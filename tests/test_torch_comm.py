"""The two forms of the port's ``Comm``: two processes over
``torch.distributed`` (gloo, one worker each, through the harness's
command line) train exactly as two ``LocalComm`` workers in one process."""

import json
import os
import socket
import subprocess
import sys

import torch

from dgc_tpu_torch import configs
from dgc_tpu_torch.parallel.comm import LocalComm
from dgc_tpu_torch.train import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--device", "cpu", "--epochs", "1", "--steps", "2",
        "--batch-size", "8", "--synthetic-size", "64"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_local_comm_collectives():
    comm = LocalComm(3)
    xs = [torch.full((2,), float(r)) for r in range(3)]
    g = comm.all_gather(xs)
    assert len(g) == 3 and g[0].tolist() == [[0, 0], [1, 1], [2, 2]]
    assert comm.all_reduce(xs)[2].tolist() == [3.0, 3.0]


def test_process_group_matches_local_comm():
    url = f"tcp://localhost:{_free_port()}"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "dgc_tpu_torch.train", *ARGS,
         "--init-method", url, "--world", "2", "--rank", str(r)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    got = [json.loads(out.strip().splitlines()[-1])["loss"]
           for out, _ in outs]

    cfg = configs.resnet20_wm5()
    cfg.train.batch_size, cfg.dataset.synthetic_size = 8, 64
    trainer = Trainer(cfg, LocalComm(2), device="cpu")
    want = [float(x) for x in trainer.run_epoch(0, steps=2)]
    assert got[0] == got[1] == want
