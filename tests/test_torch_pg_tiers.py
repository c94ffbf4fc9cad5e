"""The two tiers and Adasum's pairwise exchange over ``ProcessGroupComm``:
four processes over gloo on the CPU against the same work on
``LocalComm(4)`` in this process.

* ``ProcessGroupComm.split(2)`` (every group created in the same order on
  every rank) and ``swap`` (``batch_isend_irecv`` with the partner): the
  groups' sums and stacks, the swapped tensors and Adasum's recursive
  doubling equal ``LocalComm``'s, bitwise.
* The two-tier recipe through the CLI, one worker a process (``resnet20_
  wm5_twotier --num-local-workers 2``): its saved parameters equal the
  ``LocalComm(4)`` trainer's, bitwise (every sum of the two tiers has two
  terms, exact in any order); its reported losses within rtol 1e-6 (the
  loss all-reduce over all four adds in gloo's ring order, ``LocalComm`` in
  rank order). One intra-op thread on both sides (a convolution's backward
  sums in another order at another thread count)."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from dgc_tpu_torch import configs
from dgc_tpu_torch.optim.adasum import adasum_allreduce
from dgc_tpu_torch.parallel.comm import LocalComm
from dgc_tpu_torch.train import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import json, sys, torch, torch.distributed as dist
from dgc_tpu_torch.optim.adasum import adasum_allreduce
from dgc_tpu_torch.parallel.comm import ProcessGroupComm
url, rank = sys.argv[1], int(sys.argv[2])
dist.init_process_group("gloo", init_method=url, world_size=4, rank=rank)
comm = ProcessGroupComm()
local, cross = comm.split(2)
x = torch.randn(40, generator=torch.Generator().manual_seed(rank))
out = {"ranks": [local.ranks[0], cross.ranks[0], local.world, cross.world],
       "local_sum": local.all_reduce([x])[0].tolist(),
       "cross_stack": cross.all_gather([x])[0].tolist(),
       "swap": [comm.swap([x], d)[0].tolist() for d in (1, 2)],
       "adasum": adasum_allreduce([x], comm)[0].tolist(),
       "adasum_cross": adasum_allreduce([x], cross)[0].tolist()}
print(json.dumps(out))
dist.destroy_process_group()
"""


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("DGC_FAULTS", None)
    return env


def _run4(args, cwd):
    url = f"tcp://localhost:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, *args(url, r)], cwd=cwd,
                              env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return [out for out, _ in outs]


def test_process_group_tiers_and_swap_match_local_comm(tmp_path):
    outs = _run4(lambda url, r: ["-c", _PROBE, url, str(r)], tmp_path)
    got = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    xs = [torch.randn(40, generator=torch.Generator().manual_seed(r))
          for r in range(4)]
    comm = LocalComm(4)
    local, cross = comm.split(2)
    want_sum = local.all_reduce(xs)
    want_stack = cross.all_gather(xs)
    want_ada = adasum_allreduce(xs, comm)
    want_ada_cross = adasum_allreduce(xs, cross)
    for r, g in enumerate(got):
        assert g["ranks"] == [r % 2, r // 2, 2, 2]
        np.testing.assert_array_equal(g["local_sum"], want_sum[r].numpy())
        np.testing.assert_array_equal(g["cross_stack"],
                                      want_stack[r].numpy())
        for d, s in zip((1, 2), g["swap"]):
            np.testing.assert_array_equal(s, xs[r ^ d].numpy())
        np.testing.assert_array_equal(g["adasum"], want_ada[r].numpy())
        np.testing.assert_array_equal(g["adasum_cross"],
                                      want_ada_cross[r].numpy())


def test_two_tier_cli_over_gloo_matches_local_comm(tmp_path):
    flags = ["--config", "resnet20_wm5_twotier", "--num-local-workers", "2",
             "--device", "cpu", "--epochs", "1", "--steps", "2",
             "--batch-size", "4", "--synthetic-size", "64"]
    outs = _run4(lambda url, r: ["-m", "dgc_tpu_torch.train", *flags,
                                 "--init-method", url, "--world", "4",
                                 "--rank", str(r)], tmp_path)
    got = [json.loads(o.strip().splitlines()[-1])["loss"] for o in outs]
    cfg = configs.resnet20_wm5_twotier()
    cfg.train.num_local_workers = 2
    cfg.train.batch_size, cfg.dataset.synthetic_size = 4, 64
    t = Trainer(cfg, LocalComm(4), "cpu")
    want = [float(x) for x in t.run_epoch(0, steps=2)]
    assert got[0] == got[1] == got[2] == got[3]
    np.testing.assert_allclose(got[0], want, rtol=1e-6)
    (run,) = (tmp_path / "runs").iterdir()
    assert run.name.endswith(".tt2.np4")
    saved = torch.load(run / "checkpoints" / "e0" / "state.pt",
                       weights_only=True)
    assert torch.equal(saved["params"], t.state.params.detach())
