"""Cohort surgery's agreement over NCCL, one process a card.

The current CUDA device is per thread, and ``SurgeryCoordinator`` gathers
on a side thread: each rank's lanes must still land on its own card
(``cuda:<rank>``), or the ranks above 0 share card 0 with rank 0 and the
agreement is lost. Needs two cards or more, so it skips on a machine with
fewer; the gloo case of the same agreement runs on the CPU in
``test_torch_surgery.py``. This file imports no JAX; where only the port
is installed, skip the suite's conftest (it sets JAX up)::

    python -m pytest --noconftest tests/test_torch_surgery_nccl.py -q -s
"""

import json
import os
import socket
import subprocess
import sys

import pytest
import torch

from dgc_tpu_torch.resilience import surgery

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_AGREE = """
import json, sys, time
import torch
import torch.distributed as dist
from dgc_tpu_torch.resilience import surgery
url, rank, world, order = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \\
    sys.argv[4]
torch.cuda.set_device(rank)
dist.init_process_group("nccl", init_method=url, world_size=world,
                        rank=rank)
seen = []
gather = dist.all_gather


def recording(rows, mine, *a, **kw):
    seen.append(str(mine.device))
    return gather(rows, mine, *a, **kw)


dist.all_gather = recording
out = {"agreements": [], "seconds": []}
coord = surgery.SurgeryCoordinator(order, boundary_timeout=60.0, retries=0,
                                   log=lambda m: None)
for _ in range(6):
    t0 = time.perf_counter()
    ag = coord.agree(rank == 0)
    out["seconds"].append(time.perf_counter() - t0)
    out["agreements"].append(ag._asdict())
out["devices"] = seen
dist.barrier()
dist.destroy_process_group()
print(json.dumps(out))
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.skipif(torch.cuda.device_count() < 2,
                    reason="needs two CUDA cards or more (NCCL, one "
                           "process a card)")
def test_agreement_over_nccl_keeps_each_rank_on_its_card(tmp_path):
    """Every rank reads an excise order for the last rank, rank 0 is
    preempted: one gather a boundary, on each rank's own card, and all
    agree on both, six boundaries in a row."""
    world = min(torch.cuda.device_count(), 4)
    url = f"tcp://localhost:{_free_port()}"
    order = str(tmp_path / surgery.ORDER_FILE)
    surgery.publish_order(order, "straggler", world - 1)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _AGREE, url, str(r), str(world), order],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    want = surgery.Agreement(preempt=True, excise=True, target=world - 1,
                             verdict="straggler")._asdict()
    for r, (out, _) in enumerate(outs):
        got = json.loads(out.strip().splitlines()[-1])
        assert got["agreements"] == [want] * 6
        assert got["devices"] == [f"cuda:{r}"] * 6
        print(f"rank {r}: agreement seconds "
              + ", ".join(f"{s:.6f}" for s in got["seconds"]))
