"""Cross-check through the JAX package's DLPack bridge: one torch
ResNet-20's gradients (the port's model, W=2, three steps on different
batches) go through ``dgc_tpu/interop/torch_bridge.py``'s
``TorchDGCBridge`` (the JAX flat engine, jitted under ``shard_map`` on
two CPU devices) and through the port's flat exchange (``LocalComm(2)``).

``sample_ratio=1.0`` makes every bucket select from all of its elements,
so neither side draws sampling phases (the bridge folds its own keys,
the port draws from host generators). The exchanged gradients and every
worker's memory are held bitwise (tolerance 0), selections included: W=2
sums the two workers' ``v / W`` in one order on both sides, and the
jitted bridge computes the same numbers as the port's op-by-op plain
versions here (where XLA-CPU contracts a multiply-add under jit, the
port's own tests allow 4 eps; ROADMAP.md §3).
"""

import numpy as np
import pytest
import torch

from dgc_tpu import DGCCompressor, DGCSGDMemory, DistributedOptimizer, dgc_sgd
from dgc_tpu.interop.torch_bridge import TorchDGCBridge
from dgc_tpu_torch.compression import dgc as tdgc
from dgc_tpu_torch.compression.memory import DGCSGDMemory as TMemory
from dgc_tpu_torch.models import create, param_tree, stats_tree
from dgc_tpu_torch.optim.distributed import DistributedOptimizer as TDist
from dgc_tpu_torch.optim.sgd import dgc_sgd as t_dgc_sgd
from dgc_tpu_torch.parallel.comm import LocalComm
from dgc_tpu_torch.training.step import make_flat_setup, worker_grad

W = 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread, restored afterwards: these are many small CPU
    ops, no faster on several threads, and the files run beside other
    test workers, where several threads a worker oversubscribe the cores
    and slow every op by orders of magnitude. (A convolution's backward
    sums in another order at another thread count: each comparison here
    stays within one process, or sets one thread in its subprocesses.)"""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("epoch", [0, 5])
def test_bridge_and_port_exchange_agree(epoch):
    model = create("resnet20", 10, torch.Generator().manual_seed(0))
    shapes = {n.replace(".", "/"): tuple(p.shape)
              for n, p in model.named_parameters()}
    kw = dict(sample_ratio=1.0, warmup_epochs=5)
    jc = DGCCompressor(0.001, memory=DGCSGDMemory(momentum=0.9), **kw)
    tc = tdgc.DGCCompressor(0.001, memory=TMemory(momentum=0.9), **kw)
    jc.initialize((n, np.empty(s, np.float32)) for n, s in shapes.items()
                  if len(s) > 1)
    tc.initialize((n, s) for n, s in shapes.items() if len(s) > 1)
    for c in (jc, tc):
        c.warmup_compress_ratio(epoch)
    bridge = TorchDGCBridge(
        DistributedOptimizer(dgc_sgd(0.1, momentum=0.9), jc, world_size=W),
        shapes)
    tdist = TDist(t_dgc_sgd(0.1, momentum=0.9), tc, LocalComm(W))
    setup = make_flat_setup(model, tdist)
    engine = setup.engine
    assert setup.layout.offsets == bridge.layout.offsets
    mems = [engine.init_memory("cpu") for _ in range(W)]
    stats = setup.stats_layout.flatten(stats_tree(model))
    params = setup.layout.flatten(param_tree(model))
    rng = np.random.RandomState(epoch)
    T = engine.T
    for step in range(3):
        grads = []
        for _ in range(W):
            x = torch.from_numpy(rng.randn(4, 3, 32, 32).astype(np.float32))
            y = torch.from_numpy(rng.randint(0, 10, 4)).long()
            grads.append(worker_grad(model, setup, params, stats.clone(), x,
                                     y)[0])
        named = [setup.layout.unflatten_named(g) for g in grads]
        via_bridge = bridge.exchange(
            {n: torch.stack([g[n] for g in named]) for n in shapes})
        got = setup.layout.flatten(via_bridge)
        phases = [engine.draw_phases(torch.Generator()) for _ in range(W)]
        want = engine.exchange(grads, mems, phases, LocalComm(W))[0]
        assert torch.equal(got[:T] != 0, want[:T] != 0), step
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    saved = bridge.state_dict()
    for w, mem in enumerate(mems):
        port = engine.memory_state_dict(mem)
        for key in ("momentums", "velocities"):
            for n, t in port[key].items():
                torch.testing.assert_close(
                    torch.from_numpy(np.asarray(saved[key][n][w])).reshape(
                        t.shape), t, rtol=0, atol=0)
