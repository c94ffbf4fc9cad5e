"""The port's checkpoint manager against the JAX package's.

* The two managers go through the same ``save(epoch, best)`` calls and
  leave the same kept epochs, ``latest.json``, ``best`` epoch and meters;
  restore the same epochs; fall back alike past a corrupt newest epoch;
  and refuse a topology mismatch alike.
* A JAX flat train state saved and restored by the JAX manager, carried
  across by ``interop.carry_train_state``, saved and restored by the
  port's manager, equals the carried state bitwise (and loads into a
  port ``Trainer``).
* A small ``Trainer`` resumed between two epochs trains on exactly as
  the uninterrupted one, bitwise: ``resnet20_wm5`` at epochs 4 -> 5, and
  ``resnet20_wm5o`` across its dense -> compressed handover.
* Two gloo processes save and restore, each its own worker's state.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgc_tpu import DGCCompressor, DGCSGDMemory, DistributedOptimizer, dgc_sgd
from dgc_tpu.training import TrainState as JaxTrainState
from dgc_tpu.training import make_flat_setup, make_flat_state
from dgc_tpu.training.checkpoint import CheckpointManager as JaxManager
from dgc_tpu.utils.pytree import named_flatten as jax_named_flatten
from dgc_tpu_torch import configs
from dgc_tpu_torch.interop import carry_train_state
from dgc_tpu_torch.models import create, param_tree, stats_tree
from dgc_tpu_torch.parallel.comm import LocalComm
from dgc_tpu_torch.train import Trainer
from dgc_tpu_torch.training import checkpoint as tckpt
from dgc_tpu_torch.training.checkpoint import CheckpointManager
from dgc_tpu_torch.training.state import TrainState
from dgc_tpu_torch.training.step import (make_flat_state as t_flat_state,
                                         make_per_tensor_setup)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOPO = {"process_count": 1, "world": 2, "num_local_workers": 1}


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


def _jax_state(value: float) -> JaxTrainState:
    return JaxTrainState(
        step=jnp.asarray(int(value), jnp.int32),
        params={"w": jnp.full((4,), value)},
        opt_state=(jnp.zeros(()),),
        memory={"momentums": {"a/b": jnp.full((3,), value)}},
        batch_stats={})


def _port(value: float):
    """``(replicated, workers)`` tensors of a tiny two-worker state."""
    rep = {"params": torch.full((4,), value)}
    return rep, {r: {"m": torch.full((3,), value + r)} for r in (0, 1)}


def _dirs(path):
    return sorted(n for n in os.listdir(path) if not n.endswith(".tmp"))


def _meters(path):
    with open(os.path.join(path, "meters.json")) as f:
        return json.load(f)


#: (epoch, meters, best) saves: an overwrite of epoch 2, rotation at keep 3
SAVES = [(0, {"m": 1.0}, True), (1, {"m": 0.5}, False),
         (2, {"m": 2.0}, True), (3, {"m": 1.0}, False),
         (2, {"m": 3.0}, True), (4, {"m": 0.0}, False),
         (5, {"m": 4.0}, True), (6, {"m": 1.0}, False)]


@pytest.mark.parametrize("upto", [2, 5, len(SAVES)])
def test_save_sequence_matches_jax(tmp_path, upto):
    jm = JaxManager(str(tmp_path / "jax"), keep=3)
    tm = CheckpointManager(str(tmp_path / "port"))
    for epoch, meters, best in SAVES[:upto]:
        jm.save(epoch, _jax_state(float(epoch)), meters, best=best,
                topology=TOPO)
        tm.save(epoch, *_port(float(epoch)), meters, best=best,
                topology=TOPO)
    assert _dirs(jm.directory) == _dirs(tm.directory)
    assert tm.latest_epoch() == jm.latest_epoch()
    with open(os.path.join(jm.directory, "latest.json")) as a, \
            open(os.path.join(tm.directory, "latest.json")) as b:
        assert json.load(a) == json.load(b)
    for name in _dirs(tm.directory):
        if name != "latest.json":
            assert _meters(os.path.join(jm.directory, name)) == _meters(
                os.path.join(tm.directory, name)), name
    assert CheckpointManager.keep == 3
    for best in (False, True):
        js, je, jmeters = jm.restore(_jax_state(0.0), best=best,
                                     topology=TOPO)
        rep, workers, te, tmeters = tm.restore(*_port(0.0), best=best,
                                               topology=TOPO)
        assert te == je and tmeters == jmeters
        assert float(rep["params"][0]) == float(js.params["w"][0])
        assert float(workers[1]["m"][0]) == float(js.params["w"][0]) + 1


def test_corrupt_newest_falls_back_like_jax(tmp_path, capsys):
    jm = JaxManager(str(tmp_path / "jax"), keep=3)
    tm = CheckpointManager(str(tmp_path / "port"))
    for epoch in range(3):
        jm.save(epoch, _jax_state(float(epoch)), {"m": float(epoch)})
        tm.save(epoch, *_port(float(epoch)), {"m": float(epoch)})
    for m in (jm, tm):
        with open(os.path.join(m.directory, "e2", "meters.json"), "w") as f:
            f.write("{torn")
    js, je, _ = jm.restore(_jax_state(0.0))
    rep, _, te, _ = tm.restore(*_port(0.0))
    assert je == te == 1 and float(rep["params"][0]) == 1.0
    assert capsys.readouterr().out.count("falling back") == 2
    # the port's own files torn as well: the fallback goes one further
    path = os.path.join(tm.directory, "e1", "state.pt")
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    assert tm.restore(*_port(0.0))[2] == 0
    # a layout change is incompatible too (another worker file's shape)
    rep, workers = _port(0.0)
    workers[0]["m"] = torch.zeros(5)
    assert tm.restore(rep, workers) is None


def test_topology_mismatch_raises_like_jax(tmp_path):
    jm = JaxManager(str(tmp_path / "jax"))
    tm = CheckpointManager(str(tmp_path / "port"))
    jm.save(0, _jax_state(1.0), {"m": 1.0}, topology=TOPO)
    tm.save(0, *_port(1.0), {"m": 1.0}, topology=TOPO)
    other = dict(TOPO, world=4)
    with pytest.raises(RuntimeError, match="topology"):
        jm.restore(_jax_state(0.0), topology=other)
    with pytest.raises(tckpt.TopologyMismatch, match="item 8"):
        tm.restore(*_port(0.0), topology=other)
    # the matching or an absent record restores, and stays out of meters
    for topo in (TOPO, None):
        assert "_topology" not in tm.restore(*_port(0.0), topology=topo)[3]
    with pytest.raises(ValueError, match="item 8"):
        tm.restore(*_port(0.0), elastic=True)


@pytest.fixture(scope="module")
def jax_flat_state():
    """A JAX ``resnet20_wm5`` flat train state at W=2 with every buffer
    filled from a seed (the memory's record with random words); the
    trees come from the port's model, which has flax's names and shapes
    (a flax ``init`` takes 14 s on this CPU)."""
    def numpy_tree(t):
        return {k: numpy_tree(x) if isinstance(x, dict)
                else x.detach().numpy() for k, x in t.items()}
    model = create("resnet20", 10, torch.Generator().manual_seed(0))
    v = {"params": numpy_tree(param_tree(model)),
         "batch_stats": numpy_tree(stats_tree(model))}
    comp = DGCCompressor(0.001, memory=DGCSGDMemory(momentum=0.9),
                         warmup_epochs=5)
    named = jax_named_flatten(v["params"])[0]
    comp.initialize((n, p) for n, p in named.items() if p.ndim > 1)
    dist = DistributedOptimizer(dgc_sgd(0.1, momentum=0.9,
                                        weight_decay=1e-4), comp,
                                world_size=2)
    state = jax.device_get(make_flat_state(
        v, dist, make_flat_setup(v, dist), 2))
    rng = np.random.RandomState(3)

    def fill(a):
        a = np.asarray(a)
        if a.dtype == np.int32:
            return rng.randint(-2 ** 31, 2 ** 31 - 1, a.shape, np.int32)
        return rng.randn(*a.shape).astype(a.dtype)
    return state.replace(step=np.int32(37), params=fill(state.params),
                         opt_state=state.opt_state._replace(
                             count=np.int32(37),
                             momentum_buffer=fill(
                                 state.opt_state.momentum_buffer)),
                         memory={k: fill(a) for k, a in state.memory.items()},
                         batch_stats=fill(state.batch_stats))


def _tensors(state: TrainState):
    out = [torch.tensor(state.step), state.params,
           torch.tensor(state.opt_state.count), state.opt_state.momentum_buffer]
    for mem, stats in zip(state.memory, state.batch_stats):
        out += [mem[k] for k in sorted(mem)] + [stats]
    return out


def _assert_bitwise(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.view(torch.uint8) if g.dim() else g,
                           w.view(torch.uint8) if w.dim() else w)


def _cfg(recipe):
    """The recipe at a CPU size; ``+bf16mem`` stacks the bf16
    error-feedback state on it."""
    name, _, extra = recipe.partition("+")
    cfg = configs.RECIPES[name]()
    cfg.train.batch_size, cfg.dataset.synthetic_size = 8, 64
    if extra == "bf16mem":
        cfg.train.compression.memory.dtype = "bfloat16"
    return cfg


def test_jax_checkpoint_carried_saved_restored_bitwise(tmp_path,
                                                       jax_flat_state):
    jm = JaxManager(str(tmp_path / "jax"))
    jm.save(3, jax_flat_state, {"m": 1.0}, topology=TOPO)
    restored, epoch, _ = jm.restore(jax_flat_state, topology=TOPO)
    carried = carry_train_state(jax.device_get(restored))
    gens = [torch.Generator().manual_seed(r) for r in (5, 6)]
    tm = CheckpointManager(str(tmp_path / "port"))
    tm.save(epoch, *tckpt.state_tensors(carried, gens, (0, 1)), {"m": 1.0},
            topology=TOPO)
    # into a port trainer of the same recipe (its own initial state as
    # the template), then generators and all
    trainer = Trainer(_cfg("resnet20_wm5"), LocalComm(2), device="cpu")
    assert trainer.restore_checkpoint(tm) == (3, {"m": 1.0})
    _assert_bitwise(_tensors(trainer.state), _tensors(carried))
    assert trainer.state.step == 37 and trainer.state.opt_state.count == 37
    for a, b in zip(trainer.gens, gens):
        assert torch.equal(a.get_state(), b.get_state())
    np.testing.assert_array_equal(trainer.state.memory[1]["sent_bits"],
                                  jax_flat_state.memory["sent_bits"][1])


def test_per_tensor_memory_round_trips(tmp_path):
    """The per-tensor path's per-name memory (``memory:momentums:<name>``
    in the files) restores bitwise."""
    trainer = Trainer(_cfg("resnet20_wm5"), LocalComm(2), device="cpu")
    setup = make_per_tensor_setup(trainer.model, trainer.dist)
    state = t_flat_state(trainer.model, trainer.dist, setup, "cpu")
    gen = torch.Generator().manual_seed(1)
    for mem in state.memory:
        for k in mem:
            mem[k] = {n: torch.randn(t.shape, generator=gen)
                      for n, t in mem[k].items()}
    tm = CheckpointManager(str(tmp_path))
    tm.save(0, *tckpt.state_tensors(state, trainer.gens, (0, 1)), {})
    fresh = t_flat_state(trainer.model, trainer.dist, setup, "cpu")
    out = tm.restore(*tckpt.state_tensors(fresh, trainer.gens, (0, 1),
                                          host=False))
    back = tckpt.load_state_tensors(fresh, trainer.gens, (0, 1), out[0],
                                    out[1])
    for a, b in zip(back.memory, state.memory):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].keys() == b[k].keys()
            for n in a[k]:
                assert torch.equal(a[k][n], b[k][n]), (k, n)


@pytest.mark.parametrize("recipe", [
    "resnet20_wm5", "resnet20_wm5o", "resnet20_wm5_int8",
    "resnet20_wm5_int8_packidx+bf16mem"])
def test_trainer_resume_is_bitwise(tmp_path, recipe):
    """Epoch 4 then 5, 2 steps each (wm5o: dense, then the first
    compressed epoch; the int8 wire's error-feedback state, and the bf16
    state on the int8 wire with packed indices), uninterrupted and through
    a save and a fresh trainer's restore."""
    a = Trainer(_cfg(recipe), LocalComm(2), device="cpu")
    want = [a.run_epoch(e, 2) for e in (4, 5)]
    b = Trainer(_cfg(recipe), LocalComm(2), device="cpu")
    assert [float(x) for x in b.run_epoch(4, 2)] == [float(x)
                                                      for x in want[0]]
    ckpt = CheckpointManager(str(tmp_path))
    b.save_checkpoint(ckpt, 4, {"acc/test_top1": 1.0}, best=True)
    c = Trainer(_cfg(recipe), LocalComm(2), device="cpu")
    assert c.restore_checkpoint(ckpt)[0] == 4
    got = c.run_epoch(5, 2)
    assert [float(x) for x in got] == [float(x) for x in want[1]]
    _assert_bitwise(_tensors(c.state), _tensors(a.state))
    for x, y in zip(c.gens, a.gens):
        assert torch.equal(x.get_state(), y.get_state())
    if recipe == "resnet20_wm5o":
        assert a.compression.compress_ratio == 0.001
        assert int(a.state.memory[0]["sent_bits"].ne(0).sum()) > 0
    if "int8" in recipe:
        # int8 error feedback keeps its slots out of the record
        assert int(a.state.memory[0]["sent_bits"].ne(0).sum()) == 0
    if "bf16mem" in recipe:
        assert a.state.memory[0]["velocities_c"].dtype == torch.bfloat16


_GLOO_WORKER = """
import json, os, sys, torch
from dgc_tpu_torch import configs
from dgc_tpu_torch.parallel.comm import ProcessGroupComm
from dgc_tpu_torch.parallel.multihost import initialize_multihost
from dgc_tpu_torch.train import Trainer
from dgc_tpu_torch.training.checkpoint import CheckpointManager
assert initialize_multihost("cpu")
cfg = configs.resnet20_wm5()
cfg.train.batch_size, cfg.dataset.synthetic_size = 4, 32
def trainer():
    return Trainer(cfg, ProcessGroupComm(), device="cpu")
a = trainer()
a.run_epoch(0, 1)
ckpt = CheckpointManager(sys.argv[1])
a.save_checkpoint(ckpt, 0, {"m": 1.0})
b = trainer()
epoch, _ = b.restore_checkpoint(ckpt)
mem = a.state.memory[0]
print(json.dumps({
    "rank": torch.distributed.get_rank(), "epoch": epoch,
    "files": sorted(os.listdir(os.path.join(sys.argv[1], "e0"))),
    "own": all(torch.equal(mem[k], b.state.memory[0][k]) for k in mem),
    "stats": torch.equal(a.state.batch_stats[0], b.state.batch_stats[0]),
    "gen": torch.equal(a.gens[0].get_state(), b.gens[0].get_state()),
    "params": torch.equal(a.state.params, b.state.params),
    "sum": float(mem["velocities_c"].double().sum())}))
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_restore_their_own_workers(tmp_path):
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "RANK", "WORLD_SIZE")}
    env.update(PYTHONPATH=ROOT, MASTER_ADDR="localhost",
               MASTER_PORT=str(port), WORLD_SIZE="2", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GLOO_WORKER, str(tmp_path)], cwd=tmp_path,
        env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err
    res = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    assert [r["rank"] for r in res] == [0, 1]
    for r in res:
        assert r["epoch"] == 0 and r["own"] and r["stats"] and r["gen"]
        assert r["params"]
        assert r["files"] == ["meters.json", "state.pt", "w0.pt", "w1.pt"]
    # the two workers' memories differ, so each restored its own
    assert res[0]["sum"] != res[1]["sum"]
