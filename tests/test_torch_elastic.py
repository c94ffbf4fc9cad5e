"""The elastic restart against the JAX package (test_elastic.py's oracles):
the pending-mask fold, merge / split / collapse of the same per-worker
state through ``reshard_state`` and the port's ``reshard_workers`` over
its worker files, the refusals, the batch geometry, and the restore
through the checkpoint manager and the CLI (``--elastic``).

Merges sum in f32 in worker order and round once, as the reference does:
bitwise its result. A split child inherits bitwise. For the bf16 state the
reference's merge does not sum (``np.issubdtype(bfloat16, np.floating)``
is False, so ``_sum_workers`` copies the first parent: mass is lost; a
reference caveat, ROADMAP.md §3); the port sums, and is held bitwise
against the reference run on the same state widened to f32 (exactly) with
its result rounded once to bf16. The port's sampling
and dropout generators (no JAX counterpart) follow the rule of
``resilience/elastic.py``: a child that carries a parent's buffers takes
its first parent's generators; an empty child keeps a fresh run's
(ROADMAP.md §3)."""

import json
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dgc_tpu.resilience import elastic as jelastic
from dgc_tpu.training import TrainState as JState
from dgc_tpu.training.checkpoint import CheckpointManager as JManager
from dgc_tpu_torch import configs
from dgc_tpu_torch.ops import kernels
from dgc_tpu_torch.parallel.comm import LocalComm
from dgc_tpu_torch.resilience import elastic
from dgc_tpu_torch.training.checkpoint import (CheckpointManager,
                                               TopologyMismatch)

pack_bits = JManager._pack_transmitted_np


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _topo(world, nlocal=1):
    return {"process_count": 1, "world": world, "num_local_workers": nlocal}


@pytest.mark.parametrize("total", [8, 4096, 4096 + 5, 3 * 4096])
def test_keep_from_bits_matches_jax(total):
    rng = np.random.RandomState(total)
    transmitted = rng.rand(total) < 0.3
    bits = pack_bits(transmitted)
    np.testing.assert_array_equal(elastic.keep_from_bits_np(bits, total),
                                  jelastic.keep_from_bits_np(bits, total))
    if total % 128 == 0:    # the kernel module's own packing agrees
        words = kernels.pack_sent_bits(
            torch.from_numpy(np.flatnonzero(transmitted)), total).numpy()
        np.testing.assert_array_equal(
            elastic.keep_from_bits_np(words, total), ~transmitted)


def _bf16(a):
    return torch.from_numpy(np.asarray(a, ml_dtypes.bfloat16).view(
        np.int16)).view(torch.bfloat16)


def _flat_state(world, T=4096 * 2, D=40, dtype=np.float32, seed=0):
    """A flat-engine memory for ``world`` workers with pending records,
    as JAX ``[world, ...]`` arrays and as the port's worker dicts."""
    rng = np.random.RandomState(seed)
    mem = {"momentums_c": rng.randn(world, T).astype(dtype),
           "velocities_c": rng.randn(world, T).astype(dtype),
           "momentums_d": rng.randn(world, D).astype(dtype),
           "velocities_d": np.zeros((world, D), dtype),
           "sent_bits": np.stack([pack_bits(rng.rand(T) < 0.2)
                                  for _ in range(world)])}
    stats = rng.rand(world, 12).astype(np.float32)

    def tensor(a):
        a = np.asarray(a)
        if a.dtype == ml_dtypes.bfloat16:
            return _bf16(a)
        return torch.from_numpy(a.copy())
    workers = [{**{f"memory:{k}": tensor(v[w]) for k, v in mem.items()},
                "batch_stats": torch.from_numpy(stats[w].copy()),
                "generator": torch.Generator().manual_seed(w).get_state()}
               for w in range(world)]
    js = JState(step=jnp.asarray(3, jnp.int32),
                params={"w": jnp.zeros(4)}, opt_state=(jnp.zeros(()),),
                memory=mem, batch_stats=stats)
    return js, workers


def _as_np(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


@pytest.mark.parametrize("masking", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_fold_pending_mask_matches_jax(masking, dtype):
    js, workers = _flat_state(1, dtype=dtype)
    want = jelastic.fold_pending_mask(
        {k: np.asarray(v)[0] for k, v in js.memory.items()}, masking)
    got = elastic.fold_pending_mask(
        {k[7:]: v for k, v in workers[0].items()
         if k.startswith("memory:")}, masking)
    for k in want:
        np.testing.assert_array_equal(
            _as_np(got[k]).view(np.int16 if dtype != np.float32
                                and k != "sent_bits" else
                                np.asarray(want[k]).dtype),
            np.asarray(want[k]).view(np.int16 if dtype != np.float32
                                     and k != "sent_bits" else
                                     np.asarray(want[k]).dtype), k)
    pt = {"memory:momentums:a": torch.ones(3)}
    assert elastic.fold_pending_mask(pt, prefix="memory:") is pt


@pytest.mark.parametrize("fw,tw", [(4, 2), (2, 4), (4, 3), (3, 1), (2, 2)])
@pytest.mark.parametrize("masking", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_reshard_matches_jax(fw, tw, masking, dtype):
    """merge (4->2, 3->1), split (2->4), collapse (4->3) and identity: every
    child's memory and statistics bitwise the JAX ``reshard_state``'s; the
    total error-feedback mass (the folded velocity and momentum summed over
    the workers) is conserved; a split's first child inherits bitwise."""
    js, workers = _flat_state(fw, dtype=dtype, seed=fw * 10 + tw)
    bf16 = dtype != np.float32
    if bf16:
        if fw % tw == 0 and fw != tw:   # the reference caveat, pinned
            direct = jelastic.reshard_state(js, _topo(fw), _topo(tw),
                                            log=lambda *_: None)
            np.testing.assert_array_equal(
                np.asarray(direct.memory["velocities_d"])[0].view(np.int16),
                np.asarray(js.memory["velocities_d"])[0].view(np.int16))
        js = js.replace(memory={
            k: (np.asarray(v, np.float32) if k != "sent_bits" else v)
            for k, v in js.memory.items()})
    jout = jelastic.reshard_state(js, _topo(fw), _topo(tw),
                                  momentum_masking=masking,
                                  log=lambda *_: None)
    fresh = {c: {"generator": torch.Generator().manual_seed(100 + c)
                 .get_state()} for c in range(tw)}
    out = elastic.reshard_workers(workers, fresh, _topo(fw), _topo(tw),
                                  momentum_masking=masking,
                                  log=lambda *_: None)
    assert sorted(out) == list(range(tw))
    for c in range(tw):
        for k in js.memory:
            got = _as_np(out[c][f"memory:{k}"])
            want = np.asarray(jout.memory[k])[c]
            if bf16 and k != "sent_bits":
                want = want.astype(ml_dtypes.bfloat16)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got.view(np.uint8),
                                          want.view(np.uint8), f"{c} {k}")
        np.testing.assert_array_equal(out[c]["batch_stats"].numpy(),
                                      np.asarray(jout.batch_stats)[c])
    if fw != tw:
        def mass(ws, n):
            folded = [elastic.fold_pending_mask(w, masking, "memory:")
                      for w in ws]
            return sum(f[f"memory:{k}"].double().sum().item()
                       for f in folded for k in ("velocities_c",
                                                 "momentums_c"))
        assert mass([out[c] for c in range(tw)], tw) == pytest.approx(
            mass(workers, fw), rel=1e-6 if dtype == np.float32 else 1e-2)
    # the generators' rule
    for c in range(tw):
        if fw % tw == 0:
            src = workers[c * (fw // tw)]["generator"]
        elif tw % fw == 0:
            k = tw // fw
            src = (workers[c // k] if c % k == 0 else fresh[c])["generator"]
        else:
            src = (workers[0] if c == 0 else fresh[c])["generator"]
        assert torch.equal(out[c]["generator"], src)
    if tw % fw == 0 and fw != tw:
        k = tw // fw
        for c in range(0, tw, k):
            for key, v in workers[c // k].items():
                assert torch.equal(out[c][key], v), key


def test_reshard_refusals_and_geometry():
    _, workers = _flat_state(4)
    with pytest.raises(RuntimeError, match="num_local_workers"):
        elastic.reshard_workers(workers, {0: {}}, _topo(4, 1), _topo(2, 2))
    with pytest.raises(NotImplementedError, match="per-worker optimizer"):
        elastic.reshard_workers(workers, {0: {}}, _topo(4), _topo(2),
                                per_worker_opt=True)
    odd = [dict(w, **{"memory:surprise": torch.zeros(3)}) for w in workers]
    with pytest.raises(ValueError, match="ELASTIC_ADDITIVE_PREFIXES"):
        elastic.reshard_workers(odd, {0: {}}, _topo(4), _topo(2))
    adasum = [dict(w, **{"opt:momentum_buffer": torch.zeros(3)})
              for w in workers]
    with pytest.raises(NotImplementedError, match="per-worker optimizer"):
        elastic.reshard_workers(adasum, {0: {}}, _topo(4), _topo(2))
    with pytest.raises(ValueError, match="worker files"):
        elastic.reshard_workers(workers[:3], {0: {}}, _topo(4), _topo(2))
    for args in ((4, 4, 2), (4, 2, 2), (2, 4, 2), (2, 8, 2), (4, 3, 1),
                 (3, 1, 1), (1, 3, 3)):
        for preserve in (True, False):
            try:
                want = jelastic.resolve_batch_geometry(*args,
                                                       preserve=preserve)
            except RuntimeError as e:
                with pytest.raises(RuntimeError) as got:
                    elastic.resolve_batch_geometry(*args, preserve=preserve)
                assert "preserve_global_batch" in str(got.value)
                assert "preserve_global_batch" in str(e)
                continue
            assert elastic.resolve_batch_geometry(
                *args, preserve=preserve)[0] == want[0]


def _trainer(world, nbps=1):
    from dgc_tpu_torch.train import Trainer
    cfg = configs.resnet20_wm5()
    cfg.dataset.synthetic_size = 64
    cfg.train.batch_size = 4
    cfg.train.num_batches_per_step = nbps
    return Trainer(cfg, LocalComm(world), "cpu")


def _mass(t):
    """The trainer's whole error-feedback mass, pending records folded."""
    m = 0.0
    for mem in t.state.memory:
        f = elastic.fold_pending_mask(
            {k: v.cpu() for k, v in mem.items()},
            t.compression.memory.momentum_masking)
        m += sum(f[k].double().sum().item()
                 for k in ("momentums_c", "velocities_c", "momentums_d",
                           "velocities_d"))
    return m


@pytest.mark.parametrize("fw,tw", [(4, 2), (2, 4), (4, 3)])
def test_checkpoint_elastic_restore_conserves_mass(tmp_path, fw, tw):
    """A ``Trainer`` at W=fw trains and saves; one at W=tw restores with
    ``elastic=True`` (the meters carry the ``_elastic`` record), holds the
    same total mass, and trains on; without ``elastic`` the topology
    mismatch raises and says how to reshard."""
    a = _trainer(fw)
    a.run_epoch(5, 2)
    ckpt = CheckpointManager(str(tmp_path))
    a.save_checkpoint(ckpt, 5, {"acc/test_top1": 1.0})
    assert ckpt.saved_topology() == a.topology
    b = _trainer(tw)
    with pytest.raises(TopologyMismatch, match="elastic"):
        b.restore_checkpoint(ckpt)
    epoch, meters = b.restore_checkpoint(ckpt, elastic=True)
    assert epoch == 5 and meters["_elastic"]["from_world"] == fw
    assert meters["_elastic"]["to_world"] == tw
    assert _mass(b) == pytest.approx(_mass(a), rel=1e-6)
    assert torch.equal(b.state.params, a.state.params)
    assert b.state.step == a.state.step
    losses = [float(x) for x in b.run_epoch(6, 2)]
    assert all(np.isfinite(losses))


def test_cli_elastic_keeps_the_global_batch(tmp_path, monkeypatch, capsys):
    """``--elastic``: the run directory ends in ``.npE``; resuming a W=4
    run at W=2 doubles ``num_batches_per_step`` (the global batch and the
    steps an epoch stay) and reshards the memory."""
    from dgc_tpu_torch import train
    monkeypatch.chdir(tmp_path)
    base = ["--device", "cpu", "--steps", "2", "--batch-size", "4",
            "--synthetic-size", "64", "--elastic"]
    train.main(base + ["--world", "4", "--epochs", "1"])
    assert os.path.isdir("runs/cifar.resnet20+dgc.wm5.npE/checkpoints/e0")
    capsys.readouterr()
    train.main(base + ["--world", "2", "--epochs", "2"])
    out = capsys.readouterr().out
    assert "raising num_batches_per_step 1 -> 2" in out
    assert "resharded checkpoint state 4 -> 2 workers" in out
    summaries = [json.loads(x) for x in out.splitlines()
                 if x.startswith('{"epoch"')]
    assert [s["epoch"] for s in summaries] == [1]
    assert len(summaries[0]["loss"]) == 2
