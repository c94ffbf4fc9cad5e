"""Adasum against the JAX package (test_adasum_interop.py's oracles).

Tolerances. The combine ``fa * a + fb * b`` runs op by op in the port; the
JAX functions run op by op too when they are not jitted (here: eagerly, or
under ``jax.vmap``), so on values whose dot products are exact sums (a
coarse grid: multiples of 1/64 with |x| <= 2, a few hundred terms) one
Adasum pair is bitwise the JAX result. Past the first level of the tree
(W > 2) the operands are off the grid and the dot products are reductions
summed in another order (PyTorch's and XLA's CPU reductions), so the
Adasum-combined values are held within rtol 2e-6 (a few ulps); everything
that does not go through a dot product (the compressed payload's sums,
the transmit record, the compensated memory of the compressed block, the
per-worker optimizer state) stays bitwise. Against the jitted JAX (XLA
fuses the combine into an FMA) the JAX test's own rtol 1e-4 holds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgc_tpu import Compression, DGCCompressor, DGCSGDMemory
from dgc_tpu import dgc_sgd as jax_dgc_sgd
from dgc_tpu import sgd as jax_sgd
from dgc_tpu.optim import adasum as jada
from dgc_tpu.utils.pytree import named_flatten as jax_named_flatten
from dgc_tpu_torch.compression import dgc as tdgc
from dgc_tpu_torch.compression.base import Compression as TCompression
from dgc_tpu_torch.compression.memory import DGCSGDMemory as TMemory
from dgc_tpu_torch.optim import adasum as tada
from dgc_tpu_torch.optim.sgd import dgc_sgd, sgd
from dgc_tpu_torch.parallel.comm import LocalComm


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grid(rng, shape):
    """Multiples of 1/64, |x| <= 2: every dot product here sums exactly."""
    return (np.round(np.clip(rng.randn(*shape), -2, 2) * 64) / 64).astype(
        np.float32)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _close(got, want, err_msg=""):
    """Adasum-combined values past one tree level (module docstring)."""
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7,
                               err_msg=err_msg)


def test_adasum_pair_and_reduce_match_jax():
    rng = np.random.RandomState(0)
    a, b = _grid(rng, (64,)), _grid(rng, (64,))
    with jax.disable_jit():
        want = np.asarray(jada.adasum_pair(jnp.asarray(a), jnp.asarray(b)))
    got = tada.adasum_pair(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # the JAX test's identities
    x = torch.from_numpy(rng.randn(64).astype(np.float32))
    np.testing.assert_allclose(tada.adasum_pair(x, x).numpy(), x.numpy(),
                               rtol=1e-6)
    e0, e1 = torch.zeros(64), torch.zeros(64)
    e0[0], e1[1] = 3.0, 4.0
    np.testing.assert_array_equal(tada.adasum_pair(e0, e1).numpy(),
                                  (e0 + e1).numpy())
    np.testing.assert_array_equal(
        tada.adasum_pair(x, torch.zeros(64)).numpy(), x.numpy())
    for w in (2, 3, 4, 5, 8):
        stack = _grid(rng, (w, 48))
        with jax.disable_jit():
            want = np.asarray(jada.adasum_reduce(jnp.asarray(stack)))
        got = tada.adasum_reduce(list(torch.from_numpy(stack)))
        if w == 2:
            np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
        else:
            _close(got.numpy(), want)
    rows = torch.eye(8)
    np.testing.assert_allclose(tada.adasum_reduce(list(rows)).numpy(),
                               np.ones(8), rtol=1e-6)
    # random values: the dot products' order differs at every level
    stack = rng.randn(8, 300).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(jada.adasum_reduce(jnp.asarray(stack)))
    _close(tada.adasum_reduce(list(torch.from_numpy(stack))).numpy(), want)


@pytest.mark.parametrize("world", [2, 3, 4, 8])
def test_adasum_allreduce_is_the_gathered_reduce(world):
    """Recursive doubling over ``Comm.swap`` (powers of two) and the
    gathered reduce (W=3) give every worker the rank-order tree, bitwise."""
    xs = list(torch.from_numpy(
        np.random.RandomState(world).randn(world, 40).astype(np.float32)))
    got = tada.adasum_allreduce(xs, LocalComm(world))
    want = tada.adasum_reduce(xs)
    for g in got:
        np.testing.assert_array_equal(g.numpy(), want.numpy())


def _params(n=40):
    rng = np.random.RandomState(8)
    return {"w": rng.randn(n, n).astype(np.float32),
            "b": np.zeros((8,), np.float32)}


def _dgc_pair(params, ratio=0.05):
    jc = DGCCompressor(ratio, memory=DGCSGDMemory(momentum=0.9),
                       sample_ratio=1.0)
    tc = tdgc.DGCCompressor(ratio, memory=TMemory(momentum=0.9),
                            sample_ratio=1.0)
    jc.initialize([("w", params["w"])])
    tc.initialize([("w", params["w"].shape)])
    return jc, tc


@pytest.mark.parametrize("world", [4, 3])
def test_flat_adasum_update_matches_jax(world):
    """``AdasumDistributedOptimizer.update_flat`` over the DGC engine, two
    steps of distinct per-worker gradients on the grid: each worker's base
    step on its own optimizer state (stock ``sgd`` with momentum: a buffer
    of each worker's own gradients), the sparse deltas summed, the dense tail
    combined by Adasum — the updates, every worker's optimizer state and
    memory bitwise the JAX optimizer's run op by op under ``jax.vmap``."""
    params = _params()
    jc, tc = _dgc_pair(params)
    jd = jada.AdasumDistributedOptimizer(
        jax_sgd(0.1, momentum=0.9, weight_decay=1e-4), jc, world_size=world)
    td = tada.AdasumDistributedOptimizer(
        sgd(0.1, momentum=0.9, weight_decay=1e-4), tc, LocalComm(world))
    jlay, je = jd.make_flat(params)
    tlay, te = td.make_flat(params)
    flat_p = np.array(jlay.flatten(params))
    jopt = jax.tree.map(lambda x: jnp.stack([x] * world),
                        jd.init(jnp.asarray(flat_p)))
    jmem = jax.tree.map(lambda x: jnp.stack([x] * world), je.init_memory())
    topt = td.init_per_worker(torch.from_numpy(flat_p))
    tmem = [te.init_memory("cpu") for _ in range(world)]
    rng = np.random.RandomState(5)

    def worker(fg, opt, mem, key):
        return jd.update_flat(fg, opt, jnp.asarray(flat_p), mem, key, je)
    f = jax.vmap(worker, in_axes=(0, 0, 0, None), axis_name="data")
    T = te.T
    for step in range(2):
        g = _grid(rng, (world, tlay.total))
        jupd, jopt, jmem = f(jnp.asarray(g), jopt, jmem,
                             jax.random.PRNGKey(step))
        phases = [te.draw_phases(torch.Generator()) for _ in range(world)]
        new_p, topt, red = td.update_flat(
            [torch.from_numpy(x) for x in g], topt,
            torch.from_numpy(flat_p), tmem, phases, te)
        for w in range(world):
            ju = np.asarray(jupd)[w]
            np.testing.assert_array_equal(_bits(red[w].numpy()[:T]),
                                          _bits(ju[:T]))
            _close(red[w].numpy()[T:], ju[T:])
            np.testing.assert_array_equal(
                _bits(topt[w].momentum_buffer.numpy()),
                _bits(np.asarray(jopt.momentum_buffer)[w]))
            assert topt[w].count == int(np.asarray(jopt.count)[w])
            for k in tmem[w]:
                jm = np.asarray(jmem[k])[w]
                if k == "momentums_d":
                    _close(tmem[w][k].numpy(), jm, f"step {step} {k}")
                else:
                    np.testing.assert_array_equal(
                        _bits(tmem[w][k].numpy()), _bits(jm),
                        err_msg=f"step {step} {k}")
        np.testing.assert_array_equal(
            new_p.numpy(), (torch.from_numpy(flat_p) + red[0]).numpy())
    # distinct data: the per-worker optimizer states differ
    assert not np.array_equal(topt[0].momentum_buffer.numpy(),
                              topt[1].momentum_buffer.numpy())


def test_flat_adasum_fixed_point_and_sum_semantics():
    """The JAX tests' oracles: identical gradients on the dense engine give
    the local delta back (not x W, not / W); through DGC identical workers'
    sparse deltas sum to W x the delta at the selected coordinates."""
    params = {"w": np.random.RandomState(2).randn(16, 16).astype(np.float32),
              "b": np.zeros((16,), np.float32)}
    td = tada.AdasumDistributedOptimizer(sgd(0.1), TCompression.none(),
                                         LocalComm(8))
    lay, eng = td.make_flat(params)
    fp = lay.flatten(params)
    g = torch.from_numpy(np.random.RandomState(3).randn(lay.total).astype(
        np.float32))
    _, _, red = td.update_flat([g] * 8, td.init_per_worker(fp), fp,
                               [{}] * 8, [None] * 8, eng)
    np.testing.assert_allclose(red[0].numpy(), (-0.1 * g).numpy(),
                               rtol=1e-4, atol=1e-6)
    params = {"w": np.random.RandomState(4).randn(64, 64).astype(np.float32)}
    _, tc = _dgc_pair(params)
    td = tada.AdasumDistributedOptimizer(dgc_sgd(0.1, momentum=0.9), tc,
                                         LocalComm(8))
    lay, eng = td.make_flat(params)
    fp = lay.flatten(params)
    g = torch.from_numpy(np.random.RandomState(5).randn(lay.total).astype(
        np.float32))
    _, _, red = td.update_flat(
        [g] * 8, td.init_per_worker(fp), fp,
        [eng.init_memory("cpu") for _ in range(8)],
        [eng.draw_phases(torch.Generator())] * 8, eng)
    u = red[0].numpy()[:lay.t_data] if hasattr(lay, "t_data") else \
        red[0].numpy()
    nz = np.flatnonzero(u)
    assert nz.size > 0
    np.testing.assert_allclose(u[nz], 8 * (-0.1 * g.numpy()[nz]), rtol=1e-6)


@pytest.mark.parametrize("world", [4, 3])
@pytest.mark.parametrize("dgc", [False, True])
def test_per_tensor_adasum_matches_jax(world, dgc):
    """``AdasumDistributedOptimizer.update`` (per tensor), distinct
    per-worker gradients on the grid: the dense compressor (every tensor
    through the Adasum all-reduce) and DGC (the compressed weight's deltas
    summed, the bias's combined by Adasum and corrected) — bitwise the JAX
    per-tensor update run op by op under ``jax.vmap``."""
    params = _params()
    named = jax_named_flatten(params)[0]
    if dgc:
        jc, tc = _dgc_pair(params)
        jopt_f, topt_f = (jax_dgc_sgd(0.1, momentum=0.9),
                          dgc_sgd(0.1, momentum=0.9))
    else:
        jc, tc = Compression.none(), TCompression.none()
        jopt_f, topt_f = jax_sgd(0.1), sgd(0.1)
    jd = jada.AdasumDistributedOptimizer(jopt_f, jc, world_size=world)
    td = tada.AdasumDistributedOptimizer(topt_f, tc, LocalComm(world))
    tlay = td.make_flat(params)[0] if dgc else __import__(
        "dgc_tpu_torch.compression.flat", fromlist=["ParamLayout"]
    ).ParamLayout(params)
    rng = np.random.RandomState(7)
    gw = {n: _grid(rng, (world,) + p.shape) for n, p in named.items()}
    jopt = jd.init(params)
    jmem = jax.tree.map(lambda x: jnp.stack([x] * world),
                        jd.init_memory(params))

    def worker(g, mem, key):
        upd, _, mem = jd.update(g, jopt, params, mem, key)
        return upd, mem
    jupd, jmem = jax.vmap(worker, in_axes=(0, 0, None), axis_name="data")(
        {k: jnp.asarray(v) for k, v in gw.items()}, jmem,
        jax.random.PRNGKey(0))
    fp = tlay.flatten({n: torch.from_numpy(p) for n, p in named.items()})
    tmem = [td.init_memory({n: torch.from_numpy(p)
                            for n, p in named.items()})
            for _ in range(world)]
    phases = [td.compressor.draw_phases(torch.Generator())
              for _ in range(world)]
    _, _, outs = td.update(
        [{n: torch.from_numpy(gw[n][w]) for n in named}
         for w in range(world)], td.init_per_worker(fp), fp, tmem, phases,
        tlay)
    for w in range(world):
        for n in named:
            got, want = outs[w][n].numpy(), np.asarray(jupd[n])[w]
            if dgc and n == "w":     # compressed: the deltas summed
                np.testing.assert_array_equal(_bits(got), _bits(want),
                                              err_msg=n)
            else:                    # through the Adasum all-reduce
                _close(got, want, n)
        if dgc:
            for k in ("momentums", "velocities"):
                for n in tmem[w][k]:
                    got = tmem[w][k][n].numpy()
                    want = np.asarray(jmem[k][n])[w]
                    if n == "w":
                        np.testing.assert_array_equal(_bits(got),
                                                      _bits(want), k + n)
                    else:
                        _close(got, want, k + n)


def test_two_tier_adasum_node_mean_is_the_participant():
    """Two tiers (2 nodes x 4): the Adasum exchange equals the flat
    2-participant one fed the exact node means (test_hierarchical.py's
    oracle), and orthogonal node deltas on the dense block add."""
    params = _params(24)
    _, tc = _dgc_pair(params)
    t2 = tada.AdasumDistributedOptimizer(sgd(0.1), tc, LocalComm(8),
                                         local_size=4)
    tf = tada.AdasumDistributedOptimizer(sgd(0.1), tc, LocalComm(2))
    assert t2.num_nodes == 2 and t2.per_worker_opt_state
    lay, eng = t2.make_flat(params)
    rng = np.random.RandomState(9)
    g = _grid(rng, (8, lay.total))
    nodes = g.reshape(2, 4, -1).sum(1) / 4
    m2 = [eng.init_memory("cpu") for _ in range(8)]
    mf = [eng.init_memory("cpu") for _ in range(2)]
    ph = eng.draw_phases(torch.Generator())
    o2 = eng.exchange([torch.from_numpy(x) for x in g], m2, [ph] * 8,
                      t2.cross_comm, op="adasum", local_comm=t2.local_comm)
    of = eng.exchange([torch.from_numpy(x) for x in nodes], mf, [ph] * 2,
                      tf.comm, op="adasum")
    for w in range(8):
        np.testing.assert_array_equal(o2[w].numpy(), of[w // 4].numpy())
        for k in m2[w]:
            np.testing.assert_array_equal(m2[w][k].numpy(),
                                          mf[w // 4][k].numpy())
    db = lay.offsets[lay.dense_names[0]]
    probe = np.zeros((8, lay.total), np.float32)
    probe[:4, db] = 1.0
    probe[4:, db + 1] = 1.0
    out = eng.exchange([torch.from_numpy(x) for x in probe],
                       [eng.init_memory("cpu") for _ in range(8)], [ph] * 8,
                       t2.cross_comm, op="adasum", local_comm=t2.local_comm)
    assert float(out[0][db]) == pytest.approx(1.0, rel=1e-6)
    assert float(out[0][db + 1]) == pytest.approx(1.0, rel=1e-6)


def test_adasum_trainer_keeps_per_worker_state_in_checkpoints(tmp_path):
    """A ``Trainer(adasum=True)`` keeps one optimizer state a worker; a
    checkpoint writes each into its ``w<r>.pt`` and restores them bitwise;
    the elastic restore refuses them (no mass-conserving merge of
    optimizer moments)."""
    from dgc_tpu_torch import configs
    from dgc_tpu_torch.train import Trainer
    from dgc_tpu_torch.training.checkpoint import (CheckpointManager,
                                                   TopologyMismatch)
    cfg = configs.resnet20_wm5()
    cfg.dataset.synthetic_size = 32
    cfg.train.batch_size = 4

    def make(world=2):
        return Trainer(cfg, LocalComm(world), "cpu", adasum=True)
    t = make()
    assert isinstance(t.state.opt_state, list) and len(t.state.opt_state) == 2
    t.run_epoch(5, 2)
    bufs = [s.momentum_buffer.detach().numpy().copy()
            for s in t.state.opt_state]
    ckpt = CheckpointManager(str(tmp_path))
    t.save_checkpoint(ckpt, 5, {"acc/test_top1": 0.0})
    w0 = torch.load(tmp_path / "e5" / "w0.pt", weights_only=True)
    assert "opt:momentum_buffer" in w0
    u = make()
    assert u.restore_checkpoint(ckpt)[0] == 5
    for s, b in zip(u.state.opt_state, bufs):
        np.testing.assert_array_equal(s.momentum_buffer.detach().numpy(), b)
    assert [s.count for s in u.state.opt_state] == [2, 2]
    with pytest.raises(TopologyMismatch, match="per-worker optimizer"):
        make(4).restore_checkpoint(ckpt, elastic=True)


def test_interop_carries_guards_and_per_worker_state():
    """``interop.carry_train_state`` takes the JAX guard state and, under
    the Adasum scheme, the ``[world]``-stacked optimizer state, bit for
    bit."""
    from dgc_tpu.resilience import GuardConfig, guard as jguard
    from dgc_tpu.training import TrainState as JState
    from dgc_tpu_torch import interop
    from dgc_tpu_torch.resilience import guard as tguard
    cfg = GuardConfig(spike_window=3)
    gs = jguard.init_state(cfg)
    for v in (1.0, 2.0, float("nan")):
        _, gs, _ = jguard.apply(cfg, gs, bad_count=jnp.asarray(0.0),
                                mean_loss=jnp.asarray(v),
                                checksum_failures=jnp.asarray(1.0))
    gs = jax.device_get(gs)
    jd = jada.AdasumDistributedOptimizer(
        jax_sgd(0.1, momentum=0.9), Compression.none(), world_size=3)
    p = np.arange(8, dtype=np.float32)
    opt = jd.init(jnp.asarray(p))
    rng = np.random.RandomState(0)
    opt = opt._replace(count=jnp.asarray([1, 2, 3], jnp.int32),
                       momentum_buffer=jnp.asarray(rng.randn(3, 8),
                                                   jnp.float32))
    js = JState(step=jnp.asarray(4, jnp.int32), params=jnp.asarray(p),
                opt_state=jax.device_get(opt),
                memory={"momentums_c": np.zeros((3, 4), np.float32)},
                batch_stats=np.zeros((3, 2), np.float32), guards=gs)
    ts = interop.carry_train_state(js, per_worker_opt=True)
    assert [s.count for s in ts.opt_state] == [1, 2, 3]
    for w in range(3):
        np.testing.assert_array_equal(
            ts.opt_state[w].momentum_buffer.numpy(),
            np.asarray(opt.momentum_buffer)[w])
    assert set(ts.guards) == set(tguard.init_state(
        tguard.GuardConfig(spike_window=3)))
    for k, v in gs.items():
        assert ts.guards[k].numpy().dtype == np.asarray(v).dtype
        np.testing.assert_array_equal(ts.guards[k].numpy(), np.asarray(v))
