"""The straggler-adaptive exchange against the JAX package.

* ``update_policy``: bitwise the JAX policy in f32 over seeded random
  clocks at even and odd worlds (``jnp.median`` averages the two middle
  values of an even column), through the ramp tier, the partial tier and
  the median floor, engaged and not.
* ``exchange(send_frac=...)``: W=8 on ResNet-20's layout at the warm-up's
  first ratio and at 0.001, each worker at its own fraction, against the
  JAX engine's ``exchange(send_frac=...)`` run op by op under ``jax.vmap``
  with the same sampling phases: the payload, the transmit record and
  the memory bitwise, the exchanged gradient bitwise apart from
  coordinates several workers sent (rtol 1e-6); the withheld values stay
  in the velocity; ``payload_elems`` counts the wire after the mask while
  ``selected_frac`` and ``threshold`` describe the selection before it;
  at a fraction of 1 the exchange is bitwise the one without.
* The train step: fed an explicit skewed clock (one worker 150 ms past
  the 200 ms median), the next step's fraction of that worker is
  1 - 0.75 x 150 / 500 and reaches the wire, and an even clock releases
  it at once; the policy state is not checkpointed.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgc_tpu import DGCCompressor, DGCSGDMemory
from dgc_tpu.compression.flat import FlatDGCEngine, ParamLayout
from dgc_tpu.models import resnet20
from dgc_tpu.resilience import adaptive as jad
from dgc_tpu.utils.pytree import named_flatten as jax_named_flatten
from dgc_tpu_torch import configs as tconfigs
from dgc_tpu_torch.compression import dgc as tdgc
from dgc_tpu_torch.compression import flat as tflat
from dgc_tpu_torch.compression.memory import DGCSGDMemory as TMemory
from dgc_tpu_torch.parallel.comm import LocalComm
from dgc_tpu_torch.resilience import adaptive as tad
from dgc_tpu_torch.train import Trainer
from dgc_tpu_torch.training.checkpoint import CheckpointManager

W = 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread (the file runs beside other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


# --------------------------------------------------------------------- #
# the policy                                                             #
# --------------------------------------------------------------------- #

def _both(cfg, clock):
    c = np.asarray(clock, np.float32)
    got = tad.update_policy(cfg, torch.from_numpy(c)).numpy()
    want = np.asarray(jad.update_policy(cfg, jnp.asarray(c)))
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=str(c))
    return got


@pytest.mark.parametrize("world", [1, 2, 3, 4, 5, 8, 9])
def test_policy_matches_jax_bitwise(world):
    cfg = tad.AdaptiveConfig()
    assert tuple(cfg) == tuple(jad.AdaptiveConfig())
    rng = np.random.RandomState(world)
    engaged = 0
    for _ in range(60):
        clock = rng.choice([10.0, 200.0, 1000.0]) * rng.rand(world)
        if rng.rand() < 0.3:
            clock[rng.randint(world)] += rng.choice([150.0, 900.0, 5000.0])
        got = _both(cfg, clock)
        engaged += bool((got < 1).any())
    if world > 1:
        assert engaged > 0
    # the ramp tier at an even world: the median averages the middles
    clock = [200.0] * (world - 1) + [350.0]
    got = _both(cfg, clock)
    if world > 2:
        assert got[-1] == np.float32(1.0) - np.float32(0.75) * (
            np.float32(150.0) / np.float32(500.0))
        assert (got[:-1] == 1.0).all()


def test_policy_tiers_floor_and_knobs():
    cfg = tad.AdaptiveConfig()
    # the partial tier: past deadline_factor x median
    got = _both(cfg, [100.0, 100.0, 100.0, 900.0])
    assert got[3] == np.float32(0.02) and (got[:3] == 1.0).all()
    # the floor: every stamp ~0 (the first step) — a worker at 5 ms is
    # past 4 x max(median, 1 ms) but the gap does not engage the policy
    np.testing.assert_array_equal(_both(cfg, [0.0, 0.0, 0.0, 5.0]),
                                  np.ones(4, np.float32))
    low = tad.AdaptiveConfig(engage_gap_ms=1.0)
    got = _both(low, [0.0, 0.0, 0.0, 5.0])
    assert got[3] == np.float32(0.02)
    # an even column's median is the mean of its middles, not the lower
    got = _both(low, [0.0, 10.0, 30.0, 40.0])
    assert got[0] == 1.0 and got[3] < 1.0
    tuned = tad.AdaptiveConfig(min_frac=0.5, ramp_ms=100.0,
                               deadline_factor=10.0)
    got = _both(tuned, [200.0, 200.0, 260.0, 900.0])
    assert got[3] == np.float32(0.5)
    st = tad.init_state(4)
    assert st["w_frac"].dtype == torch.float32 and bool(
        (st["w_frac"] == 1).all())


# --------------------------------------------------------------------- #
# the engine's masked exchange                                           #
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def r20_params():
    v = jax.eval_shape(lambda: resnet20().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=True))
    return jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), v["params"])


def _engines(tree, epoch):
    common = dict(sample_ratio=0.01, warmup_epochs=5)
    jc = DGCCompressor(0.001, memory=DGCSGDMemory(momentum=0.9),
                       approx_recall=None, **common)
    tc = tdgc.DGCCompressor(0.001, memory=TMemory(momentum=0.9), **common)
    named = jax_named_flatten(tree)[0]
    jc.initialize((n, p) for n, p in named.items() if np.ndim(p) > 1)
    tc.initialize((n, np.shape(p)) for n, p in named.items()
                  if np.ndim(p) > 1)
    jc.warmup_compress_ratio(epoch)
    tc.warmup_compress_ratio(epoch)
    return (FlatDGCEngine(jc, ParamLayout.for_compressor(tree, jc)),
            tflat.FlatDGCEngine(tc, tflat.ParamLayout.for_compressor(tree,
                                                                    tc)))


def _phases(engine, key):
    out = []
    for w in range(W):
        kw = jax.random.fold_in(key, w)
        out.append([[] if b.exact else [
            float(jax.random.uniform(jax.random.fold_in(
                jax.random.fold_in(kw, bi), gi), ()))
            for gi in range(len(b.stride_groups))]
            for bi, b in enumerate(engine.buckets)])
    return out


#: each worker's send fraction: full, ramped, partial, in between
_FRACS = np.asarray([1.0, 0.775, 0.02, 0.5, 1.0, 0.3, 0.9, 1.0], np.float32)


@pytest.mark.parametrize("epoch", [0, 5])
def test_masked_exchange_matches_jax(r20_params, epoch):
    je, te = _engines(r20_params, epoch)
    np.testing.assert_array_equal(te._adaptive_rank, je._adaptive_rank)
    np.testing.assert_array_equal(te._adaptive_quota, je._adaptive_quota)
    S, P_ = te.layout.sentinel, te.layout.total

    def worker(fg, mem, key, frac):
        key = jax.random.fold_in(key, jax.lax.axis_index("data"))
        _, mc, vc, _ = je._compensate_acc(
            mem["momentums_c"], mem["velocities_c"], fg, mem["sent_bits"])
        vals, idx = je.sparsify(vc, key)
        keep = (jnp.asarray(je._adaptive_rank)
                < jnp.ceil(jnp.asarray(je._adaptive_quota) * frac))
        vals = jnp.where(keep, vals, 0.0)
        idx = jnp.where(keep, idx, jnp.asarray(S, idx.dtype))
        out, mem, st = je.exchange(fg, mem, key, "data", W, telemetry=True,
                                   send_frac=frac)
        return out, mem, vals, idx, st
    step = jax.vmap(worker, in_axes=(0, 0, None, 0), axis_name="data")
    jmem = jax.tree.map(lambda x: jnp.stack([x] * W), je.init_memory())
    tmems = [te.init_memory("cpu") for _ in range(W)]
    rng = np.random.RandomState(epoch)
    tfracs = [torch.tensor(f) for f in _FRACS]
    for s in range(2):
        g = rng.randn(W, P_).astype(np.float32)
        key = jax.random.PRNGKey(s)
        jout, jmem, jvals, jidx, jst = step(jnp.asarray(g), jmem, key,
                                            jnp.asarray(_FRACS))
        phases = _phases(je, key)
        pre = [{k: v.clone() for k, v in m.items()} for m in tmems]
        sent = [te.mask_send_frac(*te.compress(torch.from_numpy(g[w]),
                                               pre[w], phases[w]),
                                  tfracs[w]) for w in range(W)]
        touts, tst = te.exchange([torch.from_numpy(x) for x in g], tmems,
                                 phases, LocalComm(W), telemetry=True,
                                 send_frac=tfracs)
        for w in range(W):
            np.testing.assert_array_equal(_bits(sent[w][0].numpy()),
                                          _bits(jvals[w]))
            np.testing.assert_array_equal(sent[w][1].numpy(),
                                          np.asarray(jidx[w]))
            for k in tmems[w]:
                np.testing.assert_array_equal(
                    _bits(tmems[w][k].numpy()), _bits(jmem[k][w]),
                    err_msg=f"step {s} {k}")
            for k in ("payload_elems", "selected_frac", "threshold"):
                np.testing.assert_array_equal(tst[w][k].numpy(),
                                              np.asarray(jst[k][w]))
            assert float(tst[w]["payload_elems"]) == float(
                (sent[w][1] != S).sum())
        real = np.asarray(jidx).reshape(-1)
        real = real[real != S]
        u, c = np.unique(real, return_counts=True)
        dup = np.zeros(P_, bool)
        dup[u[c > 1]] = True
        for w in range(W):
            got, ref = touts[w].numpy(), np.asarray(jout[w])
            np.testing.assert_array_equal(_bits(got[~dup]),
                                          _bits(ref[~dup]))
            np.testing.assert_allclose(got[dup], ref[dup], rtol=1e-6)
    # the partial worker sent at most ceil(quota * 0.02) a row
    quota = te._adaptive_quota
    rank = te._adaptive_rank
    cap = int((rank < np.ceil(quota * np.float32(0.02))).sum())
    assert 0 < int((sent[2][1] != S).sum()) <= cap


def test_full_fraction_is_bitwise_the_unmasked_exchange(r20_params):
    _, te = _engines(r20_params, 5)
    runs = []
    for frac in (None, [1.0] * 4):
        mems = [te.init_memory("cpu") for _ in range(4)]
        rng = np.random.RandomState(2)
        for s in range(2):
            g = [torch.from_numpy(rng.randn(te.layout.total).astype(
                np.float32)) for _ in range(4)]
            ph = [te.draw_phases(torch.Generator().manual_seed(s * 4 + w))
                  for w in range(4)]
            out = te.exchange(g, mems, ph, LocalComm(4), send_frac=frac)
        runs.append((out, mems))
    for a, b in zip(runs[0][0], runs[1][0]):
        assert torch.equal(a, b)
    for a, b in zip(runs[0][1], runs[1][1]):
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_withheld_mass_stays_in_the_velocity(r20_params):
    """A worker at fraction 0.3: the masked selections are not in its
    transmit record, so the next read of its velocity keeps them; the
    sent ones are zeroed on that read."""
    from dgc_tpu_torch.ops import kernels
    _, te = _engines(r20_params, 5)
    S = te.layout.sentinel
    mems = [te.init_memory("cpu") for _ in range(2)]
    g = [torch.from_numpy(np.random.RandomState(w).randn(
        te.layout.total).astype(np.float32)) for w in range(2)]
    ph = [te.draw_phases(torch.Generator().manual_seed(w)) for w in range(2)]
    pre = {k: v.clone() for k, v in mems[1].items()}
    vals, idx = te.compress(g[1], pre, ph[1])
    _, midx = te.mask_send_frac(vals, idx, 0.3)
    te.exchange(g, mems, ph, LocalComm(2), send_frac=[1.0, 0.3])
    keep = kernels.keep_from_bits(mems[1]["sent_bits"], te.T)
    withheld = idx[(idx != S) & (midx == S)].long()
    sent = midx[midx != S].long()
    assert withheld.numel() and sent.numel()
    assert bool((keep[withheld] == 1).all()) and bool((keep[sent] == 0).all())
    v = mems[1]["velocities_c"]
    assert torch.equal(v[withheld], vals[(idx != S) & (midx == S)])


# --------------------------------------------------------------------- #
# the train step                                                         #
# --------------------------------------------------------------------- #

def _cfg():
    cfg = tconfigs.with_adaptive(tconfigs.resnet20_wm5_telemetry())
    cfg.train.trace.enabled = False
    cfg.dataset.synthetic_size = 64
    cfg.train.batch_size = 4
    return cfg


def test_step_engages_on_a_skewed_clock_and_releases(tmp_path):
    t = Trainer(_cfg(), LocalComm(4), "cpu")
    assert t.adaptive == tad.AdaptiveConfig() and t.fleet
    clocks = iter([[200.0] * 4, [200.0, 200.0, 200.0, 350.0],
                   [200.0] * 4, [200.0] * 4])
    t.clock = lambda dt: torch.tensor(next(clocks))
    seen, fracs = [], []

    def on_step(batch, m):
        seen.append(m)
        fracs.append(t.state.adaptive["w_frac"].clone())
    t.run_epoch(5, 4, on_step=on_step)
    want = np.float32(1.0) - np.float32(0.75) * (np.float32(150.0)
                                                 / np.float32(500.0))
    # step 2's skewed clock sets step 3's fraction of worker 3
    assert fracs[1][3].item() == want and bool((fracs[1][:3] == 1).all())
    eff = [m["fleet"]["w_eff_ratio"] for m in seen]
    assert eff[2][3].item() == want and bool((eff[2][:3] == 1).all())
    assert [float(m["fleet"]["adaptive_engaged"]) for m in seen] == [
        0.0, 0.0, 1.0, 0.0]
    assert bool((fracs[2] == 1).all())        # memoryless release
    # worker 3's wire: at most its rows' ceil(quota * frac) slots
    eng = t.setup.engine
    cap = int((eng._adaptive_rank < np.ceil(eng._adaptive_quota
                                            * want)).sum())
    sent = seen[2]["fleet"]["w_sent_ratio"] * eng.layout.total
    assert 0 < sent[3].item() <= cap + 0.5
    assert sent[3].item() < sent[0].item()
    # the verdict is not checkpointed: a restore re-seeds full send
    t.state.adaptive = {"w_frac": fracs[1].clone()}
    ckpt = CheckpointManager(str(tmp_path / "c"))
    t.save_checkpoint(ckpt, 5, {"acc/test_top1": 1.0})
    u = Trainer(_cfg(), LocalComm(4), "cpu")
    assert u.restore_checkpoint(ckpt)[0] == 5
    assert bool((u.state.adaptive["w_frac"] == 1).all())
    assert not any(k.startswith("adaptive") for k in torch.load(
        tmp_path / "c" / "e5" / "state.pt", weights_only=True))


def test_step_refusals():
    from dgc_tpu_torch.training import step as tstep
    cfg = _cfg()
    t = Trainer(cfg, LocalComm(2), "cpu")
    xs = [torch.zeros(4, 3, 32, 32)] * 2
    ys = [torch.zeros(4, dtype=torch.int64)] * 2
    args = (t.model, t.setup, t.dist, t.state, xs, ys, t.gens)
    with pytest.raises(ValueError, match="require telemetry"):
        tstep.train_step(*args, fleet=True)
    with pytest.raises(ValueError, match="requires fleet"):
        tstep.train_step(*args, telemetry=True, adaptive=t.adaptive)
    with pytest.raises(ValueError, match="needs clock"):
        tstep.train_step(*args, telemetry=True, fleet=True)
    kept, t.state.adaptive = t.state.adaptive, None
    with pytest.raises(ValueError, match="make_flat_state"):
        tstep.train_step(*args, telemetry=True, fleet=True,
                         adaptive=t.adaptive, clock=torch.zeros(2))
    t.state.adaptive = kept
    with pytest.raises(ValueError, match="flat engine"):
        tstep.train_step_per_tensor(*args, telemetry=True)
    per = tstep.FlatSetup(t.setup.layout, t.setup.stats_layout, None)
    with pytest.raises(ValueError, match="flat engine"):
        tstep.train_step(t.model, per, t.dist, t.state, xs, ys, t.gens,
                         telemetry=True)
    from dgc_tpu_torch.optim.adasum import AdasumDistributedOptimizer
    ad = AdasumDistributedOptimizer(t.dist.optimizer, t.compression,
                                    LocalComm(2))
    with pytest.raises(NotImplementedError, match="telemetry"):
        ad.update_flat([], [], None, [], [], None, telemetry=True)
    with pytest.raises(NotImplementedError, match="send fractions"):
        ad.update_flat([], [], None, [], [], None, send_frac=[1.0])
    assert math.isfinite(float(t.run_epoch(5, 1)[0]))
