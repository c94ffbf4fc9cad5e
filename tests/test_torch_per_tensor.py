"""The port's per-tensor DGC contract — ``ops/sparsify.py``, the
error-feedback memory, the per-name memory carry and the refusals — against
the JAX package's ``dgc_tpu.ops.sparsify`` and
``dgc_tpu.compression.memory`` (op by op, on the same numpy inputs), and
the port's per-tensor exchange against its own flat engine.

Bitwise throughout, f32 and bf16 alike, with the reference's strided phase
(``jax.random.randint``) passed to the port. The port's per-tensor and flat
exchanges are held as the JAX package holds its two (test_flat.py:253-465):
the same gradients at ``sample_ratio=1.0`` over 3 steps give the same
exchanged gradients and memory within rtol 1e-5 / atol 1e-6; they are in
fact bitwise apart from coordinates several workers sent, whose sums the
flat apply and ``index_add_`` take in other orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgc_tpu.compression import memory as jmemory
from dgc_tpu.ops import sparsify as jops
from dgc_tpu_torch.compression import dgc as tdgc
from dgc_tpu_torch.compression import flat as tflat
from dgc_tpu_torch.compression import memory as tmemory
from dgc_tpu_torch.interop import carry_memory, export_memory
from dgc_tpu_torch.ops import sparsify as tops
from dgc_tpu_torch.optim.distributed import DistributedOptimizer as TDist
from dgc_tpu_torch.optim.sgd import dgc_sgd as t_dgc_sgd
from dgc_tpu_torch.parallel.comm import LocalComm
from dgc_tpu_torch.utils.pytree import named_flatten

DTYPES = ["float32", "bfloat16"]


def _bits(a):
    a = np.asarray(a) if not torch.is_tensor(a) else a
    if torch.is_tensor(a):
        return a.view(torch.int16 if a.dtype == torch.bfloat16
                      else torch.int32).numpy()
    return a.view(np.int16 if a.dtype.name == "bfloat16" else np.int32)


def _pair(x, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(np.asarray(x, np.float32), getattr(jnp, dtype))
    return j, torch.from_numpy(np.array(j, np.float32)).to(
        getattr(torch, dtype))


def _phase(key, stride):
    """The reference's strided phase for ``key``."""
    return int(jax.random.randint(key, (), 0, stride, dtype=jnp.int32))


# ------------------------------------------------------------------ #
# ops/sparsify.py                                                    #
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("dtype", DTYPES)
def test_sample_and_threshold_match_jax(dtype):
    rng = np.random.RandomState(1)
    x = np.abs(rng.randn(10007)).astype(np.float32)
    x[::50] = 1.25                                    # ties
    ji, ti = _pair(x, dtype)
    stride, ns = 33, 10007 // 33
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        want = jops.strided_sample(ji, ns, stride, key)
        got = tops.strided_sample(ti, ns, stride, _phase(key, stride))
        np.testing.assert_array_equal(_bits(got), _bits(want))
        for k in (1, 7, ns):
            np.testing.assert_array_equal(
                _bits(tops.topk_threshold(got, k)),
                _bits(jops.topk_threshold(want, k)))
    assert 0 <= tops.draw_phase(torch.Generator().manual_seed(0), 11) < 11


def _adapt_cases(rng):
    """``(name, importance, threshold, num_selects)``: too few pass (the
    threshold must come down), too many (up, without resample), a zero
    gradient, and random data at a sampled threshold."""
    few = np.concatenate([np.full(1, 100.0), np.full(99, 1.0)])
    many = np.full(1000, 1.0)
    many[:5] = 10.0
    rand = np.abs(rng.randn(20000))
    return [("too_few", few, 50.0, 10), ("too_many", many, 0.5, 5),
            ("zero", np.zeros(1000), 0.0, 10),
            ("random", rand, float(np.sort(rand[::97])[-3]), 20)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("resample", [True, False])
@pytest.mark.parametrize("max_iters", [10, 50])
def test_adapt_threshold_matches_jax(dtype, resample, max_iters):
    for name, imp, thr, ns in _adapt_cases(np.random.RandomState(2)):
        ji, ti = _pair(imp, dtype)
        jt, tt = _pair(np.float32(thr), dtype)
        want = jops.adapt_threshold(ji, jt, ns, 0.8, 1.3, max_iters,
                                    resample)
        got = tops.adapt_threshold(ti, tt, ns, 0.8, 1.3, max_iters,
                                   resample)
        assert got.dtype == tt.dtype
        np.testing.assert_array_equal(_bits(got), _bits(want),
                                      err_msg=name)


def _select_cases(rng):
    """``(name, values, threshold, num_selects)``: padding, overflow,
    ties (to the lower index), a zero gradient (everything passes a zero
    threshold; the padded index 0 is a real selection there)."""
    ties = rng.randn(3000)
    ties[[7, 1500, 2999, 40]] = [4.0, -4.0, 4.0, -4.0]
    return [("padding", np.array([0.1, -5.0, 0.2, 4.0, -0.3, 3.0]), 3.0, 4),
            ("overflow", np.arange(1.0, 11.0), 2.0, 3),
            ("ties", ties, 1.0, 64), ("ties_all", ties, 4.0, 3),
            ("zero", np.zeros(100), 0.0, 5)]


@pytest.mark.parametrize("dtype", DTYPES)
def test_select_by_threshold_matches_jax(dtype):
    for name, x, thr, ns in _select_cases(np.random.RandomState(3)):
        jx, tx = _pair(x, dtype)
        jt, tt = _pair(np.float32(thr), dtype)
        want = jops.select_by_threshold(jx, jnp.abs(jx), jt, ns)
        got = tops.select_by_threshold(tx, tx.abs(), tt, ns)
        np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]),
                                      err_msg=name)
        assert got[1].dtype == torch.int32
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]),
                                      err_msg=name)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]),
                                      err_msg=name)


def test_scatter_and_transmitted_mask_match_jax():
    idx = np.array([[0, 2, 2, 5], [5, 0, 1, 1]], np.int32)
    vals = np.array([[1.0, 2.0, 3.0, 4.0], [0.5, 0.0, 0.25, -1.0]],
                    np.float32)
    want = jops.scatter_add_dense(6, jnp.asarray(idx), jnp.asarray(vals))
    got = tops.scatter_add_dense(6, torch.from_numpy(idx),
                                 torch.from_numpy(vals))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    for i, v in (([3, 0, 0], [True, False, False]), ([0], [True]),
                 ([2, 2, 0], [False, True, False])):
        j = jops.transmitted_mask(6, jnp.asarray(i, jnp.int32),
                                  jnp.asarray(v))
        t = tops.transmitted_mask(6, torch.tensor(i, dtype=torch.int32),
                                  torch.tensor(v))
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# ------------------------------------------------------------------ #
# the memory                                                         #
# ------------------------------------------------------------------ #

def _memories(dtype, **kw):
    return (jmemory.DGCSGDMemory(momentum=0.9, dtype=dtype, **kw),
            tmemory.DGCSGDMemory(momentum=0.9, dtype=dtype, **kw))


def _assert_state(tstate, jstate):
    for key in ("momentums", "velocities"):
        assert sorted(tstate[key]) == sorted(jstate[key])
        for n, a in jstate[key].items():
            np.testing.assert_array_equal(_bits(tstate[key][n]), _bits(a),
                                          err_msg=f"{key} {n}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("momentum_masking", [False, True])
def test_memory_matches_jax(dtype, nesterov, momentum_masking):
    """Three rounds of compensate (accumulating for ``w``, the dense
    fallback for ``b``), update with padded slots (and a NaN at a sent
    coordinate, which the select replaces) and feed_back."""
    jm, tm = _memories(dtype, nesterov=nesterov,
                       momentum_masking=momentum_masking)
    shapes = {"b": (7,), "w": (40, 25)}
    params = [(n, np.zeros(s, np.float32)) for n, s in shapes.items()]
    js, ts = jm.init(params), tm.init(params)
    _assert_state(ts, js)
    assert all(t.dtype == getattr(torch, dtype)
               for t in ts["velocities"].values())
    rng = np.random.RandomState(4)
    for step in range(3):
        gw = rng.randn(40, 25).astype(np.float32)
        gb = rng.randn(7).astype(np.float32)
        jout, js = jm.compensate(js, "w", jnp.asarray(gw))
        tout, ts = tm.compensate(ts, "w", torch.from_numpy(gw))
        assert tout is ts["velocities"]["w"]     # the stored velocity
        np.testing.assert_array_equal(_bits(tout), _bits(jout))
        jd, js = jm.compensate(js, "b", jnp.asarray(gb), accumulate=False)
        td, ts = tm.compensate(ts, "b", torch.from_numpy(gb),
                               accumulate=False)
        assert td.dtype == torch.float32
        np.testing.assert_array_equal(_bits(td), _bits(jd))
        idx = np.concatenate([rng.choice(1000, 30, replace=False),
                              np.zeros(5)]).astype(np.int32)
        valid = np.arange(35) < 30
        if step == 1:
            js["velocities"]["w"] = js["velocities"]["w"].at[idx[0]].set(
                jnp.nan)
            ts["velocities"]["w"][idx[0]] = float("nan")
        js = jm.update(js, "w", jnp.asarray(idx), jnp.asarray(valid))
        ts = tm.update(ts, "w", torch.from_numpy(idx),
                       torch.from_numpy(valid))
        res = np.where(valid, rng.randn(35) * 1e-3, 0).astype(np.float32)
        js = jm.feed_back(js, "w", jnp.asarray(idx), jnp.asarray(res))
        ts = tm.feed_back(ts, "w", torch.from_numpy(idx),
                          torch.from_numpy(res))
        _assert_state(ts, js)


def test_memory_state_dict_roundtrip_and_carry():
    """``state_dict`` / ``load_state_dict`` (merge by name, cast to the live
    dtype) as in the reference, and the per-name state carried both ways
    through ``interop``, bf16 included."""
    jm, tm = _memories("bfloat16")
    params = [("w", np.zeros(50, np.float32)), ("b", np.zeros(3, np.float32))]
    rng = np.random.RandomState(5)
    js = jm.init(params)
    js = jm.compensate(js, "w", jnp.asarray(rng.randn(50), jnp.float32))[1]
    carried = carry_memory(jax.device_get(jm.state_dict(js)))
    assert carried["momentums"]["w"].dtype == torch.bfloat16
    _assert_state(carried, js)
    # f32 saved state into the live bf16 state, merged by name
    saved = {k: {"w": np.asarray(rng.randn(50), np.float32)}
             for k in ("momentums", "velocities")}
    want = jm.load_state_dict(jm.init(params), saved)
    got = tm.load_state_dict(tm.init(params), saved)
    _assert_state(got, want)
    # the port's state back into the JAX memory
    back = jm.load_state_dict(jm.init(params), export_memory(carried))
    _assert_state(carried, back)
    assert tm.state_dict(got) is got
    noop = tmemory.Memory()
    g = torch.ones(4)
    assert noop.compensate({}, "w", g)[0] is g and noop.init(params) == {}
    assert noop.state_dict({}) is None


# ------------------------------------------------------------------ #
# refusals                                                           #
# ------------------------------------------------------------------ #

def _small_layout(comp):
    tree = {"w": (64, 32), "b": (32,)}
    comp.initialize([("w", (64, 32))])
    return tflat.ParamLayout.for_compressor(tree, comp)


@pytest.mark.parametrize("kw", [
    dict(checksum=True, int8_values=True), dict(plan=("gossip_hcube",)),
    dict(memory=tmemory.DGCSGDMemory(dtype="float16"))])
def test_flat_engine_refuses_what_it_does_not_carry(kw):
    """The flat engine carries the bf16 state, the int8 / fp16 wires (the
    per-tensor path's too) and the payload checksum since they were
    ported; it still refuses the gossip regimes (ROADMAP.md queue 1 item
    8), the checksum over the int8 wire (its scales would ride uncovered,
    as the reference refuses it) and a state dtype the reference has no
    kernel for."""
    kw = dict(kw)
    plan = kw.pop("plan", None)
    comp = tdgc.DGCCompressor(0.05, **kw)
    with pytest.raises(ValueError, match="ROADMAP|float16|int8_values"):
        comp.make_flat_exchange(_small_layout(comp), plan=plan)


def test_unported_options_still_raise():
    # the flat engine's payload checksum is ported (the bf16 state, refused
    # here before, too); the per-tensor exchange refuses it, as the
    # reference keeps it to the flat engine
    comp = tdgc.DGCCompressor(0.05, checksum=True)
    comp.initialize([("w", (64, 64))])
    assert tflat.FlatDGCEngine(comp, tflat.ParamLayout(
        {"w": (64, 64), "b": (64,)}, ["w"])).checksum
    with pytest.raises(ValueError, match="per-tensor"):
        TDist(t_dgc_sgd(0.1), comp, LocalComm(2)).exchange(
            [{}, {}], [{}, {}], [{}, {}])
    for kw in (dict(memory=tmemory.DGCSGDMemory(dtype="bfloat16")),
               dict(int8_values=True), dict(fp16_values=True)):
        comp = tdgc.DGCCompressor(0.05, **kw)
        comp.make_flat_exchange(_small_layout(comp))
    # the two tiers are ported: a local_size that divides the world builds
    # them (tests/test_torch_twotier.py), one that does not is refused
    assert TDist(t_dgc_sgd(0.1), tdgc.DGCCompressor(0.05), LocalComm(2),
                 local_size=2).num_nodes == 1
    with pytest.raises(ValueError):
        TDist(t_dgc_sgd(0.1), tdgc.DGCCompressor(0.05), LocalComm(2),
              local_size=3)
    with pytest.raises(ValueError):
        tdgc.DGCCompressor(0.05, int8_values=True, fp16_values=True)


# ------------------------------------------------------------------ #
# per-tensor == flat, in the port                                    #
# ------------------------------------------------------------------ #

_TREE = {"conv1": {"kernel": (3, 3, 8, 16)}, "conv2": {"kernel": (3, 3, 16,
                                                                  16)},
         "dense": {"kernel": (64, 10), "bias": (10,)},
         "bn": {"scale": (16,), "bias": (16,)}}


@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("momentum_masking", [False, True])
def test_per_tensor_matches_flat_engine(nesterov, momentum_masking):
    W = 4
    named = named_flatten(_TREE)

    def make():
        comp = tdgc.DGCCompressor(
            0.05, memory=tmemory.DGCSGDMemory(
                momentum=0.9, nesterov=nesterov,
                momentum_masking=momentum_masking), sample_ratio=1.0)
        comp.initialize((n, s) for n, s in named.items() if len(s) > 1)
        return comp, TDist(t_dgc_sgd(0.1), comp, LocalComm(W))

    _, dist_f = make()
    _, dist_p = make()
    layout, engine = dist_f.make_flat(_TREE)
    mems_f = [engine.init_memory("cpu") for _ in range(W)]
    mems_p = [dist_p.init_memory(
        {n: torch.zeros(s) for n, s in named.items()}) for _ in range(W)]
    rng = np.random.RandomState(6)
    for step in range(3):
        grads = [{n: torch.from_numpy(rng.randn(*s).astype(np.float32))
                  for n, s in named.items()} for _ in range(W)]
        # sample_ratio=1.0: every tensor samples all of itself, so
        # neither path draws a phase
        out_f = engine.exchange([layout.flatten(g) for g in grads], mems_f,
                                [[[]] * len(engine.buckets)] * W,
                                LocalComm(W))
        out_p, mems_p = dist_p.exchange(grads, mems_p, [{}] * W)
        for w in range(W):
            got = layout.unflatten_named(out_f[w])
            for n in named:
                np.testing.assert_allclose(
                    got[n].numpy(), out_p[w][n].numpy(), rtol=1e-5,
                    atol=1e-6, err_msg=f"step {step} {n}")
            sd = engine.memory_state_dict(mems_f[w])
            for key in ("momentums", "velocities"):
                for n in named:
                    np.testing.assert_allclose(
                        sd[key][n].numpy(), mems_p[w][key][n].numpy(),
                        rtol=1e-5, atol=1e-6, err_msg=f"{key} {n}")
