"""The port's record-less and count-masked compensates and its ladder counts
(their plain PyTorch versions, which the wrappers run on CPU tensors)
against the JAX package's kernels and references, on the same numpy
inputs; and the engine's full-scan ladder adaptation against the JAX
package's.

Against the op-by-op jnp references everything is bitwise. Against the
Pallas compensates in interpret mode (jitted), f32 state is held within
4 eps (|m| + |g| + |v|): under jit XLA-CPU contracts ``momentum * m0 + g``
into an FMA, which the port's kernel (launched with FMA contraction off)
does not. With bf16 state the one rounding to bf16 absorbs that gap
almost everywhere, but not where the two f32 values straddle a bf16
rounding boundary (2 of 8,192 elements in one case here): there the
stored values are one bf16 step apart, so bf16 state is held within one
step of the Pallas kernel's. Under jit XLA-CPU also rewrites the keep
mask's multiply into a select, so a NaN in masked-out state stays NaN in
the reference and the port but not in the jitted Pallas kernel: against
the Pallas kernels only the finite state is compared. The Pallas ladder
kernel is bitwise; the inputs hold no subnormal values, which XLA-CPU
compares as zero (the port, like IEEE, does not)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgc_tpu.compression import flat as jflat
from dgc_tpu.ops import kernels as jk
from dgc_tpu_torch.compression import flat as tflat
from dgc_tpu_torch.ops import kernels as tk

_EPS = np.finfo(np.float32).eps


def _bits(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16)
    return a.view(np.int32)


def _assert_same(got_bits, want):
    """Bitwise, except that a bf16 NaN need only be a NaN: the CPU's f32 ->
    bf16 conversion in PyTorch writes the canonical NaN, XLA keeps the
    sign and the payload's top bits."""
    want = np.asarray(want)
    if want.dtype.name == "bfloat16":
        nan = np.isnan(np.asarray(want, np.float32))
        got_nan = (got_bits & 0x7FFF) > 0x7F80
        np.testing.assert_array_equal(got_nan, nan)
        got_bits, want = got_bits[~nan], want[~nan]
    np.testing.assert_array_equal(got_bits, _bits(want))


def _within_one_bf16_step(got_bits, want):
    """Every stored bf16 value equal to the Pallas kernel's (as a number:
    the jitted kernel may write +0.0 for -0.0, as ROADMAP queue 3 records
    for the f32 compensates) or one bf16 step from it (adjacent values of
    one sign differ by one in their int16 bits)."""
    wb = _bits(want)
    zero = ((got_bits & 0x7FFF) == 0) & ((wb & 0x7FFF) == 0)
    d = np.abs(got_bits.astype(np.int32) - wb.astype(np.int32))
    assert d[~zero].max(initial=0) <= 1


def _state(rng, n, dtype):
    """f32 gradient, state in ``dtype`` (numpy f32 arrays holding exactly
    representable values, and the torch state), with zeros, signed zeros
    and a few large values planted."""
    g, m, v = (rng.randn(n).astype(np.float32) for _ in range(3))
    m[::97] = 0.0
    g[::89] = -0.0
    v[::53] = 1e4
    if dtype == "bfloat16":
        m, v = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
                for x in (m, v))
    return g, m, v


def _torch_state(x, dtype):
    return torch.from_numpy(x.copy()).to(getattr(torch, dtype))


def _jax_state(x, dtype):
    return jnp.asarray(x, getattr(jnp, dtype))


def _sent(rng, n):
    """A transmit count vector: mostly 0 (keep), some 1 and 2."""
    sent = np.zeros(n, np.float32)
    sent[rng.choice(n, n // 5, replace=False)] = 1.0
    sent[rng.choice(n, n // 50, replace=False)] = 2.0
    return sent


@pytest.mark.parametrize("n", [5000, 8192])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nesterov", [False, True])
def test_fused_compensate_matches_jax(n, dtype, nesterov):
    rng = np.random.RandomState(n + 3 * nesterov)
    g, m, v = _state(rng, n, dtype)
    rm, rv = jk.fused_compensate_reference(
        jnp.asarray(g), _jax_state(m, dtype), _jax_state(v, dtype), 0.9,
        nesterov)
    tm, tv = _torch_state(m, dtype), _torch_state(v, dtype)
    out = tk.fused_compensate(torch.from_numpy(g), tm, tv, 0.9, nesterov)
    assert out[0] is tm and out[1] is tv               # updated in place
    assert tm.dtype == getattr(torch, dtype)
    got = [x.view(torch.int16 if dtype == "bfloat16" else torch.int32)
           .numpy() for x in (tm, tv)]
    np.testing.assert_array_equal(got[0], _bits(rm))
    np.testing.assert_array_equal(got[1], _bits(rv))

    pm, pv = jk.fused_compensate(jnp.asarray(g), _jax_state(m, dtype),
                                 _jax_state(v, dtype), 0.9, nesterov)
    if dtype == "bfloat16":
        _within_one_bf16_step(got[0], pm)
        _within_one_bf16_step(got[1], pv)
    else:
        bound = 4 * _EPS * (np.abs(m) + np.abs(g) + np.abs(v))
        assert (np.abs(tm.numpy() - np.asarray(pm)) <= bound).all()
        assert (np.abs(tv.numpy() - np.asarray(pv)) <= bound).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("momentum_masking", [False, True])
def test_fused_compensate_masked_matches_jax(dtype, nesterov,
                                             momentum_masking):
    n = 6001                                           # unaligned
    rng = np.random.RandomState(17 + 2 * nesterov + momentum_masking)
    g, m, v = _state(rng, n, dtype)
    m[5], v[5] = np.nan, np.nan          # masked out: the product stays NaN
    sent = _sent(rng, n)
    sent[5] = 1.0
    args = dict(momentum=0.9, nesterov=nesterov,
                momentum_masking=momentum_masking)
    rm, rv = jk.fused_compensate_masked_reference(
        jnp.asarray(g), _jax_state(m, dtype), _jax_state(v, dtype),
        jnp.asarray(sent), **args)
    tm, tv = _torch_state(m, dtype), _torch_state(v, dtype)
    out = tk.fused_compensate_masked(torch.from_numpy(g), tm, tv,
                                     torch.from_numpy(sent), **args)
    assert out[0] is tm and out[1] is tv
    view = torch.int16 if dtype == "bfloat16" else torch.int32
    got = [x.view(view).numpy() for x in (tm, tv)]
    _assert_same(got[0], rm)
    _assert_same(got[1], rv)
    assert np.isnan(tv[5].float().item())              # NaN * 0.0 is NaN

    pm, pv = jk.fused_compensate_masked(
        jnp.asarray(g), _jax_state(m, dtype), _jax_state(v, dtype),
        jnp.asarray(sent), **args)
    ok = np.isfinite(m) & np.isfinite(v)
    if dtype == "bfloat16":
        for x, p in ((got[0], pm), (got[1], pv)):
            _within_one_bf16_step(x[ok], np.asarray(p)[ok])
    else:
        bound = 4 * _EPS * (np.abs(m) + np.abs(g) + np.abs(v))
        for t, p in ((tm, pm), (tv, pv)):
            t, p = t.numpy(), np.asarray(p)
            assert (np.abs(t - p)[ok] <= bound[ok]).all()


@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("momentum_masking", [False, True])
def test_masked_compensate_on_a_record_is_compensate_bits(
        nesterov, momentum_masking):
    """The count-masked compensate with ``sent`` expanded from a packed
    transmit record computes what the bit-masked one does on that record,
    bitwise."""
    total = 10240
    rng = np.random.RandomState(29)
    g, m, v = _state(rng, total, "float32")
    idx = torch.from_numpy(rng.choice(total, total // 4,
                                      replace=False).astype(np.int32))
    bits = tk.pack_sent_bits(idx, total)
    sent = 1.0 - tk.keep_from_bits(bits, total)
    args = dict(momentum=0.9, nesterov=nesterov,
                momentum_masking=momentum_masking)
    a = tk.fused_compensate_masked_plain(
        *(torch.from_numpy(x) for x in (g, m, v)), sent, **args)
    b = tk.compensate_bits_plain(*(torch.from_numpy(x) for x in (g, m, v)),
                                 bits, **args)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.view(torch.int32).numpy(),
                                      y.view(torch.int32).numpy())


def test_compensate_refuses_mixed_or_narrow_gradients():
    g = torch.zeros(8)
    with pytest.raises(ValueError):
        tk.fused_compensate(g, torch.zeros(8), torch.zeros(8,
                            dtype=torch.bfloat16), 0.9)
    with pytest.raises(ValueError):
        tk.fused_compensate(g.bfloat16(), torch.zeros(8), torch.zeros(8),
                            0.9)
    with pytest.raises(ValueError):
        tk.fused_compensate_masked(g, torch.zeros(8), torch.zeros(8),
                                   torch.zeros(8, dtype=torch.int32), 0.9)


def _ladder_input(rng, R, cols, levels):
    """[R, cols] importance with a -1 row tail, per-row thresholds (one
    zero), a NaN, and values planted exactly on the kernel's levels and
    one f32 step either side (where the threshold is not zero, whose
    neighbours would be subnormal)."""
    imp = np.abs(rng.randn(R, cols)).astype(np.float32)
    imp[:, cols - 37:] = -1.0
    thr = (rng.rand(R) * 2).astype(np.float32)
    thr[1 % R] = 0.0
    imp[0, 3] = np.nan
    factors = np.array([np.float32(0.8 ** i) for i in range(levels)],
                       np.float32)
    for r in range(R):
        if thr[r] == 0:
            continue
        for i in range(levels):
            level = np.float32(factors[i] * thr[r])
            c = 10 + 3 * i
            if c + 2 < cols - 37:
                imp[r, c] = level
                imp[r, c + 1] = np.nextafter(level, np.float32(np.inf))
                imp[r, c + 2] = np.nextafter(level, np.float32(-np.inf))
    return imp, thr


@pytest.mark.parametrize("levels", [1, 11, 17])
@pytest.mark.parametrize("shape", [(5, 3000), (9, 1024)])
def test_ladder_counts_matches_jax(levels, shape):
    rng = np.random.RandomState(levels + shape[0])
    imp, thr = _ladder_input(rng, *shape, levels)
    got = tk.ladder_counts(torch.from_numpy(imp), torch.from_numpy(thr),
                           0.8, levels)
    assert got.dtype == torch.int32 and got.shape == (shape[0], levels)
    ref = jk.ladder_counts_reference(jnp.asarray(imp), jnp.asarray(thr), 0.8,
                                     levels)
    pallas = jk.ladder_counts(jnp.asarray(imp), jnp.asarray(thr), 0.8,
                              levels)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    # thr = 0 counts every non-negative entry at every level, NaN never
    assert (got[1 % shape[0]] == int((imp[1 % shape[0]] >= 0).sum())).all()


def test_ladder_counts_refuses_too_many_levels():
    with pytest.raises(ValueError):
        tk.ladder_counts(torch.zeros(2, 8), torch.zeros(2), 0.8, 129)


def test_ladder_adapt_matches_jax():
    """``_ladder_adapt`` (the full scan through the ladder counts) and the
    engine's from-top-k derivation, both bitwise the JAX package's, on
    test_flat.py's equivalence data: descending, immediately passing and
    saturated count regimes."""
    rng = np.random.RandomState(11)
    R, cols, k = 6, 4096, 64
    imp = np.abs(rng.randn(R, cols)).astype(np.float32)
    num_selects = rng.randint(8, k + 1, R).astype(np.float32)
    adapt = np.array([True] * (R - 1) + [False])
    ti, tns, tad = (torch.from_numpy(x) for x in (imp, num_selects, adapt))
    top = tflat.lax_top_k(ti, k)[0]
    jtop = np.asarray(jk.topk_rows_reference(jnp.asarray(imp), k)[0])
    np.testing.assert_array_equal(top.numpy(), jtop)
    for scale in (8.0, 1.0, 0.05):
        thr = np.ascontiguousarray(jtop[:, k // 2] * np.float32(scale))
        want_a = jflat._ladder_adapt(jnp.asarray(imp), jnp.asarray(thr),
                                     jnp.asarray(num_selects),
                                     jnp.asarray(adapt), 0.8, 10)
        want_b = jflat._ladder_adapt_from_topk(
            jnp.asarray(jtop), jnp.asarray(thr), jnp.asarray(num_selects),
            jnp.asarray(adapt), 0.8, 10)
        got_a = tflat._ladder_adapt(ti, torch.from_numpy(thr), tns, tad,
                                    0.8, 10)
        got_b = tflat._ladder_adapt_from_topk(top, torch.from_numpy(thr), tns,
                                              tad, 0.8, 10)
        np.testing.assert_array_equal(_bits(got_a.numpy()), _bits(want_a))
        np.testing.assert_array_equal(_bits(got_b.numpy()), _bits(want_b))
        np.testing.assert_array_equal(got_a.numpy(), got_b.numpy())


def test_the_two_ladders_differ_in_the_gap_as_in_jax():
    """The ladder kernel's level 2 is float32(0.8 ** 2) = 0.64 (rounded
    once from the double power); the pick's and the from-top-k counts'
    is float32(float32(0.8) ** 2) = 0.64000005. An importance of 0.64 at
    threshold 1 is counted by the full scan and not by the from-top-k
    counts, which moves the pick: in the port exactly as in the JAX
    package."""
    f_kernel = tk.ladder_factors(0.8, 11).numpy()
    f_pick = tflat._pow_ladder(0.8, 11)
    gap = np.nonzero(f_kernel != f_pick)[0].tolist()
    assert gap == [2, 4, 5, 6, 7, 8, 9, 10]
    assert f_kernel[2] < f_pick[2]
    imp = np.full((1, 256), 0.01, np.float32)
    imp[0, :3] = 0.9                     # pass level 1 (0.8)
    imp[0, 3] = f_kernel[2]              # in the gap at level 2
    thr = np.ones(1, np.float32)
    num_selects = np.array([5.0], np.float32)     # lo = 4
    adapt = np.array([True])
    k = 8
    want_a = np.asarray(jflat._ladder_adapt(
        jnp.asarray(imp), jnp.asarray(thr), jnp.asarray(num_selects),
        jnp.asarray(adapt), 0.8, 10))
    want_b = np.asarray(jflat._ladder_adapt_from_topk(
        jk.topk_rows_reference(jnp.asarray(imp), k)[0], jnp.asarray(thr),
        jnp.asarray(num_selects), jnp.asarray(adapt), 0.8, 10))
    ti = torch.from_numpy(imp)
    args = (torch.from_numpy(thr), torch.from_numpy(num_selects),
            torch.from_numpy(adapt), 0.8, 10)
    got_a = tflat._ladder_adapt(ti, *args).numpy()
    got_b = tflat._ladder_adapt_from_topk(tflat.lax_top_k(ti, k)[0],
                                          *args).numpy()
    assert want_a[0] != want_b[0]
    np.testing.assert_array_equal(_bits(got_a), _bits(want_a))
    np.testing.assert_array_equal(_bits(got_b), _bits(want_b))
