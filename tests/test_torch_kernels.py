"""The port's kernel functions (their plain PyTorch versions, which the
wrappers run on CPU tensors) against the JAX package's kernels and
references, on the same numpy inputs.

Bitwise throughout, except the apply with cross-worker duplicate indices:
there the sums are compared within f32 rounding (rtol 1e-6), because the
reference's scatter leaves the order of duplicate updates to XLA, while
the port adds them in payload order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgc_tpu.ops import kernels as jk
from dgc_tpu_torch.ops import kernels as tk


def _bits_of(x):
    return np.asarray(x).view(np.int32)


def _record(rng, total, frac):
    """A transmit record over [total] from unique random indices, plus
    sentinel-padded slots."""
    n = int(total * frac)
    idx = rng.choice(total, n, replace=False).astype(np.int32)
    sentinel = total - 5
    idx = np.concatenate([idx[idx != sentinel],
                          np.full(7, sentinel, np.int32)])
    return idx, sentinel


@pytest.mark.parametrize("total", [8192, 10240])
def test_pack_and_keep_bits_match_jax(total):
    rng = np.random.RandomState(total)
    idx, sentinel = _record(rng, total, 0.3)
    assert tk.num_sent_words(total) == jk.num_sent_words(total)
    jb = jk.pack_sent_bits(jnp.asarray(idx), total, sentinel=sentinel)
    tb = tk.pack_sent_bits(torch.from_numpy(idx), total, sentinel=sentinel)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert (tb.numpy() < 0).any()          # bit 31 is exercised
    np.testing.assert_array_equal(
        tk.keep_from_bits(tb, total).numpy(),
        np.asarray(jk.keep_from_bits(jb, total)))


@pytest.mark.parametrize("total", [8192, 10240])      # T % 4096 in {0, 2048}
@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("momentum_masking", [False, True])
def test_compensate_bits_matches_jax(total, nesterov, momentum_masking):
    """Bitwise against ``fused_compensate_bits_reference`` run eagerly
    (op by op). Under jit — the Pallas kernel in interpret mode, and the
    jitted reference — XLA-CPU contracts multiply-adds such as
    ``momentum * m0 + g`` into FMAs (one rounding fewer; it may also turn
    the mask multiply's -0.0 into +0.0), while the port's kernel launches
    with FMA contraction off, to match its plain version bitwise on the
    card. Against the jitted forms the tolerance is therefore a few f32
    roundings of the operands' magnitude: 4 eps (|m| + |g| + |v|)."""
    rng = np.random.RandomState(7 + total)
    g, m, v = (rng.randn(total).astype(np.float32) for _ in range(3))
    m[::97] = 0.0
    g[::89] = -0.0
    idx, sentinel = _record(rng, total, 0.2)
    bits = np.asarray(jk.pack_sent_bits(jnp.asarray(idx), total,
                                        sentinel=sentinel))
    args = dict(momentum=0.9, nesterov=nesterov,
                momentum_masking=momentum_masking)
    jargs = [jnp.asarray(a) for a in (g, m, v, bits)]
    rm, rv = jk.fused_compensate_bits_reference(*jargs, **args)
    tm, tv = torch.from_numpy(m.copy()), torch.from_numpy(v.copy())
    out = tk.compensate_bits(torch.from_numpy(g), tm, tv,
                             torch.from_numpy(bits.copy()), **args)
    assert out[0] is tm and out[1] is tv          # updated in place
    np.testing.assert_array_equal(_bits_of(tm.numpy()), _bits_of(rm))
    np.testing.assert_array_equal(_bits_of(tv.numpy()), _bits_of(rv))

    bound = 4 * np.finfo(np.float32).eps * (np.abs(m) + np.abs(g)
                                            + np.abs(v))
    jitted = jax.jit(jk.fused_compensate_bits_reference,
                     static_argnames=tuple(args))
    for jm, jv in (jk.fused_compensate_bits(*jargs, **args),
                   jitted(*jargs, **args)):
        assert (np.abs(np.asarray(jm) - tm.numpy()) <= bound).all()
        assert (np.abs(np.asarray(jv) - tv.numpy()) <= bound).all()


def _topk_input(rng, rows, cols, pads):
    # few distinct levels: many ties, broken by index
    x = (rng.randint(0, 50, (rows, cols)) / 7.0).astype(np.float32)
    if pads:
        x[:, cols // 2:] = -1.0                 # row tails (importance -1)
        x[0, :] = -np.inf                       # a row of -inf
        x[1, ::3] = -np.inf
    return x


@pytest.mark.parametrize("cols,k", [(380, 1), (380, 37), (380, 128),
                                    (380, 300), (9216, 1), (9216, 37),
                                    (9216, 128), (9216, 300), (9216, 2913)])
@pytest.mark.parametrize("pads", [False, True])
def test_topk_rows_matches_lax_top_k(cols, k, pads):
    x = _topk_input(np.random.RandomState(cols + k), 6, cols, pads)
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    tv, ti = tk.topk_rows(torch.from_numpy(x), k)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(_bits_of(tv.numpy()), _bits_of(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_topk_rows_matches_pallas_kernel():
    """The TPU kernel itself (interpret mode, k <= 128)."""
    x = _topk_input(np.random.RandomState(3), 5, 380, True)
    jv, ji = jk.topk_rows(jnp.asarray(x), 37)
    tv, ti = tk.topk_rows(torch.from_numpy(x), 37)
    np.testing.assert_array_equal(_bits_of(tv.numpy()), _bits_of(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_topk_rows_checks_arguments():
    with pytest.raises(ValueError):
        tk.topk_rows(torch.zeros(2, 4), 5)
    with pytest.raises(ValueError):
        tk.topk_rows(torch.zeros(8), 1)
    with pytest.raises(ValueError):
        tk.topk_rows(torch.zeros(2, 4, dtype=torch.float64), 1)


def _payload(rng, world, per, total, sentinel, duplicates):
    """A gathered [world * per] payload: each worker's real indices
    unique, with sentinel pads at value 0.0; across workers the indices
    overlap when ``duplicates``."""
    pool = (rng.choice(total, per, replace=False) if duplicates
            else rng.choice(total, world * per, replace=False))
    vals, idxs = [], []
    for w in range(world):
        src = pool if duplicates else pool[w * per:(w + 1) * per]
        i = rng.permutation(src)[:per].astype(np.int32)
        i[i == sentinel] = (sentinel + 1) % total
        v = rng.randn(per).astype(np.float32)
        pad = rng.rand(per) < 0.2
        i[pad] = sentinel
        v[pad] = 0.0
        vals.append(v)
        idxs.append(i)
    return np.stack(vals), np.stack(idxs)


@pytest.mark.parametrize("duplicates", [False, True])
@pytest.mark.parametrize("divisor", [None, 4.0])
def test_apply_rows_matches_reference(duplicates, divisor):
    total, world, per = 10240, 4, 300
    sentinel = 9000
    rng = np.random.RandomState(11 + duplicates)
    vals, idxs = _payload(rng, world, per, total, sentinel, duplicates)
    me = 2
    flags = ((np.arange(world)[:, None] == me) & (idxs != sentinel))
    v, i, f = vals.reshape(-1), idxs.reshape(-1), flags.reshape(-1)
    ja, jb = jk.dgc_apply_rows_reference(jnp.asarray(v), jnp.asarray(i),
                                         jnp.asarray(f), total,
                                         divisor=divisor)
    ta, tb = tk.apply_rows(torch.from_numpy(v), torch.from_numpy(i),
                           torch.from_numpy(f), total, divisor=divisor)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    # the record is pack_sent_bits of the local worker's slots
    np.testing.assert_array_equal(
        tb.numpy(), np.asarray(jk.pack_sent_bits(
            jnp.asarray(idxs[me]), total, sentinel=sentinel)))
    if duplicates:
        # f32 rounding of the duplicate sums (order of the adds)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6,
                                   atol=0)
    else:
        np.testing.assert_array_equal(_bits_of(ta.numpy()), _bits_of(ja))
    if divisor is None:
        pa, pb = jk.payload_apply_bits_reference(
            jnp.asarray(v), jnp.asarray(i), jnp.asarray(f), total)
        np.testing.assert_array_equal(np.asarray(pb), tb.numpy())
        np.testing.assert_allclose(ta.numpy(), np.asarray(pa), rtol=1e-6,
                                   atol=0)


def test_stage_payload_moves_zero_values_last():
    v = torch.tensor([0.5, 0.0, -1.0, 2.0, 0.0], dtype=torch.float32)
    i = torch.tensor([7, 3, 7, 1, 9], dtype=torch.int32)
    skey, sval = tk.stage_payload(v, i, 16)
    assert skey.tolist() == [1, 7, 7, 16, 16]
    assert sval.tolist() == [2.0, 0.5, -1.0, 0.0, 0.0]


def test_launch_counters_count_only_launches():
    """On CPU tensors the wrappers run their plain versions and launch
    nothing."""
    tk.reset_launches()
    tk.topk_rows(torch.randn(2, 256), 3)
    tk.apply_rows(torch.ones(4), torch.arange(4, dtype=torch.int32),
                  torch.ones(4, dtype=torch.bool), 128)
    flat = torch.randn(2 * tk.SEG_SPAN)
    tk.seg_top2_candidates(flat, 0, 2, tk.SEG_SPAN)
    tk.compensate_bits_cands(flat, torch.zeros_like(flat),
                             torch.zeros_like(flat),
                             torch.zeros(tk.num_sent_words(flat.numel()),
                                         dtype=torch.int32), 0.9)
    tk.opaque_view(flat[:100])
    tk.opaque_view_from(flat, 1024, 2048)
    numels = torch.tensor([256, 7], dtype=torch.int32)
    tk.select_pack_rows(flat[:512].view(2, 256), numels, 3)
    tk.dgc_forward_rows(flat[:512], torch.zeros(512), torch.zeros(512),
                        torch.zeros(128, dtype=torch.int32), 0, numels, 3,
                        0.9)
    tk.fused_compensate(flat[:100], torch.zeros(100), torch.zeros(100), 0.9)
    tk.fused_compensate_masked(flat[:100], torch.zeros(100),
                               torch.zeros(100), torch.zeros(100), 0.9)
    tk.ladder_counts(flat[:512].view(2, 256), torch.ones(2), 0.8, 11)
    assert tk.LAUNCHES == {"compensate_bits": 0, "topk_rows": 0,
                           "apply_rows": 0, "compensate_bits_cands": 0,
                           "seg_top2_candidates": 0, "opaque_view": 0,
                           "opaque_view_from": 0, "select_pack_rows": 0,
                           "dgc_forward_rows": 0, "fused_compensate": 0,
                           "fused_compensate_masked": 0, "ladder_counts": 0}


def test_apply_rows_drops_out_of_range_indices():
    """Entries outside [0, total) change neither the sums nor the record:
    the result is that of the payload without them."""
    total = 8192
    rng = np.random.RandomState(5)
    v = rng.randn(12).astype(np.float32)
    i = rng.choice(total, 12, replace=False).astype(np.int32)
    f = np.ones(12, bool)
    bad = np.array([0, 5, 9])
    i_bad = i.copy()
    i_bad[bad] = [-1, total, total + 4096]
    keep = np.setdiff1d(np.arange(12), bad)
    got = tk.apply_rows(torch.from_numpy(v), torch.from_numpy(i_bad),
                        torch.from_numpy(f), total, divisor=2.0)
    want = tk.apply_rows(torch.from_numpy(v[keep]),
                         torch.from_numpy(i[keep]),
                         torch.from_numpy(f[keep]), total, divisor=2.0)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
