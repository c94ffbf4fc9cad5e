"""The segment-candidate kernels' decomposition (``csrc/seg_top2.cu``),
written out in numpy, against the port's plain versions and the JAX
package, on the CPU.

The CUDA kernels compute each (lane, 256-block segment) top-2 as eight
per-(record row, lane) scans of 32 blocks each, in ascending block order
with strict ``>`` updates, then merge the eight row partials of each lane
in row order by pushing each partial's first and then its second entry.
:func:`_scan_top2` repeats exactly that; it must be bitwise
``kernels._top2_plain``, the Pallas kernels (interpret mode) and the jnp
references, at ties planted across the record rows (blocks 31/32,
223/224), at blocks 0 and 255, on all-equal lanes, on +-0.0 and on
+-inf. ``seg_top2_reference`` gathers its values and so keeps the sign of
a -0.0 that the kernels read back as +0.0: it is compared as numbers.

The cell-to-record-word mapping the kernels rely on: the cell (row j,
lane l) of segment s reads the one word ``(8 s + j) * 128 + l``, whose bit
i is block ``32 j + i``, held against ``keep_from_bits`` of both packages
for random records and for a 2,048-element ragged tail (whose record has
only its first row of words)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgc_tpu.ops import kernels as jk
from dgc_tpu_torch.ops import kernels as tk

SPAN = 256 * 128
ROWS, ROW_BLOCKS = 8, 32


def _bits(x):
    return np.asarray(x).view(np.int32)


def _push(t, x, b):
    """One strict-``>`` step of a running top-2 ``(a1, x1, b1, a2, x2,
    b2)`` per lane (arrays of one shape), with the entry ``(x, b)`` that
    comes after every entry pushed so far."""
    a1, x1, b1, a2, x2, b2 = t
    a = np.abs(x)
    first = a > a1
    second = ~first & (a > a2)
    return (np.where(first, a, a1), np.where(first, x, x1),
            np.where(first, b, b1),
            np.where(first, a1, np.where(second, a, a2)),
            np.where(first, x1, np.where(second, x, x2)),
            np.where(first, b1, np.where(second, b, b2)))


def _init(shape):
    return (np.full(shape, -1.0, np.float32), np.zeros(shape, np.float32),
            np.zeros(shape, np.int32)) * 2


def _scan_top2(x):
    """The kernels' decomposition over [S, 256, 128] f32 segments:
    ``(values [S, 2, 128] f32, blocks [S, 2, 128] int32)``."""
    S = x.shape[0]
    parts = []
    for j in range(ROWS):                    # one warp per record row
        t = _init((S, 128))
        for i in range(ROW_BLOCKS):          # ascending blocks
            b = ROW_BLOCKS * j + i
            t = _push(t, x[:, b], np.int32(b))
        parts.append(t)
    r = _init((S, 128))
    for p in parts:                          # row order = block order
        r = _push(r, p[1], p[2])
        r = _push(r, p[4], p[5])
    vals = np.stack([r[1], r[4]], 1) + np.float32(0.0)   # -0.0 -> +0.0
    return vals.astype(np.float32), np.stack([r[2], r[5]], 1).astype(
        np.int32)


def _planted(rng, nseg, case):
    """[nseg * 32768] f32: random values, then per case ties across the
    record rows, at the segment's ends, all-equal lanes, signed zeros or
    infinities (every segment gets the same plants)."""
    x = rng.randn(nseg, 256, 128).astype(np.float32)
    top = np.float32(6.0)
    if case == "row_ties":
        # equal |x|, opposite signs, straddling rows 0/1 and 6/7, in lanes
        # 0, 5 and 127; a three-way tie over rows 3, 4 and 7 in lane 64
        for lane in (0, 5, 127):
            x[:, 31, lane], x[:, 32, lane] = top, -top
            x[:, 223, lane], x[:, 224, lane] = -top / 2, top / 2
        x[:, 100, 64], x[:, 128, 64], x[:, 255, 64] = -top, top, top
    elif case == "ends":
        x[:, 0, 3], x[:, 255, 3] = -top, top           # first and last
        x[:, 255, 9] = top                             # last block alone
        x[:, 0, 10], x[:, 1, 10] = top, top            # first two
    elif case == "all_equal":
        x[:, :, :64] = np.float32(-1.5)                # every block ties
        x[0] = 0.25
    elif case == "zeros":
        x[:, :, ::2] = 0.0
        x[:, ::3, ::2] = -0.0
        x[:, :, 1::4] = -0.0                           # whole -0.0 lanes
        x[:, 40, 5] = np.float32(-2.0)
        x[:, 41, 5] = 0.0
    elif case == "inf":
        x[:, 31, 0], x[:, 32, 0] = np.inf, -np.inf
        x[:, 200, 1] = -np.inf
        x[:, 7, 2], x[:, 250, 2] = -np.inf, -np.inf
        x[:, :, 3] = np.inf                            # an all-inf lane
    return x.reshape(-1)


CASES = ("random", "row_ties", "ends", "all_equal", "zeros", "inf")


@pytest.mark.parametrize("case", CASES)
def test_scan_decomposition_matches_plain_and_jax(case):
    rng = np.random.RandomState(CASES.index(case))
    nseg = 3
    x = _planted(rng, nseg, case)
    sv, sb = _scan_top2(x.reshape(nseg, 256, 128))
    pv, pb = tk._top2_plain(torch.from_numpy(x).view(nseg, 256, 128))
    np.testing.assert_array_equal(_bits(sv), _bits(pv.numpy()))
    np.testing.assert_array_equal(sb, pb.numpy())
    v2d = jnp.asarray(x).reshape(-1, 128)
    jv, jc = jk.seg_top2_candidates(v2d, 0, 1, nseg * SPAN)
    cols = tk.seg_cols_local(torch.from_numpy(sb).view(1, nseg, 2, 128))
    np.testing.assert_array_equal(_bits(sv.reshape(1, -1)), _bits(jv))
    np.testing.assert_array_equal(cols.numpy(), np.asarray(jc))
    rv, rc = jk.seg_top2_reference(v2d, 0, 1, nseg * SPAN)
    np.testing.assert_array_equal(sv.reshape(1, -1), np.asarray(rv))
    np.testing.assert_array_equal(cols.numpy(), np.asarray(rc))


def test_planted_ties_land_where_the_rank_rule_puts_them():
    """The decomposition on the planted cases picks the lower block of
    each tie, across the record rows too."""
    x = _planted(np.random.RandomState(0), 1, "row_ties").reshape(1, 256,
                                                                  128)
    v, b = _scan_top2(x)
    for lane in (0, 5, 127):
        assert b[0, :, lane].tolist() == [31, 32]
        assert v[0, :, lane].tolist() == [6.0, -6.0]
    assert b[0, :, 64].tolist() == [100, 128]
    x = _planted(np.random.RandomState(0), 1, "ends").reshape(1, 256, 128)
    v, b = _scan_top2(x)
    assert b[0, :, 3].tolist() == [0, 255]
    assert b[0, 0, 9] == 255 and b[0, :, 10].tolist() == [0, 1]
    x = _planted(np.random.RandomState(0), 1, "zeros").reshape(1, 256, 128)
    v, b = _scan_top2(x)
    assert b[0, :, 1].tolist() == [0, 1]                # a -0.0 lane
    assert _bits(v[0, :, 1]).tolist() == [0, 0]         # read as +0.0


@pytest.mark.parametrize("nesterov,momentum_masking", [
    (False, True), (False, False), (True, True), (True, False)])
def test_fused_decomposition_matches_jax_reference(nesterov,
                                                   momentum_masking):
    """The fused kernel's candidates are the decomposition over the
    stored velocity of the whole segments (a 2,048-element ragged tail
    with sent bits in it emits none): bitwise the port's plain version and
    ``fused_compensate_bits_cands_reference``."""
    rng = np.random.RandomState(10 + 2 * nesterov + momentum_masking)
    nseg, tail = 2, 2048
    n = nseg * SPAN + tail
    g = np.concatenate([_planted(rng, nseg, "row_ties"),
                        rng.randn(tail).astype(np.float32)])
    m = rng.randn(n).astype(np.float32)
    v = rng.randn(n).astype(np.float32)
    idx = np.concatenate([rng.choice(nseg * SPAN, 5000, replace=False),
                          nseg * SPAN + rng.choice(tail, 300,
                                                   replace=False)])
    bits = np.asarray(jk.pack_sent_bits(jnp.asarray(idx.astype(np.int32)),
                                        n))
    args = dict(momentum=0.9, nesterov=nesterov,
                momentum_masking=momentum_masking)
    rm, rv, rcv, rci = jk.fused_compensate_bits_cands_reference(
        *(jnp.asarray(a) for a in (g, m, v, bits)), **args)
    sv, sb = _scan_top2(np.asarray(rv)[:nseg * SPAN].reshape(nseg, 256,
                                                             128))
    np.testing.assert_array_equal(_bits(sv), _bits(rcv))
    np.testing.assert_array_equal(sb, np.asarray(rci))
    tm, tv = torch.from_numpy(m.copy()), torch.from_numpy(v.copy())
    _, _, cv, cb = tk.compensate_bits_cands(torch.from_numpy(g), tm, tv,
                                            torch.from_numpy(bits.copy()),
                                            **args)
    np.testing.assert_array_equal(_bits(cv.numpy()), _bits(sv))
    np.testing.assert_array_equal(cb.numpy(), sb)
    np.testing.assert_array_equal(_bits(tv.numpy()), _bits(rv))
    np.testing.assert_array_equal(_bits(tm.numpy()), _bits(rm))


@pytest.mark.parametrize("nseg,tail", [(3, 0), (2, 2048)])
def test_cell_reads_one_record_word(nseg, tail):
    """Cell (row j, lane l) of segment s: keep bit of block 32 j + i is
    bit i of word (8 s + j) * 128 + l, for random records; the ragged
    tail's elements read only the first row of words past the last
    segment, which is all the record holds there."""
    rng = np.random.RandomState(nseg)
    n = nseg * SPAN + tail
    W = tk.num_sent_words(n)
    assert W == jk.num_sent_words(n) == (8 * nseg + (tail > 0)) * 128
    bits = rng.randint(-2 ** 31, 2 ** 31, W, dtype=np.int64).astype(
        np.int32)
    keep_t = tk.keep_from_bits(torch.from_numpy(bits), n).numpy()
    keep_j = np.asarray(jk.keep_from_bits(jnp.asarray(bits), n))
    np.testing.assert_array_equal(keep_t, keep_j)
    s, j, i, lane = np.meshgrid(np.arange(nseg + (tail > 0)),
                                np.arange(ROWS), np.arange(ROW_BLOCKS),
                                np.arange(128), indexing="ij")
    p = s * SPAN + (ROW_BLOCKS * j + i) * 128 + lane
    inside = p < n
    word = (8 * s + j) * 128 + lane
    assert (word[inside] < W).all()
    # a row of the tail segment exists exactly where its first block does
    assert ((word < W) == (s * SPAN + ROW_BLOCKS * j * 128 < n)).all()
    want = ((bits[word[inside]] >> i[inside]) & 1) == 0
    np.testing.assert_array_equal(keep_t[p[inside]], want.astype(np.float32))
    if tail:
        # the tail is half a word group: bits 0..15 of row 0 only
        assert (i[inside & (s == nseg)] < tail // 128).all()
        assert (j[inside & (s == nseg)] == 0).all()
