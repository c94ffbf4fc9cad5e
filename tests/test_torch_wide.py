"""The port's wide-bucket selection against the JAX package, on the CPU:
the segment split of rows wider than 8M columns (``_segment_rows``) and
the 3-D fallback of wide buckets off the segment path
(``_sparsify_bucket_3d``).

* VGG-16's real layout, host-side only: every bucket field, the path of
  every bucket and the payload at each warm-up ratio, equal to the JAX
  engine's.
* The per-segment quotas against the reference's ``_segment_rows``.
* The 3-D fallback's selection on one wide tensor, bitwise, on inputs
  whose magnitudes are distinct within each (row, lane) column.
* Planted ties: the reference takes its candidates with
  ``lax.approx_max_k(reduction_dimension=1)``, which on the CPU returns
  the exact top-kp values but orders equal magnitudes of one (row, lane)
  column its own way. The port's rule is first block wins (``lax.top_k``'s
  order): its candidate values are held bitwise against the reference's,
  its block ids against a numpy stable argsort, and the reference's block
  ids at tied values as sets; the payload's values bitwise and its indices
  as sets.
The exchange over a split bucket is ``test_torch_wide_exchange.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgc_tpu.compression import flat as jflat
from dgc_tpu.compression.dgc import TensorAttrs as JaxAttrs
from dgc_tpu.models import vgg16_bn
from dgc_tpu_torch.compression import flat as tflat
from dgc_tpu_torch.compression.dgc import TensorAttrs
from test_torch_seg import _bits, _engines, _jax_phases


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread, restored afterwards: the files run beside
    other test workers, where several threads a worker oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vgg_tree():
    return jax.eval_shape(lambda: vgg16_bn().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)),
        train=True))["params"]


#: VGG-16 at W=4, ratio 0.001 with wm5: payload a worker at epochs 0-5
VGG_PAYLOAD = (43_748_266, 13_834_424, 4_374_845, 1_383_462, 437_494,
               138_360)


@pytest.mark.parametrize("epoch", range(6))
def test_vgg16_layout_matches_jax(vgg_tree, epoch):
    """Every field of every bucket, each bucket's path, the payload."""
    je, te = _engines(vgg_tree, epoch)
    assert te.T == je.T == 139_028_480
    assert te.layout.total == je.layout.total == 139_051_008
    assert te.layout.num_params == 138_365_992
    assert len(te.layout.convert_hoist_risky()) == 4
    assert te.payload_size == je.payload_size == VGG_PAYLOAD[epoch]
    assert len(te.buckets) == len(je.buckets) == 8
    for jb, tb in zip(je.buckets, te.buckets):
        for f in jb._fields:
            a, b = getattr(jb, f), getattr(tb, f)
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(np.asarray(a), b, err_msg=f)
            else:
                assert a == b, f
    assert te._seg == [je._use_seg_kernel(b) for b in je.buckets]
    assert te._sel3d == [je._use_3d(b) and not je._use_seg_kernel(b)
                         for b in je.buckets]
    geo = [(b.base, b.rows, b.cols) for b in te.buckets]
    assert geo[:3] == [(0, 16, 6_422_528), (102_760_448, 4, 4_194_304),
                       (119_537_664, 1, 4_194_304)]
    assert [g[1:] for g in geo[3:]] == [(5, 2_359_296), (1, 1_179_648),
                                        (2, 655_360), (2, 393_216),
                                        (3, 73_728)]
    # the padded payload: the fc segments' quotas are equal within one
    assert all(len(b.tight) == b.rows * b.max_sel for b in te.buckets[:2])
    if epoch < 5:
        assert te._sel3d == [True] * 3 + [False] * 5 and not any(te._seg)
        nb = (50_176, 32_768, 32_768)
        kp = [min(n, -(-2 * b.max_sel // 128))
              for n, b in zip(nb, te.buckets)]
        assert tuple(kp) == [(31_735, 20_725, 20_239), (10_036, 6_554, 6_400),
                             (3_174, 2_073, 2_024), (1_004, 656, 640),
                             (318, 208, 203)][epoch]
        assert [tflat.lane_quota(b.cols, b.max_sel)
                for b in te.buckets[:3]] == kp
    else:
        assert te._seg == [True] * 7 + [False] and not any(te._sel3d)


@pytest.mark.parametrize("numel,cols,selects,ratio", [
    (102_760_448, 102_760_448, 32_472, 0.000316),
    (16_777_216, 16_777_216, 5_306, 0.000316),
    (8_390_656, 8_519_680, 8_391, 0.001),
    (8_390_656, 8_519_680, 3, 0.316),
    (12_000_001, 12_058_624, 12_001, 0.001),
    (9_000_000, 9_043_968, 7, 0.01)])
def test_segment_rows_match_jax(numel, cols, selects, ratio):
    """Segments, per-segment numels, sampling geometry and quotas (a
    running remainder rounded by Python's ``round``) equal the
    reference's, and the quotas sum to the tensor's."""
    args = dict(numel=numel, shape=(numel,), num_selects=selects,
                num_samples=0, top_k_samples=0, sample_stride=0)
    want = jflat._segment_rows("w", JaxAttrs(**args), 4096, cols, 0.01,
                               ratio)
    got = tflat._segment_rows(TensorAttrs(**args), 4096, cols, 0.01, ratio)
    assert got == want
    assert sum(r[5] for r in got[1]) == selects


def _wide_tree():
    """One tensor, one row of 3,276,800 columns: the 3-D fallback through
    the warm-up, the segment path at epoch 5."""
    return {"w": {"kernel": np.zeros((1600, 2000), np.float32)}}


def _distinct(rng, n):
    """[n] f32 of distinct magnitudes, random signs."""
    mag = (rng.permutation(n) + 1).astype(np.float32) * np.float32(2 ** -20)
    return np.where(rng.rand(n) < 0.5, -mag, mag).astype(np.float32)


@pytest.mark.parametrize("epoch", [1, 3])
def test_3d_selection_matches_jax(epoch):
    je, te = _engines(_wide_tree(), epoch)
    assert te._sel3d == [True] and te._seg == [False]
    vec = _distinct(np.random.RandomState(epoch), te.T)
    key = jax.random.PRNGKey(9)
    jv, ji = je.sparsify(jnp.asarray(vec), key)
    tflat.ROUTES["sel3d"] = 0
    tv, ti = te.sparsify(torch.from_numpy(vec), _jax_phases(je, key))
    assert tflat.ROUTES["sel3d"] == 1
    np.testing.assert_array_equal(_bits(tv.numpy()), _bits(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert (ti.numpy() != te.layout.sentinel).sum() > 0


def test_wide_tensor_takes_the_segment_path_at_epoch_5():
    je, te = _engines(_wide_tree(), 5)
    assert te._seg == [True] and te._sel3d == [False]
    assert je._use_seg_kernel(je.buckets[0])


def _tied(rng, n, cols):
    """Distinct magnitudes, then ties planted at the top of lanes 5 and 9
    of row 0: equal values (one sign) in several blocks of one (row, lane)
    column, larger than every other value, so each tie is among the
    column's candidates and the bucket's selection."""
    vec = _distinct(rng, n)
    top = np.abs(vec).max()
    for lane, blocks, v in ((5, (3, 40, 41, 2000), 4.0 * top),
                            (9, (0, 7, 24_999), -3.0 * top)):
        for b in blocks:
            vec[b * 128 + lane] = v
    return vec


def test_3d_candidates_break_ties_to_the_first_block():
    je, te = _engines(_wide_tree(), 3)
    b = te.buckets[0]
    vec = _tied(np.random.RandomState(2), te.T, b.cols)
    R, nb = b.rows, b.cols // 128
    kp = min(nb, -(-2 * b.max_sel // 128))
    block = torch.from_numpy(vec[:R * b.cols]).view(R, b.cols)
    cand, blk = tflat.lane_candidates(block, kp)
    imp3 = np.abs(vec[:R * b.cols]).reshape(R, nb, 128)
    jcv, jci = jax.lax.approx_max_k(jnp.asarray(imp3), kp,
                                    reduction_dimension=1,
                                    recall_target=0.9)
    np.testing.assert_array_equal(_bits(cand.numpy()),
                                  _bits(np.asarray(jcv).reshape(R, -1)))
    # the port: first block wins, as a stable argsort of -|v| per column
    order = np.argsort(-imp3, axis=1, kind="stable")[:, :kp, :]
    np.testing.assert_array_equal(blk.numpy().reshape(R, kp, 128), order)
    # the reference: the same blocks at each tied value, in its own order
    jci = np.asarray(jci)
    for lane, n_tied in ((5, 4), (9, 3)):
        assert (sorted(jci[0, :n_tied, lane].tolist())
                == order[0, :n_tied, lane].tolist())


def test_3d_selection_with_ties_matches_jax_as_sets():
    """The payload at planted ties: values bitwise (the tied entries are
    equal), indices equal as sets (the tied ones come in the candidates'
    order)."""
    je, te = _engines(_wide_tree(), 3)
    vec = _tied(np.random.RandomState(2), te.T, te.buckets[0].cols)
    key = jax.random.PRNGKey(4)
    jv, ji = je.sparsify(jnp.asarray(vec), key)
    tv, ti = te.sparsify(torch.from_numpy(vec), _jax_phases(je, key))
    np.testing.assert_array_equal(_bits(tv.numpy()), _bits(jv))
    ti, ji = ti.numpy(), np.asarray(ji)
    assert sorted(ti.tolist()) == sorted(ji.tolist())
    assert {5 + 128 * b for b in (3, 40, 41, 2000)} <= set(ti.tolist())
    assert (ti != ji).sum() <= 7          # only the tied entries move
