"""The port's flat layout and bucket geometry against the JAX package, for
ResNet-20 at every ratio of the wm5 warm-up (dgc_tpu_torch vs dgc_tpu)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgc_tpu import DGCCompressor, DGCSGDMemory
from dgc_tpu.compression.flat import FlatDGCEngine, ParamLayout
from dgc_tpu.models import resnet20
from dgc_tpu.utils.pytree import named_flatten as jax_named_flatten
from dgc_tpu_torch.compression import dgc as tdgc
from dgc_tpu_torch.compression import flat as tflat
from dgc_tpu_torch.compression.memory import DGCSGDMemory as TMemory
from dgc_tpu_torch.models import param_tree, resnet_cifar, stats_tree
from dgc_tpu_torch.utils.pytree import named_flatten

WM5_RATIOS = (0.316, 0.1, 0.0316, 0.01, 0.0032, 0.001)


@pytest.fixture(scope="module")
def jax_vars():
    v = resnet20().init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                        train=True)
    return jax.device_get(v)


def _compressors():
    kw = dict(sample_ratio=0.01, strided_sample=True,
              compress_upper_bound=1.3, compress_lower_bound=0.8,
              max_adaptation_iters=10, resample=True, warmup_epochs=5)
    return (DGCCompressor(0.001, memory=DGCSGDMemory(momentum=0.9), **kw),
            tdgc.DGCCompressor(0.001, memory=TMemory(momentum=0.9), **kw))


@pytest.mark.parametrize("name", ["resnet20", "resnet110"])
def test_named_flatten_order_matches_jax(name):
    from dgc_tpu import models as jmodels
    jv = jax.eval_shape(lambda: getattr(jmodels, name)().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=True))
    model = getattr(resnet_cifar, name)()
    for tree, ttree in ((jv["params"], param_tree(model)),
                        (jv["batch_stats"], stats_tree(model))):
        jnamed = jax_named_flatten(tree)[0]
        tnamed = named_flatten(ttree)
        assert list(tnamed) == list(jnamed)
        assert {n: tuple(t.shape) for n, t in tnamed.items()} == {
            n: tuple(a.shape) for n, a in jnamed.items()}
    names = list(named_flatten(param_tree(model)))
    # sorted keys: every BasicBlock_* before BatchNorm_0, Conv_0, Dense_0
    assert names.index("BasicBlock_8/Conv_1/kernel") < names.index(
        "BatchNorm_0/bias")


def test_resnet20_layout_matches_jax(jax_vars):
    params = jax_vars["params"]
    jc, tc = _compressors()
    named = jax_named_flatten(params)[0]
    jc.initialize((n, p) for n, p in named.items() if p.ndim > 1)
    tc.initialize((n, p.shape) for n, p in named.items() if p.ndim > 1)
    jl = ParamLayout.for_compressor(params, jc)
    tl = tflat.ParamLayout.for_compressor(params, tc)
    assert tl.num_params == jl.num_params == 272_474
    assert len(tl.compressed_names) == 22
    for attr in ("names", "offsets", "t_data", "t_compressed", "sentinel",
                 "p_data_end", "total"):
        assert getattr(tl, attr) == getattr(jl, attr), attr
    assert tl.t_compressed == 370_688 and tl.total == 372_736
    assert [tuple(b) for b in tl.buckets] == [tuple(b) for b in jl.buckets]
    assert [(b.rows, b.cols) for b in tl.buckets] == [(6, 36864),
                                                      (16, 9216)]
    # flatten: bitwise, structural zeros included
    jflat = np.asarray(jl.flatten(params))
    tflat_ = tl.flatten(params).numpy()
    np.testing.assert_array_equal(tflat_.view(np.int32),
                                  jflat.view(np.int32))
    sl_j = ParamLayout(jax_vars["batch_stats"])
    sl_t = tflat.ParamLayout(jax_vars["batch_stats"])
    assert sl_t.offsets == sl_j.offsets and sl_t.total == sl_j.total
    views = tl.unflatten_named(torch.from_numpy(jflat.copy()))
    for n, a in named.items():
        np.testing.assert_array_equal(views[n].numpy(), np.asarray(a))


@pytest.mark.parametrize("epoch", range(6))
def test_bucket_geometry_matches_jax_across_warmup(jax_vars, epoch):
    params = jax_vars["params"]
    jc, tc = _compressors()
    named = jax_named_flatten(params)[0]
    jc.initialize((n, p) for n, p in named.items() if p.ndim > 1)
    tc.initialize((n, p.shape) for n, p in named.items() if p.ndim > 1)
    jc.warmup_compress_ratio(epoch)
    tc.warmup_compress_ratio(epoch)
    assert tc.compress_ratio == jc.compress_ratio
    assert round(tc.compress_ratio, 4) == pytest.approx(WM5_RATIOS[epoch],
                                                        rel=2e-3)
    assert {n: tuple(a) for n, a in tc.attributes.items()} == {
        n: tuple(a) for n, a in jc.attributes.items()}
    je = FlatDGCEngine(jc, ParamLayout.for_compressor(params, jc))
    te = tflat.FlatDGCEngine(tc, tflat.ParamLayout.for_compressor(params, tc))
    assert te.payload_size == je.payload_size
    assert len(te.buckets) == len(je.buckets)
    for tb, jb in zip(te.buckets, je.buckets):
        for f in tflat._Bucket._fields:
            a, b = getattr(tb, f), getattr(jb, f)
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=f)
            else:
                assert a == b, f
    # the top-k kernel's shared-memory sort covers the whole schedule
    from dgc_tpu_torch.ops.kernels import TOPK_MAX_K
    assert max(b.max_sel for b in te.buckets) <= TOPK_MAX_K


def test_sampling_geometry_matches_jax():
    from dgc_tpu.compression.dgc import sampling_geometry
    rng = np.random.RandomState(0)
    for numel in list(rng.randint(1, 3_000_000, 200)) + [1, 2, 2000, 2001]:
        for sr, cr in ((0.01, 0.001), (0.01, 0.316), (1.0, 0.01),
                       (0.05, 0.0032)):
            assert tdgc.sampling_geometry(int(numel), sr, cr) == \
                sampling_geometry(int(numel), sr, cr)
