"""The port's wire codecs against the JAX package's: ``IndexCodec`` and
``DeltaIndexCodec`` words bitwise (the port's int32 words against the JAX
``uint32`` ones), their decoded indices equal, ``decode(encode(x))`` equal
to ``canonical(x)``, the static layouts equal, on the buckets both
packages build from ResNet-20 and from a narrow ResNet-50 (every channel
count divided by 4) at warm-up ratios; ``pack_int4`` / ``unpack_int4``
bitwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgc_tpu import DGCCompressor, DGCSGDMemory
from dgc_tpu.compression import wirecodec as jwc
from dgc_tpu.compression.flat import FlatDGCEngine, ParamLayout
from dgc_tpu.models import resnet20, resnet50
from dgc_tpu.utils.pytree import named_flatten
from dgc_tpu_torch.compression import dgc as tdgc
from dgc_tpu_torch.compression import flat as tflat
from dgc_tpu_torch.compression import wirecodec as twc


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread (the file runs beside other test workers, where
    several threads a worker oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shapes(model, narrow=1):
    """``{name: shape}`` of a model's parameters, channels divided by
    ``narrow``."""
    tree = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
        train=True))["params"]
    out = {}
    for n, leaf in named_flatten(tree)[0].items():
        s = tuple(leaf.shape)
        if narrow > 1 and len(s) == 4:
            s = s[:2] + tuple(max(1, c // narrow) for c in s[2:])
        elif narrow > 1 and len(s) == 2:
            s = (max(1, s[0] // narrow), s[1])
        elif narrow > 1 and len(s) == 1 and s[0] > 10:
            s = (max(1, s[0] // narrow),)
        out[n] = s
    return out


_MODELS = {"resnet20": lambda: _shapes(resnet20()),
           "resnet50_narrow": lambda: _shapes(resnet50(), narrow=4)}


def _buckets(model, epoch):
    shapes = _MODELS[model]()
    jtree = {n: jax.ShapeDtypeStruct(s, jnp.float32)
             for n, s in shapes.items()}
    kw = dict(sample_ratio=0.01, warmup_epochs=5)
    jc = DGCCompressor(0.001, memory=DGCSGDMemory(momentum=0.9), **kw)
    tc = tdgc.DGCCompressor(0.001, **kw)
    compressed = [(n, s) for n, s in shapes.items() if len(s) > 1]
    jc.initialize((n, jtree[n]) for n, _ in compressed)
    tc.initialize(compressed)
    jc.warmup_compress_ratio(epoch)
    tc.warmup_compress_ratio(epoch)
    je = FlatDGCEngine(jc, ParamLayout.for_compressor(jtree, jc))
    te = tflat.FlatDGCEngine(tc, tflat.ParamLayout.for_compressor(shapes,
                                                                  tc))
    assert len(je.buckets) == len(te.buckets) > 0
    return je, te


def _indices(codec, sentinel, rng, sort_buckets=None):
    """Random in-row indices, a tenth of the slots on the sentinel; with
    ``sort_buckets`` each bucket's slice sorted by canonical position (the
    Elias-Fano precondition)."""
    off = codec.slot_off
    idx = off + (rng.random_sample(off.shape) * codec.slot_numel).astype(
        np.int64)
    idx[rng.random_sample(off.shape) < 0.1] = sentinel
    if sort_buckets is not None:
        p0 = 0
        for p in sort_buckets:
            seg = idx[p0:p0 + p]
            canon = off[p0:p0 + p] + np.clip(
                seg - off[p0:p0 + p], 0, codec.slot_numel[p0:p0 + p] - 1)
            idx[p0:p0 + p] = seg[np.argsort(canon, kind="stable")]
            p0 += p
    return idx


@pytest.mark.parametrize("epoch", [0, 5])
@pytest.mark.parametrize("model", sorted(_MODELS))
@pytest.mark.parametrize("kind", ["packed", "delta"])
def test_codec_words_match_jax(model, epoch, kind):
    je, te = _buckets(model, epoch)
    cls = {"packed": (jwc.IndexCodec, twc.IndexCodec),
           "delta": (jwc.DeltaIndexCodec, twc.DeltaIndexCodec)}[kind]
    jcodec, tcodec = cls[0](je.buckets), cls[1](te.buckets)
    np.testing.assert_array_equal(tcodec.slot_off, jcodec.slot_off)
    np.testing.assert_array_equal(tcodec.slot_numel, jcodec.slot_numel)
    assert tcodec.nwords == jcodec.nwords
    assert tcodec.bits_per_index == jcodec.bits_per_index
    if kind == "delta":
        assert tcodec.bucket_words == jcodec.bucket_words
    rng = np.random.RandomState(epoch)
    idx = _indices(tcodec, te.layout.sentinel, rng,
                   [b.payload for b in te.buckets] if kind == "delta"
                   else None)
    words = tcodec.encode(torch.from_numpy(idx).to(torch.int32))
    jwords = jcodec.encode(jnp.asarray(idx, jnp.int32))
    assert words.dtype == torch.int32 and jwords.dtype == jnp.uint32
    np.testing.assert_array_equal(words.numpy(),
                                  np.asarray(jwords).view(np.int32))
    # decode of a gathered [W, nwords] stack
    stack = torch.stack([words, words])
    dec = tcodec.decode(stack)
    jdec = jcodec.decode(jnp.stack([jwords, jwords]))
    np.testing.assert_array_equal(dec.numpy(), np.asarray(jdec))
    canon = tcodec.canonical(torch.from_numpy(idx))
    np.testing.assert_array_equal(dec[0].numpy(), canon.numpy())
    np.testing.assert_array_equal(
        canon.numpy(), np.asarray(jcodec.canonical(jnp.asarray(idx,
                                                                jnp.int32))))
    assert tcodec.decode(stack, torch.int64).dtype == torch.int64


@pytest.mark.parametrize("n", [0, 1, 2, 7, 1000, 1001])
def test_pack_int4_matches_jax(n):
    rng = np.random.RandomState(n)
    q = rng.randint(-8, 8, size=n).astype(np.int32)
    b = twc.pack_int4(torch.from_numpy(q))
    jb = jwc.pack_int4(jnp.asarray(q))
    assert b.dtype == torch.int8 and b.shape == ((n + 1) // 2,)
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    u = twc.unpack_int4(torch.stack([b, b]), n)
    np.testing.assert_array_equal(u.numpy(), np.stack([q, q]))
    np.testing.assert_array_equal(
        u.numpy(), np.asarray(jwc.unpack_int4(jnp.stack([jb, jb]), n)))


def test_floor_log2_and_refusals():
    for n in (0, 1, 2, 3, 1023, 1024, 2 ** 40 + 1):
        assert twc.math_floor_log2(n) == jwc.math_floor_log2(n)

    class Wide:
        rows, cols, payload, max_sel, base = 1, 2 ** 31, 4, 4, 0
        tight = np.arange(4)
        row_offsets = np.array([0])
        numels = np.array([2 ** 33])
    with pytest.raises(ValueError, match="2\\^32"):
        twc.IndexCodec([Wide()])
    with pytest.raises(ValueError, match="2\\^31"):
        twc.DeltaIndexCodec([Wide()])
