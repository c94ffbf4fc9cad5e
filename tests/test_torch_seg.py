"""The port's segment-candidate selection path against the JAX package, on
the CPU (the kernels' plain versions; JAX's Pallas kernels in interpret
mode and their jnp references).

* The candidates kernels — ``seg_top2_candidates`` and the fused
  ``compensate_bits_cands`` — bitwise against ``seg_top2_reference``,
  ``fused_compensate_bits_cands_reference`` and the two Pallas kernels,
  with planted ties and all-zero segments.
* The engine: ``_sample_rows_3d``'s samples, and the W=2 exchange on a
  synthetic tree whose big bucket takes the segment path (asserted on the
  JAX engine), bitwise against the op-by-op JAX engine (as in
  test_torch_engine.py) and within the 4-eps FMA bound of
  test_torch_kernels.py against the jitted one; then one worker's
  selection at ResNet-18 and ResNet-50 geometry, bitwise.
* Selection beyond the top-k kernel's k: ``lax_top_k`` against
  ``lax.top_k``, and ``lax.approx_max_k``'s CPU lowering, which the port's
  exact selection relies on, against ``lax.top_k``.

A test here compares ``-0.0`` as equal to ``+0.0`` only where it says so:
the Pallas cell function reads a candidate's value back as a masked sum
(``-0.0`` becomes ``+0.0``), while ``seg_top2_reference`` gathers it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgc_tpu import DGCCompressor, DGCSGDMemory
from dgc_tpu.compression.flat import FlatDGCEngine, ParamLayout
from dgc_tpu.models import resnet18, resnet50
from dgc_tpu.ops import kernels as jk
from dgc_tpu.utils.pytree import named_flatten as jax_named_flatten
from dgc_tpu_torch.compression import dgc as tdgc
from dgc_tpu_torch.compression import flat as tflat
from dgc_tpu_torch.compression.memory import DGCSGDMemory as TMemory
from dgc_tpu_torch.ops import kernels as tk
from dgc_tpu_torch.parallel.comm import LocalComm


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread (the file runs beside other test workers, where
    several threads a worker oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


W = 2
SPAN = 256 * 128


def _bits(x):
    return np.asarray(x).view(np.int32)


def _segments(rng, nseg, tail=0):
    """[nseg * 32768 + tail] f32 with an all-zero segment, a segment of
    one repeated value (every lane a 256-way tie) and planted ties of the
    largest magnitude, signs mixed."""
    x = rng.randn(nseg * SPAN + tail).astype(np.float32)
    x[:SPAN] = 0.0
    x[SPAN:2 * SPAN] = -1.5
    s = 2 * SPAN
    x[s + 3 * 128 + 7] = 9.0              # lane 7: blocks 3 and 200 tie
    x[s + 200 * 128 + 7] = -9.0
    x[s + 5 * 128 + 9] = 4.0              # lane 9: three-way tie
    x[s + 6 * 128 + 9] = 4.0
    x[s + 255 * 128 + 9] = -4.0
    return x


@pytest.mark.parametrize("rows,cols,base", [(2, 2 * SPAN, SPAN),
                                            (3, SPAN, 0)])
def test_seg_top2_candidates_match_jax(rows, cols, base):
    rng = np.random.RandomState(rows)
    x = _segments(rng, 7)
    v2d = jnp.asarray(x).reshape(-1, 128)
    tv, tc = tk.seg_top2_candidates(torch.from_numpy(x), base, rows, cols)
    assert tv.shape == (rows, cols // SPAN * 256) and tc.dtype == torch.int32
    for jv, jc in (jk.seg_top2_candidates(v2d, base, rows, cols),
                   jk.seg_top2_reference(v2d, base, rows, cols)):
        np.testing.assert_array_equal(_bits(tv.numpy()), _bits(jv))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_seg_candidates_read_minus_zero_as_the_kernel_does():
    """-0.0 reads back +0.0, as the Pallas kernel's masked sum has it;
    the jnp reference's gather keeps the sign (equal as numbers)."""
    x = np.zeros(SPAN, np.float32)
    x[::3] = -0.0
    v2d = jnp.asarray(x).reshape(-1, 128)
    tv, tc = tk.seg_top2_candidates(torch.from_numpy(x), 0, 1, SPAN)
    jv, jc = jk.seg_top2_candidates(v2d, 0, 1, SPAN)
    np.testing.assert_array_equal(_bits(tv.numpy()), _bits(jv))
    rv, rc = jk.seg_top2_reference(v2d, 0, 1, SPAN)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(rc))


@pytest.mark.parametrize("nesterov,momentum_masking", [(False, True),
                                                       (True, False)])
def test_compensate_bits_cands_matches_jax(nesterov, momentum_masking):
    """m, v and the candidates bitwise against the op-by-op reference (a
    ragged 2048-element tail past the last complete segment); against the
    Pallas kernel (interpret mode, under jit: FMA-contracted) m and v
    within 4 eps and its candidates bitwise the port's cell function on
    its own velocity."""
    rng = np.random.RandomState(3 + nesterov)
    n = 4 * SPAN + 2048
    g = _segments(rng, 4, 2048)
    m = rng.randn(n).astype(np.float32)
    v = rng.randn(n).astype(np.float32)
    m[:2 * SPAN] = 0.0
    v[:2 * SPAN] = 0.0
    idx = rng.choice(n, n // 5, replace=False).astype(np.int32)
    bits = np.asarray(jk.pack_sent_bits(jnp.asarray(idx), n))
    args = dict(momentum=0.9, nesterov=nesterov,
                momentum_masking=momentum_masking)
    jargs = [jnp.asarray(a) for a in (g, m, v, bits)]
    rm, rv, rcv, rci = jk.fused_compensate_bits_cands_reference(*jargs,
                                                               **args)
    tm, tv = torch.from_numpy(m.copy()), torch.from_numpy(v.copy())
    out = tk.compensate_bits_cands(torch.from_numpy(g), tm, tv,
                                   torch.from_numpy(bits.copy()), **args)
    assert out[0] is tm and out[1] is tv
    assert out[2].shape == (4, 2, 128) and out[3].dtype == torch.int32
    for got, want in zip(out, (rm, rv, rcv, rci)):
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # the standalone kernel on the stored velocity: the same candidates
    sv, sc = tk.seg_top2_candidates(tv, 0, 1, 4 * SPAN)
    np.testing.assert_array_equal(_bits(sv.numpy()),
                                  _bits(out[2].reshape(1, -1).numpy()))

    km, kv, kcv, kci = jk.fused_compensate_bits_cands(*jargs, **args)
    bound = 4 * np.finfo(np.float32).eps * (np.abs(m) + np.abs(g)
                                            + np.abs(v))
    assert (np.abs(np.asarray(km) - tm.numpy()) <= bound).all()
    assert (np.abs(np.asarray(kv) - tv.numpy()) <= bound).all()
    pv, pb = tk._top2_plain(torch.from_numpy(
        np.asarray(kv)[:4 * SPAN].copy()).view(4, 256, 128))
    np.testing.assert_array_equal(_bits(pv.numpy()),
                                  _bits(np.asarray(kcv)[:4]))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(kci)[:4])


def test_seg_cols_local_matches_jax():
    blks = np.random.RandomState(0).randint(0, 256, (3, 4, 2, 128)).astype(
        np.int32)
    np.testing.assert_array_equal(
        tk.seg_cols_local(torch.from_numpy(blks)).numpy(),
        np.asarray(jk.seg_cols_local(jnp.asarray(blks))))


# ------------------------------------------------------------------ #
# the engine                                                         #
# ------------------------------------------------------------------ #

def _tree():
    """A seg-path bucket [2, 262144] (two stride groups, one row with a
    structural-zero tail) beside a 2-D bucket [2, 65536] (a sampled row
    and an exact one), and a dense tail."""
    z = lambda *s: np.zeros(s, np.float32)      # noqa: E731
    return {"a": {"kernel": z(512, 512)}, "f": {"kernel": z(375, 400)},
            "b": {"kernel": z(256, 256)},
            "c": {"kernel": z(3, 3, 16, 32), "bias": z(32)}}


def _engines(tree, epoch, **kw):
    kw = dict(sample_ratio=0.01, warmup_epochs=5, **kw)
    jc = DGCCompressor(0.001, memory=DGCSGDMemory(momentum=0.9), **kw)
    tc = tdgc.DGCCompressor(0.001, memory=TMemory(momentum=0.9), **kw)
    named = jax_named_flatten(tree)[0]
    jc.initialize((n, p) for n, p in named.items() if len(p.shape) > 1)
    tc.initialize((n, p.shape) for n, p in named.items()
                  if len(p.shape) > 1)
    jc.warmup_compress_ratio(epoch)
    tc.warmup_compress_ratio(epoch)
    return (FlatDGCEngine(jc, ParamLayout.for_compressor(tree, jc)),
            tflat.FlatDGCEngine(tc, tflat.ParamLayout.for_compressor(
                tree, tc)))


def _jax_phases(engine, key):
    """The uniforms the JAX engine's samplers draw from a worker's key."""
    return [[] if b.exact else [
        float(jax.random.uniform(jax.random.fold_in(
            jax.random.fold_in(key, bi), gi), ()))
        for gi in range(len(b.stride_groups))]
        for bi, b in enumerate(engine.buckets)]


def _worker(engine):
    def worker(fg, mem, key):
        key = jax.random.fold_in(key, jax.lax.axis_index("data"))
        _, mc, vc, _ = engine._compensate_acc(
            mem["momentums_c"], mem["velocities_c"], fg, mem["sent_bits"])
        vals, idx = engine.sparsify(vc, key)
        out, mem = engine.exchange(fg, mem, key, "data", W)
        return out, mem, vals, idx, mc, vc
    return worker


def _exchange(je, te, grads, jmem, tmems, key, jitted=False):
    """One exchange step on both sides. Returns the JAX outputs and the
    port's ``(payloads, outputs)``; ``tmems`` update in place."""
    step = jax.vmap(_worker(je), in_axes=(0, 0, None), axis_name="data")
    if jitted:
        step = jax.jit(step)
    jres = step(jnp.asarray(grads), jmem, key)
    phases = [_jax_phases(je, jax.random.fold_in(key, w)) for w in range(W)]
    pre = [{k: v.clone() for k, v in m.items()} for m in tmems]
    sent = [te.compress(torch.from_numpy(grads[w]), pre[w], phases[w])
            for w in range(W)]
    outs = te.exchange([torch.from_numpy(g) for g in grads], tmems, phases,
                       LocalComm(W))
    return jres, sent, outs


def _check_bitwise(te, jres, sent, outs, tmems, grads):
    jout, jmem, jvals, jidx = jres[:4]
    S, P_ = te.layout.sentinel, te.layout.total
    for w in range(W):
        np.testing.assert_array_equal(_bits(sent[w][0].numpy()),
                                      _bits(jvals[w]))
        np.testing.assert_array_equal(sent[w][1].numpy(), np.asarray(jidx[w]))
        for k in ("momentums_c", "velocities_c", "momentums_d",
                  "velocities_d", "sent_bits"):
            np.testing.assert_array_equal(
                _bits(tmems[w][k].numpy()), _bits(jmem[k][w]), err_msg=k)
    # coordinates both workers sent are sums in another order
    real = np.asarray(jidx).reshape(-1)
    uniq, counts = np.unique(real[real != S], return_counts=True)
    dup = np.zeros(P_, bool)
    dup[uniq[counts > 1]] = True
    ref = np.asarray(jout[0])
    for w in range(W):
        got = outs[w].numpy()
        np.testing.assert_array_equal(_bits(got[~dup]), _bits(ref[~dup]))
        np.testing.assert_allclose(got[dup], ref[dup], rtol=1e-6, atol=0)


def test_engine_takes_the_segment_path_where_jax_does():
    for epoch in (3, 4, 5):
        je, te = _engines(_tree(), epoch)
        assert te._seg == [je._use_seg_kernel(b) for b in je.buckets]
        assert te._seg_fused == je._seg_fused
        assert te.payload_size == je.payload_size
    assert te._seg == [True, False]


def test_sample_rows_3d_matches_jax():
    je, te = _engines(_tree(), 5)
    rng = np.random.RandomState(1)
    vec = rng.randn(te.T).astype(np.float32)
    for b in te.buckets:                             # structural zeros
        for o, n in zip(b.row_offsets, b.numels):
            vec[o + n:o + b.cols] = 0.0
    consts = te._bucket_consts(torch.device("cpu"))
    key = jax.random.PRNGKey(7)
    phases = _jax_phases(je, key)
    v2d = jnp.asarray(vec).reshape(-1, 128)
    for bi, b in enumerate(je.buckets):
        if not te._seg[bi]:
            continue
        want = je._sample_rows_3d(b, v2d, jax.random.fold_in(key, bi))
        got = te._sample_rows_3d(te.buckets[bi], consts[bi],
                                 torch.from_numpy(vec).view(-1, 128),
                                 phases[bi])
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_seg_exchange_matches_jax_engine():
    """Two steps at W=2 (the second masks the first's transmit record on
    read): bitwise against the op-by-op JAX engine; against the jitted
    one, the same indices and records, values and memory within 4 eps."""
    je, te = _engines(_tree(), 5)
    assert [je._use_seg_kernel(b) for b in je.buckets] == [True, False]
    T, P_ = te.T, te.layout.total
    jmem = jax.tree.map(lambda x: jnp.stack([x] * W), je.init_memory())
    tmems = [te.init_memory("cpu") for _ in range(W)]
    rng = np.random.RandomState(5)
    for s in range(2):
        grads = rng.randn(W, P_).astype(np.float32)
        grads[:, T:] *= 0.1
        key = jax.random.PRNGKey(30 + s)
        jit_mem = jmem
        jres, sent, outs = _exchange(je, te, grads, jmem, tmems, key)
        _check_bitwise(te, jres, sent, outs, tmems, grads)
        jjit = jax.jit(jax.vmap(_worker(je), in_axes=(0, 0, None),
                                axis_name="data"))(jnp.asarray(grads),
                                                   jit_mem, key)
        eps4 = 4 * np.finfo(np.float32).eps
        for w in range(W):
            np.testing.assert_array_equal(np.asarray(jjit[3][w]),
                                          sent[w][1].numpy())
            np.testing.assert_array_equal(np.asarray(jjit[1]["sent_bits"][w]),
                                          tmems[w]["sent_bits"].numpy())
            for got, want in ((sent[w][0], jjit[2][w]),
                              (tmems[w]["velocities_c"], jjit[5][w]),
                              (tmems[w]["momentums_c"], jjit[4][w])):
                got, want = got.numpy(), np.asarray(want)
                assert (np.abs(got - want)
                        <= eps4 * (np.abs(want) + 3)).all()
        jmem = jres[1]


def test_sparsify_without_candidates_launches_the_standalone_path():
    """``sparsify(seg_cands=None)`` computes each bucket's own candidates:
    bitwise the payload from the fused compensate's candidates."""
    je, te = _engines(_tree(), 5)
    mem = te.init_memory("cpu")
    g = torch.from_numpy(np.random.RandomState(2).randn(
        te.layout.total).astype(np.float32))
    phases = te.draw_phases(torch.Generator().manual_seed(0))
    vec, cands = te._compensate_acc(mem, g[:te.T])
    assert cands is not None and cands[0].shape == (te.T // SPAN, 2, 128)
    fused = te.sparsify(vec, phases, seg_cands=cands)
    alone = te.sparsify(vec, phases)
    for a, b in zip(fused, alone):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def imagenet_trees():
    x = jnp.zeros((1, 32, 32, 3))
    return {name: jax.eval_shape(lambda: fn().init(
        jax.random.PRNGKey(0), x, train=True))["params"]
        for name, fn in (("resnet18", resnet18), ("resnet50", resnet50))}


@pytest.mark.parametrize("name,want", [
    ("resnet50", [True] * 6 + [False]), ("resnet18", None)])
def test_imagenet_geometry_matches_jax(imagenet_trees, name, want):
    """The bucket geometry and path choice at every warm-up ratio."""
    tree = imagenet_trees[name]
    for epoch in range(6):
        je, te = _engines(tree, epoch)
        assert te.T == je.T and te.payload_size == je.payload_size
        assert te._seg == [je._use_seg_kernel(b) for b in je.buckets]
    assert sum(te._seg) == (6 if name == "resnet50" else 4)
    if want is not None:
        assert te._seg == want


@pytest.mark.parametrize("name,epoch", [("resnet18", 5), ("resnet50", 5),
                                        ("resnet50", 0)])
def test_imagenet_seg_selection_matches_jax_engine(imagenet_trees, name,
                                                   epoch):
    """One worker's send side at the ImageNet ResNets' full layout at ratio
    0.001 (the segment path), and ResNet-50's at the epoch-0 ratio 0.316
    (selections beyond the top-k kernel's k: the lax_top_k route) —
    payload values and indices, momentum and velocity — bitwise against
    the JAX engine, and its transmit record bitwise ``pack_sent_bits`` of
    the JAX payload. The JAX compensate runs op by
    op; its selection is jitted (it has no multiply-add for XLA to
    contract, and op by op it takes half a minute)."""
    je, te = _engines(imagenet_trees[name], epoch)
    T, S = te.T, te.layout.sentinel
    rng = np.random.RandomState(11)
    grad = rng.randn(te.layout.total).astype(np.float32)
    m0 = rng.randn(T).astype(np.float32)
    v0 = rng.randn(T).astype(np.float32)
    jm = je.init_memory()
    _, jmc, jvc, _ = je._compensate_acc(jnp.asarray(m0), jnp.asarray(v0),
                                        jnp.asarray(grad), jm["sent_bits"])
    key = jax.random.PRNGKey(3)
    jvals, jidx = jax.jit(je.sparsify)(jvc, key)
    mem = te.init_memory("cpu")
    mem["momentums_c"].copy_(torch.from_numpy(m0))
    mem["velocities_c"].copy_(torch.from_numpy(v0))
    phases = _jax_phases(je, key)
    tvals, tidx = te.compress(torch.from_numpy(grad), mem, phases)
    np.testing.assert_array_equal(_bits(tvals.numpy()), _bits(jvals))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(_bits(mem["momentums_c"].numpy()),
                                  _bits(jmc))
    np.testing.assert_array_equal(_bits(mem["velocities_c"].numpy()),
                                  _bits(jvc))
    te.apply(tvals[None], tidx[None], torch.zeros(te.layout.total - T), mem,
             0, 1)
    np.testing.assert_array_equal(
        mem["sent_bits"].numpy(),
        np.asarray(jk.pack_sent_bits(jidx, T, sentinel=S)))


# ------------------------------------------------------------------ #
# selection beyond the top-k kernel's k                              #
# ------------------------------------------------------------------ #

def _ties(rng, rows, cols):
    x = (rng.randint(0, 300, (rows, cols)) / 7.0).astype(np.float32)
    x[:, cols // 2:cols // 2 + 1000] = -1.0
    return x


def test_lax_top_k_route_matches_lax_top_k():
    """Above the kernel's k the engine's selection is lax_top_k, bitwise
    lax.top_k (ties to the lower column); the route is counted."""
    x = _ties(np.random.RandomState(4), 3, 40000)
    k = tk.TOPK_MAX_K + 3000
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    tflat.ROUTES["lax_top_k"] = 0
    tk.reset_launches()
    tv, ti = tflat.select_topk(torch.from_numpy(x), k)
    assert tflat.ROUTES["lax_top_k"] == 1 and tk.LAUNCHES["topk_rows"] == 0
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(_bits(tv.numpy()), _bits(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    tflat.select_topk(torch.from_numpy(x), tk.TOPK_MAX_K)
    assert tflat.ROUTES["lax_top_k"] == 1


@pytest.mark.parametrize("k", [37, 2360, 20000])
def test_approx_max_k_on_cpu_is_lax_top_k(k):
    """The JAX engine selects with approx_max_k; on the CPU it lowers to
    the exact lax.top_k, planted ties included, which is what the port's
    exact selection reproduces."""
    x = jnp.asarray(_ties(np.random.RandomState(k), 3, 40000))
    av, ai = jax.lax.approx_max_k(x, k, recall_target=0.9)
    tv, ti = jax.lax.top_k(x, k)
    np.testing.assert_array_equal(_bits(av), _bits(tv))
    np.testing.assert_array_equal(np.asarray(ai), np.asarray(ti))
