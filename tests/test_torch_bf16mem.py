"""The bf16 error-feedback state (``DGCSGDMemory(dtype="bfloat16")``) on the
port's flat engine, against the JAX package.

Kernels: the plain versions of the bit-masked compensate, the fused
compensate-and-candidates and the segment candidates on bf16 state are
bitwise the JAX op-by-op references (``fused_compensate_bits_reference``,
``seg_top2_reference``). Against the jitted Pallas kernels (interpret mode)
the stored state is within one bf16 step (the jitted f32 math contracts
an FMA; the one rounding to bf16 absorbs that gap except where the two f32
values straddle a rounding boundary) or, where the sum cancels to near
zero, within the f32 test's 4 eps (|m| + |g| + |v|); the candidates of a
state are bitwise.

The engine: at W=4 with bf16 memory, three steps of the exchange on given
gradients — the payload (values in bf16), the memory, the transmit record
bitwise, the exchanged gradient bitwise apart from coordinates several
workers sent (rtol 1e-6, f32 sums in another order) — on ResNet-20's
layout at the epoch-0 and epoch-5 ratios (the 2-D path; the JAX engine
there with ``approx_recall=None``, see the test) and on a layout
whose buckets take the segment path, with the f32 wire and with the int8
wire (error feedback) and packed indices; and one step of the W=8
``shard_map`` exchange on ``mesh8`` over a small layout at the epoch-0
ratio. The JAX side runs op by op."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from dgc_tpu import DGCCompressor, DGCSGDMemory
from dgc_tpu.compression.flat import FlatDGCEngine, ParamLayout
from dgc_tpu.models import resnet20
from dgc_tpu.ops import kernels as jk
from dgc_tpu.utils.compat import shard_map
from dgc_tpu.utils.pytree import named_flatten as jax_named_flatten
from dgc_tpu_torch.compression import dgc as tdgc
from dgc_tpu_torch.compression import flat as tflat
from dgc_tpu_torch.compression.memory import DGCSGDMemory as TMemory
from dgc_tpu_torch.ops import kernels as tk
from dgc_tpu_torch.parallel.comm import LocalComm

SPAN = tk.SEG_SPAN


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread (the file runs beside other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a):
    a = np.asarray(a)
    if a.dtype.kind == "f" or a.dtype.name == "bfloat16":
        return a.view({2: np.int16, 4: np.int32}[a.itemsize])
    return a


def _t(x, dtype=torch.bfloat16):
    return torch.from_numpy(np.asarray(x, np.float32).copy()).to(dtype)


def _within_one_bf16_step(got, want, mag):
    """Over the finite values: equal as numbers (+0.0 / -0.0 alike), one
    bf16 step apart, or within the f32 FMA bound ``4 eps mag`` (a sum that
    cancels to near zero)."""
    gb, wb = _bits(got), _bits(want)
    wf = np.asarray(want, np.float32)
    gf = gb.astype(np.int32).astype(np.uint32) << 16
    gf = gf.view(np.float32)
    fin = np.isfinite(wf)
    zero = ((gb & 0x7FFF) == 0) & ((wb & 0x7FFF) == 0)
    d = np.abs(gb.astype(np.int32) - wb.astype(np.int32))
    near = np.abs(gf - wf) <= 4 * np.finfo(np.float32).eps * mag
    assert (d[fin & ~zero & ~near] <= 1).all()


def _kernel_inputs(seed, nseg=2, tail=2048):
    """f32 gradient, bf16-exact state with zeros and large values planted
    and ties planted across segment blocks, a transmit record."""
    rng = np.random.RandomState(seed)
    n = nseg * SPAN + tail
    g, m, v = (rng.randn(n).astype(np.float32) for _ in range(3))
    m[::97] = 0.0
    v[::53] = 1e4
    g[::89] = -0.0
    m, v = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
            for x in (m, v))
    # equal magnitudes of opposite sign in one (lane, segment) cell
    v[5 * 128 + 3], v[200 * 128 + 3] = 7.0, -7.0
    g[5 * 128 + 3] = g[200 * 128 + 3] = 0.0
    m[5 * 128 + 3] = m[200 * 128 + 3] = 0.0
    sent = rng.choice(n, n // 10, replace=False)
    bits = np.asarray(jk.pack_sent_bits(jnp.asarray(sent, jnp.int32), n))
    return g, m, v, bits


_FLAGS = [(False, True), (True, True), (False, False), (True, False)]


@pytest.mark.parametrize("nesterov,masking", _FLAGS)
def test_compensate_bits_bf16_matches_jax(nesterov, masking):
    g, m, v, bits = _kernel_inputs(1)
    args = (0.9, nesterov, masking)
    rm, rv = jk.fused_compensate_bits_reference(
        jnp.asarray(g), jnp.asarray(m, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), jnp.asarray(bits), *args)
    tm, tv = _t(m), _t(v)
    out = tk.compensate_bits(torch.from_numpy(g), tm, tv,
                             torch.from_numpy(bits.copy()), *args)
    assert out[0] is tm and tm.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(tm.view(torch.int16).numpy()),
                                  _bits(rm))
    np.testing.assert_array_equal(tv.view(torch.int16).numpy(), _bits(rv))
    pm, pv = jk.fused_compensate_bits(
        jnp.asarray(g), jnp.asarray(m, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), jnp.asarray(bits), *args)
    mag = np.abs(g) + np.abs(m) + np.abs(v)
    _within_one_bf16_step(tm.view(torch.int16).numpy(), np.asarray(pm), mag)
    _within_one_bf16_step(tv.view(torch.int16).numpy(), np.asarray(pv), mag)


@pytest.mark.parametrize("nesterov,masking", _FLAGS)
def test_compensate_bits_cands_bf16_matches_jax(nesterov, masking):
    g, m, v, bits = _kernel_inputs(2)
    n, nseg = g.shape[0], g.shape[0] // SPAN
    args = (0.9, nesterov, masking)
    rm, rv = jk.fused_compensate_bits_reference(
        jnp.asarray(g), jnp.asarray(m, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), jnp.asarray(bits), *args)
    rvals, rcols = jk.seg_top2_reference(rv.reshape(-1, 128), 0, 1,
                                         nseg * SPAN)
    tm, tv = _t(m), _t(v)
    _, _, cv, cb = tk.compensate_bits_cands(
        torch.from_numpy(g), tm, tv, torch.from_numpy(bits.copy()), *args)
    np.testing.assert_array_equal(tm.view(torch.int16).numpy(), _bits(rm))
    np.testing.assert_array_equal(tv.view(torch.int16).numpy(), _bits(rv))
    assert cv.dtype == torch.float32
    np.testing.assert_array_equal(_bits(cv.reshape(1, -1).numpy()),
                                  _bits(rvals))
    np.testing.assert_array_equal(
        tk.seg_cols_local(cb.view(1, nseg, 2, 128)).numpy(),
        np.asarray(rcols))
    # the Pallas kernel (interpret mode): its state within one bf16 step,
    # its candidates bitwise the port's on that state
    pm, pv, pcv, pcb = jk.fused_compensate_bits_cands(
        jnp.asarray(g), jnp.asarray(m, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), jnp.asarray(bits), *args)
    _within_one_bf16_step(tv.view(torch.int16).numpy(), np.asarray(pv),
                          np.abs(g) + np.abs(m) + np.abs(v))
    pvt = _t(np.asarray(pv, np.float32))
    want = tk.seg_top2_candidates_plain(pvt, 0, 1, nseg * SPAN)
    np.testing.assert_array_equal(
        _bits(np.asarray(pcv)[:nseg].reshape(1, -1)),
        _bits(want[0].numpy()))
    np.testing.assert_array_equal(
        tk.seg_cols_local(torch.from_numpy(np.asarray(pcb)[:nseg]).view(
            1, nseg, 2, 128)).numpy(), want[1].numpy())
    assert n == pv.shape[0]


@pytest.mark.parametrize("base,rows,cols", [(0, 1, 2 * SPAN),
                                            (SPAN, 2, SPAN)])
def test_seg_top2_candidates_bf16_matches_jax(base, rows, cols):
    _, _, v, _ = _kernel_inputs(3, nseg=3, tail=0)
    vb = jnp.asarray(v, jnp.bfloat16)
    got = tk.seg_top2_candidates(_t(v), base, rows, cols)
    for want in (jk.seg_top2_reference(vb.reshape(-1, 128), base, rows,
                                       cols),
                 jk.seg_top2_candidates(vb.reshape(-1, 128), base, rows,
                                        cols)):
        assert got[0].dtype == torch.float32
        np.testing.assert_array_equal(_bits(got[0].numpy()),
                                      _bits(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_bf16_ladder_is_the_reference_bf16_pow():
    for lower in (0.8, 0.5, 0.9, 0.77):
        want = lower ** jnp.arange(11, dtype=jnp.bfloat16)
        got = tflat._state_ladder(lower, 11, torch.bfloat16)
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      _bits(want))


def test_topk_and_select_take_bf16():
    rng = np.random.RandomState(4)
    x = _t(rng.randn(5, 700))
    x[0, :10] = x[0, 10:20]                       # ties
    v, c = tk.topk_rows(x, 37)
    jv, jc = jax.lax.top_k(jnp.asarray(x.float().numpy(), jnp.bfloat16), 37)
    assert v.dtype == torch.bfloat16
    np.testing.assert_array_equal(v.view(torch.int16).numpy(), _bits(jv))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    numels = torch.tensor([700, 5, 650, 1, 699], dtype=torch.int32)
    s, vals, cols = tk.select_pack_rows(x, numels, 20)
    js, jvals, jcols = jk.select_pack_rows_reference(
        jnp.asarray(x.float().numpy(), jnp.bfloat16),
        jnp.asarray(numels.numpy()), 20)
    for a, b in ((s, js), (vals, jvals)):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            np.asarray(a.float().numpy()), np.asarray(b, np.float32))
    np.testing.assert_array_equal(cols.numpy(), np.asarray(jcols))
    with pytest.raises(ValueError, match="f32-only"):
        z = torch.zeros(128, dtype=torch.bfloat16)
        tk.dgc_forward_rows(torch.zeros(128), z, z,
                            torch.zeros(128, dtype=torch.int32), 0,
                            torch.tensor([128], dtype=torch.int32), 4, 0.9)


# ------------------------------------------------------------------ #
# the engine                                                         #
# ------------------------------------------------------------------ #

#: a layout whose three buckets take the segment path at ratio 0.001
_SEG_SHAPES = {"a": (256, 512), "b": (512, 256), "c": (128, 512),
               "d": (64, 1024), "bias": (64,)}


@pytest.fixture(scope="module")
def r20_params():
    v = resnet20().init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                        train=True)
    return jax.device_get(v["params"])


def _engines(tree, epoch, jax_kw=None, **kw):
    common = dict(sample_ratio=0.01, warmup_epochs=5, **kw)
    jc = DGCCompressor(0.001, memory=DGCSGDMemory(momentum=0.9,
                                                  dtype="bfloat16"),
                       **common, **(jax_kw or {}))
    tc = tdgc.DGCCompressor(0.001, memory=TMemory(momentum=0.9,
                                                  dtype="bfloat16"), **common)
    named = jax_named_flatten(tree)[0]
    jc.initialize((n, p) for n, p in named.items() if np.ndim(p) > 1)
    tc.initialize((n, np.shape(p)) for n, p in named.items()
                  if np.ndim(p) > 1)
    jc.warmup_compress_ratio(epoch)
    tc.warmup_compress_ratio(epoch)
    je = FlatDGCEngine(jc, ParamLayout.for_compressor(tree, jc))
    te = tflat.FlatDGCEngine(tc, tflat.ParamLayout.for_compressor(tree, tc))
    assert te.state_dtype == torch.bfloat16 and not te._mk_fwd_ids
    return je, te


def _phases(engine, key, world):
    out = []
    for w in range(world):
        kw = jax.random.fold_in(key, w)
        out.append([[] if b.exact else [
            float(jax.random.uniform(jax.random.fold_in(
                jax.random.fold_in(kw, bi), gi), ()))
            for gi in range(len(b.stride_groups))]
            for bi, b in enumerate(engine.buckets)])
    return out


def _worker(engine, world):
    def worker(fg, mem, key):
        key = jax.random.fold_in(key, jax.lax.axis_index("data"))
        _, mc, vc, _ = engine._compensate_acc(
            mem["momentums_c"], mem["velocities_c"], fg, mem["sent_bits"])
        vals, idx = engine.sparsify(vc, key)
        out, mem = engine.exchange(fg, mem, key, "data", world)
        return out, mem, vals, idx
    return worker


def _check_steps(je, te, step, world, steps, seed):
    T, P_, S = te.T, te.layout.total, te.layout.sentinel
    jmem = jax.tree.map(lambda x: jnp.stack([x] * world), je.init_memory())
    tmems = [te.init_memory("cpu") for _ in range(world)]
    assert tmems[0]["velocities_c"].dtype == torch.bfloat16
    assert tmems[0]["sent_bits"].dtype == torch.int32
    rng = np.random.RandomState(seed)
    for s in range(steps):
        grads = rng.randn(world, P_).astype(np.float32)
        grads[:, T:] *= 0.1
        key = jax.random.PRNGKey(100 * seed + s)
        jout, jmem, jvals, jidx = step(jnp.asarray(grads), jmem, key)
        phases = _phases(je, key, world)
        pre = [{k: v.clone() for k, v in m.items()} for m in tmems]
        sent = [te.compress(torch.from_numpy(grads[w]), pre[w], phases[w])
                for w in range(world)]
        touts = te.exchange([torch.from_numpy(g) for g in grads], tmems,
                            phases, LocalComm(world))
        for w in range(world):
            assert sent[w][0].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                sent[w][0].view(torch.int16).numpy(), _bits(jvals[w]))
            np.testing.assert_array_equal(sent[w][1].numpy(),
                                          np.asarray(jidx[w]))
            for k in ("momentums_c", "velocities_c", "momentums_d",
                      "velocities_d", "sent_bits"):
                np.testing.assert_array_equal(
                    _bits(tmems[w][k].view(torch.int16)
                          if tmems[w][k].dtype == torch.bfloat16
                          else tmems[w][k]), _bits(jmem[k][w]),
                    err_msg=f"step {s} {k}")
        real = np.asarray(jidx).reshape(-1)
        real = real[real != S]
        uniq, counts = np.unique(real, return_counts=True)
        dup = np.zeros(P_, bool)
        dup[uniq[counts > 1]] = True
        ref = np.asarray(jout[0])
        for w in range(world):
            got = touts[w].numpy()
            np.testing.assert_array_equal(_bits(got[~dup]),
                                          _bits(ref[~dup]))
            np.testing.assert_allclose(got[dup], ref[dup], rtol=1e-6,
                                       atol=0)
    # the per-name checkpoint format carries the bf16 state
    jsd = jax.tree.map(np.asarray, je.memory_state_dict(
        jax.tree.map(lambda x: x[0], jmem)))
    tsd = te.memory_state_dict(tmems[0])
    for key in ("momentums", "velocities"):
        for n, a in jsd[key].items():
            assert tsd[key][n].dtype == torch.bfloat16
            np.testing.assert_array_equal(tsd[key][n].float().numpy(),
                                          np.asarray(a, np.float32))
    tl = te.load_memory_state_dict(te.init_memory("cpu"), tsd)
    jl = je.load_memory_state_dict(je.init_memory(), jsd)
    for k, a in jl.items():
        assert tl[k].dtype == tmems[0][k].dtype
        np.testing.assert_array_equal(_bits(
            tl[k].view(torch.int16) if tl[k].dtype == torch.bfloat16
            else tl[k]), _bits(a), err_msg=k)


@pytest.mark.parametrize("epoch", [0, 5])
def test_bf16_engine_matches_jax_resnet20(r20_params, epoch):
    # the JAX engine selects with its exact lax.top_k here: its CPU
    # approx_max_k fallback (k > 128) sorts equal bf16 magnitudes, which
    # bf16 makes common, in XLA's own order, where lax.top_k and the port
    # put the lower column first
    je, te = _engines(r20_params, epoch, jax_kw=dict(approx_recall=None))
    step = jax.vmap(_worker(je, 4), in_axes=(0, 0, None), axis_name="data")
    _check_steps(je, te, step, 4, steps=3, seed=epoch)


@pytest.mark.parametrize("wire", ["fp32", "int8_packed"])
def test_bf16_engine_matches_jax_on_the_segment_path(wire):
    tree = {n: np.zeros(s, np.float32) for n, s in _SEG_SHAPES.items()}
    kw = (dict(int8_values=True, packed_indices=True)
          if wire == "int8_packed" else {})
    je, te = _engines(tree, 5, **kw)
    assert any(te._seg) and te._seg_fused and te.regimes[0] == wire
    step = jax.vmap(_worker(je, 4), in_axes=(0, 0, None), axis_name="data")
    _check_steps(je, te, step, 4, steps=3, seed=7)


#: a small layout for the op-by-op ``shard_map`` case (8 devices)
_MESH_SHAPES = {"c1": (3, 3, 16, 32), "c2": (3, 3, 32, 32), "fc": (64, 10),
                "bias": (32,)}


def test_bf16_engine_matches_jax_on_mesh8(mesh8):
    tree = {n: np.zeros(s, np.float32) for n, s in _MESH_SHAPES.items()}
    # the JAX engine's exact top-k, as in the ResNet-20 case
    je, te = _engines(tree, 0, jax_kw=dict(approx_recall=None))
    worker = _worker(je, 8)

    def per_device(fg, mem, key):
        out = worker(fg[0], jax.tree.map(lambda x: x[0], mem), key)
        return jax.tree.map(lambda x: x[None], out)
    step = shard_map(per_device, mesh=mesh8,
                     in_specs=(P("data"), P("data"), P()),
                     out_specs=(P("data"),) * 4, check_vma=False)
    _check_steps(je, te, step, 8, steps=1, seed=11)
