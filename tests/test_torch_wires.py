"""The port's flat engine on every wire regime against the JAX engine: one
exchange at W=4 on ResNet-20's layout at the epoch-0 and epoch-5 ratios,
for each regime of the reference's ``_REGIMES`` but its gossip ones as a
uniform plan and for mixed plans; int8 with and without error feedback;
the int64 index wire (``int32_indices=False``, JAX in x64 mode).

The JAX side runs op by op under ``jax.vmap`` (see test_torch_engine.py),
its ``jax.lax.all_gather`` wrapped so that the exchange also returns what
each lane gathered. The port's payload, every gathered lane (the int32
word lane against the JAX ``uint32`` one, bit for bit), the transmit
record and the memory are bitwise the JAX engine's; the exchanged gradient
is bitwise apart from coordinates that several workers sent, whose sums
are compared within f32 rounding (rtol 1e-6, as test_torch_engine.py
has it), and the dense tail on the fp16 wire, whose W-term fp16 sums are
compared within two fp16 roundings of their magnitude."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgc_tpu import DGCCompressor, DGCSGDMemory
from dgc_tpu.compression.flat import FlatDGCEngine, ParamLayout
from dgc_tpu.models import resnet20
from dgc_tpu.utils.compat import enable_x64
from dgc_tpu.utils.pytree import named_flatten as jax_named_flatten
from dgc_tpu_torch.compression import dgc as tdgc
from dgc_tpu_torch.compression import flat as tflat
from dgc_tpu_torch.compression.memory import DGCSGDMemory as TMemory
from dgc_tpu_torch.parallel.comm import LocalComm

W = 4
#: the regimes the port carries, each a uniform plan
UNIFORM = ("dense", "fp32", "fp32_packed", "fp16", "fp16_packed", "int8",
           "int8_packed", "int4_packed", "int8_delta_idx")
#: mixed plans over ResNet-20's two buckets
MIXED = (("int8_delta_idx", "fp16_packed"), ("dense", "int4_packed"),
         ("int8", "fp32_packed"))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread (the file runs beside other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    v = resnet20().init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                        train=True)
    return jax.device_get(v["params"])


def _engines(params, epoch, plan=None, **kw):
    common = dict(sample_ratio=0.01, warmup_epochs=5, **kw)
    jc = DGCCompressor(0.001, memory=DGCSGDMemory(momentum=0.9), **common)
    tc = tdgc.DGCCompressor(0.001, memory=TMemory(momentum=0.9), **common)
    named = jax_named_flatten(params)[0]
    jc.initialize((n, p) for n, p in named.items() if p.ndim > 1)
    tc.initialize((n, p.shape) for n, p in named.items() if p.ndim > 1)
    jc.warmup_compress_ratio(epoch)
    tc.warmup_compress_ratio(epoch)
    return (FlatDGCEngine(jc, ParamLayout.for_compressor(params, jc),
                          plan=plan),
            tflat.FlatDGCEngine(tc, tflat.ParamLayout.for_compressor(
                params, tc), plan=plan))


def _jax_phases(engine, key):
    """The uniforms the JAX engine's _sample_rows draws, per worker."""
    out = []
    for w in range(W):
        kw = jax.random.fold_in(key, w)
        per = []
        for bi, b in enumerate(engine.buckets):
            kb = jax.random.fold_in(kw, bi)
            per.append([] if b.exact else [
                float(jax.random.uniform(jax.random.fold_in(kb, gi), ()))
                for gi in range(len(b.stride_groups))])
        out.append(per)
    return out


def _step(engine):
    """The JAX worker, vmapped: exchanged gradient, memory, the payload
    before encoding, and every lane's gathered [W, ...] stack in the order
    the exchange gathers them."""
    orig = jax.lax.all_gather

    def worker(fg, mem, key):
        key = jax.random.fold_in(key, jax.lax.axis_index("data"))
        vals = idx = jnp.zeros((0,), jnp.int32)
        if engine._sparse_ids:
            _, mc, vc, _ = engine._compensate_acc(
                mem["momentums_c"], mem["velocities_c"], fg,
                mem["sent_bits"])
            vals, idx = engine.sparsify(vc, key)
        rec = []

        def spy(x, axis_name, **kw):
            y = orig(x, axis_name, **kw)
            rec.append(y)
            return y
        with mock.patch.object(jax.lax, "all_gather", spy):
            out, mem = engine.exchange(fg, mem, key, "data", W)
        return out, mem, vals, idx, tuple(rec)
    return jax.vmap(worker, in_axes=(0, 0, None), axis_name="data")


def _jax_lane_names(je):
    """The lanes in the JAX exchange's gather order."""
    kp = je._kind_payload
    names = []
    if kp.get("i8") or kp.get("i4"):
        names.append("q")
    if kp.get("f32") or kp.get("i8") or kp.get("i4"):
        names.append("f32")
    if kp.get("f16"):
        names.append("f16")
    if je._codec is not None or je._dcodec is not None:
        names.append("words")
    if je._plain_payload:
        names.append("idx")
    return names


def _bits(a):
    a = np.asarray(a)
    if a.dtype.kind == "f":
        return a.view({2: np.int16, 4: np.int32, 8: np.int64}[a.itemsize])
    if a.dtype == np.uint32:
        return a.view(np.int32)
    return a


def _check(je, te, epoch, seed=0):
    T, P_, S = te.T, te.layout.total, te.layout.sentinel
    jmem = jax.tree.map(lambda x: jnp.stack([x] * W), je.init_memory())
    tmems = [te.init_memory("cpu") for _ in range(W)]
    rng = np.random.RandomState(100 + epoch + seed)
    key = jax.random.PRNGKey(7 * epoch + seed)
    for step in range(2):
        grads = rng.randn(W, P_).astype(np.float32)
        grads[:, T:] *= 0.1
        key = jax.random.fold_in(key, step)
        jout, jmem, jvals, jidx, jlanes = _step(je)(jnp.asarray(grads), jmem,
                                                    key)
        phases = _jax_phases(je, key)
        pre = [{k: v.clone() for k, v in m.items()} for m in tmems]
        sent = ([te.compress(torch.from_numpy(grads[w]), pre[w], phases[w])
                 for w in range(W)] if te._sparse_ids else [])
        lanes = [te.encode(v, i, pre[w])[0] for w, (v, i) in enumerate(sent)]
        touts = te.exchange([torch.from_numpy(g) for g in grads], tmems,
                            phases, LocalComm(W))
        for w in range(W):
            if not sent:
                break
            np.testing.assert_array_equal(_bits(sent[w][0].numpy()),
                                          _bits(jvals[w]))
            np.testing.assert_array_equal(sent[w][1].numpy(),
                                          np.asarray(jidx[w]))
            assert sent[w][1].dtype == (torch.int64
                                        if te.index_dtype == torch.int64
                                        else torch.int32)
        for w in range(W):
            for k in ("momentums_c", "velocities_c", "momentums_d",
                      "velocities_d", "sent_bits"):
                np.testing.assert_array_equal(
                    _bits(tmems[w][k].numpy()), _bits(jmem[k][w]),
                    err_msg=f"step {step} {k}")
        names = _jax_lane_names(je) if sent else []
        assert sorted(names) == sorted(lanes[0] if lanes else [])
        assert len(jlanes) == len(names)
        for name, g in zip(names, jlanes):
            mine = torch.stack([ln[name] for ln in lanes]).numpy()
            np.testing.assert_array_equal(_bits(mine), _bits(g[0]),
                                          err_msg=f"lane {name}")
        real = np.asarray(jidx).reshape(-1)
        real = real[real != S]
        uniq, counts = np.unique(real, return_counts=True)
        dup = np.zeros(P_, bool)
        dup[uniq[counts > 1]] = True
        tail = np.zeros(P_, bool)
        if te.c.fp16_values:
            tail[T:] = True
            for bi in te._dense_ids:
                b = te.buckets[bi]
                tail[b.base:b.base + b.rows * b.cols] = True
        ref = np.asarray(jout[0])
        exact = ~dup & ~tail
        for w in range(W):
            got = touts[w].numpy()
            np.testing.assert_array_equal(_bits(got[exact]),
                                          _bits(ref[exact]))
            np.testing.assert_allclose(got[dup], ref[dup], rtol=1e-6, atol=0)
            # W fp16 roundings of the running sum, then the divide by W
            mag = np.abs(grads[:, tail]).sum(0) / W
            assert (np.abs(got[tail] - ref[tail])
                    <= 2 * 2.0 ** -10 * mag + 1e-7).all()


@pytest.mark.parametrize("epoch", [0, 5])
@pytest.mark.parametrize("regime", UNIFORM + tuple("+".join(m)
                                                   for m in MIXED))
def test_exchange_matches_jax_on_every_regime(params, regime, epoch):
    je, te = _engines(params, epoch, plan=tuple(regime.split("+")) * (
        1 if "+" in regime else 2))
    assert te.regimes == je.regimes and te.payload_size == je.payload_size
    assert te.wire_bytes_per_worker() == je.wire_bytes_per_worker()
    assert te.bucket_wire_bytes() == je.bucket_wire_bytes()
    _check(je, te, epoch)


@pytest.mark.parametrize("feedback", [True, False])
@pytest.mark.parametrize("flags", ["int8", "int8_packed", "fp16"])
def test_compressor_flags_match_jax(params, flags, feedback):
    """The uniform regime from the compressor's flags (no plan), at the
    epoch-5 ratio, int8 error feedback on and off."""
    kw = {"int8": dict(int8_values=True),
          "int8_packed": dict(int8_values=True, packed_indices=True),
          "fp16": dict(fp16_values=True)}[flags]
    je, te = _engines(params, 5, int8_error_feedback=feedback, **kw)
    assert te.regimes == je.regimes == (flags, flags)
    _check(je, te, 5, seed=1)


@pytest.mark.parametrize("epoch", [0, 5])
@pytest.mark.parametrize("regime", ["fp32", "int8_packed"])
def test_int64_index_wire_matches_jax(params, regime, epoch):
    """``int32_indices=False``: the payload's indices and their lane are
    int64, bitwise the JAX engine's in x64 mode."""
    with enable_x64(True):
        je, te = _engines(params, epoch, plan=(regime, regime),
                          int32_indices=False)
        assert te.index_dtype == torch.int64
        assert te.wire_bytes_per_worker() == je.wire_bytes_per_worker()
        _check(je, te, epoch, seed=2)


def test_plans_and_refusals(params):
    je, te = _engines(params, 5)
    assert te.regimes == ("fp32", "fp32") and te._sparse_ids == [0, 1]
    with pytest.raises(ValueError, match="different geometry"):
        _engines(params, 5, plan=("fp32",))
    # a bare regime tuple with a gossip family: a plain f32-wire engine
    # with no gossip schedule in both packages (only a planner Plan
    # carries one, and the planner refuses gossip next to fp32)
    je, te = _engines(params, 5, plan=("gossip_ring", "fp32"))
    assert te.regimes == je.regimes == ("gossip_ring", "fp32")
    assert te._gossip is None and je._gossip is None
    assert te.wire_bytes_per_worker() == je.wire_bytes_per_worker()
    with pytest.raises(ValueError, match="unknown exchange regime"):
        _engines(params, 5, plan=("int2", "fp32"))
    # the payload checksum is ported (test_torch_checksum.py holds it):
    # both engines build it; over the int8 wire both refuse it
    je, te = _engines(params, 5, checksum=True)
    assert te.checksum and je.checksum
    with pytest.raises(ValueError, match="int8_values"):
        _engines(params, 5, checksum=True, int8_values=True)
    dense = _engines(params, 5, plan=("dense", "dense"))[1]
    assert dense.dense and dense.payload_size == 0
