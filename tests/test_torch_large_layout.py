"""Flat layouts of 2**31 slots or more (ROADMAP queue 1 item 14) on the
CPU, allocating nothing of that size: the port's ``ParamLayout`` and
``FlatDGCEngine`` built from shapes against the JAX package's (the int64
index dtype, the forced int64 wire, the bucket geometry and payload); the
plain apply on int64 indices bitwise its int32 form and the JAX
references under x64; the transmit record's word and bit of positions
past 2**31 against the reference formula; the launch plans at such a
size (every argument within its C type, the 64-bit instantiations picked
there and the 32-bit ones below); the routes without a 64-bit kernel
refused; and the engine's 64-bit path run at a small size (the 32-bit
limit lowered) bitwise its ordinary path.

Every comparison is bitwise: the plain apply sums in payload order on
both index types, and the wide engine path differs from the narrow one
only in the index dtype it carries."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dgc_tpu import DGCCompressor as JaxCompressor
from dgc_tpu import DGCSGDMemory as JaxMemory
from dgc_tpu.compression.flat import FlatDGCEngine as JaxEngine
from dgc_tpu.compression.flat import ParamLayout as JaxLayout
from dgc_tpu.ops import kernels as jk
from dgc_tpu.utils.compat import enable_x64
from dgc_tpu_torch import configs
from dgc_tpu_torch.compression.dgc import DGCCompressor
from dgc_tpu_torch.compression.flat import FlatDGCEngine, ParamLayout
from dgc_tpu_torch.compression.memory import DGCSGDMemory
from dgc_tpu_torch.models import from_config
from dgc_tpu_torch.ops import kernels as tk
from dgc_tpu_torch.parallel.comm import LocalComm

HUGE = 2 ** 31 + 128          # the reference test's tensor (test_flat.py)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread, restored afterwards: the files run beside
    other test workers, where several threads a worker oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _LargestTensor(TorchDispatchMode):
    """The most elements any tensor an aten op makes inside the block."""

    def __init__(self):
        super().__init__()
        self.most = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.most = max(self.most, t.numel())
        return out


def _resnet50_shapes():
    with torch.device("meta"):
        model = from_config(configs.resnet50_wm5().model, None)
    return {n.replace(".", "/"): tuple(p.shape)
            for n, p in model.named_parameters()}


def _port_engine(shapes, compressed, ratio, epoch=None,
                 mem_dtype="bfloat16", **flags):
    cc = configs.resnet50_wm5().train.compression
    comp = DGCCompressor(
        ratio, memory=DGCSGDMemory(0.9, nesterov=True, dtype=mem_dtype),
        sample_ratio=cc.sample_ratio,
        warmup_epochs=cc.warmup_epochs if epoch is not None else 0,
        **flags)
    comp.initialize((n, shapes[n]) for n in compressed)
    if epoch is not None:
        comp.warmup_compress_ratio(epoch)
    layout = ParamLayout(shapes, list(comp.attributes))
    return comp, layout, FlatDGCEngine(comp, layout)


def _jax_engine(shapes, compressed, ratio):
    comp = JaxCompressor(ratio, memory=JaxMemory(momentum=0.9,
                                                 nesterov=True),
                         sample_ratio=0.01)
    comp.initialize([(n, (math.prod(shapes[n]), shapes[n]))
                     for n in compressed])
    tree = {n: jax.ShapeDtypeStruct(s, jnp.float32)
            for n, s in shapes.items()}
    layout = JaxLayout(tree, list(comp.attributes))
    with enable_x64(True):
        return layout, JaxEngine(comp, layout)


def test_int64_index_wire_from_shapes():
    """``tests/test_flat.py::test_int64_index_wire_path`` on the port: a
    2**31 + 128 slot layout is int64, the engine forces the int64 wire
    with the reference's payload, and neither allocates a tensor of that
    size; a 2**20 layout keeps int32 unless ``int32_indices=False``."""
    shapes = {"w": (HUGE,)}
    spy = _LargestTensor()
    with spy:
        comp, layout, eng = _port_engine(shapes, ["w"], 1e-6)
    assert spy.most < 2 ** 24
    assert layout.index_dtype == torch.int64
    assert eng.index_dtype == torch.int64
    assert eng.payload_size == comp.attributes["w"].num_selects
    jlay, jeng = _jax_engine(shapes, ["w"], 1e-6)
    assert jlay.index_dtype == np.int64 and jeng.index_dtype == jnp.int64
    assert (layout.total, eng.T, eng.payload_size) == (
        jlay.total, jeng.T, jeng.payload_size)
    small = {"w": (2 ** 20,)}
    _, lay32, eng32 = _port_engine(small, ["w"], 0.01)
    assert lay32.index_dtype == torch.int32
    assert eng32.index_dtype == torch.int32
    _, _, eng64 = _port_engine(small, ["w"], 0.01, int32_indices=False)
    assert eng64.index_dtype == torch.int64


def test_resnet50_plus_huge_tensor_geometry():
    """The card's large layout (``chip_smoke.py``'s ``phase_large_layout``):
    ResNet-50 at ratio 0.001 beside ``w`` of 2**31 + 128 elements. The
    size sort puts ``w`` first, on the 3-D fallback (its 512 segment rows
    of 4,194,560 columns are not whole candidate segments), and every
    ResNet-50 bucket and the dense tail past 2**31, each bucket the
    ResNet-50-only layout's shifted by one offset; the geometry and the
    payload are the JAX engine's."""
    shapes = _resnet50_shapes()
    conv = [n for n, s in shapes.items() if len(s) > 1]
    big = dict(shapes, w=(HUGE,))
    spy = _LargestTensor()
    with spy:
        _, lay, eng = _port_engine(big, conv + ["w"], 0.001, epoch=5)
    assert spy.most < 2 ** 24
    _, lay50, eng50 = _port_engine(shapes, conv, 0.001, epoch=5)
    assert eng.index_dtype == torch.int64 and eng50.index_dtype == torch.int32
    assert eng.T == 2_174_683_136 and lay.total == 2_174_738_432
    w0 = eng.buckets[0]
    assert (w0.base, w0.rows, w0.cols) == (0, 512, 4_194_560)
    assert eng._sel3d[0] and not eng._seg[0]
    shift = eng.buckets[1].base
    assert shift == 2 ** 31 + 2 ** 17
    assert [(b.base - shift, b.rows, b.cols, b.payload)
            for b in eng.buckets[1:]] == [(b.base, b.rows, b.cols, b.payload)
                                          for b in eng50.buckets]
    assert eng._seg[1:] == eng50._seg and eng._seg_fused
    assert (lay.sentinel - shift, lay.t_compressed - shift,
            lay.total - shift) == (lay50.sentinel, lay50.t_compressed,
                                   lay50.total)
    assert eng.payload_size == w0.payload + eng50.payload_size
    jlay, jeng = _jax_engine(big, conv + ["w"], 0.001)
    assert (jlay.total, jeng.T, jeng.payload_size) == (
        lay.total, eng.T, eng.payload_size)
    assert [(b.base, b.rows, b.cols, b.payload) for b in jeng.buckets] == [
        (b.base, b.rows, b.cols, b.payload) for b in eng.buckets]


@pytest.mark.parametrize("divisor", [None, 2.0, 3.0])
def test_plain_apply_int64_matches_int32_and_reference(divisor):
    """The plain apply on int64 indices: bitwise its int32 form and the
    JAX references run on int64 indices under x64 (duplicates, the
    sentinel, out-of-range and zero entries planted)."""
    rng = np.random.RandomState(7)
    total = 17 * 4096 + 2048
    n = 30_000
    i = rng.randint(-5, total + 5, n)
    i[:200] = total - 2048 + rng.randint(0, 2048, 200)
    i[200:400] = i[:200]                         # duplicate coordinates
    v = rng.randn(n).astype(np.float32)
    v[::97] = 0.0
    f = np.zeros(n, bool)
    _, first = np.unique(i, return_index=True)
    first = first[(i[first] >= 0) & (i[first] < total)]
    f[rng.choice(first, 5000, replace=False)] = True
    a32, b32 = tk.apply_rows(torch.from_numpy(v),
                             torch.from_numpy(i.astype(np.int32)),
                             torch.from_numpy(f), total, divisor)
    a64, b64 = tk.apply_rows(torch.from_numpy(v), torch.from_numpy(i),
                             torch.from_numpy(f), total, divisor)
    np.testing.assert_array_equal(a64.numpy().view(np.int32),
                                  a32.numpy().view(np.int32))
    np.testing.assert_array_equal(b64.numpy(), b32.numpy())
    keep = (i >= 0) & (i < total)
    with enable_x64(True):
        args = (jnp.asarray(v[keep]), jnp.asarray(i[keep], jnp.int64),
                jnp.asarray(f[keep]), total)
        if divisor is None:
            ra, rb = jk.payload_apply_bits_reference(*args)
        else:
            ra, rb = jk.dgc_apply_rows_reference(*args, divisor=divisor)
    np.testing.assert_array_equal(a64.numpy().view(np.int32),
                                  np.asarray(ra).view(np.int32))
    np.testing.assert_array_equal(b64.numpy(), np.asarray(rb))


def test_record_word_and_bit_past_2_31():
    """The transmit record's word and bit of int64 positions past 2**31
    (:func:`kernels.sent_word_bit`, the arithmetic ``pack_sent_bits``
    runs) against the reference formula in numpy, no record built; and
    ``pack_sent_bits`` on int64 indices bitwise its int32 form and the
    JAX function."""
    rng = np.random.RandomState(3)
    p = np.concatenate([2 ** 31 - 4096 + np.arange(8192),
                        rng.randint(2 ** 31, 2 ** 34, 10_000)])
    w, b = tk.sent_word_bit(torch.from_numpy(p))
    np.testing.assert_array_equal(w.numpy(), (p // 4096) * 128 + p % 128)
    np.testing.assert_array_equal(b.numpy(), (p // 128) % 32)
    assert w.dtype == torch.int64 and int(w.min()) >= 0
    total = 9 * 4096
    idx = rng.choice(total, 3000, replace=False)
    r64 = tk.pack_sent_bits(torch.from_numpy(idx), total)
    r32 = tk.pack_sent_bits(torch.from_numpy(idx.astype(np.int32)), total)
    np.testing.assert_array_equal(r64.numpy(), r32.numpy())
    with enable_x64(True):
        ref = jk.pack_sent_bits(jnp.asarray(idx, jnp.int64), total)
    np.testing.assert_array_equal(r64.numpy(), np.asarray(ref))


def test_launch_plans_at_2_31_fit_their_c_types():
    """The plans the card's large layout gives its kernels: every launch
    argument within its C type, the 64-bit instantiations where the
    offsets pass 2**31 (the apply, the Triton compensate) and the 32-bit
    ones below; the apply's scratch bounded by the layout, not the mean
    load; the top-k of the 3-D fallback's [65536, 32770] candidates and
    the ResNet-50 buckets' segment gate at their bases past 2**31."""
    c_int = 2 ** 31 - 1
    shapes = _resnet50_shapes()
    conv = [n for n, s in shapes.items() if len(s) > 1]
    _, lay, eng = _port_engine(dict(shapes, w=(HUGE,)), conv + ["w"], 0.001,
                               epoch=5)
    T, n = eng.T, 2 * eng.payload_size
    plan = tk.apply_plan(n, T)
    assert plan.index64 and plan.route == "list"
    assert plan.grid == -(-T // 4096) and plan.cap == 256
    assert all(0 < x <= c_int for x in (plan.cap, plan.smem_bytes,
                                        plan.route_grid))
    assert plan.smem_bytes <= 227 * 1024
    # 12 B x 256 slots and a cursor a chunk, 24 B a payload entry
    assert plan.scratch_bytes <= 3076 * plan.grid + 24 * n + 4096
    for t50 in (27_068_416, 370_688):
        assert not tk.apply_plan(102_332, t50).index64
    assert not tk.apply_plan(102_332, 2 ** 31 - 128).index64
    assert tk.apply_plan(10, 2 ** 31).index64
    with pytest.raises(ValueError, match="payload entries"):
        tk.apply_plan(2 ** 31, T)
    # the Triton compensate's program offsets
    assert tk.index64(-(-T // 4096) * 4096 - 1)
    assert not tk.index64(-(-27_068_416 // 4096) * 4096 - 1)
    # the 3-D fallback's candidates: one row per (segment row, lane)
    w0 = eng.buckets[0]
    R, nb = w0.rows * 128, w0.cols // 128
    kp = -(-2 * w0.max_sel // 128)
    assert R * nb >= 2 ** 31 and kp <= tk.TOPK_MAX_K
    tp = tk.topk_plan(R, nb, kp)
    assert tp.grid <= c_int and R <= c_int and nb <= c_int
    assert tp.smem_bytes <= 227 * 1024
    # the segment buckets past 2**31: the candidates' gate and launch
    for b, seg in zip(eng.buckets[1:], eng._seg[1:]):
        assert b.base >= 2 ** 31
        if seg:
            assert tk.seg_top2_eligible(T // 128, b.base, b.cols, b.rows)
            assert b.rows * (b.cols // tk.SEG_SPAN) <= c_int
    assert T // tk.SEG_SPAN <= c_int


@pytest.mark.parametrize("route,flags", [
    ("megakernel", {"megakernel": True}),
    ("fused select", {"fused_select": True}),
    ("one-level ladder", {"resample": False})])
def test_off_path_routes_refuse_large_layouts(route, flags):
    """At 2**31 slots or more the routes whose kernels have no 64-bit
    form refuse the layout when the engine is built, naming ROADMAP
    queue 1 item 14; the same flags build below 2**31 (f32 state: the
    bf16 state keeps the megakernel off, as in the reference)."""
    shapes = _resnet50_shapes()
    conv = [n for n, s in shapes.items() if len(s) > 1]
    with pytest.raises(ValueError, match=f"{route}.*item 14"):
        _port_engine(dict(shapes, w=(HUGE,)), conv + ["w"], 0.001,
                     epoch=5, mem_dtype=None, **flags)
    _port_engine(shapes, conv, 0.001, epoch=5, mem_dtype=None, **flags)


def test_per_tensor_compensate_refuses_2_31_elements():
    """The multi-tensor compensate (the per-tensor path) refuses a tensor
    whose offsets pass 2**31, naming item 14 (meta tensors: nothing
    allocated)."""
    g = torch.empty(2 ** 31, device="meta")
    with pytest.raises(ValueError, match="item 14"):
        tk.fused_compensate_multi([g], [g.clone()], [g.clone()], 0.9)
    ok = torch.zeros(4096)
    tk.fused_compensate_multi([ok], [ok.clone()], [ok.clone()], 0.9)


@pytest.mark.parametrize("mem_dtype", [None, "bfloat16"])
def test_engine_wide_path_matches_ordinary_path(monkeypatch, mem_dtype):
    """The engine's 64-bit path at a small size, the 32-bit limit lowered
    below its layout: the layout and the wire are int64, the apply takes
    int64 indices, and two W=2 exchanges (outputs and memories) are
    bitwise the ordinary int32 path's."""
    shapes = {"conv1": (32, 16, 3, 3), "conv2": (64, 32, 3, 3),
              "fc": (10, 1024), "bias": (10,)}
    compressed = ["conv1", "conv2", "fc"]

    def run(wide):
        if wide:
            monkeypatch.setattr(tk, "INDEX32_LIMIT", 4096)
        comp = DGCCompressor(0.01, memory=DGCSGDMemory(0.9, dtype=mem_dtype),
                             sample_ratio=0.5)
        comp.initialize((n, shapes[n]) for n in compressed)
        layout = ParamLayout(shapes, compressed)
        eng = FlatDGCEngine(comp, layout)
        seen = []
        real = tk.apply_rows

        def spy(values, indices, *a, **k):
            seen.append(indices.dtype)
            return real(values, indices, *a, **k)
        monkeypatch.setattr(tk, "apply_rows", spy)
        comm = LocalComm(2)
        mems = [eng.init_memory("cpu") for _ in range(2)]
        gen = torch.Generator().manual_seed(5)
        outs = []
        for _ in range(2):
            grads = [torch.randn(layout.total, generator=gen)
                     for _ in range(2)]
            phases = [eng.draw_phases(gen) for _ in range(2)]
            outs.append(eng.exchange(grads, mems, phases, comm))
        monkeypatch.undo()
        return layout, eng, seen, outs, mems

    lay64, eng64, seen64, outs64, mems64 = run(True)
    lay32, eng32, seen32, outs32, mems32 = run(False)
    assert lay64.index_dtype == eng64.index_dtype == torch.int64
    assert lay32.index_dtype == eng32.index_dtype == torch.int32
    assert set(seen64) == {torch.int64} and set(seen32) == {torch.int32}
    for o64, o32 in zip(outs64, outs32):
        for a, b in zip(o64, o32):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    for m64, m32 in zip(mems64, mems32):
        for k in m32:
            assert torch.equal(m64[k], m32[k]), k
