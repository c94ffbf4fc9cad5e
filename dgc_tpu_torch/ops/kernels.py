"""The hot-path kernels of the flat DGC engine, and the transmit-record
format they share.

Counterpart of ``dgc_tpu/ops/kernels.py``. Three kernels are written by
hand for Hopper, each with a plain PyTorch version of the same function in
this module and a launch counter (:data:`LAUNCHES`):

=====================  =========  ==========================================
wrapper                route      replaces (dgc_tpu/ops/kernels.py)
=====================  =========  ==========================================
:func:`compensate_bits`  Triton   ``fused_compensate_bits`` (:527)
:func:`topk_rows`      CUDA C++   ``topk_rows`` (:739)
:func:`apply_rows`     CUDA C++   ``payload_apply_bits`` (:1643) /
                                  ``dgc_apply_rows`` (:1743)
=====================  =========  ==========================================

A wrapper runs the plain version only for tensors that lie on the CPU; for
a CUDA tensor it launches its kernel or raises. It checks device, dtype,
shape and contiguity first. The CUDA C++ sources are in
``dgc_tpu_torch/csrc`` (built by :mod:`dgc_tpu_torch.ops.build`); the
Triton kernel is defined and compiled on its first launch. Kernels launch
on PyTorch's current stream and never synchronise.

The transmit-record helpers (:func:`num_sent_words`, :func:`pack_sent_bits`,
:func:`keep_from_bits`) define a format shared with the JAX package and are
bitwise its functions.
"""

import ctypes
from typing import Optional, Tuple

import torch

from dgc_tpu_torch.ops import build as _build

__all__ = ["LAUNCHES", "reset_launches", "num_sent_words", "pack_sent_bits",
           "keep_from_bits", "compensate_bits", "compensate_bits_plain",
           "topk_rows", "topk_rows_plain", "TOPK_MAX_K", "apply_rows",
           "apply_rows_plain", "stage_payload"]

_LANE = 128
#: flat elements covered by one 128-word row of the transmit record
_BITS_GROUP = 32 * _LANE
#: largest k the top-k kernel's shared-memory sort takes (128 KB of words)
TOPK_MAX_K = 16384

#: launches of each kernel since the last :func:`reset_launches`; a wrapper
#: adds one where it launches its kernel and nowhere else
LAUNCHES = {"compensate_bits": 0, "topk_rows": 0, "apply_rows": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _on_card(name: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises on a mix or on
    any other device."""
    devs = {t.device for t in tensors}
    _check(len(devs) == 1, f"{name}: tensors on several devices {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    _check(dev.type == "cuda", f"{name}: unsupported device {dev}")
    _check(all(t.is_contiguous() for t in tensors),
           f"{name}: CUDA operands must be contiguous")
    return True


def _stream_args(t: torch.Tensor) -> Tuple[int, int]:
    dev = t.device.index if t.device.index is not None else \
        torch.cuda.current_device()
    return dev, torch.cuda.current_stream(t.device).cuda_stream


# ------------------------------------------------------------------ #
# bit-packed transmit record                                         #
# ------------------------------------------------------------------ #

def num_sent_words(total: int) -> int:
    """Words of the packed transmit record for a [total] buffer:
    ceil(total / 4096) * 128 (total lane-aligned)."""
    _check(total % _LANE == 0, f"total {total} is not a multiple of 128")
    return -(-total // _BITS_GROUP) * _LANE


def pack_sent_bits(indices: torch.Tensor, total: int,
                   sentinel: Optional[int] = None) -> torch.Tensor:
    """Transmit indices -> packed one-bit-per-coordinate record (int32).

    Flat position p maps to word ``(p >> 12) * 128 + (p & 127)``, bit
    ``(p >> 7) & 31``. ``sentinel`` entries are dropped. Bits are ADDED,
    as in the reference (``jnp.zeros(W).at[w].add(1 << bit)``), so real
    indices must be unique."""
    W = num_sent_words(total)
    idx = indices.to(torch.int32)
    w = (idx >> 12) * 128 + (idx & 127)
    bit = (idx >> 7) & 31
    if sentinel is not None:
        w = torch.where(idx == sentinel, W, w)    # a dropped extra word
    one = torch.ones_like(bit)
    out = torch.zeros(W + 1, dtype=torch.int32, device=indices.device)
    out.index_add_(0, w.long(), torch.bitwise_left_shift(one, bit))
    return out[:W]


def keep_from_bits(bits: torch.Tensor, total: int) -> torch.Tensor:
    """Packed transmit record -> multiplicative keep mask [total] f32
    (1.0 = not transmitted)."""
    _check(bits.shape == (num_sent_words(total),),
           f"bits {tuple(bits.shape)} do not cover {total} elements")
    b3 = bits.view(-1, 1, _LANE)
    m = torch.arange(32, dtype=torch.int32, device=bits.device).view(1, 32, 1)
    keep = ((b3 >> m) & 1) == 0
    return keep.reshape(-1)[:total].to(torch.float32)


# ------------------------------------------------------------------ #
# K1: bit-masked momentum compensate (Triton)                        #
# ------------------------------------------------------------------ #
#
# Replaces dgc_tpu/ops/kernels.py::fused_compensate_bits (body
# _bits_compensate_core / _compensate_math). One fused elementwise pass:
# reads g, m, v and one int32 word per (32-row x 128-lane) group, writes
# m and v in place. Bound on the card: bytes, 20 B per element plus T/8
# of record (7.5 MB at ResNet-20's T = 370,688, ~2.2 us at 3.35 TB/s) —
# so at this size the launch, not HBM, dominates. One program covers one
# 4096-element word group; the ragged tail (T % 4096 may be 2048) is
# masked. Multiplying by the keep mask, not a select, keeps signed zeros
# and NaNs as the reference has them; the launch disables FMA contraction
# so `momentum * m0 + g` rounds twice, as the plain version does.

# triton.language, bound at the first build: a module global, because
# Triton resolves the names a kernel uses in the kernel's globals
tl = None
_TRITON = {}


def _compensate_triton():
    global tl
    kernel = _TRITON.get("compensate_bits")
    if kernel is not None:
        return kernel
    import triton
    import triton.language as _tl
    tl = _tl

    @triton.jit
    def compensate_bits_kernel(g_ptr, m_ptr, v_ptr, b_ptr, n, momentum,
                               NESTEROV: tl.constexpr,
                               MASK_MOMENTUM: tl.constexpr,
                               BLOCK: tl.constexpr):
        p = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        inb = p < n
        g = tl.load(g_ptr + p, mask=inb, other=0.0)
        m0 = tl.load(m_ptr + p, mask=inb, other=0.0)
        v0 = tl.load(v_ptr + p, mask=inb, other=0.0)
        word = tl.load(b_ptr + ((p >> 12) * 128 + (p & 127)), mask=inb,
                       other=0)
        keep = (((word >> ((p >> 7) & 31)) & 1) == 0).to(tl.float32)
        if MASK_MOMENTUM:
            m0 = m0 * keep
        v0 = v0 * keep
        if NESTEROV:
            m = (m0 + g) * momentum
            ov = v0 + m + g
        else:
            m = momentum * m0 + g
            ov = v0 + m
        tl.store(m_ptr + p, m, mask=inb)
        tl.store(v_ptr + p, ov, mask=inb)

    _TRITON["compensate_bits"] = compensate_bits_kernel
    return compensate_bits_kernel


def compensate_bits_plain(grad, mmt, vec, bits, momentum: float,
                          nesterov: bool = False,
                          momentum_masking: bool = True):
    """Plain version: unpack the record to a keep mask, mask on read, then
    momentum correction (``dgc_tpu`` ``_compensate_math`` op order).
    Returns new ``(mmt', vec')``."""
    keep = keep_from_bits(bits, grad.shape[0])
    m0 = mmt * keep if momentum_masking else mmt
    v0 = vec * keep
    if nesterov:
        m = (m0 + grad) * momentum
        return m, v0 + m + grad
    m = momentum * m0 + grad
    return m, v0 + m


def compensate_bits(grad, mmt, vec, bits, momentum: float,
                    nesterov: bool = False, momentum_masking: bool = True):
    """Bit-masked momentum compensate, updating ``mmt`` and ``vec`` IN
    PLACE (they have no other reader afterwards); returns them. All of
    grad/mmt/vec are f32 [T]; ``bits`` is the previous step's record."""
    n = grad.shape[0]
    _check(grad.dim() == 1 and mmt.shape == (n,) and vec.shape == (n,),
           "compensate_bits: grad, mmt, vec must be 1-D of one length")
    _check(all(t.dtype == torch.float32 for t in (grad, mmt, vec)),
           "compensate_bits: grad, mmt, vec must be float32")
    _check(bits.dtype == torch.int32 and bits.shape == (num_sent_words(n),),
           "compensate_bits: bits must be int32 [num_sent_words(T)]")
    if not _on_card("compensate_bits", grad, mmt, vec, bits):
        m, v = compensate_bits_plain(grad, mmt, vec, bits, momentum,
                                     nesterov, momentum_masking)
        mmt.copy_(m)
        vec.copy_(v)
        return mmt, vec
    if n:
        kernel = _compensate_triton()
        grid = (-(-n // _BITS_GROUP),)
        kernel[grid](grad, mmt, vec, bits, n, float(momentum),
                     NESTEROV=bool(nesterov),
                     MASK_MOMENTUM=bool(momentum_masking),
                     BLOCK=_BITS_GROUP, num_warps=8,
                     enable_fp_fusion=False)
        LAUNCHES["compensate_bits"] += 1
    return mmt, vec


# ------------------------------------------------------------------ #
# K2: exact per-row top-k (CUDA C++, csrc/topk_rows.cu)              #
# ------------------------------------------------------------------ #

def topk_rows_plain(x: torch.Tensor, k: int):
    """Plain version: a stable descending sort, so ties keep column order
    (``lax.top_k`` order). Returns ``(values [R, k], columns [R, k] int32)``."""
    v, i = torch.sort(x, dim=1, descending=True, stable=True)
    return v[:, :k].contiguous(), i[:, :k].to(torch.int32)


_TOPK_ARGS = {"topk_rows_launch": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]}


def topk_rows(x: torch.Tensor, k: int):
    """Per-row ``(values, int32 columns)`` of the k largest elements of a
    [R, cols] f32 tensor: values descending, ties to the smaller column,
    exactly ``jax.lax.top_k`` for NaN-free input."""
    _check(x.dim() == 2 and x.dtype == torch.float32,
           "topk_rows: x must be a 2-D float32 tensor")
    R, cols = x.shape
    _check(0 <= k <= cols, f"topk_rows: k={k} outside [0, {cols}]")
    if not _on_card("topk_rows", x):
        return topk_rows_plain(x, k)
    _check(k <= TOPK_MAX_K,
           f"topk_rows: k={k} exceeds the kernel's shared-memory sort "
           f"(k <= {TOPK_MAX_K})")
    vals = torch.empty((R, k), dtype=torch.float32, device=x.device)
    cols_out = torch.empty((R, k), dtype=torch.int32, device=x.device)
    if R and k:
        lib = _build.library("topk_rows.cu", _TOPK_ARGS)
        err = lib.topk_rows_launch(x.data_ptr(), vals.data_ptr(),
                                   cols_out.data_ptr(), R, cols, k,
                                   *_stream_args(x))
        if err:
            raise RuntimeError(f"topk_rows launch failed: CUDA error {err}")
        LAUNCHES["topk_rows"] += 1
    return vals, cols_out


# ------------------------------------------------------------------ #
# K3: post-gather apply (CUDA C++, csrc/apply_rows.cu)               #
# ------------------------------------------------------------------ #

def _in_range(indices: torch.Tensor, total: int) -> torch.Tensor:
    return (indices >= 0) & (indices < total)


def stage_payload(values: torch.Tensor, indices: torch.Tensor, total: int):
    """The apply's staging (``_stage_payload``'s role): stable sort of the
    payload by index, with zero-valued and out-of-range entries keyed
    ``total`` so they form one trailing run that is never summed (adding 0
    to a sum that starts at +0.0 changes nothing). Returns ``(sorted keys
    int32, sorted values)``."""
    key = torch.where((values != 0) & _in_range(indices, total), indices,
                      total)
    skey, order = torch.sort(key, stable=True)
    return skey, values[order]


def apply_rows_plain(values, indices, flags, total: int,
                     divisor: Optional[float] = None):
    """Plain version of :func:`apply_rows`. Sums each index's entries in
    payload order from +0.0 — one round per duplicate rank, each round a
    scatter with unique indices — so it is deterministic on any device."""
    v = values / divisor if divisor is not None else values
    skey, sval = stage_payload(v, indices, total)
    n = skey.shape[0]
    pos = torch.arange(n, device=skey.device)
    start = torch.ones(n, dtype=torch.bool, device=skey.device)
    start[1:] = skey[1:] != skey[:-1]
    rank = pos - torch.cummax(torch.where(start, pos, 0), 0).values
    rank = torch.where(skey < total, rank, -1)
    acc = torch.zeros(total, dtype=values.dtype, device=values.device)
    for r in range(int(rank.max()) + 1 if n else 0):
        sel = rank == r
        acc.index_add_(0, skey[sel].long(), sval[sel])
    routed = torch.where(flags & _in_range(indices, total), indices, total)
    return acc, pack_sent_bits(routed, total, sentinel=total)


_APPLY_ARGS = {"apply_rows_launch": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]}


def apply_rows(values, indices, flags, total: int,
               divisor: Optional[float] = None):
    """Decompress + transmit record in one pass over the gathered payload
    (``dgc_apply_rows`` semantics; ``divisor=None`` is
    ``payload_apply_bits``): ``acc[idx] += v / divisor`` for every entry,
    and the packed bit set for every entry whose ``flag`` is true (the local
    worker's non-sentinel slots). Entries whose index lies outside
    ``[0, total)`` are dropped (the engine routes them to its sentinel
    first). Returns ``(acc [total] f32, bits [num_sent_words(total)]
    int32)``."""
    n = values.shape[0]
    _check(values.dim() == 1 and indices.shape == (n,) and flags.shape == (n,),
           "apply_rows: values, indices, flags must be 1-D of one length")
    _check(values.dtype == torch.float32 and indices.dtype == torch.int32
           and flags.dtype == torch.bool,
           "apply_rows: values f32, indices int32, flags bool")
    nw = num_sent_words(total)
    if not _on_card("apply_rows", values, indices, flags):
        return apply_rows_plain(values, indices, flags, total, divisor)
    skey, sval = stage_payload(values, indices, total)
    acc = torch.zeros(total, dtype=torch.float32, device=values.device)
    bits = torch.zeros(nw, dtype=torch.int32, device=values.device)
    if n:
        lib = _build.library("apply_rows.cu", _APPLY_ARGS)
        err = lib.apply_rows_launch(
            indices.data_ptr(), flags.data_ptr(), skey.data_ptr(),
            sval.data_ptr(), n, acc.data_ptr(), bits.data_ptr(), total,
            int(divisor is not None),
            float(divisor) if divisor is not None else 1.0,
            *_stream_args(values))
        if err:
            raise RuntimeError(f"apply_rows launch failed: CUDA error {err}")
        LAUNCHES["apply_rows"] += 1
    return acc, bits
