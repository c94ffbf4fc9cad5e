"""The hot-path kernels of the flat DGC engine, and the transmit-record
format they share.

Counterpart of ``dgc_tpu/ops/kernels.py``. Twelve kernels are written by
hand for Hopper, each with a plain PyTorch version of the same function in
this module and a launch counter (:data:`LAUNCHES`):

==============================  ========  =================================
wrapper                         route     replaces (dgc_tpu/ops/kernels.py)
==============================  ========  =================================
:func:`fused_compensate`        CUDA C++  ``fused_compensate`` (:171)
:func:`fused_compensate_masked` CUDA C++  ``fused_compensate_masked``
                                          (:275)
:func:`compensate_bits`         Triton    ``fused_compensate_bits`` (:527)
:func:`ladder_counts`           CUDA C++  ``ladder_counts`` (:652)
:func:`topk_rows`               CUDA C++  ``topk_rows`` (:739)
:func:`select_pack_rows`        CUDA C++  ``select_pack_rows`` (:853) and
                                          ``_select_pack_rows_mr`` (:1001)
:func:`seg_top2_candidates`     CUDA C++  ``seg_top2_candidates`` (:1130)
:func:`compensate_bits_cands`   CUDA C++  ``fused_compensate_bits_cands``
                                          (:1265)
:func:`dgc_forward_rows`        CUDA C++  ``dgc_forward_rows`` (:1427)
:func:`apply_rows`              CUDA C++  ``payload_apply_bits`` (:1643) /
                                          ``dgc_apply_rows`` (:1743)
:func:`opaque_view`             CUDA C++  ``opaque_view`` (:1799)
:func:`opaque_view_from`        CUDA C++  ``opaque_view_from`` (:1856)
==============================  ========  =================================

A wrapper runs the plain version only for tensors that lie on the CPU; for
a CUDA tensor it launches its kernel or raises. It checks device, dtype,
shape and contiguity first. The bf16 error-feedback state reaches the
compensates (:func:`compensate_bits`, :func:`compensate_bits_cands` and
the per-tensor ones) and :func:`seg_top2_candidates` as bf16, loaded and
up-cast in the kernel, the math in f32, one round-to-nearest-even per
stored value; :func:`topk_rows` and :func:`select_pack_rows` up-cast a
bf16 input once to f32 before their kernel and cast the values back (the
reference's wrappers do the same); :func:`dgc_forward_rows` refuses it.
The CUDA C++ sources are in ``dgc_tpu_torch/csrc`` (built by
:mod:`dgc_tpu_torch.ops.build`); the one Triton kernel is defined and
compiled on its first launch. Kernels launch on PyTorch's current stream
and never synchronise. The two compensates are one-entry calls of
:func:`fused_compensate_multi`, which compensates many tensors in one
launch.

The transmit-record helpers (:func:`num_sent_words`, :func:`pack_sent_bits`,
:func:`keep_from_bits`, :func:`realign_bits`) define a format shared with
the JAX package and are bitwise its functions.

As in the reference, :func:`pack_sent_bits`, :func:`topk_rows`,
:func:`select_pack_rows` and :func:`apply_rows` are phase-marked
(``@phased("pack" / "select" / "apply")``, :mod:`dgc_tpu_torch.telemetry.
trace`): with the markers on, their launches land in that phase of a
profile wherever they are called from.
"""

import ctypes
import functools
import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dgc_tpu_torch.ops import build as _build
from dgc_tpu_torch.telemetry import trace as _trace

__all__ = ["LAUNCHES", "reset_launches", "num_sent_words", "pack_sent_bits",
           "keep_from_bits", "realign_bits", "keep_from_sent",
           "fused_compensate", "fused_compensate_plain",
           "fused_compensate_masked", "fused_compensate_masked_plain",
           "fused_compensate_multi", "fused_compensate_multi_plain",
           "compensate_plan", "compensate_head", "CompensateLaunch",
           "COMPENSATE_MAX_ENTRIES", "COMPENSATE_TILE",
           "ladder_counts", "ladder_counts_plain", "ladder_factors",
           "ladder_plan", "LadderPlan", "LADDER_MAX_LEVELS",
           "compensate_bits",
           "compensate_bits_plain", "topk_rows", "topk_rows_plain",
           "TOPK_MAX_K", "topk_plan", "topk_geometry", "TopkPlan",
           "TOPK_ROUTES", "divide_exact", "select_pack_rows",
           "select_pack_rows_plain",
           "MR_MAX_K", "dgc_forward_rows", "dgc_forward_rows_plain",
           "apply_rows",
           "apply_rows_plain", "apply_plan", "ApplyPlan", "APPLY_CHUNK",
           "SEG_BLOCKS", "SEG_SPAN",
           "seg_top2_eligible", "seg_cols_local", "seg_top2_candidates",
           "seg_top2_candidates_plain", "compensate_bits_cands",
           "compensate_bits_cands_plain", "opaque_view", "opaque_view_from",
           "opaque_view_eligible", "vtag"]

_LANE = 128
#: f32 sublanes of the reference's (8, 128) tile (opaque-view alignment)
_SUBLANE = 8
#: flat elements covered by one 128-word row of the transmit record
_BITS_GROUP = 32 * _LANE
#: largest k the top-k kernel's shared-memory sort buffer takes (136 KB
#: of words with their pads)
TOPK_MAX_K = 16384
#: largest k of the select-and-pack kernels (the reference's multi-round
#: bound, ``_MR_MAX_K``)
MR_MAX_K = 8 * _LANE
#: 128-lane blocks per candidate segment, and the elements it spans
SEG_BLOCKS = 256
SEG_SPAN = SEG_BLOCKS * _LANE

#: launches of each kernel since the last :func:`reset_launches`; a wrapper
#: adds one where it launches its kernel and nowhere else
LAUNCHES = {"fused_compensate": 0, "fused_compensate_masked": 0,
            "ladder_counts": 0, "compensate_bits": 0, "topk_rows": 0,
            "apply_rows": 0,
            "compensate_bits_cands": 0, "seg_top2_candidates": 0,
            "opaque_view": 0, "opaque_view_from": 0, "select_pack_rows": 0,
            "dgc_forward_rows": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


#: the verifier's active recorder (``analysis.program.Recorder``), or None
VTAG_RECORDER = None


def vtag(x, name: str):
    """Dataflow anchor for the verifier (``analysis/verify.py``): returns
    ``x`` (a tensor, or a dict / list / tuple of them) unchanged and
    reports it under ``name`` to the active recorder. With no recorder it
    does nothing: no op, no launch, no sync."""
    rec = VTAG_RECORDER
    if rec is not None:
        rec.tag(x, name)
    return x


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


@_trace.phased("pack")
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


def realign_bits(bits: torch.Tensor, base: int, n: int) -> torch.Tensor:
    """Window the packed transmit record onto the region ``[base, base+n)``
    (both lane-aligned): ``num_sent_words(n)`` words whose
    ``keep_from_bits(out, n)`` is ``keep_from_bits(bits, total)[base:base +
    n]``, words past the record reading 0. A region whose start row ``S =
    base // 128`` is not a multiple of 32 takes a funnel shift across
    adjacent word groups: ``out[j] = (w[q+j] >>> sh) | (w[q+j+1] << (32 -
    sh))``, ``q, sh = divmod(S, 32)``, in uint32 (computed here in int64)."""
    _check(base % _LANE == 0 and n % _LANE == 0,
           f"realign_bits: base {base} and n {n} must be lane-aligned")
    wr = num_sent_words(n) // _LANE          # word groups of the window
    q, sh = divmod(base // _LANE, 32)
    w2 = bits.view(-1, _LANE)
    need = q + wr + 1 - w2.shape[0]          # one zero guard group
    if need > 0:
        w2 = torch.cat([w2, w2.new_zeros((need, _LANE))])
    if sh == 0:
        return w2[q:q + wr].reshape(-1)
    u = w2.to(torch.int64) & 0xFFFFFFFF
    out = (u[q:q + wr] >> sh) | ((u[q + 1:q + wr + 1] << (32 - sh))
                                 & 0xFFFFFFFF)
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(
        torch.int32).reshape(-1)


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
# so `momentum * m0 + g` rounds twice, as the plain version does. A bf16
# state (12 B per element plus the record) is up-cast as it is loaded and
# rounded to nearest even as it is stored (STATE_BF16). The CUDA
# kernels that compensate (K10/K11, and K5, K9 on the fly) repeat its
# arithmetic (_momentum_correct) op by op in csrc/compensate.cuh.

# triton.language and the @triton.jit helper, bound at the first build:
# module globals, because Triton resolves the names a kernel uses in the
# kernel's globals
tl = None
_momentum_correct = None
_TRITON = {}


def _triton_kernels():
    """Define the Triton kernels (on first use; the CPU has no Triton).
    Returns ``{name: kernel}``."""
    global tl, _momentum_correct
    if _TRITON:
        return _TRITON
    import triton
    import triton.language as _tl
    tl = _tl

    @triton.jit
    def _momentum_correct(g, m0, v0, momentum, NESTEROV: tl.constexpr):
        # the momentum correction in f32 on masked state: returns (m',
        # v'); the launch disables FMA contraction, so each product and sum
        # rounds on its own
        if NESTEROV:
            m = (m0 + g) * momentum
            ov = v0 + m + g
        else:
            m = momentum * m0 + g
            ov = v0 + m
        return m, ov

    @triton.jit
    def compensate_bits_kernel(g_ptr, m_ptr, v_ptr, b_ptr, n, momentum,
                               NESTEROV: tl.constexpr,
                               MASK_MOMENTUM: tl.constexpr,
                               STATE_BF16: tl.constexpr,
                               BLOCK: tl.constexpr):
        p = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        inb = p < n
        g = tl.load(g_ptr + p, mask=inb, other=0.0)
        m0 = tl.load(m_ptr + p, mask=inb, other=0.0).to(tl.float32)
        v0 = tl.load(v_ptr + p, mask=inb, other=0.0).to(tl.float32)
        word = tl.load(b_ptr + ((p >> 12) * 128 + (p & 127)), mask=inb,
                       other=0)
        keep = (((word >> ((p >> 7) & 31)) & 1) == 0).to(tl.float32)
        if MASK_MOMENTUM:
            m0 = m0 * keep
        v0 = v0 * keep
        m, ov = _momentum_correct(g, m0, v0, momentum, NESTEROV)
        if STATE_BF16:
            m = m.to(tl.bfloat16, fp_downcast_rounding="rtne")
            ov = ov.to(tl.bfloat16, fp_downcast_rounding="rtne")
        tl.store(m_ptr + p, m, mask=inb)
        tl.store(v_ptr + p, ov, mask=inb)

    _TRITON.update(compensate_bits=compensate_bits_kernel)
    return _TRITON


def compensate_bits_plain(grad, mmt, vec, bits, momentum: float,
                          nesterov: bool = False,
                          momentum_masking: bool = True):
    """Plain version: unpack the record to a keep mask, mask on read, then
    momentum correction (``dgc_tpu`` ``_compensate_math`` op order), the
    state up-cast to the gradient's dtype and the results rounded once to
    the state's. Returns new ``(mmt', vec')``."""
    sdt = mmt.dtype
    keep = keep_from_bits(bits, grad.shape[0]).to(grad.dtype)
    m0 = mmt.to(grad.dtype)
    if momentum_masking:
        m0 = m0 * keep
    v0 = vec.to(grad.dtype) * keep
    if nesterov:
        m = (m0 + grad) * momentum
        v = v0 + m + grad
    else:
        m = momentum * m0 + grad
        v = v0 + m
    return m.to(sdt), v.to(sdt)


def _check_compensate(name, grad, mmt, vec, bits) -> None:
    n = grad.shape[0]
    _check(grad.dim() == 1 and mmt.shape == (n,) and vec.shape == (n,),
           f"{name}: grad, mmt, vec must be 1-D of one length")
    _check(grad.dtype == torch.float32 and mmt.dtype == vec.dtype
           and mmt.dtype in (torch.float32, torch.bfloat16),
           f"{name}: grad must be float32, mmt and vec both float32 or both "
           f"bfloat16, got {grad.dtype}/{mmt.dtype}/{vec.dtype}")
    _check(bits.dtype == torch.int32 and bits.shape == (num_sent_words(n),),
           f"{name}: bits must be int32 [num_sent_words(T)]")


def compensate_bits(grad, mmt, vec, bits, momentum: float,
                    nesterov: bool = False, momentum_masking: bool = True):
    """Bit-masked momentum compensate, updating ``mmt`` and ``vec`` IN
    PLACE (they have no other reader afterwards); returns them. grad is f32
    [T], mmt/vec f32 or bf16 [T] (math in f32, one rounding to nearest even
    per stored value); ``bits`` is the previous step's record."""
    n = grad.shape[0]
    _check_compensate("compensate_bits", grad, mmt, vec, bits)
    if not _on_card("compensate_bits", grad, mmt, vec, bits):
        m, v = compensate_bits_plain(grad, mmt, vec, bits, momentum,
                                     nesterov, momentum_masking)
        mmt.copy_(m)
        vec.copy_(v)
        return mmt, vec
    if n:
        kernel = _triton_kernels()["compensate_bits"]
        grid = (-(-n // _BITS_GROUP),)
        kernel[grid](grad, mmt, vec, bits, n, float(momentum),
                     NESTEROV=bool(nesterov),
                     MASK_MOMENTUM=bool(momentum_masking),
                     STATE_BF16=mmt.dtype == torch.bfloat16,
                     BLOCK=_BITS_GROUP, num_warps=8,
                     enable_fp_fusion=False)
        LAUNCHES["compensate_bits"] += 1
    return mmt, vec


# ------------------------------------------------------------------ #
# K10, K11: record-less and count-masked compensate, many tensors a   #
#           launch (CUDA C++, csrc/compensate.cu)                     #
# ------------------------------------------------------------------ #
#
# Replace dgc_tpu/ops/kernels.py::fused_compensate (_compensate_kernel),
# the per-tensor memory's accumulating compensate, and
# ::fused_compensate_masked (_compensate_masked_kernel), the same with the
# previous step's transmit COUNT vector applied on read. One CUDA kernel
# takes a table of up to COMPENSATE_MAX_ENTRIES tensors in its launch
# parameters (the per-tensor exchange compensates every compressed tensor
# of every local worker in one launch); :func:`compensate_plan` gives each
# entry whole blocks of 4,096 elements and the scalar head before its
# vector body. State is f32 or bf16 (the bf16 error-feedback memory):
# loaded in its dtype, up-cast, the math in f32 (compensate_bits'
# arithmetic, op by op, csrc/compensate.cuh), one round-to-nearest-even per
# stored value. Bound on the card: bytes, 20 B per element with f32 state,
# 12 with bf16, plus 4 for the count vector of the masked form.

#: most tensors one compensate launch takes (its table stays under the
#: classic 4 KB of kernel parameters)
COMPENSATE_MAX_ENTRIES = 96
#: elements of one tensor a block of the compensate kernel covers
COMPENSATE_TILE = 4096


def keep_from_sent(sent: torch.Tensor) -> torch.Tensor:
    """Transmit count -> multiplicative keep mask in the count's dtype:
    1.0 where the coordinate was not transmitted (count 0), else 0.0."""
    return (sent == 0).to(sent.dtype)


def fused_compensate_plain(grad, mmt, vec, momentum: float,
                           nesterov: bool = False):
    """Plain version of :func:`fused_compensate` (``fused_compensate_
    reference``'s op order): the state up-cast to the gradient's dtype,
    the momentum correction, one rounding to the state's dtype. Returns
    new ``(mmt', vec')``."""
    sdt = mmt.dtype
    m0, v0 = mmt.to(grad.dtype), vec.to(grad.dtype)
    if nesterov:
        m = (m0 + grad) * momentum
        v = v0 + m + grad
    else:
        m = momentum * m0 + grad
        v = v0 + m
    return m.to(sdt), v.to(sdt)


def fused_compensate_masked_plain(grad, mmt, vec, sent, momentum: float,
                                  nesterov: bool = False,
                                  momentum_masking: bool = True):
    """Plain version of :func:`fused_compensate_masked`: the keep mask
    ``sent == 0`` in the gradient's dtype, multiplied into the up-cast
    state (the momentum only under ``momentum_masking``), then
    :func:`fused_compensate_plain`. Returns new ``(mmt', vec')``."""
    kf = keep_from_sent(sent).to(grad.dtype)
    m0 = mmt.to(grad.dtype)
    if momentum_masking:
        m0 = m0 * kf
    m, v = fused_compensate_plain(grad, m0, vec.to(grad.dtype) * kf,
                                  momentum, nesterov)
    return m.to(mmt.dtype), v.to(mmt.dtype)


def fused_compensate_multi_plain(grads, mmts, vecs, momentum: float,
                                 nesterov: bool = False, sents=None,
                                 momentum_masking: bool = True):
    """Plain version of :func:`fused_compensate_multi`: a loop of
    :func:`fused_compensate_plain` (or, with ``sents``,
    :func:`fused_compensate_masked_plain`). Returns the new ``(mmts',
    vecs')`` lists."""
    if sents is None:
        out = [fused_compensate_plain(g, m, v, momentum, nesterov)
               for g, m, v in zip(grads, mmts, vecs)]
    else:
        out = [fused_compensate_masked_plain(g, m, v, s, momentum, nesterov,
                                             momentum_masking)
               for g, m, v, s in zip(grads, mmts, vecs, sents)]
    return [m for m, _ in out], [v for _, v in out]


def _check_state(name, grad, mmt, vec, sent=None) -> None:
    n = grad.shape[0]
    _check(grad.dim() == 1 and mmt.shape == (n,) and vec.shape == (n,)
           and (sent is None or sent.shape == (n,)),
           f"{name}: grad, mmt, vec{', sent' if sent is not None else ''} "
           "must be 1-D of one length")
    _check(grad.dtype == torch.float32
           and (sent is None or sent.dtype == torch.float32),
           f"{name}: grad{' and sent' if sent is not None else ''} must be "
           "float32")
    _check(mmt.dtype == vec.dtype
           and mmt.dtype in (torch.float32, torch.bfloat16),
           f"{name}: mmt and vec must be both float32 or both bfloat16, got "
           f"{mmt.dtype}/{vec.dtype}")


def _check_no_alias(name, written, read) -> None:
    """Raises where a written tensor (an m or v) shares a byte with any
    other tensor of the call, written or read (a g or sent): the kernel
    updates m and v in place, entry by entry in no order."""
    spans = sorted((t.data_ptr(), t.data_ptr() + t.numel() * t.element_size(),
                    w) for ts, w in ((written, True), (read, False))
                   for t in ts if t.numel())
    w_end = a_end = 0
    for start, end, w in spans:
        _check(start >= w_end and not (w and start < a_end),
               f"{name}: an m or v shares memory with another tensor of the "
               "call")
        a_end = max(a_end, end)
        if w:
            w_end = max(w_end, end)


class CompensateLaunch(NamedTuple):
    """One launch of the compensate kernel (see ``csrc/compensate.cu``):
    ``entries`` indexes the caller's lists; entry ``entries[j]`` owns
    blocks ``[block0[j], block0[j + 1])`` (``block0[-1]`` blocks in all);
    ``head[j]`` is its scalar head, the elements before the vector body
    (each stream aligned there: 16 bytes for f32, 8 for bf16 state), or -1
    where no such start exists (the entry runs scalar). A block covers
    :data:`COMPENSATE_TILE` elements of its entry's body (``[head, head +
    4 * ((n - head) // 4))``, or ``[0, n)`` when scalar); block 0 of the
    entry also does the head and the tail past the body."""
    entries: Tuple[int, ...]
    block0: Tuple[int, ...]
    head: Tuple[int, ...]


def compensate_head(n: int, addrs, state_bytes: int) -> int:
    """The scalar head of one entry: the least ``h`` (0-3, at most ``n``)
    at which its f32 streams (g, and sent where given) are 16-byte and
    its state streams (m, v) ``4 * state_bytes``-byte aligned; -1 if none.
    ``addrs`` is ``(g, m, v, sent or None)``, byte addresses."""
    g, m, v, s = addrs
    h = (-g % 16) // 4
    ok = (g % 4 == 0 and (s is None or (s + 4 * h) % 16 == 0)
          and all((a + state_bytes * h) % (4 * state_bytes) == 0
                  for a in (m, v)))
    return min(h, n) if ok else -1


def _compensate_blocks(n: int, head: int) -> int:
    body = n if head < 0 else 4 * ((n - head) // 4)
    return max(1, -(-body // COMPENSATE_TILE))


def compensate_plan(ns, addrs, state_bytes: int = 4
                    ) -> Tuple[CompensateLaunch, ...]:
    """The compensate kernel's launches for entries of ``ns[i]`` elements
    at byte addresses ``addrs[i] = (g, m, v, sent or None)``, state of
    ``state_bytes`` (4 or 2) per element: the non-empty entries in order,
    :data:`COMPENSATE_MAX_ENTRIES` a launch, each with its whole blocks
    and its scalar head (:class:`CompensateLaunch`)."""
    live = [i for i, n in enumerate(ns) if n]
    out = []
    cap = COMPENSATE_MAX_ENTRIES
    for c in range(0, len(live), cap):
        entries = tuple(live[c:c + cap])
        head = tuple(compensate_head(ns[i], addrs[i], state_bytes)
                     for i in entries)
        block0 = [0]
        for i, h in zip(entries, head):
            block0.append(block0[-1] + _compensate_blocks(ns[i], h))
        out.append(CompensateLaunch(entries, tuple(block0), head))
    return tuple(out)


_COMPENSATE_ARGS = {"compensate_multi_launch": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p]}


def fused_compensate_multi(grads, mmts, vecs, momentum: float,
                           nesterov: bool = False, sents=None,
                           momentum_masking: bool = True):
    """Momentum correction and local accumulation of many tensors at once:
    for each i, :func:`fused_compensate` of ``(grads[i], mmts[i],
    vecs[i])``, or with ``sents`` :func:`fused_compensate_masked` with
    ``sents[i]``; ``mmts`` and ``vecs`` are updated IN PLACE and returned.
    On the card: one launch per :data:`COMPENSATE_MAX_ENTRIES` non-empty
    tensors (:func:`compensate_plan`). All states share one dtype (f32 or
    bf16); no m or v may share memory with another tensor of the call."""
    name = ("fused_compensate_masked" if sents is not None
            else "fused_compensate")
    k = len(grads)
    _check(len(mmts) == k and len(vecs) == k
           and (sents is None or len(sents) == k),
           f"{name}: grads, mmts, vecs{', sents' if sents else ''} must be "
           "lists of one length")
    sl = [None] * k if sents is None else list(sents)
    for g, m, v, s in zip(grads, mmts, vecs, sl):
        _check_state(name, g, m, v, s)
    _check(len({m.dtype for m in mmts}) <= 1,
           f"{name}: every state must share one dtype")
    _check_no_alias(name, [*mmts, *vecs],
                    [*grads, *(s for s in sl if s is not None)])
    if not k:
        return mmts, vecs
    if not _on_card(name, *grads, *mmts, *vecs,
                    *(s for s in sl if s is not None)):
        new_m, new_v = fused_compensate_multi_plain(
            grads, mmts, vecs, momentum, nesterov, sents, momentum_masking)
        for t, x in zip([*mmts, *vecs], [*new_m, *new_v]):
            t.copy_(x)
        return mmts, vecs
    ns = [g.shape[0] for g in grads]
    _check(max(ns) <= 2 ** 31 - 2 * COMPENSATE_TILE,
           f"{name}: a tensor of {max(ns)} elements is too long")
    addrs = [(g.data_ptr(), m.data_ptr(), v.data_ptr(),
              s.data_ptr() if s is not None else None)
             for g, m, v, s in zip(grads, mmts, vecs, sl)]
    bf16 = mmts[0].dtype == torch.bfloat16
    lib = _build.library("compensate.cu", _COMPENSATE_ARGS)
    for launch in compensate_plan(ns, addrs, 2 if bf16 else 4):
        ptrs = np.array([[a or 0 for a in addrs[i]] for i in launch.entries],
                        dtype=np.int64)
        n_arr = np.array([ns[i] for i in launch.entries], dtype=np.int32)
        block0 = np.array(launch.block0, dtype=np.int32)
        head = np.array(launch.head, dtype=np.int8)
        err = lib.compensate_multi_launch(
            ptrs.ctypes.data, n_arr.ctypes.data, block0.ctypes.data,
            head.ctypes.data, len(launch.entries), int(bf16),
            int(sents is not None), float(momentum), int(nesterov),
            int(momentum_masking), *_stream_args(grads[0]))
        if err:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        LAUNCHES[name] += 1
    return mmts, vecs


def fused_compensate(grad, mmt, vec, momentum: float,
                     nesterov: bool = False):
    """Momentum correction and local accumulation in one pass, updating
    ``mmt`` and ``vec`` IN PLACE (the TPU kernel aliases them to its
    outputs); returns them. ``grad`` is f32 [n]; ``mmt``, ``vec`` are f32
    or bf16 [n]. A one-entry :func:`fused_compensate_multi`."""
    fused_compensate_multi([grad], [mmt], [vec], momentum, nesterov)
    return mmt, vec


def fused_compensate_masked(grad, mmt, vec, sent, momentum: float,
                            nesterov: bool = False,
                            momentum_masking: bool = True):
    """:func:`fused_compensate` with the previous step's transmit count
    ``sent`` (f32 [n], 0 = keep) applied on read: ``keep = (sent == 0)``
    multiplies the up-cast velocity, and the momentum under
    ``momentum_masking``. Updates ``mmt`` and ``vec`` IN PLACE; returns
    them. A one-entry :func:`fused_compensate_multi`."""
    fused_compensate_multi([grad], [mmt], [vec], momentum, nesterov, [sent],
                           momentum_masking)
    return mmt, vec


# ------------------------------------------------------------------ #
# K12: threshold-ladder counts (CUDA C++, csrc/ladder_counts.cu)     #
# ------------------------------------------------------------------ #

#: most levels the ladder kernel takes (the reference's lane bound)
LADDER_MAX_LEVELS = _LANE
#: the most blocks of a ladder cluster (Hopper's non-portable limit; rows
#: narrower than LADDER_WIDE_COLS keep to the portable 8)
LADDER_MAX_CLUSTER = 16
#: rows of at least this many columns are bound by their counting: they
#: take 1,024-thread blocks (one an SM) and may split their levels
LADDER_WIDE_COLS = 262144
#: what reading an element costs a block next to counting it at one level
#: (about two instructions), fitted to split sweeps on an H100 (PERF.md)
LADDER_READ_COST = 3.5


@functools.lru_cache(maxsize=None)
def _ladder_factor_array(lower_bound: float, levels: int) -> np.ndarray:
    return np.array([float(lower_bound) ** i for i in range(levels)],
                    dtype=np.float32)


def ladder_factors(lower_bound: float, levels: int) -> torch.Tensor:
    """The ladder's level factors ``float32(lower_bound ** i)``, i <
    ``levels``: the Python double power rounded once, as the Pallas
    kernel and ``ladder_counts_reference`` form them (the engine's
    from-top-k ladder rounds ``float32(lower_bound)`` first and differs
    at some levels)."""
    return torch.from_numpy(_ladder_factor_array(lower_bound, levels).copy())


def ladder_counts_plain(imp_rows: torch.Tensor, thr: torch.Tensor,
                        lower_bound: float, levels: int) -> torch.Tensor:
    """Plain version of :func:`ladder_counts`: one compare and count per
    level. Returns [R, levels] int32."""
    f = ladder_factors(lower_bound, levels).to(imp_rows.device)
    cols = [(imp_rows >= f[i] * thr[:, None]).sum(dim=1, dtype=torch.int32)
            for i in range(levels)]
    return torch.stack(cols, dim=1)


class LadderPlan(NamedTuple):
    """Launch geometry of :func:`ladder_counts` (see
    ``csrc/ladder_counts.cu``): each row's levels in ``splits`` splits of
    ``ceil(L / splits)`` levels, each split counted over the whole row by
    ``cluster`` blocks (``route`` ``"row"``: one block; ``"cluster"``: a
    cluster, each block a contiguous share of the row's 16-byte quads) of
    ``threads``; ``grid`` the blocks."""
    route: str
    cluster: int
    splits: int
    threads: int
    grid: int


def ladder_plan(R: int, cols: int, levels: int,
                max_clusters: Callable[[int, int], int]) -> LadderPlan:
    """The ladder kernel's plan for [R, cols] and ``levels`` (0 < levels
    <= 128), given ``max_clusters(threads, cluster)``: the most clusters of
    ``cluster`` blocks of ``threads`` the card runs at once (the library's
    ``ladder_max_clusters``). Among the geometries whose R x splits
    clusters run in one wave, the least work a block, ``cols / cluster x
    (levels / splits + LADDER_READ_COST)`` (fewest blocks on a tie). A row
    of :data:`LADDER_WIDE_COLS` or more columns takes 1,024-thread blocks
    (one an SM), up to 16 a cluster, and may split its levels (none
    empty); a narrower row takes one split over up to 8 blocks of 512
    threads. Every block gets at least a quad a thread. With no such
    geometry (more rows than a wave holds), a block a row."""
    _check(0 < levels <= LADDER_MAX_LEVELS,
           f"ladder_plan: levels={levels} outside (0, {LADDER_MAX_LEVELS}]")
    wide = cols >= LADDER_WIDE_COLS
    threads = 1024 if wide else 512
    best = (math.inf, 0, 1, 1)
    for c in range(2, (LADDER_MAX_CLUSTER if wide else 8) + 1):
        if cols // c < 4 * threads:
            break
        for s in range(1, (levels if wide else 1) + 1):
            per = -(-levels // s)
            if -(-levels // per) == s and 0 < R * s <= max_clusters(threads,
                                                                    c):
                best = min(best, (-(-cols // c) * (per + LADDER_READ_COST),
                                  c * s, c, s))
    _, _, cluster, splits = best
    return LadderPlan("cluster" if cluster > 1 else "row", cluster, splits,
                      threads, R * splits * cluster)


_LADDER_ARGS = {
    "ladder_counts_launch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
    "ladder_max_clusters": [ctypes.c_int] * 3}


@functools.lru_cache(maxsize=None)
def _ladder_max_clusters(device: int, threads: int, cluster: int) -> int:
    """The card's ``cudaOccupancyMaxActiveClusters`` for the ladder kernel,
    asked once per device and geometry."""
    lib = _build.library("ladder_counts.cu", _LADDER_ARGS)
    n = lib.ladder_max_clusters(cluster, threads, device)
    if n < 0:
        raise RuntimeError(f"ladder_max_clusters failed: CUDA error {-n}")
    return n


def ladder_counts(imp_rows: torch.Tensor, thr: torch.Tensor,
                  lower_bound: float, levels: int) -> torch.Tensor:
    """Per-row pass counts of the whole threshold ladder in one read:
    ``counts[r, i] = #{imp_rows[r] >= float32(lower_bound ** i) *
    thr[r]}`` for i < ``levels`` <= 128, over a [R, cols] f32 importance
    view (row tails -1, never counted at thresholds >= 0; a NaN is never
    counted). Returns [R, levels] int32."""
    _check(imp_rows.dim() == 2 and imp_rows.dtype == torch.float32,
           "ladder_counts: imp_rows must be a 2-D float32 tensor")
    R, cols = imp_rows.shape
    _check(thr.shape == (R,) and thr.dtype == torch.float32,
           "ladder_counts: thr must be float32 [R]")
    _check(0 < levels <= LADDER_MAX_LEVELS,
           f"ladder_counts: levels={levels} outside (0, "
           f"{LADDER_MAX_LEVELS}]")
    if not _on_card("ladder_counts", imp_rows, thr):
        return ladder_counts_plain(imp_rows, thr, lower_bound, levels)
    dev = _stream_args(imp_rows)[0]
    plan = ladder_plan(R, cols, levels,
                       functools.partial(_ladder_max_clusters, dev))
    return _ladder_counts_launch(imp_rows, thr, lower_bound, levels, plan)


def _ladder_counts_launch(imp_rows, thr, lower_bound: float, levels: int,
                          plan: LadderPlan) -> torch.Tensor:
    """Launch the ladder kernel on checked CUDA operands with ``plan``
    (measurements time other geometries through here): one launch, which
    writes every count once."""
    R, cols = imp_rows.shape
    out = torch.empty((R, levels), dtype=torch.int32, device=imp_rows.device)
    if R:
        factors = _ladder_factor_array(float(lower_bound), levels)
        lib = _build.library("ladder_counts.cu", _LADDER_ARGS)
        err = lib.ladder_counts_launch(
            imp_rows.data_ptr(), thr.data_ptr(), factors.ctypes.data, R, cols,
            levels, plan.cluster, plan.splits, plan.threads, out.data_ptr(),
            *_stream_args(imp_rows))
        if err:
            raise RuntimeError(f"ladder_counts launch failed: CUDA error {err}")
        LAUNCHES["ladder_counts"] += 1
    return out


# ------------------------------------------------------------------ #
# K4, K5: per-(lane, segment) top-2 candidates (CUDA C++,          #
#         csrc/seg_top2.cu)                                          #
# ------------------------------------------------------------------ #
#
# Replace dgc_tpu/ops/kernels.py::seg_top2_candidates and
# ::fused_compensate_bits_cands, which share one cell function
# (_seg_top2_block). A segment is 256 blocks of 128 lanes (32,768
# elements); for each lane it yields the two largest |v| in the order
# (|v| descending, block ascending) as (signed value, segment-local block).
# One 256-thread block covers a segment: warp j owns record row j (blocks
# 32j..32j+31), each thread four lanes, so a thread reads one int4 of
# record words and float4s of the state. Each thread keeps a running top-2
# per lane in registers over its 32 blocks in ascending order (strict
# compares: ties keep the lower block); there is no reduction inside the
# stream, and one merge of the 8 row partials per lane through shared
# memory at the end, in row order. Both kernels run that one scan and
# merge, so their candidates agree bitwise by construction; the fused
# kernel compensates each element first with compensate_bits' arithmetic
# (csrc/compensate.cuh) and scans the stored velocity.
#
# Bound on the card: bytes. The fused pass moves the compensate's 20 B per
# element plus the record and 2 KB of candidates per segment (541 MB at
# ResNet-50's T = 27,068,416: 0.16 ms at 3.35 TB/s; with bf16 state 12 B
# per element, 0.098 ms); the standalone pass reads each bucket once (4 B
# per element, 2 for bf16). The candidate compares ride the stream: a few
# per element, far below the f32 rate. Both kernels take f32 or bf16 state
# (a template flag): bf16 is widened in the kernel and the candidates stay
# f32; the fused kernel scans the stored, rounded velocity.

def seg_top2_eligible(total_blocks: int, base: int, cols: int,
                      rows: int = 1) -> bool:
    """Whether a bucket's [rows, cols] region can be read by the candidates
    kernels straight out of the flat buffer of ``total_blocks`` 128-lane
    blocks: base and row width whole segments, the region inside the
    buffer (the reference's gate)."""
    return (base % SEG_SPAN == 0 and cols % SEG_SPAN == 0
            and total_blocks * _LANE >= base + rows * cols)


def seg_cols_local(blks: torch.Tensor) -> torch.Tensor:
    """Per-segment block ids [R, nseg, 2, 128] -> bucket-local columns
    [R, nseg * 256] in (segment, slot, lane) order: ``(blk + seg * 256) *
    128 + lane``. The one recomposition both candidate sources go
    through."""
    R, nseg = blks.shape[0], blks.shape[1]
    lane = torch.arange(_LANE, dtype=torch.int32, device=blks.device)
    seg0 = torch.arange(nseg, dtype=torch.int32,
                        device=blks.device) * SEG_BLOCKS
    return ((blks + seg0[None, :, None, None]) * _LANE
            + lane[None, None, None, :]).reshape(R, -1)


def _top2_plain(x: torch.Tensor):
    """Plain cell function over [S, 256, 128] segments: ``(values
    [S, 2, 128] f32, blocks [S, 2, 128] int32)``; the value read back at
    the block plus 0.0 (the kernels' masked sum), so -0.0 reads +0.0. A
    NaN never wins, as in the kernel's running top-2 (a NaN step's
    candidates are thrown away by the guards' revert, but must stay in
    range): a lane slot with no number left gives block 0 and 0.0."""
    a = torch.where(torch.isnan(x), -1.0, x.abs())
    blk = torch.arange(SEG_BLOCKS, dtype=torch.int32,
                       device=x.device).view(1, SEG_BLOCKS, 1)
    m1 = a.amax(1, keepdim=True)
    b1 = torch.where(a >= m1, blk, SEG_BLOCKS).amin(1, keepdim=True)
    a_2 = torch.where(blk == b1, -1.0, a)
    m2 = a_2.amax(1, keepdim=True)
    b2 = torch.where(a_2 >= m2, blk, SEG_BLOCKS).amin(1, keepdim=True)
    b2 = torch.where(m2 < 0, 0, b2)
    blocks = torch.cat([b1, b2], 1)
    vals = torch.where(torch.cat([m1, m2], 1) < 0, 0.0,
                       x.gather(1, blocks.long()))
    return vals + 0.0, blocks


def seg_top2_candidates_plain(flat: torch.Tensor, base: int, rows: int,
                              cols: int):
    """Plain version of :func:`seg_top2_candidates` (a bf16 buffer is
    up-cast first, which is exact)."""
    nseg = cols // SEG_SPAN
    x = flat[base:base + rows * cols].float().view(rows * nseg, SEG_BLOCKS,
                                                    _LANE)
    vals, blks = _top2_plain(x)
    return (vals.view(rows, -1),
            seg_cols_local(blks.view(rows, nseg, 2, _LANE)))


_SEG_ARGS = {
    "seg_top2_launch": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p],
    "compensate_bits_cands_launch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]}


def _quad_bytes(t: torch.Tensor) -> int:
    """Bytes of four elements of ``t``: the candidates kernels' load
    granule, to which their state must be aligned (16 for f32, 8 for
    bf16)."""
    return 4 * t.element_size()


def seg_top2_candidates(flat: torch.Tensor, base: int, rows: int, cols: int):
    """Per-(row, lane, segment) top-2 candidates of the bucket [rows, cols]
    at ``base`` of the flat f32 or bf16 buffer, read in place. Returns
    ``(signed values [rows, C] f32, bucket-local columns [rows, C] int32)``
    with ``C = cols / 32768 * 256``, in (segment, slot, lane) order."""
    _check(flat.dim() == 1 and flat.dtype in (torch.float32, torch.bfloat16)
           and flat.shape[0] % _LANE == 0,
           "seg_top2_candidates: flat must be a lane-aligned 1-D float32 or "
           "bfloat16 tensor")
    _check(seg_top2_eligible(flat.shape[0] // _LANE, base, cols, rows),
           f"seg_top2_candidates: [{rows}, {cols}] at {base} is not "
           "segment-aligned inside the buffer")
    if not _on_card("seg_top2_candidates", flat):
        return seg_top2_candidates_plain(flat, base, rows, cols)
    _check(flat.data_ptr() % _quad_bytes(flat) == 0,
           f"seg_top2_candidates: flat must be {_quad_bytes(flat)}-byte "
           "aligned")
    nseg = cols // SEG_SPAN
    vals = torch.empty((rows * nseg, 2, _LANE), dtype=torch.float32,
                       device=flat.device)
    blks = torch.empty((rows * nseg, 2, _LANE), dtype=torch.int32,
                       device=flat.device)
    if rows and nseg:
        lib = _build.library("seg_top2.cu", _SEG_ARGS)
        err = lib.seg_top2_launch(
            flat.data_ptr() + flat.element_size() * base, rows * nseg,
            vals.data_ptr(), blks.data_ptr(),
            int(flat.dtype == torch.bfloat16), *_stream_args(flat))
        if err:
            raise RuntimeError(
                f"seg_top2_candidates launch failed: CUDA error {err}")
        LAUNCHES["seg_top2_candidates"] += 1
    return (vals.view(rows, -1),
            seg_cols_local(blks.view(rows, nseg, 2, _LANE)))


def compensate_bits_cands_plain(grad, mmt, vec, bits, momentum: float,
                                nesterov: bool = False,
                                momentum_masking: bool = True):
    """Plain version of :func:`compensate_bits_cands`: returns new
    ``(mmt', vec', cand values, cand blocks)``."""
    m, v = compensate_bits_plain(grad, mmt, vec, bits, momentum, nesterov,
                                 momentum_masking)
    nseg = v.shape[0] // SEG_SPAN
    cv, cb = _top2_plain(v[:nseg * SEG_SPAN].float().view(nseg, SEG_BLOCKS,
                                                           _LANE))
    return m, v, cv, cb


def compensate_bits_cands(grad, mmt, vec, bits, momentum: float,
                          nesterov: bool = False,
                          momentum_masking: bool = True):
    """:func:`compensate_bits` (``mmt``, ``vec`` updated IN PLACE) that
    also emits the segment top-2 candidates of the stored velocity, for
    the ``T // 32768`` complete segments. Returns ``(mmt, vec, cand values
    [nseg, 2, 128] f32, cand blocks [nseg, 2, 128] int32)``; the
    candidates are bitwise :func:`seg_top2_candidates` on ``vec`` (with
    bf16 state, on the stored, rounded velocity)."""
    n = grad.shape[0]
    _check_compensate("compensate_bits_cands", grad, mmt, vec, bits)
    if not _on_card("compensate_bits_cands", grad, mmt, vec, bits):
        m, v, cv, cb = compensate_bits_cands_plain(
            grad, mmt, vec, bits, momentum, nesterov, momentum_masking)
        mmt.copy_(m)
        vec.copy_(v)
        return mmt, vec, cv, cb
    _check(grad.data_ptr() % 16 == 0 and bits.data_ptr() % 16 == 0
           and all(t.data_ptr() % _quad_bytes(t) == 0 for t in (mmt, vec)),
           "compensate_bits_cands: grad and bits must be 16-byte aligned, "
           f"mmt and vec {_quad_bytes(mmt)}-byte aligned")
    nseg = n // SEG_SPAN
    cv = torch.empty((nseg, 2, _LANE), dtype=torch.float32,
                     device=grad.device)
    cb = torch.empty((nseg, 2, _LANE), dtype=torch.int32, device=grad.device)
    if n:
        lib = _build.library("seg_top2.cu", _SEG_ARGS)
        err = lib.compensate_bits_cands_launch(
            grad.data_ptr(), mmt.data_ptr(), vec.data_ptr(), bits.data_ptr(),
            n, float(momentum), int(nesterov), int(momentum_masking),
            cv.data_ptr(), cb.data_ptr(), int(mmt.dtype == torch.bfloat16),
            *_stream_args(grad))
        if err:
            raise RuntimeError(
                f"compensate_bits_cands launch failed: CUDA error {err}")
        LAUNCHES["compensate_bits_cands"] += 1
    return mmt, vec, cv, cb


# ------------------------------------------------------------------ #
# K2: exact per-row top-k (CUDA C++, csrc/topk_rows.cu)              #
# ------------------------------------------------------------------ #

def topk_rows_plain(x: torch.Tensor, k: int):
    """Plain version: a stable descending sort, so ties keep column order
    (``lax.top_k`` order). Returns ``(values [R, k], columns [R, k] int32)``."""
    v, i = torch.sort(x, dim=1, descending=True, stable=True)
    return v[:, :k].contiguous(), i[:, :k].to(torch.int32)


#: shared memory a block may use on an H100 (227 KB)
_SMEM_MAX = 232_448
#: the selection core's scratch at the head of a block's shared memory
#: (``topk::Scratch``, csrc/topk_select.cuh)
_TOPK_SCRATCH = 4368
#: rows of at most this many columns are sorted whole (the "sort" route)
TOPK_SORT_MAX_COLS = 512
#: the survivors of a selection are radix-sorted from this many sort words
#: (next_pow2(k)) on, below it bitonic-sorted
TOPK_RADIX_MIN_WORDS = 2048
#: the cluster route takes rows of at least this many columns when the
#: rows alone would leave most SMs idle
TOPK_CLUSTER_MIN_COLS = 8192
_TOPK_CLUSTER_MIN_SLICE = 2048
_TOPK_SMS = 132
#: columns a thread of a row's block scans per pass, at least
_TOPK_COLS_PER_THREAD = 4
#: the top-k kernel's routes (see :class:`TopkPlan`)
TOPK_ROUTES = ("sort", "block", "cluster")


class TopkPlan(NamedTuple):
    """Launch geometry of :func:`topk_rows` (see ``csrc/topk_rows.cu``).
    ``route`` is ``"sort"`` (a block of ``threads`` sorts each whole
    row), ``"block"`` (a block of ``threads`` selects in each row) or
    ``"cluster"`` (``cluster`` blocks split each row into slices of
    ``slice`` columns); ``grid`` is the blocks launched; ``staged``
    whether each block stages its slice into shared memory
    (``stage_words`` words), else reads it from global memory; ``padded``
    the sort buffer's words; ``radix`` whether the survivors are
    radix-sorted (through ``R * padded`` words of global scratch), else
    bitonic-sorted; ``smem_bytes`` a block's dynamic shared memory."""
    route: str
    threads: int
    cluster: int
    grid: int
    slice: int
    staged: bool
    stage_words: int
    padded: int
    radix: bool
    smem_bytes: int


def _pow2_ceil(x: int) -> int:
    return 1 << max(0, (int(x) - 1).bit_length())


def _pow2_floor(x: int) -> int:
    return 1 << (max(1, int(x)).bit_length() - 1)


def _topk_smem(slice_cols: int, padded: int, staged: bool,
               radix_warps: int = 0) -> int:
    """A block's shared memory: the selection core's scratch, the staged
    slice (the 16-byte granules that cover it), the sort buffer (a pad
    word after every 16, against bank conflicts) and the radix sort's 256
    counters a warp."""
    stage = -(-(slice_cols + 8) // 4) * 4 if staged else 0
    return _align16(_TOPK_SCRATCH + 4 * stage + 8 * (padded + padded // 16)
                    + 1024 * radix_warps)


def topk_geometry(R: int, cols: int, k: int, route: str, cluster: int,
                  threads: int, radix: Optional[bool] = None) -> TopkPlan:
    """The :class:`TopkPlan` of a given route, cluster size and threads a
    block (a multiple of 32, at most 1,024): the slices, the staging
    (where the slice and the sort buffer fit one block's shared memory)
    and the shared bytes. The survivors are radix-sorted from
    :data:`TOPK_RADIX_MIN_WORDS` sort words on (never on the sort route),
    unless ``radix`` says."""
    _check(0 < k <= min(cols, TOPK_MAX_K),
           f"topk_plan: k={k} outside [1, min({cols}, {TOPK_MAX_K})]")
    _check(route in TOPK_ROUTES, f"topk_plan: unknown route {route}")
    _check(threads % 32 == 0 and 32 <= threads <= 1024,
           f"topk_plan: {threads} threads a block")
    _check(route != "sort" or cols <= TOPK_MAX_K,
           f"topk_plan: the sort route sorts at most {TOPK_MAX_K} columns")
    _check((route == "cluster") == (cluster > 1),
           f"topk_plan: {route} route with {cluster} blocks a row")
    padded = _pow2_ceil(cols if route == "sort" else k)
    if radix is None:
        radix = route != "sort" and padded >= TOPK_RADIX_MIN_WORDS
    _check(not (radix and route == "sort"),
           "topk_plan: the sort route sorts by bitonic stages")
    if cluster > 1:                             # slices of 4k columns
        sl = -(-(-(-cols // cluster)) // 4) * 4
    else:
        sl = cols
    warps = threads // 32 if radix else 0
    staged = _topk_smem(sl, padded, True, warps) <= _SMEM_MAX
    stage_words = -(-(sl + 8) // 4) * 4 if staged else 0
    return TopkPlan(route, threads, cluster, R * cluster, sl, staged,
                    stage_words, padded, radix,
                    _topk_smem(sl, padded, staged, warps))


def topk_plan(R: int, cols: int, k: int,
              route: Optional[str] = None) -> TopkPlan:
    """The top-k kernel's launch plan for ``k`` of ``cols`` columns in
    each of ``R`` rows (0 < k <= min(cols, TOPK_MAX_K)), sized from
    ``topk_bench.py`` on an H100 (PERF.md). Rows of at most
    :data:`TOPK_SORT_MAX_COLS` columns are sorted whole, by a block of one
    thread for every two columns (wider, the sort costs more than the
    selection it replaces). Wider rows radix-select: rows of at least
    :data:`TOPK_CLUSTER_MIN_COLS` columns that leave more than half the
    132 SMs idle are split over a cluster of up to 8 blocks (at least
    2,048 columns a block), as is a row whose slice and sort buffer do
    not fit one block's 227 KB (a slice that fits nowhere is read from
    global memory); the rest take a block each. A row's (or a slice's)
    threads are the power of two that gives each at least 4 columns a
    pass, and at least one for every 4 words of the sort, within 256 to
    1,024. ``route`` forces one (for measurements)."""
    _check(0 < k <= min(cols, TOPK_MAX_K),
           f"topk_plan: k={k} outside [1, min({cols}, {TOPK_MAX_K})]")
    _check(route is None or route in TOPK_ROUTES,
           f"topk_plan: unknown route {route}")
    if route == "sort" or (route is None and cols <= TOPK_SORT_MAX_COLS):
        return topk_geometry(R, cols, k, "sort", 1,
                             min(1024, max(32, _pow2_ceil(cols) // 2)))
    padded = _pow2_ceil(k)
    C = 1
    if cols >= TOPK_CLUSTER_MIN_COLS and 2 * R <= _TOPK_SMS:
        C = min(8, _pow2_floor(_TOPK_SMS // R),
                _pow2_floor(cols // _TOPK_CLUSTER_MIN_SLICE))
    if route == "cluster":
        C = max(C, 2)
    elif route is not None:
        C = 1
    while (route is None and C < 8 and not topk_geometry(
            R, cols, k, "cluster" if C > 1 else "block", C, 1024).staged):
        C *= 2                                  # the row does not fit a block
    sl = -(-(-(-cols // C)) // 4) * 4 if C > 1 else cols
    threads = min(1024, max(256, padded // 4, _pow2_floor(
        sl // _TOPK_COLS_PER_THREAD)))
    return topk_geometry(R, cols, k, "cluster" if C > 1 else "block", C,
                         threads)


#: the geometry arguments of a row kernel's launch (a :class:`TopkPlan`)
_PLAN_ARGS = [ctypes.c_int] * 8


def _plan_args(plan: TopkPlan):
    return (plan.cluster, plan.threads, plan.slice, int(plan.staged),
            plan.stage_words, plan.padded, int(plan.route == "sort"),
            plan.smem_bytes)


_TOPK_ARGS = {"topk_rows_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
              + _PLAN_ARGS + [ctypes.c_int, ctypes.c_void_p]}


@_trace.phased("select")
def topk_rows(x: torch.Tensor, k: int):
    """Per-row ``(values, int32 columns)`` of the k largest elements of a
    [R, cols] f32 or bf16 tensor: values descending, ties to the smaller
    column, exactly ``jax.lax.top_k`` for NaN-free input (the values are
    read back from the row, so a selected -0.0 keeps its sign). A bf16
    input reaches the kernel through one up-cast to f32 (monotone and
    exact, so the order, the ties and the values cast back are the bf16
    top-k's), after the kernel's bound on k is checked."""
    _check(x.dim() == 2 and x.dtype in (torch.float32, torch.bfloat16),
           "topk_rows: x must be a 2-D float32 or bfloat16 tensor")
    R, cols = x.shape
    _check(0 <= k <= cols, f"topk_rows: k={k} outside [0, {cols}]")
    if not _on_card("topk_rows", x):
        return topk_rows_plain(x, k)
    _check(k <= TOPK_MAX_K,
           f"topk_rows: k={k} exceeds the kernel's shared-memory sort "
           f"(k <= {TOPK_MAX_K})")
    if x.dtype != torch.float32:
        vals, cols_out = topk_rows(x.float(), k)
        return vals.to(x.dtype), cols_out
    return _topk_rows_launch(x, k, topk_plan(R, cols, k) if R and k else None)


def _topk_rows_launch(x: torch.Tensor, k: int, plan: Optional[TopkPlan]):
    """Launch the top-k kernel on a checked CUDA ``x`` with ``plan``
    (measurements force a route through here)."""
    R = x.shape[0]
    vals = torch.empty((R, k), dtype=torch.float32, device=x.device)
    cols_out = torch.empty((R, k), dtype=torch.int32, device=x.device)
    if plan is not None:
        tmp = (torch.empty(R * plan.padded, dtype=torch.int64,
                           device=x.device) if plan.radix else None)
        lib = _build.library("topk_rows.cu", _TOPK_ARGS)
        err = lib.topk_rows_launch(
            x.data_ptr(), vals.data_ptr(), cols_out.data_ptr(),
            tmp.data_ptr() if tmp is not None else None, R, x.shape[1], k,
            *_plan_args(plan), *_stream_args(x))
        if err:
            raise RuntimeError(f"topk_rows launch failed: CUDA error {err}")
        LAUNCHES["topk_rows"] += 1
    return vals, cols_out


# ------------------------------------------------------------------ #
# K8: fused select and pack (CUDA C++, csrc/select_pack_rows.cu)     #
# ------------------------------------------------------------------ #

def select_pack_rows_plain(x: torch.Tensor, numels: torch.Tensor, k: int):
    """Plain version of :func:`select_pack_rows`: the row tail masked to
    importance -1, the stable top-k of |x| (``lax.top_k`` order), the
    signed values gathered at the selected columns. A selected -0.0 reads
    +0.0 (the gather plus 0.0), as the Pallas kernels' one-hot masked sum
    reads it; the reference's gather keeps the sign."""
    col = torch.arange(x.shape[1], device=x.device)
    imp = torch.where(col[None, :] < numels[:, None], x.abs(), -1.0)
    scores, cols = topk_rows_plain(imp, k)
    return scores, x.gather(1, cols.long()) + 0.0, cols


def _check_select(name: str, R: int, cols: int, numels: torch.Tensor,
                  k: int) -> None:
    _check(numels.shape == (R,) and numels.dtype == torch.int32,
           f"{name}: numels must be int32 [R]")
    _check(0 < k <= min(cols, MR_MAX_K),
           f"{name}: k={k} outside (0, min(cols={cols}, {MR_MAX_K})]")


def _select_outputs(R: int, k: int, device):
    return (torch.empty((R, k), dtype=torch.float32, device=device),
            torch.empty((R, k), dtype=torch.float32, device=device),
            torch.empty((R, k), dtype=torch.int32, device=device))


_SELECT_ARGS = {"select_pack_rows_launch": [ctypes.c_void_p] * 5
                + [ctypes.c_int] * 3 + _PLAN_ARGS
                + [ctypes.c_int, ctypes.c_void_p]}


@_trace.phased("select")
def select_pack_rows(x: torch.Tensor, numels: torch.Tensor, k: int):
    """Fused threshold -> select -> pack over a bucket's [R, cols] f32
    block: per row, ``(scores, signed values, int32 columns)`` [R, k] of
    the k most important entries, importance ``|x|`` over the first
    ``numels[r]`` columns and -1 past them, in ``lax.top_k`` order. ``0 <
    k <= MR_MAX_K``; a selected -0.0 is written +0.0 (see
    :func:`select_pack_rows_plain`). The kernel runs on the top-k kernel's
    route and geometry (:func:`topk_plan`). A bf16 block reaches it
    through one up-cast to f32, its scores and values cast back (exact)."""
    _check(x.dim() == 2 and x.dtype in (torch.float32, torch.bfloat16),
           "select_pack_rows: x must be a 2-D float32 or bfloat16 tensor")
    R, cols = x.shape
    _check_select("select_pack_rows", R, cols, numels, k)
    if not _on_card("select_pack_rows", x, numels):
        return select_pack_rows_plain(x, numels, k)
    if x.dtype != torch.float32:
        scores, vals, cols_out = select_pack_rows(x.float(), numels, k)
        return scores.to(x.dtype), vals.to(x.dtype), cols_out
    return _select_pack_rows_launch(x, numels, k, topk_plan(R, cols, k))


def _select_pack_rows_launch(x: torch.Tensor, numels: torch.Tensor, k: int,
                             plan: TopkPlan):
    """Launch the select-and-pack kernel on checked CUDA operands with
    ``plan`` (measurements force a route through here)."""
    _check(not plan.radix, "select_pack_rows: the survivors are bitonic-"
           f"sorted (k <= {MR_MAX_K})")
    R = x.shape[0]
    out = _select_outputs(R, k, x.device)
    if R:
        lib = _build.library("select_pack_rows.cu", _SELECT_ARGS)
        err = lib.select_pack_rows_launch(
            x.data_ptr(), numels.data_ptr(), *(t.data_ptr() for t in out), R,
            x.shape[1], k, *_plan_args(plan), *_stream_args(x))
        if err:
            raise RuntimeError(
                f"select_pack_rows launch failed: CUDA error {err}")
        LAUNCHES["select_pack_rows"] += 1
    return out


# ------------------------------------------------------------------ #
# K9: the forward megakernel (CUDA C++, csrc/dgc_forward_rows.cu)    #
# ------------------------------------------------------------------ #

def dgc_forward_rows_plain(grad, mmt, vec, bits, base: int,
                           numels: torch.Tensor, k: int, momentum: float,
                           nesterov: bool = False,
                           momentum_masking: bool = True):
    """Plain version of :func:`dgc_forward_rows` (the engine's unfused
    sequence over one bucket region): window the record
    (:func:`realign_bits`), compensate (:func:`compensate_bits_plain`),
    select and pack the [R, cols] view of the velocity
    (:func:`select_pack_rows_plain`). Returns new ``(mmt', vec', scores,
    values, columns)``."""
    n, R = grad.shape[0], numels.shape[0]
    m, v = compensate_bits_plain(grad, mmt, vec, realign_bits(bits, base, n),
                                 momentum, nesterov, momentum_masking)
    return (m, v, *select_pack_rows_plain(v.view(R, n // R), numels, k))


_FORWARD_ARGS = {"dgc_forward_rows_launch": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_longlong] + [ctypes.c_void_p] * 4
    + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_int]
    + _PLAN_ARGS + [ctypes.c_int, ctypes.c_void_p]}


def dgc_forward_rows(grad, mmt, vec, bits, base: int, numels: torch.Tensor,
                     k: int, momentum: float, nesterov: bool = False,
                     momentum_masking: bool = True):
    """The forward megakernel over one bucket: ``grad``, ``mmt``, ``vec``
    are the bucket's flat f32 region ``[R * cols]`` at flat offset
    ``base`` of the buffers whose transmit record is ``bits`` (the full
    record). Compensates with the record's mask applied on read, updating
    ``mmt`` and ``vec`` IN PLACE, and returns the selection of the
    compensated velocity, ``(scores, values, columns)`` [R, k]: bitwise
    :func:`compensate_bits` then :func:`select_pack_rows` on the region."""
    if any(t.dtype != torch.float32 for t in (grad, mmt, vec)):
        raise ValueError(
            "dgc_forward_rows is f32-only (the bf16 error-feedback state "
            f"must stay on the unfused path): got {grad.dtype}/"
            f"{mmt.dtype}/{vec.dtype}")
    n, R = grad.shape[0], numels.shape[0]
    _check(grad.dim() == 1 and mmt.shape == (n,) and vec.shape == (n,)
           and R > 0 and n % R == 0,
           "dgc_forward_rows: grad, mmt, vec must be 1-D of one length, "
           "a multiple of len(numels)")
    cols = n // R
    _check(cols % _LANE == 0 and base % _LANE == 0,
           f"dgc_forward_rows: cols {cols} and base {base} must be "
           "lane-aligned")
    _check(bits.dim() == 1 and bits.dtype == torch.int32,
           "dgc_forward_rows: bits must be a 1-D int32 record")
    _check_select("dgc_forward_rows", R, cols, numels, k)
    if not _on_card("dgc_forward_rows", grad, mmt, vec, bits, numels):
        m, v, *sel = dgc_forward_rows_plain(grad, mmt, vec, bits, base,
                                            numels, k, momentum, nesterov,
                                            momentum_masking)
        mmt.copy_(m)
        vec.copy_(v)
        return tuple(sel)
    _check(all(t.data_ptr() % 16 == 0 for t in (grad, mmt, vec)),
           "dgc_forward_rows: grad, mmt, vec must be 16-byte aligned")
    plan = topk_plan(R, cols, k)
    _check(plan.staged and not plan.radix,
           f"dgc_forward_rows: rows of {cols} columns do not fit the "
           "kernel's shared memory")
    out = _select_outputs(R, k, grad.device)
    lib = _build.library("dgc_forward_rows.cu", _FORWARD_ARGS)
    err = lib.dgc_forward_rows_launch(
        grad.data_ptr(), mmt.data_ptr(), vec.data_ptr(), bits.data_ptr(),
        bits.shape[0], base, numels.data_ptr(),
        *(t.data_ptr() for t in out), R, cols, k, float(momentum),
        int(nesterov), int(momentum_masking), *_plan_args(plan),
        *_stream_args(grad))
    if err:
        raise RuntimeError(f"dgc_forward_rows launch failed: CUDA error {err}")
    LAUNCHES["dgc_forward_rows"] += 1
    return out


# ------------------------------------------------------------------ #
# K3: post-gather apply (CUDA C++, csrc/apply_rows.cu)               #
# ------------------------------------------------------------------ #

def _in_range(indices: torch.Tensor, total: int) -> torch.Tensor:
    return (indices >= 0) & (indices < total)


def divide_exact(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """``x / divisor`` as an IEEE divide on every device: the divisor is a
    0-dim tensor of ``x``'s dtype and device. PyTorch's CUDA divide by a
    Python scalar multiplies by the scalar's reciprocal, which differs
    from the divide wherever 1/divisor is inexact (a divisor that is not a
    power of two); its CPU divide and the JAX package's op-by-op divide
    are IEEE."""
    return x / torch.full((), divisor, dtype=x.dtype, device=x.device)


def apply_rows_plain(values, indices, flags, total: int,
                     divisor: Optional[float] = None):
    """Plain version of :func:`apply_rows`. Sums each index's entries in
    payload order from +0.0 — a stable sort by index, then one round per
    duplicate rank, each round a scatter with unique indices — so it is
    deterministic on any device. Zero-valued and out-of-range entries add
    nothing. The divide is :func:`divide_exact`, an IEEE divide on every
    device."""
    v = values if divisor is None else divide_exact(values, divisor)
    key = torch.where((v != 0) & _in_range(indices, total), indices, total)
    skey, order = torch.sort(key, stable=True)
    sval = v[order]
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


#: coordinates (and 128 record words) one block of the apply kernel owns
APPLY_CHUNK = _BITS_GROUP
#: the scan route (every block reads the whole payload) up to this many
#: entries and this many entries x chunks; the list route above. From
#: ``apply_bench.py --sweep`` on an H100 (PERF.md): at ResNet-20's T
#: (91 chunks) the scan route is faster up to n = 8,192, the most its
#: shared memory holds (0.0086 against 0.0113 ms); at ResNet-50's (6,609
#: chunks) up to n = 2,048 (0.038 against 0.059 ms) and slower from 4,096
#: (0.066 against 0.060), so n x chunks stays under 16M.
APPLY_SCAN_MAX_N = 8192
APPLY_SCAN_MAX_WORK = 16 << 20
#: dynamic shared memory of a chunk block: 22,784 fixed bytes (4096
#: counters, the 128 record words, the long-run mask, scan scratch, the
#: sparse path's 256 keys), then 12 bytes a staged entry (scan route) and 8
#: a placed one; a list-route chunk with more entries than its ``cap`` runs
#: in global scratch
_APPLY_SMEM_FIXED = 22_784
_APPLY_CAP_MIN, _APPLY_CAP_MAX = 512, 11_264
_APPLY_TILE = 2048
_APPLY_ROUTE_GRID_MAX = 132 * 4


class ApplyPlan(NamedTuple):
    """Launch geometry of :func:`apply_rows` (see ``csrc/apply_rows.cu``).
    ``route`` is ``"scan"`` or ``"list"``; ``grid`` the chunk blocks;
    ``cap`` the entries a chunk block keeps in shared memory (and the list
    route's segment of each chunk); ``smem_bytes`` its dynamic shared
    memory; ``route_grid`` the blocks of the list route's scatter (2,048
    entries a tile); ``scratch_bytes`` the list route's scratch (0 for the
    scan route)."""
    route: str
    chunk: int
    grid: int
    cap: int
    smem_bytes: int
    route_grid: int
    scratch_bytes: int


def _align16(x: int) -> int:
    return -(-x // 16) * 16


def apply_plan(n: int, total: int, route: Optional[str] = None
               ) -> ApplyPlan:
    """The apply kernel's launch plan for ``n`` payload entries into a
    [total] buffer. The scan route when the payload is small (every block
    reads all of it from L2; ``cap = n``, so no chunk overflows), else the
    list route, whose chunk blocks keep 3/2 of the mean entries per chunk
    plus 256 in shared memory (rounded up to 256, within [512, 11264]:
    two blocks an SM at most): the engine's chunks hold up to 1.4x the
    mean (ResNet-20 at the epoch-0 ratio, W=4). ``route`` forces one (for
    measurements)."""
    grid = -(-total // APPLY_CHUNK)
    if route is None:
        route = ("scan" if n <= APPLY_SCAN_MAX_N
                 and n * grid <= APPLY_SCAN_MAX_WORK else "list")
    _check(route in ("scan", "list"), f"apply_plan: unknown route {route}")
    if route == "scan":
        cap = max(n, 1)
        return ApplyPlan("scan", APPLY_CHUNK, grid, cap,
                         _APPLY_SMEM_FIXED + 20 * cap, 0, 0)
    mean = n // max(grid, 1)
    cap = -(-(mean + mean // 2 + 256) // 256) * 256
    cap = min(max(cap, _APPLY_CAP_MIN), _APPLY_CAP_MAX)
    route_grid = max(1, min(-(-n // _APPLY_TILE), _APPLY_ROUTE_GRID_MAX))
    slots = grid * cap
    scratch = (_align16(4 * (grid + 2)) + _align16(8 * slots)
               + _align16(4 * slots) + _align16(8 * n) + 3 * _align16(4 * n))
    return ApplyPlan("list", APPLY_CHUNK, grid, cap,
                     _APPLY_SMEM_FIXED + 8 * cap, route_grid, scratch)


_APPLY_ARGS = {"apply_rows_launch": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]}


@_trace.phased("apply")
def apply_rows(values, indices, flags, total: int,
               divisor: Optional[float] = None):
    """Decompress + transmit record in one pass over the gathered payload
    (``dgc_apply_rows`` semantics; ``divisor=None`` is
    ``payload_apply_bits``): ``acc[idx] += v / divisor`` for every entry,
    summed in payload order from +0.0, and the packed bit set for every
    entry whose ``flag`` is true (the local worker's non-sentinel slots,
    whose indices are unique). Entries whose index lies outside
    ``[0, total)`` are dropped (the engine routes them to its sentinel
    first). Returns ``(acc [total] f32, bits [num_sent_words(total)]
    int32)``."""
    n = values.shape[0]
    _check(values.dim() == 1 and indices.shape == (n,) and flags.shape == (n,),
           "apply_rows: values, indices, flags must be 1-D of one length")
    _check(values.dtype == torch.float32 and indices.dtype == torch.int32
           and flags.dtype == torch.bool,
           "apply_rows: values f32, indices int32, flags bool")
    num_sent_words(total)                   # checks total % 128
    if not _on_card("apply_rows", values, indices, flags):
        return apply_rows_plain(values, indices, flags, total, divisor)
    return _apply_rows_launch(values, indices, flags, total, divisor,
                              apply_plan(n, total))


def _apply_rows_launch(values, indices, flags, total: int,
                       divisor: Optional[float], plan: ApplyPlan):
    """Launch the apply kernel on checked CUDA operands with ``plan``
    (measurements force a route through here)."""
    n, dev = values.shape[0], values.device
    acc = torch.empty(total, dtype=torch.float32, device=dev)
    bits = torch.empty(num_sent_words(total), dtype=torch.int32, device=dev)
    if plan.grid:
        scratch = (torch.empty(plan.scratch_bytes, dtype=torch.uint8,
                               device=dev) if plan.scratch_bytes else None)
        lib = _build.library("apply_rows.cu", _APPLY_ARGS)
        err = lib.apply_rows_launch(
            indices.data_ptr(), flags.data_ptr(), values.data_ptr(), n,
            acc.data_ptr(), bits.data_ptr(), total,
            int(divisor is not None),
            float(divisor) if divisor is not None else 1.0,
            int(plan.route == "list"), plan.grid, plan.cap, plan.smem_bytes,
            plan.route_grid,
            scratch.data_ptr() if scratch is not None else None,
            *_stream_args(values))
        if err:
            raise RuntimeError(f"apply_rows launch failed: CUDA error {err}")
        LAUNCHES["apply_rows"] += 1
    return acc, bits


# ------------------------------------------------------------------ #
# K6, K7: opaque views (CUDA C++, csrc/opaque_copy.cu)               #
# ------------------------------------------------------------------ #
#
# Replace dgc_tpu/ops/kernels.py::opaque_view (_opaque_copy) and
# ::opaque_view_from (_opaque_from): an identity copy of one weight into a
# buffer of its own, which the train step binds in place of a view of the
# flat parameter buffer for the tensors ParamLayout.convert_hoist_risky
# names. Bound on the card: bytes, one read and one write of the tensor.

def opaque_view_eligible(total: int, base: int, numel: int) -> bool:
    """Whether :func:`opaque_view_from` takes ``flat[base:base+numel]``
    (the reference's tile alignment)."""
    tile = _SUBLANE * _LANE
    return (total % _LANE == 0 and base % tile == 0 and numel % tile == 0
            and numel > 0 and base + numel <= total)


_COPY_ARGS = {"opaque_copy_launch": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_void_p]}


def _copy_on_card(name: str, src: torch.Tensor, offset: int,
                  numel: int) -> torch.Tensor:
    out = torch.empty(numel, dtype=torch.float32, device=src.device)
    if numel:
        lib = _build.library("opaque_copy.cu", _COPY_ARGS)
        err = lib.opaque_copy_launch(src.data_ptr() + 4 * offset,
                                     out.data_ptr(), numel,
                                     *_stream_args(src))
        if err:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        LAUNCHES[name] += 1
    return out


def opaque_view_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`opaque_view`'s forward."""
    return x.clone()


def opaque_view_from_plain(flat: torch.Tensor, base: int,
                           numel: int) -> torch.Tensor:
    """Plain version of :func:`opaque_view_from`'s forward."""
    return flat[base:base + numel].clone()


class _OpaqueView(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        if not _on_card("opaque_view", x):
            return opaque_view_plain(x)
        return _copy_on_card("opaque_view", x, 0, x.numel()).view(x.shape)

    @staticmethod
    def backward(ctx, g):
        return g


class _OpaqueViewFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, flat, base, numel):
        ctx.base, ctx.total = base, flat.shape[0]
        if not _on_card("opaque_view_from", flat):
            return opaque_view_from_plain(flat, base, numel)
        return _copy_on_card("opaque_view_from", flat, base, numel)

    @staticmethod
    def backward(ctx, g):
        # the transpose of the slice it replaces (not a kernel on the TPU
        # either: a dynamic_update_slice into zeros)
        out = g.new_zeros(ctx.total)
        out[ctx.base:ctx.base + g.shape[0]] = g
        return out, None, None


def opaque_view(x: torch.Tensor) -> torch.Tensor:
    """Identity with a buffer of its own: a copy of the f32 tensor ``x``;
    the gradient passes through unchanged."""
    _check(x.dtype == torch.float32, "opaque_view: x must be float32")
    return _OpaqueView.apply(x)


def opaque_view_from(flat: torch.Tensor, base: int,
                     numel: int) -> torch.Tensor:
    """:func:`opaque_view` of ``flat[base:base+numel]``, read straight from
    the flat f32 buffer; the gradient is the [total] zeros with the
    cotangent at ``base``. Needs :func:`opaque_view_eligible`."""
    _check(flat.dim() == 1 and flat.dtype == torch.float32,
           "opaque_view_from: flat must be a 1-D float32 tensor")
    _check(opaque_view_eligible(flat.shape[0], base, numel),
           f"opaque_view_from: [{base}, {base + numel}) of {flat.shape[0]} "
           "is not tile-aligned")
    return _OpaqueViewFrom.apply(flat, base, numel)
