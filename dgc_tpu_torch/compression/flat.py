"""Flat (bucketed) execution engine for DGC, on PyTorch.

Counterpart of ``dgc_tpu/compression/flat.py``. The whole gradient, the
error-feedback memory and the optimizer state live in a few flat buffers
with the reference's exact layout (:class:`ParamLayout`): compressed
tensors first, one tensor per row of a size bucket, then a gap whose first
slot is the always-zero scatter sentinel, then the dense tail (biases,
BatchNorm). Buffers are therefore interchangeable with the JAX package's.

:class:`FlatDGCEngine` runs the reference's plain-f32-wire pipeline, split
into the per-worker halves around the collective so one process can drive
W workers in lockstep (:class:`dgc_tpu_torch.parallel.comm.LocalComm`):

* :meth:`FlatDGCEngine.compress` — bit-masked momentum compensate (the
  compensate kernel, in place) and sampled top-k sparsification of every
  bucket into a fixed-size ``(values, indices)`` payload;
* ``comm.all_gather`` of values and indices, ``comm.all_reduce`` of the
  dense tail;
* :meth:`FlatDGCEngine.apply` — the apply kernel (scatter-add of
  ``wire / W`` and this worker's transmit record), then the dense tail's
  non-accumulating correction.

Three selection paths, chosen per bucket exactly as the reference chooses
them (a single-tensor bucket wider than 8M columns is first split into
segment rows of about 4M, :func:`_segment_rows`, as VGG-16's fc1 and fc2):

* the 2-D path: top-k over the [R, cols] importance view (|v|, row tails
  -1), thresholds from lane-block samples of that view;
* the segment path (:meth:`FlatDGCEngine._use_seg_kernel`, ImageNet-scale
  buckets at small ratios): the compensate pass also emits, per (row,
  lane, 256-block segment), the two largest-|v| candidates
  (:func:`kernels.compensate_bits_cands`), and the bucket selects its
  top ``max_sel`` among those; thresholds come from the same lane blocks,
  read raw from the flat buffer (:meth:`FlatDGCEngine._sample_rows_3d`);
* the 3-D fallback (:meth:`FlatDGCEngine._sparsify_bucket_3d`: a bucket
  of 3M+ columns off the segment path, VGG-16's fc buckets through the
  warm-up): the same thresholds, then per-(row, lane) candidates over
  the row's 128-lane blocks and the top ``max_sel`` among them.

**One deliberate difference from the TPU path.** The JAX engine selects
with ``lax.approx_max_k`` at recall 0.90 wherever k exceeds 128 (or the
exact path would pay XLA's sort), both for the sample threshold and for the
selection. The port selects EXACTLY at every k (:func:`select_topk`: the
top-k kernel up to its k limit, :func:`lax_top_k` above it). On the CPU
``approx_max_k`` lowers to an exact sort, so the port computes what the JAX
package computes there — the semantics its parity tests pin.
The compressor has no ``approx_recall``: the port gates the segment path
as the reference does with ``approx_recall`` set (its default, 0.90).

Two opt-in routes of the reference replace kernels of that pipeline on the
2-D path, chosen per bucket by the reference's on-card gates:

* ``DGCCompressor(fused_select=True)`` (:meth:`FlatDGCEngine.
  _use_fused_select`): the bucket's top-k and value gather become one
  select-and-pack kernel (:func:`kernels.select_pack_rows`);
* ``DGCCompressor(megakernel=True)``, or ``DGC_MEGAKERNEL=1`` in the
  environment (:meth:`FlatDGCEngine._use_megakernel_fwd`): the buckets it
  owns (``_mk_fwd_ids``) compensate and select in one kernel per bucket
  (:func:`kernels.dgc_forward_rows`), the spans between them compensate
  through the compensate kernel on windows of the transmit record
  (:func:`kernels.realign_bits`), and the segment-path buckets compute
  their own candidates (:func:`kernels.seg_top2_candidates`). The apply
  is the apply kernel, as on the default route.

Both give the default route's payload, memory and exchanged gradient
bitwise, except that a selected -0.0 travels as +0.0 (as in the
reference's Pallas kernels), which changes no sum.

Random phases: strided sampling draws one uniform per (bucket, stride
group), the uniform sampler (``strided_sample=False``) one per (row,
sample slot). The JAX engine draws them from ``fold_in(fold_in(key,
bucket), group)`` and ``fold_in(key, bucket)``; the port draws them on
the host from an explicit ``torch.Generator`` (:meth:`FlatDGCEngine.
draw_phases`) — host numbers slice the buffers without a device sync —
and :meth:`sparsify` takes them as an argument, so a test can pass in the
JAX-drawn values.

Threshold adaptation: with ``resample=True`` (the default) the ladder
choice is derived from the selection's own top-k; with ``resample=False``
:func:`_batched_adapt` runs the reference's bounded raise-or-lower loop,
each round's per-row count on the ladder-counts kernel at one level.

At ``compress_ratio >= 1`` (a dense warm-up epoch) or with nothing
compressed, :meth:`FlatDGCEngine.exchange` is all dense: one all-reduce,
the average, and the non-accumulating correction of the whole buffer
(:meth:`FlatDGCEngine._exchange_dense`), which first folds a pending
transmit record into the memory. The memory's ``gradient_clipping``
clips the local compressed block before the compensate and the averaged
dense part before its correction (:meth:`FlatDGCEngine._clip_block`).
:class:`FlatDenseExchange` is the dense baseline compressors' engine.

The engine's threshold ladder is also kept as a full scan,
:func:`_ladder_adapt` (the ladder-counts kernel, :func:`kernels.
ladder_counts`), the oracle the from-top-k derivation is held against; as
in the reference, :meth:`FlatDGCEngine.sparsify` does not call it.

Not ported yet to the engine (``ROADMAP.md``; it raises where a flag asks
for one): planner regimes and dense-planned buckets, gossip, the adaptive
send fraction, checksums, the int8/int4/fp16 and packed-index wires and
the bf16 error-feedback state (the per-tensor path has the int8 and fp16
wires and the bf16 state), Adasum, the two-tier exchange and telemetry.
"""

import math
import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from dgc_tpu_torch.ops import kernels
from dgc_tpu_torch.utils.pytree import named_flatten

__all__ = ["ParamLayout", "FlatDGCEngine", "FlatDenseExchange",
           "ladder_cols", "lax_top_k", "select_topk", "lane_quota",
           "lane_candidates", "ROUTES"]

#: block alignment of the compressed-block boundary and the buffer tail
_ALIGN = 16 * 128
_LANE = 128
#: the reference's ladder-kernel column chunk, which fixes row widths
_LADDER_COL_CHUNK = 128 * 1024
#: single-tensor rows wider than this are split into segment rows of at
#: least ``_SPLIT_TARGET`` columns (:func:`_segment_rows`; VGG-16's fc1 and
#: fc2)
_SPLIT_COLS = 8 * 1024 * 1024
_SPLIT_TARGET = 4 * 1024 * 1024
#: maximum payload growth a bucket may pay to make its payload the full
#: [R, max_sel] selection grid (identity ``tight`` map)
_PAD_PAYLOAD_MAX_FRAC = 0.02
#: the reference's minimum row width for its 3-D selection path
_SEL3D_MIN_COLS = 3 * 1024 * 1024
#: the 3-D fallback's per-(row, lane) candidate quota as a multiple of the
#: mean ``max_sel / 128``
_SEL3D_MARGIN = 2
#: the reference's on-card bound on ``max_sel * cols`` of a fused select
_FUSED_SELECT_MAX_WORK = 16_000_000
#: widest row the forward megakernel takes (the reference's VMEM bound)
_MK_MAX_COLS = 128 * 1024

#: calls of the :func:`lax_top_k` route and of the 3-D fallback's bucket
#: selection (:meth:`FlatDGCEngine._sparsify_bucket_3d`) since the last
#: reset (on any device); the kernels' own launches are in
#: ``kernels.LAUNCHES``
ROUTES = {"lax_top_k": 0, "sel3d": 0}


def _round_up(n: int, align: int) -> int:
    return -(-n // align) * align


def lax_top_k(x: torch.Tensor, k: int):
    """Counterpart of ``jax.lax.top_k`` over the rows of a [R, cols] f32
    tensor (a PyTorch call, as the reference's is an XLA op): a stable
    descending sort, then the first k. Returns ``(values [R, k], columns
    [R, k] int32)``, ties to the lower column."""
    ROUTES["lax_top_k"] += 1
    v, i = torch.sort(x, dim=1, descending=True, stable=True)
    return v[:, :k], i[:, :k].to(torch.int32)


def select_topk(x: torch.Tensor, k: int):
    """Exact per-row top-k, routed by k before the call: the top-k kernel
    where its shared-memory sort holds k, :func:`lax_top_k` above that (the
    warm-up selections of ImageNet-scale buckets)."""
    if k <= kernels.TOPK_MAX_K:
        return kernels.topk_rows(x, k)
    return lax_top_k(x, k)


def lane_quota(cols: int, max_sel: int) -> int:
    """The 3-D fallback's candidates a (row, lane): ``min(nb, ceil(2
    max_sel / 128))`` over a row of ``nb = cols / 128`` blocks."""
    return min(cols // _LANE, -(-_SEL3D_MARGIN * max_sel // _LANE))


def lane_candidates(block: torch.Tensor, kp: int):
    """Per-(row, lane) candidates of a [R, nb * 128] block: for each of
    the 128 lanes of each row, the ``kp`` largest |v| over the row's nb
    128-lane blocks and their block ids, ``(values, blocks)`` each laid out
    [R, kp, 128] and flattened to [R, kp * 128] (the reference's
    ``approx_max_k(|v3|, kp, reduction_dimension=1)`` layout). Computed as
    :func:`select_topk` over the rows of the transposed [R * 128, nb] view,
    so equal magnitudes go to the lower block."""
    R, cols = block.shape
    nb = cols // _LANE
    imp_t = block.view(R, nb, _LANE).abs().transpose(1, 2).reshape(
        R * _LANE, nb).contiguous()
    cv, cb = select_topk(imp_t, kp)                         # [R * 128, kp]
    del imp_t

    def relayout(t):
        return t.view(R, _LANE, kp).transpose(1, 2).reshape(
            R, kp * _LANE).contiguous()
    return relayout(cv), relayout(cb)


def ladder_cols(max_n: int) -> int:
    """Row width of a bucket whose widest tensor has ``max_n`` elements:
    lane-aligned, and a multiple of 128K once wider than that (the
    reference's layout, fixed by its ladder kernel's column chunk)."""
    cols = _round_up(max_n, _LANE)
    if cols > _LADDER_COL_CHUNK:
        cols = _round_up(cols, _LADDER_COL_CHUNK)
    return cols


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(int(s) for s in getattr(leaf, "shape", leaf))


class _BucketGeom(NamedTuple):
    """Ratio-independent geometry of one size bucket: a [rows, cols] tile
    at ``base``; tensor ``names[r]`` occupies row r."""
    names: Tuple[str, ...]
    base: int
    rows: int
    cols: int


class ParamLayout:
    """Static flat-buffer layout over a nested dict of parameters (leaves
    are tensors, arrays or shapes), bitwise the reference's: size-bucketed
    row tiles of the compressed tensors, the sentinel gap, the dense tail.
    Depends only on shapes and the compressed-name set, never on the
    compress ratio."""

    #: bucket-count / padding exchange rate of the partition DP
    FLOOR_SLOTS = 300_000

    def __init__(self, tree, compressed_names: Sequence[str] = ()):
        named = named_flatten(tree)
        cset = set(compressed_names)
        compressed = [n for n in named if n in cset]
        dense = [n for n in named if n not in cset]
        self.shapes = {n: _shape(named[n]) for n in named}
        self.sizes = {n: int(math.prod(self.shapes[n])) for n in named}
        self.num_params = sum(self.sizes.values())

        self.buckets: List[_BucketGeom] = []
        self.offsets: Dict[str, int] = {}
        off = 0
        for group in self._group_by_size(compressed):
            cols = ladder_cols(max(self.sizes[n] for n in group))
            self.buckets.append(_BucketGeom(tuple(group), off, len(group),
                                            cols))
            for r, n in enumerate(group):
                self.offsets[n] = off + r * cols
            off += len(group) * cols
        self.compressed_names = [n for g in self.buckets for n in g.names]
        self.dense_names = dense
        self.names: List[str] = self.compressed_names + dense
        #: end of the compressed storage; [t_data, t_compressed) is the gap
        self.t_data = off
        self.t_compressed = _round_up(off + 1, _ALIGN) if compressed else 0
        #: scatter sentinel: always a structural-zero slot
        self.sentinel = self.t_data
        off = self.t_compressed
        for n in dense:
            self.offsets[n] = off
            off += self.sizes[n]
        self.p_data_end = off
        self.total = _round_up(off, _ALIGN) if off else 0
        if self.total >= 2 ** 31:
            raise ValueError("layouts of 2**31 slots or more need the int64 "
                             "index wire, which is not ported "
                             "(ROADMAP.md queue 1 item 7)")

    def _group_by_size(self, compressed: Sequence[str]) -> List[List[str]]:
        """Partition the size-sorted tensors into contiguous buckets by the
        reference's exact DP minimising ``FLOOR_SLOTS * #buckets + padded
        slots``."""
        names = sorted(compressed, key=lambda n: -self.sizes[n])
        n = len(names)
        if n == 0:
            return []
        sizes = [self.sizes[x] for x in names]
        best = [float("inf")] * (n + 1)
        best[n] = 0.0
        cut = [n] * (n + 1)
        for i in range(n - 1, -1, -1):
            cols = ladder_cols(sizes[i])
            pad = 0
            for j in range(i, n):
                pad += cols - sizes[j]
                c = self.FLOOR_SLOTS + pad + best[j + 1]
                if c < best[i]:
                    best[i] = c
                    cut[i] = j + 1
        groups, i = [], 0
        while i < n:
            groups.append(names[i:cut[i]])
            i = cut[i]
        return groups

    @classmethod
    def for_compressor(cls, tree, compressor) -> "ParamLayout":
        """The layout whose compressed names are the compressor's
        initialised attributes (none for a dense compressor)."""
        return cls(tree, list(compressor.attributes))

    def flatten(self, tree, device=None) -> torch.Tensor:
        """Nested dict (or ``{name: leaf}``) of tensors/arrays -> flat
        [total] f32, with structural zeros in row tails and gaps."""
        named = named_flatten(tree)
        flat = torch.zeros(self.total, dtype=torch.float32, device=device)
        for n in self.names:
            o = self.offsets[n]
            leaf = named[n]
            if not torch.is_tensor(leaf):
                leaf = torch.from_numpy(np.array(leaf, np.float32))
            flat[o:o + self.sizes[n]] = leaf.reshape(-1)
        return flat

    def mask_vector(self, predicate, device=None) -> torch.Tensor:
        """[total] 0/1 f32 mask from a per-name predicate (e.g. the
        ``optimize_bn_separately`` weight-decay split); gaps are 0."""
        out = torch.zeros(self.total, dtype=torch.float32, device=device)
        for n in self.names:
            if predicate(n):
                out[self.offsets[n]:self.offsets[n] + self.sizes[n]] = 1.0
        return out

    def convert_hoist_risky(self) -> frozenset:
        """The reference's set of compressed tensors whose view of the flat
        buffer it binds through an opaque copy: conv/dense weights whose
        base offset and the buffer total are both multiples of
        ``prod(shape[1:])``, in buffers at least 4x the tensor."""
        out = set()
        for n in self.compressed_names:
            shape = self.shapes[n]
            if len(shape) < 2 or self.total < 4 * self.sizes[n]:
                continue
            trailing = int(np.prod(shape[1:], dtype=np.int64))
            if (trailing > 1 and self.offsets[n] % trailing == 0
                    and self.total % trailing == 0):
                out.add(n)
        return frozenset(out)

    def unflatten_named(self, flat: torch.Tensor,
                        keep_1d: bool = False) -> Dict[str, torch.Tensor]:
        """Flat [total] -> ``{name: view}`` in layout order (views share
        the flat buffer's storage)."""
        out = {}
        for n in self.names:
            piece = flat[self.offsets[n]:self.offsets[n] + self.sizes[n]]
            out[n] = piece if keep_1d else piece.view(self.shapes[n])
        return out


class _Bucket(NamedTuple):
    """Ratio-dependent sparsification attributes of one layout bucket (all
    static, host-side)."""
    base: int
    rows: int
    cols: int
    row_offsets: np.ndarray    # [R] global offset of each tensor row
    numels: np.ndarray         # [R]
    strides: np.ndarray        # [R] sampling stride
    num_samples: np.ndarray    # [R]
    max_s: int
    topk_samples: np.ndarray   # [R]
    max_k: int
    num_selects: np.ndarray    # [R]
    max_sel: int
    adapt: np.ndarray          # [R] bool: run threshold adaptation
    exact: bool                # every row samples its whole tensor
    tight: np.ndarray          # [payload] positions into the [R*max_sel] grid
    payload: int
    #: runs of consecutive rows sharing a sample stride: (r0, r1, stride, n)
    stride_groups: Tuple[Tuple[int, int, int, int], ...]


def _segment_rows(attrs, base: int, cols: int, sample_ratio: float,
                  compress_ratio: float):
    """Split one giant tensor row into S segment rows (the reference's
    ``_segment_rows``): S doubles while the halves stay at least
    :data:`_SPLIT_TARGET` wide and each keeps a select. The tensor's
    ``num_selects`` is split in proportion to each segment's elements,
    Python's ``round`` on the running remainder (the sum stays exact), and
    each segment samples at its own geometry. Returns ``(seg_cols, rows)``
    with the row tuples of :func:`_bucket_from_rows`."""
    # dgc.py imports this module
    from dgc_tpu_torch.compression.dgc import sampling_geometry
    S = 1
    while (cols % (2 * S) == 0 and cols // (2 * S) >= _SPLIT_TARGET
           and attrs.num_selects >= 2 * S):
        S *= 2
    seg_cols = cols // S
    rows = []
    rem_sel, rem_numel = attrs.num_selects, attrs.numel
    for s in range(S):
        numel_s = min(seg_cols, attrs.numel - s * seg_cols)
        if numel_s <= 0:
            raise ValueError(f"segment {s} of {seg_cols} columns is empty "
                             f"({attrs.numel} elements)")
        ns = (rem_sel if s == S - 1
              else int(round(rem_sel * numel_s / rem_numel)))
        ns = max(1, min(ns, rem_sel - (S - 1 - s)))
        rem_sel -= ns
        rem_numel -= numel_s
        num_samples, stride = sampling_geometry(numel_s, sample_ratio,
                                                compress_ratio)
        topk = max(1, int(math.ceil(num_samples * compress_ratio)))
        rows.append((base + s * seg_cols, numel_s, stride, num_samples,
                     topk, ns))
    return seg_cols, rows


def _build_buckets(attributes, layout: ParamLayout,
                   compressor) -> List[_Bucket]:
    """Per-ratio sparsification attributes of each layout bucket; a
    single-tensor bucket wider than :data:`_SPLIT_COLS` with at least two
    selects becomes the segment rows of :func:`_segment_rows` where that
    makes more than one row."""
    buckets = []
    for g in layout.buckets:
        if (len(g.names) == 1 and g.cols > _SPLIT_COLS
                and attributes[g.names[0]].num_selects >= 2):
            seg_cols, rows = _segment_rows(
                attributes[g.names[0]], g.base, g.cols,
                compressor.sample_ratio, compressor.compress_ratio)
            if len(rows) > 1:
                buckets.append(_bucket_from_rows(g.base, seg_cols, rows))
                continue
        rows = [(layout.offsets[n], a.numel, a.sample_stride,
                 a.num_samples, a.top_k_samples, a.num_selects)
                for n, a in ((n, attributes[n]) for n in g.names)]
        buckets.append(_bucket_from_rows(g.base, g.cols, rows))
    return buckets


def _bucket_from_rows(base: int, cols: int, rows) -> _Bucket:
    """Assemble a :class:`_Bucket` from per-row tuples ``(row_off, numel,
    stride, num_samples, topk_samples, num_selects)``. The payload is the
    tight concatenation of each row's ``num_selects`` slots, or the whole
    [R, max_sel] grid when that grows the wire by at most 2%."""
    cols_in = list(zip(*rows))
    offs = np.array(cols_in[0], np.int64)
    numels, strides, samples, topks, selects = (
        np.array(c, np.int32) for c in cols_in[1:])
    max_sel = int(selects.max())
    n_rows = len(rows)
    padded = n_rows * max_sel
    if padded - int(selects.sum()) <= (
            _PAD_PAYLOAD_MAX_FRAC * int(selects.sum())):
        tight = np.arange(padded, dtype=np.int64)
    else:
        tight = np.concatenate([
            np.arange(r * max_sel, r * max_sel + k, dtype=np.int64)
            for r, k in enumerate(selects)])
    stride_groups = []
    r0 = 0
    for r in range(1, n_rows + 1):
        if r == n_rows or strides[r] != strides[r0]:
            stride_groups.append((r0, r, int(strides[r0]),
                                  int(samples[r0:r].max())))
            r0 = r
    return _Bucket(
        base=base, rows=n_rows, cols=cols, row_offsets=offs, numels=numels,
        strides=strides, num_samples=samples, max_s=int(samples.max()),
        topk_samples=topks, max_k=int(topks.max()), num_selects=selects,
        max_sel=max_sel, adapt=numels > samples,
        exact=bool((samples >= numels).all()), tight=tight,
        payload=int(tight.shape[0]), stride_groups=tuple(stride_groups))


def _f32_floor_mul(u: float, m: int) -> int:
    """``floor(u * m)`` in f32, as the reference computes a sample phase."""
    return int(np.floor(np.float32(u) * np.float32(m)))


def _pow_ladder(lower: float, levels: int) -> np.ndarray:
    """``lower ** i`` for i < ``levels`` as XLA's f32 pow computes it:
    ``float32(lower)`` raised in double, rounded once to f32 (the ladder
    of the adaptation's pick and of its from-top-k counts; the ladder
    kernel's own levels round ``lower ** i`` from the double ``lower``,
    :func:`kernels.ladder_factors`)."""
    return np.array([np.float64(np.float32(lower)) ** i
                     for i in range(levels)], np.float32)


def _topk_counts(top_scores: torch.Tensor, thr: torch.Tensor,
                 ladder: torch.Tensor) -> torch.Tensor:
    """Per-row counts of the sorted selection top-k at each level ``thr *
    ladder[i]``."""
    t = thr[:, None] * ladder[None, :]
    return (top_scores[:, :, None] >= t[:, None, :]).sum(dim=1)


def _ladder_choice(counts, thr, ladder, lo, adapt, max_iters: int):
    """The stopping rule over per-level pass counts: the first level whose
    count reaches ``lo`` ([R, 1] f32), else the last; ``thr * ladder[i*]``
    where ``adapt``, else ``thr``."""
    passing = counts.to(torch.float32) >= lo
    first = passing.to(torch.int8).argmax(dim=1)
    i_star = torch.where(passing.any(dim=1), first, max_iters)
    return torch.where(adapt, thr * ladder[i_star], thr)


def _ladder_pick(counts, thr, num_selects, adapt_mask, lower: float,
                 max_iters: int):
    """Closed-form ladder stopping rule from per-level pass counts (the
    reference's ``_ladder_pick``): first i with count >= ``lower *
    num_selects`` (f32 [R]), else ``max_iters``."""
    ladder = torch.from_numpy(_pow_ladder(lower, max_iters + 1)).to(
        thr.device)
    lo = (num_selects.to(torch.float32)
          * torch.tensor(lower, dtype=torch.float32,
                         device=thr.device))[:, None]
    return _ladder_choice(counts, thr, ladder, lo, adapt_mask, max_iters)


def _ladder_adapt(imp_rows, thr, num_selects, adapt_mask, lower: float,
                  max_iters: int):
    """One-pass threshold adaptation for ``resample=True`` over the full
    [R, cols] importance view: every ladder level's count in one read
    (:func:`kernels.ladder_counts`), then :func:`_ladder_pick`. Kept as
    the reference keeps it: the full-scan oracle that the engine's
    from-top-k derivation (:func:`_ladder_adapt_from_topk`) is held
    against; :meth:`FlatDGCEngine.sparsify` does not call it."""
    counts = kernels.ladder_counts(imp_rows, thr, lower, max_iters + 1)
    return _ladder_pick(counts, thr, num_selects, adapt_mask, lower,
                        max_iters)


def _ladder_adapt_from_topk(top_scores, thr, num_selects, adapt_mask,
                            lower: float, max_iters: int):
    """The same adaptation with the counts taken over the sorted selection
    top-k (exact for an exact top-k: a count above k only ever needs to
    reach ``lower * num_selects <= k``). The two ladders differ by an ulp
    at some levels, so an importance inside that gap is counted
    differently, as in the reference."""
    ladder = torch.from_numpy(_pow_ladder(lower, max_iters + 1)).to(
        thr.device)
    return _ladder_pick(_topk_counts(top_scores, thr, ladder), thr,
                        num_selects, adapt_mask, lower, max_iters)


def _batched_adapt(imp_rows, thr, lo, hi, adapt, lower: float,
                   upper: float, max_iters: int):
    """Threshold adaptation of every row of a bucket at once without
    ``resample`` (the reference's ``_batched_adapt``, the per-row semantics
    of :func:`dgc_tpu_torch.ops.sparsify.adapt_threshold`): while a row
    that ``adapt`` marks passes fewer than ``lo`` elements its threshold
    is multiplied by ``lower``, and while it passes more than ``hi`` by
    ``upper``; at most ``max_iters`` rounds. Each round's
    count ``#{imp_rows[r] >= thr[r]}`` is the ladder-counts kernel at one
    level (its level 0 factor is exactly 1.0, so it is the reference's
    count bitwise). The reference's ``while_loop`` stops once no row needs
    adapting; this runs all ``max_iters`` rounds with the need mask and no
    host sync: a row that no longer needs adapting keeps its threshold,
    hence its count and its need, so the result is the loop's."""
    lower_t = torch.full((), lower, dtype=thr.dtype, device=thr.device)
    upper_t = torch.full((), upper, dtype=thr.dtype, device=thr.device)
    for _ in range(max_iters):
        c = kernels.ladder_counts(imp_rows, thr, lower, 1)[:, 0].to(
            torch.float32)
        need = (c < lo) | (c > hi)
        nt = torch.where(c < lo, thr * lower_t,
                         torch.where(c > hi, thr * upper_t, thr))
        thr = torch.where(need & adapt, nt, thr)
    return thr


class FlatDGCEngine:
    """The flat DGC pipeline for one compressor + layout pair; rebuilt
    (host-side, cheaply) whenever the warm-up schedule changes the ratio.
    Memory buffers stay valid across rebuilds, also across the change from
    a dense ratio (>= 1) to a compressed one and back."""

    def __init__(self, compressor, layout: ParamLayout):
        self.c = compressor
        self.layout = layout
        self.T = layout.t_compressed
        #: nothing compressed, or a ratio of 1: the all-dense exchange
        self.dense = self.T == 0 or compressor.compress_ratio >= 1.0
        mdt = compressor.memory.dtype
        if mdt not in (None, torch.float32):
            raise ValueError(
                f"the flat engine keeps f32 error-feedback state only, not "
                f"{mdt}: its bf16 memory is ROADMAP.md queue 1 item 7 (the "
                "per-tensor path, DistributedOptimizer.exchange, takes it)")
        for flag in ("int8_values", "fp16_values"):
            if getattr(compressor, flag, False):
                raise ValueError(
                    f"the flat engine carries the plain f32 wire only: "
                    f"{flag} is ROADMAP.md queue 1 item 7 (the per-tensor "
                    "path, DistributedOptimizer.exchange, takes it)")
        self.buckets = ([] if self.dense
                        else _build_buckets(compressor.attributes, layout,
                                            compressor))
        #: per bucket: selects through the segment candidates
        self._seg = [self._use_seg_kernel(b) for b in self.buckets]
        #: per bucket: a wide bucket off the segment path, selecting
        #: through per-(row, lane) candidates (:meth:`_sparsify_bucket_3d`)
        self._sel3d = [self._use_3d(b) and not seg
                       for b, seg in zip(self.buckets, self._seg)]
        #: any bucket takes the segment path: the compensate pass then
        #: emits the candidates itself (the reference's ``_seg_fused``)
        self._seg_fused = any(self._seg)
        #: the forward megakernel's opt-in, read where the reference reads
        #: it: the compressor's flag or ``DGC_MEGAKERNEL=1``
        self._megakernel = bool(
            getattr(compressor, "megakernel", False)
            or os.environ.get("DGC_MEGAKERNEL", "") == "1")
        #: bucket ids whose compensate and selection run the forward
        #: megakernel, in base order
        self._mk_fwd_ids = tuple(bi for bi in range(len(self.buckets))
                                 if self._use_megakernel_fwd(bi))
        sl, off = [], 0
        for b in self.buckets:
            sl.append((off, off + b.payload))
            off += b.payload
        self._payload_slices = tuple(sl)
        #: per-worker wire payload in elements
        self.payload_size = off
        self._ladder_np = _pow_ladder(self.c.compress_lower_bound,
                                      self.c.max_adaptation_iters + 1)
        self._consts: Dict[torch.device, list] = {}

    # -------------------------------------------------------------- #
    # memory                                                         #
    # -------------------------------------------------------------- #

    def init_memory(self, device) -> Dict[str, torch.Tensor]:
        """Error-feedback buffers split at the compressed/dense boundary T,
        plus the packed transmit record of the last step (deferred
        masking: the next compensate zeroes those coordinates on read)."""
        T, P = self.T, self.layout.total

        def z(n, dtype=torch.float32):
            return torch.zeros(n, dtype=dtype, device=device)
        return {"momentums_c": z(T), "velocities_c": z(T),
                "momentums_d": z(P - T), "velocities_d": z(P - T),
                "sent_bits": z(kernels.num_sent_words(T), torch.int32)}

    def memory_full(self, mem) -> Dict[str, torch.Tensor]:
        """Canonical ``{momentums, velocities}`` [P] view with the pending
        transmit mask applied (inspection and checkpoints only)."""
        keep = kernels.keep_from_bits(mem["sent_bits"], self.T)
        vc = mem["velocities_c"] * keep
        mc = mem["momentums_c"]
        if self.c.memory.momentum_masking:
            mc = mc * keep
        return {"momentums": torch.cat([mc, mem["momentums_d"]]),
                "velocities": torch.cat([vc, mem["velocities_d"]])}

    def memory_state_dict(self, mem):
        """Per-name ``{momentums, velocities}`` (the reference's
        checkpoint format, interchangeable with the JAX package's)."""
        full = self.memory_full(mem)
        return {k: self.layout.unflatten_named(v, keep_1d=True)
                for k, v in full.items()}

    def load_memory_state_dict(self, mem, saved):
        """Per-name saved ``{momentums, velocities}`` (tensors or arrays)
        -> flat memory, merging by name over ``mem``'s canonical view; gap
        slots stay zero and nothing is left pending in the record."""
        if saved is None:
            return mem
        lay, T = self.layout, self.T
        full = self.memory_full(mem)
        out = {}
        for key in ("momentums", "velocities"):
            flat = full[key].clone()
            for n in lay.names:
                if n in saved[key]:
                    piece = saved[key][n]
                    if not torch.is_tensor(piece):
                        piece = torch.from_numpy(np.array(piece, np.float32))
                    o = lay.offsets[n]
                    flat[o:o + piece.numel()] = piece.reshape(-1)
            out[key + "_c"] = flat[:T]
            out[key + "_d"] = flat[T:]
        out["sent_bits"] = torch.zeros_like(mem["sent_bits"])
        return out

    def _compensate_acc(self, mem, grad_c: torch.Tensor):
        """Momentum correction + local accumulation over [0, T) with the
        previous step's transmit mask applied on read (in place). Returns
        ``(compensated gradient, candidates or None)``: the gradient IS the
        velocity buffer; where a bucket takes the segment path the fused
        kernel also emits the ``(values, blocks)`` candidates."""
        m = self.c.memory
        args = (grad_c, mem["momentums_c"], mem["velocities_c"],
                mem["sent_bits"], m.momentum, m.nesterov, m.momentum_masking)
        if self._seg_fused:
            _, vec, cv, cb = kernels.compensate_bits_cands(*args)
            return vec, (cv, cb)
        kernels.compensate_bits(*args)
        return mem["velocities_c"], None

    def _compensate_dense(self, mmt: torch.Tensor, grad: torch.Tensor):
        """Non-accumulating correction of an averaged dense block: returns
        ``(corrected gradient, new momentum)``."""
        m = self.c.memory
        if m.nesterov:
            mmt = (mmt + grad) * m.momentum
            return mmt + grad, mmt
        mmt = m.momentum * mmt + grad
        return mmt, mmt

    def _clip_block(self, blocks: Sequence[torch.Tensor],
                    names: Sequence[str], base: int) -> List[torch.Tensor]:
        """The memory's ``gradient_clipping`` of every named tensor in each
        local worker's flat block (``blocks[w]`` starts at flat offset
        ``base``), on copies. A bucket whose tensors are all named clips
        as its [R, cols] row view (row tails are structural zeros, and the
        clip functions are padding-invariant, so per row == per tensor);
        the other names (the dense tail) as a zero-padded [R, C] gather of
        their elements. Each call gets one view per worker, so the global
        clip variants reduce across workers."""
        clip = self.c.memory.gradient_clipping
        lay = self.layout
        blocks = [b.clone() for b in blocks]
        name_set, done = set(names), set()
        for g in lay.buckets:
            if not all(n in name_set for n in g.names):
                continue
            s, n = g.base - base, g.rows * g.cols
            views = [b[s:s + n].view(g.rows, g.cols) for b in blocks]
            for b, c in zip(blocks, clip(views)):
                b[s:s + n] = c.reshape(-1)
            done.update(g.names)
        rest = [n for n in names if n not in done]
        if rest:
            dev = blocks[0].device
            C = max(lay.sizes[n] for n in rest)
            offs = torch.tensor([lay.offsets[n] - base for n in rest],
                                device=dev)[:, None]
            sizes = torch.tensor([lay.sizes[n] for n in rest],
                                 device=dev)[:, None]
            col = torch.arange(C, device=dev)[None, :]
            valid = col < sizes
            pos = torch.where(valid, offs + col, 0)
            rows = clip([torch.where(valid, b[pos], 0.0) for b in blocks])
            for b, r in zip(blocks, rows):
                b[pos[valid]] = r[valid]
        return blocks

    # -------------------------------------------------------------- #
    # sparsify                                                       #
    # -------------------------------------------------------------- #

    def draw_phases(self, gen: torch.Generator) -> list:
        """The sampling draws of every sampled bucket, on the host from
        ``gen``: one uniform per stride group (a list of floats), or for
        the uniform sampler a [rows, max samples] f32 tensor of uniforms;
        nothing for a bucket that samples every element."""
        out = []
        for b in self.buckets:
            if not self.c.strided_sample and not b.exact:
                out.append(torch.rand((b.rows, b.max_s), generator=gen))
                continue
            n = 0 if b.exact else len(b.stride_groups)
            out.append(torch.rand(n, generator=gen).tolist())
        return out

    def _bucket_consts(self, device) -> list:
        """Per-bucket constant tensors on ``device`` (built once)."""
        consts = self._consts.get(device)
        if consts is not None:
            return consts
        consts = []
        for b, seg, sel3d in zip(self.buckets, self._seg, self._sel3d):
            def t(a, dtype):
                return torch.as_tensor(np.asarray(a), dtype=dtype,
                                       device=device)
            col = torch.arange(b.cols, device=device)
            slot = torch.arange(b.max_sel, device=device)
            c = {
                "in_row": col[None, :] < t(b.numels, torch.int64)[:, None],
                "row_off": t(b.row_offsets, torch.int32)[:, None],
                "slot_ok": slot[None, :] < t(b.num_selects,
                                             torch.int64)[:, None],
                "k_idx": t(b.topk_samples - 1, torch.int64)[:, None],
                "tight": (None if b.payload == b.rows * b.max_sel
                          else t(b.tight, torch.int64)),
                "ladder": t(self._ladder_np, torch.float32),
                "lo": t(np.float32(self.c.compress_lower_bound)
                        * b.num_selects.astype(np.float32),
                        torch.float32)[:, None],
                "hi": t(np.float32(self.c.compress_upper_bound)
                        * b.num_selects.astype(np.float32), torch.float32),
                "adapt": t(b.adapt, torch.bool),
                "steps": [torch.arange(n, device=device) * stride
                          for (_, _, stride, n) in b.stride_groups],
                "numels_r": t(b.numels, torch.int32),
                "s_idx": torch.arange(b.max_s, device=device)[None, :],
                "s_valid": (torch.arange(b.max_s, device=device)[None, :]
                            < t(b.num_samples, torch.int64)[:, None]),
                "s_exact": t(b.num_samples >= b.numels, torch.bool)[:, None],
                "blocks3d": ([self._sample_blocks_3d(b, gi, device)
                              for gi in range(len(b.stride_groups))]
                             if seg or sel3d else None),
            }
            c["numels"] = c["numels_r"][:, None]
            consts.append(c)
        self._consts[device] = consts
        return consts

    # -------------------------------------------------------------- #
    # the segment path                                               #
    # -------------------------------------------------------------- #

    def _sampled_strided_ok(self, b: _Bucket) -> bool:
        """The reference's shared preconditions of its layout-free
        selection paths (with ``approx_recall`` set, as it always is for
        the port): every row genuinely sampled with a stride, resample
        adaptation."""
        return (not b.exact and self.c.strided_sample and self.c.resample
                and bool((b.strides > 1).all())
                and bool((b.num_samples >= 128).all()))

    def _use_3d(self, b: _Bucket) -> bool:
        """The reference's gate of its 3-D selection path (wide buckets)."""
        return (self._sampled_strided_ok(b) and b.cols % _LANE == 0
                and b.cols >= _SEL3D_MIN_COLS)

    def _use_seg_kernel(self, b: _Bucket) -> bool:
        """Whether a bucket selects through the segment candidates: the
        sampled+strided preconditions, enough (lane, segment) cells that
        per-cell top-2 captures the top set (cells >= 3 max_sel), and a
        segment-aligned region (the reference's gate)."""
        cells = (b.cols // _LANE // kernels.SEG_BLOCKS) * _LANE
        return (self._sampled_strided_ok(b)
                and cells >= 3 * b.max_sel
                and kernels.seg_top2_eligible(self.T // _LANE, b.base,
                                              b.cols, b.rows))

    def _use_fused_select(self, b: _Bucket) -> bool:
        """Whether a 2-D bucket selects through the select-and-pack kernel:
        the ``fused_select`` opt-in, k within the kernel's bound and the
        reference's on-card work bound."""
        return (getattr(self.c, "fused_select", False)
                and b.max_sel <= kernels.MR_MAX_K
                and b.max_sel * b.cols <= _FUSED_SELECT_MAX_WORK)

    def _use_megakernel_fwd(self, bi: int) -> bool:
        """Whether bucket ``bi`` compensates and selects through the forward
        megakernel (the reference's on-card gate): the megakernel opt-in, a
        2-D bucket (not segment-path, not 3-D), ``0 < max_sel <= min(cols,
        MR_MAX_K)``, lane-aligned base and width, rows of at most 128K
        columns. The port's state and gradients are f32 throughout."""
        b = self.buckets[bi]
        return (self._megakernel and not self._seg[bi] and not self._use_3d(b)
                and 0 < b.max_sel <= min(b.cols, kernels.MR_MAX_K)
                and b.base % _LANE == 0 and b.cols % _LANE == 0
                and b.cols <= _MK_MAX_COLS)

    def _sample_blocks_3d(self, b: _Bucket, gi: int, device):
        """``(ids, sb)``: the [Rg, nb] ids of the 128-lane blocks that
        stride group ``gi`` samples at phase 0, in the [T/128, 128] view of
        the flat buffer (block j of row r is ``base/128 + r * cols/128 +
        j * sb``), and the block stride ``sb`` the phase ranges over."""
        r0, r1, stride, n = b.stride_groups[gi]
        nb_s = -(-n // _LANE)
        sb = max(1, (n * stride) // (nb_s * _LANE))
        rows = torch.arange(r0, r1, device=device)[:, None]
        return (b.base // _LANE + rows * (b.cols // _LANE)
                + torch.arange(nb_s, device=device)[None, :] * sb), sb

    def _sample_rows_3d(self, b: _Bucket, c, v2d: torch.Tensor,
                        phases: Sequence[float]) -> torch.Tensor:
        """Per-row threshold samples of a segment-path bucket: the lane
        blocks :meth:`_sample_rows` takes, gathered from the [T/128, 128]
        view of the flat buffer and |.| taken after the gather, so
        structural-zero row tails read 0 (not -1); the phase is not
        clamped (the reference's ``_sample_rows_3d``). Pad slots read -1."""
        width = max(ids.shape[1] for ids, _ in c["blocks3d"]) * _LANE
        parts = []
        for (ids, sb), u in zip(c["blocks3d"], phases):
            blocks = ids + _f32_floor_mul(u, sb)
            smp = v2d[blocks.reshape(-1)].abs().reshape(ids.shape[0], -1)
            if smp.shape[1] < width:
                smp = torch.cat([smp, smp.new_full(
                    (ids.shape[0], width - smp.shape[1]), -1.0)], dim=1)
            parts.append(smp)
        return torch.cat(parts) if len(parts) > 1 else parts[0]

    def _sparsify_bucket_seg(self, vec_c: torch.Tensor, b: _Bucket, c,
                             phases: Sequence[float], cands):
        """Selection over one segment-path bucket (the reference's
        ``_sparsify_bucket_3d`` seg branch): sampled threshold, top
        ``max_sel`` among the per-(row, lane, segment) top-2 candidates,
        ladder adaptation from that top-k, validity ``score >= thr & slot <
        num_selects & column < numel``. Returns ``(values [R, max_sel],
        global indices [R, max_sel])``."""
        R, cols = b.rows, b.cols
        samples = self._sample_rows_3d(b, c, vec_c.view(-1, _LANE), phases)
        thr = select_topk(samples, b.max_k)[0].gather(1, c["k_idx"])[:, 0]
        if cands is not None:
            # this bucket's contiguous range of the compensate pass's
            # candidates
            cv_all, cb_all = cands
            span = kernels.SEG_SPAN
            if cv_all.shape[0] * span < b.base + R * cols:
                raise ValueError(
                    f"{cv_all.shape[0]} candidate segments do not cover the "
                    f"bucket [{R}, {cols}] at {b.base}")
            s0, nsr = b.base // span, cols // span
            cvals = cv_all[s0:s0 + R * nsr].reshape(R, -1)
            ccols = kernels.seg_cols_local(
                cb_all[s0:s0 + R * nsr].view(R, nsr, 2, _LANE))
        else:
            cvals, ccols = kernels.seg_top2_candidates(vec_c, b.base, R, cols)
        top_scores, c2 = select_topk(cvals.abs(), b.max_sel)
        # one gather of the (value bits, column) pairs
        packed = torch.stack([cvals.view(torch.int32), ccols], dim=-1)
        sel = packed.gather(1, c2.long()[:, :, None].expand(-1, -1, 2))
        sel_vals = sel[:, :, 0].contiguous().view(torch.float32)
        cols_sel = sel[:, :, 1]
        if self.c.max_adaptation_iters > 0 and b.adapt.any():
            thr = self._ladder_adapt_from_topk(c, top_scores, thr)
        valid = ((top_scores >= thr[:, None]) & c["slot_ok"]
                 & (cols_sel < c["numels"]))
        gidx = torch.where(valid, c["row_off"] + cols_sel,
                           self.layout.sentinel)
        return torch.where(valid, sel_vals, 0.0), gidx

    def _sparsify_bucket_3d(self, vec_c: torch.Tensor, b: _Bucket, c,
                            phases: Sequence[float]):
        """Selection over one wide bucket off the segment path (the
        reference's ``_sparsify_bucket_3d`` fallback): the threshold from
        the lane-block samples of :meth:`_sample_rows_3d`; per (row, lane)
        the top ``kp = min(nb, ceil(2 max_sel / 128))`` of |v| over the
        row's nb 128-lane blocks, laid out [R, kp, 128] and flattened to
        [R, kp * 128] (the reference's layout, which decides ties in the
        next step); the top ``max_sel`` of those, column = block * 128 +
        lane; the ladder adaptation from that top-k; validity ``score >=
        thr & slot < num_selects & column < numel``; the values gathered
        from the bucket. The candidates run as the top-kp of each row of
        the transposed [R * 128, nb] view, so equal magnitudes in one
        (row, lane) column go to the lower block (the reference's CPU
        ``approx_max_k`` orders such ties its own way). Returns
        ``(values [R, max_sel], global indices [R, max_sel])``."""
        ROUTES["sel3d"] += 1
        R, cols = b.rows, b.cols
        samples = self._sample_rows_3d(b, c, vec_c.view(-1, _LANE), phases)
        thr = select_topk(samples, b.max_k)[0].gather(1, c["k_idx"])[:, 0]
        block = vec_c[b.base:b.base + R * cols].view(R, cols)
        cand, blk = lane_candidates(block, lane_quota(cols, b.max_sel))
        top_scores, c2 = select_topk(cand, b.max_sel)
        c2 = c2.long()
        cols_sel = blk.gather(1, c2) * _LANE + (c2 % _LANE).to(torch.int32)
        if self.c.max_adaptation_iters > 0 and b.adapt.any():
            thr = self._ladder_adapt_from_topk(c, top_scores, thr)
        valid = ((top_scores >= thr[:, None]) & c["slot_ok"]
                 & (cols_sel < c["numels"]))
        gidx = torch.where(valid, c["row_off"] + cols_sel,
                           self.layout.sentinel)
        # the columns lie inside the bucket's rows, so the gather needs
        # no sentinel slot
        return torch.where(valid, block.gather(1, cols_sel.long()),
                           0.0), gidx

    def _sample_rows(self, b: _Bucket, c, imp_rows: torch.Tensor,
                     phases) -> torch.Tensor:
        """Per-row threshold samples of one bucket: 128-lane blocks at the
        tensor's sampling rate with one random phase per stride group (the
        reference's lane-block strided sampling), or without
        ``strided_sample`` the uniform positions ``floor(u * numel)``
        (``phases`` the [R, max samples] uniforms; a row that samples its
        whole tensor takes every element once); pad slots read -1."""
        if not self.c.strided_sample:
            u = phases.to(imp_rows.device)
            numels = c["numels"]
            pos = torch.floor(u * numels.to(torch.float32)).to(torch.int64)
            pos = torch.where(c["s_exact"],
                              torch.minimum(c["s_idx"], numels - 1), pos)
            smp = imp_rows.gather(1, torch.clamp(pos, max=b.cols - 1))
            return torch.where(c["s_valid"], smp, -1.0)
        L = _LANE
        widths = [n if (stride == 1 or n < L) else -(-n // L) * L
                  for (_, _, stride, n) in b.stride_groups]
        width = max(widths)
        parts = []
        for gi, (r0, r1, stride, n) in enumerate(b.stride_groups):
            Rg = r1 - r0
            nb = -(-n // L)
            if stride == 1:
                smp = imp_rows[r0:r1, :n]
            elif n < L:
                pos = torch.clamp(c["steps"][gi]
                                  + _f32_floor_mul(phases[gi], stride),
                                  max=b.cols - 1)
                smp = imp_rows[r0:r1, pos]
            else:
                sb = max(1, (n * stride) // (nb * L))
                # a start past the end clamps, as lax.dynamic_slice does
                phase = min(_f32_floor_mul(phases[gi], sb), sb - 1)
                smp = imp_rows[r0:r1, :nb * sb * L].reshape(
                    Rg, nb, sb, L)[:, :, phase, :].reshape(Rg, nb * L)
            if smp.shape[1] < width:
                smp = torch.cat([smp, smp.new_full((Rg, width - smp.shape[1]),
                                                   -1.0)], dim=1)
            parts.append(smp)
        return torch.cat(parts) if len(parts) > 1 else parts[0]

    def _ladder_adapt_from_topk(self, c, top_scores, thr):
        """Threshold adaptation (``resample=True``): the first ladder level
        ``thr * lower**i`` that at least ``lower * num_selects`` selections
        pass, else the last — counted over the sorted selection top-k,
        which is exact (see the reference's derivation)."""
        return _ladder_choice(_topk_counts(top_scores, thr, c["ladder"]),
                              thr, c["ladder"], c["lo"], c["adapt"],
                              self.c.max_adaptation_iters)

    def sparsify(self, vec_c: torch.Tensor, phases: Sequence[Sequence[float]],
                 seg_cands: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 fwd_sel: Optional[Dict[int, Tuple[torch.Tensor, ...]]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sampled top-k selection over the compressed block [T]. Returns
        ``(values f32, indices int32)`` of length ``payload_size``;
        invalid slots carry ``(0.0, sentinel)``. ``seg_cands`` are the
        compensate pass's candidates (:func:`kernels.compensate_bits_cands`);
        without them a segment-path bucket computes its own
        (:func:`kernels.seg_top2_candidates`). ``fwd_sel`` maps a bucket id
        to the ``(scores, values, columns)`` the forward megakernel already
        selected (:meth:`_compensate_megakernel`)."""
        consts = self._bucket_consts(vec_c.device)
        out_v, out_i = [], []
        for bi, (b, c) in enumerate(zip(self.buckets, consts)):
            if self._seg[bi]:
                vals, gidx = self._sparsify_bucket_seg(vec_c, b, c,
                                                       phases[bi], seg_cands)
            elif self._sel3d[bi]:
                vals, gidx = self._sparsify_bucket_3d(vec_c, b, c,
                                                      phases[bi])
            else:
                vals, gidx = self._sparsify_bucket_2d(
                    vec_c, b, c, phases[bi], (fwd_sel or {}).get(bi))
            if c["tight"] is None:
                out_v.append(vals.reshape(-1))
                out_i.append(gidx.reshape(-1))
            else:
                out_v.append(vals.reshape(-1)[c["tight"]])
                out_i.append(gidx.reshape(-1)[c["tight"]])
        return torch.cat(out_v), torch.cat(out_i)

    def _sparsify_bucket_2d(self, vec_c: torch.Tensor, b: _Bucket, c,
                            phases: Sequence[float], fused=None):
        """Selection over the [R, cols] importance view of one bucket: the
        top ``max_sel`` by importance with their values — ``fused`` (the
        forward megakernel's), else the select-and-pack kernel's under
        ``fused_select``, else the top-k of the importance and a gather —
        then the sampled threshold and its adaptation from those scores.
        Returns ``(values [R, max_sel], global indices [R, max_sel])``."""
        block = vec_c[b.base:b.base + b.rows * b.cols].view(b.rows, b.cols)
        if fused is None and self._use_fused_select(b):
            fused = kernels.select_pack_rows(block, c["numels_r"], b.max_sel)
        imp_rows = (torch.where(c["in_row"], block.abs(), -1.0)
                    if fused is None or not b.exact else None)
        if fused is not None:
            top_scores, sel_vals, cols = fused
        else:
            top_scores, cols = select_topk(imp_rows, b.max_sel)
            sel_vals = block.gather(1, cols.long())
        if b.exact:
            # every row samples its whole tensor: the threshold is the
            # exact k-th largest, so top-num_selects is the selection
            valid = (top_scores >= 0) & c["slot_ok"]
        else:
            samples = self._sample_rows(b, c, imp_rows, phases)
            sorted_s = select_topk(samples.contiguous(), b.max_k)[0]
            thr = sorted_s.gather(1, c["k_idx"])[:, 0]
            if self.c.max_adaptation_iters > 0 and b.adapt.any():
                if self.c.resample:
                    thr = self._ladder_adapt_from_topk(c, top_scores, thr)
                else:
                    thr = _batched_adapt(
                        imp_rows, thr, c["lo"][:, 0], c["hi"], c["adapt"],
                        self.c.compress_lower_bound,
                        self.c.compress_upper_bound,
                        self.c.max_adaptation_iters)
            valid = (top_scores >= thr[:, None]) & c["slot_ok"]
        gidx = torch.where(valid, c["row_off"] + cols, self.layout.sentinel)
        return torch.where(valid, sel_vals, 0.0), gidx

    # -------------------------------------------------------------- #
    # the exchange                                                   #
    # -------------------------------------------------------------- #

    def _compensate_megakernel(self, mem, grad_c: torch.Tensor):
        """The megakernel route's compensate over [0, T), in place: each
        bucket of ``_mk_fwd_ids`` runs the forward megakernel on its region
        (compensate and selection in one launch); every span between them
        runs the compensate kernel on a window of the transmit record.
        Each element takes the default route's arithmetic. Returns
        ``(velocity, {bucket id: (scores, values, columns)})``."""
        m = self.c.memory
        flags = (m.momentum, m.nesterov, m.momentum_masking)
        mmt, vec, bits = (mem["momentums_c"], mem["velocities_c"],
                          mem["sent_bits"])
        consts = self._bucket_consts(grad_c.device)

        def span(lo, hi):
            if hi > lo:
                kernels.compensate_bits(
                    grad_c[lo:hi], mmt[lo:hi], vec[lo:hi],
                    kernels.realign_bits(bits, lo, hi - lo), *flags)

        fwd_sel, pos = {}, 0
        for bi in self._mk_fwd_ids:        # bucket bases rise with the id
            b = self.buckets[bi]
            hi = b.base + b.rows * b.cols
            span(pos, b.base)
            fwd_sel[bi] = kernels.dgc_forward_rows(
                grad_c[b.base:hi], mmt[b.base:hi], vec[b.base:hi], bits,
                b.base, consts[bi]["numels_r"], b.max_sel, *flags)
            pos = hi
        span(pos, self.T)
        return vec, fwd_sel

    def compress(self, flat_grad: torch.Tensor, mem, phases):
        """One worker's send side: compensate (in place on ``mem``), then
        sparsify. Returns the ``(values, indices)`` payload. With buckets
        on the forward megakernel the segment-path buckets get no fused
        candidates and compute their own, as in the reference. Does not
        clip: :meth:`exchange` clips every worker's block first."""
        if self._mk_fwd_ids:
            vec, fwd_sel = self._compensate_megakernel(mem,
                                                       flat_grad[:self.T])
            return self.sparsify(vec, phases, fwd_sel=fwd_sel)
        comp, cands = self._compensate_acc(mem, flat_grad[:self.T])
        return self.sparsify(comp, phases, seg_cands=cands)

    def apply(self, g_values: torch.Tensor, g_indices: torch.Tensor,
              dense_avg: torch.Tensor, mem, rank: int,
              world: int) -> torch.Tensor:
        """One worker's receive side, from the gathered [W, payload]
        values/indices and the averaged (and clipped) dense tail: the
        averaged flat [P] gradient. Replaces ``mem``'s transmit record and
        dense momentum."""
        T, S = self.T, self.layout.sentinel
        # out-of-range indices route to the structural-zero sentinel
        g_indices = torch.where((g_indices >= 0) & (g_indices < T),
                                g_indices, S)
        rows = torch.arange(g_indices.shape[0], device=g_indices.device)
        flags = ((rows[:, None] == rank) & (g_indices != S)).reshape(-1)
        acc, mem["sent_bits"] = kernels.apply_rows(
            g_values.reshape(-1), g_indices.reshape(-1), flags, T,
            divisor=float(world))
        if self.layout.total == T:
            return acc
        out_d, mem["momentums_d"] = self._compensate_dense(
            mem["momentums_d"], dense_avg)
        return torch.cat([acc, out_d])

    def _clipping(self) -> bool:
        return self.c.memory.gradient_clipping is not None

    def _exchange_dense(self, flat_grads: Sequence[torch.Tensor], mems,
                        comm) -> List[torch.Tensor]:
        """The all-dense exchange (ratio >= 1, or nothing compressed): the
        average of the whole flat gradient, clipped, then the
        non-accumulating correction of all of it. A transmit record still
        pending from a compressed step is folded into the memory first
        (the velocity, and the momentum under ``momentum_masking``, zeroed
        where it was sent) and reset, so the next compressed step reads
        the dense steps' momentum and an empty record."""
        T, world = self.T, comm.world
        avgs = [kernels.divide_exact(s, world)
                for s in comm.all_reduce(list(flat_grads))]
        if self._clipping():
            avgs = self._clip_block(avgs, self.layout.names, 0)
        outs = []
        for avg, mem in zip(avgs, mems):
            if T:
                keep = kernels.keep_from_bits(mem["sent_bits"], T)
                mem["velocities_c"] = mem["velocities_c"] * keep
                mc = mem["momentums_c"]
                if self.c.memory.momentum_masking:
                    mc = mc * keep
                out_c, mem["momentums_c"] = self._compensate_dense(
                    mc, avg[:T])
                mem["sent_bits"] = torch.zeros_like(mem["sent_bits"])
            out_d, mem["momentums_d"] = self._compensate_dense(
                mem["momentums_d"], avg[T:])
            outs.append(torch.cat([out_c, out_d]) if T else out_d)
        return outs

    def exchange(self, flat_grads: Sequence[torch.Tensor], mems,
                 phases, comm) -> List[torch.Tensor]:
        """compress -> all_gather -> apply for this process's workers
        (``comm.ranks``), plus the dense-tail all-reduce; at a dense ratio
        :meth:`_exchange_dense`. Under the memory's ``gradient_clipping``
        every worker's local compressed block is clipped before the
        compensate, and the averaged dense tail before its correction.
        Returns each worker's averaged flat gradient; the memories update
        in place."""
        if self.dense:
            return self._exchange_dense(flat_grads, mems, comm)
        T, world = self.T, comm.world
        blocks = [g[:T] for g in flat_grads]
        if self._clipping():
            blocks = self._clip_block(blocks, self.layout.compressed_names,
                                      0)
        sent = [self.compress(g, m, ph)
                for g, m, ph in zip(blocks, mems, phases)]
        g_vals = comm.all_gather([v for v, _ in sent])
        g_idx = comm.all_gather([i for _, i in sent])
        avgs = [kernels.divide_exact(d, world)
                for d in comm.all_reduce([g[T:] for g in flat_grads])]
        if self._clipping() and self.layout.total > T:
            avgs = self._clip_block(avgs, self.layout.dense_names, T)
        return [self.apply(gv, gi, d, m, r, world)
                for gv, gi, d, m, r in zip(g_vals, g_idx, avgs, mems,
                                           comm.ranks)]


class FlatDenseExchange:
    """The dense baseline compressors' flat exchange (``NoneCompressor``,
    ``FP16Compressor``): one all-reduce of the whole flat gradient on the
    compressor's wire, then the average. No memory, no sampling."""

    payload_size = 0

    def __init__(self, compressor, layout: ParamLayout):
        self.c = compressor
        self.layout = layout

    def init_memory(self, device=None) -> Dict:
        return {}

    def draw_phases(self, gen: torch.Generator) -> None:
        """Nothing is sampled."""
        return None

    def exchange(self, flat_grads: Sequence[torch.Tensor], mems,
                 phases, comm) -> List[torch.Tensor]:
        """Each local worker's averaged flat gradient: the compressor's
        own compress (to the wire) and decompress (the average) around
        the all-reduce (``mems`` and ``phases`` are unused)."""
        sent = [self.c.compress(None, None, g, None)[:2] for g in flat_grads]
        totals = comm.all_reduce([wire for wire, _ in sent])
        return [self.c.decompress(t, ctx, None, comm.world)[0]
                for t, (_, ctx) in zip(totals, sent)]
