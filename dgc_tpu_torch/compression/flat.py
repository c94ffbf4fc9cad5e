"""Flat (bucketed) execution engine for DGC, on PyTorch.

Counterpart of ``dgc_tpu/compression/flat.py``. The whole gradient, the
error-feedback memory and the optimizer state live in a few flat buffers
with the reference's exact layout (:class:`ParamLayout`): compressed
tensors first, one tensor per row of a size bucket, then a gap whose first
slot is the always-zero scatter sentinel, then the dense tail (biases,
BatchNorm). Buffers are therefore interchangeable with the JAX package's.

:class:`FlatDGCEngine` runs the reference's pipeline, split into the
per-worker halves around the collectives so one process can drive W workers
in lockstep (:class:`dgc_tpu_torch.parallel.comm.LocalComm`):

* :meth:`FlatDGCEngine.compress` — bit-masked momentum compensate (the
  compensate kernel, in place) and sampled top-k sparsification of every
  sparse bucket into a fixed-size ``(values, indices)`` payload;
* :meth:`FlatDGCEngine.encode` — the payload onto the wire lanes of each
  bucket's regime (below), with the int8 error feedback into the memory;
* ``comm.all_gather`` of each lane, ``comm.all_reduce`` of the dense
  tail together with the dense-planned buckets' slabs;
* :meth:`FlatDGCEngine.decode` and :meth:`FlatDGCEngine.apply` — the
  lanes back to values and indices, the apply kernel (scatter-add of
  ``wire / W`` and this worker's transmit record), then the dense slabs'
  and tail's non-accumulating correction.

Wires and state (the reference's regimes, :data:`_REGIMES`; one regime
a bucket, from a ``plan`` —
:mod:`~dgc_tpu_torch.compression.planner` — or uniformly from the
compressor's flags ``int8_values`` / ``fp16_values`` /
``packed_indices``): native values (in the state's dtype) or fp16 values,
int8 values with one f32 scale a tensor row (round half to even, clipped
to +-127) and, under ``int8_error_feedback``, the rounding residual kept
in the velocity and the int8 slots kept out of the transmit record, int4
values with one scale a bucket on the int8 byte lane; plain offsets (int32,
or int64 under ``int32_indices=False``), bit-packed tensor-local indices
or Elias-Fano words (:mod:`~dgc_tpu_torch.compression.wirecodec`); a
``dense`` bucket rides the dense all-reduce. ``fp16_values`` also puts the
dense all-reduce on an fp16 wire. The error-feedback state is f32 or
bf16 (``DGCSGDMemory(dtype="bfloat16")``): the compensate's math runs in
f32 with one round-to-nearest-even per stored value, the selection runs on
the stored bf16 velocity, and the values ship in bf16 on the native lane.

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

:meth:`FlatDGCEngine.exchange` also takes the combine ``op``
(``"average"``, ``"sum"`` or ``"adasum"``: compressed payloads divide by
the world only under the average; Adasum combines the dense block
pairwise), the two-tier exchange's local group (``local_comm``: each
worker's gradient is first replaced by its node's mean, then the whole
pipeline runs over ``comm``, the cross group) and ``health``, a dict that
receives the payload checksum's mismatch count
(``DGCCompressor(checksum=True)``, :mod:`~dgc_tpu_torch.resilience.
integrity`: the sender's per-bucket words ride the index lane, every
receiver recomputes them over the gathered payload). An armed
``DGC_FAULTS`` plan (read once, when the engine is built) corrupts the
gathered values (``bitflip``, after the gather) and indices (``badidx``,
before the clamp), on copies.

Telemetry (:mod:`dgc_tpu_torch.telemetry`): ``exchange(...,
telemetry=True)`` also returns each local worker's ``STEP_METRICS`` dict
(:meth:`FlatDGCEngine._telemetry_stats`: the gradient's norm before
clipping, the clip's relative reduction, the momenta's and the
untransmitted residual's norms and mass, the payload's real elements, the
wire's bytes, and per bucket the selected fraction and the effective
threshold from ``sparsify(..., stats_out=)``); the residual comes from the
reference's identity over the transmitted values, so no masked copy of
the velocity is built. ``bucket_descriptors`` and ``telemetry_static``
give the sink's header. ``exchange(..., send_frac=[...])`` is the
straggler-adaptive exchange (:mod:`~dgc_tpu_torch.resilience.adaptive`):
each local worker keeps only each row's ``ceil(quota * send_frac)``
largest selections, the rest become ``(0.0, sentinel)`` pads, dropped
from the transmit record, so the withheld mass stays in the velocity. The
stages run inside the reference's phase markers
(:func:`dgc_tpu_torch.telemetry.trace.phase`), which cost nothing while
tracing is off.

The gossip exchange (a plan of ``gossip_ring`` or ``gossip_hcube``
buckets, :mod:`~dgc_tpu_torch.compression.gossip`): the same wire and
collectives every round; the memory carries the round clock, the ``[W]``
staleness ages, the forced-sync count and a ``[T]`` inbox. Each round the
compensate's velocity takes last round's inbox (after the deferred
transmit mask) before the selection; the gathered rows are weighed by
the round (:func:`gossip.row_weights`: 1 each on a full sync, ``W /
outdeg`` for the rotating neighborhood on a gossip round) before the
apply's division by W; the apply's scatter then feeds the parameters on
a full round and only the inbox on a gossip round. The round's
classification is computed on the device from the memory
(:func:`gossip.round_state`), never read on the host. An armed
``droplink`` weighs the dropped worker's row 0 on every receiver and
voids its own transmit record. Gossip turns the fused candidates off
(the segment path runs the compensate kernel, then the standalone
candidates kernel over the velocity with the inbox in it) and refuses
the megakernel.

Layouts of 2**31 slots or more (``ParamLayout.index_dtype`` int64, as in
the reference) run the default route: the engine's wire is then int64,
the apply takes it as it is, and the kernels on that route launch their
64-bit instantiations (:func:`kernels.index64`). The routes whose kernels
have no 64-bit form yet refuse such a layout when the engine is built,
naming ``ROADMAP.md`` queue 1 item 14: the forward megakernel, the fused
select and the non-resample adaptation's one-level ladder.
"""

import math
import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from dgc_tpu_torch.compression import gossip as _gossip_sched
from dgc_tpu_torch.compression.wirecodec import (DeltaIndexCodec, IndexCodec,
                                                  pack_int4, unpack_int4)
from dgc_tpu_torch.ops import kernels
from dgc_tpu_torch.resilience import faults as _faults
from dgc_tpu_torch.resilience import integrity
from dgc_tpu_torch.telemetry import taps
from dgc_tpu_torch.telemetry.trace import phase
from dgc_tpu_torch.utils.pytree import named_flatten

__all__ = ["ParamLayout", "FlatDGCEngine", "FlatDenseExchange",
           "ladder_cols", "lax_top_k", "select_topk", "lane_quota",
           "lane_candidates", "node_mean", "ROUTES", "OPS"]

#: the exchange's combine semantics (the reference's allreduce ops)
OPS = ("average", "sum", "adasum")

#: exchange regime -> (value kind, index lane), the reference's regimes:
#: "d" buckets ride the dense all-reduce; the
#: value lane is "f32" (the native values, in the state's dtype), "f16",
#: "i8" (int8 + one f32 scale a row) or "i4" (nibble-packed int4 + one f32
#: scale a bucket, on the int8 byte lane); the index lane is False (plain
#: flat offsets), True (:class:`IndexCodec` words) or "delta"
#: (:class:`DeltaIndexCodec` words; both word streams share one lane).
#: The gossip regimes ride the f32 wire: the round decides whether the
#: gathered payload feeds the parameters or the neighborhood's inbox
_REGIMES = {
    "dense": ("d", False),
    "fp32": ("f32", False), "fp32_packed": ("f32", True),
    "fp16": ("f16", False), "fp16_packed": ("f16", True),
    "int8": ("i8", False), "int8_packed": ("i8", True),
    "int4_packed": ("i4", True),
    "int8_delta_idx": ("i8", "delta"),
    "gossip_ring": ("f32", False),
    "gossip_hcube": ("f32", False),
}

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


def node_mean(xs: Sequence[torch.Tensor], local_comm,
              op: str = "average") -> List[torch.Tensor]:
    """The two-tier exchange's first tier: each worker's tensor replaced by
    its node's sum over ``local_comm``, divided by the node's size under
    ``"average"`` and ``"adasum"`` (whose participant is the node mean),
    in full precision."""
    sums = local_comm.all_reduce(list(xs))
    if op == "sum":
        return sums
    return [kernels.divide_exact(x, local_comm.world) for x in sums]


def _round_up(n: int, align: int) -> int:
    return -(-n // align) * align


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


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
    #: the flat buffers' dtype
    dtype = torch.float32

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
        #: the least index dtype the flat offsets fit in: int32, or int64
        #: at 2**31 slots or more (the reference's rule; the engine then
        #: forces the int64 wire)
        self.index_dtype = (torch.int64 if kernels.index64(self.total)
                            else torch.int32)

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


def _state_ladder(lower: float, levels: int,
                  dtype: torch.dtype) -> torch.Tensor:
    """The adaptation's ladder ``lower ** i`` in the thresholds' dtype:
    :func:`_pow_ladder` for f32; for bf16 the reference's bf16 pow, ``lower``
    rounded to bf16, raised in f32 and rounded once more."""
    if dtype == torch.float32:
        return torch.from_numpy(_pow_ladder(lower, levels))
    base = float(torch.tensor(lower, dtype=dtype))
    return torch.from_numpy(_pow_ladder(base, levels)).to(dtype)


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
    a dense ratio (>= 1) to a compressed one and back, and across a change
    of plan. ``plan``: one exchange regime per bucket (a regime sequence or
    a :class:`~dgc_tpu_torch.compression.planner.Plan`), else the uniform
    regime of the compressor's wire flags."""

    def __init__(self, compressor, layout: ParamLayout, plan=None):
        self.c = compressor
        self.layout = layout
        self.T = layout.t_compressed
        #: the armed fault plan, read once (None: ``DGC_FAULTS`` unset)
        self._faults = _faults.active_plan()
        mdt = compressor.memory.dtype
        if mdt not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"the flat engine keeps f32 or bf16 error-"
                             f"feedback state, not {mdt}")
        #: the error-feedback state's dtype: f32, or the bf16 memory
        self.state_dtype = mdt or torch.float32
        #: the wire's index dtype: int64 where the compressor asks for it
        #: (``int32_indices=False``) or the layout's offsets need it (2**31
        #: slots or more; the reference's ``want64``); the apply narrows an
        #: int64 wire to int32 only below 2**31 slots
        want64 = (not getattr(compressor, "int32_indices", True)
                  or layout.index_dtype == torch.int64)
        self.index_dtype = torch.int64 if want64 else torch.int32
        compressed = self.T > 0 and compressor.compress_ratio < 1.0
        self.buckets = (_build_buckets(compressor.attributes, layout,
                                       compressor) if compressed else [])
        if plan is None:
            regimes = (self._legacy_regime(),) * len(self.buckets)
            self.plan = None
        else:
            regimes = tuple(getattr(plan, "regimes", plan))
            if len(regimes) != len(self.buckets):
                raise ValueError(
                    f"plan carries {len(regimes)} regimes for "
                    f"{len(self.buckets)} buckets — the plan was built for "
                    "a different geometry; call Plan.replan(engine) after "
                    "every warmup compress-ratio change")
            self.plan = plan if hasattr(plan, "regimes") else None
        unknown = [r for r in regimes if r not in _REGIMES]
        if unknown:
            raise ValueError(f"unknown exchange regime(s) {unknown}; "
                             f"expected one of {sorted(_REGIMES)}")
        #: one exchange regime per bucket
        self.regimes: Tuple[str, ...] = regimes
        rk = [_REGIMES[r] for r in regimes]
        #: bucket ids by role: dense-planned buckets ride the dense
        #: all-reduce as slabs; the sparse pipeline runs over the rest
        self._sparse_ids = [i for i, (k, _) in enumerate(rk) if k != "d"]
        self._dense_ids = [i for i, (k, _) in enumerate(rk) if k == "d"]
        #: nothing compressed, a ratio of 1, or an all-dense plan: the
        #: all-dense exchange
        self.dense = not self._sparse_ids
        sparse = [self.buckets[i] for i in self._sparse_ids]
        #: per sparse bucket (payload order): value kind, index lane
        self._kinds = tuple(rk[i][0] for i in self._sparse_ids)
        self._packed = tuple(rk[i][1] for i in self._sparse_ids)
        sl, off = [], 0
        for b in sparse:
            sl.append((off, off + b.payload))
            off += b.payload
        self._payload_slices = tuple(sl)
        #: per-worker wire payload in elements (the sparse buckets')
        self.payload_size = off
        #: adaptive-exchange statics (resilience/adaptive.py): per payload
        #: slot, its rank within its row and the row's full quota, from
        #: the bucket's tight map. The selections of a row come in
        #: descending |value| order, so masking the slots of rank >=
        #: ceil(quota * send_frac) keeps exactly the largest; at
        #: send_frac == 1 every structurally valid slot survives
        self._adaptive_rank = self._adaptive_quota = None
        if sparse and self.payload_size:
            self._adaptive_rank = np.concatenate(
                [(b.tight % b.max_sel).astype(np.int32) for b in sparse])
            self._adaptive_quota = np.concatenate(
                [np.asarray(b.num_selects, np.float32)[b.tight // b.max_sel]
                 for b in sparse])
        self._build_lanes(sparse)
        #: per bucket: selects through the segment candidates
        self._seg = [self._use_seg_kernel(b) for b in self.buckets]
        #: per bucket: a wide bucket off the segment path, selecting
        #: through per-(row, lane) candidates (:meth:`_sparsify_bucket_3d`)
        self._sel3d = [self._use_3d(b) and not seg
                       for b, seg in zip(self.buckets, self._seg)]
        #: any sparse bucket takes the segment path: the compensate pass
        #: then emits the candidates itself (the reference's ``_seg_fused``)
        self._seg_fused = any(self._seg[i] for i in self._sparse_ids)
        #: the forward megakernel's opt-in, read where the reference reads
        #: it: the compressor's flag or ``DGC_MEGAKERNEL=1``
        #: the payload checksum (resilience.integrity): one int32 word a
        #: sparse bucket over the exact wire words, on the index lane;
        #: verified where the caller passes ``health`` to :meth:`exchange`
        self.checksum = (bool(getattr(compressor, "checksum", False))
                         and self.payload_size > 0)
        if self.checksum and self._row_map is not None:
            raise ValueError(
                "checksum=True is not supported with int8_values — the "
                "per-row f32 scale wire would ride uncovered; use the "
                "fp16/f32 value wire")
        if self.checksum and self._i4_buckets:
            raise ValueError(
                "checksum=True is not supported with the int4_packed "
                "wire — the per-bucket f32 scale wire would ride "
                "uncovered; use the fp16/f32 value wire")
        if self.checksum and len(set(regimes) - {"dense"}) > 1:
            raise ValueError(
                "checksum=True needs one wire format across the sparse "
                f"buckets; the plan mixes {sorted(set(regimes) - {'dense'})}"
                " — plan with candidates=('dense', <one regime>) or disable "
                "the checksum")
        self._num_seg = len(sparse)
        self._seg_ids = (integrity.bucket_segments(sparse) if self.checksum
                         else None)
        self._megakernel = bool(
            getattr(compressor, "megakernel", False)
            or os.environ.get("DGC_MEGAKERNEL", "") == "1")
        #: sparse bucket ids whose compensate and selection run the
        #: forward megakernel, in base order
        self._mk_fwd_ids = tuple(bi for bi in self._sparse_ids
                                 if self._use_megakernel_fwd(bi))
        #: the gossip schedule (:class:`gossip.GossipConfig`) when the
        #: plan carries a gossip family, else None (nothing of it runs);
        #: the plan has refused mixed families already, what is checked
        #: here only the engine knows
        self._gossip = getattr(self.plan, "gossip", None)
        if self._gossip is not None:
            from dgc_tpu_torch.compression.memory import DGCSGDMemory
            if not isinstance(compressor.memory, DGCSGDMemory):
                raise ValueError(
                    "gossip regimes need momentum-correction memory "
                    "(DGCSGDMemory): a worker's untransmitted mass must "
                    "live in the error-feedback residual between "
                    "neighborhood rounds")
            if not self._sparse_ids:
                raise ValueError(
                    "gossip plan has no sparse buckets — with an all-"
                    "dense plan (or compress_ratio >= 1) there is no "
                    "neighborhood payload to exchange; plan without the "
                    "gossip candidates instead")
            if self._megakernel:
                raise ValueError(
                    "megakernel=True is not supported with gossip "
                    "regimes: the fused forward emits its candidates "
                    "before the neighborhood inbox is folded into the "
                    "velocities, so they would be one round stale")
            if getattr(compressor, "fused_apply", False):
                raise ValueError(
                    "fused_apply=True is not supported with gossip "
                    "regimes: the fused scatter cannot split the "
                    "gathered payload between parameters (full-sync "
                    "round) and the neighborhood inbox (gossip round)")
            # the fused compensate emits candidates before the inbox
            # fold: the segment path takes the compensate kernel and the
            # standalone candidates kernel instead
            self._seg_fused = False
        self._check_index64_routes()
        self._consts: Dict[torch.device, list] = {}
        self._wire_dev: Dict[torch.device, dict] = {}

    def _check_index64_routes(self) -> None:
        """Refuse, at a layout of 2**31 slots or more, the routes whose
        kernels have no 64-bit form yet (``ROADMAP.md`` queue 1 item 14):
        the forward megakernel, the fused select and the non-resample
        adaptation's one-level ladder. The default route runs there."""
        if not kernels.index64(self.layout.total):
            return
        flat2d = [self.buckets[i] for i in self._sparse_ids
                  if not self._seg[i] and not self._sel3d[i]]
        refused = []
        if self._mk_fwd_ids:
            refused.append("the forward megakernel (megakernel=True)")
        if any(self._use_fused_select(b) for b in flat2d):
            refused.append("the fused select (fused_select=True)")
        if (not self.c.resample and self.c.max_adaptation_iters > 0
                and any(b.adapt.any() and not b.exact for b in flat2d)):
            refused.append("the one-level ladder (resample=False)")
        if refused:
            raise ValueError(
                f"a layout of {self.layout.total} slots (2**31 or more) "
                f"runs only the default route: {', '.join(refused)} has no "
                "64-bit kernel yet (ROADMAP.md queue 1 item 14)")

    def _build_lanes(self, sparse: List[_Bucket]) -> None:
        """The static lane layout over the sparse buckets (the reference's
        constructor): each value kind's chunks, each index lane's chunks,
        the int8 row map and int4 bucket map of the scales, the int4 byte
        chunks, the int8 slot mask of a mixed plan, the codecs and the
        receiver's clamp bounds."""
        kof: Dict[str, int] = {}
        vloc = []
        for b, kk in zip(sparse, self._kinds):
            lo = kof.get(kk, 0)
            vloc.append((kk, lo, lo + b.payload))
            kof[kk] = lo + b.payload
        self._val_chunks = tuple(vloc)
        #: payload elements on each value kind's lane
        self._kind_payload = kof
        iof = {True: 0, False: 0, "delta": 0}
        iloc = []
        for b, p in zip(sparse, self._packed):
            iloc.append((p, iof[p], iof[p] + b.payload))
            iof[p] += b.payload
        self._idx_chunks = tuple(iloc)
        self._plain_payload = iof[False]
        # int8 buckets: payload slot -> tensor row (slot s of a bucket's
        # [R, max_sel] grid belongs to row s // max_sel), one f32 scale a
        # row
        i8 = [b for b, kk in zip(sparse, self._kinds) if kk == "i8"]
        self._i8_rows = sum(b.rows for b in i8)
        rm, base = [], 0
        for b in i8:
            rm.append((b.tight // b.max_sel).astype(np.int64) + base)
            base += b.rows
        self._row_map = np.concatenate(rm) if rm else None
        # int4 buckets: one f32 scale a bucket, each bucket's nibbles
        # padded to a whole byte
        i4 = [b for b, kk in zip(sparse, self._kinds) if kk == "i4"]
        self._i4_buckets = len(i4)
        self._i4_map = (np.concatenate([np.full(b.payload, j, np.int64)
                                        for j, b in enumerate(i4)])
                        if i4 else None)
        ck, plo, blo = [], 0, 0
        for b in i4:
            nb = (b.payload + 1) // 2
            ck.append((plo, plo + b.payload, blo, blo + nb))
            plo, blo = plo + b.payload, blo + nb
        self._i4_chunks = tuple(ck)
        self._i4_bytes = blo
        # the int8 slots of a mixed plan (int8 error feedback keeps them
        # out of the transmit record; the other buckets record theirs)
        self._i8_slot_mask = None
        if i8 and len(i8) != len(sparse):
            i8m = np.zeros(self.payload_size, bool)
            for (s0, s1), kk in zip(self._payload_slices, self._kinds):
                if kk == "i8":
                    i8m[s0:s1] = True
            self._i8_slot_mask = i8m
        pk = [b for b, p in zip(sparse, self._packed) if p is True]
        self._codec = IndexCodec(pk) if pk else None
        dl = [b for b, p in zip(sparse, self._packed) if p == "delta"]
        self._dcodec = DeltaIndexCodec(dl) if dl else None
        # each delta bucket's payload slice and its slots' row bounds
        # (:meth:`_sort_delta_payload`)
        ds, dj = [], 0
        for (s0, s1), p in zip(self._payload_slices, self._packed):
            if p == "delta":
                n = s1 - s0
                ds.append((s0, s1, self._dcodec.slot_off[dj:dj + n],
                           self._dcodec.slot_numel[dj:dj + n]))
                dj += n
        self._delta_sort = tuple(ds)
        # receiver-side clamp bounds: codec slots their static rows, plain
        # slots [0, T)
        words = [c for c in (self._codec, self._dcodec) if c is not None]
        if len(words) == 1 and not self._plain_payload:
            self._clamp_bounds = (words[0].slot_off, words[0].slot_numel)
        elif words:
            so = np.zeros(self.payload_size, np.int64)
            sn = np.full(self.payload_size, max(int(self.T), 1), np.int64)
            pj = dj = 0
            for (s0, s1), p in zip(self._payload_slices, self._packed):
                if p is True:
                    so[s0:s1] = self._codec.slot_off[pj:pj + s1 - s0]
                    sn[s0:s1] = self._codec.slot_numel[pj:pj + s1 - s0]
                    pj += s1 - s0
                elif p == "delta":
                    so[s0:s1] = self._dcodec.slot_off[dj:dj + s1 - s0]
                    sn[s0:s1] = self._dcodec.slot_numel[dj:dj + s1 - s0]
                    dj += s1 - s0
            self._clamp_bounds = (so, sn)
        else:
            self._clamp_bounds = (None, None)

    def _legacy_regime(self) -> str:
        """The uniform wire regime the compressor's flags describe (every
        ``plan=None`` engine's)."""
        c = self.c
        if getattr(c, "int8_values", False):
            base = "int8"
        elif getattr(c, "fp16_values", False):
            base = "fp16"
        else:
            base = "fp32"
        return base + ("_packed"
                       if getattr(c, "packed_indices", False) else "")

    # -------------------------------------------------------------- #
    # wire geometry                                                  #
    # -------------------------------------------------------------- #

    def wire_bytes_per_worker(self) -> int:
        """Per-worker sparse wire bytes a step under the regimes, as the
        reference counts them: the value lanes (int8 payload and one f32
        scale a row, int4 bytes and one scale a bucket, fp16, or the
        native lane at the layout's 4 bytes) and the index lanes (codec
        words, plain offsets at the index dtype's width). Dense-planned
        buckets ride the dense all-reduce and cost 0 here."""
        if not self.payload_size:
            return 0
        kp = self._kind_payload
        val = 0
        if kp.get("i8"):
            val += kp["i8"] + 4 * self._i8_rows
        if kp.get("i4"):
            val += self._i4_bytes + 4 * self._i4_buckets
        if kp.get("f16"):
            val += 2 * kp["f16"]
        if kp.get("f32"):
            val += kp["f32"] * _itemsize(self.layout.dtype)
        idx = 0
        if self._codec is not None:
            idx += 4 * self._codec.nwords
        if self._dcodec is not None:
            idx += 4 * self._dcodec.nwords
        if self._plain_payload:
            idx += self._plain_payload * _itemsize(self.index_dtype)
        return int(val + idx)

    def bucket_wire_bytes(self) -> List[int]:
        """Per-bucket sparse wire bytes under the regimes (dense-planned
        buckets 0; a packed-index bucket's slot bits rounded up to whole
        bytes, so the sum may differ from :meth:`wire_bytes_per_worker`
        by the shared stream's sub-word rounding)."""
        out = []
        pj = dj = 0
        for b, r in zip(self.buckets, self.regimes):
            kind, packed = _REGIMES[r]
            if kind == "d":
                out.append(0)
                continue
            if kind == "i8":
                vb = b.payload + 4 * b.rows
            elif kind == "i4":
                vb = (b.payload + 1) // 2 + 4
            elif kind == "f16":
                vb = 2 * b.payload
            else:
                vb = b.payload * _itemsize(self.layout.dtype)
            if packed is True:
                w = self._codec.widths[pj:pj + b.payload]
                pj += b.payload
                ib = -(-int(w.sum()) // 8)
            elif packed == "delta":
                ib = 4 * self._dcodec.bucket_words[dj]
                dj += 1
            else:
                ib = b.payload * _itemsize(self.index_dtype)
            out.append(int(vb + ib))
        return out

    def bucket_descriptors(self) -> List[Dict]:
        """Static per-bucket geometry for telemetry headers and readers:
        the per-bucket stat columns (``selected_frac``, ``threshold``)
        come in this order. Carries each bucket's regime and its wire
        bytes."""
        wb = self.bucket_wire_bytes()
        return [{"base": int(b.base), "rows": int(b.rows),
                 "cols": int(b.cols), "numel": int(np.sum(b.numels)),
                 "num_selects": int(np.sum(b.num_selects)),
                 "payload": int(b.payload), "regime": r,
                 "wire_bytes": int(w)}
                for b, r, w in zip(self.buckets, self.regimes, wb)]

    def telemetry_static(self) -> Dict:
        """Header block for the telemetry sink (``registry.make_header``)."""
        return {
            "engine": type(self).__name__,
            "num_params": int(self.layout.total),
            "t_compressed": int(self.T),
            "compress_ratio": float(self.c.compress_ratio),
            "payload_elems": int(self.payload_size),
            "wire_bytes": self.wire_bytes_per_worker(),
            "index_bits": (round(self._codec.bits_per_index, 2)
                           if self._codec is not None else
                           8 * _itemsize(self.index_dtype)),
            "regimes": list(self.regimes),
            "buckets": self.bucket_descriptors(),
        }

    # -------------------------------------------------------------- #
    # memory                                                         #
    # -------------------------------------------------------------- #

    def init_memory(self, device) -> Dict[str, torch.Tensor]:
        """Error-feedback buffers split at the compressed/dense boundary T,
        plus the packed transmit record of the last step (deferred
        masking: the next compensate zeroes those coordinates on read).
        The buffers are in the memory's dtype (f32, or the bf16 state);
        the record is int32. A gossip plan adds its round state:
        ``gossip_clock`` (rounds completed), ``gossip_age`` ([W] rounds
        since each worker's mass last reached the parameters, the same on
        every worker), ``gossip_inbox`` ([T] neighbor mass received this
        round, folded into the velocity next round) and ``gossip_forced``
        (the count of staleness-forced full syncs), all int32 but the
        inbox."""
        T, P, sdt = self.T, self.layout.total, self.state_dtype

        def z(n, dtype=sdt):
            return torch.zeros(n, dtype=dtype, device=device)
        mem = {"momentums_c": z(T), "velocities_c": z(T),
               "momentums_d": z(P - T), "velocities_d": z(P - T),
               "sent_bits": z(kernels.num_sent_words(T), torch.int32)}
        if self._gossip is not None:
            mem["gossip_clock"] = z((), torch.int32)
            mem["gossip_age"] = z(self._gossip.world, torch.int32)
            mem["gossip_inbox"] = z(T)
            mem["gossip_forced"] = z((), torch.int32)
        return mem

    def memory_full(self, mem) -> Dict[str, torch.Tensor]:
        """Canonical ``{momentums, velocities}`` [P] view with the pending
        transmit mask applied (inspection and checkpoints only). A gossip
        inbox is velocity in flight: it is folded in after the mask, in
        the order the next exchange folds it."""
        keep = kernels.keep_from_bits(mem["sent_bits"], self.T).to(
            mem["velocities_c"].dtype)
        vc = mem["velocities_c"] * keep
        mc = mem["momentums_c"]
        if self.c.memory.momentum_masking:
            mc = mc * keep
        if "gossip_inbox" in mem:
            vc = vc + mem["gossip_inbox"].to(vc.dtype)
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
        slots stay zero and nothing is left pending in the record. The
        gossip clock, ages and forced count carry over from ``mem``; the
        inbox is empty (the canonical view holds its mass)."""
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
        for k in ("gossip_clock", "gossip_age", "gossip_forced"):
            if k in mem:
                out[k] = mem[k]
        if "gossip_inbox" in mem:
            out["gossip_inbox"] = torch.zeros_like(mem["gossip_inbox"])
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
        ``(corrected gradient, new momentum)``, the math in the gradient's
        dtype and the momentum rounded once to the state's."""
        m = self.c.memory
        sdt = mmt.dtype
        mmt = mmt.to(grad.dtype)
        if m.nesterov:
            mmt = (mmt + grad) * m.momentum
            return mmt + grad, mmt.to(sdt)
        mmt = m.momentum * mmt + grad
        return mmt, mmt.to(sdt)

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
        nothing for a bucket that samples every element or that the plan
        sends dense."""
        out = []
        for b, r in zip(self.buckets, self.regimes):
            if r == "dense":
                out.append([])
                continue
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
                # [R, cols]; the 3-D fallback never reads it (its bucket
                # past 2**31 slots would hold 2.1 GB of it)
                "in_row": (None if sel3d else
                           col[None, :] < t(b.numels, torch.int64)[:, None]),
                "row_off": t(b.row_offsets, self.index_dtype)[:, None],
                "slot_ok": slot[None, :] < t(b.num_selects,
                                             torch.int64)[:, None],
                "k_idx": t(b.topk_samples - 1, torch.int64)[:, None],
                "tight": (None if b.payload == b.rows * b.max_sel
                          else t(b.tight, torch.int64)),
                # the thresholds' dtype: the state's (bf16 thresholds
                # adapt on a bf16 ladder, as the reference's do)
                "ladder": _state_ladder(self.c.compress_lower_bound,
                                        self.c.max_adaptation_iters + 1,
                                        self.state_dtype).to(device),
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
        columns, f32 state (the bf16 state keeps the unfused route, as in
        the reference)."""
        b = self.buckets[bi]
        return (self._megakernel and self.state_dtype == torch.float32
                and not self._seg[bi] and not self._use_3d(b)
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
        # the candidates' f32 values are exact up-casts of a bf16 state
        sel_vals = sel[:, :, 0].contiguous().view(torch.float32).to(
            vec_c.dtype)
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
                 fwd_sel: Optional[Dict[int, Tuple[torch.Tensor, ...]]] = None,
                 stats_out: Optional[Dict] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sampled top-k selection over the compressed block [T], over the
        buckets the plan does not send dense. Returns ``(values, indices)``
        of length ``payload_size``, the values in the state's dtype and the
        indices in :attr:`index_dtype`; invalid slots carry ``(0.0,
        sentinel)``. ``seg_cands`` are the
        compensate pass's candidates (:func:`kernels.compensate_bits_cands`);
        without them a segment-path bucket computes its own
        (:func:`kernels.seg_top2_candidates`). ``fwd_sel`` maps a bucket id
        to the ``(scores, values, columns)`` the forward megakernel already
        selected (:meth:`_compensate_megakernel`). ``stats_out``: a dict
        that receives the telemetry's selection stats (:meth:`
        _selection_stats`)."""
        consts = self._bucket_consts(vec_c.device)
        out_v, out_i = [], []
        for bi in self._sparse_ids:
            b, c = self.buckets[bi], consts[bi]
            if self._seg[bi]:
                with phase("select", bi):
                    vals, gidx = self._sparsify_bucket_seg(
                        vec_c, b, c, phases[bi], seg_cands)
            elif self._sel3d[bi]:
                with phase("select", bi):
                    vals, gidx = self._sparsify_bucket_3d(vec_c, b, c,
                                                          phases[bi])
            else:
                vals, gidx = self._sparsify_bucket_2d(
                    vec_c, b, c, phases[bi], (fwd_sel or {}).get(bi), bi)
            with phase("pack", bi):
                if c["tight"] is None:
                    out_v.append(vals.reshape(-1))
                    out_i.append(gidx.reshape(-1))
                else:
                    out_v.append(vals.reshape(-1)[c["tight"]])
                    out_i.append(gidx.reshape(-1)[c["tight"]])
        if stats_out is not None:
            stats_out.update(self._selection_stats(out_v, out_i))
        return torch.cat(out_v), torch.cat(out_i)

    def _selection_stats(self, out_v, out_i) -> Dict[str, torch.Tensor]:
        """The telemetry tap over the emitted payload (each sparse
        bucket's ``(values, indices)``): per bucket the real selections
        over the bucket's elements (``selected_frac``) and the least |value|
        sent (``threshold``), a dense-planned bucket 1.0 and 0.0, and the
        payload's real elements (``payload_elems``)."""
        dev = out_v[0].device
        counts, thrs, fracs = [], [], []
        sj = 0
        for b, r in zip(self.buckets, self.regimes):
            if r == "dense":
                fracs.append(torch.ones((), dtype=torch.float32, device=dev))
                thrs.append(torch.zeros((), dtype=torch.float32, device=dev))
                continue
            cnt, thr = taps.bucket_payload_stats(out_v[sj], out_i[sj],
                                                 self.layout.sentinel)
            sj += 1
            counts.append(cnt)
            thrs.append(thr)
            fracs.append(cnt / torch.full((), float(np.sum(b.numels)),
                                          dtype=torch.float32, device=dev))
        return {"selected_frac": torch.stack(fracs),
                "threshold": torch.stack(thrs),
                "payload_elems": sum(counts)}

    def _sparsify_bucket_2d(self, vec_c: torch.Tensor, b: _Bucket, c,
                            phases: Sequence[float], fused=None, bi=-1):
        """Selection over the [R, cols] importance view of one bucket
        (``bi``, for the phase markers): the top ``max_sel`` by importance
        with their values — ``fused`` (the forward megakernel's), else the
        select-and-pack kernel's under ``fused_select``, else the top-k of
        the importance and a gather — then the sampled threshold and its
        adaptation from those scores. Returns ``(values [R, max_sel],
        global indices [R, max_sel])``."""
        block = vec_c[b.base:b.base + b.rows * b.cols].view(b.rows, b.cols)
        with phase("select", bi):
            if fused is None and self._use_fused_select(b):
                fused = kernels.select_pack_rows(block, c["numels_r"],
                                                 b.max_sel)
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
            with phase("select", bi):
                valid = (top_scores >= 0) & c["slot_ok"]
        else:
            with phase("threshold", bi):
                samples = self._sample_rows(b, c, imp_rows, phases)
                sorted_s = select_topk(samples.contiguous(), b.max_k)[0]
                thr = sorted_s.gather(1, c["k_idx"])[:, 0]
                if self.c.max_adaptation_iters > 0 and b.adapt.any():
                    if self.c.resample:
                        thr = self._ladder_adapt_from_topk(c, top_scores,
                                                           thr)
                    else:
                        thr = _batched_adapt(
                            imp_rows, thr, c["lo"][:, 0], c["hi"],
                            c["adapt"], self.c.compress_lower_bound,
                            self.c.compress_upper_bound,
                            self.c.max_adaptation_iters)
            with phase("select", bi):
                valid = (top_scores >= thr[:, None]) & c["slot_ok"]
        with phase("select", bi):
            gidx = torch.where(valid, c["row_off"] + cols,
                               self.layout.sentinel)
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
            with phase("forward", bi):
                fwd_sel[bi] = kernels.dgc_forward_rows(
                    grad_c[b.base:hi], mmt[b.base:hi], vec[b.base:hi], bits,
                    b.base, consts[bi]["numels_r"], b.max_sel, *flags)
            pos = hi
        span(pos, self.T)
        return vec, fwd_sel

    def compress(self, flat_grad: torch.Tensor, mem, phases,
                 stats_out: Optional[Dict] = None):
        """One worker's send side: compensate (in place on ``mem``), then
        sparsify. Returns the ``(values, indices)`` payload. With buckets
        on the forward megakernel the segment-path buckets get no fused
        candidates and compute their own, as in the reference. Under a
        gossip plan last round's inbox is added to the velocity (in place,
        after the compensate's deferred mask) before the selection. Does
        not clip: :meth:`exchange` clips every worker's block first.
        ``stats_out``: see :meth:`sparsify`.

        The ``dgcver.*`` anchors (:func:`kernels.vtag`) report the error-
        feedback state, the selection's input and the payload to the
        verifier's recorder, and do nothing without one.
        ``DGC_VERIFY_MUTATE=cast_bf16`` (a seeded mutation the verifier
        must catch) round-trips the compensated velocity through bf16
        before the selection."""
        kernels.vtag(mem["momentums_c"], "dgcver.src.momentum")
        kernels.vtag(mem["velocities_c"], "dgcver.src.residual")
        if self._mk_fwd_ids:
            with phase("forward"):
                vec, fwd_sel = self._compensate_megakernel(
                    mem, flat_grad[:self.T])
            kernels.vtag(vec, "dgcver.sel_input")
            return self._tag_selection(self.sparsify(
                vec, phases, fwd_sel=fwd_sel, stats_out=stats_out))
        with phase("compensate"):
            comp, cands = self._compensate_acc(mem, flat_grad[:self.T])
            if self._gossip is not None:
                # the received neighbor mass joins the velocity only (its
                # senders ran their momentum); consumed once, the apply
                # rewrites the inbox
                comp.add_(mem["gossip_inbox"])
        if os.environ.get("DGC_VERIFY_MUTATE", "") == "cast_bf16":
            comp = comp.to(torch.bfloat16).to(comp.dtype)
        kernels.vtag(comp, "dgcver.sel_input")
        return self._tag_selection(self.sparsify(
            comp, phases, seg_cands=cands, stats_out=stats_out))

    @staticmethod
    def _tag_selection(sel):
        """The payload's anchors, before any send-fraction mask."""
        kernels.vtag(sel[0], "dgcver.sel_values")
        kernels.vtag(sel[1], "dgcver.sel_indices")
        return sel

    def mask_send_frac(self, values: torch.Tensor, indices: torch.Tensor,
                       send_frac) -> Tuple[torch.Tensor, torch.Tensor]:
        """The straggler-adaptive mask of one worker's payload: the slots
        of rank ``>= ceil(quota * clip(send_frac, 0, 1))`` in their row
        become ``(0.0, sentinel)`` (in f32, as the reference computes it;
        ``send_frac`` a float or an f32 device scalar). At 1 the payload
        is unchanged."""
        wc = self._wire_consts(values.device)
        fr = torch.clamp(torch.as_tensor(send_frac, dtype=torch.float32,
                                         device=values.device), 0.0, 1.0)
        keep = wc["ad_rank"] < torch.ceil(wc["ad_quota"] * fr)
        return (torch.where(keep, values, 0.0),
                torch.where(keep, indices, self.layout.sentinel))

    # -------------------------------------------------------------- #
    # the wire lanes                                                 #
    # -------------------------------------------------------------- #

    def _wire_consts(self, device) -> dict:
        """The lanes' static maps as tensors on ``device`` (built once)."""
        device = torch.device(device)
        wc = self._wire_dev.get(device)
        if wc is None:
            def t(a):
                return None if a is None else torch.as_tensor(a,
                                                              device=device)
            so, sn = self._clamp_bounds
            wc = {"row_map": t(self._row_map), "i4_map": t(self._i4_map),
                  "i8_slots": t(self._i8_slot_mask),
                  "clamp_lo": None if so is None else t(so).to(
                      self.index_dtype),
                  "clamp_hi": None if so is None else t(so + sn).to(
                      self.index_dtype),
                  "seg_ids": t(self._seg_ids),
                  "ad_rank": t(self._adaptive_rank),
                  "ad_quota": t(self._adaptive_quota)}
            self._wire_dev[device] = wc
        return wc

    def _kind_chunks(self, arr: torch.Tensor, kind: str) -> torch.Tensor:
        """The concatenated payload chunks of the sparse buckets whose value
        kind is ``kind`` (``arr`` itself when every bucket has it)."""
        if all(k == kind for k in self._kinds):
            return arr
        parts = [arr[s0:s1] for (s0, s1), k
                 in zip(self._payload_slices, self._kinds) if k == kind]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def _packed_chunks(self, arr: torch.Tensor, packed) -> torch.Tensor:
        """The same for an index lane (``packed``: True, False or
        "delta")."""
        if all(p == packed for p in self._packed):
            return arr
        parts = [arr[s0:s1] for (s0, s1), p
                 in zip(self._payload_slices, self._packed) if p == packed]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def _sort_delta_payload(self, values: torch.Tensor,
                            indices: torch.Tensor):
        """Sort each ``int8_delta_idx`` bucket's payload slice by canonical
        position (the in-row clipped index, so padded sentinel slots sort
        inside their row), values and indices together, stably — the
        Elias-Fano precondition. Rows occupy disjoint ascending ranges, so
        no slot moves across rows and the row map stays valid."""
        values, indices = values.clone(), indices.clone()
        for s0, s1, off, num in self._delta_sort:
            seg = indices[s0:s1]
            o = torch.as_tensor(off, dtype=seg.dtype, device=seg.device)
            hi = torch.as_tensor(num - 1, dtype=seg.dtype, device=seg.device)
            canon = o + torch.minimum(torch.clamp(seg - o, min=0), hi)
            order = torch.argsort(canon, stable=True)
            values[s0:s1] = values[s0:s1][order]
            indices[s0:s1] = seg[order]
        return values, indices

    def encode(self, values: torch.Tensor, indices: torch.Tensor, mem,
               checksum: bool = False):
        """One worker's payload onto the wire lanes. Returns ``(lanes,
        flags)``: ``lanes`` maps a lane name to its tensor — ``"q"`` int8
        bytes (the int8 payload, then the int4 nibbles), ``"f32"`` (the
        native values in the state's dtype, then the int8 row scales and
        the int4 bucket scales, all f32 where there are several parts),
        ``"f16"``, ``"words"`` (codec words, then Elias-Fano words, int32)
        and ``"idx"`` (plain offsets in :attr:`index_dtype`) — and
        ``flags`` [payload] bool, this worker's transmit record: the
        pre-encoding non-sentinel slots, less the int8 slots under int8
        error feedback. Under int8 error feedback ``mem`` takes the
        rounding residual: the velocity keeps ``v - q * scale`` at the int8
        slots and, under momentum masking, the momentum is zeroed there
        now instead of on the next read. With ``checksum`` the sparse
        buckets' checksum words (over the value lane as shipped and the
        indices as the receiver decodes them) follow the codec words on
        ``"words"``, or the offsets on ``"idx"``."""
        if self._delta_sort:
            with phase("pack"):
                values, indices = self._sort_delta_payload(values, indices)
        wc = self._wire_consts(values.device)
        kp = self._kind_payload
        lanes, q_parts, f32_parts = {}, [], []
        flags = indices != self.layout.sentinel
        scale = scale4 = None
        if kp.get("i8"):
            v8 = self._kind_chunks(values, "i8")
            rm = wc["row_map"]
            with phase("pack"):
                smax = torch.full((self._i8_rows,), -math.inf,
                                  dtype=v8.dtype, device=v8.device
                                  ).scatter_reduce(0, rm, v8.abs(), "amax")
                scale = kernels.divide_exact(smax, 127.0).to(torch.float32)
                safe = torch.where(scale > 0, scale, 1.0)
                q = torch.clamp(torch.round(v8 / safe[rm]), -127, 127).to(
                    torch.int8)
            q_parts.append(q)
            if getattr(self.c, "int8_error_feedback", False):
                vc, mc = mem["velocities_c"], mem["momentums_c"]
                idx8 = self._kind_chunks(indices, "i8").long()
                dequant = (q.to(torch.float32) * scale[rm]).to(vc.dtype)
                vc.index_add_(0, idx8, -dequant)
                if self.c.memory.momentum_masking:
                    mc.index_fill_(0, idx8, 0.0)
                flags = flags & (~wc["i8_slots"] if wc["i8_slots"]
                                 is not None else torch.zeros_like(flags))
        if kp.get("i4"):
            v4 = self._kind_chunks(values, "i4")
            m4 = wc["i4_map"]
            with phase("pack"):
                smax4 = torch.full((self._i4_buckets,), -math.inf,
                                   dtype=v4.dtype, device=v4.device
                                   ).scatter_reduce(0, m4, v4.abs(), "amax")
                scale4 = kernels.divide_exact(smax4, 7.0).to(torch.float32)
                safe4 = torch.where(scale4 > 0, scale4, 1.0)
                q4 = torch.clamp(torch.round(v4 / safe4[m4]), -7, 7).to(
                    torch.int32)
                q_parts += [pack_int4(q4[plo:phi])
                            for plo, phi, _, _ in self._i4_chunks]
        if kp.get("f32"):
            f32_parts.append(self._kind_chunks(values, "f32"))
        f32_parts += [x for x in (scale, scale4) if x is not None]
        if len(f32_parts) == 1:
            lanes["f32"] = f32_parts[0]
        elif f32_parts:
            lanes["f32"] = torch.cat([x.to(torch.float32)
                                      for x in f32_parts])
        if kp.get("f16"):
            lanes["f16"] = self._kind_chunks(values, "f16").to(
                torch.float16)
        if q_parts:
            lanes["q"] = q_parts[0] if len(q_parts) == 1 else torch.cat(
                q_parts)
        chk = None
        if checksum:
            # the constructor keeps the plan uniform and off int8 / int4:
            # one value lane carries the whole payload
            with phase("pack"):
                wire = lanes["f16"] if "f16" in lanes else lanes["f32"]
                canon = (self._codec.canonical(indices)
                         if self._codec is not None else indices)
                chk = integrity.payload_checksum(wire, canon,
                                                 wc["seg_ids"],
                                                 self._num_seg)
        words = []
        with phase("pack"):
            if self._codec is not None:
                words.append(self._codec.encode(
                    self._packed_chunks(indices, True)))
                if chk is not None:
                    words.append(chk)
            if self._dcodec is not None:
                words.append(self._dcodec.encode(
                    self._packed_chunks(indices, "delta")))
            if words:
                lanes["words"] = (words[0] if len(words) == 1
                                  else torch.cat(words))
            if self._plain_payload:
                lanes["idx"] = self._packed_chunks(indices, False)
                if chk is not None and self._codec is None:
                    lanes["idx"] = torch.cat([lanes["idx"],
                                              chk.to(self.index_dtype)])
        return lanes, flags

    def _decode_i4(self, g_q4: torch.Tensor, g_scale4: torch.Tensor,
                   dt) -> torch.Tensor:
        """The gathered int4 bytes [W, i4 bytes] and scales (starting at
        the [W, int4 buckets] bucket scales) -> values [W, i4 payload]."""
        parts = [unpack_int4(g_q4[:, blo:bhi], phi - plo)
                 for plo, phi, blo, bhi in self._i4_chunks]
        q = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        scale = g_scale4[:, :self._i4_buckets].to(dt)
        wc = self._wire_consts(g_q4.device)
        return q.to(dt) * scale[:, wc["i4_map"]]

    def decode(self, g, dt=torch.float32, checksum: bool = False,
               health: Optional[Dict] = None):
        """The gathered lanes (``{lane: [W, ...]}``) -> ``(values [W,
        payload] dt, indices [W, payload] index dtype)``: values dequantized
        and stitched back into payload order, indices decoded and stitched,
        then clamped — plain slots to ``[0, T)``, codec slots to their
        static rows — with anything outside routed to the sentinel. An
        armed fault plan corrupts copies of the values (at wire precision)
        and of the indices before the clamp; with ``checksum`` the lanes
        carry the senders' words, recomputed here, and ``health``
        receives the mismatch count (``"checksum_failures"``, f32)."""
        kinds = set(self._kinds)
        wc = self._wire_consts(next(iter(g.values())).device)
        if kinds == {"f16"}:
            gv = g["f16"]
        elif kinds == {"f32"}:
            gv = g["f32"]
        elif kinds == {"i8"}:
            gv = g["q"].to(dt) * g["f32"].to(dt)[:, wc["row_map"]]
        elif kinds == {"i4"}:
            gv = self._decode_i4(g["q"], g["f32"], dt)
        else:
            # a mixed plan: each value lane decoded, then the sparse
            # buckets' chunks stitched back into payload order
            kp = self._kind_payload
            n8, f32_off = kp.get("i8", 0), kp.get("f32", 0)
            lane = {"f16": g.get("f16"), "f32": g.get("f32")}
            if n8:
                lane["i8"] = g["q"][:, :n8].to(dt) * g["f32"][
                    :, f32_off:].to(dt)[:, wc["row_map"]]
            if kp.get("i4"):
                lane["i4"] = self._decode_i4(
                    g["q"][:, n8:], g["f32"][:, f32_off + self._i8_rows:],
                    dt)
            gv = torch.cat([lane[kk][:, lo:hi].to(dt)
                            for kk, lo, hi in self._val_chunks], dim=1)
        srcs = {}
        nc = self._codec.nwords if self._codec is not None else 0
        g_chk = None
        if self._codec is not None:
            srcs[True] = self._codec.decode(g["words"][:, :nc],
                                            self.index_dtype)
            if checksum:
                g_chk = g["words"][:, nc:nc + self._num_seg]
        if self._dcodec is not None:
            srcs["delta"] = self._dcodec.decode(
                g["words"][:, nc:nc + self._dcodec.nwords], self.index_dtype)
        if self._plain_payload:
            srcs[False] = g["idx"][:, :self._plain_payload]
            if checksum and self._codec is None:
                g_chk = g["idx"][:, self._plain_payload:]
        if len(srcs) == 1:
            gi = next(iter(srcs.values()))
        else:
            gi = torch.cat([srcs[p][:, lo:hi]
                            for p, lo, hi in self._idx_chunks], dim=1)
        if self._faults is not None:
            gv = _faults.corrupt_wire(self._faults, gv)
            gi = _faults.corrupt_indices(self._faults, gi)
        if checksum and health is not None:
            health["checksum_failures"] = integrity.count_mismatches(
                gv, gi, g_chk, wc["seg_ids"], self._num_seg)
        if wc["clamp_lo"] is None:
            ok = (gi >= 0) & (gi < self.T)
        else:
            ok = (gi >= wc["clamp_lo"]) & (gi < wc["clamp_hi"])
        return gv.to(dt), torch.where(ok, gi, self.layout.sentinel)

    def apply(self, g_values: torch.Tensor, g_indices: torch.Tensor,
              dense_avg: torch.Tensor, mem, rank: int, world: int,
              own_flags: Optional[torch.Tensor] = None,
              slabs: Sequence[Tuple[int, torch.Tensor]] = (),
              prev=None, op: str = "average",
              gossip_full: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One worker's receive side, from the gathered [W, payload] values
        and indices (decoded, f32; indices in range or on the sentinel),
        the averaged (and clipped) dense tail and the dense-planned
        buckets' averaged slabs ``[(bucket id, slab)]``: the averaged flat
        [P] gradient. ``own_flags`` [payload] is this worker's transmit
        record (:meth:`encode`; by default its non-sentinel gathered
        slots). Replaces ``mem``'s transmit record and dense momentum; a
        dense-planned slab gets the dense path's semantics from ``prev``
        (:meth:`_slab_state`, the state before this step's compensate).
        The payload is divided by ``world`` only under ``op="average"``
        (the reference's decompress: any other op sums). ``gossip_full``
        (a bool device scalar, gossip plans only): the scattered payload
        feeds the parameters on a full round and only ``mem``'s
        ``gossip_inbox`` on a gossip round, split before the dense slabs
        are written (they always reach the parameters)."""
        T, S = self.T, self.layout.sentinel
        g_indices = torch.where((g_indices >= 0) & (g_indices < T),
                                g_indices, S)
        if own_flags is None:
            own_flags = g_indices[rank] != S
        flags = torch.zeros(g_indices.shape, dtype=torch.bool,
                            device=g_indices.device)
        flags[rank] = own_flags
        # the one narrowing of an int64 index wire, where the buffer is
        # under 2**31 slots; at or above, the apply takes the int64 wire
        # (its 64-bit kernel)
        idx = g_indices.reshape(-1)
        if not kernels.index64(T):
            idx = idx.to(torch.int32)
        with phase("apply"):
            acc, mem["sent_bits"] = kernels.apply_rows(
                g_values.reshape(-1), idx, flags.reshape(-1), T,
                divisor=float(world) if op == "average" else None)
        if os.environ.get("DGC_VERIFY_MUTATE", "") == "drop_foldback":
            # a seeded mutation the verifier must catch: the transmit
            # record is lost, so the next compensate re-sends the payload
            mem["sent_bits"] = torch.zeros_like(mem["sent_bits"])
        if gossip_full is not None:
            with phase("apply"):
                mem["gossip_inbox"] = torch.where(
                    gossip_full, 0.0, acc).to(self.state_dtype)
                acc = torch.where(gossip_full, acc, 0.0)
        if not slabs and self.layout.total == T:
            return acc
        with phase("dense"):
            if slabs:
                mc_prev, vc_prev, bits_prev = prev
                keep = kernels.keep_from_bits(bits_prev, T)
                for (bi, slab), mp, vp in zip(slabs, mc_prev, vc_prev):
                    b = self.buckets[bi]
                    lo, hi = b.base, b.base + b.rows * b.cols
                    k = keep[lo:hi].to(vp.dtype)
                    if self.c.memory.momentum_masking:
                        mp = mp * k
                    out, mem["momentums_c"][lo:hi] = self._compensate_dense(
                        mp, slab)
                    mem["velocities_c"][lo:hi] = vp * k
                    acc[lo:hi] = out
            if self.layout.total == T:
                return acc
            out_d, mem["momentums_d"] = self._compensate_dense(
                mem["momentums_d"], dense_avg)
            return torch.cat([acc, out_d])

    def _slab_state(self, mem):
        """The dense-planned buckets' momentum and velocity before this
        step's compensate writes them, and the transmit record they are
        masked with: ``(mc slabs, vc slabs, bits)``."""
        regions = [(self.buckets[bi].base, self.buckets[bi].base
                    + self.buckets[bi].rows * self.buckets[bi].cols)
                   for bi in self._dense_ids]
        return ([mem["momentums_c"][lo:hi].clone() for lo, hi in regions],
                [mem["velocities_c"][lo:hi].clone() for lo, hi in regions],
                mem["sent_bits"])

    def _dense_combine(self, blocks: Sequence[torch.Tensor], comm,
                       op: str = "average") -> List[torch.Tensor]:
        """The dense collective: each local worker's average of
        ``blocks`` over every worker, summed on the fp16 wire under
        ``fp16_values``, divided in the blocks' dtype (an IEEE divide);
        the sum under ``"sum"``; the pairwise Adasum under ``"adasum"``
        (full precision: an fp16 wire would overflow its dot products)."""
        if op == "adasum":
            from dgc_tpu_torch.optim.adasum import adasum_allreduce
            return adasum_allreduce(list(blocks), comm)
        dt = blocks[0].dtype
        fp16 = getattr(self.c, "fp16_values", False)
        sums = comm.all_reduce([b.to(torch.float16) if fp16 else b
                                for b in blocks])
        if op == "sum":
            return [x.to(dt) for x in sums]
        return [kernels.divide_exact(x.to(dt), comm.world) for x in sums]

    def _clipping(self) -> bool:
        return self.c.memory.gradient_clipping is not None

    def _exchange_dense(self, flat_grads: Sequence[torch.Tensor], mems,
                        comm, op: str = "average", telemetry: bool = False):
        """The all-dense exchange (ratio >= 1, nothing compressed, or an
        all-dense plan): the average of the whole flat gradient, clipped,
        then the non-accumulating correction of all of it. A transmit
        record still pending from a compressed step is folded into the
        memory first (the velocity, and the momentum under
        ``momentum_masking``, zeroed where it was sent) and reset, so the
        next compressed step reads the dense steps' momentum and an empty
        record. Returns ``(outputs, clip deltas)``, the deltas (of the
        averaged gradient's norm) with ``telemetry`` only."""
        T = self.T
        avgs = self._dense_combine(list(flat_grads), comm, op)
        deltas = None
        if telemetry:
            deltas = [_zero(a.device) for a in avgs]
        if self._clipping():
            pre = [taps.l2(a) for a in avgs] if telemetry else None
            avgs = self._clip_block(avgs, self.layout.names, 0)
            if telemetry:
                deltas = [_clip_delta(p, a) for p, a in zip(pre, avgs)]
        outs = []
        for avg, mem in zip(avgs, mems):
            if T:
                kernels.vtag(mem["momentums_c"], "dgcver.src.momentum")
                kernels.vtag(mem["velocities_c"], "dgcver.src.residual")
                keep = kernels.keep_from_bits(mem["sent_bits"], T).to(
                    mem["velocities_c"].dtype)
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
        return outs, deltas

    def _transmitted(self, values: torch.Tensor, int8_ef: bool):
        """``(sum of squares, sum of |.|)`` of the values this worker's
        transmit record will hold (the deferred-masking slots: under int8
        error feedback none of a uniform int8 plan's, the non-int8 slots
        of a mixed one), f32; ``(None, None)`` where the velocity already
        is the residual."""
        if int8_ef and self._i8_slot_mask is None:
            return None, None
        vf = values.to(torch.float32)
        if int8_ef:
            vf = torch.where(self._wire_consts(vf.device)["i8_slots"], 0.0,
                             vf)
        return taps.sumsq(vf), torch.sum(torch.abs(vf))

    def _telemetry_stats(self, grad_norm, clip_delta, mem, sel,
                         tx_energy=None, tx_abs=None):
        """One worker's ``STEP_METRICS`` dict (see ``telemetry.taps``) over
        its memory after the exchange. ``sel`` is sparsify's
        ``stats_out``, or None on the all-dense path (zero payload, zero
        wire). ``tx_energy`` / ``tx_abs`` — the transmitted values' sum of
        squares and of |.| for the deferred-masking residual identity:
        under deferred masking the velocity still holds exactly the
        transmitted values at the transmitted slots, which the next
        compensate zeroes, so the residual's energy is the velocity's
        minus theirs (and its mass likewise); None means the velocity
        already is the residual (the dense path, int8 error feedback)."""
        dev = grad_norm.device
        if sel is None:
            sel = taps.empty_bucket_stats(len(self.buckets), dev)
            wire = 0.0
        else:
            wire = float(self.wire_bytes_per_worker())
        vc = mem["velocities_c"]
        mom = torch.sqrt(taps.l2(mem["momentums_c"]) ** 2
                         + taps.l2(mem["momentums_d"]) ** 2)
        if tx_energy is None:
            res, mass = taps.l2(vc), taps.l1(vc)
        else:
            res = torch.sqrt(torch.clamp(taps.sumsq(vc) - tx_energy,
                                         min=0.0))
            mass = torch.clamp(taps.l1(vc) - tx_abs, min=0.0)
        return taps.assemble_step_stats(
            grad_norm=grad_norm, momentum_norm=mom, residual_norm=res,
            residual_mass=mass, clip_delta=clip_delta,
            payload_elems=sel["payload_elems"],
            wire_bytes=torch.full((), wire, dtype=torch.float32,
                                  device=dev),
            selected_frac=sel["selected_frac"], threshold=sel["threshold"])

    def exchange(self, flat_grads: Sequence[torch.Tensor], mems,
                 phases, comm, op: str = "average", local_comm=None,
                 health: Optional[Dict] = None, telemetry: bool = False,
                 send_frac: Optional[Sequence] = None):
        """compress -> encode -> all_gather (one a lane) -> decode -> apply
        for this process's workers (``comm.ranks``), plus one all-reduce of
        the dense-planned slabs and the dense tail; all dense,
        :meth:`_exchange_dense`. Under the memory's ``gradient_clipping``
        every worker's local compressed block is clipped before the
        compensate, and the averaged dense slabs and tail before their
        correction. ``op``: the combine (:data:`OPS`); ``local_comm``: the
        two-tier exchange's node group (``comm`` is then the cross group);
        ``health``: receives the checksum's mismatch count. Returns each
        worker's combined flat gradient; the memories update in place.

        ``send_frac``: each local worker's adaptive send fraction (floats
        or f32 device scalars), applied to its payload after the selection
        (:meth:`mask_send_frac`); the all-dense path ignores it.
        ``telemetry=True`` returns ``(outputs, stats)``, ``stats[w]``
        local worker w's ``STEP_METRICS`` dict on the device
        (:meth:`_telemetry_stats`; ``payload_elems`` counted after the
        send-fraction mask, ``selected_frac`` and ``threshold`` before
        it)."""
        if op not in OPS:
            raise ValueError(f"op must be one of {OPS}, got {op!r}")
        if local_comm is not None and local_comm.world > 1:
            flat_grads = node_mean(flat_grads, local_comm, op)
        kernels.vtag(flat_grads, "dgcver.src.grad")
        gnorms = [taps.l2(g) for g in flat_grads] if telemetry else None
        if self.dense:
            outs, deltas = self._exchange_dense(flat_grads, mems, comm, op,
                                                telemetry)
            if not telemetry:
                return outs
            return outs, [self._telemetry_stats(gn, cd, m, None)
                          for gn, cd, m in zip(gnorms, deltas, mems)]
        T, world, S = self.T, comm.world, self.layout.sentinel
        g_cfg = self._gossip
        if g_cfg is not None:
            if world != g_cfg.world:
                raise ValueError(
                    f"gossip plan was built for world={g_cfg.world} but "
                    f"exchange runs with world_size={world} — replan for "
                    "the current cohort")
            if op != "average":
                raise ValueError(
                    "gossip regimes require op='average': the neighbor "
                    f"mixing weights fold into the averaging divide "
                    f"(got op={op!r})")
            # the round's classification from the memory's (replicated)
            # clock and ages, on the device: every worker computes the
            # same values, no collective
            g_clock = mems[0]["gossip_clock"]
            g_forced0 = mems[0]["gossip_forced"]
            g_dropped = _faults.gossip_dropped(self._faults, world, g_clock)
            g_full, g_forced, g_new_age = _gossip_sched.round_state(
                g_cfg, g_clock, mems[0]["gossip_age"], g_dropped)
        chk = self.checksum and health is not None
        blocks = [g[:T] for g in flat_grads]
        deltas = ([_zero(b.device) for b in blocks] if telemetry
                  else None)
        if self._clipping():
            pre = [taps.l2(b) for b in blocks] if telemetry else None
            blocks = self._clip_block(blocks, self.layout.compressed_names,
                                      0)
            if telemetry:
                deltas = [_clip_delta(p, b) for p, b in zip(pre, blocks)]
        prev = ([self._slab_state(m) for m in mems] if self._dense_ids
                else [None] * len(mems))
        sel = [{} if telemetry else None for _ in mems]
        sent = [self.compress(g, m, ph, stats_out=st)
                for g, m, ph, st in zip(blocks, mems, phases, sel)]
        if send_frac is not None and self._adaptive_rank is not None:
            sent = [self.mask_send_frac(v, i, f)
                    for (v, i), f in zip(sent, send_frac)]
            if telemetry:
                for st, (_, i) in zip(sel, sent):
                    # the wire's real elements, after the mask (the
                    # selection's stats describe the selection)
                    st["payload_elems"] = torch.sum(
                        (i != S).to(torch.float32))
        if telemetry:
            int8_ef = bool(self._kind_payload.get("i8")) and getattr(
                self.c, "int8_error_feedback", False)
            tx = [self._transmitted(v, int8_ef) for v, _ in sent]
        wires = [self.encode(v, i, m, checksum=chk)
                 for (v, i), m in zip(sent, mems)]
        local_idx = [i for _, i in sent]
        del sent
        with phase("allgather"):
            gathered = {k: comm.all_gather([lanes[k] for lanes, _ in wires])
                        for k in wires[0][0]}
        # the dense-planned slabs (the unclipped gradient) and the tail on
        # one all-reduce
        regions = [(bi, self.buckets[bi].base,
                    self.buckets[bi].base
                    + self.buckets[bi].rows * self.buckets[bi].cols)
                   for bi in self._dense_ids]
        with phase("dense"):
            dwire = [torch.cat([g[lo:hi] for _, lo, hi in regions]
                               + [g[T:]])
                     if regions else g[T:] for g in flat_grads]
            davgs = (self._dense_combine(dwire, comm, op)
                     if dwire[0].numel() else dwire)
            slabs, off = [[] for _ in mems], 0
            for bi, lo, hi in regions:
                part = [d[off:off + hi - lo] for d in davgs]
                if self._clipping():
                    part = self._clip_block(
                        part, self.layout.buckets[bi].names, lo)
                for w, x in enumerate(part):
                    slabs[w].append((bi, x))
                off += hi - lo
            tails = [d[off:] for d in davgs]
            if self._clipping() and self.layout.total > T:
                tails = self._clip_block(tails, self.layout.dense_names, T)
        outs = []
        for li, (mem, r) in enumerate(zip(mems, comm.ranks)):
            # every receiver counts the same mismatches; the first's stand
            with phase("decode"):
                gv, gi = self.decode({k: v[li] for k, v in gathered.items()},
                                     checksum=chk,
                                     health=health if li == 0 else {})
            kernels.vtag(gv, "dgcver.wire_values")
            kernels.vtag(gi, "dgcver.wire_indices")
            if g_cfg is not None:
                # the round on the one gathered wire: each sender's row
                # weighed (in the values' own dtype, as the reference
                # multiplies them) before the apply's division by W
                sdt = self.state_dtype
                rw = _gossip_sched.row_weights(g_cfg, g_clock, r, g_full,
                                               g_dropped)
                gv = (gv.to(sdt) * rw[:, None].to(sdt)).to(gv.dtype)
            outs.append(self.apply(gv, gi, tails[li], mem, r, world,
                                   own_flags=wires[li][1], slabs=slabs[li],
                                   prev=prev[li], op=op,
                                   gossip_full=(g_full if g_cfg is not None
                                                else None)))
            if self._faults is not None and self._faults.badidx is not None:
                # the record is what this worker sent, not what a corrupted
                # wire delivered back to it (the reference packs the local
                # indices): rebuilt only under the fault drill
                mem["sent_bits"] = kernels.pack_sent_bits(
                    torch.where(wires[li][1], local_idx[li], S), T,
                    sentinel=S)
            if g_cfg is not None:
                if g_dropped is not None:
                    # the round carried none of a dropped worker's mass:
                    # its record is voided, so the mass stays in its
                    # residual for a later round
                    mem["sent_bits"] = torch.where(
                        g_dropped[r], torch.zeros_like(mem["sent_bits"]),
                        mem["sent_bits"])
                mem["gossip_clock"] = g_clock + 1
                mem["gossip_age"] = g_new_age
                mem["gossip_forced"] = g_forced0 + g_forced.to(torch.int32)
            kernels.vtag(mem["momentums_c"], "dgcver.sink.momentum")
            kernels.vtag(mem["velocities_c"], "dgcver.sink.residual")
            kernels.vtag(mem["sent_bits"], "dgcver.sink.sent_bits")
        if not telemetry:
            return outs
        return outs, [self._telemetry_stats(gn, cd, m, st, *t)
                      for gn, cd, m, st, t in zip(gnorms, deltas, mems, sel,
                                                  tx)]


def _zero(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=device)


def _clip_delta(pre: torch.Tensor, clipped: torch.Tensor) -> torch.Tensor:
    """The clip's relative reduction of a norm: ``(pre - |clipped|) /
    max(pre, 1e-12)``."""
    return (pre - taps.l2(clipped)) / torch.clamp(pre, min=1e-12)


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
                 phases, comm, op: str = "average", local_comm=None,
                 health: Optional[Dict] = None, telemetry: bool = False,
                 send_frac: Optional[Sequence] = None):
        """Each local worker's averaged flat gradient: the compressor's
        own compress (to the wire) and decompress (the average) around
        the all-reduce (``mems`` and ``phases`` are unused; the dense
        all-reduce has no payload to checksum, so ``health`` is too, and
        no quota for ``send_frac`` to shrink). Two tiers: the node mean
        first, in full precision (the fp16 wire casts only for the cross
        group, after the divide). ``"sum"`` skips the divide;
        ``"adasum"`` combines pairwise. ``telemetry=True`` returns
        ``(outputs, stats)``: each worker's gradient norm, the rest 0 (no
        sparse payload, no error-feedback state; ``wire_bytes`` is the
        sparse wire's and stays 0)."""
        if op not in OPS:
            raise ValueError(f"op must be one of {OPS}, got {op!r}")
        stats = None
        if telemetry:
            # the local gradient's norm, before any node mean (the
            # reference's dense engine taps it first)
            stats = []
            for g in flat_grads:
                z = _zero(g.device)
                stats.append(taps.assemble_step_stats(
                    grad_norm=taps.l2(g), momentum_norm=z, residual_norm=z,
                    residual_mass=z, clip_delta=z, wire_bytes=z,
                    **taps.empty_bucket_stats(0, g.device)))
        if local_comm is not None and local_comm.world > 1:
            flat_grads = node_mean(flat_grads, local_comm, op)
        if op == "adasum":
            from dgc_tpu_torch.optim.adasum import adasum_allreduce
            outs = adasum_allreduce(list(flat_grads), comm)
        else:
            sent = [self.c.compress(None, None, g, None)[:2]
                    for g in flat_grads]
            totals = comm.all_reduce([wire for wire, _ in sent])
            world = comm.world if op == "average" else 1
            outs = [self.c.decompress(t, ctx, None, world)[0]
                    for t, (_, ctx) in zip(totals, sent)]
        return (outs, stats) if telemetry else outs
