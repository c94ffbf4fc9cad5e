"""DGCCompressor — sampled top-k sparsification with momentum correction.

Counterpart of ``dgc_tpu/compression/dgc.py``. The host-side half
(``sampling_geometry``, ``initialize``, ``warmup_compress_ratio``) serves
both paths:

* the per-tensor path, the reference DGC's own API and the oracle the flat
  engine is held against: ``compress`` (the memory's compensate — the
  ``fused_compensate`` kernel, batched over every tensor of every local
  worker by ``compensate_all`` — then :meth:`DGCCompressor.sparsify` and
  the memory's update), ``communicate``, ``exchange_fused`` and ``decompress``,
  tensor by tensor, with the f32, fp16 (``fp16_values``) or int8
  (``int8_values``, with or without ``int8_error_feedback``) wire;
* the flat engine (:mod:`dgc_tpu_torch.compression.flat`,
  :meth:`DGCCompressor.make_flat_exchange`), with f32 or bf16 state, the
  f32, fp16 (``fp16_values``) and int8 (``int8_values``, with or without
  ``int8_error_feedback``) value wires, bit-packed indices
  (``packed_indices``), the int64 index wire (``int32_indices=False``),
  a per-bucket plan of the planner's regimes, and two of the reference's
  opt-in fused paths: ``fused_select`` (the select-and-pack kernel on the
  2-D buckets) and ``megakernel`` (the forward megakernel on the buckets
  it owns, the spans between them on the compensate kernel; also
  ``DGC_MEGAKERNEL=1``; f32 state only). The fused paths change no
  result, only the kernels that compute it. ``checksum`` (the payload
  integrity checksum) is refused by the flat engine: ROADMAP.md queue 1
  item 8.

The strided sample's phase is drawn on the host (:meth:`DGCCompressor.
draw_phases`) where the reference folds a PRNG key per tensor.
"""

import math
from typing import Dict, NamedTuple, Tuple

import torch

from dgc_tpu_torch.compression.base import CompressCtx, Compressor
from dgc_tpu_torch.compression.flat import FlatDGCEngine
from dgc_tpu_torch.compression.memory import DGCSGDMemory
from dgc_tpu_torch.ops import kernels
from dgc_tpu_torch.ops import sparsify as ops

__all__ = ["DGCCompressor", "TensorAttrs", "sampling_geometry",
           "quantize_int8"]


class TensorAttrs(NamedTuple):
    """Static per-tensor sparsification geometry."""
    numel: int
    shape: Tuple[int, ...]
    num_selects: int
    num_samples: int
    top_k_samples: int
    sample_stride: int


def sampling_geometry(numel: int, sample_ratio: float,
                      compress_ratio: float) -> Tuple[int, int]:
    """``(num_samples, sample_stride)``: the stride starts at
    ``ceil(numel / max(pct, cpr) / 32) * 32 + 1`` and backs off by 8 until
    at least ``max(pct_numel, cpr_numel)`` samples fit."""
    if sample_ratio >= 1.0:
        return numel, 1
    pct_numel = int(math.ceil(numel * sample_ratio))
    cpr_numel = int(math.ceil(2 / compress_ratio))
    if numel <= cpr_numel:
        return numel, 1
    sample_stride = int(math.ceil(numel / max(pct_numel, cpr_numel) / 32)) * 32 + 1
    num_samples = numel // sample_stride
    while num_samples < max(pct_numel, cpr_numel) and sample_stride > 8:
        sample_stride -= 8
        num_samples = numel // sample_stride
    return num_samples, sample_stride


def quantize_int8(values: torch.Tensor):
    """Symmetric per-vector int8 quantization: ``(q, scale)`` with ``scale =
    max|values| / 127`` (in the values' dtype, then f32) and round half to
    even; an all-zero vector quantizes to zeros with scale 0. Dequantized,
    ``q * scale`` is within scale/2 of each value."""
    vmax = (values.abs().max() if values.numel()
            else values.new_zeros(()))
    scale = (vmax / torch.tensor(127.0, dtype=vmax.dtype,
                                 device=vmax.device)).to(torch.float32)
    safe = torch.where(scale > 0, scale, 1.0)
    q = torch.clamp(torch.round(values / safe), -127, 127).to(torch.int8)
    return q, scale


class DGCCompressor(Compressor):
    """Deep Gradient Compression: momentum-corrected sampled top-k with
    bounded threshold adaptation and the epoch-wise warm-up schedule.
    It behaves as the reference's with ``approx_recall`` set (its
    default): the segment path is taken wherever the reference takes it."""

    def __init__(self, compress_ratio: float, memory: DGCSGDMemory = None,
                 sample_ratio: float = 0.01, strided_sample: bool = True,
                 compress_upper_bound: float = 1.3,
                 compress_lower_bound: float = 0.8,
                 max_adaptation_iters: int = 10, resample: bool = True,
                 fp16_values: bool = False, warmup_epochs: int = -1,
                 warmup_coeff=None,
                 fused_select: bool = False, megakernel: bool = False,
                 int8_values: bool = False,
                 int8_error_feedback: bool = True,
                 packed_indices: bool = False, int32_indices: bool = True,
                 checksum: bool = False, verbose: bool = False):
        if int8_values and fp16_values:
            raise ValueError("int8_values and fp16_values are mutually "
                             "exclusive wire formats")
        #: the wire: fp16 values, or int8 values with one f32 scale per
        #: tensor (the rounding residual fed back into the velocity under
        #: ``int8_error_feedback``)
        self.fp16_values = fp16_values
        self.int8_values = int8_values
        self.int8_error_feedback = int8_error_feedback
        #: flat engine only: tensor-local indices bit-packed in
        #: ``ceil(log2 numel)`` bits (``wirecodec.IndexCodec``); the
        #: per-tensor path ignores it (a wire format, not numerics)
        self.packed_indices = packed_indices
        #: flat engine only: int32 wire indices (the reference's flag);
        #: False ships them as int64
        self.int32_indices = int32_indices
        #: flat engine only: the payload checksum, which the port's engine
        #: refuses (ROADMAP.md queue 1 item 8)
        self.checksum = checksum
        self.base_compress_ratio = self.compress_ratio = (
            compress_ratio if compress_ratio <= 1.0 else 1.0 / compress_ratio)
        self.memory = DGCSGDMemory() if memory is None else memory
        self.warmup_epochs = warmup_epochs
        #: the warm-up: a scalar coefficient c gives epoch e the ratio
        #: ``max(c ** (e + 1), compress_ratio)`` (by default c = ratio **
        #: (1 / (epochs + 1))); a list gives epoch e ``warmup_coeff[e]``
        #: (``[1] * 5`` trains the first five epochs dense)
        if warmup_epochs <= 0:
            self.warmup_coeff = 1
        elif warmup_coeff is None:
            self.warmup_coeff = self.base_compress_ratio ** (
                1.0 / (warmup_epochs + 1))
        else:
            coeffs = (warmup_coeff if isinstance(warmup_coeff, (tuple, list))
                      else [warmup_coeff] * warmup_epochs)
            if len(coeffs) < warmup_epochs or not all(0 < c <= 1
                                                      for c in coeffs):
                raise ValueError(f"warmup_coeff {warmup_coeff}: values in "
                                 f"(0, 1], {warmup_epochs} of them in a "
                                 "list")
            self.warmup_coeff = warmup_coeff
        self.sample_ratio = min(max(sample_ratio, 0.01), 1.0)
        #: strided lane-block samples (True) or uniform positions drawn
        #: with replacement (False)
        self.strided_sample = strided_sample
        #: without ``resample`` the adaptation also raises the threshold
        #: (x ``compress_upper_bound``) while too many elements pass
        self.compress_upper_bound = compress_upper_bound
        self.compress_lower_bound = compress_lower_bound
        self.max_adaptation_iters = max_adaptation_iters
        self.resample = resample
        #: read by the flat engine: the select-and-pack kernel, and the
        #: forward megakernel (flat.py, the module docstring)
        self.fused_select = fused_select
        self.megakernel = megakernel
        self.verbose = verbose
        self.attributes: Dict[str, TensorAttrs] = {}

    def initialize(self, named_shapes) -> None:
        """Static attributes for every compressed tensor. ``named_shapes``
        yields ``(name, shape)``, ``(name, tensor)`` or ``(name,
        TensorAttrs)`` (the re-initialisation on a ratio change)."""
        for name, param in named_shapes:
            if isinstance(param, TensorAttrs):
                shape = param.shape
            else:
                shape = tuple(getattr(param, "shape", param))
            numel = int(math.prod(shape))
            num_samples, sample_stride = sampling_geometry(
                numel, self.sample_ratio, self.compress_ratio)
            top_k_samples = int(math.ceil(num_samples * self.compress_ratio))
            num_selects = int(math.ceil(numel * self.compress_ratio))
            self.attributes[name] = TensorAttrs(
                numel=numel, shape=shape, num_selects=num_selects,
                num_samples=num_samples, top_k_samples=top_k_samples,
                sample_stride=sample_stride)
            if self.verbose:
                print(f"   {name:<40}: transmit {num_selects} / {numel} "
                      f"(threshold {top_k_samples} / {num_samples} samples "
                      f"at stride {sample_stride})")

    def warmup_compress_ratio(self, epoch: int) -> bool:
        """Epoch hook; True when the ratio changed, and the engine must then
        be rebuilt (its geometry is ratio-derived)."""
        if self.warmup_epochs > 0 and epoch < self.warmup_epochs:
            if isinstance(self.warmup_coeff, (tuple, list)):
                compress_ratio = self.warmup_coeff[epoch]
            else:
                compress_ratio = max(self.warmup_coeff ** (epoch + 1),
                                     self.base_compress_ratio)
        else:
            compress_ratio = self.base_compress_ratio
        if compress_ratio != self.compress_ratio:
            self.compress_ratio = compress_ratio
            self.initialize(list(self.attributes.items()))
            return True
        return False

    def draw_phases(self, gen: torch.Generator):
        """The per-tensor path's samples, drawn on the host from ``gen``
        for every tensor that samples (numel above its sample count), in
        attribute order: ``{name: start in [0, stride)}`` of the strided
        sample, or ``{name: [num_samples] positions}`` of the uniform one
        (``strided_sample=False``)."""
        if not self.strided_sample:
            return {n: ops.draw_positions(gen, a.num_samples, a.numel)
                    for n, a in self.attributes.items()
                    if a.numel > a.num_samples}
        return {n: ops.draw_phase(gen, a.sample_stride)
                for n, a in self.attributes.items()
                if a.numel > a.num_samples}

    # -------------------------------------------------------------- #
    # the per-tensor path                                            #
    # -------------------------------------------------------------- #

    def sparsify(self, grad: torch.Tensor, name: str, phase=0):
        """Fixed-size sampled top-k of one tensor: the threshold is the
        ``top_k_samples``-th largest |sample|, adapted over the whole
        tensor where it samples, then :func:`ops.select_by_threshold`.
        ``phase`` is what :meth:`draw_phases` drew for the tensor.
        Returns ``(values, int32 indices, valid)`` of ``num_selects``
        slots, in the gradient's dtype (bf16 under the bf16 memory)."""
        attrs = self.attributes[name]
        flat = grad.reshape(-1)
        importance = flat.abs()
        if attrs.numel == attrs.num_samples:
            samples = importance
        elif self.strided_sample:
            samples = ops.strided_sample(importance, attrs.num_samples,
                                         attrs.sample_stride, phase)
        else:
            samples = ops.uniform_sample(importance, phase)
        threshold = ops.topk_threshold(samples, attrs.top_k_samples)
        if attrs.numel > attrs.num_samples:
            threshold = ops.adapt_threshold(
                importance, threshold, attrs.num_selects,
                self.compress_lower_bound, self.compress_upper_bound,
                self.max_adaptation_iters, self.resample)
        return ops.select_by_threshold(flat, importance, threshold,
                                       attrs.num_selects)

    def compensate_all(self, mem_states, grads):
        """The memory's accumulating compensate of every compressed tensor
        of every local worker in one batched call (``grads[w]`` maps names
        to worker w's gradients; the memories update in place). Returns
        ``[{name: compensated velocity}]`` per worker, to be handed to
        :meth:`compress`, or None where the memory has no batched
        compensate (:meth:`compress` then compensates tensor by tensor).
        Each compensate reads and writes only its own name's state, so
        doing them all first changes no result."""
        batched = getattr(self.memory, "compensate_all", None)
        if batched is None:
            return None
        names = [n for n in grads[0]
                 if self.compress_ratio < 1.0 and n in self.attributes]
        vecs = iter(batched([(mem, n, g[n]) for mem, g in zip(mem_states,
                                                               grads)
                             for n in names]))
        return [{n: next(vecs) for n in names} for _ in grads]

    def compress(self, mem_state, name: str, grad: torch.Tensor,
                 phase=0, compensated=None):
        """Momentum-corrected sparsification of a compressed tensor (the
        memory updates in place; the payload's values are gathered before
        the memory's update zeroes them), or the dense payload of any other.
        ``compensated``: the velocity :meth:`compensate_all` already
        compensated from ``grad``, else the memory compensates it here.
        Returns ``(payload, ctx, mem_state)``: ``(values, indices)``,
        ``(q, indices, scale)`` under ``int8_values``, or the gradient."""
        if self.compress_ratio < 1.0 and name in self.attributes:
            attrs = self.attributes[name]
            if compensated is None:
                compensated, mem_state = self.memory.compensate(
                    mem_state, name, grad, accumulate=True)
            values, indices, valid = self.sparsify(compensated, name, phase)
            mem_state = self.memory.update(mem_state, name, indices, valid)
            ctx = CompressCtx(name=name, numel=attrs.numel, shape=attrs.shape,
                              dtype=grad.dtype, compressed=True)
            if self.int8_values:
                q, scale = quantize_int8(values)
                if self.int8_error_feedback:
                    # what travels is q * scale: the rounding residual goes
                    # back into the velocity update() just zeroed
                    residual = torch.where(
                        valid, values - q.to(values.dtype)
                        * scale.to(values.dtype), 0.0)
                    mem_state = self.memory.feed_back(mem_state, name,
                                                      indices, residual)
                return (q, indices, scale), ctx, mem_state
            if self.fp16_values and values.is_floating_point():
                values = values.to(torch.float16)
            return (values, indices), ctx, mem_state
        ctx = CompressCtx(name=name, numel=grad.numel(),
                          shape=tuple(grad.shape), dtype=grad.dtype,
                          compressed=False)
        payload = grad
        if self.fp16_values and grad.is_floating_point():
            payload = grad.to(torch.float16)
        return payload, ctx, mem_state

    def communicate(self, payloads, ctx: CompressCtx, comm):
        """The collective over every local worker's payload: an all-gather
        of each component of a sparse payload (per worker a tuple of
        [W, ...] stacks), a sum of dense ones."""
        if ctx.compressed:
            parts = [comm.all_gather([p[i] for p in payloads])
                     for i in range(len(payloads[0]))]
            return [tuple(part[w] for part in parts)
                    for w in range(len(payloads))]
        return comm.all_reduce(payloads)

    def exchange_fused(self, compressed, comm, world_size: int, mem_states):
        """Every sparse payload in two all-gathers (values, indices; plus
        the [n_tensors] scales under int8): ``compressed[w]`` maps each
        name to ``(payload, ctx)`` for local worker w. Returns ``(outs,
        mem_states)``, ``outs[w]`` mapping names to decompressed
        gradients; each equals the unfused exchange's."""
        names = list(compressed[0])
        sizes = [compressed[0][n][0][0].shape[0] for n in names]
        g_values = comm.all_gather([torch.cat([c[n][0][0] for n in names])
                                    for c in compressed])
        g_indices = comm.all_gather([torch.cat([c[n][0][1] for n in names])
                                     for c in compressed])
        g_scales = None
        if self.int8_values:
            g_scales = comm.all_gather([torch.stack([c[n][0][2]
                                                     for n in names])
                                        for c in compressed])
        outs = []
        for w, c in enumerate(compressed):
            out, offset = {}, 0
            for i, (n, sz) in enumerate(zip(names, sizes)):
                piece = (g_values[w][:, offset:offset + sz],
                         g_indices[w][:, offset:offset + sz])
                if g_scales is not None:
                    piece = piece + (g_scales[w][:, i],)
                out[n], mem_states[w] = self.decompress(
                    piece, c[n][1], mem_states[w], world_size)
                offset += sz
            outs.append(out)
        return outs, mem_states

    def decompress(self, gathered, ctx: CompressCtx, mem_state,
                   world_size: int, op: str = "average"):
        """One worker's gradient from the gathered payloads: the
        scatter-add of every worker's values (a sum, then ``/ world_size``
        under ``op="average"``), or for a dense payload the average and the
        memory's non-accumulating correction. Returns ``(grad,
        mem_state)``."""
        avg = op == "average"
        if ctx.compressed:
            if self.int8_values:
                q, indices, scales = gathered          # [W,k], [W,k], [W]
                values = q.to(ctx.dtype) * scales[:, None].to(ctx.dtype)
            else:
                values, indices = gathered             # [W, k] each
                if self.fp16_values:
                    values = values.to(ctx.dtype)
            dense = ops.scatter_add_dense(ctx.numel, indices, values,
                                          dtype=ctx.dtype)
            if avg:
                dense = kernels.divide_exact(dense, world_size)
            return dense.reshape(ctx.shape), mem_state
        out, mem_state = self.memory.compensate(
            mem_state, ctx.name,
            self._dense_average(gathered, ctx, world_size, avg),
            accumulate=False)
        return out.reshape(ctx.shape), mem_state

    def _dense_average(self, grad, ctx: CompressCtx, world_size: int,
                       avg: bool = True):
        """A dense tensor's gathered sum off the wire, divided by the
        workers under ``avg``, in its own dtype."""
        if self.fp16_values and grad.is_floating_point():
            grad = grad.to(ctx.dtype)
        if avg:
            grad = kernels.divide_exact(grad, world_size)
        return grad.to(ctx.dtype)

    def decompress_all(self, gathered, ctx: CompressCtx, mem_states,
                       world_size: int):
        """:meth:`decompress` of one tensor for every local worker
        (``gathered[w]``, ``mem_states[w]``); a dense tensor's averages
        are clipped together, so the memory's global clipping reduces
        across the workers. Returns ``(outs, mem_states)``."""
        if ctx.compressed or self.memory.gradient_clipping is None:
            return super().decompress_all(gathered, ctx, mem_states,
                                          world_size)
        outs = []
        for i, g in enumerate(self.memory.clip(
                [self._dense_average(g, ctx, world_size).reshape(-1)
                 for g in gathered])):
            out, mem_states[i] = self.memory.compensate(
                mem_states[i], ctx.name, g, accumulate=False, clipped=True)
            outs.append(out.reshape(ctx.shape))
        return outs, mem_states

    def make_flat_exchange(self, layout, plan=None):
        """The flat-buffer engine over ``layout`` (``plan``: one regime per
        bucket, see :class:`FlatDGCEngine`); call again after every ratio
        change."""
        return FlatDGCEngine(self, layout, plan=plan)
