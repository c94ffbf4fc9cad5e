"""Compressor plugin boundary and the dense baseline compressors.

Counterpart of ``dgc_tpu/compression/base.py``. A compressor is used
tensor by tensor by the per-tensor exchange
(:meth:`dgc_tpu_torch.optim.distributed.DistributedOptimizer.exchange`):

* ``compress(mem_state, name, grad, phase) -> (payload, ctx, mem_state)``
* ``communicate(payload, ctx, comm) -> gathered``, for this process's
  workers at once: ``payload`` and ``gathered`` are lists with one entry
  per local worker (``comm.ranks``) — the all-gather for sparse payloads,
  the all-reduce (a sum) for dense ones;
* ``decompress(gathered, ctx, mem_state, world_size) -> (grad,
  mem_state)``, one worker's.

``phase`` is the strided sample's start (an int; see
:func:`dgc_tpu_torch.ops.sparsify.draw_phase`), where the reference passes
a PRNG key; the dense compressors ignore it.
"""

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from dgc_tpu_torch.compression.memory import Memory
from dgc_tpu_torch.ops import kernels

__all__ = ["CompressCtx", "Compressor", "NoneCompressor", "FP16Compressor",
           "Compression"]


class CompressCtx(NamedTuple):
    """Static per-tensor context threaded from compress to decompress."""
    name: Optional[str]
    numel: Optional[int]
    shape: Optional[Tuple[int, ...]]
    dtype: Any          # the value's dtype before the wire
    compressed: bool


class Compressor:
    """Interface: tensor-wise compression for the gradient exchange."""

    #: memory plugin; the identity no-op by default
    memory: Memory = Memory()
    #: the sparsifying compressors' ratio and per-tensor attributes; a
    #: dense compressor sends everything and has neither
    compress_ratio: Optional[float] = None
    attributes: Dict[str, Any] = {}

    def initialize(self, named_params) -> None:
        """Precompute static per-tensor attributes (no-op for dense)."""

    def warmup_compress_ratio(self, epoch: int) -> bool:
        """Set ``epoch``'s warm-up ratio; True if it changed (never for
        dense)."""
        return False

    def draw_phases(self, gen) -> Dict[str, int]:
        """The per-tensor sampling phases of one step (none for dense)."""
        return {}

    def compress(self, mem_state, name, grad, phase):
        raise NotImplementedError

    def communicate(self, payloads, ctx: CompressCtx, comm):
        raise NotImplementedError

    def decompress(self, gathered, ctx: CompressCtx, mem_state,
                   world_size: int):
        raise NotImplementedError

    def decompress_all(self, gathered, ctx: CompressCtx, mem_states,
                       world_size: int):
        """:meth:`decompress` of one tensor for every local worker
        (``gathered[w]``, ``mem_states[w]``). Returns ``(outs,
        mem_states)``."""
        res = [self.decompress(g, ctx, m, world_size)
               for g, m in zip(gathered, mem_states)]
        return [r[0] for r in res], [r[1] for r in res]


class _DenseCompressor(Compressor):
    """Shared dense path: the payload is the whole gradient, the collective
    a sum, and decompress averages."""

    def _wire(self, grad):
        return grad

    def _unwire(self, grad, dtype):
        return grad

    def make_flat_exchange(self, layout):
        """The flat path's engine: one all-reduce of the whole buffer."""
        from dgc_tpu_torch.compression.flat import FlatDenseExchange
        return FlatDenseExchange(self, layout)

    def compress(self, mem_state, name, grad, phase):
        ctx = CompressCtx(name=name, numel=grad.numel(),
                          shape=tuple(grad.shape), dtype=grad.dtype,
                          compressed=False)
        return self._wire(grad), ctx, mem_state

    def communicate(self, payloads, ctx, comm):
        return comm.all_reduce(payloads)

    def decompress(self, gathered, ctx, mem_state, world_size):
        out = kernels.divide_exact(self._unwire(gathered, ctx.dtype),
                                   world_size)
        return out.to(ctx.dtype), mem_state


class NoneCompressor(_DenseCompressor):
    """Identity wire format."""


class FP16Compressor(_DenseCompressor):
    """fp16 on the wire for floating-point gradients: the sum runs in
    fp16, and the result is up-cast before averaging."""

    def _wire(self, grad):
        if grad.is_floating_point():
            return grad.to(torch.float16)
        return grad

    def _unwire(self, grad, dtype):
        return grad.to(dtype)


class Compression:
    """Registry of the baseline compressors."""
    none = NoneCompressor
    fp16 = FP16Compressor
