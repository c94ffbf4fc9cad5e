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

from typing import Any, NamedTuple, Optional, Tuple

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

    def initialize(self, named_params) -> None:
        """Precompute static per-tensor attributes (no-op for dense)."""

    def compress(self, mem_state, name, grad, phase):
        raise NotImplementedError

    def communicate(self, payloads, ctx: CompressCtx, comm):
        raise NotImplementedError

    def decompress(self, gathered, ctx: CompressCtx, mem_state,
                   world_size: int):
        raise NotImplementedError


class _DenseCompressor(Compressor):
    """Shared dense path: the payload is the whole gradient, the collective
    a sum, and decompress averages."""

    def _wire(self, grad):
        return grad

    def _unwire(self, grad, dtype):
        return grad

    def make_flat_exchange(self, layout):
        raise ValueError("the flat dense exchange (FlatDenseExchange) is not "
                         "ported yet (ROADMAP.md queue 1 item 2)")

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
