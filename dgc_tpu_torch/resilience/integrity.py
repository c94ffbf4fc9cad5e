"""Sparse-exchange integrity: index clamping and payload checksums.

Counterpart of ``dgc_tpu/resilience/integrity.py``.

**Index clamp (always on).** The engine's ``decode`` routes every
gathered index outside ``[0, T)`` (the codec slots: outside their owning
row) to the structural-zero sentinel before the apply
(``FlatDGCEngine._clamp_bounds``).

**Payload checksum (opt-in, ``DGCCompressor(checksum=True)``).** One
int32 wraparound checksum a sparse bucket over the ``(value bits,
index)`` words, computed by the sender over the exact wire forms and
recomputed by every receiver over the gathered payload. The words ride
the index lane (the plain one, or the codec word lane), so the exchange
makes no extra collective. Mismatches are counted (the guard metric
``checksum_failures``), not corrected.

The reference sums int32 words with wraparound (``jax.ops.segment_sum``);
PyTorch promotes an int32 sum to int64 and a CUDA kernel's signed
overflow is undefined, so the port computes in int64 and reduces mod
2**32 at the end: bitwise the reference's int32 words.
"""

import numpy as np
import torch

__all__ = ["bucket_segments", "payload_checksum", "count_mismatches"]

_MASK = (1 << 32) - 1
#: the reference's Knuth multiplier, as the int32 it is there
_KNUTH = -1640531527


def _as_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values mod 2**32 -> the int32 bit patterns."""
    x = x & _MASK
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def bucket_segments(buckets) -> np.ndarray:
    """The payload slot -> sparse bucket id map (payload order is bucket by
    bucket, as the engine lays out its wire)."""
    if not buckets:
        return np.zeros(0, np.int32)
    return np.concatenate([np.full(b.payload, i, np.int32)
                           for i, b in enumerate(buckets)])


def _wire_words(values: torch.Tensor) -> torch.Tensor:
    """The value lane's words as int64 in the int32 range, as the
    reference reads them: an f32's bits, an f16's 16 bits zero-extended,
    and any other dtype (the bf16 state's native lane) converted to int32
    by value, XLA's way (toward zero, saturating, NaN to 0)."""
    if values.dtype == torch.float32:
        return values.view(torch.int32).to(torch.int64)
    if values.dtype == torch.float16:
        return values.view(torch.int16).to(torch.int64) & 0xFFFF
    if values.is_floating_point():
        x = values.to(torch.float64)
        x = torch.where(torch.isnan(x), 0.0, x)
        return torch.clamp(torch.trunc(x), -2 ** 31, 2 ** 31 - 1).to(
            torch.int64)
    return values.to(torch.int64)


def payload_checksum(values: torch.Tensor, indices: torch.Tensor,
                     seg_ids: torch.Tensor, num_buckets: int
                     ) -> torch.Tensor:
    """Per-bucket int32 wraparound checksum over ``[payload]`` wire words
    (``[..., payload]`` inputs give ``[..., num_buckets]``): each slot adds
    ``(value bits XOR index * 0x9E3779B9) * (2 * position + 1)``."""
    idx = indices.to(torch.int64)
    # the index as the reference's int32 (a wrap of wider wires)
    idx = torch.where((idx & _MASK) >= 1 << 31, (idx & _MASK) - (1 << 32),
                      idx & _MASK)
    word = (_wire_words(values) ^ (idx * _KNUTH)) & _MASK
    pos = (torch.arange(word.shape[-1], dtype=torch.int64,
                        device=word.device) << 1) | 1
    prod = (word * pos) & _MASK
    lead = prod.shape[:-1]
    out = torch.zeros(lead + (num_buckets,), dtype=torch.int64,
                      device=word.device)
    out.index_add_(out.dim() - 1, seg_ids.to(word.device).long(), prod)
    return _as_int32(out)


def count_mismatches(g_values: torch.Tensor, g_indices: torch.Tensor,
                     g_chk: torch.Tensor, seg_ids: torch.Tensor,
                     num_buckets: int) -> torch.Tensor:
    """The f32 count of ``[W, buckets]`` checksum words that disagree with
    the gathered payload's recomputed ones (identical on every receiver)."""
    got = payload_checksum(g_values, g_indices, seg_ids, num_buckets)
    return (got != g_chk.to(torch.int32)).sum().to(torch.float32)
