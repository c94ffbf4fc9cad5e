"""Bit-packed index wires and int4 nibble packing for the sparse payload.

Counterpart of ``dgc_tpu/compression/wirecodec.py``. The reference ships
its sparse payload as (f32 value, int32 index) pairs and lists "no
quantization/encoding of payloads is performed" among its caveats; with
the int8 value wire the index is 4 of every 5 wire bytes. Every payload
slot belongs statically to one tensor row (payload order is bucket by
bucket, row by row), so:

* :class:`IndexCodec` ships each index tensor-local in ``max(1,
  ceil(log2 numel))`` bits at a static bit offset (two word-wide
  scatter-adds of disjoint bit ranges to pack, two gathers and shifts a
  slot to unpack);
* :class:`DeltaIndexCodec` ships each bucket's canonically sorted indices
  as Elias-Fano words (``s`` low bits a slot plus a unary high-part
  bitvector), near the ``log2(C(U, p))`` bound.

The words are bitwise the JAX package's ``uint32`` words. PyTorch has
little ``uint32`` arithmetic, so both codecs compute in ``int64`` (every
word value below 2^32, bit ranges disjoint so an add is an or) and narrow
once to ``int32`` bit patterns: the gathered lane holds 4 bytes a word, as
the JAX lane does, and ``words.view`` of either side compares bit for bit.

Padded payload slots (fewer threshold passers than ``num_selects``) carry
the global scatter sentinel, which is not in-row; they encode as a clipped
in-row position whose wire value is exactly 0.0, a no-op of the scatter-add.
The local transmit record is built from the pre-encoding indices, never
from the wire.

Device tensors of the static layout are built once per device and kept.
"""

from typing import Dict, List

import numpy as np
import torch

__all__ = ["IndexCodec", "DeltaIndexCodec", "pack_int4", "unpack_int4",
           "math_floor_log2"]

_U32 = 0xFFFFFFFF


def _to_words(w: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> their int32 bit patterns."""
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def _from_words(words: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2^32)."""
    return words.to(torch.int64) & _U32


def _slot_rows(buckets):
    """Per payload slot, its owning row's flat offset and element count
    (slot s of a bucket's [R, max_sel] grid belongs to row s // max_sel,
    for the tight and the padded payload alike)."""
    offs, numels = [], []
    for b in buckets:
        rows = np.asarray(b.tight) // b.max_sel
        offs.append(np.asarray(b.row_offsets, np.int64)[rows])
        numels.append(np.asarray(b.numels, np.int64)[rows])
    if offs:
        return np.concatenate(offs), np.concatenate(numels)
    return np.zeros(0, np.int64), np.ones(0, np.int64)


def _canonical(indices: torch.Tensor, off: torch.Tensor,
               numel: torch.Tensor) -> torch.Tensor:
    """Each index clipped into its slot's row ``[off, off + numel)``."""
    local = torch.minimum(torch.clamp(indices - off, min=0), numel - 1)
    return off + local


def _pack_bits(words: torch.Tensor, values: torch.Tensor, w0: torch.Tensor,
               shift: torch.Tensor) -> torch.Tensor:
    """Add ``values`` (int64, < 2^32) at bit ``shift`` of word ``w0`` (its
    spill into word ``w0 + 1``) of the int64 ``words`` (one guard word at
    the end), in place."""
    lo = (values << shift) & _U32
    hi = torch.where(shift > 0, values >> (32 - shift).clamp(max=31),
                     torch.zeros_like(values))
    words.index_add_(0, w0, lo)
    words.index_add_(0, w0 + 1, hi)
    return words


def _unpack_bits(words: torch.Tensor, w0: torch.Tensor, shift: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`_pack_bits` over ``[..., nwords]`` int64 words
    (a zero guard word appended here): ``[..., slots]`` int64."""
    wpad = torch.cat([words, words.new_zeros(words.shape[:-1] + (1,))], -1)
    lo = wpad[..., w0] >> shift
    hi = torch.where(shift > 0,
                     (wpad[..., w0 + 1] << (32 - shift).clamp(max=31)) & _U32,
                     torch.zeros_like(lo))
    return (lo | hi) & mask


class _DeviceCache:
    """Static numpy arrays as tensors on each device, built once."""

    def __init__(self, **arrays):
        self._np = arrays
        self._dev: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def on(self, device) -> Dict[str, torch.Tensor]:
        device = torch.device(device)
        out = self._dev.get(device)
        if out is None:
            out = {k: torch.as_tensor(v, device=device)
                   for k, v in self._np.items()}
            self._dev[device] = out
        return out


class IndexCodec:
    """Static per-slot variable-width bit packing of payload indices over
    the engine's buckets: slot s ships ``indices[s] - off_s`` in ``w_s =
    max(1, ceil(log2 numel_s))`` bits at a static bit offset. ``encode``:
    [payload] global indices -> [nwords] int32 words; ``decode``: [...,
    nwords] words -> [..., payload] global indices."""

    def __init__(self, buckets):
        self.slot_off, self.slot_numel = _slot_rows(buckets)
        self.payload = int(self.slot_off.shape[0])
        widths = np.maximum(1, np.ceil(np.log2(np.maximum(
            self.slot_numel, 2))).astype(np.int64))
        if widths.size and widths.max() > 32:
            raise ValueError(
                "packed_indices: tensor rows with numel > 2^32 exceed the "
                f"32-bit local-index packing (max width {widths.max()})")
        self.widths = widths.astype(np.int32)
        bit_off = np.zeros(self.payload, np.int64)
        if self.payload:
            bit_off[1:] = np.cumsum(widths)[:-1]
        self.total_bits = int(widths.sum())
        self.nwords = -(-self.total_bits // 32) if self.payload else 0
        self._dev = _DeviceCache(
            off=self.slot_off, numel=self.slot_numel, w0=bit_off >> 5,
            shift=bit_off & 31, mask=(np.int64(1) << widths) - 1)

    @property
    def bits_per_index(self) -> float:
        return self.total_bits / self.payload if self.payload else 0.0

    def canonical(self, indices: torch.Tensor) -> torch.Tensor:
        """The ``decode(encode(x))`` fixed point: each index clipped into
        its slot's owning row."""
        c = self._dev.on(indices.device)
        return _canonical(indices, c["off"].to(indices.dtype),
                          c["numel"].to(indices.dtype))

    def encode(self, indices: torch.Tensor) -> torch.Tensor:
        """[payload] global flat indices -> [nwords] int32 words."""
        dev = indices.device
        if not self.payload:
            return torch.zeros(0, dtype=torch.int32, device=dev)
        c = self._dev.on(dev)
        local = torch.minimum(torch.clamp(indices.to(torch.int64) - c["off"],
                                          min=0), c["numel"] - 1)
        words = torch.zeros(self.nwords + 1, dtype=torch.int64, device=dev)
        _pack_bits(words, local, c["w0"], c["shift"])
        return _to_words(words[:self.nwords])

    def decode(self, words: torch.Tensor,
               out_dtype=torch.int32) -> torch.Tensor:
        """[..., nwords] int32 words -> [..., payload] global indices."""
        if not self.payload:
            return torch.zeros(words.shape[:-1] + (0,), dtype=out_dtype,
                               device=words.device)
        c = self._dev.on(words.device)
        local = _unpack_bits(_from_words(words), c["w0"], c["shift"],
                             c["mask"])
        return (c["off"] + local).to(out_dtype)


def math_floor_log2(n: int) -> int:
    """floor(log2(n)) for n >= 1 (0 for n < 1), in exact integer math."""
    return max(int(n), 1).bit_length() - 1


class DeltaIndexCodec:
    """Elias-Fano packing of each bucket's canonically sorted indices (the
    ``int8_delta_idx`` regime's index lane): per bucket of universe ``U =
    rows * cols`` and payload ``p``, each bucket-local position splits into
    ``s = max(0, floor(log2(U / p)))`` low bits and a high part whose
    deltas are unary-coded in a ``p + (U >> s) + 1``-bit vector (set bit
    ``high_j + j``). The input to :meth:`encode` must be sorted by
    canonical position within each bucket (the engine sorts each delta
    bucket's payload, values with it, before any packing). Decoding sorts
    the keys ``t`` (set bits) / ``t + Hb`` (clear bits): the first ``p``
    are the set bits in order."""

    def __init__(self, buckets):
        self.slot_off, self.slot_numel = _slot_rows(buckets)
        self.meta: List[dict] = []
        self.bucket_words: List[int] = []
        word0 = 0
        for b in buckets:
            U, p = int(b.rows) * int(b.cols), int(b.payload)
            if U >= 2 ** 31:
                raise ValueError(
                    f"int8_delta_idx: bucket grid spans {U} >= 2^31 slots — "
                    "exceeds the int32 Elias-Fano decode; use int8_packed "
                    "for this bucket")
            s = max(0, math_floor_log2(U // max(p, 1)))
            lw = -(-(p * s) // 32)
            Hb = p + (U >> s) + 1
            hw = -(-Hb // 32)
            bit_off = np.arange(p, dtype=np.int64) * s
            t = np.arange(Hb, dtype=np.int64)
            self.meta.append({
                "base": int(b.base), "U": U, "p": p, "s": s, "Hb": Hb,
                "low_w0": word0, "low_words": lw, "high_w0": word0 + lw,
                "high_words": hw,
                "dev": _DeviceCache(
                    lw0=word0 + (bit_off >> 5), lshift=bit_off & 31,
                    lw0_local=bit_off >> 5, j=np.arange(p, dtype=np.int64),
                    tw=t >> 5, tb=t & 31, t=t)})
            self.bucket_words.append(lw + hw)
            word0 += lw + hw
        self.payload = int(self.slot_off.shape[0])
        self.nwords = word0
        self.total_bits = sum(m["p"] * m["s"] + m["Hb"] for m in self.meta)
        self._dev = _DeviceCache(off=self.slot_off, numel=self.slot_numel)

    @property
    def bits_per_index(self) -> float:
        return self.total_bits / self.payload if self.payload else 0.0

    def canonical(self, indices: torch.Tensor) -> torch.Tensor:
        """Each index clipped into its slot's owning row (the decode fixed
        point for sorted input)."""
        c = self._dev.on(indices.device)
        return _canonical(indices, c["off"].to(indices.dtype),
                          c["numel"].to(indices.dtype))

    def encode(self, indices: torch.Tensor) -> torch.Tensor:
        """[payload] global indices, sorted per bucket by canonical
        position -> [nwords] int32 Elias-Fano words."""
        dev = indices.device
        if not self.payload:
            return torch.zeros(0, dtype=torch.int32, device=dev)
        canon = self.canonical(indices.to(torch.int64))
        words = torch.zeros(self.nwords + 1, dtype=torch.int64, device=dev)
        p0 = 0
        for m in self.meta:
            p, s = m["p"], m["s"]
            c = m["dev"].on(dev)
            g = canon[p0:p0 + p] - m["base"]
            high = g >> s
            if s > 0:
                _pack_bits(words, g & ((1 << s) - 1), c["lw0"], c["lshift"])
            pos = torch.clamp(high + c["j"], 0, m["Hb"] - 1)
            words.index_add_(0, m["high_w0"] + (pos >> 5),
                             torch.ones_like(pos) << (pos & 31))
            p0 += p
        return _to_words(words[:self.nwords])

    def decode(self, words: torch.Tensor,
               out_dtype=torch.int32) -> torch.Tensor:
        """[..., nwords] int32 words -> [..., payload] global indices (the
        canonical sorted stream)."""
        if not self.payload:
            return torch.zeros(words.shape[:-1] + (0,), dtype=out_dtype,
                               device=words.device)
        u = _from_words(words)
        parts = []
        for m in self.meta:
            p, s, Hb = m["p"], m["s"], m["Hb"]
            c = m["dev"].on(words.device)
            hwords = u[..., m["high_w0"]:m["high_w0"] + m["high_words"]]
            bits = (hwords[..., c["tw"]] >> c["tb"]) & 1
            key = torch.where(bits.bool(), c["t"], c["t"] + Hb)
            pos = torch.sort(key, dim=-1).values[..., :p]
            high = pos - c["j"]
            if s > 0:
                lw = u[..., m["low_w0"]:m["low_w0"] + m["low_words"]]
                low = _unpack_bits(lw, c["lw0_local"], c["lshift"],
                                   torch.full((), (1 << s) - 1,
                                              dtype=torch.int64,
                                              device=words.device))
                g = (high << s) | low
            else:
                g = high
            parts.append((g + m["base"]).to(out_dtype))
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """[n] integer nibbles in [-8, 7] -> [ceil(n/2)] int8, two a byte (the
    even slot in the low nibble); an odd payload pads one zero nibble."""
    q = q.to(torch.int32)
    if q.shape[0] % 2:
        q = torch.cat([q, q.new_zeros(1)])
    b = (q[0::2] & 15) | ((q[1::2] & 15) << 4)
    return b.to(torch.uint8).view(torch.int8)


def unpack_int4(b: torch.Tensor, n: int) -> torch.Tensor:
    """[..., ceil(n/2)] int8 nibble bytes -> [..., n] int32 in [-8, 7]
    (sign-extended)."""
    u = b.view(torch.uint8).to(torch.int32)
    nib = torch.stack([u & 15, (u >> 4) & 15], dim=-1).reshape(
        b.shape[:-1] + (-1,))[..., :n]
    return nib - 16 * (nib >= 8).to(torch.int32)
