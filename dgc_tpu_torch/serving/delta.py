"""The serving delta format: bucketed top-k sparse param deltas on the
training stack's wire codecs, computed on the spec's device.

Counterpart of ``dgc_tpu/serving/delta.py``. A :class:`DeltaSpec` is the
static contract both ends of the stream agree on, built from nothing but
the parameter ``{name: shape}`` map and the serving ratio, so a replica
reconstructs the identical spec from the manifest:

* **bucketing** — :class:`~dgc_tpu_torch.compression.flat.ParamLayout`
  over the WHOLE tree (every tensor, down to scalars), then one
  :func:`~dgc_tpu_torch.compression.flat._bucket_from_rows` bucket per
  layout tile with per-row quotas ``k_r = max(1, round(numel_r * ratio))``.
  The models keep flax's names and HWIO layouts, so the layout, the
  payload, :meth:`DeltaSpec.key` and :meth:`DeltaSpec.describe` are the
  reference's.
* **selection** — per bucket, the engine's exact per-row top-k
  (:func:`~dgc_tpu_torch.compression.flat.select_topk`: the ``topk_rows``
  kernel on the card) over the [rows, cols] magnitudes with the row tails
  at -1, at k = the bucket's largest quota; each row keeps its first
  ``k_r`` columns, sorted ascending, and its pad tail points at the row's
  last element with value 0.0. Equal magnitudes at a row's cut go to the
  lower column; the reference's ``np.argpartition`` leaves that choice
  unspecified (ROADMAP.md, "Deliberate divergences").
* **values** — int4 nibbles against one f32 scale per bucket row
  (``scale_r = max|v| / 7``), ``rint(v / scale)`` clipped to [-8, 7]:
  ``torch.round`` rounds half to even, as ``np.rint`` does.
* **indices** — :class:`~dgc_tpu_torch.compression.wirecodec.DeltaIndexCodec`
  (Elias-Fano over the canonically sorted stream); the artifact's words
  are ``uint32`` on the host, as the reference writes them.

**Bitwise apply parity**: :meth:`DeltaSpec.apply` is ``np.add.at`` bit for
bit: the decoded ``+-0.0`` slots (the pad tail, values that quantize to 0)
change a coordinate only from -0.0 to +0.0, whatever their order; the
other slots are added in payload order, one pass per repeat of a
coordinate (a corrupt index word clamped into its row can repeat one), so
no two writes of a pass meet and nothing is left to the order of atomics.
The exporter advances its published state by its own DECODED artifacts,
so a replica that applied the same stream holds the byte-identical flat
buffer, checkable by :meth:`DeltaSpec.digest` (sha256 of the f32 bytes,
one copy to the host).
"""

import hashlib
import json
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from dgc_tpu_torch.compression.flat import (
    ParamLayout, _bucket_from_rows, select_topk)
from dgc_tpu_torch.compression.wirecodec import (
    DeltaIndexCodec, pack_int4, unpack_int4)
from dgc_tpu_torch.utils.device import resolve_device
from dgc_tpu_torch.utils.pytree import named_flatten, nest

__all__ = ["DeltaSpec", "add_at"]

#: artifact format tag, bumped on any incompatible wire-layout change
FORMAT = "dgc-serving-delta"
FORMAT_VERSION = 1


def _named_leaves(params) -> Dict[str, object]:
    """Any param container (nested dict, flax-shaped variables, ``{"a/b":
    leaf}``) -> ``{name: leaf}`` in the reference's flattening order."""
    return named_flatten(nest(named_flatten(params)))


def _leaf_shape(a) -> Tuple[int, ...]:
    return tuple(int(d) for d in (a.shape if torch.is_tensor(a)
                                  else np.shape(a)))


def _as_tensor(a) -> torch.Tensor:
    if torch.is_tensor(a):
        return a.detach()
    return torch.from_numpy(np.array(a, np.float32))


def add_at(out: torch.Tensor, idx: torch.Tensor,
           values: torch.Tensor) -> torch.Tensor:
    """``np.add.at(out, idx, values)`` bit for bit, in place, with the same
    result on every device. An add of -0.0 changes nothing, and an add of
    +0.0 only turns a -0.0 into +0.0, which commutes with every other add
    (no add of a non-zero value gives -0.0): one write of ``out + 0.0`` at
    the +0.0 slots, whose repeats write equal values. The other slots, in
    payload order per coordinate: a stable sort by coordinate ranks each
    repeat, and pass r adds every coordinate's r-th value, so the writes of
    a pass never meet."""
    zero = values == 0
    pos = zero & ~torch.signbit(values)
    if bool(pos.any()):
        i0 = idx[pos]
        out[i0] = out[i0] + 0.0
    i1, v1 = idx[~zero], values[~zero]
    n = int(i1.numel())
    if n == 0:
        return out
    s, perm = torch.sort(i1, stable=True)
    v1 = v1[perm]
    pos_n = torch.arange(n, device=idx.device)
    head = torch.ones(n, dtype=torch.bool, device=idx.device)
    head[1:] = s[1:] != s[:-1]
    rank = pos_n - torch.cummax(torch.where(head, pos_n, 0), 0).values
    for r in range(int(rank.max()) + 1):
        m = rank == r
        ir = s[m]
        out[ir] = out[ir] + v1[m]
    return out


class DeltaSpec:
    """Static codec + layout for one parameter set at one serving ratio,
    computing on ``device`` (the card unless the CPU is asked for)."""

    def __init__(self, shapes: Dict[str, Sequence[int]], ratio: float,
                 device="cuda"):
        if not shapes:
            raise ValueError("DeltaSpec needs at least one parameter")
        if not (0.0 < float(ratio) <= 1.0):
            raise ValueError(f"serving ratio must be in (0, 1], got {ratio}")
        self.device = resolve_device(device)
        self.ratio = float(ratio)
        self.shapes = {str(n): tuple(int(d) for d in shapes[n])
                       for n in shapes}
        elems = sum(int(np.prod(np.asarray(s, np.int64)))
                    for s in self.shapes.values())
        if elems >= 2 ** 31:
            raise ValueError(
                f"serving layout spans {elems} >= 2^31 slots — "
                "shard the stream per parameter group")
        #: the flat-engine layout, every tensor in the compressed block
        self.layout = ParamLayout(self.shapes,
                                  compressed_names=list(self.shapes))
        if self.layout.total >= 2 ** 31:
            raise ValueError(
                f"serving layout spans {self.layout.total} >= 2^31 slots — "
                "shard the stream per parameter group")
        self.buckets = []
        for g in self.layout.buckets:
            rows = []
            for n in g.names:
                numel = self.layout.sizes[n]
                k = max(1, min(numel, int(round(numel * self.ratio))))
                # the selection-pipeline fields (stride, samples, top-k
                # samples) at the exact-sampling identity; no codec reads them
                rows.append((self.layout.offsets[n], numel, 1, numel, k, k))
            self.buckets.append(_bucket_from_rows(g.base, g.cols, rows))
        self.codec = DeltaIndexCodec(self.buckets)
        self.payload = self.codec.payload
        #: per payload slot: its row's place in the concatenated per-row
        #: scale vector (bucket-major, row-minor)
        slot_scale, self.num_rows = [], 0
        for b in self.buckets:
            rows = np.asarray(b.tight) // b.max_sel
            slot_scale.append(self.num_rows + rows.astype(np.int64))
            self.num_rows += b.rows
        dev = self.device

        def t(a, dtype=torch.int64):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
        self._slot_scale = t(np.concatenate(slot_scale))
        self._slot_off = t(self.codec.slot_off)
        self._slot_numel = t(self.codec.slot_numel)
        self._bconst = [dict(offs=t(b.row_offsets), numels=t(b.numels),
                             k=t(b.num_selects), tight=t(b.tight),
                             col=torch.arange(b.cols, device=dev),
                             j=torch.arange(b.max_sel, device=dev))
                        for b in self.buckets]

    # ------------------------------------------------------------------ #

    @classmethod
    def from_params(cls, params, ratio: float, device="cuda") -> "DeltaSpec":
        return cls({n: _leaf_shape(a)
                    for n, a in _named_leaves(params).items()}, ratio,
                   device=device)

    def meta(self) -> Dict:
        """The JSON-able spec record a manifest carries; feeding it back
        through :meth:`from_meta` reconstructs the identical spec."""
        return {"format": FORMAT, "format_version": FORMAT_VERSION,
                "ratio": self.ratio,
                "shapes": {n: list(s) for n, s in self.shapes.items()},
                "key": self.key()}

    @classmethod
    def from_meta(cls, meta: Dict, device="cuda") -> "DeltaSpec":
        if meta.get("format") != FORMAT:
            raise ValueError(f"not a serving delta spec: "
                             f"format={meta.get('format')!r}")
        if int(meta.get("format_version", -1)) != FORMAT_VERSION:
            raise ValueError(
                f"serving delta format version {meta.get('format_version')} "
                f"!= supported {FORMAT_VERSION} — resync from a full "
                "checkpoint written by a matching tree")
        spec = cls(meta["shapes"], float(meta["ratio"]), device=device)
        if meta.get("key") and meta["key"] != spec.key():
            raise ValueError("serving spec key mismatch: the manifest was "
                             "published by a different layout/codec build")
        return spec

    def key(self) -> str:
        """Content hash of everything the wire layout depends on — the
        lineage anchor's compatibility check."""
        h = hashlib.sha256()
        h.update(json.dumps(
            {"format": FORMAT, "v": FORMAT_VERSION, "ratio": self.ratio,
             "shapes": {n: list(s) for n, s in sorted(self.shapes.items())}},
            sort_keys=True).encode())
        return h.hexdigest()[:16]

    # ------------------------------------------------------------------ #

    def flatten(self, params) -> torch.Tensor:
        """Params (tensors on any device, or arrays) -> flat f32 [total] on
        the spec's device in layout order, structural zeros in row tails
        and gaps."""
        named = _named_leaves(params)
        got = {n: _leaf_shape(a) for n, a in named.items()}
        if got != self.shapes:
            raise ValueError(
                f"params do not match the serving spec: spec shapes "
                f"{self.shapes} vs got {got}")
        flat = torch.zeros(self.layout.total, dtype=torch.float32,
                           device=self.device)
        for n, a in named.items():
            off = self.layout.offsets[n]
            flat[off:off + self.layout.sizes[n]] = _as_tensor(a).reshape(-1)
        return flat

    def unflatten(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Flat [total] -> ``{name: view}`` (the replica's serving view)."""
        out = {}
        for n, shape in self.shapes.items():
            off = self.layout.offsets[n]
            out[n] = flat[off:off + self.layout.sizes[n]].view(shape)
        return out

    # ------------------------------------------------------------------ #

    def encode(self, delta: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Flat f32 delta [total] on the spec's device -> the artifact's
        tensors there: ``{"scales" f32 [num_rows], "values" int8
        [ceil(payload/2)], "words" int32 [nwords]}`` (the words' bit
        patterns; :meth:`to_arrays` gives the wire's numpy form)."""
        if tuple(delta.shape) != (self.layout.total,):
            raise ValueError(f"delta shape {tuple(delta.shape)} != "
                             f"({self.layout.total},)")
        delta = delta.to(self.device, torch.float32)
        values, indices, scales = [], [], []
        for b, c in zip(self.buckets, self._bconst):
            x = delta[b.base:b.base + b.rows * b.cols].view(b.rows, b.cols)
            imp = torch.where(c["col"][None, :] < c["numels"][:, None],
                              x.abs(), -1.0)
            _, top = select_topk(imp, b.max_sel)
            keep = c["j"][None, :] < c["k"][:, None]
            # a row's first k_r columns, ascending; the pad tail at the
            # row's last element with value 0.0 (the codec's canonical form)
            sel = torch.sort(torch.where(keep, top.long(), b.cols),
                             dim=1).values
            sel = torch.where(keep, sel, c["numels"][:, None] - 1)
            grid_v = torch.where(keep, x.gather(1, sel), 0.0)
            grid_i = c["offs"][:, None] + sel
            values.append(grid_v.reshape(-1)[c["tight"]])
            indices.append(grid_i.reshape(-1)[c["tight"]])
            amax = grid_v.abs().amax(dim=1)
            scales.append(torch.where(amax > 0, amax / 7.0, 1.0))
        values, scales = torch.cat(values), torch.cat(scales)
        q = torch.clamp(torch.round(values / scales[self._slot_scale]),
                        -8, 7).to(torch.int32)
        words = self.codec.encode(torch.cat(indices).to(torch.int32))
        return {"scales": scales, "values": pack_int4(q), "words": words}

    def _tensors(self, artifact) -> Dict[str, torch.Tensor]:
        """An artifact's arrays (the wire's numpy form, or tensors) as
        tensors on the spec's device; ``uint32`` words as their int32 bit
        patterns."""
        out = {}
        for k, dtype in (("scales", np.float32), ("values", np.int8),
                         ("words", np.uint32)):
            a = artifact[k]
            if not torch.is_tensor(a):
                a = np.array(a, dtype)
                a = torch.from_numpy(a.view(np.int32) if k == "words" else a)
            out[k] = a.to(self.device)
        return out

    @staticmethod
    def to_arrays(artifact: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
        """The artifact's tensors -> the wire's numpy arrays (f32 scales,
        int8 nibble bytes, uint32 index words), as the reference saves
        them."""
        return {"scales": artifact["scales"].cpu().numpy(),
                "values": artifact["values"].cpu().numpy(),
                "words": artifact["words"].cpu().numpy().view(np.uint32)}

    def decode(self, artifact) -> Tuple[torch.Tensor, torch.Tensor]:
        """Wire artifact -> (values f32 [payload], indices int64 [payload])
        on the spec's device — the canonical stream every receiver
        reconstructs."""
        a = self._tensors(artifact)
        q = unpack_int4(a["values"], self.payload)
        scales = a["scales"]
        if tuple(scales.shape) != (self.num_rows,):
            raise ValueError(f"scale lane shape {tuple(scales.shape)} != "
                             f"({self.num_rows},)")
        values = q.to(torch.float32) * scales[self._slot_scale]
        idx = self.codec.decode(a["words"], out_dtype=torch.int32).long()
        # receiver-side row clamp: a corrupted word decodes in-row
        idx = self._slot_off + torch.minimum(
            torch.clamp(idx - self._slot_off, min=0), self._slot_numel - 1)
        return values, idx

    def apply(self, flat: torch.Tensor, artifact) -> torch.Tensor:
        """One deterministic delta application: scatter-ADD the decoded
        values at the decoded coordinates into a copy of ``flat``
        (:func:`add_at`). Both ends run exactly this, which is what makes
        apply parity bitwise."""
        values, idx = self.decode(artifact)
        out = flat.to(self.device, torch.float32, copy=True)
        return add_at(out, idx, values)

    # ------------------------------------------------------------------ #

    def wire_bytes_per_update(self) -> int:
        """Exact artifact payload bytes of one delta update (scale lane +
        packed int4 values + Elias-Fano index words)."""
        return int(4 * self.num_rows + (self.payload + 1) // 2
                   + 4 * self.codec.nwords)

    def full_checkpoint_bytes(self) -> int:
        """f32 bytes of a full parameter snapshot — the shipping cost the
        delta stream replaces."""
        return int(4 * self.layout.num_params)

    @staticmethod
    def digest(flat) -> str:
        """Content digest of a flat param state (a tensor on any device, or
        an array): sha256 of its f32 bytes, the reference's digest."""
        if torch.is_tensor(flat):
            flat = flat.detach().to("cpu", torch.float32).numpy()
        a = np.ascontiguousarray(np.asarray(flat, np.float32))
        return hashlib.sha256(a.data).hexdigest()[:16]

    def describe(self) -> Dict:
        """Static accounting for logs/bench: payload, rows, wire bytes,
        bits/index, and the delta:checkpoint byte ratio."""
        wire = self.wire_bytes_per_update()
        full = self.full_checkpoint_bytes()
        return {
            "num_params": int(self.layout.num_params),
            "payload": int(self.payload),
            "num_rows": int(self.num_rows),
            "num_buckets": len(self.buckets),
            "bits_per_index": round(self.codec.bits_per_index, 3),
            "wire_bytes_per_update": wire,
            "full_checkpoint_bytes": full,
            "wire_frac": round(wire / full, 6) if full else 0.0,
        }
