"""Trainer-side delta exporter (counterpart of
``dgc_tpu/serving/exporter.py``; the published state lives on the spec's
device: the card unless the CPU is asked for).

``Exporter.publish(params, step)`` is called from the training loop every
N steps (or every epoch). It diffs the live params against the last
*published* state, encodes the top-k sparse delta with the serving wire
codecs, and publishes ``delta_v{V}_{S}.npz`` + an updated manifest.

The published state is advanced by applying the exporter's own DECODED
artifact — the exact bytes a replica will apply — never the raw delta.
Two things follow:

* **bitwise apply parity** — a replica that has applied the same
  ``(base_version, delta_seq)`` stream holds the byte-identical flat
  buffer, and the manifest's trailing digests make that checkable.
* **error feedback** — whatever the top-k selection did not send, plus
  all int4 quantization error, remains in ``live - published`` and is
  a candidate for the next delta. Nothing is ever dropped, only
  deferred (the serving analogue of DGC's residual accumulation).

A pending ``resync.json`` (from a replica or the control plane's
``stale_replica -> resync`` action) is consumed at the next publish: the
exporter REBASES — bumps ``base_version``, writes a fresh full
``base_v{V}.npz`` of the live params, resets ``delta_seq`` to 0 — and
replicas reload from the newer base. The base snapshot carries the
checkpoint lineage anchor (``lineage={"epoch": …, "step": …}``) naming
the training checkpoint the stream is certified against.
"""

import os
import time
from typing import Dict, Optional

import torch

from dgc_tpu_torch.serving import protocol
from dgc_tpu_torch.serving.delta import DeltaSpec

__all__ = ["Exporter"]

#: trailing (version:seq -> digest) entries kept in the manifest
DIGEST_TRAIL = 32


class Exporter:
    """Publishes one serving stream into ``serving_dir``.

    Single-writer by contract (one exporter per stream — the trainer's
    process 0); replicas and the control plane only read, except for the
    ``resync.json`` request file. ``params`` is a ``{flax name: tensor}``
    map (or a nested one), e.g. ``ParamLayout.unflatten_named`` of the
    trainer's flat parameters; ``device`` holds the published state.
    """

    def __init__(self, serving_dir: str, params, ratio: float = 0.001,
                 max_lag: int = 8, lineage: Optional[Dict] = None,
                 device="cuda"):
        self.serving_dir = str(serving_dir)
        os.makedirs(self.serving_dir, exist_ok=True)
        self.spec = DeltaSpec.from_params(params, ratio, device=device)
        self.max_lag = int(max_lag)
        self.base_version = 0
        self.delta_seq = 0
        self.digests: Dict[str, str] = {}
        self.published: Optional[torch.Tensor] = None
        self.wire_bytes_total = 0
        self._rebase(params, lineage=lineage, reason="initial")

    # ------------------------------------------------------------------ #

    def _manifest(self, lineage: Optional[Dict]) -> Dict:
        return {
            "spec": self.spec.meta(),
            "base_version": self.base_version,
            "latest_seq": self.delta_seq,
            "max_lag": self.max_lag,
            "lineage": dict(lineage) if lineage else {},
            "digests": dict(self.digests),
            "wire_bytes_per_update": self.spec.wire_bytes_per_update(),
            "full_checkpoint_bytes": self.spec.full_checkpoint_bytes(),
            "published_at": time.time(),
        }

    def _record_digest(self, host=None) -> str:
        d = DeltaSpec.digest(self.published if host is None else host)
        self.digests[f"{self.base_version}:{self.delta_seq}"] = d
        while len(self.digests) > DIGEST_TRAIL:
            self.digests.pop(next(iter(self.digests)))
        return d

    def _rebase(self, params, lineage: Optional[Dict],
                reason: str) -> Dict:
        """Publish a fresh full base snapshot as version+1, seq 0."""
        self.base_version += 1
        self.delta_seq = 0
        self.digests = {}
        self.published = self.spec.flatten(params)
        self._lineage = dict(lineage) if lineage else {}
        self._lineage.setdefault("reason", reason)
        host = self.published.cpu().numpy()
        self._record_digest(host)
        protocol.save_npz_atomic(
            protocol.base_path(self.serving_dir, self.base_version),
            {"flat": host})
        protocol.write_json_atomic(
            os.path.join(self.serving_dir, protocol.MANIFEST),
            self._manifest(self._lineage))
        protocol.clear_resync_request(self.serving_dir)
        return {"kind": "base", "base_version": self.base_version,
                "delta_seq": 0, "reason": reason,
                "bytes": self.spec.full_checkpoint_bytes()}

    # ------------------------------------------------------------------ #

    def publish(self, params, step: Optional[int] = None,
                lineage: Optional[Dict] = None) -> Dict:
        """One publish tick. Rebases if a resync request is pending,
        otherwise emits the next delta artifact. Returns an audit record
        ``{"kind": "base"|"delta", ...}``."""
        req = protocol.read_resync_request(self.serving_dir)
        if req is not None:
            lin = dict(lineage) if lineage else dict(self._lineage)
            if step is not None:
                lin["step"] = int(step)
            out = self._rebase(params, lineage=lin,
                               reason=req.get("reason", "requested"))
            out["request"] = req
            return out

        flat = self.spec.flatten(params)
        artifact = self.spec.encode(flat - self.published)
        self.delta_seq += 1
        # advance by the DECODED artifact — the bytes replicas apply —
        # so parity is bitwise and the unsent remainder carries over
        self.published = self.spec.apply(self.published, artifact)
        self._record_digest()
        if lineage:
            self._lineage = dict(lineage)
        if step is not None:
            self._lineage["step"] = int(step)
        # fault injection for drills: DGC_SERVE_DROP="S" skips writing
        # delta S of every base; "V:S" skips it on base V only (so a
        # post-resync stream does not re-hit the same injected gap)
        drop = os.environ.get("DGC_SERVE_DROP", "")
        if ":" in drop:
            v, s = drop.split(":", 1)
            dropped = (self.base_version == int(v)
                       and self.delta_seq == int(s))
        else:
            dropped = bool(drop) and self.delta_seq == int(drop)
        if not dropped:
            protocol.save_npz_atomic(
                protocol.delta_path(self.serving_dir, self.base_version,
                                    self.delta_seq),
                self.spec.to_arrays(artifact))
        # the manifest advances either way: a skipped artifact is a GAP
        # replicas (and the control plane) must detect, the injected
        # fault of the serving drill
        protocol.write_json_atomic(
            os.path.join(self.serving_dir, protocol.MANIFEST),
            self._manifest(self._lineage))
        wire = self.spec.wire_bytes_per_update()
        self.wire_bytes_total += 0 if dropped else wire
        return {"kind": "delta", "base_version": self.base_version,
                "delta_seq": self.delta_seq, "bytes": wire,
                "dropped": dropped,
                "digest": self.digests[
                    f"{self.base_version}:{self.delta_seq}"]}
