"""Serving-side replica: applies the delta stream in place (counterpart
of ``dgc_tpu/serving/replica.py``; the flat state lives on the replica's
device: the card unless the CPU is asked for).

``Replica.poll()`` is the serving loop's tick: read the manifest, apply
every delta artifact between the local ``(base_version, delta_seq)`` and
the stream head, and report status. Three fallbacks guard the in-place
path, all ending in a full-snapshot resync:

* **base change** — the manifest's ``base_version`` moved (exporter
  rebased): reload ``base_v{V}.npz`` and replay from seq 0.
* **gap** — the next delta artifact is missing while the head is
  already past it (a dropped update): the in-place state can never
  catch up, so the replica requests a resync (``auto_resync=True``
  writes ``resync.json`` itself; otherwise it reports ``gap`` health
  and waits for the control plane's ``stale_replica -> resync``).
* **staleness breach** — ``latest_seq - delta_seq`` exceeded the
  manifest's pinned ``max_lag`` bound: same resync path.

Status records validate against
:func:`dgc_tpu_torch.telemetry.registry.validate_replica_status` and are
what the fleet monitor's per-replica ``{replica=…}`` gauges scrape.
"""

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from dgc_tpu_torch.serving import protocol
from dgc_tpu_torch.serving.delta import DeltaSpec
from dgc_tpu_torch.utils.device import resolve_device

__all__ = ["Replica"]


class Replica:
    """One serving replica following a stream in ``serving_dir``."""

    def __init__(self, serving_dir: str, name: str = "replica0",
                 auto_resync: bool = True, device="cuda"):
        self.device = resolve_device(device)
        self.serving_dir = str(serving_dir)
        self.name = str(name)
        self.auto_resync = bool(auto_resync)
        self.spec: Optional[DeltaSpec] = None
        self.flat: Optional[torch.Tensor] = None
        self.base_version = 0
        self.delta_seq = -1          # -1: no base loaded yet
        self.applied_deltas = 0
        self.resyncs = 0
        self.gaps = 0
        self._health = "init"

    # ------------------------------------------------------------------ #

    @property
    def ready(self) -> bool:
        return self.flat is not None

    def params(self) -> Dict[str, torch.Tensor]:
        """The served parameter view at the current (version, seq)."""
        if not self.ready:
            raise RuntimeError(f"replica {self.name} has no base loaded")
        return self.spec.unflatten(self.flat)

    def digest(self) -> str:
        if not self.ready:
            raise RuntimeError(f"replica {self.name} has no base loaded")
        return DeltaSpec.digest(self.flat)

    # ------------------------------------------------------------------ #

    def _load_base(self, manifest: Dict) -> bool:
        v = int(manifest["base_version"])
        arrays = protocol.load_npz(protocol.base_path(self.serving_dir, v))
        if arrays is None:
            self._health = "no_base"
            return False
        spec = DeltaSpec.from_meta(manifest["spec"], device=self.device)
        flat = np.asarray(arrays["flat"], np.float32)
        if flat.shape != (spec.layout.total,):
            self._health = "bad_base"
            return False
        if self.ready:
            self.resyncs += 1
        self.spec = spec
        self.flat = torch.from_numpy(flat).to(self.device)
        self.base_version, self.delta_seq = v, 0
        self._health = "ok"
        return True

    def _request_resync(self, reason: str) -> None:
        if self.auto_resync:
            protocol.request_resync(self.serving_dir, reason,
                                    replica=self.name,
                                    base_version=self.base_version,
                                    delta_seq=self.delta_seq)

    # ------------------------------------------------------------------ #

    def poll(self) -> Dict:
        """One serving tick: catch up to the stream head, return status."""
        manifest = protocol.read_manifest(self.serving_dir)
        if manifest is None:
            self._health = "no_manifest"
            return self.status(latest_seq=-1, max_lag=0)
        head_v = int(manifest["base_version"])
        head_s = int(manifest["latest_seq"])
        max_lag = int(manifest.get("max_lag", 8))

        if not self.ready or head_v != self.base_version:
            if not self._load_base(manifest):
                return self.status(latest_seq=head_s, max_lag=max_lag)

        while self.delta_seq < head_s:
            nxt = self.delta_seq + 1
            arrays = protocol.load_npz(protocol.delta_path(
                self.serving_dir, self.base_version, nxt))
            if arrays is None:
                # missing artifact below the head — a real gap, not a
                # not-yet-published tail (the manifest IS the head)
                self.gaps += 1
                self._health = "gap"
                self._request_resync(f"gap at {self.base_version}:{nxt}")
                break
            self.flat = self.spec.apply(self.flat, arrays)
            self.delta_seq = nxt
            self.applied_deltas += 1
            self._health = "ok"

        if (self._health == "ok"
                and head_s - self.delta_seq > max_lag):
            self._health = "stale"
            self._request_resync(
                f"staleness {head_s - self.delta_seq} > max_lag {max_lag}")

        # bitwise apply-parity check against the manifest's digest trail
        key = f"{self.base_version}:{self.delta_seq}"
        want = manifest.get("digests", {}).get(key)
        if want is not None and self._health in ("ok", "stale"):
            if self.digest() != want:
                self._health = "divergent"
                self._request_resync(f"digest mismatch at {key}")
        return self.status(latest_seq=head_s, max_lag=max_lag)

    def status(self, latest_seq: int, max_lag: int) -> Dict:
        """The replica_status record the fleet monitor scrapes (schema:
        ``telemetry.registry.validate_replica_status``)."""
        staleness = (max(0, latest_seq - self.delta_seq)
                     if self.ready and latest_seq >= 0 else -1)
        return {
            "event": "replica_status",
            "replica": self.name,
            "base_version": self.base_version,
            "delta_seq": self.delta_seq,
            "latest_seq": int(latest_seq),
            "staleness": staleness,
            "max_lag": int(max_lag),
            "health": self._health,
            "applied_deltas": self.applied_deltas,
            "resyncs": self.resyncs,
            "gaps": self.gaps,
            "t": time.time(),
        }

    def write_status(self, status_dir: str, latest_seq: int,
                     max_lag: int) -> str:
        """Publish this replica's status file for the fleet monitor
        (``status_dir/replica_{name}.json``, atomic)."""
        path = os.path.join(status_dir, f"replica_{self.name}.json")
        protocol.write_json_atomic(
            path, self.status(latest_seq=latest_seq, max_lag=max_lag))
        return path
