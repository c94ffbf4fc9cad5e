"""dgc_tpu_torch.serving — sparse model-delta streaming from trainer to
replicas (counterpart of ``dgc_tpu/serving``).

Under DGC the per-N-step parameter delta is top-k sparse by construction,
so the training stack's wire codecs (int4 values, Elias-Fano delta
indices — :mod:`dgc_tpu_torch.compression.wirecodec`) ship model updates
to a serving fleet at a tiny fraction of full-checkpoint bytes:

* :class:`~dgc_tpu_torch.serving.delta.DeltaSpec` — the static delta
  format (flat-engine bucketing over the whole parameter tree, per-row
  top-k quotas, int4 values + per-row f32 scales + Elias-Fano indices)
  and the deterministic apply both ends share, computed on a device.
* :class:`~dgc_tpu_torch.serving.exporter.Exporter` — trainer side: every
  N steps, diff the live params against the last *published* (decoded)
  state, encode, publish a versioned delta artifact; full base snapshots
  carry the checkpoint-lineage anchor; rebases answer resync requests.
* :class:`~dgc_tpu_torch.serving.replica.Replica` — serving side: applies
  deltas in place, tracks ``(base_version, delta_seq)``, reports
  staleness/gap health, and falls back to a full-snapshot resync on a
  gap or a staleness-bound breach.

The files are the reference's byte for byte (:mod:`.protocol`), so either
package's replica follows the other's stream. The file protocol is
imported eagerly (numpy only); the three classes load on first use, so a
host-only reader of the protocol (the surgery order files) loads nothing
of the codecs.
"""

from dgc_tpu_torch.serving.protocol import (
    MANIFEST, RESYNC_REQUEST, clear_resync_request, read_manifest,
    read_resync_request, request_resync, write_json_atomic,
)

__all__ = [
    "DeltaSpec", "Exporter", "Replica", "MANIFEST", "RESYNC_REQUEST",
    "read_manifest", "read_resync_request", "request_resync",
    "clear_resync_request", "write_json_atomic",
]

_LAZY = {"DeltaSpec": "delta", "Exporter": "exporter", "Replica": "replica"}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(f"{__name__}.{_LAZY[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
