"""Online exchange replanning: refit the link model from measured step
times and re-run the regime planner at epoch boundaries.

Counterpart of ``dgc_tpu/compression/autotune.py`` (host-only Python, a
copy of it). The planner
chooses regimes once, at engine-build time, from a static fabric model;
the :class:`Autotuner` closes the loop on the host::

    step loop   -> record_step(wall_ms, wire_bytes)
                   (+ add_profile(profile.json), add_fleet_view(run dir))
                         |
                 epoch boundary: epoch_end(engine, profile=...)
                         |
        fit_link_model(points, prior=current fabric)
                         |
        persist  <save_path>/fabric.json  (provenance-stamped)
                         |
        plan_engine(engine, fabric=refit)  ->  key() comparison
                         |
        key unchanged -> keep the engine
        key changed   -> the caller rebuilds the engine once

Everything here is host-side: a replan adds no collective, and with an
unchanged ``key()`` no rebuild. The refit fabric keeps one stable name
(``autotuned-<base>``) from the first plan on, so ``Plan.key()`` —
``(fabric.name, world, regimes)`` — changes exactly when the chosen
regimes change.

Besides the step points: :meth:`Autotuner.add_profile` takes each
bucket's all-gather device milliseconds from a ``dgc-profile`` table
(:mod:`dgc_tpu_torch.telemetry.attrib`) against the bucket's wire bytes,
and :meth:`Autotuner.add_fleet_view` the per-step cohort maximum of a
fleet lane from a run's sink shards (:mod:`dgc_tpu_torch.telemetry.
fleet`). Refits and replans go to ``sink`` as ``autotune_replan``
records.

The gossip regimes (``planner.GOSSIP_REGIMES``) are not in the default
candidates the replans sweep: gossip changes the consistency model
(bounded staleness, :mod:`~dgc_tpu_torch.compression.gossip`), not only
the wire, so a caller opts in with ``candidates=REGIMES + (family,)``
(the trainer does for a recipe with ``train.gossip``); from then on each
refit weighs the family's amortized neighborhood cost against the
all-gather, with the schedule knobs ``gossip_sync_every`` /
``gossip_max_staleness`` carried into every replan.
"""

import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from dgc_tpu_torch.compression.planner import (
    DEFAULT_COST,
    FABRIC_SCHEMA,
    FABRIC_VERSION,
    Fabric,
    Plan,
    REGIMES,
    fit_link_model,
    plan_engine,
    resolve_fabric,
)

__all__ = ["Autotuner", "regime_histogram"]


def regime_histogram(regimes: Sequence[str]) -> Dict[str, int]:
    """``{regime: bucket count}`` of a plan's per-bucket choices (plain
    dict, sorted keys)."""
    out: Dict[str, int] = {}
    for r in regimes:
        out[r] = out.get(r, 0) + 1
    return dict(sorted(out.items()))


def _write_json_atomic(path: str, obj) -> None:
    """Write ``obj`` as JSON to ``path`` through a uniquely named file in
    the same directory, flushed to disk, then one ``os.replace``."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".fabric.", dir=d)
    try:
        with os.fdopen(fd, "w") as fh:
            json.dump(obj, fh, indent=1)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


class Autotuner:
    """Epoch-boundary replanner over one engine's exchange.

    ``fabric`` resolves through :func:`planner.resolve_fabric` (None: the
    env ``DGC_FABRIC`` / ``runs/fabric.json`` / built-in chain) and is
    renamed to the stable ``autotuned-<base>`` identity the refits keep.
    Measured (bytes, ms) points accumulate across epochs, and every refit
    uses the current fabric as the degenerate-input prior
    (:func:`planner.fit_link_model`), so a cluster of identical step sizes
    cannot produce an unphysical fit."""

    def __init__(self, fabric=None, *, world: int,
                 runs_dir: str = "runs",
                 fabric_out: Optional[str] = None,
                 candidates: Sequence[str] = REGIMES,
                 cost=DEFAULT_COST,
                 min_points: int = 2,
                 max_points: int = 4096,
                 sink=None,
                 gossip_sync_every: Optional[int] = None,
                 gossip_max_staleness: Optional[int] = None):
        base = resolve_fabric(fabric, runs_dir=runs_dir)
        name = (base.name if base.name.startswith("autotuned-")
                else f"autotuned-{base.name}")
        self.base_name = base.name
        self.fabric = Fabric(name, int(world), base.gbps, base.alpha_ms,
                             measured=base.measured)
        self.world = int(world)
        self.candidates = tuple(candidates)
        self.cost = cost
        self.min_points = int(min_points)
        self.max_points = int(max_points)
        self.fabric_out = fabric_out
        self.sink = sink
        #: the gossip schedule knobs (meaningful with a gossip family in
        #: ``candidates``), threaded into every replan
        self.gossip_sync_every = gossip_sync_every
        self.gossip_max_staleness = gossip_max_staleness
        #: measured (wire bytes, ms) pool, newest last
        self.points: List[Tuple[float, float]] = []
        self.refit_count = 0      # fits performed
        self.replan_count = 0     # fits whose plan key() changed
        self._plan: Optional[Plan] = None

    # -- planning --------------------------------------------------- #

    @property
    def plan(self) -> Optional[Plan]:
        return self._plan

    def plan_for(self, engine) -> Plan:
        """Plan the engine's current bucket geometry under the current
        (possibly refit) fabric — the rebuild path: a warm-up ratio change
        reshapes the buckets, so the plan is recomputed against the engine
        that will realize it."""
        self._plan = plan_engine(
            engine, fabric=self.fabric, world=self.world, cost=self.cost,
            candidates=self.candidates,
            gossip_sync_every=self.gossip_sync_every,
            gossip_max_staleness=self.gossip_max_staleness)
        return self._plan

    # -- measured inputs -------------------------------------------- #

    def record_step(self, wall_ms: float, wire_bytes: int) -> None:
        """One host-stamped step interval against the engine's static
        per-worker wire bytes. Coarse (it includes compute) but free; the
        prior-pinned intercept keeps a same-size cluster from bending
        alpha."""
        if wall_ms > 0 and wire_bytes > 0:
            self.points.append((float(wire_bytes), float(wall_ms)))
            if len(self.points) > self.max_points:
                del self.points[:len(self.points) - self.max_points]

    def add_profile(self, profile: Optional[Dict], engine) -> int:
        """Per-bucket allgather device ms from an
        ``attrib.profile_json`` dict x the engine's per-bucket wire
        bytes — the sharp input: every differently-sized bucket is a
        distinct point on the line. Returns points added."""
        if not profile:
            return 0
        buckets = (profile.get("dgc") or {}).get("buckets") or {}
        wire = engine.bucket_wire_bytes()
        added = 0
        for i, nbytes in enumerate(wire):
            tab = buckets.get(f"b{i}")
            if not isinstance(tab, dict) or nbytes <= 0:
                continue
            ms = tab.get("allgather")
            if isinstance(ms, (int, float)) and ms > 0:
                self.record_step(float(ms), int(nbytes))
                added += 1
        return added

    def add_fleet_view(self, run_dir: str, wire_bytes: int,
                       metric: str = "w_clock", last: int = 200) -> int:
        """Per-step cohort max of a fleet lane (``telemetry.fleet``
        sink shards) x the static wire bytes — the slowest worker
        bounds the synchronous exchange. Tolerant: a missing or
        unreadable run directory adds nothing."""
        try:
            from dgc_tpu_torch.telemetry.fleet import load_view, worker_series
            series = worker_series(load_view(run_dir), metric)
        except Exception:
            return 0
        added = 0
        for _, lanes in series[-last:]:
            vals = [v for v in lanes if isinstance(v, (int, float))
                    and np.isfinite(v) and v > 0]
            if vals and wire_bytes > 0:
                self.record_step(max(vals), wire_bytes)
                added += 1
        return added

    # -- the refit -------------------------------------------------- #

    def epoch_end(self, engine, epoch: Optional[int] = None,
                  profile: Optional[Dict] = None) -> Optional[Plan]:
        """Refit the link model over the accumulated points, persist the
        provenance-stamped fabric, and replan. Returns the new
        :class:`Plan` iff its ``key()`` differs from the active plan's
        (the caller's rebuild trigger); None keeps the engine as it is."""
        if profile:
            self.add_profile(profile, engine)
        if len(self.points) < self.min_points:
            return None
        alpha, gbps = fit_link_model(self.points, prior=self.fabric)
        self.fabric = self.fabric._replace(
            gbps=float(gbps), alpha_ms=float(alpha), measured=True)
        self.refit_count += 1
        if self.fabric_out:
            self.write_fabric(self.fabric_out, epoch=epoch)
        new = plan_engine(engine, fabric=self.fabric, world=self.world,
                          cost=self.cost, candidates=self.candidates,
                          gossip_sync_every=self.gossip_sync_every,
                          gossip_max_staleness=self.gossip_max_staleness)
        changed = self._plan is None or new.key() != self._plan.key()
        if self.sink is not None:
            self.sink.write_record({
                "event": "autotune_replan",
                "epoch": epoch,
                "alpha_ms": self.fabric.alpha_ms,
                "gbps": self.fabric.gbps,
                "points": len(self.points),
                "rebuilt": bool(changed),
                "regimes": regime_histogram(new.regimes),
            })
        if not changed:
            return None
        self._plan = new
        self.replan_count += 1
        return new

    # -- persistence ------------------------------------------------ #

    def _fit_residual_ms(self) -> float:
        """RMS of ``t - (alpha + bytes/bw)`` over the point pool — the
        provenance quality stamp."""
        beta = 1.0 / (self.fabric.gbps * 1e6)
        errs = [t - (self.fabric.alpha_ms + b * beta)
                for b, t in self.points]
        return float(np.sqrt(np.mean(np.square(errs)))) if errs else 0.0

    def write_fabric(self, path: str, epoch: Optional[int] = None) -> str:
        """Schema-versioned ``fabric.json`` (``planner.load_fabric``
        round-trips it; the provenance block rides as extra keys), written
        atomically."""
        sizes = sorted({int(b) for b, _ in self.points})
        obj = {
            "schema": FABRIC_SCHEMA,
            "version": FABRIC_VERSION,
            "name": self.fabric.name,
            "workers": self.fabric.workers,
            "fit": {"alpha_ms": self.fabric.alpha_ms,
                    "gbps": self.fabric.gbps},
            "provenance": {
                "source": "autotune",
                "base": self.base_name,
                "refit": self.refit_count,
                "epoch": epoch,
                "points": len(self.points),
                "distinct_sizes": len(sizes),
                "geometry_bytes": sizes[:64],
                "fit_residual_ms": self._fit_residual_ms(),
                "written_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
            },
        }
        _write_json_atomic(path, obj)
        return path
