"""Live fleet run monitor (counterpart of
``dgc_tpu/telemetry/monitor.py``; its snapshots and renderings are the
reference's byte for byte).

Point it at a run directory (or a single sink file) and it tails the
telemetry shards through the tolerant reader, merges the fleet view
(:mod:`dgc_tpu_torch.telemetry.fleet`), and serves two read-only
projections:

* ``GET /metrics`` — OpenMetrics / Prometheus text exposition
  (``dgc_``-prefixed gauges, per-worker series labeled ``worker="i"``,
  terminated by ``# EOF`` per the OpenMetrics spec), and
* a terminal status view — step / step rate / loss / compression ratio /
  guard counters / per-worker straggler table / desync verdict / the last
  run event and the last supervisor relaunch event.

Every gauge carries a ``run="…"`` label (the supervisor-assigned
``run_id`` when the run is supervised, else the run dir name) so
single-run and fleet scrapes share one label schema; per-worker series
add ``worker="i"`` alongside it.

Fleet mode (``--fleet``) points the same monitor at a *fleet root* — a
directory of run dirs as laid out by ``python -m dgc_tpu_torch.control``:
``discover_runs`` finds every run, ``/metrics`` serves ONE merged
exposition with each sample distinguished by its ``run`` label, and the
status view becomes a health-ranked table (worst first: collection
errors, quarantines/flight dumps, desync verdicts, stragglers, guard
trips, then step rate) with the control plane's recent remediation
actions underneath.

::

    python -m dgc_tpu_torch.telemetry.monitor runs/exp           # serve
    python -m dgc_tpu_torch.telemetry.monitor runs/exp --once    # render
    python -m dgc_tpu_torch.telemetry.monitor runs/exp --once --openmetrics
    python -m dgc_tpu_torch.telemetry.monitor runs/fleet --fleet # fleet

The monitor is a pure reader: plain file tailing + numpy, no device, no
writes into the run directory, safe to run beside (or long after) the
trainer. Live-writer torn lines are skipped-with-count by the tolerant
reader and the count is surfaced, never silently averaged over.
"""

import argparse
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np

from dgc_tpu_torch.telemetry import fleet as _fleet

__all__ = ["collect", "collect_fleet", "render_openmetrics",
           "render_openmetrics_fleet", "render_status",
           "render_fleet_status", "rank_runs", "serve",
           "supervise_events_path", "read_supervise_events",
           "read_control_events"]

#: default event-stream filename the supervisor writes under the run
SUPERVISE_EVENTS = "supervise_events.jsonl"

#: default fleet-wide event stream the control plane writes under the root
CONTROL_EVENTS = "control_events.jsonl"

#: guard counters surfaced in the status view / quarantine evidence
_GUARD_KEYS = ("skipped_steps", "nonfinite_rate", "checksum_failures")

#: OpenMetrics names for the per-worker fleet columns
_WORKER_GAUGES = {
    "w_clock": ("dgc_worker_clock_ms",
                "host-stamped step prep interval per worker (ms)"),
    "w_grad_norm": ("dgc_worker_grad_norm",
                    "per-worker L2 norm of the local flat gradient"),
    "w_residual_mass": ("dgc_worker_residual_mass",
                        "per-worker L1 mass of the error-feedback residual"),
    "w_sent_ratio": ("dgc_worker_sent_ratio",
                     "per-worker transmitted / total model elements"),
    "w_eff_ratio": ("dgc_worker_eff_ratio",
                    "per-worker effective send fraction from the "
                    "straggler-adaptive policy (1.0 = undegraded)"),
    "w_staleness": ("dgc_worker_staleness",
                    "per-worker gossip age in exchange rounds (0 = "
                    "fresh / gossip off)"),
}

#: OpenMetrics names for scalar record columns (latest step's value)
_SCALAR_GAUGES = {
    "loss": ("dgc_loss", "training loss at the latest recorded step"),
    "grad_norm": ("dgc_grad_norm", "cohort-mean gradient L2 norm"),
    "residual_mass": ("dgc_residual_mass",
                      "cohort-mean residual L1 mass"),
    "straggler": ("dgc_straggler",
                  "argmax worker index of the prep-interval column"),
    "straggler_gap": ("dgc_straggler_gap_ms",
                      "max-min prep interval across workers (ms)"),
    "worker_skew": ("dgc_worker_skew",
                    "max relative cross-worker dispersion"),
    "adaptive_engaged": ("dgc_adaptive_engaged",
                         "1 when the straggler-adaptive policy degraded "
                         "at least one worker this step"),
    "max_staleness_seen": ("dgc_gossip_max_staleness",
                           "stalest gossip age across the cohort this "
                           "step (rounds)"),
    "gossip_forced_syncs": ("dgc_gossip_forced_syncs",
                            "cumulative staleness-breach-forced "
                            "full-sync rounds"),
    "skipped_steps": ("dgc_guard_skipped_steps",
                      "cumulative guard-skipped updates"),
    "nonfinite_rate": ("dgc_guard_nonfinite_rate",
                       "fraction of guarded steps with nonfinite values"),
    "checksum_failures": ("dgc_guard_checksum_failures",
                          "cumulative payload-checksum mismatches"),
}


# --------------------------------------------------------------------- #
# supervise event stream                                                 #
# --------------------------------------------------------------------- #

def supervise_events_path(run: str) -> Optional[str]:
    """First existing supervise event stream near the run: the run dir
    itself, then its parent (``--watch <run>/checkpoints`` makes the
    supervisor default its stream next to the watch dir)."""
    if os.path.isfile(run):
        run = os.path.dirname(os.path.abspath(run))
    for d in (run, os.path.dirname(os.path.abspath(run))):
        p = os.path.join(d, SUPERVISE_EVENTS)
        if os.path.isfile(p):
            return p
    return None


def read_supervise_events(run: str) -> List[Dict]:
    """Tolerantly read the supervisor's JSONL event stream (torn tail
    lines from a live writer are dropped)."""
    path = supervise_events_path(run)
    if path is None:
        return []
    out: List[Dict] = []
    with open(path) as fh:
        for ln in fh:
            if not ln.strip():
                continue
            try:
                out.append(json.loads(ln))
            except json.JSONDecodeError:
                continue
    return out


# --------------------------------------------------------------------- #
# snapshot                                                               #
# --------------------------------------------------------------------- #

def collect(run: str, *, rate_window: int = 50) -> Dict:
    """One monitor snapshot of a run: latest record, derived rates, fleet
    summary, straggler table, guard counters, flight-recorder dump, and
    the trailing events. Pure read."""
    serving_dir = _fleet.discover_serving(run)
    try:
        view = _fleet.load_view(run)
    except FileNotFoundError:
        if serving_dir is None:
            raise
        # a serving-only dir (replica fleet with no trainer telemetry
        # here) is still a monitorable population
        view = _fleet.FleetView(hosts={}, events=[], header={}, skipped=0)
    steps = view.steps
    last = steps[-1] if steps else {}
    static = view.header.get("static", {})
    base = run if os.path.isdir(run) else os.path.dirname(
        os.path.abspath(run))
    snap: Dict = {
        "run": run,
        "t_collect": time.time(),
        "step": int(last.get("step", 0)),
        "num_steps": len(steps),
        "world": view.world,
        "num_hosts": len(view.hosts),
        "skipped_lines": view.skipped,
        "static": static,
        "last": last,
        "summary": _fleet.fleet_summary(view),
        "straggler_table": _fleet.straggler_table(view),
    }
    # step rate from the sink's host stamps over the trailing window
    tail = [r for r in steps[-rate_window:]
            if isinstance(r.get("t_host"), (int, float))]
    if len(tail) >= 2:
        span = float(tail[-1]["t_host"]) - float(tail[0]["t_host"])
        if span > 0:
            snap["steps_per_s"] = round((len(tail) - 1) / span, 3)
    # compression ratio: model elements / transmitted elements per worker
    total = static.get("num_params")
    payload = None
    pvals = [float(r["payload_elems"]) for r in steps[-rate_window:]
             if isinstance(r.get("payload_elems"), (int, float))]
    if pvals:
        payload = float(np.mean(pvals))
    elif static.get("payload_elems"):
        payload = float(static["payload_elems"])
    if total and payload:
        snap["compression_ratio"] = round(float(total) / payload, 2)
    if view.events:
        snap["last_event"] = view.events[-1]
    # guard counters from the newest record that carries them (the last
    # record of a crashing run may be a bare event row)
    for r in reversed(steps):
        if any(isinstance(r.get(k), (int, float)) for k in _GUARD_KEYS):
            snap["guards"] = {k: r[k] for k in _GUARD_KEYS
                              if isinstance(r.get(k), (int, float))}
            break
    # flight-recorder dump next to the run — the quarantine evidence
    fpath = os.path.join(base, "flight.json")
    if os.path.isfile(fpath):
        try:
            from dgc_tpu_torch.telemetry import flight as _flight
            dump = _flight.load_dump(fpath)
            snap["flight"] = {
                "reason": dump.get("reason"),
                "t_dump": dump.get("t_dump"),
                "records": len(dump.get("records") or []),
                "path": fpath,
            }
        except (OSError, ValueError):
            snap["flight"] = {"reason": "unreadable", "path": fpath}
    # cohort surgery state published by the control plane — tolerant:
    # absent or torn file just means no COHORT line / gauges
    cpath = os.path.join(base, "cohort.json")
    if os.path.isfile(cpath):
        try:
            with open(cpath) as f:
                cohort = json.load(f)
            if isinstance(cohort, dict):
                snap["cohort"] = cohort
        except (OSError, ValueError):
            pass
    # serving-stream lane: stream head + per-replica staleness/health
    # (dgc_tpu_torch.serving exporter/replicas publishing under
    # <run>/serving)
    if serving_dir is not None:
        snap["serving"] = _fleet.serving_summary(serving_dir)
    sup = read_supervise_events(run)
    if sup:
        snap["supervise_launches"] = max(
            (int(e.get("launches", 0)) for e in sup), default=0)
        snap["last_supervise"] = sup[-1]
    # the run label every gauge carries: supervisor-assigned run_id when
    # supervised (the event stream and the child's DGC_RUN_ID agree),
    # else the header's run_id, else the run dir name
    run_id = next((e["run_id"] for e in reversed(sup)
                   if e.get("run_id")), None) if sup else None
    snap["run_label"] = str(
        run_id or static.get("run_id")
        or os.path.basename(os.path.normpath(base)) or "run")
    return snap


# --------------------------------------------------------------------- #
# renderers                                                              #
# --------------------------------------------------------------------- #

def _fmt(v: float) -> str:
    # OpenMetrics float formatting: plain repr, no exponent surprises
    f = float(v)
    return repr(int(f)) if f.is_integer() and abs(f) < 2**53 else repr(f)


def _esc(v) -> str:
    # OpenMetrics label-value escaping
    return (str(v).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _labels(run: str, **extra) -> str:
    parts = [f'run="{_esc(run)}"']
    parts += [f'{k}="{_esc(v)}"' for k, v in extra.items()]
    return "{" + ",".join(parts) + "}"


def _snap_samples(snap: Dict, families: Dict) -> None:
    """Append one snapshot's gauge samples into the ordered family map
    ``{name: (help, [(labels, value), ...])}`` — shared by the single-run
    and merged-fleet expositions so both carry the same label schema
    (every sample labeled ``run="…"``, per-worker series additionally
    ``worker="i"``)."""
    run = snap.get("run_label", "run")

    def gauge(name, help_, samples):
        families.setdefault(name, (help_, []))[1].extend(samples)

    gauge("dgc_step", "latest recorded step (sample-count cursor)",
          [(_labels(run), snap.get("step", 0))])
    gauge("dgc_records", "step records merged across host shards",
          [(_labels(run), snap.get("num_steps", 0))])
    gauge("dgc_world", "cohort world size",
          [(_labels(run), snap.get("world", 0))])
    gauge("dgc_hosts", "host shards merged",
          [(_labels(run), snap.get("num_hosts", 0))])
    gauge("dgc_skipped_lines",
          "torn JSONL lines skipped by the tolerant reader",
          [(_labels(run), snap.get("skipped_lines", 0))])
    if "steps_per_s" in snap:
        gauge("dgc_steps_per_second",
              "record rate over the trailing window",
              [(_labels(run), snap["steps_per_s"])])
    if "compression_ratio" in snap:
        gauge("dgc_compression_ratio",
              "model elements / transmitted elements per worker",
              [(_labels(run), snap["compression_ratio"])])

    last = snap.get("last", {})
    guards = snap.get("guards", {})
    for key, (name, help_) in _SCALAR_GAUGES.items():
        value = last.get(key)
        if not isinstance(value, (int, float)) and key in _GUARD_KEYS:
            value = guards.get(key)     # newest record carrying guards
        if isinstance(value, (int, float)):
            gauge(name, help_, [(_labels(run), value)])
    for key, (name, help_) in _WORKER_GAUGES.items():
        col = last.get(key)
        if isinstance(col, list) and col:
            gauge(name, help_,
                  [(_labels(run, worker=i), v) for i, v in enumerate(col)])

    summary = snap.get("summary", {})
    gauge("dgc_desync_alerts",
          "desync detector alerts across monitored mass metrics",
          [(_labels(run), summary.get("desync_alerts", 0))])
    if "flight" in snap:
        gauge("dgc_flight_dump",
              "1 when a flight-recorder dump sits next to the run",
              [(_labels(run), 1)])
    if "supervise_launches" in snap:
        gauge("dgc_supervise_launches",
              "trainer launches recorded by the restart supervisor",
              [(_labels(run), snap["supervise_launches"])])
    serving = snap.get("serving")
    if isinstance(serving, dict) and serving.get("head"):
        head = serving["head"]
        gauge("dgc_serving_latest_seq",
              "delta sequence at the serving stream head",
              [(_labels(run), head.get("latest_seq", 0))])
        gauge("dgc_serving_base_version",
              "full base snapshot generation at the stream head",
              [(_labels(run), head.get("base_version", 0))])
        gauge("dgc_serving_wire_bytes_per_update",
              "delta-stream artifact bytes per published update",
              [(_labels(run), head.get("wire_bytes_per_update", 0))])
        gauge("dgc_serving_replicas", "replicas reporting on the stream",
              [(_labels(run), serving.get("num_replicas", 0))])
        gauge("dgc_serving_stale_replicas",
              "replicas unhealthy or past the pinned max_lag bound",
              [(_labels(run), len(serving.get("stale_replicas", [])))])
        for name_, rec in sorted(serving.get("replicas", {}).items()):
            lbl = _labels(run, replica=name_)
            gauge("dgc_replica_staleness",
                  "delta updates a replica trails the stream head "
                  "(latest_seq - delta_seq; -1 before the first base)",
                  [(lbl, rec.get("staleness", -1))])
            gauge("dgc_replica_healthy",
                  "1 when the replica's health is 'ok', else 0",
                  [(lbl, 1 if rec.get("health") == "ok" else 0)])
            gauge("dgc_replica_delta_seq",
                  "last delta sequence a replica applied on its base",
                  [(lbl, rec.get("delta_seq", -1))])
            gauge("dgc_replica_resyncs",
                  "cumulative full-snapshot reloads by a replica",
                  [(lbl, rec.get("resyncs", 0))])
            gauge("dgc_replica_gaps",
                  "cumulative missing-artifact gaps a replica detected",
                  [(lbl, rec.get("gaps", 0))])

    cohort = snap.get("cohort")
    if isinstance(cohort, dict):
        size = cohort.get("target") or cohort.get("spec_world")
        if isinstance(size, (int, float)):
            gauge("dgc_cohort_size",
                  "published cohort spec world size (surgery target)",
                  [(_labels(run), size)])
        free = cohort.get("pool_free")
        if isinstance(free, (int, float)):
            gauge("dgc_pool_free",
                  "device-pool slots freed by readmit probes and "
                  "available for cohort growth",
                  [(_labels(run), free)])


def _render_families(families: Dict) -> str:
    lines: List[str] = []
    for name, (help_, samples) in families.items():
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} gauge")
        for labels, value in samples:
            lines.append(f"{name}{labels} {_fmt(value)}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def render_openmetrics(snap: Dict) -> str:
    """OpenMetrics text exposition for one snapshot — gauges only, each
    with HELP/TYPE, every sample labeled ``run="…"`` (per-worker series
    also ``worker="i"``), ``# EOF`` terminated."""
    families: Dict = {}
    _snap_samples(snap, families)
    return _render_families(families)


def render_openmetrics_fleet(fsnap: Dict) -> str:
    """ONE merged exposition for a fleet snapshot: every family is
    declared once and carries one sample per run (distinguished by the
    ``run`` label), plus fleet-level gauges — run count, collection
    errors, and per-run control-plane action counts."""
    families: Dict = {}
    runs = fsnap.get("runs", {})
    ok = {n: s for n, s in runs.items() if "error" not in s}
    for name in sorted(ok):
        _snap_samples(ok[name], families)
    families.setdefault(
        "dgc_runs", ("runs discovered under the fleet root",
                     []))[1].append(("", len(runs)))
    families.setdefault(
        "dgc_runs_unreadable",
        ("runs whose telemetry could not be collected this scrape",
         []))[1].append(("", len(runs) - len(ok)))
    counts: Dict[str, int] = {}
    for e in fsnap.get("control", []):
        if e.get("event") == "control_action":
            label = e.get("run_id") or e.get("run", "?")
            counts[label] = counts.get(label, 0) + 1
    if counts:
        families.setdefault(
            "dgc_control_actions",
            ("control-plane remediation actions fired per run", []))[1] \
            .extend((_labels(r), n) for r, n in sorted(counts.items()))
    sched = fsnap.get("sched")
    if sched:
        if isinstance(sched.get("total"), int):
            families.setdefault(
                "dgc_sched_slots_total",
                ("gang scheduler device-pool capacity in seats",
                 []))[1].append(("", sched["total"]))
            families.setdefault(
                "dgc_sched_slots_free",
                ("gang scheduler free seats", []))[1] \
                .append(("", sched.get("free", 0)))
        families.setdefault(
            "dgc_sched_queue_depth",
            ("gangs queued for admission (schedulable)", []))[1] \
            .append(("", sched.get("queue_depth", 0)))
        for gang, slots in sorted((sched.get("holdings") or {}).items()):
            families.setdefault(
                "dgc_sched_held_slots",
                ("seats held per granted gang", []))[1] \
                .append((_labels(gang), slots))
        lat = sched.get("grant_latency")
        if lat:
            families.setdefault(
                "dgc_sched_grant_latency_seconds",
                ("median queue wait across grants", []))[1] \
                .append(("", lat["median_s"]))
    return _render_families(families)


def _event_line(e: Dict) -> str:
    kind = e.get("event", "?")
    extras = {k: e[k] for k in ("step", "epoch", "rc", "launches", "worker",
                                "host", "reason") if k in e}
    t = e.get("t", e.get("t_host"))
    when = time.strftime("%H:%M:%S", time.localtime(t)) if t else "--"
    kv = " ".join(f"{k}={v}" for k, v in extras.items())
    return f"{kind} @{when}" + (f" ({kv})" if kv else "")


def render_status(snap: Dict) -> str:
    """Terminal status view for one snapshot."""
    summary = snap.get("summary", {})
    last = snap.get("last", {})
    lines = [
        f"== dgc fleet monitor == {snap['run']}",
        "   step {step}  records {num_steps}  world {world}  "
        "hosts {num_hosts}".format(**snap),
    ]
    row2 = []
    if "steps_per_s" in snap:
        row2.append(f"rate {snap['steps_per_s']}/s")
    if isinstance(last.get("loss"), (int, float)):
        row2.append(f"loss {last['loss']:.4g}")
    if "compression_ratio" in snap:
        row2.append(f"compression {snap['compression_ratio']}x")
    if snap.get("skipped_lines"):
        row2.append(f"torn-lines-skipped {snap['skipped_lines']}")
    if row2:
        lines.append("   " + "  ".join(row2))
    gvals = snap.get("guards") or {
        k: last[k] for k in _GUARD_KEYS
        if isinstance(last.get(k), (int, float))}
    if gvals:
        tripped = any(v for v in gvals.values())
        lines.append(("   GUARD TRIPS: " if tripped else "   guards: ")
                     + "  ".join(f"{k}={v:.4g}"
                                 for k, v in gvals.items()))
    flight = snap.get("flight")
    if flight:
        t = flight.get("t_dump")
        when = time.strftime("%H:%M:%S", time.localtime(t)) if t else "--"
        lines.append(f"   FLIGHT DUMP @{when}: "
                     f"reason={flight.get('reason')!r} "
                     f"records={flight.get('records', '?')} "
                     f"({flight.get('path', 'flight.json')})")

    table = snap.get("straggler_table") or []
    if table:
        lines.append("   worker  mean_ms   max_ms  last_ms  share")
        for r in table:
            mark = "  <- straggler" if r is table[0] and len(table) > 1 \
                else ""
            lines.append(
                f"   {r['worker']:>6}  {r['mean_ms']:>7.1f}  "
                f"{r['max_ms']:>7.1f}  {r['last_ms']:>7.1f}  "
                f"{r['share']:>5.2f}{mark}")
        if "straggler_gap" in summary:
            lines.append(
                f"   straggler gap {summary['straggler_gap']:.1f}ms  "
                f"worker skew {summary.get('worker_skew', 0.0):.3g}")
    else:
        lines.append("   (no fleet clock column — run without "
                     "configs/fleet.py?)")

    if last.get("adaptive_engaged"):
        eff = last.get("w_eff_ratio")
        degraded = ""
        if isinstance(eff, list) and eff:
            degraded = "  " + "  ".join(
                f"w{i}={float(v):.2f}" for i, v in enumerate(eff)
                if isinstance(v, (int, float)) and v < 0.999)
        lines.append("   ADAPTIVE: straggler send fraction degraded"
                     + degraded)

    stale_seen = last.get("max_staleness_seen")
    if isinstance(stale_seen, (int, float)) and stale_seen > 0:
        parts = [f"max staleness {stale_seen:.0f} rounds"]
        col = last.get("w_staleness")
        if isinstance(col, list) and col:
            vals = [float(v) if isinstance(v, (int, float)) else 0.0
                    for v in col]
            stalest = max(range(len(vals)), key=vals.__getitem__)
            parts.append(f"stalest w{stalest} ({vals[stalest]:.0f})")
        forced = last.get("gossip_forced_syncs")
        if isinstance(forced, (int, float)) and forced > 0:
            parts.append(f"FORCED SYNCS {forced:.0f}")
        lines.append("   GOSSIP: " + "  ".join(parts))

    n_alerts = summary.get("desync_alerts", 0)
    if n_alerts:
        first = summary.get("desync_first", {})
        lines.append(
            f"   DESYNC: {n_alerts} alerts, workers "
            f"{summary.get('desync_workers')} — first at step "
            f"{first.get('step')} ({first.get('metric')}, deviation "
            f"{first.get('deviation', 0.0):.2f} > band "
            f"{first.get('band', 0.0):.2f})")
    else:
        lines.append("   desync: quiet")

    cohort = snap.get("cohort")
    if isinstance(cohort, dict):
        target = cohort.get("target") or cohort.get("spec_world")
        active = cohort.get("active")
        parts = []
        if target is not None:
            parts.append(f"world {active if active is not None else '?'}"
                         f"/{target}")
        q = cohort.get("quarantined") or []
        if q:
            parts.append("quarantined=[" + ",".join(str(n) for n in q)
                         + "]")
        free = cohort.get("pool_free", cohort.get("free"))
        if free is not None:
            parts.append(f"pool free {free}")
        probe = cohort.get("probe")
        if isinstance(probe, dict):
            parts.append("probe "
                         + ("passed" if probe.get("passed") else "failed"))
        if parts:
            lines.append("   COHORT: " + "  ".join(parts))

    serving = snap.get("serving")
    if isinstance(serving, dict) and serving.get("head"):
        head = serving["head"]
        parts = [f"head v{head.get('base_version')}:"
                 f"{head.get('latest_seq')}",
                 f"{serving.get('num_replicas', 0)} replicas"]
        if "max_staleness" in serving:
            parts.append(f"max staleness {serving['max_staleness']}"
                         f"/{head.get('max_lag')}")
        wire = head.get("wire_bytes_per_update")
        full = head.get("full_checkpoint_bytes")
        if wire and full:
            parts.append(f"wire {wire}B/update ({wire / full:.2%} of "
                         "full ckpt)")
        stale = serving.get("stale_replicas") or []
        line = "   SERVING: " + "  ".join(parts)
        if stale:
            line += "  STALE=[" + ",".join(stale) + "]"
        lines.append(line)
        for name_, rec in sorted(serving.get("replicas", {}).items()):
            if rec.get("health") != "ok":
                lines.append(f"     replica {name_}: {rec.get('health')} "
                             f"@ v{rec.get('base_version')}:"
                             f"{rec.get('delta_seq')} "
                             f"(staleness {rec.get('staleness')}, "
                             f"gaps {rec.get('gaps')}, "
                             f"resyncs {rec.get('resyncs')})")

    if "last_event" in snap:
        lines.append("   last run event:   "
                     + _event_line(snap["last_event"]))
    if "last_supervise" in snap:
        lines.append("   last supervise:   "
                     + _event_line(snap["last_supervise"])
                     + f"  [launches={snap.get('supervise_launches', 0)}]")
    return "\n".join(lines) + "\n"


# --------------------------------------------------------------------- #
# fleet mode                                                             #
# --------------------------------------------------------------------- #

def read_control_events(fleet_root: str) -> List[Dict]:
    """Tolerantly read the control plane's fleet-wide event stream
    (``control_events.jsonl`` under the fleet root)."""
    path = os.path.join(fleet_root, CONTROL_EVENTS)
    if not os.path.isfile(path):
        return []
    out: List[Dict] = []
    with open(path) as fh:
        for ln in fh:
            if not ln.strip():
                continue
            try:
                out.append(json.loads(ln))
            except json.JSONDecodeError:
                continue
    return out


def collect_sched(fleet_root: str) -> Optional[Dict]:
    """The gang scheduler's SCHED lane: queue snapshot + grant-ledger
    stats from the scheduler-ledger protocol files under the fleet root
    (control.scheduler). ``None`` when no scheduler ever ran here."""
    # lazy import: the monitor must stay importable without the control
    # plane package in degraded environments
    from dgc_tpu_torch.control import scheduler as _sched
    snap = _sched.read_queue(fleet_root)
    records, skipped = _sched.read_grant_ledger(fleet_root)
    if snap is None and not records:
        return None
    out: Dict = {"queue_depth": 0, "ledger_records": len(records),
                 "ledger_skipped": skipped}
    if snap is not None:
        total = snap.get("total")
        queue = snap.get("queue") or []
        # schedulable depth only (mirrors GangScheduler.pending): a
        # permanently-parked entry must not read as a backlog
        depth = sum(1 for e in queue
                    if not isinstance(total, int)
                    or int(e.get("slots", 0)) <= total)
        out.update(total=total, free=snap.get("free"), queue_depth=depth,
                   holdings={n: h.get("slots")
                             for n, h in (snap.get("holdings")
                                          or {}).items()},
                   unschedulable=snap.get("unschedulable") or [])
    lat = _sched.grant_latency_summary(records)
    if lat is not None:
        out["grant_latency"] = lat
    return out


def collect_fleet(fleet_root: str, *, rate_window: int = 50) -> Dict:
    """One snapshot of every run under a fleet root. Tolerant per run: a
    run whose telemetry cannot be read yields ``{"error": ...}`` instead
    of poisoning the rest of the fleet."""
    snaps: Dict[str, Dict] = {}
    for name, path in sorted(_fleet.discover_runs(fleet_root).items()):
        try:
            snaps[name] = collect(path, rate_window=rate_window)
        except (OSError, ValueError) as e:
            snaps[name] = {"run": path, "run_label": name,
                           "error": f"{type(e).__name__}: {e}"}
    fsnap = {"root": fleet_root, "t_collect": time.time(), "runs": snaps,
             "control": read_control_events(fleet_root)}
    sched = collect_sched(fleet_root)
    if sched is not None:
        fsnap["sched"] = sched
    return fsnap


def rank_runs(fsnap: Dict) -> List[Dict]:
    """Health-ranked fleet rows, WORST first — the operator's reading
    order. Score starts at 100 and sheds points for, in decreasing
    weight: unreadable telemetry, quarantine evidence (flight dump /
    exit-70 / giveup), desync alerts, guard trips, a persistent
    straggler, and a stalled step rate."""
    rows: List[Dict] = []
    control_by_run: Dict[str, Dict] = {}
    for e in fsnap.get("control", []):
        if e.get("event") == "control_action":
            control_by_run[e.get("run", "?")] = e
    for name, snap in fsnap.get("runs", {}).items():
        row: Dict = {"name": name, "last_control": control_by_run.get(name)}
        if "error" in snap:
            rows.append(dict(row, score=0, verdict="unreadable",
                             error=snap["error"]))
            continue
        score = 100
        notes = []
        last_sup = snap.get("last_supervise") or {}
        if snap.get("flight"):
            score -= 50
            notes.append("flight-dump")
        if (last_sup.get("event") in ("quarantined", "giveup")
                or last_sup.get("rc") == 70):
            score -= 50
            notes.append(last_sup.get("event") or "rc70")
        summary = snap.get("summary") or {}
        if summary.get("desync_alerts"):
            score -= 40
            notes.append(f"desync x{summary['desync_alerts']}")
        guards = snap.get("guards") or {}
        if any(guards.get(k) for k in _GUARD_KEYS):
            score -= 20
            notes.append("guard-trips")
        share = summary.get("straggler_share")
        if share is not None and share >= 1.5:
            score -= 15
            notes.append(f"straggler w{summary.get('straggler')} "
                         f"x{share:.2f}")
        stale = (snap.get("serving") or {}).get("stale_replicas") or []
        if stale:
            score -= 25
            notes.append("stale-replicas [" + ",".join(stale) + "]")
        if not snap.get("steps_per_s") and last_sup.get("event") not in \
                ("done",):
            score -= 10
            notes.append("no-rate")
        rows.append(dict(
            row, score=max(score, 0),
            verdict=("healthy" if score >= 80 else
                     "degraded" if score >= 40 else "critical"),
            step=snap.get("step"), rate=snap.get("steps_per_s"),
            world=snap.get("world"), run_label=snap.get("run_label"),
            launches=snap.get("supervise_launches"),
            last_supervise=last_sup.get("event"), notes=notes))
    rows.sort(key=lambda r: (r["score"], r["name"]))
    return rows


def render_fleet_status(fsnap: Dict) -> str:
    """Terminal fleet view: health-ranked run table (worst first) plus
    the control plane's most recent remediation actions."""
    runs = fsnap.get("runs", {})
    control = fsnap.get("control", [])
    n_actions = sum(1 for e in control if e.get("event") == "control_action")
    lines = [
        f"== dgc fleet control == {fsnap.get('root', '?')}",
        f"   {len(runs)} runs  {n_actions} control actions",
    ]
    sched = fsnap.get("sched")
    if sched:
        bits = [f"slots {sched.get('free', '?')}/{sched.get('total', '?')} "
                f"free", f"queue {sched.get('queue_depth', 0)}"]
        holdings = sched.get("holdings") or {}
        if holdings:
            bits.append("held " + " ".join(
                f"{n}:{s}" for n, s in sorted(holdings.items())))
        lat = sched.get("grant_latency")
        if lat:
            bits.append(f"grant p50 {lat['median_s']:.2f}s "
                        f"max {lat['max_s']:.2f}s")
        if sched.get("unschedulable"):
            bits.append("UNSCHEDULABLE [" +
                        ",".join(sched["unschedulable"]) + "]")
        lines.append("   SCHED: " + "  ".join(bits))
    lines.append(
        "   health  verdict     run           step    rate/s  launches  "
        "notes")
    for r in rank_runs(fsnap):
        if r["verdict"] == "unreadable":
            lines.append(f"   {r['score']:>6}  {r['verdict']:<10}  "
                         f"{r['name']:<12}  {r.get('error', '')}")
            continue
        rate = f"{r['rate']:.2f}" if isinstance(r.get("rate"),
                                                (int, float)) else "--"
        lines.append(
            f"   {r['score']:>6}  {r['verdict']:<10}  {r['name']:<12}  "
            f"{str(r.get('step', '--')):>4}  {rate:>8}  "
            f"{str(r.get('launches', '--')):>8}  "
            + (", ".join(r["notes"]) if r.get("notes") else "ok"))
    actions = [e for e in control if e.get("event") == "control_action"]
    if actions:
        lines.append("   recent control actions (newest last):")
        for e in actions[-5:]:
            ev = e.get("evidence", {})
            t = e.get("t")
            when = time.strftime("%H:%M:%S", time.localtime(t)) if t \
                else "--"
            lines.append(f"     {when}  {e.get('run')}: "
                         f"{e.get('rule')} -> {e.get('action')} "
                         f"(evidence: {ev.get('kind')})")
    return "\n".join(lines) + "\n"


# --------------------------------------------------------------------- #
# server                                                                 #
# --------------------------------------------------------------------- #

_OPENMETRICS_CT = ("application/openmetrics-text; version=1.0.0; "
                   "charset=utf-8")


class _Cache:
    """Re-collect at most once per ``interval`` seconds; collection
    errors (e.g. the run dir appearing late) are served as a 503 body
    rather than killing the monitor."""

    def __init__(self, collect_fn, interval: float):
        if isinstance(collect_fn, str):        # a run path: single-run collect
            collect_fn = (lambda path: lambda: collect(path))(collect_fn)
        self._collect = collect_fn
        self.interval = float(interval)
        self._lock = threading.Lock()
        self._snap: Optional[Dict] = None
        self._err: Optional[str] = None
        self._t = 0.0

    def snapshot(self):
        with self._lock:
            now = time.monotonic()
            if self._snap is None or now - self._t >= self.interval:
                try:
                    self._snap, self._err = self._collect(), None
                except (OSError, ValueError) as e:
                    self._err = f"{type(e).__name__}: {e}"
                self._t = now
            return self._snap, self._err


def _make_handler(cache: "_Cache", fleet: bool = False):
    status_fn = render_fleet_status if fleet else render_status
    metrics_fn = render_openmetrics_fleet if fleet else render_openmetrics

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            snap, err = cache.snapshot()
            if snap is None:
                body, code, ct = (err or "no data") + "\n", 503, \
                    "text/plain; charset=utf-8"
            elif self.path.rstrip("/") in ("", "/status"):
                body, code, ct = status_fn(snap), 200, \
                    "text/plain; charset=utf-8"
            elif self.path == "/metrics":
                body, code, ct = metrics_fn(snap), 200, \
                    _OPENMETRICS_CT
            else:
                body, code, ct = "not found\n", 404, \
                    "text/plain; charset=utf-8"
            data = body.encode()
            self.send_response(code)
            self.send_header("Content-Type", ct)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *a):   # quiet: status goes to the terminal
            pass

    return Handler


def serve(run: str, *, port: int = 9100, interval: float = 5.0,
          max_iterations: Optional[int] = None, fleet: bool = False) -> int:
    """Serve ``/metrics`` + ``/status`` and print the terminal view every
    ``interval`` seconds until interrupted (``max_iterations`` bounds the
    loop for tests). ``fleet=True`` treats ``run`` as a fleet root and
    serves the merged exposition / health-ranked table."""
    collect_fn = ((lambda: collect_fleet(run)) if fleet
                  else (lambda: collect(run)))
    cache = _Cache(collect_fn, interval=min(interval, 5.0))
    server = ThreadingHTTPServer(("", port), _make_handler(cache, fleet))
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              name="dgc-monitor-http")
    thread.start()
    print(f"[monitor] serving /metrics + /status on "
          f"http://0.0.0.0:{server.server_address[1]}  (ctrl-c to stop)",
          flush=True)
    status_fn = render_fleet_status if fleet else render_status
    n = 0
    try:
        while max_iterations is None or n < max_iterations:
            snap, err = cache.snapshot()
            print(status_fn(snap) if snap is not None
                  else f"[monitor] waiting for telemetry: {err}",
                  flush=True)
            n += 1
            if max_iterations is not None and n >= max_iterations:
                break
            time.sleep(interval)
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
    return 0


def _main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dgc_tpu_torch.telemetry.monitor",
        description="live fleet monitor over a telemetry run directory")
    ap.add_argument("run", help="run dir (or telemetry dir / .jsonl file; "
                                "a fleet root with --fleet)")
    ap.add_argument("--port", type=int, default=9100,
                    help="OpenMetrics endpoint port (0 = ephemeral)")
    ap.add_argument("--interval", type=float, default=5.0,
                    help="terminal refresh / re-read period, seconds")
    ap.add_argument("--once", action="store_true",
                    help="render one snapshot to stdout and exit")
    ap.add_argument("--openmetrics", action="store_true",
                    help="with --once: print the /metrics exposition "
                         "instead of the status view")
    ap.add_argument("--fleet", action="store_true",
                    help="treat RUN as a fleet root of run dirs: merged "
                         "per-run-labeled /metrics, health-ranked status")
    args = ap.parse_args(argv)
    if args.once:
        try:
            snap = (collect_fleet(args.run) if args.fleet
                    else collect(args.run))
        except (OSError, ValueError) as e:
            print(f"[monitor] {type(e).__name__}: {e}")
            return 1
        if args.fleet:
            print(render_openmetrics_fleet(snap) if args.openmetrics
                  else render_fleet_status(snap), end="")
        else:
            print(render_openmetrics(snap) if args.openmetrics
                  else render_status(snap), end="")
        return 0
    return serve(args.run, port=args.port, interval=args.interval,
                 fleet=args.fleet)


if __name__ == "__main__":
    raise SystemExit(_main())
