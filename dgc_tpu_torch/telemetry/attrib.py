"""Device-profile attribution: the kernels of a ``torch.profiler`` trace
-> DGC phases and buckets.

Counterpart of ``dgc_tpu/telemetry/attrib.py``. Pipeline: run a few steps
under ``torch.profiler`` (the CLI's ``--profile`` writes
``<save_path>/profile/trace.json``, :func:`dgc_tpu_torch.utils.profiling.
trace`) with the :mod:`telemetry.trace` phase markers on ->
:func:`load_trace_events` + :func:`device_events` pull out the device
events and give each its phase scope -> :func:`phase_table` aggregates
per-phase / per-bucket device milliseconds -> :func:`profile_json`
assembles the per-bucket cost table (schema ``dgc-profile`` v1, the
reference's) that :meth:`~dgc_tpu_torch.compression.autotune.Autotuner.
add_profile` reads.

**How a device event finds its phase.** XLA writes each op's scope path
into the event (``tf_op``); Kineto's device events (``cat`` ``kernel``,
``gpu_memcpy``, ``gpu_memset``) carry no such path. Each carries
``args.correlation``, the id of the CUDA API call that queued it
(``cudaLaunchKernel``, ``cuLaunchKernelEx`` for Triton, ``cudaMemcpyAsync``,
...), recorded on the host thread that made the call.
The phase markers are ``record_function`` ranges (``cat``
``user_annotation``) on that same thread, so the ``dgcph.`` ranges that
contain the launch's start, outermost first, form the event's scope path
(``args["dgc_scope"]``, joined by "/"), and the innermost token wins, as
with ``tf_op``. Only a launch made on a thread that holds no ``dgcph.``
range (the autograd engine's device thread runs the backward while the
step's thread waits inside ``dgcph.fwd_bwd``) takes the ranges of the
other threads that contain it. The device-side copies of the ranges
(``gpu_user_annotation``) are not used: with W workers queuing their
stages in turn on one stream, they overlap each other's kernels.

On the CPU (the tests) there are no device events: the ops themselves
(``cat`` ``cpu_op``) are the events, each outermost op of a thread once,
with the ranges of its own thread.
"""

import glob
import gzip
import json
import os
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from dgc_tpu_torch.telemetry import trace as _trace

__all__ = ["PROFILE_SCHEMA", "PROFILE_VERSION", "load_trace_events",
           "device_events", "op_phase", "phase_table", "profile_json",
           "write_profile", "load_profile"]

PROFILE_SCHEMA = "dgc-profile"
PROFILE_VERSION = 1

#: ``dgcph.<phase>`` / ``dgcph.<phase>.b<idx>`` anywhere in the scope path
_PHASE_RE = re.compile(r"dgcph\.([A-Za-z_]+)(?:\.b(\d+))?")

#: Kineto's device-side event categories
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


# ---------------------------------------------------------------------- #
# trace loading / event selection                                        #
# ---------------------------------------------------------------------- #

def load_trace_events(path: str) -> List[Dict]:
    """Events of a profiler trace. ``path`` may be a directory (the newest
    ``*.json`` / ``*.json.gz`` below it wins: ``profiling.trace``'s
    ``trace.json``, or a tensorboard handler's ``*.pt.trace.json``), or a
    Chrome-trace ``.json[.gz]`` file."""
    if os.path.isdir(path):
        cands = sorted(
            (p for pat in ("*.json", "*.json.gz")
             for p in glob.glob(os.path.join(path, "**", pat),
                                recursive=True)),
            key=os.path.getmtime)
        if not cands:
            raise FileNotFoundError(
                f"no *.json trace under {path} — did the profiler run?")
        path = cands[-1]
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        obj = json.load(fh)
    return obj.get("traceEvents", []) if isinstance(obj, dict) else obj


def _span(ev: Dict) -> Tuple[float, float]:
    t = float(ev["ts"])
    return t, t + float(ev.get("dur", 0.0))


def _scopes(points: List[Tuple[float, int]],
            ranges: List[Dict]) -> Dict[int, List[str]]:
    """``{point id: [names of the ranges containing its time, outermost
    first]}`` for ``points`` (``(time, id)``), by one sweep over both in
    time order. The ranges need not nest."""
    order = sorted(ranges, key=lambda r: (float(r["ts"]),
                                          -float(r.get("dur", 0.0))))
    out: Dict[int, List[str]] = {}
    active: List[Tuple[float, float, str]] = []
    j = 0
    for t, pid in sorted(points):
        while j < len(order) and float(order[j]["ts"]) <= t:
            s, e = _span(order[j])
            active.append((s, e, order[j]["name"]))
            j += 1
        active = [a for a in active if a[1] >= t]
        out[pid] = [name for _, _, name in active]
    return out


def _phase_ranges(events: List[Dict]) -> Dict[object, List[Dict]]:
    """The ``dgcph.`` ranges by thread id."""
    by_tid: Dict[object, List[Dict]] = defaultdict(list)
    for ev in events:
        if (ev.get("ph") == "X" and ev.get("cat") == "user_annotation"
                and str(ev.get("name", "")).startswith(_trace.SCOPE_PREFIX)):
            by_tid[ev.get("tid")].append(ev)
    return by_tid


def _attach(targets: List[Tuple[Dict, Tuple[object, float]]],
            ranges: Dict[object, List[Dict]]) -> List[Dict]:
    """Copies of the target events with ``args["dgc_scope"]``: the scope
    path at each one's host point ``(tid, time)``, from its own thread's
    ranges, else (a thread that holds none) from every thread's."""
    by_tid: Dict[object, List[Tuple[float, int]]] = defaultdict(list)
    for i, (_, (tid, t)) in enumerate(targets):
        by_tid[tid].append((t, i))
    scope: Dict[int, List[str]] = {}
    orphans: List[Tuple[float, int]] = []
    for tid, pts in by_tid.items():
        if ranges.get(tid):
            scope.update(_scopes(pts, ranges[tid]))
        else:
            orphans += pts
    if orphans:
        everyone = [r for rs in ranges.values() for r in rs]
        scope.update(_scopes(orphans, everyone))
    out = []
    for i, (ev, _) in enumerate(targets):
        ev = dict(ev, args=dict(ev.get("args") or {}))
        if scope.get(i):
            ev["args"]["dgc_scope"] = "/".join(scope[i])
        out.append(ev)
    return out


def _outermost_ops(events: List[Dict]) -> List[Dict]:
    """The ``cpu_op`` events no other op of their thread contains."""
    by_tid: Dict[object, List[Dict]] = defaultdict(list)
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") == "cpu_op" and "dur" in ev:
            by_tid[ev.get("tid")].append(ev)
    out = []
    for ops in by_tid.values():
        end = float("-inf")
        for ev in sorted(ops, key=lambda e: (float(e["ts"]),
                                             -float(e["dur"]))):
            s, e = _span(ev)
            if s >= end:
                out.append(ev)
                end = e
    return out


def device_events(events: List[Dict], device: str = "auto") -> List[Dict]:
    """The trace's device events, each a copy carrying its phase scope
    path in ``args["dgc_scope"]`` (absent when no ``dgcph.`` range holds
    its launch).

    ``device`` — "gpu": the ``kernel`` / ``gpu_memcpy`` / ``gpu_memset``
    events, scoped through their launches (module docstring); "cpu": the
    outermost ``cpu_op`` of each thread, scoped by its own thread's
    ranges; "auto": "gpu" when the trace has device events, else "cpu".
    A device event whose launch the trace lacks keeps no scope."""
    ranges = _phase_ranges(events)
    gpu = [ev for ev in events if ev.get("ph") == "X"
           and ev.get("cat") in _DEVICE_CATS and "dur" in ev]
    if device == "gpu" or (device == "auto" and gpu):
        launch: Dict[object, Dict] = {}
        for ev in events:
            corr = (ev.get("args") or {}).get("correlation")
            if (corr is not None and ev.get("ph") == "X"
                    and ev.get("cat") not in _DEVICE_CATS):
                launch[corr] = ev
        targets = []
        for ev in gpu:
            host = launch.get((ev.get("args") or {}).get("correlation"))
            point = ((host.get("tid"), float(host["ts"])) if host
                     else (None, float("-inf")))
            targets.append((ev, point))
        scoped = _attach([t for t in targets if t[1][0] is not None],
                         ranges)
        loose = [dict(ev) for ev, p in targets if p[0] is None]
        return scoped + loose
    ops = _outermost_ops(events)
    out = []
    for tid in {ev.get("tid") for ev in ops}:
        mine = [ev for ev in ops if ev.get("tid") == tid]
        out += _attach([(ev, (tid, float(ev["ts"]))) for ev in mine],
                       {tid: ranges.get(tid, [])})
    return out


# ---------------------------------------------------------------------- #
# event -> phase mapping                                                 #
# ---------------------------------------------------------------------- #

def op_phase(event: Dict) -> Tuple[Optional[str], Optional[int]]:
    """(phase, bucket) of one device event, or (None, None) when its
    scope path carries no ``dgcph.`` token. The innermost (last) token
    wins — nested markers refine, not shadow."""
    scope = (event.get("args", {}) or {}).get("dgc_scope", "")
    hits = _PHASE_RE.findall(scope)
    if not hits:
        return None, None
    name, bucket = hits[-1]
    return name, (int(bucket) if bucket else None)


def phase_table(events: List[Dict], steps: int = 1) -> Dict:
    """Aggregate device-event durations by DGC phase and bucket.

    Returns ``{"total_ms", "attributed_ms", "unattributed_ms",
    "phases": {phase: ms}, "buckets": {"b<idx>": {phase: ms}},
    "ops": n}`` — all ms figures divided by ``steps`` (per-step)."""
    phases: Dict[str, float] = defaultdict(float)
    buckets: Dict[str, Dict[str, float]] = defaultdict(
        lambda: defaultdict(float))
    total = attributed = 0.0
    for ev in events:
        ms = ev["dur"] / 1e3
        total += ms
        name, bucket = op_phase(ev)
        if name is None:
            continue
        attributed += ms
        phases[name] += ms
        if bucket is not None:
            buckets[f"b{bucket}"][name] += ms
    k = max(int(steps), 1)
    order = {p: i for i, p in enumerate(_trace.PHASES)}
    return {
        "total_ms": round(total / k, 6),
        "attributed_ms": round(attributed / k, 6),
        "unattributed_ms": round((total - attributed) / k, 6),
        "phases": {p: round(v / k, 6) for p, v in sorted(
            phases.items(), key=lambda kv: order.get(kv[0], 99))},
        "buckets": {b: {p: round(v / k, 6) for p, v in sorted(
            t.items(), key=lambda kv: order.get(kv[0], 99))}
            for b, t in sorted(buckets.items(),
                               key=lambda kv: int(kv[0][1:]))},
        "ops": len(events),
    }


# ---------------------------------------------------------------------- #
# profile.json — the planner's cost table                                #
# ---------------------------------------------------------------------- #

def profile_json(dgc_table: Dict, dense_table: Optional[Dict] = None,
                 static: Optional[Dict] = None,
                 measured_overhead_ms: Optional[float] = None) -> Dict:
    """Assemble the machine-readable per-bucket cost table.

    ``dgc_table`` / ``dense_table`` — :func:`phase_table` outputs (per
    step). The exchange planner reads ``dgc.buckets`` (per-bucket,
    per-phase device ms — what a wire-format change would buy) and
    ``delta_ms`` (dgc total minus dense: the profiled compression
    overhead, to reconcile against a paired step timing in
    ``measured_overhead_ms``)."""
    out = {
        "schema": PROFILE_SCHEMA, "version": PROFILE_VERSION,
        "static": dict(static or {}),
        "dgc": dgc_table,
    }
    if dense_table is not None:
        out["dense"] = dense_table
        out["delta_ms"] = round(
            dgc_table["total_ms"] - dense_table["total_ms"], 6)
    exch = sum(v for p, v in dgc_table.get("phases", {}).items()
               if p not in ("fwd_bwd", "update", "loss"))
    out["exchange_phase_ms"] = round(exch, 6)
    if measured_overhead_ms is not None:
        out["measured_overhead_ms"] = round(float(measured_overhead_ms), 6)
    return out


def write_profile(obj: Dict, path: str) -> str:
    """Atomically write profile.json (tmp + rename)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(obj, fh, indent=1)
    os.replace(tmp, path)
    return path


def load_profile(path: str) -> Dict:
    with open(path) as fh:
        obj = json.load(fh)
    if obj.get("schema") != PROFILE_SCHEMA:
        raise ValueError(f"{path}: not a {PROFILE_SCHEMA} file "
                         f"(schema={obj.get('schema')!r})")
    if obj.get("version") != PROFILE_VERSION:
        raise ValueError(f"{path}: profile version {obj.get('version')} "
                         f"(reader supports {PROFILE_VERSION})")
    return obj
