"""Declarative alert → remediation rules for the control plane
(counterpart of ``dgc_tpu/control/rules.py``).

A :class:`Rule` binds a *detector* — a pure function over one run's
monitor snapshot (:func:`dgc_tpu_torch.telemetry.monitor.collect`)
returning evidence or ``None`` — to a named remediation from
:data:`dgc_tpu_torch.telemetry.registry.CONTROL_ACTIONS`. The
:class:`RuleEngine` adds the operational hygiene every auto-remediation
needs:

* **persistence** (``min_hits``) — the detector must fire on that many
  *consecutive* ticks before the rule does; one noisy snapshot never
  restarts a run.
* **debounce** (``debounce_s``) — after firing, the rule stays quiet for
  a window so the remediation has time to take effect before the same
  evidence (which may persist through a restart) can fire it again.
* **budget** (``budget``) — a hard per-(run, rule) cap on firings for
  the plane's lifetime; a remediation that doesn't stick escalates to a
  human instead of flapping forever.

Suppressed firings (debounced or over budget) are counted and visible
via ``engine.suppressed`` — silence must be attributable too. The engine
takes ``now`` explicitly so tests drive it with a fake clock.

The table itself can come from a ``rules.toml`` file
(:func:`load_rules`) so an operator retunes thresholds or wires the
``adapt`` remediation without touching code; the code table
(:func:`default_rules`) stays the default.

One deliberate divergence from the reference: :func:`detect_quarantine`
does not read a flight dump written on a relaunch path — the trainer's
preemption save (exit 75, reason ``preempt signal N``) and its cohort
surgery exits (76, ``surgery: ...``) — as evidence. The reference
quarantines on any dump, which stops its own restart remediation from
relaunching a real trainer that dumps on SIGTERM.
"""

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

__all__ = ["Rule", "RuleEngine", "default_rules", "load_rules",
           "DETECTORS", "detect_desync", "detect_straggler",
           "detect_quarantine", "detect_cohort_shrink", "detect_excise",
           "detect_readmit", "detect_stale_replica", "detect_autoscale"]


class Rule(NamedTuple):
    """One row of the remediation table."""
    name: str
    detect: Callable[[Dict], Optional[Dict]]
    action: str                 # a registry.CONTROL_ACTIONS name
    min_hits: int = 2           # consecutive detecting ticks before firing
    debounce_s: float = 60.0    # quiet window after a firing
    budget: int = 2             # lifetime firings per (run, rule)


# ---------------------------------------------------------------------- #
# detectors — tolerant by design: a half-collected snapshot (young run,  #
# torn shard, no supervise stream yet) must read as "no evidence", never #
# raise                                                                  #
# ---------------------------------------------------------------------- #

def detect_desync(snap: Dict) -> Optional[Dict]:
    """A worker's residual walked out of the cohort's rolling band
    (:func:`dgc_tpu_torch.telemetry.fleet.detect_desync` verdict in the
    snapshot summary) — the silent-corruption signature. Remediation:
    restart the run so it restores from the last good checkpoint."""
    s = snap.get("summary") or {}
    alerts = s.get("desync_alerts") or 0
    workers = s.get("desync_workers") or []
    if alerts and workers:
        return {"kind": "desync", "alerts": int(alerts),
                "workers": list(workers), "first": s.get("desync_first")}
    return None


def detect_straggler(snap: Dict, min_share: float = 1.5,
                     min_gap_ms: float = 20.0) -> Optional[Dict]:
    """One worker persistently slower than the cohort mean by
    ``min_share`` (and trailing by at least ``min_gap_ms``) — the whole
    cohort runs at its pace. Remediation: publish a smaller cohort spec
    and elastically relaunch without it."""
    s = snap.get("summary") or {}
    share = s.get("straggler_share")
    gap = s.get("straggler_gap")
    worker = s.get("straggler")
    if (share is not None and gap is not None and worker is not None
            and math.isfinite(share) and share >= min_share
            and gap >= min_gap_ms):
        return {"kind": "straggler", "worker": int(worker),
                "share": float(share), "gap_ms": float(gap)}
    return None


#: reason prefixes of the flight dumps the trainer writes on its relaunch
#: paths (the emergency save before exit 75, the surgery exits 76)
RELAUNCH_DUMPS = ("preempt signal", "surgery:")


def detect_quarantine(snap: Dict, max_nonfinite_rate: float = 0.5) \
        -> Optional[Dict]:
    """The run is numerically dead or crashed hard: a flight-recorder
    dump on disk (other than one of :data:`RELAUNCH_DUMPS`), a
    nonfinite-streak abort (exit 70), or a saturated nonfinite guard
    rate. Remediation: quarantine — relaunching a run that diverges
    deterministically just burns the retry budget and overwrites the
    evidence."""
    flight = snap.get("flight") or {}
    if flight.get("reason") and not str(flight["reason"]).startswith(
            RELAUNCH_DUMPS):
        return {"kind": "flight_dump", "reason": flight["reason"],
                "t_dump": flight.get("t_dump"),
                "records": flight.get("records")}
    last = snap.get("last_supervise") or {}
    if last.get("event") in ("relaunch", "quarantined", "giveup") \
            and last.get("rc") == 70:
        return {"kind": "nonfinite_abort", "rc": 70,
                "supervise_event": last.get("event")}
    guards = snap.get("guards") or {}
    rate = guards.get("nonfinite_rate")
    if rate is not None and rate > max_nonfinite_rate:
        return {"kind": "nonfinite_rate", "nonfinite_rate": float(rate),
                "skipped_steps": guards.get("skipped_steps")}
    return None


def detect_cohort_shrink(snap: Dict) -> Optional[Dict]:
    """Fewer hosts writing telemetry than the run's recorded cohort spec
    — a process died without its supervisor noticing (the others block in
    collectives at the next exchange). Remediation: publish the shrunken
    cohort through the env-file and elastically relaunch at W' = live."""
    static = snap.get("static") or {}
    want = static.get("num_processes")
    have = snap.get("num_hosts")
    try:
        want = int(want) if want is not None else None
    except (TypeError, ValueError):
        want = None
    if want and have and int(have) < want:
        return {"kind": "cohort_shrink", "live_hosts": int(have),
                "spec_processes": want}
    return None


def detect_excise(snap: Dict) -> Optional[Dict]:
    """A worker was SIGKILLed by the supervisor's hang-escalation tier
    (``hang_kill`` event, or the quarantine it left behind) — the
    survivors are already taking the exit-76 path. Remediation:
    ``excise`` — publish the order + shrunk cohort spec so the whole
    fleet's record of the surgery is explicit and audited
    (:mod:`dgc_tpu_torch.resilience.surgery`)."""
    last = snap.get("last_supervise") or {}
    hang = last.get("event") == "hang_kill" or (
        last.get("event") == "quarantined"
        and str(last.get("reason", "")).startswith("hang:"))
    if not hang:
        return None
    ev: Dict = {"kind": "hang", "reason": last.get("reason")}
    cohort = last.get("cohort") or {}
    try:
        ev["worker"] = int(cohort.get("JAX_PROCESS_ID"))
    except (TypeError, ValueError):
        pass
    # FROM-world: the spec the hung child LAUNCHED under (the event's
    # cohort stamp) — by audit time the survivors' supervisors have
    # already shrunk the live env-file, and deriving from that would
    # shrink the cohort twice
    try:
        ev["world"] = int(cohort.get("JAX_NUM_PROCESSES"))
    except (TypeError, ValueError):
        plane_cohort = snap.get("cohort") or {}
        if plane_cohort.get("spec_world"):
            ev["world"] = int(plane_cohort["spec_world"])
    return ev


def detect_readmit(snap: Dict) -> Optional[Dict]:
    """A quarantined worker passed its re-init probe and the device-pool
    ledger holds freed capacity (``snap["cohort"]`` is the control
    plane's injected ledger view). Remediation: ``readmit`` — publish
    the grown cohort spec and relaunch the worker; the elastic 1:k
    split reshard deals it back into the error-feedback state."""
    cohort = snap.get("cohort") or {}
    probe = cohort.get("probe") or {}
    if not probe.get("passed") or not cohort.get("pool_free"):
        return None
    ev: Dict = {"kind": "readmit", "pool_free": int(cohort["pool_free"]),
                "probe_rc": probe.get("rc")}
    if probe.get("checksum"):
        ev["checksum"] = probe["checksum"]
    if cohort.get("spec_world"):
        ev["target_world"] = int(cohort["spec_world"]) + 1
    return ev


def detect_stale_replica(snap: Dict) -> Optional[Dict]:
    """A serving replica is unhealthy or past the stream's pinned
    ``max_lag`` bound (the monitor's serving lane,
    :func:`dgc_tpu_torch.telemetry.fleet.serving_summary`) — it is serving a
    model the trainer has moved past, or it hit a gap/divergence the
    in-place delta path cannot repair. Remediation: ``resync`` — ask the
    exporter to rebase so the replica reloads a fresh full snapshot."""
    serving = snap.get("serving") or {}
    stale = serving.get("stale_replicas") or []
    if not stale:
        return None
    head = serving.get("head") or {}
    ev: Dict = {"kind": "stale_replica", "replicas": list(stale),
                "head": f"v{head.get('base_version')}:"
                        f"{head.get('latest_seq')}",
                "max_lag": head.get("max_lag")}
    recs = serving.get("replicas") or {}
    healths = {n: recs[n].get("health") for n in stale if n in recs}
    if healths:
        ev["health"] = healths
    if "max_staleness" in serving:
        ev["max_staleness"] = serving["max_staleness"]
    return ev


def detect_autoscale(snap: Dict, max_straggler_share: float = 1.5) \
        -> Optional[Dict]:
    """A healthy run with headroom (the gang scheduler's injected
    ``snap["sched"]`` view shows ``slots < slots_max``) that is making
    throughput (the summary's rate lane) and is NOT straggler-bound —
    giving a straggler-limited cohort another worker just adds another
    waiter. Remediation: ``admit`` a one-seat grow request; the
    scheduler grants it when slots free (preempting a lower-priority
    gang if the priority gap says so)."""
    sched = snap.get("sched") or {}
    slots = sched.get("slots")
    slots_max = sched.get("slots_max")
    try:
        slots, slots_max = int(slots), int(slots_max)
    except (TypeError, ValueError):
        return None
    if slots < 1 or slots >= slots_max:
        return None
    rate = snap.get("steps_per_s")
    try:
        rate = float(rate)
    except (TypeError, ValueError):
        return None
    if not math.isfinite(rate) or rate <= 0:
        return None    # no throughput signal: don't scale blind
    s = snap.get("summary") or {}
    share = s.get("straggler_share")
    if share is not None and math.isfinite(float(share)) \
            and float(share) >= max_straggler_share:
        return None    # straggler-bound: a new seat would just wait too
    return {"kind": "autoscale", "slots": slots, "slots_max": slots_max,
            "target_slots": slots + 1, "rate": rate}


def default_rules() -> Tuple[Rule, ...]:
    """The shipped remediation table. Order matters: quarantine outranks everything — a numerically dead
    run must never be "fixed" by a restart rule on the same tick."""
    return (
        Rule("nonfinite-quarantine", detect_quarantine, "quarantine",
             min_hits=1, debounce_s=0.0, budget=1),
        Rule("desync-restart", detect_desync, "restart",
             min_hits=2, debounce_s=60.0, budget=2),
        Rule("straggler-relaunch", detect_straggler, "elastic_relaunch",
             min_hits=3, debounce_s=120.0, budget=1),
        Rule("cohort-shrink-relaunch", detect_cohort_shrink,
             "elastic_relaunch", min_hits=2, debounce_s=120.0, budget=2),
        Rule("hang-excise", detect_excise, "excise",
             min_hits=1, debounce_s=60.0, budget=2),
        Rule("probe-readmit", detect_readmit, "readmit",
             min_hits=1, debounce_s=60.0, budget=2),
        Rule("stale-replica-resync", detect_stale_replica, "resync",
             min_hits=2, debounce_s=30.0, budget=4),
        Rule("autoscale-admit", detect_autoscale, "admit",
             min_hits=3, debounce_s=300.0, budget=2),
    )


#: detector names usable from a ``rules.toml`` rule table
DETECTORS: Dict[str, Callable[[Dict], Optional[Dict]]] = {
    "desync": detect_desync,
    "straggler": detect_straggler,
    "quarantine": detect_quarantine,
    "cohort_shrink": detect_cohort_shrink,
    "excise": detect_excise,
    "readmit": detect_readmit,
    "stale_replica": detect_stale_replica,
    "autoscale": detect_autoscale,
}

#: the Rule fields a ``rules.toml`` table may set
_RULE_KEYS = {"name", "detector", "action", "min_hits", "debounce_s",
              "budget"}


def _toml_scalar(raw: str, path: str, lineno: int):
    """One TOML scalar: quoted string, int, or float."""
    if len(raw) >= 2 and raw[0] == raw[-1] and raw[0] in "\"'":
        return raw[1:-1]
    for conv in (int, float):
        try:
            return conv(raw)
        except ValueError:
            pass
    raise ValueError(
        f"{path}:{lineno}: unsupported TOML value {raw!r} (the rule-table "
        "subset takes quoted strings, ints, and floats)")


def load_rules(path: str) -> Tuple[Rule, ...]:
    """Rule table from a ``rules.toml`` file — ``[[rule]]`` array-of-
    tables, one per row, e.g.::

        [[rule]]
        name = "straggler-adapt"
        detector = "straggler"     # a DETECTORS name
        action = "adapt"           # a registry.CONTROL_ACTIONS name
        min_hits = 3
        debounce_s = 120.0
        budget = 1

    Validated loudly: unknown detectors, actions, or keys raise — a
    typo'd table silently reverting to defaults would make the operator's
    intent a no-op. (The reference's hand-rolled subset parser —
    ``[[rule]]`` headers and scalar ``key = value`` lines — rather than
    ``tomllib``, so both packages accept and refuse the same tables.)"""
    from dgc_tpu_torch.telemetry import registry
    tables: list = []
    current: Optional[Dict] = None
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if line == "[[rule]]":
                current = {}
                tables.append(current)
                continue
            if line.startswith("["):
                raise ValueError(
                    f"{path}:{lineno}: only [[rule]] tables are "
                    f"supported, got {line!r}")
            if current is None:
                raise ValueError(
                    f"{path}:{lineno}: key outside a [[rule]] table")
            key, sep, raw = (p.strip() for p in line.partition("="))
            if not sep or not key:
                raise ValueError(
                    f"{path}:{lineno}: expected key = value, got {line!r}")
            if raw[:1] not in "\"'" and "#" in raw:
                raw = raw.split("#", 1)[0].strip()
            current[key] = _toml_scalar(raw, path, lineno)
    if not tables:
        raise ValueError(f"{path}: no [[rule]] tables")
    rules = []
    for i, t in enumerate(tables, 1):
        missing = [k for k in ("name", "detector", "action") if k not in t]
        if missing:
            raise ValueError(f"{path}: rule #{i} missing keys {missing}")
        unknown = sorted(set(t) - _RULE_KEYS)
        if unknown:
            raise ValueError(
                f"{path}: rule {t['name']!r} has unknown keys {unknown} "
                f"(known: {sorted(_RULE_KEYS)})")
        det = t["detector"]
        if det not in DETECTORS:
            raise ValueError(
                f"{path}: rule {t['name']!r}: unknown detector {det!r} "
                f"(known: {sorted(DETECTORS)})")
        if t["action"] not in registry.control_action_names():
            raise ValueError(
                f"{path}: rule {t['name']!r}: unknown action "
                f"{t['action']!r} "
                f"(known: {list(registry.control_action_names())})")
        rules.append(Rule(
            name=str(t["name"]), detect=DETECTORS[det],
            action=str(t["action"]),
            min_hits=int(t.get("min_hits", 2)),
            debounce_s=float(t.get("debounce_s", 60.0)),
            budget=int(t.get("budget", 2))))
    names = [r.name for r in rules]
    if len(set(names)) != len(names):
        raise ValueError(f"{path}: duplicate rule names in {names}")
    return tuple(rules)


class RuleEngine:
    """Stateful evaluator: consecutive-hit counting, debounce, budget."""

    def __init__(self, rules: Optional[Tuple[Rule, ...]] = None):
        self.rules = tuple(default_rules() if rules is None else rules)
        self._hits: Dict[Tuple[str, str], int] = {}
        self._fired_t: Dict[Tuple[str, str], float] = {}
        self._fired_n: Dict[Tuple[str, str], int] = {}
        #: (run, rule) -> count of firings suppressed by debounce/budget
        self.suppressed: Dict[Tuple[str, str], int] = {}

    def evaluate(self, run: str, snap: Dict, now: float):
        """One tick for one run: returns ``[(rule, evidence), ...]`` for
        every rule that fires now. Evidence is the detector's dict plus
        ``hits`` (consecutive detecting ticks) and ``firing`` (1-based
        count against the budget)."""
        fired = []
        for rule in self.rules:
            key = (run, rule.name)
            try:
                evidence = rule.detect(snap)
            except Exception:
                evidence = None     # a detector crash is not evidence
            if not evidence:
                self._hits[key] = 0
                continue
            self._hits[key] = self._hits.get(key, 0) + 1
            if self._hits[key] < rule.min_hits:
                continue
            last = self._fired_t.get(key)
            if ((last is not None and now - last < rule.debounce_s)
                    or self._fired_n.get(key, 0) >= rule.budget):
                self.suppressed[key] = self.suppressed.get(key, 0) + 1
                continue
            self._fired_t[key] = now
            self._fired_n[key] = self._fired_n.get(key, 0) + 1
            fired.append((rule, dict(evidence, hits=self._hits[key],
                                     firing=self._fired_n[key])))
        return fired
