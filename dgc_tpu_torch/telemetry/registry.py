"""Declarative metric schema shared by taps, sinks, and readers.

A copy of ``dgc_tpu/telemetry/registry.py`` (JAX-free there too) without
its ``*_out_specs`` helpers, which are ``shard_map`` out-specs. One source
of truth: the taps (:mod:`dgc_tpu_torch.telemetry.taps`, the
engine's ``exchange(..., telemetry=True)``) emit exactly the
``STEP_METRICS`` names, the sink writes them under the versioned ``SCHEMA``
header, and the regression gate (:mod:`dgc_tpu_torch.telemetry.regress`)
compares the ``RUN_METRICS`` summary keys by their declared ``better``
direction. Readers that see an unknown schema version fail loudly instead
of misparsing. The ``CONTROL_ACTIONS`` and ``SERVING_METRICS`` tables are
kept so the schema stays one with the JAX package's, though the port has
neither a control plane nor a serving stream yet.
"""

from typing import Dict, NamedTuple, Optional, Tuple

__all__ = [
    "SCHEMA", "SCHEMA_VERSION", "MetricSpec", "STEP_METRICS", "RUN_METRICS",
    "GUARD_METRICS", "FLEET_METRICS", "CONTROL_ACTIONS", "SERVING_METRICS",
    "step_stat_names", "guard_stat_names", "fleet_stat_names",
    "control_action_names", "serving_stat_names", "spec_by_name",
    "make_header",
    "validate_step_stats", "validate_guard_stats", "validate_fleet_stats",
    "validate_control_action", "validate_replica_status",
]

#: schema family tag written into every sink header
SCHEMA = "dgc-telemetry"
#: bump on any incompatible change to STEP_METRICS/record layout
SCHEMA_VERSION = 1


class MetricSpec(NamedTuple):
    """One metric column.

    ``kind`` — "scalar" (one f32 per step), "per_bucket" (one value per
    size bucket of the flat engine, variable length across engine rebuilds),
    or "per_worker" (one value per mesh worker, length = world size).
    ``better`` — regression direction for the gate: "lower", "higher", or
    "" for purely informational columns the gate never compares.
    """
    name: str
    kind: str
    description: str
    better: str = ""


#: per-step stats emitted by the taps (the engine and the train step).
STEP_METRICS: Tuple[MetricSpec, ...] = (
    MetricSpec("grad_norm", "scalar",
               "L2 norm of the local flat gradient entering the exchange"),
    MetricSpec("momentum_norm", "scalar",
               "L2 norm of the DGC momentum buffers (compressed + dense)"),
    MetricSpec("residual_norm", "scalar",
               "L2 norm of the untransmitted error-feedback residual after "
               "this step's selection"),
    MetricSpec("residual_mass", "scalar",
               "L1 mass (sum |v|) of the untransmitted error-feedback "
               "residual — the additive per-worker quantity the elastic "
               "reshard conserves, and the fleet desync detector's signal"),
    MetricSpec("clip_delta", "scalar",
               "relative gradient-norm reduction from clipping this step "
               "(0 when clipping is off or did not bind)"),
    MetricSpec("payload_elems", "scalar",
               "real (non-sentinel) transmitted elements this step, per "
               "worker", better="lower"),
    MetricSpec("wire_bytes", "scalar",
               "per-worker sparse wire bytes per step (values + indices + "
               "scales; 0 on the dense path)", better="lower"),
    MetricSpec("selected_frac", "per_bucket",
               "real selected elements / bucket numel — should track the "
               "configured compress ratio"),
    MetricSpec("threshold", "per_bucket",
               "effective top-k threshold: min |transmitted value| over the "
               "bucket's real payload slots"),
)

#: guard counters emitted by the guarded step (dgc_tpu.resilience.guard)
#: under the record key "guards". ADDITIVE to schema version 1: records
#: carry these keys only when guards are on, and readers are key-generic
#: (unknown record keys pass through), so no version bump — the header
#: lists them under "guard_metrics" when present.
GUARD_METRICS: Tuple[MetricSpec, ...] = (
    MetricSpec("skipped_steps", "scalar",
               "cumulative guard-skipped update count (nonfinite grads/"
               "loss or loss-spike breaker)", better="lower"),
    MetricSpec("nonfinite_rate", "scalar",
               "fraction of guarded steps where any worker saw a "
               "nonfinite gradient or loss", better="lower"),
    MetricSpec("checksum_failures", "scalar",
               "cumulative payload-checksum mismatches across the sparse "
               "exchange (0 when the checksum is off)", better="lower"),
)

#: cross-worker dispersion stats emitted by the fleet taps
#: (dgc_tpu_torch.telemetry.fleet) under the record key "fleet".
#: ADDITIVE to schema version 1, same doctrine as GUARD_METRICS: records
#: carry these keys only when fleet taps are on, readers are key-generic,
#: and the header lists them under "fleet_metrics" when present. The
#: per_worker columns come out of ONE packed all_gather that *replaces*
#: the telemetry pmean (means are computed locally from the gathered
#: matrix), so the fleet build costs at most one extra collective over
#: the plain step (chip_smoke.py counts them on the card).
FLEET_METRICS: Tuple[MetricSpec, ...] = (
    MetricSpec("w_clock", "per_worker",
               "host-stamped dispatch interval per worker (ms since that "
               "process dispatched its previous step) — the step-time "
               "proxy; comparable across hosts without clock sync"),
    MetricSpec("w_grad_norm", "per_worker",
               "per-worker L2 norm of the local flat gradient"),
    MetricSpec("w_residual_mass", "per_worker",
               "per-worker L1 mass of the error-feedback residual"),
    MetricSpec("w_sent_ratio", "per_worker",
               "per-worker transmitted elements / total model elements "
               "(the sent-bits ratio)"),
    MetricSpec("w_eff_ratio", "per_worker",
               "per-worker effective send fraction from the straggler-"
               "adaptive policy (resilience.adaptive) — 1.0 when the "
               "policy is off or disengaged, < 1 for a degraded worker"),
    MetricSpec("w_staleness", "per_worker",
               "per-worker gossip age in exchange rounds: how long since "
               "that worker's sparse mass last reached the replicated "
               "params (compression.gossip) — 0 when gossip is off or "
               "after every full-sync round"),
    MetricSpec("straggler", "scalar",
               "argmax worker index of w_clock this step (the worker the "
               "cohort waited on)"),
    MetricSpec("straggler_gap", "scalar",
               "max - min of w_clock (ms): how far the slowest worker "
               "trails the fastest", better="lower"),
    MetricSpec("worker_skew", "scalar",
               "max over the monitored dimensions of the relative cohort "
               "dispersion (max - min) / max(|mean|, eps)", better="lower"),
    MetricSpec("adaptive_engaged", "scalar",
               "1.0 when the straggler-adaptive policy degraded at least "
               "one worker's send fraction this step (min w_eff_ratio < "
               "1), else 0.0", better="lower"),
    MetricSpec("max_staleness_seen", "scalar",
               "max of w_staleness across the cohort this step: the "
               "stalest any worker's view got; bounded by the plan's "
               "gossip max_staleness by construction", better="lower"),
    MetricSpec("gossip_forced_syncs", "scalar",
               "cumulative staleness-breach-forced full-sync rounds "
               "(scheduled syncs excluded) — a rising count means the "
               "gossip schedule is being overridden, e.g. by a dropped "
               "link", better="lower"),
)

#: remediations the control plane (dgc_tpu.control) may take on a
#: supervised run. Declared here so the audit trail is schema-checked like
#: every other record stream: each fired rule appends one ``control_action``
#: event (see ``validate_control_action``) to the fleet event stream, and the
#: action name must be one of these specs. ``better`` reads as "fewer is
#: healthier" — a fleet firing many actions is a fleet in trouble.
CONTROL_ACTIONS: Tuple[MetricSpec, ...] = (
    MetricSpec("restart", "action",
               "SIGTERM the run's child so it emergency-saves and exits 75, "
               "then relaunch it with the same cohort spec — the desync "
               "remediation", better="lower"),
    MetricSpec("elastic_relaunch", "action",
               "publish an updated cohort spec through the supervisor's "
               "--env-file, then restart so the relaunch restores elastically "
               "(W -> W' reshard) under the new cohort — the straggler / "
               "cohort-shrink remediation", better="lower"),
    MetricSpec("quarantine", "action",
               "stop relaunching the run but keep its artifacts (telemetry, "
               "flight.json, checkpoints) for post-mortem — the "
               "nonfinite-streak / flight-dump remediation", better="lower"),
    MetricSpec("adapt", "action",
               "publish DGC_ADAPTIVE=1 through the supervisor's --env-file "
               "and restart so the relaunch runs with the straggler-"
               "adaptive exchange engaged (resilience.adaptive) — the "
               "persistent-straggler soft remediation", better="lower"),
    MetricSpec("excise", "action",
               "cut one worker out of the cohort: publish the excise order "
               "(resilience.surgery) so the step-boundary agreement spreads "
               "the verdict, publish the shrunk cohort spec, and let the "
               "survivors take the exit-76 / elastic-reshard relaunch — the "
               "hang / per-worker-fault hard remediation", better="lower"),
    MetricSpec("readmit", "action",
               "deal a probe-passed quarantined worker back in: publish the "
               "grown cohort spec and relaunch it; the elastic 1:k split "
               "reshard re-seats the error-feedback state — frees the "
               "device-pool ledger's quarantine slot", better="lower"),
    MetricSpec("resync", "action",
               "ask the serving exporter to rebase: publish resync.json in "
               "the stream's serving dir so the next publish writes a fresh "
               "full base snapshot and replicas reload from it — the "
               "stale/gapped/divergent-replica remediation "
               "(dgc_tpu.serving)", better="lower"),
    MetricSpec("admit", "action",
               "accept a queued RunSpec (or a running run's grow request) "
               "into the gang scheduler's queue (control.scheduler) — the "
               "entry transition of the slot ledger; recorded so queue "
               "residency is attributable end to end", better="lower"),
    MetricSpec("grant", "action",
               "assign freed device-pool slots to the queued run the "
               "priority/health ranking puts first and launch (or grow) it "
               "under the granted cohort spec — the scheduler's normal "
               "dequeue transition", better="lower"),
    MetricSpec("preempt_to_grant", "action",
               "shrink a lower-priority run via the cohort-surgery excise "
               "path (atomic order file, exit 76, elastic merge conserves "
               "its error-feedback mass) to free slots for a higher-"
               "priority queued run — the scheduler's starvation "
               "remediation", better="lower"),
    MetricSpec("grow", "action",
               "complete a granted elastic grow: publish the grown cohort "
               "spec, boot the new seat's supervisor, and restart the "
               "cohort so the 1:k split reshard deals the error-feedback "
               "state onto the new worker", better="lower"),
)

#: per-replica serving-stream health (dgc_tpu.serving). Each
#: ``Replica.poll()`` yields one ``replica_status`` record; the fleet
#: monitor scrapes the latest per replica into ``{replica=…}``-labeled
#: gauges, and the control plane's ``stale_replica -> resync`` rule reads
#: them. ADDITIVE, same doctrine as GUARD_METRICS/FLEET_METRICS.
SERVING_METRICS: Tuple[MetricSpec, ...] = (
    MetricSpec("staleness", "scalar",
               "delta updates behind the stream head: latest_seq - "
               "delta_seq (-1 before the first base load); the pinned "
               "bound is the manifest's max_lag", better="lower"),
    MetricSpec("base_version", "scalar",
               "full base snapshot generation the replica serves from"),
    MetricSpec("delta_seq", "scalar",
               "last delta sequence applied on the current base"),
    MetricSpec("applied_deltas", "scalar",
               "cumulative delta artifacts applied in place"),
    MetricSpec("resyncs", "scalar",
               "cumulative full-snapshot reloads (base changes after the "
               "first)", better="lower"),
    MetricSpec("gaps", "scalar",
               "cumulative missing-artifact gaps detected below the "
               "stream head", better="lower"),
    MetricSpec("healthy", "scalar",
               "1.0 when the replica's health is 'ok', else 0.0 (init/"
               "no_manifest/no_base/gap/stale/divergent)", better="higher"),
)

#: run-level summary keys the regression gate compares (step time and
#: overhead come from bench records; wire volume from either source).
RUN_METRICS: Tuple[MetricSpec, ...] = (
    MetricSpec("step_time_ms", "scalar",
               "median full train-step wall clock", better="lower"),
    MetricSpec("overhead_ms", "scalar",
               "paired DGC-minus-dense per-step overhead", better="lower"),
    MetricSpec("overhead_ms_megakernel", "scalar",
               "paired megakernel-minus-plain per-step delta from the "
               "DGC_MEGAKERNEL_AB=1 bench arm (negative = the two-"
               "megakernel hot path is faster); regress-gated so the "
               "fused path may only get cheaper", better="lower"),
    MetricSpec("exchange_ms", "scalar",
               "modeled sparse exchange time on the reference fabric",
               better="lower"),
    MetricSpec("wire_bytes", "scalar",
               "per-worker sparse wire bytes per step", better="lower"),
    MetricSpec("payload_elems", "scalar",
               "per-worker transmitted elements per step", better="lower"),
    MetricSpec("ici_ratio", "scalar",
               "modeled dense/DGC exchange-time ratio on the v5e-8 ICI "
               "fabric (bench.py ici_v5e8.ratio)", better="higher"),
    MetricSpec("ici_planned_ratio", "scalar",
               "dense/planned exchange-time ratio on the v5e-8 ICI fabric "
               "under the exchange planner (bench.py "
               "planned.ici_v5e8.ratio) — the never-lose gate: the "
               "planner must keep this >= ~1.0", better="higher"),
    MetricSpec("eth_planned_ratio", "scalar",
               "dense/planned exchange-time ratio on the 32x25GbE "
               "reference fabric under the exchange planner (bench.py "
               "planned.32x25GbE.ratio) — the win-by-more gate: the "
               "low-bit codec menu must not regress it", better="higher"),
    MetricSpec("worker_skew", "scalar",
               "median per-step relative cross-worker dispersion from the "
               "fleet taps (bench.py fleet.worker_skew)", better="lower"),
    MetricSpec("straggler_gap", "scalar",
               "median per-step max-min dispatch-interval gap across "
               "workers, ms (bench.py fleet.straggler_gap)", better="lower"),
    MetricSpec("straggler_stall_ms", "scalar",
               "median per-step stall the cohort spends waiting on its "
               "slowest worker: max(w_clock) - median(w_clock), ms "
               "(bench.py fleet.straggler_stall_ms) — the quantity the "
               "adaptive exchange exists to shrink", better="lower"),
    MetricSpec("wire_bytes_per_update", "scalar",
               "serving delta-stream artifact bytes per published update "
               "(scales + packed int4 values + Elias-Fano index words) at "
               "the serving ratio on the ResNet-20 config (bench.py "
               "serving.wire_bytes_per_update) — vs full_checkpoint_bytes "
               "shipping", better="lower"),
    MetricSpec("alias_coverage", "scalar",
               "donated-param fraction of the state leaves in the compiled "
               "step's input_output_alias header (dgcver donation pass, "
               "runs/analysis_report.json) — dropping below baseline means "
               "a state buffer stopped being donated", better="higher"),
    MetricSpec("peak_live_bytes", "scalar",
               "peak simultaneously-live bytes over the traced step by "
               "jaxpr liveness (dgcver donation pass, "
               "runs/analysis_report.json) — a static proxy for step HBM "
               "high-water", better="lower"),
    MetricSpec("grant_latency_s", "scalar",
               "median admit-to-grant latency over the gang scheduler's "
               "grant ledger (control.scheduler) — how long queued work "
               "waits for slots", better="lower"),
    MetricSpec("sched_queue_depth", "scalar",
               "gang-scheduler queue depth at collection time (pending "
               "admissions not yet granted)", better="lower"),
    MetricSpec("max_staleness_seen", "scalar",
               "max gossip staleness any worker's view reached over the "
               "run (bench.py gossip.max_staleness_seen) — must stay "
               "within the plan's max_staleness bound", better="lower"),
    MetricSpec("gossip_forced_syncs", "scalar",
               "staleness-breach-forced full-sync rounds over the run "
               "(bench.py gossip.forced_syncs) — scheduled syncs "
               "excluded", better="lower"),
)


def step_stat_names() -> Tuple[str, ...]:
    return tuple(s.name for s in STEP_METRICS)


def guard_stat_names() -> Tuple[str, ...]:
    return tuple(s.name for s in GUARD_METRICS)


def fleet_stat_names() -> Tuple[str, ...]:
    return tuple(s.name for s in FLEET_METRICS)


def control_action_names() -> Tuple[str, ...]:
    return tuple(s.name for s in CONTROL_ACTIONS)


def serving_stat_names() -> Tuple[str, ...]:
    return tuple(s.name for s in SERVING_METRICS)


def spec_by_name() -> Dict[str, MetricSpec]:
    seen: Dict[str, MetricSpec] = {}
    for s in STEP_METRICS + GUARD_METRICS + FLEET_METRICS + RUN_METRICS:
        seen.setdefault(s.name, s)
    return seen


def validate_step_stats(stats: Dict) -> None:
    """Fail loudly when a tap emits a dict that drifts from the schema."""
    got, want = set(stats), set(step_stat_names())
    if got != want:
        raise ValueError(
            f"telemetry step stats drifted from the registry schema: "
            f"missing={sorted(want - got)} extra={sorted(got - want)}")


def validate_guard_stats(stats: Dict) -> None:
    """Same drift check for the guard-metrics dict."""
    got, want = set(stats), set(guard_stat_names())
    if got != want:
        raise ValueError(
            f"guard stats drifted from the registry schema: "
            f"missing={sorted(want - got)} extra={sorted(got - want)}")


def validate_fleet_stats(stats: Dict) -> None:
    """Same drift check for the fleet-dispersion dict."""
    got, want = set(stats), set(fleet_stat_names())
    if got != want:
        raise ValueError(
            f"fleet stats drifted from the registry schema: "
            f"missing={sorted(want - got)} extra={sorted(got - want)}")


def validate_control_action(record: Dict) -> None:
    """Schema check for one ``control_action`` audit event before it hits
    the fleet event stream. Every action must be attributable: which run,
    which rule, which remediation, and the evidence that triggered it."""
    if record.get("event") != "control_action":
        raise ValueError(
            f"control_action record has event={record.get('event')!r}")
    missing = [k for k in ("run", "run_id", "rule", "action", "evidence", "t")
               if k not in record]
    if missing:
        raise ValueError(
            f"control_action record missing keys: {missing}")
    if record["action"] not in control_action_names():
        raise ValueError(
            f"unknown control action {record['action']!r} "
            f"(known: {list(control_action_names())})")
    if not isinstance(record["evidence"], dict) or not record["evidence"]:
        raise ValueError("control_action evidence must be a non-empty dict")


def validate_replica_status(record: Dict) -> None:
    """Schema check for one serving ``replica_status`` record before the
    fleet monitor trusts it: who is reporting, where it stands in the
    stream, and a health verdict."""
    if record.get("event") != "replica_status":
        raise ValueError(
            f"replica_status record has event={record.get('event')!r}")
    missing = [k for k in ("replica", "base_version", "delta_seq",
                           "latest_seq", "staleness", "max_lag", "health",
                           "t") if k not in record]
    if missing:
        raise ValueError(f"replica_status record missing keys: {missing}")
    if not str(record["replica"]):
        raise ValueError("replica_status needs a non-empty replica name")


def make_header(static: Optional[Dict] = None,
                guards: bool = False, fleet: bool = False) -> Dict:
    """Versioned JSONL header row (first line of every sink file).
    ``guards=True`` / ``fleet=True`` additionally list the guard / fleet
    columns the records will carry — additive keys, readers of version 1
    ignore them safely."""
    header = {
        "schema": SCHEMA,
        "version": SCHEMA_VERSION,
        "metrics": [s._asdict() for s in STEP_METRICS],
        "static": dict(static or {}),
    }
    if guards:
        header["guard_metrics"] = [s._asdict() for s in GUARD_METRICS]
    if fleet:
        header["fleet_metrics"] = [s._asdict() for s in FLEET_METRICS]
    return header
