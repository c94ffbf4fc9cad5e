"""Remediations the rule engine can execute on a supervised run
(counterpart of ``dgc_tpu/control/actions.py``).

Each action takes the run's
:class:`~dgc_tpu_torch.control.supervisor.Supervisor`
plus the triggering evidence and returns a result dict that rides the
``control_action`` audit event — every mutation the control plane makes
to the world (a SIGTERM, a cohort-spec publish, a quarantine flag) is
recorded next to the evidence that justified it.

The elastic relaunch goes through the elastic restart end to end: the
new cohort spec is *published* into the supervisor's ``--env-file`` (the same
mechanism a human cluster operator uses), the child is SIGTERMed into its
emergency-save / exit-75 path, and the relaunch re-reads the env-file,
re-forms the cohort at W', and restores with ``--elastic`` resharding.
"""

import os
from typing import Dict, Optional

from dgc_tpu_torch.control.supervisor import Supervisor, parse_env_file

__all__ = ["publish_env", "default_cohort_planner", "act_restart",
           "act_elastic_relaunch", "act_quarantine", "act_adapt",
           "act_excise", "act_readmit", "act_resync", "act_admit",
           "act_grant", "act_preempt_to_grant", "act_grow", "ACTIONS",
           "execute"]


def publish_env(path: str, updates: Dict[str, str]) -> Dict[str, str]:
    """Merge ``updates`` into the KEY=VALUE env-file at ``path`` and
    rewrite it atomically (the supervisor re-reads it before every
    launch; it must never see a torn file — a truncated
    ``JAX_NUM_PROCESSES=32`` still PARSES as 3, so writer atomicity is
    the only defense). Returns the merged spec."""
    # lazy import: the serving package's classes pull the codecs and the
    # kernels; the control package imports none of them
    from dgc_tpu_torch.serving import protocol as _sproto
    merged = parse_env_file(path)
    merged.update({k: str(v) for k, v in updates.items()})
    lines = ["# published by dgc_tpu_torch.control"]
    lines += [f"{k}={merged[k]}" for k in sorted(merged)]
    _sproto.write_text_atomic(path, "\n".join(lines) + "\n",
                              prefix=".cohort.", suffix=".env")
    return merged


def default_cohort_planner(snap: Dict, evidence: Dict) -> Dict[str, str]:
    """Propose the cohort-spec update for an elastic relaunch.

    * cohort shrink — the spec chases reality: W' = live host count.
    * straggler — drop one process (the slowest host leaves; the elastic
      reshard redistributes its residual mass at restore).
    * anything else, or an unshrinkable single-process run — no update;
      the action degrades to a plain restart and says so in the audit.
    """
    static = snap.get("static") or {}
    try:
        procs = int(static.get("num_processes") or 1)
    except (TypeError, ValueError):
        procs = 1
    kind = evidence.get("kind")
    if kind == "cohort_shrink":
        return {"JAX_NUM_PROCESSES": str(int(evidence["live_hosts"]))}
    if kind == "straggler" and procs > 1:
        return {"JAX_NUM_PROCESSES": str(procs - 1)}
    if kind in ("hang", "desync", "flight_dump") and "worker" in evidence:
        # excise: survivors-only world — prefer the evidence's recorded
        # FROM-world (the plane's env-spec view) over stale telemetry
        base = int(evidence.get("world") or procs)
        if base > 1:
            return {"JAX_NUM_PROCESSES": str(base - 1)}
    if kind == "readmit":
        tw = evidence.get("target_world")
        return {"JAX_NUM_PROCESSES": str(int(tw))} if tw \
            else {"JAX_NUM_PROCESSES": str(procs + 1)}
    return {}


def act_restart(sup: Supervisor, evidence: Dict, **_kw) -> Dict:
    """SIGTERM → emergency save → exit 75 → relaunch, same cohort."""
    delivered = sup.request_restart(reason=evidence.get("kind"))
    return {"delivered": delivered}


def act_elastic_relaunch(sup: Supervisor, evidence: Dict,
                         env_updates: Optional[Dict[str, str]] = None,
                         **_kw) -> Dict:
    """Publish a new cohort spec through the env-file, then restart so
    the relaunch restores elastically under it."""
    result: Dict = {}
    updates = dict(env_updates or {})
    if updates and sup.env_file:
        merged = publish_env(sup.env_file, updates)
        result.update(env_file=sup.env_file, published=updates,
                      cohort_spec={k: merged[k] for k in sorted(merged)})
    else:
        # no spec to publish (single process, or no env-file wired):
        # still restart, but the audit must not claim a reshape happened
        result.update(published={}, degraded_to="restart")
    result["delivered"] = sup.request_restart(reason=evidence.get("kind"))
    return result


def act_quarantine(sup: Supervisor, evidence: Dict, **_kw) -> Dict:
    """Stop relaunching; keep telemetry/flight/checkpoint artifacts."""
    already = sup.quarantined is not None
    sup.quarantine(evidence.get("kind", "quarantine"))
    return {"quarantined": sup.quarantined, "already": already}


def act_adapt(sup: Supervisor, evidence: Dict, **_kw) -> Dict:
    """Publish ``DGC_ADAPTIVE=1`` through the env-file, then restart so
    the relaunch runs with the straggler-adaptive exchange engaged (the
    trainer's CLI reads the env var;
    :mod:`dgc_tpu_torch.resilience.adaptive`) — the *soft* straggler
    remediation: the cohort keeps every worker but stops paying the
    laggard's full lag. Contrast ``elastic_relaunch``, which evicts the
    worker outright."""
    result: Dict = {}
    if sup.env_file:
        merged = publish_env(sup.env_file, {"DGC_ADAPTIVE": "1"})
        result.update(env_file=sup.env_file,
                      published={"DGC_ADAPTIVE": "1"},
                      cohort_spec={k: merged[k] for k in sorted(merged)})
    else:
        # no env-file wired: still restart, but the audit must not claim
        # the adaptive flag was delivered
        result.update(published={}, degraded_to="restart")
    result["delivered"] = sup.request_restart(reason=evidence.get("kind"))
    return result


def act_excise(sup: Supervisor, evidence: Dict,
               env_updates: Optional[Dict[str, str]] = None,
               order_path: Optional[str] = None, **_kw) -> Dict:
    """Cut ONE worker out of the cohort
    (:mod:`dgc_tpu_torch.resilience.surgery`): publish the excise order next to the run's checkpoints —
    the workers fold it into the step-boundary agreement lane and take
    the exit-76 path — and publish the shrunk cohort spec the survivors
    relaunch under. For a ``hang`` verdict the target is already
    SIGKILLed; its supervisor is quarantined so the corpse is held for
    the readmit probe instead of relaunching into a dead slot."""
    from dgc_tpu_torch.resilience import surgery as _surgery
    result: Dict = {}
    verdict = evidence.get("kind", "manual")
    if verdict not in _surgery.VERDICTS or verdict == "none":
        verdict = "manual"
    target = evidence.get("worker")
    if order_path is None and sup.watch:
        order_path = os.path.join(sup.watch, _surgery.ORDER_FILE)
    if order_path and target is not None:
        _surgery.publish_order(order_path, verdict, int(target),
                               extra={"rule_fired": evidence.get("hits")})
        result["order"] = {"path": order_path, "verdict": verdict,
                           "target": int(target)}
    updates = dict(env_updates or {})
    if updates and sup.env_file:
        merged = publish_env(sup.env_file, updates)
        result.update(env_file=sup.env_file, published=updates,
                      cohort_spec={k: merged[k] for k in sorted(merged)})
    else:
        result["published"] = {}
    if verdict == "hang":
        already = sup.quarantined is not None
        sup.quarantine(f"excised:{verdict}")
        result.update(quarantined=sup.quarantined, already=already)
    return result


def act_readmit(sup: Supervisor, evidence: Dict,
                env_updates: Optional[Dict[str, str]] = None,
                relauncher=None, cohort_restart=None, **_kw) -> Dict:
    """Deal a probe-passed quarantined worker back in: publish the grown
    cohort spec, relaunch the worker under a fresh supervisor
    (``relauncher`` — plane-provided), and restart the running cohort so
    the grown spec takes effect at the next restart boundary
    (``cohort_restart``). The elastic 1:k split reshard re-seats the
    error-feedback state across the grown world at restore. Any stale
    excise order / exit record is cleared first — the grown cohort must
    not relaunch into last surgery's verdict."""
    from dgc_tpu_torch.resilience import surgery as _surgery
    result: Dict = {}
    if sup.watch:
        _surgery.clear_order(os.path.join(sup.watch, _surgery.ORDER_FILE))
        _surgery.clear_order(os.path.join(sup.watch,
                                          _surgery.EXIT_RECORD))
    updates = dict(env_updates or {})
    if updates and sup.env_file:
        merged = publish_env(sup.env_file, updates)
        result.update(env_file=sup.env_file, published=updates,
                      cohort_spec={k: merged[k] for k in sorted(merged)})
    else:
        result["published"] = {}
    if relauncher is not None:
        result["relaunched"] = bool(relauncher())
    if cohort_restart is not None:
        result["cohort_restarted"] = list(cohort_restart())
    return result


def act_resync(sup: Optional[Supervisor], evidence: Dict,
               serving_dir: Optional[str] = None, **_kw) -> Dict:
    """Ask the run's serving exporter to rebase (dgc_tpu_torch.serving): write
    the atomic ``resync.json`` request into the stream's serving dir —
    the exporter consumes it at its next publish, writes a fresh full
    base snapshot as version+1, and every replica reloads from it. Works
    without a live Supervisor (the serving population is files, not a
    child process); when none is passed the serving dir must be."""
    from dgc_tpu_torch.serving import protocol as _sproto
    if serving_dir is None and sup is not None and sup.watch:
        # the conventional layout: the stream lives beside the run the
        # supervisor watches (<run>/serving)
        cand = os.path.join(os.path.dirname(os.path.abspath(sup.watch)),
                            "serving")
        if os.path.isfile(os.path.join(cand, _sproto.MANIFEST)):
            serving_dir = cand
    if serving_dir is None:
        return {"requested": False, "error": "no serving dir resolvable"}
    req = _sproto.request_resync(
        serving_dir, evidence.get("kind", "stale_replica"),
        replicas=evidence.get("replicas"),
        fired_by="control_plane", hits=evidence.get("hits"))
    return {"requested": True, "serving_dir": serving_dir,
            "request": req}


def act_admit(sup: Optional[Supervisor], evidence: Dict,
              enqueue=None, **_kw) -> Dict:
    """Accept work into the gang scheduler's queue (control.scheduler):
    a whole queued gang, or — when fired by the autoscale rule — one
    extra seat for a healthy running gang. ``enqueue`` is plane-provided
    (it closes over the scheduler and the gang identity); the action
    itself is the audit point. Works without a live Supervisor — the
    queued gang has no child yet."""
    if enqueue is None:
        return {"admitted": False, "error": "no scheduler wired"}
    rec = enqueue()
    out: Dict = {"admitted": not (rec or {}).get("duplicate", False)}
    if isinstance(rec, dict):
        out.update({k: rec[k] for k in ("kind", "slots", "priority",
                                        "queue_depth", "duplicate")
                    if k in rec})
    return out


def act_grant(sup: Optional[Supervisor], evidence: Dict,
              launcher=None, **_kw) -> Dict:
    """Assign granted slots: boot the queued gang's supervisors (or the
    grow seat) under the granted cohort spec. ``launcher`` is
    plane-provided; the grant decision's wait accounting rides the
    evidence so queue latency is attributable per grant."""
    if launcher is None:
        return {"launched": [], "error": "no launcher wired"}
    return {"launched": list(launcher())}


def act_preempt_to_grant(sup: Supervisor, evidence: Dict,
                         env_updates: Optional[Dict[str, str]] = None,
                         order_paths=None, **_kw) -> Dict:
    """Shrink a lower-priority running gang to free slots for a starved
    higher-priority admission: publish the excise order (verdict
    ``preempt`` is not a surgery verdict, so it degrades to ``manual``)
    into EVERY victim member's watch dir — the members fold it at their
    next step boundary and take the exit-76 path — and publish the
    shrunk cohort spec the survivors relaunch under. The elastic merge
    at their restore conserves the excised seat's error-feedback mass;
    the freed slot grants at the scheduler's next tick."""
    from dgc_tpu_torch.resilience import surgery as _surgery
    result: Dict = {}
    target = evidence.get("worker")
    paths = list(order_paths or [])
    if not paths and sup is not None and sup.watch:
        paths = [os.path.join(sup.watch, _surgery.ORDER_FILE)]
    if target is not None:
        published_orders = []
        for path in paths:
            _surgery.publish_order(
                path, "manual", int(target),
                extra={"rule_fired": evidence.get("hits"),
                       "beneficiary": evidence.get("beneficiary")})
            published_orders.append(path)
        result["order"] = {"paths": published_orders, "verdict": "manual",
                           "target": int(target)}
    updates = dict(env_updates or {})
    if updates and sup is not None and sup.env_file:
        merged = publish_env(sup.env_file, updates)
        result.update(env_file=sup.env_file, published=updates,
                      cohort_spec={k: merged[k] for k in sorted(merged)})
    else:
        result["published"] = {}
    return result


def act_grow(sup: Supervisor, evidence: Dict,
             env_updates: Optional[Dict[str, str]] = None,
             relauncher=None, cohort_restart=None, **_kw) -> Dict:
    """Complete a granted elastic grow: clear any stale surgery order /
    exit record (the grown cohort must not relaunch into last
    preemption's verdict), publish the grown cohort spec, boot the new
    seat's supervisor (``relauncher``), and restart the running members
    (``cohort_restart``) so the 1:k split reshard deals the
    error-feedback state onto the new worker at the next restore."""
    from dgc_tpu_torch.resilience import surgery as _surgery
    result: Dict = {}
    if sup is not None and sup.watch:
        _surgery.clear_order(os.path.join(sup.watch, _surgery.ORDER_FILE))
        _surgery.clear_order(os.path.join(sup.watch,
                                          _surgery.EXIT_RECORD))
    updates = dict(env_updates or {})
    if updates and sup is not None and sup.env_file:
        merged = publish_env(sup.env_file, updates)
        result.update(env_file=sup.env_file, published=updates,
                      cohort_spec={k: merged[k] for k in sorted(merged)})
    else:
        result["published"] = {}
    if relauncher is not None:
        result["launched"] = list(relauncher())
    if cohort_restart is not None:
        result["cohort_restarted"] = list(cohort_restart())
    return result


#: action name (registry.CONTROL_ACTIONS) -> implementation
ACTIONS = {
    "restart": act_restart,
    "elastic_relaunch": act_elastic_relaunch,
    "quarantine": act_quarantine,
    "adapt": act_adapt,
    "excise": act_excise,
    "readmit": act_readmit,
    "resync": act_resync,
    "admit": act_admit,
    "grant": act_grant,
    "preempt_to_grant": act_preempt_to_grant,
    "grow": act_grow,
}


def execute(action: str, sup: Supervisor, evidence: Dict, **kw) -> Dict:
    """Dispatch one remediation; unknown names raise (the registry and
    this table must agree — checked in tests)."""
    return ACTIONS[action](sup, evidence, **kw)
