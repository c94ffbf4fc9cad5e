"""Fleet control plane: multi-run supervision, cross-run aggregation
hooks, and alert-driven remediation (counterpart of
``dgc_tpu/control``).

Host-only by construction: the plane starts, watches and signals its
trainer children, which own the card; nothing here initialises CUDA,
builds or launches a kernel, or enters the step. The pieces:

* :mod:`dgc_tpu_torch.control.supervisor` — the launch/backoff/progress-
  watch loop, and its single-run CLI (``python -m
  dgc_tpu_torch.control.supervisor``).
* :mod:`dgc_tpu_torch.control.plane` — ``ControlPlane`` owning N
  supervisors on threads, a fleet-wide JSONL event stream, and the tick
  loop that feeds monitor snapshots to the rule engine.
* :mod:`dgc_tpu_torch.control.rules` — declarative detector → remediation
  table with per-(run, rule) hit counting, debounce, and action budgets.
* :mod:`dgc_tpu_torch.control.actions` — the remediations themselves
  (restart, elastic relaunch via the ``--env-file`` cohort republish,
  quarantine, the cohort-surgery pair excise / readmit, and the gang
  scheduler's admit / grant / preempt-to-grant / grow).
* :mod:`dgc_tpu_torch.control.scheduler` — the gang scheduler's slot
  ledger, admission queue and grant policy.

``python -m dgc_tpu_torch.control fleet.json`` runs a fleet from a spec
file. The exports load on first use, so the trainer's
:func:`resolve_run_id` import pulls in nothing else.
"""

import importlib
import os

__all__ = ["COHORT_KEYS", "ControlPlane", "DevicePool", "Rule",
           "RuleEngine", "RunSpec", "Supervisor", "checkpoint_progress",
           "default_events_path", "default_rules", "parse_env_file",
           "resolve_run_id"]

_LAZY = {"ControlPlane": "plane", "DevicePool": "plane", "RunSpec": "plane",
         "Rule": "rules", "RuleEngine": "rules", "default_rules": "rules",
         "COHORT_KEYS": "supervisor", "Supervisor": "supervisor",
         "checkpoint_progress": "supervisor",
         "default_events_path": "supervisor",
         "parse_env_file": "supervisor"}


def __getattr__(name):
    if name in _LAZY:
        mod = importlib.import_module(f"{__name__}.{_LAZY[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def resolve_run_id(default=None):
    """The supervisor-assigned run id for this process, if any.

    A ``Supervisor`` exports its ``run_id`` to every child as
    ``DGC_RUN_ID``; the trainer stamps it into the telemetry header and
    the flight recorder's static so the monitor can label every gauge
    with the same ``run`` the supervise event stream carries.
    Unsupervised runs get ``default`` (the monitor then falls back to the
    run dir name).
    """
    return os.environ.get("DGC_RUN_ID") or default
