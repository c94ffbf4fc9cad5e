"""Fleet control plane CLI (counterpart of ``dgc_tpu/control/__main__.py``,
with its spec format).

    python -m dgc_tpu_torch.control fleet.json [--interval 5] \
        [--max-ticks N] [--rules rules.toml]

``fleet.json``::

    {
      "fleet_root": "/runs/fleet",
      "runs": [
        {"name": "exp-a",
         "cmd": ["python", "-m", "dgc_tpu_torch.train", "--config", "..."],
         "run_dir": "/runs/fleet/exp-a",
         "env_file": "/runs/fleet/exp-a/cohort.env",
         "env": {"JAX_NUM_PROCESSES": "2"}},
        ...
      ]
    }

Per-run keys mirror :class:`dgc_tpu_torch.control.plane.RunSpec`;
``run_dir`` defaults to ``<fleet_root>/<name>`` and ``env_file`` to
``<run_dir>/cohort.env`` so the elastic-relaunch remediation always has
a publish target. ``run_dir`` must be the directory the trainer saves
under (its ``checkpoints/`` and ``telemetry/``), or the progress watch,
the heartbeat and the monitor see nothing. The remediation table
defaults to the built-in :func:`dgc_tpu_torch.control.rules.default_rules`;
a ``rules.toml`` next to the fleet spec (or ``--rules``) replaces it
declaratively (:func:`dgc_tpu_torch.control.rules.load_rules`). Exit
code is 0 when every run ends successfully, 1 otherwise. Watch the fleet
live with::

    python -m dgc_tpu_torch.telemetry.monitor <fleet_root> --fleet
"""

import argparse
import json
import os
import sys

from dgc_tpu_torch.control.plane import ControlPlane, RunSpec


def load_fleet(path):
    """fleet.json -> (fleet_root, [RunSpec])."""
    with open(path) as f:
        spec = json.load(f)
    if not isinstance(spec, dict) or not spec.get("runs"):
        raise ValueError(f"{path}: expected an object with a 'runs' list")
    fleet_root = os.path.abspath(
        spec.get("fleet_root") or os.path.dirname(os.path.abspath(path)))
    specs = []
    for r in spec["runs"]:
        name, cmd = r.get("name"), r.get("cmd")
        if not name or not cmd:
            raise ValueError(f"{path}: every run needs 'name' and 'cmd'")
        run_dir = os.path.abspath(r.get("run_dir")
                                  or os.path.join(fleet_root, name))
        specs.append(RunSpec(
            name=name, cmd=list(cmd), run_dir=run_dir,
            watch=r.get("watch"),
            env_file=r.get("env_file") or os.path.join(run_dir, "cohort.env"),
            env=r.get("env"),
            retries=int(r.get("retries", 5)),
            backoff=float(r.get("backoff", 5.0)),
            backoff_max=float(r.get("backoff_max", 300.0)),
            success_codes=tuple(r.get("success_codes", (0,)))))
    return fleet_root, specs


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m dgc_tpu_torch.control",
        description="supervise a fleet of training runs with "
                    "alert-driven remediation")
    ap.add_argument("fleet", help="fleet spec JSON (see module docstring)")
    ap.add_argument("--interval", type=float, default=5.0,
                    help="seconds between control ticks")
    ap.add_argument("--max-ticks", type=int, default=None,
                    help="stop the fleet after N control ticks (smoke runs)")
    ap.add_argument("--rules", default=None,
                    help="rule-table TOML (default: rules.toml beside the "
                         "fleet spec when present, else the built-in "
                         "table)")
    args = ap.parse_args(argv)
    fleet_root, specs = load_fleet(args.fleet)
    rules = None
    rules_path = args.rules or os.path.join(
        os.path.dirname(os.path.abspath(args.fleet)), "rules.toml")
    if args.rules or os.path.exists(rules_path):
        from dgc_tpu_torch.control.rules import load_rules
        rules = load_rules(rules_path)
        print(f"[control] rule table from {rules_path}: "
              f"{[r.name for r in rules]}", flush=True)
    plane = ControlPlane(specs, fleet_root, rules=rules,
                         interval=args.interval)
    final = plane.run(max_ticks=args.max_ticks)
    bad = {n: v for n, v in final.items() if v["rc"] not in (0, None)}
    print(f"[control] fleet done: {len(final) - len(bad)}/{len(final)} runs "
          f"clean, {len(plane.actions)} control actions", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
