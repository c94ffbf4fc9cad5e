"""The port's gang scheduler (``dgc_tpu_torch.control.scheduler``) against
the JAX package's (``dgc_tpu.control.scheduler``): the same admit /
cancel / shrunk / grown / exiting / completed / tick scripts on a fake
clock give the same decisions, the same views, the same grant-ledger
records and the same queue snapshot — priorities, FIFO by admission time
and sequence, the parked never-grantable gang, no backfill past a starved
head, the victim pick, and a sequence number that resumes across
restarts; the tolerant readers agree on torn and absent files. Then the
plane's gang drills on fake members: the grant, queue and complete cycle
(``true``-like commands), and the priority-inversion drill
(``tests/torch_sched_worker.py``: a low-priority 2-seat gang shrinks
through the surgery excise path so a high-priority gang can grow, with
the excised seat's residual mass conserved; the high-priority gang runs
until its grow has landed, whatever the host's speed)."""

import json
import os
import sys

import numpy as np
import pytest

from dgc_tpu.control import scheduler as jsched
from dgc_tpu_torch.control import rules, scheduler
from dgc_tpu_torch.control.plane import ControlPlane, RunSpec
from dgc_tpu_torch.control.rules import Rule
from dgc_tpu_torch.control.scheduler import (GangScheduler, SCHED_GRANTS,
                                             SCHED_QUEUE,
                                             grant_latency_summary,
                                             read_grant_ledger, read_queue)
from dgc_tpu_torch.control.supervisor import parse_env_file
from dgc_tpu_torch.resilience import surgery
from dgc_tpu_torch.telemetry import monitor, registry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_sched_worker.py")


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def _play(mod, script, root=None, total=4, t0=100.0):
    """Run ``script`` on ``mod.GangScheduler``: every call's result, the
    final snapshot, and (with ``root``) the ledger and queue files."""
    clk = FakeClock(t0)
    s = mod.GangScheduler(total, root=root, clock=clk)
    out = []
    for op, *args in script:
        if op == "clock":
            clk.t += args[0]
            continue
        if op == "restart":
            s.close()
            clk = FakeClock(args[0])
            s = mod.GangScheduler(total, root=root, clock=clk)
            continue
        kw = args.pop() if args and isinstance(args[-1], dict) else {}
        try:
            out.append((op, getattr(s, op)(*args, **kw)))
        except ValueError as e:
            out.append((op, "ValueError", str(e)))
    out.append(("snapshot", s.snapshot()))
    s.close()
    if root is not None:
        out.append(("ledger", mod.read_grant_ledger(root)))
        out.append(("queue", mod.read_queue(root)))
    return out


#: one script through every mutator (the parity test's main case)
_FULL = [
    ("admit", "a", 2, {"priority": 1}), ("clock", 1.0),
    ("admit", "b", 1, {"priority": 0}), ("clock", 1.0),
    ("admit", "whale", 9, {"priority": 7}), ("tick",), ("pending",),
    ("admit", "c", 2, {"priority": 3}), ("admit", "c", 2, {"priority": 3}),
    ("admit", "c", 1, {"kind": "grow"}), ("cancel", "c", {"kind": "grow"}),
    ("clock", 0.5), ("tick",), ("tick",), ("shrunk", "a"), ("tick",),
    ("grown", "b", {"by": 1}), ("mark_exiting", "b"), ("mark_exiting", "b"),
    ("admit", "d", 1, {"priority": 2}), ("clock", 2.0), ("tick",),
    ("completed", "b"), ("clock", 1.0), ("tick",), ("holding", "c"),
    ("holding", "zz"), ("cancel", "nobody"), ("shrunk", "nobody"),
    ("admit", "e", 1, {"kind": "resize"}), ("completed", "c"),
    ("completed", "a"), ("tick",), ("pending",),
    ("restart", 500.0), ("admit", "f", 1), ("tick",),
]

#: the reference's unit scenarios (tests/test_scheduler.py), as scripts
_SCENARIOS = {
    "priority_then_fifo": (4, [
        ("admit", "a", 1, {"priority": 0}), ("clock", 1.0),
        ("admit", "b", 1, {"priority": 0}), ("clock", 1.0),
        ("admit", "c", 1, {"priority": 5}), ("tick",)]),
    "same_instant_seq": (2, [
        ("admit", "x", 1, {"priority": 1, "now": 100.0}),
        ("admit", "y", 1, {"priority": 1, "now": 100.0}), ("tick",)]),
    "parked_whale": (3, [
        ("admit", "whale", 5, {"priority": 9}), ("tick",), ("pending",),
        ("tick",), ("tick",), ("admit", "minnow", 1, {"priority": 0}),
        ("tick",)]),
    "no_backfill": (3, [
        ("admit", "big", 2, {"priority": 5}), ("clock", 1.0),
        ("admit", "small", 1, {"priority": 0}), ("tick",), ("clock", 1.0),
        ("admit", "urgent", 2, {"priority": 5}), ("tick",), ("clock", 1.0),
        ("admit", "sneak", 1, {"priority": 0}), ("tick",), ("pending",)]),
    "duplicate_and_cancel": (2, [
        ("admit", "g", 1), ("admit", "g", 1), ("admit", "g", 1,
                                               {"kind": "grow"}),
        ("cancel", "g", {"kind": "grow"}), ("cancel", "g"), ("cancel", "g"),
        ("pending",), ("admit", "g", 1, {"kind": "resize"})]),
    "victim_lowest_priority": (5, [
        ("admit", "low", 2, {"priority": 0}),
        ("admit", "mid", 2, {"priority": 1}),
        ("admit", "hi", 1, {"priority": 3}), ("tick",), ("clock", 1.0),
        ("admit", "urgent", 1, {"priority": 9}), ("tick",), ("tick",),
        ("shrunk", "low"), ("tick",), ("holding", "low")]),
    "victim_skips_exiting": (4, [
        ("admit", "low", 2, {"priority": 0}),
        ("admit", "mid", 2, {"priority": 1}), ("tick",),
        ("mark_exiting", "low"), ("clock", 1.0),
        ("admit", "urgent", 1, {"priority": 9}), ("tick",), ("tick",)]),
    "victim_strictly_lower": (2, [
        ("admit", "peer", 2, {"priority": 3}), ("tick",), ("clock", 1.0),
        ("admit", "rival", 1, {"priority": 3}), ("tick",), ("clock", 1.0),
        ("admit", "boss", 1, {"priority": 4}), ("tick",)]),
}


def test_scheduler_script_matches_jax(tmp_path):
    got = _play(scheduler, _FULL, str(tmp_path / "port"))
    want = _play(jsched, _FULL, str(tmp_path / "ref"))
    assert got == want
    ledger, skipped = got[-2][1]
    assert skipped == 0
    seqs = [r["seq"] for r in ledger]
    assert seqs == sorted(set(seqs))           # monotone across restart
    for r in ledger:
        assert r["held"] + r["free"] == r["total"] == 4, r
    events = [r["event"] for r in ledger]
    for e in ("admit", "cancel", "unschedulable", "grant", "preempt",
              "shrunk", "grown", "exiting", "completed"):
        assert e in events, e
    assert grant_latency_summary(ledger) == \
        jsched.grant_latency_summary(ledger)


@pytest.mark.parametrize("case", sorted(_SCENARIOS))
def test_scheduler_scenario_matches_jax(case):
    total, script = _SCENARIOS[case]
    got = _play(scheduler, script, total=total)
    assert got == _play(jsched, script, total=total)
    ticks = [r for op, *r in got if op == "tick"]
    granted = [d["name"] for (ds,) in ticks for d in ds
               if d["decision"] == "grant"]
    if case == "priority_then_fifo":
        assert granted == ["c", "a", "b"]
    elif case == "parked_whale":
        assert granted == ["minnow"]
        assert got[-1][1]["unschedulable"] == ["whale"]
    elif case == "no_backfill":
        assert granted == ["big", "small"]
    elif case == "victim_lowest_priority":
        (pre,) = [d for (ds,) in ticks for d in ds
                  if d["decision"] == "preempt_to_grant"]
        assert pre["victim"] == "low" and granted[-1] == "urgent"


def test_readers_match_jax_on_torn_and_absent_files(tmp_path):
    root = str(tmp_path)

    def both():
        got = (read_queue(root), read_grant_ledger(root))
        assert got == (jsched.read_queue(root),
                       jsched.read_grant_ledger(root))
        return got
    assert both() == (None, ([], 0))
    with open(os.path.join(root, SCHED_QUEUE), "w") as f:
        f.write('{"total": 3, "que')
    assert both()[0] is None
    with open(os.path.join(root, SCHED_QUEUE), "w") as f:
        json.dump(["not", "a", "snapshot"], f)
    assert both()[0] is None
    with open(os.path.join(root, SCHED_GRANTS), "w") as f:
        f.write('{"event": "grant", "seq": 1, "wait_s": 2.5}\n[1]\n\n')
        f.write('{"event": "grant", "seq": 2, "wait_s": 0.5}\n')
        f.write('{"event": "grant", "se')
    records, skipped = both()[1]
    assert len(records) == 2 and skipped == 2
    assert grant_latency_summary(records) == \
        jsched.grant_latency_summary(records) == \
        {"median_s": 1.5, "max_s": 2.5, "n": 2}
    assert grant_latency_summary([]) is None


# --------------------------------------------------------------------- #
# the plane's gang drills                                                #
# --------------------------------------------------------------------- #

def test_plane_gang_grant_queue_and_complete(tmp_path):
    root = str(tmp_path)

    def gang(name, n, secs=0.4):
        return [RunSpec(
            f"{name}{i}",
            [sys.executable, "-c", f"import time; time.sleep({secs})"],
            run_dir=os.path.join(root, f"{name}{i}"), backoff=0.1)
            for i in range(n)]

    sched = GangScheduler(2, root=root)
    plane = ControlPlane([], root, rules=(), interval=0.05,
                         scheduler=sched)
    with pytest.raises(ValueError):
        plane.submit("empty", [])
    plane.submit("alpha", gang("alpha", 2), priority=0)
    plane.submit("beta", gang("beta", 1, secs=0.2), priority=1)
    with pytest.raises(ValueError):
        plane.submit("alpha", gang("dup", 1))
    final = plane.run(max_ticks=400)
    for name in ("alpha0", "alpha1", "beta0"):
        assert final[name]["rc"] == 0 and final[name]["state"] == "done"
    chain = [(a["action"], a["run"]) for a in plane.actions]
    assert chain[:2] == [("admit", "alpha"), ("admit", "beta")]
    grants = [a for a in plane.actions if a["action"] == "grant"]
    assert [g["run"] for g in grants] == ["beta", "alpha"]
    assert set(grants[1]["result"]["launched"]) == {"alpha0", "alpha1"}
    for a in plane.actions:
        registry.validate_control_action(a)
    assert plane.pool.slots == {"alpha0": 1, "alpha1": 1, "beta0": 1}
    snap = sched.snapshot()
    assert snap["free"] == snap["total"] == 2 and snap["holdings"] == {}
    records, skipped = read_grant_ledger(root)
    assert skipped == 0
    events = [r["event"] for r in records]
    # a tick may land between alpha0's and alpha1's exits: alpha is then
    # marked exiting before it completes
    assert [e for e in events if e != "exiting"] == [
        "admit", "admit", "grant", "completed", "grant", "completed"]
    for r in records:
        assert r["held"] + r["free"] == r["total"] == 2
    # the monitor's SCHED lane reads the same files
    lane = monitor.collect_sched(root)
    assert lane["total"] == 2 and lane["free"] == 2
    assert lane["grant_latency"]["n"] == 2
    with pytest.raises(RuntimeError):
        ControlPlane([], str(tmp_path / "none"), rules=()).submit(
            "g", gang("g", 1))


def _member(root, gang, i, env_file, world, steps, priority=0,
            until_world=0):
    """A gang member of ``steps`` steps; with ``until_world``, one that
    steps on until its cohort has run 40 steps at that world (the grow
    landing), at most 4,000 steps."""
    run_dir = os.path.join(root, f"{gang}{i}")
    until = (["--until-world", str(until_world), "--world-steps", "40",
              "--max-steps", "4000"] if until_world else [])
    return RunSpec(
        f"{gang}{i}",
        [sys.executable, WORKER, run_dir,
         "--cohort", os.path.join(root, f"cohort_{gang}"),
         "--steps", str(steps), "--step-ms", "25", "--world", str(world)]
        + until,
        run_dir=run_dir, env_file=env_file,
        # a peer's first step waits on its start-up, which a loaded host
        # stretches for seconds: a boundary timeout past any start-up, so
        # only a real hang trips it (none in these drills; an excise
        # order reaches a member waiting at a boundary directly)
        env={"JAX_PROCESS_ID": str(i), "DGC_BOUNDARY_TIMEOUT": "60"},
        backoff=0.1, priority=priority)


def test_priority_inversion_drill(tmp_path):
    root = str(tmp_path)
    envs = {}
    for gang, world in (("low", 2), ("hi", 1), ("bat", 1)):
        envs[gang] = os.path.join(root, f"{gang}.env")
        with open(envs[gang], "w") as f:
            f.write(f"JAX_NUM_PROCESSES={world}\n")
    sched = GangScheduler(3, root=root)
    # the shipped autoscale detector, tuned tick-fast
    table = (Rule("autoscale-admit", rules.detect_autoscale, "admit",
                  min_hits=2, debounce_s=5.0, budget=1),)
    plane = ControlPlane([], root, rules=table, interval=0.25,
                         scheduler=sched)
    # hi trains until the autoscale admit, the preemption and the grow
    # have landed and its grown cohort has run, however loaded the host
    # is: its end waits on the grow, not on a step count
    plane.submit("low", [_member(root, "low", i, envs["low"], 2, 100)
                         for i in range(2)], priority=0)
    plane.submit(
        "hi", [_member(root, "hi", 0, envs["hi"], 2, 40, until_world=2)],
        priority=2, slots_max=2,
        grow_spec=lambda seat: _member(root, "hi", seat, envs["hi"], 2, 40,
                                       until_world=2))
    plane.submit("bat", [_member(root, "bat", 0, envs["bat"], 1, 10)],
                 priority=0)
    final = plane.run(max_ticks=800)

    for name in ("low0", "hi0", "hi1", "bat0"):
        assert final[name]["rc"] == 0, (name, final[name])
    assert final["low1"]["rc"] == surgery.EXIT_SURGERY
    assert final["low1"]["state"] == "quarantined"
    assert final["low1"]["quarantined"] == "excised:manual"
    assert parse_env_file(envs["low"]) == {"JAX_NUM_PROCESSES": "1"}
    assert parse_env_file(envs["hi"]) == {"JAX_NUM_PROCESSES": "2"}

    for a in plane.actions:
        registry.validate_control_action(a)
    chain = [(a["action"], a["run"]) for a in plane.actions]
    assert chain[:3] == [("admit", "low"), ("admit", "hi"),
                         ("admit", "bat")]
    grants = [a for a in plane.actions if a["action"] == "grant"]
    assert [g["run"] for g in grants] == ["hi", "low", "bat"]
    (scale,) = [a for a in plane.actions
                if a["action"] == "admit" and a["run"] == "hi0"]
    assert scale["rule"] == "autoscale-admit"
    assert scale["evidence"]["target_slots"] == 2
    assert scale["result"]["admitted"] is True
    (pre,) = [a for a in plane.actions if a["action"] == "preempt_to_grant"]
    assert pre["run"] == "low" and pre["evidence"]["beneficiary"] == "hi"
    assert pre["evidence"]["worker"] == 1 and pre["evidence"]["world"] == 2
    assert pre["result"]["published"] == {"JAX_NUM_PROCESSES": "1"}
    assert len(pre["result"]["order"]["paths"]) == 2   # every member
    (grow,) = [a for a in plane.actions if a["action"] == "grow"]
    assert grow["run"] == "hi" and grow["evidence"]["seat"] == 1
    assert grow["result"]["published"] == {"JAX_NUM_PROCESSES": "2"}
    assert grow["result"]["launched"] == ["hi1"]
    assert grow["result"]["cohort_restarted"] == ["hi0"]
    order = [a["action"] for a in plane.actions]
    assert order.index("preempt_to_grant") < order.index("grow")

    records, skipped = read_grant_ledger(root)
    assert skipped == 0
    for r in records:
        assert r["held"] + r["free"] == r["total"] == 3, r
    events = [(r["event"], r["name"]) for r in records]
    assert events.index(("preempt", "low")) \
        < events.index(("shrunk", "low")) \
        < [i for i, e in enumerate(events) if e == ("grant", "hi")][1]
    assert {r["name"] for r in records if r["event"] == "completed"} == {
        "low", "hi", "bat"}
    assert read_queue(root)["holdings"] == {}

    # the excised seat's residual survived the fold into seat 0
    for gang, seats in (("low", (0, 1)), ("hi", (0, 1)), ("bat", (0,))):
        recs = []
        for j in seats:
            with open(os.path.join(root, f"cohort_{gang}",
                                   f"res.{j}.json")) as f:
                recs.append(json.load(f))
        actual = float(np.sum(np.asarray([r["res"] for r in recs],
                                         dtype=np.float64)))
        oracle = float(np.sum(np.asarray([r["mass_in"] for r in recs],
                                         dtype=np.float64)))
        assert oracle > 0.0 and abs(actual - oracle) <= 1e-6, gang
    with open(os.path.join(root, "cohort_low", "res.1.json")) as f:
        orphan = json.load(f)
    assert orphan["final"] is True and orphan["folded_into"] == 0
    events = [json.loads(x) for x in open(
        os.path.join(root, "control_events.jsonl"))]
    freed = [e for e in events if e["event"] == "sched_slot_freed"]
    assert freed and freed[0]["run"] == "low" and freed[0]["seat"] == "low1"
