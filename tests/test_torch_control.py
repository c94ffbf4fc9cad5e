"""The port's control plane (``dgc_tpu_torch.control``) against the JAX
package's (``dgc_tpu.control``) on the same inputs: the eight detectors on
synthetic snapshots, the rule engine's firings and suppressions on a fake
clock, the rule tables (built-in and from a ``rules.toml``), the
supervisor's backoff draws, the env-file and fleet-spec readers and
writers, and the exit-76 bookkeeping. Then the drills on fake trainers
(``tests/control_worker.py``, millisecond steps): the multi-run drill
(straggler -> elastic relaunch, desync -> restart, a steady run
untouched), the nonfinite quarantine, the exit-70 supervisor and the
hang escalation; the trainer's two hooks (``DGC_RUN_ID`` and
``DGC_HEARTBEAT``) through an in-process ``train.main``; and the
``*_control`` recipes against ``configs/control.py``. Wall-clock fields
(``t``), pids and run ids are the only things a comparison strips."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from dgc_tpu.control import actions as jactions
from dgc_tpu.control import rules as jrules
from dgc_tpu.control import supervisor as jsup
from dgc_tpu.control.__main__ import load_fleet as jload_fleet
from dgc_tpu.telemetry import registry as jregistry
from dgc_tpu.utils.config import Config, configs
from dgc_tpu_torch import configs as tconfigs
from dgc_tpu_torch import control
from dgc_tpu_torch.control import actions, rules, supervisor
from dgc_tpu_torch.control.__main__ import load_fleet, main as control_main
from dgc_tpu_torch.control.plane import ControlPlane, RunSpec
from dgc_tpu_torch.control.rules import Rule
from dgc_tpu_torch.resilience import faults, surgery
from dgc_tpu_torch.resilience.preempt import Watchdog
from dgc_tpu_torch.telemetry import flight, monitor, registry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "control_worker.py")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread (the trainer-hook test trains on the CPU beside
    other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------- #
# detectors                                                              #
# --------------------------------------------------------------------- #

#: the reference's synthetic snapshots (tests/test_control.py), widened to
#: every detector's firing and quiet edges
SNAPSHOTS = [
    {},
    {"summary": {"desync_alerts": 4, "desync_workers": [2],
                 "desync_first": {"step": 30}}},
    {"summary": {"desync_alerts": 0, "desync_workers": [2]}},
    {"summary": {"straggler_share": 1.1, "straggler_gap": 80.0,
                 "straggler": 3}},
    {"summary": {"straggler_share": 8.0, "straggler_gap": 80.0,
                 "straggler": 3}},
    {"summary": {"straggler_share": 8.0, "straggler_gap": 5.0,
                 "straggler": 3}},
    {"summary": {"straggler_share": float("nan"), "straggler_gap": 80.0,
                 "straggler": 1}},
    {"flight": {"reason": "nonfinite-streak", "records": 16}},
    {"flight": {"reason": "nonfinite-streak x4", "t_dump": 5.0,
                "records": 4}},
    {"last_supervise": {"event": "quarantined", "rc": 70}},
    {"last_supervise": {"event": "relaunch", "rc": 70}},
    {"last_supervise": {"event": "done", "rc": 0}},
    {"guards": {"nonfinite_rate": 1.0, "skipped_steps": 3}},
    {"guards": {"nonfinite_rate": 0.0}},
    {"num_hosts": 1, "static": {"num_processes": 2}},
    {"num_hosts": 2, "static": {"num_processes": 2}},
    {"num_hosts": 1, "static": {"num_processes": "x"}},
    {"last_supervise": {"event": "hang_kill", "reason": "no heartbeat",
                        "cohort": {"JAX_PROCESS_ID": "1",
                                   "JAX_NUM_PROCESSES": "3"}}},
    {"last_supervise": {"event": "quarantined", "reason": "hang:stale",
                        "cohort": {}}, "cohort": {"spec_world": 4}},
    {"last_supervise": {"event": "quarantined", "reason": "exit:70"}},
    {"cohort": {"probe": {"passed": True, "rc": 0, "checksum": "ab"},
                "pool_free": 1, "spec_world": 2}},
    {"cohort": {"probe": {"passed": True, "rc": 0}, "pool_free": 0}},
    {"cohort": {"probe": {"passed": False}, "pool_free": 2}},
    {"serving": {"stale_replicas": ["r1"],
                 "head": {"base_version": 2, "latest_seq": 7, "max_lag": 4},
                 "replicas": {"r1": {"health": "stale"}},
                 "max_staleness": 6}},
    {"serving": {"stale_replicas": []}},
    {"sched": {"slots": 1, "slots_max": 2}, "steps_per_s": 3.5,
     "summary": {"straggler_share": 1.0}},
    {"sched": {"slots": 1, "slots_max": 2}, "steps_per_s": 3.5,
     "summary": {"straggler_share": 2.0}},
    {"sched": {"slots": 2, "slots_max": 2}, "steps_per_s": 3.5},
    {"sched": {"slots": 1, "slots_max": 2}},
    {"sched": {"slots": "a", "slots_max": 2}, "steps_per_s": 1.0},
]


@pytest.mark.parametrize("name", sorted(rules.DETECTORS))
def test_detector_matches_jax(name):
    assert sorted(rules.DETECTORS) == sorted(jrules.DETECTORS)
    port, ref = rules.DETECTORS[name], jrules.DETECTORS[name]
    fired = 0
    for snap in SNAPSHOTS:
        got = port(snap)
        assert got == ref(snap), (name, snap)
        fired += got is not None
    assert fired, f"{name} never fired on the snapshots"


@pytest.mark.parametrize("reason", ["preempt signal 15",
                                    "surgery: excise manual worker 0",
                                    "surgery: cohort lost"])
def test_relaunch_dumps_are_not_quarantine_evidence(reason):
    """The deliberate divergence: a dump the trainer writes on its way to
    a relaunch (exit 75 / 76) quarantines in the reference, not here; the
    exit-70 evidence behind it still does."""
    snap = {"flight": {"reason": reason, "records": 2}}
    assert jrules.detect_quarantine(snap)["kind"] == "flight_dump"
    assert rules.detect_quarantine(snap) is None
    snap["last_supervise"] = {"event": "quarantined", "rc": 70}
    assert rules.detect_quarantine(snap) == {
        "kind": "nonfinite_abort", "rc": 70, "supervise_event": "quarantined"}


# --------------------------------------------------------------------- #
# the rule engine and its tables                                         #
# --------------------------------------------------------------------- #

def _firings(mod, table, script):
    eng = mod.RuleEngine(table)
    out = []
    for now, run, snap in script:
        out.append([(r.name, ev) for r, ev in eng.evaluate(run, snap, now)])
    return out, dict(eng.suppressed)


def test_rule_engine_matches_jax_on_a_fake_clock():
    strag = SNAPSHOTS[4]
    desync = SNAPSHOTS[1]
    dump = SNAPSHOTS[8]
    both = {"summary": dict(strag["summary"], **desync["summary"])}
    seq = [strag, strag, {}, strag, strag, strag, both, both, both, dump,
           dump, desync, desync, desync, strag, {}]
    script = [(float(i * 20), run, snap) for i, snap in enumerate(seq)
              for run in ("a", "b")]
    script += [(400.0 + 70.0 * i, "a", both) for i in range(6)]
    got = _firings(rules, None, script)
    want = _firings(jrules, None, script)
    assert got == want
    assert any(got[0]) and got[1]          # fired and suppressed

    # the reference's own debounce / budget script, with a crashing rule
    def table(mod):
        return (mod.Rule("r", lambda s: ({"kind": "x"} if s.get("bad")
                                         else None),
                         "restart", min_hits=2, debounce_s=10.0, budget=2),
                mod.Rule("boom", lambda s: 1 / 0, "restart", min_hits=1))
    bad = {"bad": True}
    script = [(0.0, "a", bad), (1.0, "a", bad), (2.0, "a", bad),
              (12.0, "a", bad), (30.0, "a", bad), (0.0, "b", bad),
              (1.0, "b", {}), (2.0, "b", bad), (3.0, "b", bad)]
    got = _firings(rules, table(rules), script)
    assert got == _firings(jrules, table(jrules), script)
    assert got[1] == {("a", "r"): 2}


def _table(rs):
    return [(r.name, r.detect.__name__, r.action, r.min_hits, r.debounce_s,
             r.budget) for r in rs]


_GOOD_TOML = """# an operator's table
[[rule]]
name = "straggler-adapt"
detector = "straggler"
action = "adapt"
min_hits = 3               # consecutive ticks
debounce_s = 120.0
budget = 1

[[rule]]
name = 'nonfinite'
detector = "quarantine"
action = "quarantine"
debounce_s = 0
"""

_BAD_TOML = {
    "no_tables": "# nothing\n",
    "other_header": "[rule]\nname = 'x'\n",
    "outside": "name = 'x'\n",
    "no_equals": "[[rule]]\nname\n",
    "value": "[[rule]]\nname = [1]\n",
    # both parsers strip a comment only after an unquoted value
    "quoted_comment": "[[rule]]\nname = 'x'  # a comment\n",
    "missing": "[[rule]]\nname = 'x'\ndetector = 'desync'\n",
    "unknown_key": ("[[rule]]\nname = 'x'\ndetector = 'desync'\n"
                    "action = 'restart'\nweight = 2\n"),
    "unknown_detector": ("[[rule]]\nname = 'x'\ndetector = 'nope'\n"
                         "action = 'restart'\n"),
    "unknown_action": ("[[rule]]\nname = 'x'\ndetector = 'desync'\n"
                       "action = 'reboot'\n"),
    "duplicate": ("[[rule]]\nname = 'x'\ndetector = 'desync'\n"
                  "action = 'restart'\n[[rule]]\nname = 'x'\n"
                  "detector = 'straggler'\naction = 'restart'\n"),
}


def test_rule_tables_match_jax(tmp_path):
    assert _table(rules.default_rules()) == _table(jrules.default_rules())
    assert rules.default_rules()[0].name == "nonfinite-quarantine"
    path = tmp_path / "rules.toml"
    path.write_text(_GOOD_TOML)
    assert _table(rules.load_rules(str(path))) == \
        _table(jrules.load_rules(str(path))) == [
            ("straggler-adapt", "detect_straggler", "adapt", 3, 120.0, 1),
            ("nonfinite", "detect_quarantine", "quarantine", 2, 0.0, 2)]
    # every action of either table, and of the registry, dispatches
    names = registry.control_action_names()
    assert names == jregistry.control_action_names()
    assert set(actions.ACTIONS) == set(names) == set(jactions.ACTIONS)
    for r in rules.default_rules():
        assert r.action in names
    assert actions.execute("admit", None, {"kind": "x"}) == \
        jactions.execute("admit", None, {"kind": "x"}) == {
            "admitted": False, "error": "no scheduler wired"}
    with pytest.raises(KeyError):
        actions.execute("reboot", None, {})


@pytest.mark.parametrize("case", sorted(_BAD_TOML))
def test_bad_rule_tables_refused_as_jax(case, tmp_path):
    path = tmp_path / "rules.toml"
    path.write_text(_BAD_TOML[case])
    with pytest.raises(ValueError) as port:
        rules.load_rules(str(path))
    with pytest.raises(ValueError) as ref:
        jrules.load_rules(str(path))
    assert str(port.value) == str(ref.value)


# --------------------------------------------------------------------- #
# the supervisor's backoff, env files, fleet specs, exit-76 bookkeeping  #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("seed", range(20))
def test_backoff_draws_match_jax(seed):
    seqs = []
    for mod in (supervisor, jsup):
        for backoff, cap in ((2.0, 30.0), (5.0, 8.0), (10.0, 4.0)):
            sup = mod.Supervisor(["true"], backoff=backoff, backoff_max=cap)
            sup._rng.seed(seed)
            seqs.append([sup._next_delay(f)
                         for f in (1, 2, 3, 4, 5, 6, 1, 2, 3, 9, 10, 11)])
    assert seqs[:3] == seqs[3:]
    first = seqs[0]
    assert first[0] == first[6] == 2.0       # a fresh streak waits backoff
    assert all(2.0 <= d <= 30.0 for d in first)


def test_env_files_and_fleet_specs_match_jax(tmp_path):
    text = ("# seed\n\nJAX_NUM_PROCESSES=2\nnot a pair\n  JAX_COORDINATOR_"
            "ADDRESS = h0:1234  \nDGC_ADAPTIVE=\n")
    for d in ("port", "ref"):
        (tmp_path / d).mkdir()
        (tmp_path / d / "cohort.env").write_text(text)
    p, r = (str(tmp_path / d / "cohort.env") for d in ("port", "ref"))
    assert supervisor.parse_env_file(p) == jsup.parse_env_file(r)
    assert supervisor.parse_env_file(str(tmp_path / "gone")) == {}
    got = actions.publish_env(p, {"JAX_NUM_PROCESSES": 1, "NEW": "x"})
    assert got == jactions.publish_env(r, {"JAX_NUM_PROCESSES": 1,
                                           "NEW": "x"})
    assert got == {"JAX_NUM_PROCESSES": "1",
                   "JAX_COORDINATOR_ADDRESS": "h0:1234",
                   "DGC_ADAPTIVE": "", "NEW": "x"}
    assert supervisor.parse_env_file(p) == jsup.parse_env_file(r) == got
    assert os.listdir(tmp_path / "port") == ["cohort.env"]   # no temp litter

    fleet = {"fleet_root": str(tmp_path / "fleet"), "runs": [
        {"name": "a", "cmd": ["python", "x.py"]},
        {"name": "b", "cmd": ["python", "y.py"], "run_dir": "rel/b",
         "watch": "/w", "env_file": "/e.env", "env": {"K": "v"},
         "retries": 2, "backoff": 0.5, "backoff_max": 9,
         "success_codes": [0, 3]}]}
    path = tmp_path / "fleet.json"
    path.write_text(json.dumps(fleet))
    root, specs = load_fleet(str(path))
    jroot, jspecs = jload_fleet(str(path))
    assert root == jroot and [tuple(s) for s in specs] == \
        [tuple(s) for s in jspecs]
    assert specs[0].env_file == str(tmp_path / "fleet" / "a" / "cohort.env")
    path.write_text(json.dumps({"runs": [{"name": "a"}]}))
    for loader in (load_fleet, jload_fleet):
        with pytest.raises(ValueError, match="'name' and 'cmd'"):
            loader(str(path))


_EXIT_CASES = {
    "survivor_above": (4, 1, "3", {"JAX_NUM_PROCESSES": "3"}),
    "survivor_below": (4, 2, "0", {"JAX_NUM_PROCESSES": "3"}),
    "excised": (4, 2, "2", {"JAX_NUM_PROCESSES": "3"}),
    "unshrinkable": (1, 0, "0", None),
    "no_process_id": (3, 0, None, {"JAX_NUM_PROCESSES": "2"}),
}


@pytest.mark.parametrize("case", sorted(_EXIT_CASES))
def test_exit76_bookkeeping_matches_jax(case, tmp_path):
    world, target, pid, published = _EXIT_CASES[case]
    outs = []
    for mod, d in ((supervisor, "port"), (jsup, "ref")):
        watch = tmp_path / d / "checkpoints"
        watch.mkdir(parents=True)
        env_file = tmp_path / d / "cohort.env"
        env_file.write_text(f"JAX_NUM_PROCESSES={world}\nX=1\n")
        rec = {"verdict": "manual", "target": target, "lost": False,
               "world": world, "process_index": 0, "t": 12.5}
        (watch / surgery.EXIT_RECORD).write_text(json.dumps(rec))
        sup = mod.Supervisor(["true"], watch=str(watch),
                             env_file=str(env_file),
                             extra_env=({"JAX_PROCESS_ID": pid}
                                        if pid is not None else {}))
        first = sup._apply_surgery(76)
        again = sup._apply_surgery(76)          # one record, applied once
        outs.append((first, again, dict(sup.extra_env),
                     mod.parse_env_file(str(env_file))))
    assert outs[0] == outs[1]
    first, again, extra, cohort = outs[0]
    assert again == {} and first["target"] == target
    assert first.get("published") == published
    assert cohort["X"] == "1"
    if case == "excised":
        assert first["excised"] is True
    elif case == "survivor_above":
        assert extra["JAX_PROCESS_ID"] == "2" and first["process_id"] == 2


# --------------------------------------------------------------------- #
# supervisor drills                                                      #
# --------------------------------------------------------------------- #

def test_supervisor_quarantines_exit_70(tmp_path):
    events = tmp_path / "ev.jsonl"
    sup = supervisor.Supervisor(
        [sys.executable, "-c", "raise SystemExit(70)"], retries=5,
        backoff=0.05, events=str(events))
    assert sup.run(install_signals=False) == 70
    assert sup.launches == 1 and sup.state == "quarantined"
    assert sup.quarantined == "exit:70"
    recs = [json.loads(x) for x in events.read_text().splitlines()]
    assert [r["event"] for r in recs] == ["launch", "quarantined"]
    for r in recs:
        assert {"event", "t", "launches", "run_id", "cohort"} <= set(r)
    assert recs[0]["env_overrides"] == [] and recs[1]["rc"] == 70


def test_supervisor_cli(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "dgc_tpu_torch.control.supervisor", "--help"],
        capture_output=True, text=True, timeout=60, cwd=REPO)
    assert out.returncode == 0
    for flag in ("--retries", "--backoff", "--backoff-max", "--env-file",
                 "--watch", "--events-out", "--events", "--success-codes",
                 "--surgery-codes", "--hang-timeout", "--heartbeat"):
        assert flag in out.stdout, flag
    events = tmp_path / "run" / "supervise_events.jsonl"
    (tmp_path / "run").mkdir()
    rc = supervisor.main(["--retries", "1", "--backoff", "0.05", "--watch",
                          str(tmp_path / "run" / "checkpoints"), "--",
                          sys.executable, "-c",
                          "import os; print(os.environ['DGC_RUN_ID'])"])
    assert rc == 0
    recs = [json.loads(x) for x in events.read_text().splitlines()]
    assert [r["event"] for r in recs] == ["launch", "done"]
    assert recs[1]["rc"] == 0 and "elapsed" in recs[1]
    assert supervisor.default_events_path(None) is None


#: a trainer that writes its telemetry header and one heartbeat, then hangs
_HANG = """import json, os, sys, time
sys.path.insert(0, {repo!r})
from dgc_tpu.telemetry import registry
d = os.path.join({run!r}, "telemetry", "host0")
os.makedirs(d, exist_ok=True)
with open(os.path.join(d, "telemetry.jsonl"), "w") as f:
    f.write(json.dumps(registry.make_header(
        {{"run_id": os.environ["DGC_RUN_ID"]}})) + "\\n")
with open(os.environ["DGC_HEARTBEAT"], "w") as f:
    f.write(str(time.time()))
time.sleep(60)
"""


def test_hang_escalation_kills_and_excises(tmp_path):
    """A child that beats once and stops: its supervisor SIGKILLs it
    within the hang budget plus one poll and quarantines it; the plane's
    excise rule then publishes the order and the shrunk cohort."""
    root = str(tmp_path)
    run = os.path.join(root, "hung")
    spec = RunSpec("hung", [sys.executable, "-c",
                            _HANG.format(repo=REPO, run=run)],
                   run_dir=run, env_file=os.path.join(run, "cohort.env"),
                   env={"JAX_PROCESS_ID": "1", "JAX_NUM_PROCESSES": "2"},
                   hang_timeout=1.0, backoff=0.05)
    t0 = time.time()
    plane = ControlPlane([spec], root, interval=0.2)
    final = plane.run(max_ticks=100)
    assert time.time() - t0 < 20
    assert final["hung"]["state"] == "quarantined"
    assert final["hung"]["launches"] == 1 and final["hung"]["rc"] == -9
    assert final["hung"]["quarantined"].startswith("hang:no heartbeat")
    evs = [json.loads(x) for x in open(os.path.join(
        run, "supervise_events.jsonl"))]
    # the kill's event and the loop's quarantine race each other
    assert evs[0]["event"] == "launch"
    assert sorted(e["event"] for e in evs[1:]) == ["hang_kill",
                                                   "quarantined"]
    (kill,) = [e for e in evs if e["event"] == "hang_kill"]
    hb = os.path.getmtime(os.path.join(run, "heartbeat"))
    assert kill["t"] - hb <= 1.0 + 0.25 + 0.25     # budget + poll + slack
    (act,) = plane.actions
    assert act["rule"] == "hang-excise" and act["action"] == "excise"
    assert act["evidence"]["kind"] == "hang"
    assert act["evidence"]["worker"] == 1 and act["evidence"]["world"] == 2
    assert act["result"]["order"]["target"] == 1
    assert act["result"]["published"] == {"JAX_NUM_PROCESSES": "1"}
    assert act["run_id"] == final["hung"]["run_id"]
    order = surgery.read_order(act["result"]["order"]["path"])
    assert order["verdict"] == "hang" and order["target"] == 1


# --------------------------------------------------------------------- #
# the plane's drills                                                     #
# --------------------------------------------------------------------- #

def _worker_cmd(run_dir, steps, step_ms=20):
    return [sys.executable, WORKER, run_dir,
            "--steps", str(steps), "--step-ms", str(step_ms)]


def _drill_rules():
    # the shipped detectors and actions, tuned tick-fast (the shipped
    # debounce is minutes)
    return (
        Rule("nonfinite-quarantine", rules.detect_quarantine, "quarantine",
             min_hits=1, debounce_s=0.0, budget=1),
        Rule("desync-restart", rules.detect_desync, "restart",
             min_hits=2, debounce_s=5.0, budget=1),
        Rule("straggler-relaunch", rules.detect_straggler,
             "elastic_relaunch", min_hits=2, debounce_s=5.0, budget=1),
    )


def test_control_plane_multi_run_drill(tmp_path):
    root = str(tmp_path)
    specs = [
        RunSpec("slowpoke", _worker_cmd(os.path.join(root, "slowpoke"),
                                        steps=150),
                run_dir=os.path.join(root, "slowpoke"),
                env_file=os.path.join(root, "slowpoke", "cohort.env"),
                env={"DGC_FAULTS": "slow:ms=80", "JAX_NUM_PROCESSES": "2"},
                backoff=0.1),
        RunSpec("wobbly", _worker_cmd(os.path.join(root, "wobbly"),
                                      steps=150),
                run_dir=os.path.join(root, "wobbly"),
                env={"DGC_FAKE_DESYNC": "2"}, backoff=0.1),
        RunSpec("steady", _worker_cmd(os.path.join(root, "steady"),
                                      steps=40),
                run_dir=os.path.join(root, "steady"), backoff=0.1),
    ]
    plane = ControlPlane(specs, root, rules=_drill_rules(), interval=0.25)
    final = plane.run(max_ticks=400)
    for name in ("steady", "slowpoke", "wobbly"):
        assert final[name]["rc"] == 0, (name, final[name])
    by_run = {}
    for a in plane.actions:
        by_run.setdefault(a["run"], []).append(a)
    assert final["steady"]["launches"] == 1 and "steady" not in by_run

    (act,) = by_run["slowpoke"]
    assert act["action"] == "elastic_relaunch"
    ev = act["evidence"]
    assert ev["kind"] == "straggler" and ev["worker"] == 3
    assert ev["share"] >= 1.5 and ev["hits"] >= 2
    assert act["result"]["published"] == {"JAX_NUM_PROCESSES": "1"}
    assert act["result"]["delivered"] is True
    assert supervisor.parse_env_file(specs[0].env_file) == {
        "JAX_NUM_PROCESSES": "1"}
    assert final["slowpoke"]["launches"] == 2
    snap = monitor.collect(os.path.join(root, "slowpoke"))
    assert snap["static"]["num_processes"] == 1
    assert snap["run_label"] == final["slowpoke"]["run_id"]

    (act,) = by_run["wobbly"]
    assert act["action"] == "restart"
    assert act["evidence"]["kind"] == "desync"
    assert act["evidence"]["workers"] == [2]
    assert act["result"]["delivered"] is True
    assert final["wobbly"]["launches"] == 2

    events = [json.loads(x) for x in open(
        os.path.join(root, "control_events.jsonl"))]
    kinds = [e["event"] for e in events]
    assert kinds[0] == "plane_start" and kinds[-1] == "plane_stop"
    assert kinds.count("control_action") == len(plane.actions) == 2
    assert {e["run"] for e in events if e["event"] == "launch"} == {
        "slowpoke", "wobbly", "steady"}
    for e in events:
        if e["event"] == "control_action":
            registry.validate_control_action(e)
            jregistry.validate_control_action(e)
        elif "run" in e and e["event"] != "plane_stop":
            assert e["run_id"] == final[e["run"]]["run_id"]
    om = monitor.render_openmetrics_fleet(monitor.collect_fleet(root))
    for name in ("slowpoke", "wobbly", "steady"):
        assert f'dgc_step{{run="{final[name]["run_id"]}"}}' in om, name
    assert "dgc_control_actions{" in om and "dgc_runs 3" in om
    cohort = json.load(open(os.path.join(root, "cohort.json")))
    assert cohort["total"] == 3 and cohort["quarantined"] == []


def test_control_plane_quarantines_nonfinite_run(tmp_path):
    root = str(tmp_path)
    run_dir = os.path.join(root, "cursed")
    spec = RunSpec("cursed", _worker_cmd(run_dir, steps=60), run_dir=run_dir,
                   env={"DGC_FAKE_NONFINITE": "12"}, backoff=0.5)
    plane = ControlPlane([spec], root, rules=_drill_rules(), interval=0.2)
    final = plane.run(max_ticks=200)
    assert final["cursed"]["rc"] == 70
    assert final["cursed"]["launches"] == 1
    assert final["cursed"]["state"] == "quarantined"
    (act,) = plane.actions
    assert act["action"] == "quarantine"
    assert act["evidence"]["kind"] == "flight_dump"
    assert "nonfinite-streak" in act["evidence"]["reason"]
    assert plane.pool.snapshot()["quarantined"] == ["cursed"]
    snap = monitor.collect(run_dir)
    assert snap["flight"]["reason"].startswith("nonfinite-streak")
    assert snap["guards"]["nonfinite_rate"] == 1.0
    status = monitor.render_status(snap)
    assert "FLIGHT DUMP" in status and "GUARD TRIPS" in status
    om = monitor.render_openmetrics(snap)
    assert "dgc_flight_dump{" in om and "dgc_guard_nonfinite_rate{" in om


def test_control_cli_exit_codes(tmp_path):
    runs = [{"name": "ok", "cmd": _worker_cmd(str(tmp_path / "ok"), 5, 5)}]
    path = tmp_path / "fleet.json"
    path.write_text(json.dumps({"runs": runs}))
    assert control_main([str(path), "--interval", "0.1"]) == 0
    runs.append({"name": "bad", "retries": 0, "backoff": 0.01,
                 "cmd": [sys.executable, "-c", "raise SystemExit(3)"]})
    path.write_text(json.dumps({"fleet_root": str(tmp_path / "f2"),
                                "runs": runs}))
    (tmp_path / "rules.toml").write_text(_GOOD_TOML)
    assert control_main([str(path), "--interval", "0.1"]) == 1
    events = [json.loads(x) for x in open(
        tmp_path / "f2" / "control_events.jsonl")]
    assert events[0]["rules"] == ["straggler-adapt", "nonfinite"]


# --------------------------------------------------------------------- #
# the trainer's hooks and the recipes                                    #
# --------------------------------------------------------------------- #

def test_watchdog_heartbeat(tmp_path):
    path = tmp_path / "heartbeat"
    wd = Watchdog(60.0, heartbeat_path=str(path))
    try:
        assert abs(float(path.read_text()) - time.time()) < 5   # at start
        path.write_text("0")
        wd.beat()                           # within the second: throttled
        assert path.read_text() == "0"
        wd._hb_last -= 1.0
        wd.beat()
        assert abs(float(path.read_text()) - time.time()) < 5
    finally:
        wd.stop()


def test_trainer_stamps_run_id_and_writes_heartbeat(tmp_path, monkeypatch):
    from dgc_tpu_torch import train
    monkeypatch.chdir(tmp_path)
    hb = tmp_path / "heartbeat"
    monkeypatch.setenv("DGC_RUN_ID", "drill-20260101-000000-1")
    monkeypatch.setenv("DGC_HEARTBEAT", str(hb))
    monkeypatch.setenv(faults.ENV, "kill@1")
    assert control.resolve_run_id() == "drill-20260101-000000-1"
    t0 = time.time()
    with pytest.raises(SystemExit) as e:
        train.main(["--config", "resnet20_wm5_control", "--device", "cpu",
                    "--world", "2", "--epochs", "1", "--steps", "3",
                    "--batch-size", "4", "--synthetic-size", "32"])
    assert e.value.code == 75
    (run,) = (tmp_path / "runs").iterdir()
    assert run.name == "cifar.resnet20+dgc.wm5+control.np2"
    with open(run / "telemetry" / "host0" / "telemetry.jsonl") as f:
        header = json.loads(f.readline())
    assert header["static"]["run_id"] == "drill-20260101-000000-1"
    assert "fleet_metrics" in header and "guard_metrics" in header
    dump = flight.load_dump(str(run / "flight.json"))
    assert dump["static"]["run_id"] == "drill-20260101-000000-1"
    assert dump["reason"] == "preempt signal 15"
    assert t0 <= float(hb.read_text()) <= time.time()
    snap = monitor.collect(str(run))
    assert snap["run_label"] == "drill-20260101-000000-1"
    assert rules.detect_quarantine(snap) is None
    monkeypatch.delenv("DGC_RUN_ID")
    assert control.resolve_run_id("fallback") == "fallback"


@pytest.mark.parametrize("recipe", ["resnet20_wm5_control",
                                    "resnet50_wm5_control"])
def test_control_recipes_match_the_config_file(recipe, monkeypatch):
    monkeypatch.chdir(REPO)
    Config.reset()
    try:
        Config.update_from_modules(*tconfigs.CONFIG_FILES[recipe])
        t = tconfigs.RECIPES[recipe]().train
        c = configs.train
        assert dict(t.telemetry) == dict(c.telemetry) == {
            "enabled": True, "every": 1, "rotate_mb": 64, "fleet": True}
        assert dict(t.resilience) == dict(c.resilience)
        assert t.resilience.nonfinite_streak == 3
        assert t.resilience.watchdog_secs == 300
        assert t.resilience.checksum is False
        base = tconfigs.RECIPES[recipe.replace("_control", "")]().train
        assert t.compression == base.compression
    finally:
        Config.reset()
    assert tconfigs.CONFIG_FILES[recipe][-1] == "configs/control.py"
