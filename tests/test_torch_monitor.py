"""The port's live monitor (``dgc_tpu_torch.telemetry.monitor``) against
the JAX package's (``dgc_tpu.telemetry.monitor``) over the same run
directories: ``collect`` and ``collect_fleet`` give equal snapshots
(``t_collect`` stripped) — torn and rotated shards, a flight dump, the
control plane's cohort file and event streams, a serving lane and the
gang scheduler's lane included — and ``render_status``,
``render_openmetrics``, ``render_openmetrics_fleet`` and
``render_fleet_status`` are byte-equal, as is the ``--once`` CLI. The
cached HTTP endpoint answers ``/metrics`` on port 0."""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import pytest

from dgc_tpu.telemetry import flight as jflight
from dgc_tpu.telemetry import monitor as jmonitor
from dgc_tpu_torch.control.scheduler import GangScheduler
from dgc_tpu_torch.telemetry import monitor

from test_fleet import _write_run


def _strip(snap):
    """A snapshot without its wall-clock stamp (recursively for fleets)."""
    out = {k: v for k, v in snap.items() if k != "t_collect"}
    if isinstance(out.get("runs"), dict):
        out["runs"] = {n: _strip(s) for n, s in out["runs"].items()}
    return out


def _serving(run):
    d = os.path.join(run, "serving")
    os.makedirs(d)
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump({"base_version": 2, "latest_seq": 9, "max_lag": 3,
                   "wire_bytes_per_update": 100,
                   "full_checkpoint_bytes": 1000}, f)
    for name, seq, health in (("r0", 9, "ok"), ("r1", 4, "gap")):
        with open(os.path.join(d, f"replica_{name}.json"), "w") as f:
            json.dump({"event": "replica_status", "replica": name,
                       "base_version": 2, "delta_seq": seq,
                       "latest_seq": 9, "staleness": 9 - seq, "max_lag": 3,
                       "health": health, "t": 0.0}, f)


def _supervise(run, run_id, events):
    with open(os.path.join(run, "supervise_events.jsonl"), "w") as f:
        for i, (kind, extra) in enumerate(events):
            f.write(json.dumps(dict(extra, event=kind, t=1000.0 + i,
                                    launches=1 + (i > 1), run_id=run_id,
                                    cohort={})) + "\n")
        f.write('{"event": "relau')                   # live-writer tear


def _guarded(run):
    """The coordinator-only layout, the guard counters on every record,
    and a bare event row last."""
    from dgc_tpu.telemetry import registry
    d = os.path.join(run, "telemetry")
    os.makedirs(d)
    with open(os.path.join(d, "telemetry.jsonl"), "w") as f:
        f.write(json.dumps(registry.make_header(
            {"world": 2, "num_params": 400, "run_id": "hdr-id"},
            guards=True)) + "\n")
        for i in range(6):
            f.write(json.dumps({
                "step": i, "t_host": 50.0 + i, "loss": None if i > 3 else
                1.5, "payload_elems": 20.0, "skipped_steps": float(i > 3),
                "nonfinite_rate": 0.5 if i > 3 else 0.0,
                "checksum_failures": 0.0, "adaptive_engaged": 1.0,
                "w_eff_ratio": [1.0, 0.5], "max_staleness_seen": 2.0,
                "w_staleness": [0.0, 2.0], "gossip_forced_syncs": 1.0})
                + "\n")
        f.write(json.dumps({"event": "nonfinite_abort", "t_host": 60.0,
                            "step": 5}) + "\n")


def _layout(root, name):
    run = os.path.join(root, name)
    if name == "fleet":
        _write_run(run, hosts=2, world=4, steps=30, straggler=1, torn=True,
                   rotate=True)
        fl = jflight.FlightRecorder(capacity=8, static={"world": 4})
        fl.record(step=3, loss=float("nan"))
        fl.dump(os.path.join(run, "flight.json"), reason="nonfinite-streak x3")
        with open(os.path.join(run, "cohort.json"), "w") as f:
            json.dump({"total": 2, "active": 1, "pool_free": 1,
                       "quarantined": ["fleet"], "spec_world": 2,
                       "probe": {"passed": True}}, f)
        _supervise(run, "fleet-20260101-000000-7", [
            ("launch", {"cmd": ["x"]}), ("relaunch", {"rc": 75}),
            ("launch", {}), ("quarantined", {"rc": 70, "reason": "exit:70"})])
        _serving(run)
    elif name == "plain":
        _write_run(run, hosts=1, world=2, steps=8)
    elif name == "guarded":
        _guarded(run)
        with open(os.path.join(run, "flight.json"), "w") as f:
            f.write("{torn")
        with open(os.path.join(run, "cohort.json"), "w") as f:
            f.write("[torn")
    elif name == "serving_only":
        os.makedirs(run)
        _serving(run)
    return run


@pytest.mark.parametrize("name", ["fleet", "plain", "guarded",
                                  "serving_only"])
def test_collect_and_renderings_match_jax(name, tmp_path):
    run = _layout(str(tmp_path), name)
    got, want = monitor.collect(run), jmonitor.collect(run)
    assert _strip(got) == _strip(want)
    assert monitor.render_status(got) == jmonitor.render_status(want)
    assert monitor.render_openmetrics(got) == \
        jmonitor.render_openmetrics(want)
    assert monitor.render_openmetrics(got).endswith("# EOF\n")
    if name == "fleet":
        assert got["run_label"] == "fleet-20260101-000000-7"
        assert got["skipped_lines"] == 1 and got["supervise_launches"] == 2
        assert got["flight"]["reason"] == "nonfinite-streak x3"
        assert "dgc_flight_dump{" in monitor.render_openmetrics(got)
    if name == "guarded":
        assert got["run_label"] == "hdr-id"
        assert got["flight"]["reason"] == "unreadable"


def test_collect_refuses_a_missing_run_as_jax(tmp_path):
    for mod in (monitor, jmonitor):
        with pytest.raises(FileNotFoundError):
            mod.collect(str(tmp_path / "gone"))
    assert monitor.read_supervise_events(str(tmp_path)) == []
    assert monitor.supervise_events_path(str(tmp_path)) is None


def _fleet_root(root):
    for name in ("fleet", "plain", "guarded", "serving_only"):
        _layout(root, name)
    bad = os.path.join(root, "broken", "telemetry", "host0")
    os.makedirs(bad)
    with open(os.path.join(bad, "telemetry.jsonl"), "w") as f:
        f.write('{"schema": "dgc-telem')
    with open(os.path.join(root, "control_events.jsonl"), "w") as f:
        f.write(json.dumps({"event": "plane_start", "t": 1.0}) + "\n")
        for i, (run, rule, action, kind) in enumerate((
                ("fleet", "nonfinite-quarantine", "quarantine",
                 "flight_dump"),
                ("plain", "straggler-relaunch", "elastic_relaunch",
                 "straggler"),
                ("plain", "desync-restart", "restart", "desync"))):
            f.write(json.dumps({
                "event": "control_action", "run": run, "run_id": f"{run}-id",
                "rule": rule, "action": action, "evidence": {"kind": kind},
                "result": {}, "t": 2.0 + i}) + "\n")
        f.write("not json\n")
    clock = iter(range(100, 200)).__next__
    s = GangScheduler(4, root=root, clock=lambda: float(clock()))
    s.admit("train", 3, priority=1)
    s.admit("whale", 9)
    s.tick()
    s.admit("batch", 2)
    s.close()
    return root


def test_collect_fleet_and_renderings_match_jax(tmp_path):
    root = _fleet_root(str(tmp_path))
    got, want = monitor.collect_fleet(root), jmonitor.collect_fleet(root)
    assert _strip(got) == _strip(want)
    assert sorted(got["runs"]) == ["broken", "fleet", "guarded", "plain",
                                   "serving_only"]
    assert "error" in got["runs"]["broken"]
    assert monitor.collect_sched(root) == jmonitor.collect_sched(root)
    assert got["sched"]["holdings"] == {"train": 3}
    assert got["sched"]["unschedulable"] == ["whale"]
    assert monitor.read_control_events(root) == \
        jmonitor.read_control_events(root)
    assert monitor.rank_runs(got) == jmonitor.rank_runs(want)
    assert monitor.rank_runs(got)[0]["name"] == "broken"
    om = monitor.render_openmetrics_fleet(got)
    assert om == jmonitor.render_openmetrics_fleet(want)
    assert "dgc_runs 5" in om and "dgc_runs_unreadable 1" in om
    assert 'dgc_control_actions{run="plain-id"} 2' in om
    assert 'dgc_sched_held_slots{run="train"} 3' in om
    helps = [x.split()[2] for x in om.splitlines() if x.startswith("# HELP")]
    assert len(helps) == len(set(helps))
    status = monitor.render_fleet_status(got)
    assert status == jmonitor.render_fleet_status(want)
    assert "SCHED:" in status and "UNSCHEDULABLE [whale]" in status
    assert monitor.collect_sched(str(tmp_path / "nowhere")) is None


def test_once_cli_matches_jax(tmp_path, capsys):
    root = _fleet_root(str(tmp_path))
    for argv in ([root, "--fleet", "--once", "--openmetrics"],
                 [root, "--fleet", "--once"],
                 [os.path.join(root, "fleet"), "--once"],
                 [os.path.join(root, "plain"), "--once", "--openmetrics"],
                 [os.path.join(root, "gone"), "--once"]):
        rc = monitor._main(argv)
        got = capsys.readouterr().out
        assert rc == jmonitor._main(argv), argv
        assert got == capsys.readouterr().out, argv
        assert rc == (1 if argv[0].endswith("gone") else 0)


def test_serve_answers_metrics_on_port_zero(tmp_path, capsys):
    root = _fleet_root(str(tmp_path))
    t = threading.Thread(target=monitor.serve, args=(root,), daemon=True,
                         kwargs=dict(port=0, interval=0.5,
                                     max_iterations=6, fleet=True))
    t.start()
    out, deadline = "", time.time() + 30
    while "serving /metrics" not in out and time.time() < deadline:
        time.sleep(0.05)
        out += capsys.readouterr().out
    port = int(out.split("http://0.0.0.0:")[1].split()[0])
    base = f"http://127.0.0.1:{port}"
    with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
        assert r.status == 200
        assert r.headers["Content-Type"].startswith(
            "application/openmetrics-text")
        body = r.read().decode()
    assert body.endswith("# EOF\n") and "dgc_runs 5" in body
    with urllib.request.urlopen(base + "/status", timeout=10) as r:
        assert "dgc fleet control" in r.read().decode()
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(base + "/nope", timeout=10)
    assert e.value.code == 404
    t.join(timeout=30)
    assert not t.is_alive()
    assert "dgc fleet control" in capsys.readouterr().out + out
