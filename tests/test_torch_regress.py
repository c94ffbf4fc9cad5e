"""The regression gate against the JAX package's, on the same files: sink
runs the port writes (per-step records, and a run-summary record), bench
artifacts (one-line JSON, a ``{"parsed": ...}`` wrapper, a log whose last
JSON line counts). ``load_summary`` and ``compare`` give the JAX gate's
values, and ``main`` its exit codes: 0 pass, 1 regression, 2 nothing to
compare, 3 a missing file, 4 a schema version this reader does not read.
"""

import json

import numpy as np
import pytest
import torch

from dgc_tpu.telemetry import regress as jreg
from dgc_tpu_torch.telemetry import registry, regress, sink


def _run(path, wire=1000.0, payload=50.0, summary=None, steps=6):
    rng = np.random.RandomState(0)
    with sink.TelemetrySink(str(path)) as s:
        for step in range(steps):
            st = {k: torch.tensor(float(rng.rand()))
                  for k in registry.step_stat_names()}
            st["wire_bytes"] = torch.tensor(wire)
            st["payload_elems"] = torch.tensor(payload + step)
            s.write(step, st)
        if summary:
            s.write_record(dict(summary, event="run_summary"))
    return s.path


@pytest.fixture
def files(tmp_path):
    out = {"base": _run(tmp_path / "base.jsonl"),
           "same": _run(tmp_path / "same.jsonl"),
           "worse": _run(tmp_path / "worse.jsonl", wire=1300.0),
           "better": _run(tmp_path / "better.jsonl", wire=500.0,
                          payload=10.0),
           "summary": _run(tmp_path / "summ.jsonl",
                           summary={"step_time_ms": 350.0,
                                    "overhead_ms": 4.0})}
    bench = {"value": 3.5, "overhead_ms": 4.5, "step_time_ms": 360.0,
             "wire_bytes": 1000, "ici_v5e8": {"ratio": 2.0},
             "planned": {"ici_v5e8": {"ratio": 1.5},
                         "32x25GbE": {"ratio": 9.0}},
             "fleet": {"worker_skew": 0.1, "straggler_gap": 12.0,
                       "straggler_stall_ms": 3.0},
             "scheduler": {"grant_latency_s": 1.0, "sched_queue_depth": 2},
             "gossip": {"max_staleness_seen": 2, "forced_syncs": 0},
             "serving": {"wire_bytes_per_update": 900}}
    (tmp_path / "bench.json").write_text(json.dumps(bench))
    (tmp_path / "wrapped.json").write_text(json.dumps({"parsed": bench}))
    (tmp_path / "log.txt").write_text("noise\n{bad\n" + json.dumps(bench)
                                      + "\ntrailing\n")
    out.update(bench=str(tmp_path / "bench.json"),
               wrapped=str(tmp_path / "wrapped.json"),
               log=str(tmp_path / "log.txt"))
    v2 = tmp_path / "v2.jsonl"
    v2.write_text(json.dumps({"schema": registry.SCHEMA, "version": 2})
                  + "\n")
    out["v2"] = str(v2)
    (tmp_path / "junk.json").write_text("not json at all")
    out["junk"] = str(tmp_path / "junk.json")
    out["missing"] = str(tmp_path / "nope.jsonl")
    return out


def test_summaries_match_jax(files):
    for name in ("base", "worse", "better", "summary", "bench", "wrapped",
                 "log"):
        got = regress.load_summary(files[name])
        assert got == jreg.load_summary(files[name]), name
        assert got
    assert regress.load_summary(files["summary"])["step_time_ms"] == 350.0
    assert regress.DEFAULT_METRICS == jreg.DEFAULT_METRICS


def test_compare_matches_jax(files):
    base = regress.load_summary(files["bench"])
    for other in ("bench", "base", "worse", "better"):
        new = regress.load_summary(files[other])
        for tol in (0.0, 0.1, 0.5):
            assert (regress.compare(base, new, tol)
                    == jreg.compare(base, new, tol)), (other, tol)
    rows = regress.compare({"ici_ratio": 2.0}, {"ici_ratio": 1.0}, 0.1)
    assert rows[0]["regressed"]                 # "higher" is better
    rows = regress.compare({"wire_bytes": 0.0}, {"wire_bytes": 0.05}, 0.1)
    assert not rows[0]["regressed"]             # absolute at a 0 baseline


@pytest.mark.parametrize("pair, code", [
    (("base", "same"), 0), (("base", "better"), 0), (("base", "worse"), 1),
    (("base", "bench"), 0), (("base", "junk"), 2), (("base", "missing"), 3),
    (("v2", "base"), 4), (("summary", "base"), 2)])
def test_main_exit_codes_match_jax(files, pair, code, capsys):
    args = [files[pair[0]], files[pair[1]]]
    assert regress.main(args) == code
    mine = capsys.readouterr()
    assert jreg.main(args) == code
    theirs = capsys.readouterr()
    if code in (0, 1):
        assert mine.out == theirs.out


def test_metric_subset_and_tolerance(files, capsys):
    args = [files["base"], files["worse"]]
    assert regress.main(args + ["--tol", "0.5"]) == 0
    assert regress.main(args + ["--metrics", "payload_elems"]) == 0
    assert "payload_elems" in capsys.readouterr().out
