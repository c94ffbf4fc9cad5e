"""The port's verifier (layer 3): the recorded program's helpers, each
pass on toy recorded programs, the seeded mutations wired to the real
engine (``DGC_VERIFY_MUTATE`` must turn the right pass red at the port's
line), the runtime conservation check, the suite green on all 15 pinned
configs, and the report in the reference's schema read by both
packages' regress gates."""

import inspect
import json
import os
import re

import pytest
import torch

from dgc_tpu_torch.analysis import program as prg
from dgc_tpu_torch.analysis import verify
from dgc_tpu_torch.analysis.contracts import record_step
from dgc_tpu_torch.analysis.rules import Allowlist, Finding, load_allowlist
from dgc_tpu_torch.analysis.suite import build_fixture
from dgc_tpu_torch.analysis.verify import (AxisPolicy, ConservationProbe,
                                           check_collective_axes,
                                           check_donation_liveness,
                                           check_dtype_flow,
                                           check_ef_conservation,
                                           run_verify_suite)
from dgc_tpu_torch.ops import kernels
from dgc_tpu_torch.parallel.comm import LocalComm

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread (the file runs beside other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    path = tmp_path_factory.mktemp("report") / "analysis_report.json"
    results = run_verify_suite(root=REPO_ROOT, allowlist=load_allowlist(),
                               report_path=str(path))
    return results, json.loads(path.read_text())


def _record(fn, *args):
    with prg.Recorder() as rec:
        fn(*args)
    return rec.prog


def _comm_prog(axis="data", n=1, local_size=None):
    comm = prg.RecordingComm(LocalComm(4))
    if local_size:
        local, cross = comm.split(local_size)
        comm = {"local": local, "hosts": cross}[axis]

    def run():
        xs = [torch.ones(4) for _ in range(4)]
        for _ in range(n):
            comm.all_gather(xs)
    return _record(run)


# --------------------------------------------------------------------- #
# the recorded program                                                   #
# --------------------------------------------------------------------- #

def test_fixture_step_records_collectives_anchors_and_sources():
    rec = record_step(build_fixture())
    sites = prg.collectives(rec.prog)
    assert [s.prim for s in sites] == ["all-gather", "all-gather",
                                       "all-reduce", "all-reduce"]
    assert all(s.axes == ("data",) for s in sites)
    assert all("compression/flat.py" in s.source or "training/step.py"
               in s.source for s in sites)
    tags = prg.tags(rec.prog)
    for name in ("dgcver.src.loss", "dgcver.src.grad", "dgcver.src.momentum",
                 "dgcver.src.residual", "dgcver.sel_values",
                 "dgcver.sel_indices", "dgcver.sink.momentum",
                 "dgcver.sink.residual", "dgcver.sink.sent_bits"):
        assert len(tags[name]) == 8, name     # one a worker
    assert "training/step.py" in tags["dgcver.src.loss"][0].source
    assert "compression/flat.py" in tags["dgcver.sel_values"][0].source


def test_two_tier_groups_are_labelled_by_axis():
    assert prg.collectives(_comm_prog("local", local_size=2))[0].axes == (
        "local",)
    assert prg.collectives(_comm_prog("hosts", local_size=2))[0].axes == (
        "hosts",)


def test_forward_taint_follows_storages_through_views():
    def fn():
        a = torch.zeros(8)
        kernels.vtag(a, "seed")
        b = torch.ones(8)
        a[2:4].copy_(b[:2])          # a write through a view of a
        c = a.sum()
        d = b * 2                    # untouched by a
        return c, d
    prog = _record(fn)
    seed = prg.tags(prog)["seed"][0].outvars
    taint = prg.forward_taint(prog, seed)
    s = next(e for e in prog.eqns if e.prim == "aten.sum")
    m = next(e for e in prog.eqns if e.prim == "aten.mul")
    assert s.outvars[0] in taint and m.outvars[0] not in taint


def test_peak_live_bytes_counts_each_storage_once():
    def fn():
        a = torch.zeros(1024)
        a.add_(1)
        a.mul_(2)                     # in place: no new storage
        return a
    prog = _record(fn)
    assert prg.peak_live_bytes(prog) == 4096


def test_vtag_is_identity_and_silent_without_a_recorder():
    x = torch.arange(4.0)
    assert kernels.VTAG_RECORDER is None
    assert kernels.vtag(x, "dgcver.src.grad") is x
    d = {"a": x}
    assert kernels.vtag(d, "dgcver.sink.residual") is d


# --------------------------------------------------------------------- #
# pass 1: collective-axis                                                #
# --------------------------------------------------------------------- #

def test_collective_axis_allowed():
    assert check_collective_axes(_comm_prog(), root=REPO_ROOT) == []


def test_collective_axis_undeclared_axis_flagged():
    policy = AxisPolicy(allowed=frozenset({"model"}), budgets={})
    f = check_collective_axes(_comm_prog(), policy, REPO_ROOT)
    assert f and "undeclared axis 'data'" in f[0].message


def test_collective_axis_budget_enforced():
    policy = AxisPolicy(allowed=frozenset({"data"}), budgets={"data": 2})
    f = check_collective_axes(_comm_prog(n=3), policy, REPO_ROOT)
    assert any("over its budget" in x.message for x in f)


# --------------------------------------------------------------------- #
# pass 2: dtype-flow                                                     #
# --------------------------------------------------------------------- #

def test_dtype_flow_flags_onchip_bf16_roundtrip():
    def fn():
        g = kernels.vtag(torch.ones(8), "dgcver.src.residual")
        return g.to(torch.bfloat16).to(torch.float32) * 2
    f = check_dtype_flow(_record(fn), REPO_ROOT)
    assert f and "truncating cast" in f[0].message
    assert f[0].path.endswith("test_torch_analysis_verify.py") is False


def test_dtype_flow_allows_wire_lane_narrowing():
    comm = prg.RecordingComm(LocalComm(2))

    def fn():
        g = kernels.vtag(torch.ones(8), "dgcver.src.grad")
        q = g.to(torch.int8)                       # quantize, then gather
        comm.all_gather([q, q])
    assert check_dtype_flow(_record(fn), REPO_ROOT) == []


def test_dtype_flow_ignores_untainted_casts():
    def fn():
        kernels.vtag(torch.ones(2), "dgcver.src.loss")
        return torch.ones(8).to(torch.bfloat16)
    assert check_dtype_flow(_record(fn), REPO_ROOT) == []


def test_adaptive_policy_has_no_truncating_cast():
    """A deliberate divergence: the reference's DGCV02 finding on its
    adaptive config (``resilience/adaptive.py:98``) is a truncating
    f32->int32 cast inside ``jnp.median``'s own lowering. The port's
    median indexes the sorted column at host ints (``adaptive._median``),
    so its policy update, tainted from the gathered clock, casts
    nothing."""
    from dgc_tpu_torch.resilience.adaptive import (AdaptiveConfig,
                                                   update_policy)

    def fn():
        clock = kernels.vtag(torch.tensor([200.0, 200.0, 200.0, 350.0]),
                             "dgcver.src.loss")
        return update_policy(AdaptiveConfig(), clock)
    prog = _record(fn)
    assert not [e for e in prog.eqns if "dst_dtype" in e.params]
    assert check_dtype_flow(prog, REPO_ROOT) == []


# --------------------------------------------------------------------- #
# passes 3 and 4                                                         #
# --------------------------------------------------------------------- #

def test_donation_liveness_reports_coverage_and_flags_fresh_storage():
    rec = record_step(build_fixture())
    metrics, findings = check_donation_liveness(rec, root=REPO_ROOT)
    assert findings == []
    assert 0.0 < metrics["alias_coverage"] < 1.0
    assert metrics["peak_live_bytes"] > 0
    _, bad = check_donation_liveness(
        rec, inplace=("memory.0.sent_bits",), root=REPO_ROOT)
    assert bad and "fresh storage" in bad[0].message


def test_ef_conservation_dense_program_trivially_ok():
    prog = _record(lambda: torch.ones(4) * 2)
    assert check_ef_conservation(prog, REPO_ROOT) == ("dense", [])


def test_ef_conservation_descriptor_rejects_dense_under_sparse_plan():
    prog = _record(lambda: torch.ones(4) * 2)
    status, f = check_ef_conservation(prog, REPO_ROOT,
                                      descriptor={"conservation": "sparse"})
    assert status == "broken" and f


def test_plan_verify_descriptors_equal_the_reference():
    from dgc_tpu.compression.planner import Plan as JPlan
    from dgc_tpu_torch.compression.planner import Plan
    for reg in ("dense", "fp32", "int8", "int8_packed", "int4_packed",
                "int8_delta_idx", "gossip_ring", "gossip_hcube"):
        assert (Plan([reg], fabric="32x25GbE", world=8).verify_descriptor()
                == JPlan([reg], fabric="32x25GbE",
                         world=8).verify_descriptor()), reg


# --------------------------------------------------------------------- #
# seeded mutations and the runtime check                                 #
# --------------------------------------------------------------------- #

def test_mutation_cast_bf16_turns_dtype_flow_red(monkeypatch):
    monkeypatch.setenv("DGC_VERIFY_MUTATE", "cast_bf16")
    findings = check_dtype_flow(record_step(build_fixture()).prog,
                                REPO_ROOT)
    assert findings
    f = findings[0]
    assert f.path == "dgc_tpu_torch/compression/flat.py" and f.line > 0
    assert "torch.bfloat16" in f.snippet


def test_mutation_drop_foldback_turns_conservation_red(monkeypatch):
    monkeypatch.setenv("DGC_VERIFY_MUTATE", "drop_foldback")
    status, findings = check_ef_conservation(
        record_step(build_fixture()).prog, REPO_ROOT)
    assert status == "broken"
    assert [f.message[:10] for f in findings] == ["C3 broken:"]
    assert findings[0].path == "dgc_tpu_torch/compression/flat.py"
    got = verify._runtime_conservation("cpu")
    assert got and all(v.startswith("C3: ") for v in got)


def test_unmutated_fixture_conserves_statically_and_at_run_time(
        monkeypatch):
    monkeypatch.delenv("DGC_VERIFY_MUTATE", raising=False)
    prog = record_step(build_fixture()).prog
    assert check_dtype_flow(prog, REPO_ROOT) == []
    assert check_ef_conservation(prog, REPO_ROOT) == ("ok", [])
    assert verify._runtime_conservation("cpu") == []


def test_probe_names_every_check():
    fx = build_fixture()
    probe = ConservationProbe()
    with prg.Recorder(trace=False, modules=False, probe=probe):
        for _ in range(2):
            probe.begin_step()
            fx.state, _ = fx.step(fx.state)
    got = probe.check(fx.setup.engine)
    assert got == {"C1": [], "C2": [], "C3": []}
    # a flipped payload value breaks C1 at that worker
    probe.steps[0]["dgcver.sel_values"][5][0] += 1.0
    assert probe.check(fx.setup.engine)["C1"][0].startswith("worker 5")


# --------------------------------------------------------------------- #
# the suite, the report and the waivers                                  #
# --------------------------------------------------------------------- #

def test_verify_suite_green_on_all_pinned_configs(suite):
    results, _ = suite
    bad = [(n, v) for n, v in results if v]
    assert not bad, bad
    names = {n.split("].")[0] + "]" for n, _ in results
             if n.startswith("verify[") and n.split("]")[0][7:]
             in verify.VERIFY_CONFIGS}
    assert len(names) == len(verify.VERIFY_CONFIGS) == 15


def test_report_schema_matches_the_reference(suite):
    """The reference's report literal and per-config keys, read off its
    source, all present in the port's report."""
    from dgc_tpu.analysis import verify as jverify
    src = inspect.getsource(jverify.run_verify_suite)
    schema = re.search(r'"schema": "([^"]+)"', src).group(1)
    keys = set(re.findall(r'"(\w+)": ', src.split(
        'report["configs"][name] = {')[1].split("}")[0]))
    _, report = suite
    assert report["schema"] == schema == verify.REPORT_SCHEMA
    assert set(verify.VERIFY_CONFIGS) <= set(report["configs"])
    for name in verify.VERIFY_CONFIGS:
        assert keys <= set(report["configs"][name]), name
    assert {"alias_coverage", "peak_live_bytes"} <= set(
        report["configs"]["donated"])
    assert report["devices"]["dtype-flow"].startswith("cpu")


def test_both_regress_gates_read_the_report(suite, tmp_path):
    from dgc_tpu.telemetry.regress import load_summary as jax_load
    from dgc_tpu_torch.telemetry.regress import compare, load_summary
    _, report = suite
    p = tmp_path / "r.json"
    p.write_text(json.dumps(report))
    mine = load_summary(str(p))
    assert mine["alias_coverage"] == report["alias_coverage"]
    assert mine["peak_live_bytes"] == report["peak_live_bytes"]
    assert {k: jax_load(str(p))[k] for k in
            ("alias_coverage", "peak_live_bytes")} == {
        k: mine[k] for k in ("alias_coverage", "peak_live_bytes")}
    worse = dict(report, alias_coverage=report["alias_coverage"] / 2,
                 peak_live_bytes=report["peak_live_bytes"] * 3)
    q = tmp_path / "w.json"
    q.write_text(json.dumps(worse))
    by = {r["metric"]: r for r in compare(mine, load_summary(str(q)),
                                          tol=0.10)}
    assert by["alias_coverage"]["regressed"]
    assert by["peak_live_bytes"]["regressed"]


def test_inline_dgcver_waiver_syntax():
    assert Allowlist.inline_waiver("x = 1  # dgcver: ok[dtype-flow]",
                                   "dtype-flow", tool="dgcver")
    assert not Allowlist.inline_waiver("x = 1  # dgcver: ok[dtype-flow]",
                                       "ef-conservation", tool="dgcver")
    assert not Allowlist.inline_waiver("x = 1  # dgclint: ok",
                                       "dtype-flow", tool="dgcver")


def test_allowlist_matches_verify_findings():
    al = Allowlist([{"rule": "dtype-flow",
                     "file": "dgc_tpu_torch/compression/*",
                     "contains": "to(torch.bfloat16)",
                     "reason": "test entry"}])
    f = Finding(rule="dtype-flow", path="dgc_tpu_torch/compression/flat.py",
                line=1, col=0, snippet="y = x.to(torch.bfloat16)",
                message="m")
    assert al.match(f) == "test entry"
    assert verify._filter_waived([f], al) == []
    assert verify._filter_waived([f], Allowlist()) != []


def test_verify_cli_device_rule(capsys):
    """--verify raises without a card unless --device cpu, and --help
    says the taint passes trace on the CPU."""
    from dgc_tpu_torch.analysis.__main__ import main
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--verify"])
    with pytest.raises(SystemExit):
        main(["--help"])
    assert "dispatch trace" in " ".join(capsys.readouterr().out.split())
