"""The port's crash-consistency model checker (layer 4, dynamic half):
sandbox crash semantics, every protocol spec driven by a scenario over
the port's own writers, the suite green at head, and each seeded
mutation turning it red — naming the same protocols, steps, syscalls and
invariants as the JAX checker on the reference's writers (the JAX side
computed once for the module)."""

import builtins
import json
import os
import re
import tempfile

import pytest
import torch

from dgc_tpu.analysis import mc as jmc
from dgc_tpu.analysis import protospec as jspec
from dgc_tpu_torch.analysis.mc import (MUTATIONS, Crash, Sandbox, explore,
                                       run_mc_suite, scenarios)
from dgc_tpu_torch.analysis.protospec import (APPEND_TAIL_TORN, PROTOCOLS,
                                              PROTOCOLS_BY_NAME,
                                              RENAME_ATOMIC, WRITE_ONCE)

_SILENT = lambda s: None  # noqa: E731
#: "<protocol> @ [crash at] step K (kind path)[ + retry]: INVARIANT ...",
#: or a write-once ledger breach "... @ live: step K: write-once artifact X"
_CTX = re.compile(r"^([a-z\-]+) @ (?:crash at )?(?:step (\d+) \((\w+) "
                  r"[^)]*\)|(\w+))(?: \+ retry)?: ([A-Z][A-Z\-]+|step \d+: "
                  r"write-once artifact \S+)")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread (the file runs beside other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _named(results):
    """(protocol, step, syscall kind, phase, invariant) of every
    violation: what a red run names, free of temporary file names."""
    out = set()
    for _, violations in results:
        for v in violations:
            m = _CTX.match(v)
            assert m, v
            out.add(m.groups())
    return out


@pytest.fixture(scope="module")
def jax_red():
    """The JAX checker's red runs on its own writers, one per mutation
    (without the checkpoint scenario, whose writer is orbax there and
    torch.save here)."""
    return {m: _named(jmc.run_mc_suite(log=_SILENT, mutate=m, fast=True))
            for m in MUTATIONS}


def test_protocol_specs_well_formed():
    classes = {RENAME_ATOMIC, WRITE_ONCE, APPEND_TAIL_TORN}
    assert len(PROTOCOLS) == 8
    for spec in PROTOCOLS:
        assert spec.files and spec.invariants, spec.name
        for fs in spec.files:
            assert fs.atomicity in classes, (spec.name, fs.pattern)
            assert fs.writer and fs.readers, (spec.name, fs.pattern)
        assert PROTOCOLS_BY_NAME[spec.name] is spec


def test_specs_are_the_reference_protocols():
    """The same protocols, files, atomicity classes and invariants."""
    assert [p.name for p in PROTOCOLS] == [p.name for p in jspec.PROTOCOLS]
    for mine, ref in zip(PROTOCOLS, jspec.PROTOCOLS):
        assert mine.invariants == ref.invariants
        assert [(f.pattern, f.atomicity) for f in mine.files] == [
            (f.pattern, f.atomicity) for f in ref.files]


def test_every_protocol_has_a_scenario():
    assert {s.name for s in scenarios()} == {p.name for p in PROTOCOLS}
    assert ({s.name for s in scenarios(fast=True)}
            == {p.name for p in PROTOCOLS} - {"checkpoint-epoch"})


def test_scenarios_drive_the_ports_writers():
    """Each scenario's writer is the port's function, never the JAX
    package's: a checkpoint save publishes through torch.save files."""
    scn = [s for s in scenarios() if s.name == "checkpoint-epoch"][0]
    with tempfile.TemporaryDirectory() as d:
        root = os.path.join(d, "fs")
        scn.setup(root)
        scn.writer(root)
        assert sorted(os.listdir(os.path.join(root, "e1"))) == [
            "meters.json", "state.pt", "w0.pt"]
        assert scn.check_final(root) == []


def test_crash_is_not_an_exception():
    assert issubclass(Crash, BaseException)
    assert not issubclass(Crash, Exception)


def test_crash_fires_before_nonwrite_op(tmp_path):
    sb = Sandbox(str(tmp_path), crash_at=0)
    with sb:
        with pytest.raises(Crash):
            open(tmp_path / "a.txt", "w")
    assert not (tmp_path / "a.txt").exists()
    assert sb.ops == [("create", "a.txt")]


def test_mid_write_tear_leaves_half(tmp_path):
    sb = Sandbox(str(tmp_path), crash_at=1)
    with sb:
        with pytest.raises(Crash):
            with open(tmp_path / "a.txt", "w") as f:
                f.write("0123456789")
    assert (tmp_path / "a.txt").read_bytes() == b"01234"
    torn = sb.apply_crash_effects()
    assert (tmp_path / "a.txt").read_bytes() == b"012"
    assert torn and "a.txt" in torn[0]


def test_fsynced_bytes_survive_crash_effects(tmp_path):
    from dgc_tpu_torch.serving.protocol import write_json_atomic
    sb = Sandbox(str(tmp_path))
    with sb:
        write_json_atomic(str(tmp_path / "x.json"), {"v": 1})
    assert sb.apply_crash_effects() == []
    with open(tmp_path / "x.json") as f:
        assert json.load(f) == {"v": 1}
    kinds = [k for k, _ in sb.ops]
    assert "fsync" in kinds and "replace" in kinds


def test_unsynced_replace_carries_risk(tmp_path):
    sb = Sandbox(str(tmp_path))
    with sb:
        with open(tmp_path / "t.tmp", "w") as f:
            f.write("0123456789abcdef")
        os.replace(tmp_path / "t.tmp", tmp_path / "final.txt")
    torn = sb.apply_crash_effects()
    assert torn and "final.txt" in torn[0]
    assert len((tmp_path / "final.txt").read_bytes()) < 16


def test_write_once_ledger_flags_republish(tmp_path):
    sb = Sandbox(str(tmp_path), write_once=("delta_*.npz",))
    with sb:
        for content in ("AAAA", "BBBB"):
            with open(tmp_path / "d.tmp", "w") as f:
                f.write(content)
            os.replace(tmp_path / "d.tmp", tmp_path / "delta_1.npz")
    assert len(sb.violations) == 1
    assert "delta_1.npz" in sb.violations[0]


def test_sandbox_confined_to_root_and_restored(tmp_path):
    inside = tmp_path / "in"
    inside.mkdir()
    before = (builtins.open, os.replace, os.fsync, tempfile.mkstemp)
    sb = Sandbox(str(inside))
    with sb:
        with open(tmp_path / "outside.txt", "w") as f:
            f.write("x")
        with open(inside / "inside.txt", "w") as f:
            f.write("y")
    assert [rel for _, rel in sb.ops] == ["inside.txt", "inside.txt"]
    assert (builtins.open, os.replace, os.fsync,
            tempfile.mkstemp) == before


def test_suite_green_at_head():
    results = run_mc_suite(log=_SILENT)
    assert {n for n, _ in results} == {p.name for p in PROTOCOLS}
    for name, violations in results:
        assert violations == [], (name, violations[:3])


@pytest.mark.parametrize("mutation", MUTATIONS)
def test_mutation_red_names_what_the_reference_names(mutation, jax_red,
                                                     monkeypatch):
    if mutation == "torn_tail":
        # seeded through the environment, as the CLI's DGC_MC_MUTATE is
        monkeypatch.setenv("DGC_MC_MUTATE", mutation)
        results = run_mc_suite(log=_SILENT, fast=True)
    else:
        results = run_mc_suite(log=_SILENT, mutate=mutation, fast=True)
    red = [(n, v) for n, v in results if v]
    assert red, f"mutation {mutation} left the suite green"
    for name, violations in red:
        assert all(v.startswith(f"{name} @ ") for v in violations)
        assert any("step" in v for v in violations), violations[:3]
    assert _named(results) == jax_red[mutation]


def test_checkpoint_scenario_red_under_drop_replace():
    """The torch.save checkpoint's publish rename is its commit point."""
    scn = [s for s in scenarios() if s.name == "checkpoint-epoch"][0]
    viols = explore(scn, log=_SILENT, mutate="drop_replace")
    assert any("RESTORE-FALLBACK" in v for v in viols), viols[:3]


def test_unknown_mutation_rejected():
    with pytest.raises(ValueError, match="unknown mc mutation"):
        run_mc_suite(log=_SILENT, mutate="no_such_bug")


def test_explore_reports_crash_context():
    scn = [s for s in scenarios(mutate="torn_tail", fast=True)
           if s.name == "telemetry-stream"][0]
    viols = explore(scn, log=_SILENT, mutate="torn_tail")
    assert viols and all(v.startswith("telemetry-stream @ ") for v in viols)
    assert any("crash at step" in v for v in viols)
