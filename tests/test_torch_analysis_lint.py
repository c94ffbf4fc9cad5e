"""The port's AST lints (layer 1): fixture-seeded rule coverage, the
port's tree clean after its allowlist, and the allowlist and waiver
machinery held equal to the JAX package's on the same findings.

Every port rule has a ``<rule>_pos.py`` / ``<rule>_neg.py`` pair under
tests/fixtures/torch_lint/. Positive fixtures mark each expected violation
line with ``# LINT: <rule-id>`` and a hot-path root with ``# dgclint:
hot``; the test asserts the linter finds exactly the marked (rule, line)
set."""

import re
from pathlib import Path

import pytest
import torch

from dgc_tpu.analysis import rules as jrules
from dgc_tpu_torch.analysis.astlint import (DEFAULT_ROOTS, hot_functions,
                                            lint_paths, lint_source)
from dgc_tpu_torch.analysis.rules import (RULES, RULES_BY_ID, Allowlist,
                                          Finding, load_allowlist)

FIXDIR = Path(__file__).parent / "fixtures" / "torch_lint"
REPO_ROOT = Path(__file__).parents[1]
_MARK = re.compile(r"#\s*LINT:\s*([a-z0-9\-]+)")

POS = sorted(FIXDIR.glob("*_pos.py"))
NEG = sorted(FIXDIR.glob("*_neg.py"))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread (the file runs beside other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _expected(src: str):
    return {(m.group(1), i + 1)
            for i, line in enumerate(src.splitlines())
            for m in [_MARK.search(line)] if m}


@pytest.mark.parametrize("path", POS, ids=lambda p: p.stem)
def test_positive_fixture_flags_marked_lines(path):
    src = path.read_text()
    want = _expected(src)
    assert want, f"{path.name} has no LINT markers"
    got = {(f.rule, f.line) for f in lint_source(src, str(path))}
    assert got == want


@pytest.mark.parametrize("path", NEG, ids=lambda p: p.stem)
def test_negative_fixture_is_clean(path):
    findings = lint_source(path.read_text(), str(path))
    assert findings == [], [f.format() for f in findings]


def test_every_rule_has_fixture_pair():
    stems = {p.stem for p in POS} | {p.stem for p in NEG}
    for rule in RULES:
        base = rule.id.replace("-", "_")
        assert f"{base}_pos" in stems, f"no positive fixture for {rule.id}"
        assert f"{base}_neg" in stems, f"no negative fixture for {rule.id}"


def test_rules_keep_the_reference_ids_and_codes():
    """Every port rule is a JAX rule by id and code; the three without a
    hazard in eager PyTorch (DGC104, DGC105, DGC108) are left out."""
    for rule in RULES:
        assert jrules.RULES_BY_ID[rule.id].code == rule.code
    assert {r.code for r in jrules.RULES} - {r.code for r in RULES} == {
        "DGC104", "DGC105", "DGC108"}
    for rule in jrules.VERIFY_PASSES + jrules.RACE_RULES:
        assert RULES_BY_ID[rule.id].code == rule.code


def test_hot_path_is_rooted_at_the_step():
    hot = set(hot_functions(root=str(REPO_ROOT)))
    for key in ("training/step.py::train_step",
                "compression/flat.py::FlatDGCEngine.exchange",
                "compression/flat.py::FlatDGCEngine.compress",
                "compression/flat.py::FlatDGCEngine.apply",
                "ops/kernels.py::apply_rows",
                "compression/gossip.py::round_state"):
        assert f"dgc_tpu_torch/{key}" in hot, key
    # host code with no same-name link to the step stays out
    assert "dgc_tpu_torch/train.py::main" not in hot


# --------------------------------------------------------------------- #
# CLI gate exit codes                                                    #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("path", POS, ids=lambda p: p.stem)
def test_cli_exits_nonzero_on_seeded_violation(path, capsys):
    from dgc_tpu_torch.analysis.__main__ import main
    rc = main([str(path), "--root", str(REPO_ROOT)])
    capsys.readouterr()
    assert rc == 1


def test_cli_exits_zero_on_clean_fixtures(capsys):
    from dgc_tpu_torch.analysis.__main__ import main
    rc = main([str(p) for p in NEG] + ["--root", str(REPO_ROOT)])
    capsys.readouterr()
    assert rc == 0


def test_cli_gate_clean_on_repo_tree(capsys):
    from dgc_tpu_torch.analysis.__main__ import main
    rc = main(["--root", str(REPO_ROOT)])
    out = capsys.readouterr().out
    assert rc == 0, out


def test_repo_tree_has_no_unallowed_findings():
    findings = lint_paths(DEFAULT_ROOTS, root=str(REPO_ROOT))
    bad = [f.format() for f in findings if not f.allowed]
    assert bad == []
    assert any(f.allowed for f in findings)


def test_fleet_inline_waivers_keep_working():
    """telemetry/fleet.py's two host-math f64 lines carry inline waivers
    and never reach the finding list."""
    src = (REPO_ROOT / "dgc_tpu_torch" / "telemetry" / "fleet.py").read_text()
    waived = [i + 1 for i, ln in enumerate(src.splitlines())
              if "dgclint: ok[f64-dtype]" in ln]
    assert len(waived) == 2
    findings = lint_paths(["dgc_tpu_torch/telemetry/fleet.py"],
                          root=str(REPO_ROOT), allowlist=Allowlist())
    assert not [f for f in findings if f.line in waived]
    bare = src.replace("# dgclint: ok[f64-dtype]", "#")
    assert {f.line for f in lint_source(bare, "fleet.py")
            if f.rule == "f64-dtype"} >= set(waived)


# --------------------------------------------------------------------- #
# allowlist machinery, held against the JAX package's                    #
# --------------------------------------------------------------------- #

def test_inline_waiver_suppresses_named_rule():
    src = ("import numpy as np\n"
           "def f(x):  # dgclint: hot\n"
           "    return np.asarray(x)  # dgclint: ok[host-sync]\n")
    assert lint_source(src) == []
    other = src.replace("ok[host-sync]", "ok[f64-dtype]")
    assert [f.rule for f in lint_source(other)] == ["host-sync"]
    bare = src.replace("ok[host-sync]", "ok")
    assert lint_source(bare) == []


def test_allowlist_and_waivers_match_the_reference_on_the_same_findings():
    """The port's findings on its own tree, matched by the port's and the
    JAX package's machinery against the port's allowlist file: the same
    reason for every finding, and the same inline-waiver verdicts."""
    path = str(Path(load_allowlist.__code__.co_filename).parent
               / "allowlist.toml")
    mine, theirs = load_allowlist(path), jrules.load_allowlist(path)
    assert mine.entries == theirs.entries
    findings = lint_paths(DEFAULT_ROOTS, root=str(REPO_ROOT),
                          allowlist=Allowlist())
    assert findings
    for f in findings:
        jf = jrules.Finding(f.rule, f.path, f.line, f.col, f.snippet,
                            f.message)
        assert mine.match(f) == theirs.match(jf)
    for line in ("x  # dgclint: ok", "x  # dgclint: ok[host-sync]",
                 "x  # dgclint: ok[f64-dtype, host-sync]", "x  # dgclint:",
                 "x  # dgcver: ok[dtype-flow]"):
        for rule in ("host-sync", "dtype-flow"):
            for tool in ("dgclint", "dgcver"):
                assert (Allowlist.inline_waiver(line, rule, tool)
                        == jrules.Allowlist.inline_waiver(line, rule, tool))


def test_allowlist_matches_rule_glob_and_substring():
    fd = Finding(rule="host-sync", path="dgc_tpu_torch/utils/meters.py",
                 line=3, col=0, snippet="x = np.asarray(outputs)",
                 message="m")
    allow = Allowlist([{"rule": "host-sync", "file": "dgc_tpu_torch/utils/*",
                        "contains": "np.asarray", "reason": "host meter"}])
    assert allow.match(fd) == "host meter"
    assert allow.match(
        Finding(rule="tracer-branch", path=fd.path, line=3, col=0,
                snippet=fd.snippet, message="m")) is None
    assert allow.match(
        Finding(rule="host-sync", path="train.py", line=3, col=0,
                snippet=fd.snippet, message="m")) is None


def test_load_allowlist_rejects_missing_reason(tmp_path):
    p = tmp_path / "a.toml"
    p.write_text('[[allow]]\nrule = "host-sync"\nfile = "x.py"\n')
    with pytest.raises(ValueError, match="reason"):
        load_allowlist(str(p))


def test_load_allowlist_rejects_unknown_rule(tmp_path):
    p = tmp_path / "a.toml"
    p.write_text('[[allow]]\nrule = "missing-donate"\nreason = "r"\n')
    with pytest.raises(ValueError, match="unknown rule"):
        load_allowlist(str(p))


def test_repo_allowlist_parses_with_reasons():
    allow = load_allowlist()
    assert allow.entries
    for e in allow.entries:
        assert e.get("rule", "host-sync") in RULES_BY_ID
        assert e["reason"].strip()


def test_allowlisted_finding_format_shows_reason():
    fd = Finding(rule="host-sync", path="a.py", line=1, col=0,
                 snippet="s", message="m", allowed=True, allowed_by="why")
    assert "[allowed: why]" in fd.format()
    assert "DGC101" in fd.format()


def test_syntax_error_reported_as_finding():
    assert [f.message for f in lint_source("def broken(:\n")][0].startswith(
        "syntax error")
