"""The port's race lint (layer 4, static half): DGC201, DGC202 and DGC204
held against the JAX racelint on the reference's fixtures by (rule,
line); DGC203 (which reads the step's hot path) on the port's own
fixture pair; the port's tree clean after its allowlist."""

import re
from pathlib import Path

import pytest
import torch

from dgc_tpu.analysis.racelint import race_lint_source as jax_race_source
from dgc_tpu_torch.analysis.racelint import race_lint_paths, race_lint_source
from dgc_tpu_torch.analysis.rules import (RACE_RULES, RULES_BY_ID, Allowlist,
                                          load_allowlist)

REF_FIXDIR = Path(__file__).parent / "fixtures" / "racelint"
FIXDIR = Path(__file__).parent / "fixtures" / "torch_racelint"
REPO_ROOT = Path(__file__).parents[1]
_MARK = re.compile(r"#\s*LINT:\s*([a-z0-9\-]+)")

REF = sorted(REF_FIXDIR.glob("*.py"))
POS = sorted(FIXDIR.glob("*_pos.py"))
NEG = sorted(FIXDIR.glob("*_neg.py"))
#: the API-free rules, which read the same in both packages
SHARED = {"thread-shared-state", "thread-crash-file", "thread-no-join"}


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


@pytest.mark.parametrize("path", REF, ids=lambda p: p.stem)
def test_reference_fixtures_match_the_jax_racelint(path):
    src = path.read_text()
    mine = {(f.rule, f.line) for f in race_lint_source(src, str(path))
            if f.rule in SHARED}
    theirs = {(f.rule, f.line) for f in jax_race_source(src, str(path))
              if f.rule in SHARED}
    assert mine == theirs
    want = {(r, ln) for r, ln in _expected(src) if r in SHARED}
    assert mine == want


@pytest.mark.parametrize("path", POS, ids=lambda p: p.stem)
def test_hot_state_fixture_flags_marked_lines(path):
    src = path.read_text()
    want = _expected(src)
    assert want
    assert {(f.rule, f.line) for f in race_lint_source(src, str(path))} \
        == want


@pytest.mark.parametrize("path", NEG, ids=lambda p: p.stem)
def test_hot_state_clean_twin(path):
    findings = race_lint_source(path.read_text(), str(path))
    assert findings == [], [f.format() for f in findings]


def test_every_race_rule_has_a_fixture_pair():
    stems = ({p.stem for p in REF} | {p.stem for p in POS}
             | {p.stem for p in NEG})
    for rule in RACE_RULES:
        base = rule.id.replace("-", "_")
        assert {f"{base}_pos", f"{base}_neg"} <= stems, rule.id


def test_race_rules_registered_with_codes():
    for rule in RACE_RULES:
        assert RULES_BY_ID[rule.id] is rule
        assert rule.code.startswith("DGC2")


def test_repo_tree_has_no_unallowed_race_findings():
    findings = race_lint_paths(root=str(REPO_ROOT))
    bad = [f.format() for f in findings if not f.allowed]
    assert bad == []
    assert any(f.allowed for f in findings)


def test_race_allowlist_entries_name_race_rules():
    allow = load_allowlist()
    race_ids = {r.id for r in RACE_RULES}
    audited = [e for e in allow.entries if e.get("rule") in race_ids]
    assert audited
    for e in audited:
        assert e["reason"].strip()


_PRE_FIX_SUPERVISOR = '''
import subprocess
import threading


class Supervisor:
    def __init__(self, cmd):
        self.cmd = cmd
        self.child = None
        self.quarantined = None
        self.launches = 0

    def quarantine(self, reason):
        if self.quarantined is None:
            self.quarantined = reason

    def _watch_hang(self, child):
        current = self.child
        if current is child and self.launches > 3:
            child.kill()
            if self.quarantined is None:
                self.quarantined = "hang"

    def run(self):
        while self.quarantined is None:
            self.launches += 1
            self.child = subprocess.Popen(self.cmd)
            child = self.child
            t = threading.Thread(target=self._watch_hang, args=(child,),
                                 daemon=True)
            t.start()
            child.wait()
            self.child = None
'''


def test_pre_fix_supervisor_shape_is_red():
    findings = race_lint_source(_PRE_FIX_SUPERVISOR, "pre_fix.py")
    shared = {f.message.split(" is shared")[0] for f in findings
              if f.rule == "thread-shared-state"}
    assert {"Supervisor.child", "Supervisor.quarantined",
            "Supervisor.launches"} <= shared


@pytest.mark.parametrize("rel", [
    "dgc_tpu_torch/control/supervisor.py",
    "dgc_tpu_torch/resilience/preempt.py",
    "dgc_tpu_torch/telemetry/sink.py",
])
def test_port_threaded_modules_are_green(rel):
    findings = race_lint_paths([rel], root=str(REPO_ROOT))
    bad = [f.format() for f in findings if not f.allowed]
    assert bad == [], bad


#: the seeded fixtures: the reference's API-free ones and the port's own
#: DGC203 pair (the reference's DGC203 fixture seeds a jax.jit step)
SEEDED = POS + [p for p in REF if p.stem.endswith("_pos")
                and not p.stem.startswith("thread_traced_state")]


@pytest.mark.parametrize("path", SEEDED, ids=lambda p: p.stem)
def test_cli_race_exits_nonzero_on_seeded_violation(path, capsys):
    from dgc_tpu_torch.analysis.__main__ import main
    rc = main(["--race", str(path), "--root", str(REPO_ROOT)])
    capsys.readouterr()
    assert rc == 1


def test_cli_race_exits_zero_on_clean_fixtures(capsys):
    from dgc_tpu_torch.analysis.__main__ import main
    rc = main(["--race"] + [str(p) for p in NEG]
              + [str(p) for p in REF if "_neg" in p.stem]
              + ["--root", str(REPO_ROOT)])
    capsys.readouterr()
    assert rc == 0


def test_cli_race_clean_on_repo_tree(capsys):
    from dgc_tpu_torch.analysis.__main__ import main
    rc = main(["--race", "--root", str(REPO_ROOT)])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "dgcrace:" in out


def test_inline_waiver_suppresses_race_rule():
    src = _PRE_FIX_SUPERVISOR.replace(
        "self.launches += 1",
        "self.launches += 1  # dgclint: ok[thread-shared-state]")
    findings = race_lint_source(src, "waived.py")
    assert not any(f.rule == "thread-shared-state"
                   and "launches" in f.message for f in findings)


def test_allowlist_matches_race_finding():
    findings = race_lint_source(_PRE_FIX_SUPERVISOR, "pre_fix.py",
                                allowlist=Allowlist([{
                                    "rule": "thread-shared-state",
                                    "file": "pre_fix.py",
                                    "contains": "self.launches",
                                    "reason": "test"}]))
    waived = [f for f in findings if f.allowed]
    assert waived and all("launches" in f.snippet for f in waived)
