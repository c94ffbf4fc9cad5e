"""Rule catalog + allowlist for the port's AST lints (layer 1).

Counterpart of ``dgc_tpu/analysis/rules.py``. Every rule is a static
description; the detection logic lives in
:mod:`dgc_tpu_torch.analysis.astlint` (one visitor, dispatching per rule
id). In eager PyTorch there is no trace to freeze a value into, so the
hazards are the ones that stall the step's hot path on the card:

* a host read of a device tensor (``.item()``, ``.cpu()``, ``float(t)``)
  inside the step waits for every kernel queued before it;
* a Python branch on a tensor's value is the same wait, hidden in
  ``Tensor.__bool__``;
* a float64 dtype doubles bytes and runs at a fraction of the card's f32
  rate (the pipeline contract is f32 end to end);
* an RNG call without an explicit ``generator=`` draws from global state,
  so two workers or two runs no longer draw the same numbers;
* a per-iteration host conversion in a driver loop serialises the
  dispatch pipeline.

The JAX rules DGC104 (static-argnums), DGC105 (missing-donate) and DGC108
(mutable-closure) have no counterpart: there is no jit cache and no
``donate_argnums`` in eager PyTorch (DGC105's concern is carried by the
``inplace_state`` contract and the DGCV03 pass).

Audited exceptions are recorded in ``allowlist.toml`` next to this file
(rule + file glob + source-line substring + one-line justification), or
inline with a ``# dgclint: ok`` / ``# dgclint: ok[rule-id]`` comment.
"""

import fnmatch
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = ["Rule", "RULES", "VERIFY_PASSES", "RACE_RULES", "RULES_BY_ID",
           "Finding", "Allowlist", "load_allowlist",
           "DEFAULT_ALLOWLIST_PATH"]

DEFAULT_ALLOWLIST_PATH = os.path.join(os.path.dirname(__file__),
                                      "allowlist.toml")


@dataclass(frozen=True)
class Rule:
    id: str             # stable kebab-case id, used in allowlists/waivers
    code: str           # short numeric code for terse output (DGC1xx)
    summary: str        # one line, shown next to each finding
    hot_only: bool      # rule only fires inside the step's hot path


RULES: Tuple[Rule, ...] = (
    Rule("host-sync", "DGC101",
         "host-synchronising call in the step's hot path (.item(), "
         ".tolist(), .cpu(), .numpy(), float()/int()/bool() of a tensor, "
         "torch.cuda.synchronize, print of a tensor)", True),
    Rule("tracer-branch", "DGC102",
         "Python if/while/assert on a tensor's value in the step's hot "
         "path (an implicit host sync on the card; use torch.where or "
         "hoist the condition to static config)", True),
    Rule("f64-dtype", "DGC103",
         "float64 dtype (torch.float64/double, .double(), np.float64): "
         "the pipeline contract is f32 end to end", False),
    Rule("host-entropy", "DGC106",
         "RNG without an explicit generator= (torch.rand*/randint/"
         "randperm/normal, Tensor.uniform_/normal_/bernoulli_/random_), "
         "np.random / random global state, or host wall clock in the "
         "step's hot path", True),
    Rule("sync-in-loop", "DGC107",
         "per-iteration host conversion on step outputs inside a driver "
         "loop (float()/int()/.item()/.tolist()/.cpu()/.numpy()): stalls "
         "the dispatch pipeline every iteration — batch the reads after "
         "the loop", False),
)

#: the verifier passes (:mod:`dgc_tpu_torch.analysis.verify`); kept out
#: of RULES (the AST linter expects no fixtures for them) but registered
#: in RULES_BY_ID so allowlist entries and Finding.format() work alike
VERIFY_PASSES: Tuple[Rule, ...] = (
    Rule("collective-axis", "DGCV01",
         "collective runs over an axis missing from the AxisPolicy, has "
         "no axis label at all, or pushes an axis past its per-axis "
         "collective budget", True),
    Rule("dtype-flow", "DGCV02",
         "truncating cast (f32->bf16/f16/int) on a value tainted by an "
         "f32 source (residual, momentum, guards, loss) whose narrow "
         "flow never crosses a collective — precision silently lost "
         "outside a wire lane", True),
    Rule("donation-liveness", "DGCV03",
         "state tensor the step declares in place was replaced by a "
         "fresh storage: the old buffer and the new one are both live "
         "across the step", True),
    Rule("ef-conservation", "DGCV04",
         "error-feedback conservation broken: a selected gradient "
         "element's flow does not reach both the wire payload and a "
         "transmit-record/residual fold-back sink", True),
)

#: the race-lint rules (:mod:`dgc_tpu_torch.analysis.racelint`)
RACE_RULES: Tuple[Rule, ...] = (
    Rule("thread-shared-state", "DGC201",
         "module/instance state written by a spawned thread and accessed "
         "by another thread with no shared lock on every access — the "
         "Eraser lockset condition (guard with one Lock, or hand the "
         "value over a queue/Event)", False),
    Rule("thread-crash-file", "DGC202",
         "a spawned thread and a signal/atexit crash handler write the "
         "same file — a crash mid-write interleaves the two writers on "
         "one path (route both through one atomic publisher)", False),
    Rule("thread-traced-state", "DGC203",
         "a spawned thread mutates state that the step's hot path reads: "
         "the step sees a value torn between two of the thread's updates "
         "(thread the value as a step argument)", False),
    Rule("thread-no-join", "DGC204",
         "non-daemon Thread never joined in its module: interpreter "
         "shutdown blocks on it forever (daemon=True, or join with a "
         "timeout)", False),
)

RULES_BY_ID: Dict[str, Rule] = {
    r.id: r for r in RULES + VERIFY_PASSES + RACE_RULES}

#: inline waivers: ``# dgclint: ok`` / ``# dgclint: ok[id,id]`` for the
#: AST layers, ``# dgcver: ok`` / ``# dgcver: ok[pass-id]`` for verifier
#: findings (matched against the source line the provenance names)
_WAIVER_RES = {
    "dgclint": re.compile(r"#\s*dgclint:\s*ok(?:\[([a-z0-9_,\- ]+)\])?"),
    "dgcver": re.compile(r"#\s*dgcver:\s*ok(?:\[([a-z0-9_,\- ]+)\])?"),
}


@dataclass
class Finding:
    rule: str
    path: str           # posix path relative to the lint root
    line: int
    col: int
    snippet: str        # the offending source line, stripped
    message: str
    allowed: bool = False
    allowed_by: str = ""   # "inline" or the allowlist reason

    def format(self) -> str:
        mark = f"  [allowed: {self.allowed_by}]" if self.allowed else ""
        code = RULES_BY_ID[self.rule].code
        return (f"{self.path}:{self.line}:{self.col}: {code} "
                f"[{self.rule}] {self.message}{mark}\n"
                f"    {self.snippet}")


@dataclass
class Allowlist:
    """Audited exceptions: entries match (rule, file glob, line substring).

    ``contains`` is matched against the offending *source line* — robust
    across line-number drift, unlike path:line pins. An empty ``contains``
    allows the rule for the whole file (use sparingly)."""
    entries: List[dict] = field(default_factory=list)

    def match(self, finding: Finding) -> Optional[str]:
        for e in self.entries:
            if e.get("rule") and e["rule"] != finding.rule:
                continue
            if not fnmatch.fnmatch(finding.path, e.get("file", "*")):
                continue
            contains = e.get("contains", "")
            if contains and contains not in finding.snippet:
                continue
            return e.get("reason", "allowlisted")
        return None

    @staticmethod
    def inline_waiver(source_line: str, rule: str,
                      tool: str = "dgclint") -> bool:
        m = _WAIVER_RES[tool].search(source_line)
        if not m:
            return False
        if m.group(1) is None:
            return True
        ids = {s.strip() for s in m.group(1).split(",")}
        return rule in ids


def load_allowlist(path: Optional[str] = None) -> Allowlist:
    """Parse ``allowlist.toml`` (``tomllib``); every entry needs a reason
    and a known rule id."""
    import tomllib
    path = path or DEFAULT_ALLOWLIST_PATH
    if not os.path.exists(path):
        return Allowlist()
    with open(path, "rb") as f:
        data = tomllib.load(f)
    entries = list(data.get("allow", []))
    for e in entries:
        if "reason" not in e or not str(e["reason"]).strip():
            raise ValueError(
                f"allowlist entry {e} lacks a reason — every audited "
                "exception must carry a one-line justification")
        if e.get("rule") and e["rule"] not in RULES_BY_ID:
            raise ValueError(f"allowlist entry names unknown rule "
                             f"{e['rule']!r} (known: "
                             f"{sorted(RULES_BY_ID)})")
    return Allowlist(entries)
