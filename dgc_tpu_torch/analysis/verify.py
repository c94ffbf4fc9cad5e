"""The dataflow verifier (layer 3): four passes over recorded steps.

Counterpart of ``dgc_tpu/analysis/verify.py``. The reference runs its
passes over a jaxpr; here they run over the dispatch trace of one step
(:class:`~dgc_tpu_torch.analysis.program.Recorder`), seeded at the
``dgcver.*`` anchors the engine reports through
:func:`~dgc_tpu_torch.ops.kernels.vtag` (no op and no launch without a
recorder):

* **collective-axis** (DGCV01) — every collective of every pinned config
  names an axis of the declared :class:`AxisPolicy` (the recording Comm
  labels ``data``, ``local`` and ``hosts``), within that axis's budget,
  and the wire gathers are as many as the plan's descriptor predicts.
* **dtype-flow** (DGCV02) — values tainted by the f32 sources (loss,
  gradient, momentum, residual, guards) take no truncating cast
  (f32 -> bf16/f16/int) unless the narrowed flow crosses a gather before
  it is widened again — i.e. unless it is a wire lane.
* **donation-liveness** (DGCV03) — the state leaves the step declares in
  place (the error-feedback momentum and velocity, the BatchNorm
  statistics) keep their storages; ``alias_coverage`` (the share of all
  state leaves that do) and ``peak_live_bytes`` (a liveness estimate
  over the trace; on the card ``torch.cuda.max_memory_allocated`` too)
  go to ``runs/analysis_report.json`` for ``telemetry/regress.py``.
* **ef-conservation** (DGCV04) — the selection's values reach a wire
  gather (C1), its indices too (C2), and the transmit record or the
  residual write-back depends on them (C3). :class:`ConservationProbe`
  checks the same three bit for bit on the values a step computes (a
  runtime check; on the card, through the kernels).

The taint passes read a dispatch trace, to which the kernels launched
through ctypes on the card are opaque. So DGCV02 and DGCV04 trace the
step on the CPU, where every kernel wrapper runs its plain version, as
the reference traces a jaxpr without running it; the report records
which part ran on which device, and a ``device="cuda"`` run also runs
DGCV01, DGCV03 and the runtime conservation check on the card.

Seeded mutations (``DGC_VERIFY_MUTATE``): ``cast_bf16`` round-trips the
compensated velocity through bf16 (DGCV02 must turn red at that line of
``compression/flat.py``) and ``drop_foldback`` zeroes the transmit record
(DGCV04 must turn red on C3).

Waivers share one mechanism with the lints: ``analysis/allowlist.toml``
entries and inline ``# dgcver: ok[pass-id]`` markers on the source line
a finding names.
"""

import json
import os
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from dgc_tpu_torch.analysis import program as prg
from dgc_tpu_torch.analysis.rules import Allowlist, Finding, load_allowlist

__all__ = ["AxisPolicy", "DEFAULT_POLICY", "DEFAULT_REPORT_PATH",
           "REPORT_SCHEMA", "check_collective_axes", "check_dtype_flow",
           "check_ef_conservation", "check_donation_liveness",
           "ConservationProbe", "run_verify_suite", "VERIFY_CONFIGS",
           "INPLACE_STATE"]

DEFAULT_REPORT_PATH = os.path.join("runs", "analysis_report.json")
REPORT_SCHEMA = "dgc-analysis-report-v1"

#: wire collectives a narrowed (wire-lane) flow may legitimately cross
_WIRE_PRIMS = frozenset({"all-gather", "all-to-all", "reduce-scatter"})

#: sources whose f32 chains the dtype-flow pass protects
_SRC_PREFIX = "dgcver.src."

#: the state leaves the step updates in place (DGCV03)
INPLACE_STATE = ("memory.0.momentums_c", "memory.0.velocities_c",
                 "batch_stats")


@dataclass(frozen=True)
class AxisPolicy:
    """Declared axes + per-axis collective budgets (per step)."""
    allowed: frozenset = frozenset({"data"})
    budgets: Dict[str, int] = field(default_factory=lambda: {"data": 8})


DEFAULT_POLICY = AxisPolicy(
    allowed=frozenset({"data", "hosts", "local"}),
    budgets={"data": 8, "hosts": 8, "local": 4},
)


# --------------------------------------------------------------------- #
# finding plumbing: provenance -> rules.Finding -> shared waivers       #
# --------------------------------------------------------------------- #

_SRC_RE = re.compile(r"^(.*?):(\d+)")


def _mk_finding(pass_id: str, source: str, message: str,
                root: str) -> Finding:
    """Resolve an op's ``file:line (fn)`` provenance into the Finding
    shape the lints emit, so allowlist globs, inline waivers and
    formatting are one mechanism for every layer."""
    path, line, snippet = "", 0, ""
    m = _SRC_RE.match(source or "")
    if m:
        path, line = m.group(1), int(m.group(2))
        full = path if os.path.isabs(path) else os.path.join(root, path)
        try:
            with open(full, "r", encoding="utf-8") as f:
                for i, text in enumerate(f, 1):
                    if i == line:
                        snippet = text.strip()
                        break
        except OSError:
            pass
        try:
            path = os.path.relpath(full, root)
        except ValueError:
            pass
        path = path.replace(os.sep, "/")
    return Finding(rule=pass_id, path=path, line=line, col=0,
                   snippet=snippet, message=message)


def _filter_waived(findings: Sequence[Finding],
                   allowlist: Allowlist) -> List[str]:
    """Formatted messages for the findings that survive waivers."""
    out = []
    for f in findings:
        if f.snippet and Allowlist.inline_waiver(f.snippet, f.rule,
                                                 tool="dgcver"):
            continue
        if allowlist.match(f) is not None:
            continue
        msg = f.format()
        if msg not in out:      # one finding a site, not one a worker
            out.append(msg)
    return out


# --------------------------------------------------------------------- #
# pass 1: collective-axis audit                                         #
# --------------------------------------------------------------------- #

def check_collective_axes(prog: prg.FlatProgram,
                          policy: AxisPolicy = DEFAULT_POLICY,
                          root: str = ".") -> List[Finding]:
    """Every collective must name at least one axis, every named axis
    must be in the policy, and no axis may exceed its budget."""
    findings: List[Finding] = []
    per_axis: Dict[str, int] = {}
    sites = prg.collectives(prog)
    for s in sites:
        if not s.axes:
            findings.append(_mk_finding(
                "collective-axis", s.source,
                f"{s.prim} has no axis label — an unlabelled collective "
                "can't be audited against the AxisPolicy", root))
            continue
        for ax in s.axes:
            per_axis[ax] = per_axis.get(ax, 0) + 1
            if ax not in policy.allowed:
                findings.append(_mk_finding(
                    "collective-axis", s.source,
                    f"{s.prim} runs over undeclared axis {ax!r} "
                    f"(AxisPolicy allows {sorted(policy.allowed)})", root))
    for ax, n in per_axis.items():
        budget = policy.budgets.get(ax)
        if budget is not None and n > budget:
            src = next((s.source for s in sites if ax in s.axes), "")
            findings.append(_mk_finding(
                "collective-axis", src,
                f"axis {ax!r} carries {n} collectives, over its budget "
                f"of {budget} — a new exchange leaked into the step", root))
    return findings


# --------------------------------------------------------------------- #
# pass 2: dtype-flow                                                    #
# --------------------------------------------------------------------- #

def _float_bits(dt) -> int:
    """Float width in bits, 0 for non-floats."""
    if dt is None or not dt.is_floating_point:
        return 0
    return torch.finfo(dt).bits


def _is_truncating(src_dt, dst_dt) -> bool:
    """f32 -> {smaller float, any int}. bool is exempt (predicate
    semantics — comparisons, masks — not a value representation)."""
    if _float_bits(src_dt) < 32 or dst_dt is None:
        return False
    bits = _float_bits(dst_dt)
    if bits:
        return bits < _float_bits(src_dt)
    return dst_dt != torch.bool and not dst_dt.is_complex


def check_dtype_flow(prog: prg.FlatProgram, root: str = ".",
                     ) -> List[Finding]:
    """Truncating casts on f32-source-tainted values must be wire lanes:
    the narrowed flow (followed until widened back to >= f32) has to
    cross a gather. A narrow-then-widen chain that never leaves the
    worker is silent precision loss, not a codec."""
    seeds = set()
    for name, eqns in prg.tags(prog).items():
        if name.startswith(_SRC_PREFIX):
            for e in eqns:
                seeds.update(e.outvars)
    if not seeds:
        return []
    tainted = prg.forward_taint(prog, seeds)

    def _not_rewiden(e: prg.FlatEqn) -> bool:
        dst = e.params.get("dst_dtype")
        return dst is None or _float_bits(dst) < 32

    findings: List[Finding] = []
    for e in prog.eqns:
        src_dt, dst_dt = e.params.get("src_dtype"), e.params.get(
            "dst_dtype")
        if dst_dt is None or not e.invars:
            continue
        if not any(v in tainted for v in e.invars):
            continue
        if not _is_truncating(src_dt, dst_dt):
            continue
        narrow = prg.forward_taint(prog, set(e.outvars),
                                   through=_not_rewiden)
        crosses = any(any(v in narrow for v in c.invars)
                      for c in prog.eqns if c.prim in _WIRE_PRIMS)
        if not crosses:
            findings.append(_mk_finding(
                "dtype-flow", e.source,
                f"truncating cast {src_dt} -> {dst_dt} on an f32-source-"
                "tainted value whose narrowed flow never crosses a "
                "collective — precision silently lost outside a wire "
                "lane", root))
    return findings


# --------------------------------------------------------------------- #
# pass 4: error-feedback conservation                                   #
# --------------------------------------------------------------------- #

def check_ef_conservation(prog: prg.FlatProgram, root: str = ".",
                          descriptor: Optional[Dict] = None,
                          ) -> Tuple[str, List[Finding]]:
    """Returns (status, findings); status ``"ok"``, ``"dense"`` (no sparse
    selection in this step: an all-dense plan or the dense engine,
    trivially conserved) or ``"broken"``. ``descriptor``: a
    ``Plan.verify_descriptor()``; a plan that promises a sparse selection
    must plant one, and an fp32 plan (``eager_foldback=False``) must
    conserve through the transmit record specifically."""
    tag_map = prg.tags(prog)
    sel_v = [v for e in tag_map.get("dgcver.sel_values", ())
             for v in e.outvars]
    sel_i = [v for e in tag_map.get("dgcver.sel_indices", ())
             for v in e.outvars]
    if not sel_v and not sel_i:
        if descriptor and descriptor.get("conservation") == "sparse":
            return "broken", [_mk_finding(
                "ef-conservation", "",
                "plan descriptor promises a sparse selection but the "
                "recorded step plants none — the engine ran the dense "
                "branch against a sparse plan", root)]
        return "dense", []

    findings: List[Finding] = []
    v_taint = prg.forward_taint(prog, sel_v)
    i_taint = prg.forward_taint(prog, sel_i)
    gathers = [e for e in prog.eqns if e.prim in _WIRE_PRIMS]
    sel_src = next((e.source
                    for e in tag_map.get("dgcver.sel_values", ())), "")
    if not any(any(v in v_taint for v in g.invars) for g in gathers):
        findings.append(_mk_finding(
            "ef-conservation", sel_src,
            "C1 broken: no collective input depends on the selected "
            "values — the payload never reaches the wire", root))
    if not any(any(v in i_taint for v in g.invars) for g in gathers):
        findings.append(_mk_finding(
            "ef-conservation", sel_src,
            "C2 broken: no collective input depends on the selected "
            "indices — peers can't place the payload", root))
    bits_in = [v for e in tag_map.get("dgcver.sink.sent_bits", ())
               for v in e.invars]
    resid_in = [v for e in tag_map.get("dgcver.sink.residual", ())
                for v in e.invars]
    bits_src = next((e.source
                     for e in tag_map.get("dgcver.sink.sent_bits", ())),
                    sel_src)
    deferred = any(v in i_taint for v in bits_in)
    eager = any(v in i_taint for v in resid_in)
    if (descriptor is not None
            and not descriptor.get("eager_foldback", True)
            and not deferred):
        findings.append(_mk_finding(
            "ef-conservation", bits_src,
            "C3 broken for an fp32 plan: the transmit record (sent_bits) "
            "does not depend on the selected indices — fp32 regimes "
            "conserve through deferred masking, and that record is the "
            "only fold-back they have", root))
    elif not (deferred or eager):
        findings.append(_mk_finding(
            "ef-conservation", bits_src,
            "C3 broken: neither the transmit record (sent_bits) nor the "
            "residual write-back depends on the selected indices — "
            "untransmitted selection mass is lost instead of folded "
            "back (error feedback no longer conserves)", root))
    return ("ok" if not findings else "broken"), findings


class ConservationProbe:
    """The runtime conservation check: attached to a :class:`~dgc_tpu_
    torch.analysis.program.Recorder` (``probe=``), it copies what the
    anchors report during each step — per worker the selection's input
    (the compensated velocity), its values and indices and the new
    transmit record, the decoded wire of the first receiver, and the
    next step's velocity before its compensate — and :meth:`check` holds
    them bit for bit, for every worker and bucket:

    * C1: the payload's values are the compensated velocity at the
      payload's indices, and the wire carries them;
    * C2: the wire carries the payload's indices;
    * C3: the transmit record's set bits are exactly those indices, and
      every unselected element of the velocity reaches the next step's
      compensate unchanged.

    Call :meth:`begin_step` before each step."""

    _KEEP = ("dgcver.sel_input", "dgcver.sel_values", "dgcver.sel_indices",
             "dgcver.sink.sent_bits", "dgcver.src.residual")

    def __init__(self):
        self.steps: List[Dict[str, List[torch.Tensor]]] = []

    def begin_step(self) -> None:
        self.steps.append({})

    def on_tag(self, name: str, t: torch.Tensor) -> None:
        if not self.steps:
            return
        cur = self.steps[-1]
        if name in ("dgcver.wire_values", "dgcver.wire_indices"):
            if name not in cur:      # the first receiver's copy
                cur[name] = [t.detach().clone()]
        elif name in self._KEEP:
            cur.setdefault(name, []).append(t.detach().clone())

    def check(self, engine, step: int = 0) -> Dict[str, List[str]]:
        """``{"C1": [...], "C2": [...], "C3": [...]}`` violations of step
        ``step`` (C3's velocity half needs step ``step + 1``)."""
        from dgc_tpu_torch.ops import kernels
        T, S = engine.T, engine.layout.sentinel
        cur = self.steps[step]
        nxt = (self.steps[step + 1] if step + 1 < len(self.steps)
               else None)
        out: Dict[str, List[str]] = {"C1": [], "C2": [], "C3": []}
        need = ("dgcver.sel_input", "dgcver.sel_values",
                "dgcver.sel_indices", "dgcver.sink.sent_bits",
                "dgcver.wire_values", "dgcver.wire_indices")
        missing = [k for k in need if k not in cur]
        if missing:
            out["C1"].append(f"step {step}: anchors {missing} never "
                             "reported (the dense branch, or no recorder)")
            return out
        wv = cur["dgcver.wire_values"][0]
        wi = cur["dgcver.wire_indices"][0]
        for w, (vin, vals, idx, bits) in enumerate(zip(
                cur["dgcver.sel_input"], cur["dgcver.sel_values"],
                cur["dgcver.sel_indices"], cur["dgcver.sink.sent_bits"])):
            idx = idx.to(torch.int64)
            # the sentinel (a structural-zero slot inside [0, T)) pads
            valid = (idx >= 0) & (idx < T) & (idx != S)
            at = vin.reshape(-1)[idx.clamp(0, T - 1)].to(vals.dtype)
            want = torch.where(valid, at, torch.zeros_like(at))
            if not _bitwise_equal(vals, want):
                n = int((_bits(vals) != _bits(want)).sum())
                out["C1"].append(f"worker {w}: {n} payload values differ "
                                 "from the compensated velocity at their "
                                 "indices")
            if not _bitwise_equal(wv[w].to(vals.dtype), vals):
                out["C1"].append(f"worker {w}: the wire's values differ "
                                 "from the payload")
            gi = wi[w].to(torch.int64)
            gi = torch.where((gi >= 0) & (gi < T), gi, S)
            if not torch.equal(gi, torch.where(valid, idx, S)):
                out["C2"].append(f"worker {w}: the wire's indices differ "
                                 "from the payload's")
            sel = torch.zeros(T, dtype=torch.bool, device=idx.device)
            sel[idx[valid]] = True
            sent = ~kernels.keep_from_bits(bits, T).to(torch.bool)
            if not torch.equal(sent, sel):
                out["C3"].append(
                    f"worker {w}: the transmit record sets "
                    f"{int(sent.sum())} bits, the payload selects "
                    f"{int(sel.sum())} indices ({int((sent ^ sel).sum())} "
                    "differ)")
            if nxt is not None and "dgcver.src.residual" in nxt:
                v_next = nxt["dgcver.src.residual"][w].reshape(-1)[:T]
                v_now = vin.reshape(-1)[:T]
                if not _bitwise_equal(v_next[~sel], v_now[~sel]):
                    out["C3"].append(f"worker {w}: unselected velocity "
                                     "changed before the next compensate")
        return out


def _bits(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.view(torch.int16)
    return t


def _bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        _bits(a), _bits(b))


# --------------------------------------------------------------------- #
# pass 3: donation / liveness                                           #
# --------------------------------------------------------------------- #

def check_donation_liveness(recorded, inplace: Sequence[str] =
                            INPLACE_STATE, root: str = "."
                            ) -> Tuple[Dict[str, float], List[Finding]]:
    """Returns (metrics, findings) for one recorded step
    (:class:`~dgc_tpu_torch.analysis.contracts.RecordedStep`).
    ``alias_coverage``: the share of the state's leaves that keep their
    storage across the step; ``peak_live_bytes``: the trace's liveness
    estimate. A leaf named (by prefix) in ``inplace`` that got a fresh
    storage is a finding."""
    same = recorded.same
    coverage = sum(same.values()) / max(1, len(same))
    metrics = {"alias_coverage": round(coverage, 4),
               "peak_live_bytes": float(prg.peak_live_bytes(
                   recorded.prog))}
    findings = []
    for k, ok in sorted(same.items()):
        if ok or not any(k == p or k.startswith(p + ".") for p in inplace):
            continue
        findings.append(_mk_finding(
            "donation-liveness", "",
            f"state leaf {k} is declared in place but the step gave it a "
            "fresh storage — both buffers are live across the step", root))
    return metrics, findings


# --------------------------------------------------------------------- #
# the verify suite: every pinned engine configuration                   #
# --------------------------------------------------------------------- #

def _configs():
    """(name, fixture kwargs thunk) for every pinned configuration. The
    port's apply is always one kernel (the reference's ``fused_apply``
    epilogue is its only route), so ``fused_apply`` is the plain build
    and ``megakernel_fused`` the megakernel with the fused selection."""
    def plan_for(reg):
        from dgc_tpu_torch.compression.planner import plan_buckets
        return plan_buckets([], fabric="32x25GbE", world=8,
                            candidates=(reg,))

    def adaptive():
        from dgc_tpu_torch.resilience.adaptive import AdaptiveConfig
        return dict(telemetry=True, fleet=True, adaptive=AdaptiveConfig())

    cfgs = [
        ("plain", lambda: {}),
        ("telemetry", lambda: dict(telemetry=True)),
        ("fused_apply", lambda: {}),
        ("fused_select", lambda: dict(
            compressor_kwargs={"fused_select": True})),
        ("megakernel", lambda: dict(
            compressor_kwargs={"megakernel": True})),
        ("megakernel_fused", lambda: dict(
            compressor_kwargs={"megakernel": True, "fused_select": True})),
        ("fleet", lambda: dict(telemetry=True, fleet=True)),
        ("adaptive", adaptive),
    ]
    for reg in ("fp32", "int8", "int8_packed", "int4_packed",
                "int8_delta_idx", "gossip_ring", "gossip_hcube"):
        cfgs.append((f"planned.{reg}",
                     lambda reg=reg: dict(plan=plan_for(reg))))
    return cfgs


VERIFY_CONFIGS = tuple(name for name, _ in _configs())


def run_verify_suite(log: Callable[[str], None] = None,
                     root: Optional[str] = None, fast: bool = False,
                     allowlist: Optional[Allowlist] = None,
                     policy: AxisPolicy = DEFAULT_POLICY,
                     report_path: Optional[str] = None,
                     device: str = "cpu", variables=None,
                     configs: Optional[Sequence[str]] = None,
                     ) -> List[Tuple[str, List[str]]]:
    """Run the four passes over every pinned config (or ``configs``).

    Returns ``(name, violations)`` pairs like ``run_contract_suite``.
    The taint passes trace each step on the CPU (see the module
    docstring); with ``device="cuda"`` the donation pass and a runtime
    conservation check of the plain config run on the card. ``fast``
    skips the donation pass and the report. The full run writes
    ``runs/analysis_report.json`` under ``root``."""
    from dgc_tpu_torch.analysis.contracts import record_step
    from dgc_tpu_torch.analysis.suite import build_fixture

    say = log or (lambda s: None)
    root = root or os.getcwd()
    allowlist = allowlist if allowlist is not None else load_allowlist()
    results: List[Tuple[str, List[str]]] = []
    report: Dict = {"schema": REPORT_SCHEMA, "configs": {},
                    "devices": {"collective-axis": "cpu",
                                "dtype-flow": "cpu (dispatch trace: the "
                                              "card's ctypes kernels are "
                                              "opaque to it)",
                                "ef-conservation": "cpu (dispatch trace)",
                                "ef-conservation-runtime": device,
                                "donation-liveness": device}}

    for name, kw_thunk in _configs():
        if configs is not None and name not in configs:
            continue
        say(f"verify: {name}")
        try:
            fx = build_fixture(device="cpu", variables=variables,
                               **kw_thunk())
            # a first step builds the engine's lazy caches, so the
            # recorded step is the steady state whatever ran before it
            fx.step(fx.state)
            rec = record_step(fx)
            prog = rec.prog
        except Exception as e:
            results.append((f"verify[{name}]",
                            [f"errored: {type(e).__name__}: {e}"]))
            continue
        eng_plan = getattr(fx.setup.engine, "plan", None)
        desc = (eng_plan.verify_descriptor()
                if eng_plan is not None else None)

        ax = check_collective_axes(prog, policy, root)
        if desc is not None:
            observed = sum(1 for e in prog.eqns if e.prim in _WIRE_PRIMS)
            if observed != desc["gather_lanes"]:
                src = next((s.source for s in prg.collectives(prog)
                            if s.prim in _WIRE_PRIMS), "")
                ax.append(_mk_finding(
                    "collective-axis", src,
                    f"plan descriptor predicts {desc['gather_lanes']} "
                    f"wire-gather lanes but the step runs {observed} — the "
                    "engine's lane construction drifted from "
                    "Plan.num_gathers", root))
        results.append((f"verify[{name}].collective-axis",
                        _filter_waived(ax, allowlist)))
        df = check_dtype_flow(prog, root)
        results.append((f"verify[{name}].dtype-flow",
                        _filter_waived(df, allowlist)))
        status, ef = check_ef_conservation(prog, root, descriptor=desc)
        results.append((f"verify[{name}].ef-conservation",
                        _filter_waived(ef, allowlist)))
        report["configs"][name] = {
            "conservation": status,
            "peak_live_bytes": prg.peak_live_bytes(prog),
            "collectives": sorted(
                f"{s.prim}@{','.join(s.axes)}"
                for s in prg.collectives(prog)),
        }
        if desc is not None:
            report["configs"][name]["plan"] = {
                k: list(v) if isinstance(v, tuple) else v
                for k, v in desc.items()}

    # DGCV03 corollary: the fused hot path may not raise the peak over the
    # unfused build (nothing new may stay live at once)
    plain_cfg = report["configs"].get("plain")
    for mk_name in ("megakernel", "megakernel_fused"):
        mk_cfg = report["configs"].get(mk_name)
        if not (mk_cfg and plain_cfg):
            continue
        viol = []
        if mk_cfg["peak_live_bytes"] > plain_cfg["peak_live_bytes"]:
            viol.append(
                f"fused build's peak_live_bytes "
                f"{mk_cfg['peak_live_bytes']} exceeds the unfused "
                f"build's {plain_cfg['peak_live_bytes']} — the "
                "megakernel path holds an intermediate the staged path "
                "never held live")
        results.append((f"verify[{mk_name}].peak-live-vs-unfused", viol))

    if configs is None or "plain" in configs:
        say(f"verify: plain ef-conservation-runtime ({device})")
        try:
            results.append(("verify[plain].ef-conservation-runtime",
                            _runtime_conservation(device, variables)))
        except Exception as e:
            results.append(("verify[plain].ef-conservation-runtime",
                            [f"errored: {type(e).__name__}: {e}"]))

    if not fast:
        say(f"verify: donation-liveness ({device})")
        try:
            fx = build_fixture(device=device, variables=variables)
            fx.step(fx.state)             # the first step's set-up
            if device != "cpu":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            rec = record_step(fx, trace=device == "cpu")
            if device == "cpu":
                metrics, dn = check_donation_liveness(rec, root=root)
            else:
                torch.cuda.synchronize()
                traced = record_step(build_fixture(variables=variables))
                metrics, dn = check_donation_liveness(
                    rec._replace(prog=traced.prog), root=root)
                metrics["device_peak_bytes"] = float(
                    torch.cuda.max_memory_allocated())
            results.append(("verify[donated].donation-liveness",
                            _filter_waived(dn, allowlist)))
            report.update(metrics)
            report["configs"]["donated"] = {
                "alias_coverage": metrics["alias_coverage"],
                "peak_live_bytes": int(metrics["peak_live_bytes"])}
        except Exception as e:
            results.append(("verify[donated].donation-liveness",
                            [f"errored: {type(e).__name__}: {e}"]))
        path = report_path or os.path.join(root, DEFAULT_REPORT_PATH)
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w", encoding="utf-8") as f:
                json.dump(report, f, indent=1, sort_keys=True)
            say(f"verify: report -> {path}")
        except OSError as e:
            results.append(("verify.report", [f"unwritable: {e}"]))
    return results


def _runtime_conservation(device: str, variables=None) -> List[str]:
    """Two steps of the plain fixture on ``device`` under a
    :class:`ConservationProbe`: C1-C3 of the first step, bit for bit."""
    from dgc_tpu_torch.analysis.suite import build_fixture
    fx = build_fixture(device=device, variables=variables)
    probe = ConservationProbe()
    with prg.Recorder(trace=False, modules=False, probe=probe):
        for _ in range(2):
            probe.begin_step()
            fx.state, _ = fx.step(fx.state)
    got = probe.check(fx.setup.engine, 0)
    return [f"{c}: {m}" for c, ms in got.items() for m in ms]
