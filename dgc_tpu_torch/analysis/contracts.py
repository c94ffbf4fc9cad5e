"""Declarative contracts over recorded steps (layer 2).

Counterpart of ``dgc_tpu/analysis/contracts.py``. A :class:`Contract`
wraps a thunk that records one step (:func:`record_step`, run lazily and
memoized) and checks a set of *expectations* against the record::

    Contract("flat-step", lambda: record_step(fixture)) \\
        .expects(collectives={"all-gather": 2, "all-reduce": 2},
                 forbid_modules=["telemetry/fleet"], no_f64=True) \\
        .enforce()

``check()`` returns a list of violation strings; ``enforce()`` raises
:class:`ContractViolation` listing all of them at once.

Where the reference reads the lowered and compiled program text, a
contract here reads what the step did: the collectives its
:class:`~dgc_tpu_torch.analysis.program.RecordingComm` counted, the op
trace its :class:`~dgc_tpu_torch.analysis.program.Recorder` flattened
(``identical_to`` compares it op for op, as the reference compares bytes),
the Python functions that ran (``forbid_modules`` stands for
``forbid_substrings``), the state's storages before and after the step
(``inplace_state`` stands for donation) and, on the card, the
synchronising calls a profiler window saw (``max_syncs``).

:class:`BuildGuard` is the counterpart of ``RecompileGuard``: eager
PyTorch has no trace cache, so it counts what a second same-shape step
must not repeat — a kernel library build or load
(:mod:`dgc_tpu_torch.ops.build`) and an engine construction.
"""

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import torch

from dgc_tpu_torch.analysis import program as prg

__all__ = ["Contract", "ContractViolation", "RecordedStep", "record_step",
           "state_leaves", "state_storages", "BuildGuard"]


class ContractViolation(AssertionError):
    """One or more contract expectations failed."""

    def __init__(self, name: str, violations: Sequence[str]):
        self.name = name
        self.violations = list(violations)
        bullet = "\n".join(f"  - {v}" for v in self.violations)
        super().__init__(f"contract {name!r}: "
                         f"{len(self.violations)} violation(s)\n{bullet}")


class RecordedStep(NamedTuple):
    """What one recorded step did."""
    prog: prg.FlatProgram              # the op trace (empty untraced)
    collectives: Dict[str, int]        # the comm's counts, JAX names
    functions: Dict[str, int]          # "file:function" -> calls (this
                                       # package's functions)
    #: state leaf -> whether it holds the same storage after the step
    same: Dict[str, bool]
    syncs: Optional[Dict[str, int]]    # card only
    launches: Dict[str, int]           # kernel launches in the step
    #: (synchronising call, innermost enclosing op) of each, card only
    sync_sites: Optional[List] = None


def state_leaves(state) -> Dict[str, torch.Tensor]:
    """``{leaf name: tensor}`` of a :class:`TrainState`'s tensors
    (``params``, ``memory.<w>.<key>``, ``batch_stats.<w>``, ...)."""
    out = {}

    def walk(prefix, x):
        if isinstance(x, torch.Tensor):
            out[prefix] = x
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(f"{prefix}.{k}", v)
        elif isinstance(x, (list, tuple)):
            fields = getattr(x, "_fields", None)
            for i, v in enumerate(x):
                walk(f"{prefix}.{fields[i] if fields else i}", v)
    for name in ("params", "opt_state", "memory", "batch_stats", "guards",
                 "adaptive"):
        walk(name, getattr(state, name, None))
    return out


def state_storages(state) -> Dict[str, object]:
    """``{leaf name: untyped storage}`` of :func:`state_leaves`."""
    return {k: t.untyped_storage() for k, t in state_leaves(state).items()}


def record_step(fixture, trace: bool = True, syncs: bool = False,
                **step_args) -> RecordedStep:
    """Run one step of ``fixture`` (:func:`~dgc_tpu_torch.analysis.suite.
    build_fixture`) under a :class:`~dgc_tpu_torch.analysis.program.
    Recorder`: the op trace (``trace``), the collectives, the functions
    that ran, the state's storages before and after, the kernel launches
    and, with ``syncs`` (the card only), the synchronising calls of a
    second, profiled step."""
    import weakref

    from dgc_tpu_torch.ops import kernels
    comm = fixture.comm
    refs = {k: weakref.ref(s)
            for k, s in state_storages(fixture.state).items()}
    comm.reset()
    kernels.reset_launches()
    rec = prg.Recorder(trace=trace, modules=True)
    with rec:
        fixture.state, _ = fixture.step(fixture.state, **step_args)
        rec.mark_outputs(list(state_leaves(fixture.state).values()))
    launches = dict(kernels.LAUNCHES)
    counts = comm.counts()
    after = state_storages(fixture.state)
    same = {k: r() is not None and r() is after.get(k)
            for k, r in refs.items()}
    sync = sites = None
    if syncs:
        def again():
            fixture.state, _ = fixture.step(fixture.state, **step_args)
        sites = []
        sync = prg.sync_calls(again, where=sites)
    return RecordedStep(rec.prog, counts, rec.prog.functions, same, sync,
                        launches, sites)


def _ran(rec: RecordedStep, fragment: str) -> List[str]:
    """The functions that ran in a file whose path contains ``fragment``
    (``telemetry/fleet``), or, for ``file:function``
    (``ops/kernels.py:apply_rows``), that function of such a file."""
    import os
    frag, _, func = fragment.replace("/", os.sep).partition(":")
    return sorted(k for k in rec.functions
                  if frag in k.rpartition(":")[0]
                  and (not func or k.rpartition(":")[2] == func))


class Contract:
    """A named set of expectations over one recorded step.

    ``record``: a thunk returning a :class:`RecordedStep` (run once, on
    the first check), or ``recorded`` given directly."""

    def __init__(self, name: str,
                 record: Optional[Callable[[], RecordedStep]] = None,
                 recorded: Optional[RecordedStep] = None):
        self.name = name
        self._record = record
        self._recorded = recorded
        self._expectations: List[Callable[[], List[str]]] = []

    @property
    def recorded(self) -> RecordedStep:
        if self._recorded is None:
            self._recorded = self._record()
        return self._recorded

    # -- expectation builders --------------------------------------------
    def expects(self, collectives: Optional[Dict[str, int]] = None,
                collectives_delta=None,
                identical_to: Optional["Contract"] = None,
                forbid_modules: Sequence[str] = (),
                require_modules: Sequence[str] = (),
                no_f64: bool = False,
                inplace_state: Sequence[str] = (),
                max_syncs: Optional[int] = None,
                syncs_delta=None,
                calls: Optional[Dict[str, int]] = None) -> "Contract":
        """Register expectations (chainable; all checked together).

        collectives: exact count per collective op in the step (either
            spelling); ops not named are unconstrained.
        collectives_delta: ``(baseline contract, {op: delta})``.
        identical_to: another contract whose op trace must match op for
            op (the off == never-built pin).
        forbid_modules / require_modules: ``file[:function]`` fragments
            of which no function / at least one function ran.
        no_f64: no float64 value anywhere in the step.
        inplace_state: state leaf-name prefixes (``memory``,
            ``batch_stats``) whose storages after the step must be the
            ones before it.
        max_syncs: most synchronising calls a step may make (the card).
        syncs_delta: ``(baseline contract, n)``: at most ``n`` more
            synchronising calls than the baseline (the card).
        calls: ``{file:function fragment: n}``: exact call counts.
        """
        if collectives is not None:
            want = {prg.normalize_op(k): v for k, v in collectives.items()}
            self._expectations.append(lambda: self._check_collectives(want))
        if collectives_delta is not None:
            base, delta = collectives_delta
            want_d = {prg.normalize_op(k): v for k, v in delta.items()}
            self._expectations.append(
                lambda: self._check_delta(base, want_d))
        if identical_to is not None:
            self._expectations.append(
                lambda: self._check_identical(identical_to))
        for m in forbid_modules:
            self._expectations.append(lambda m=m: self._check_module(m))
        for m in require_modules:
            self._expectations.append(
                lambda m=m: self._check_module(m, forbid=False))
        if no_f64:
            self._expectations.append(self._check_no_f64)
        if inplace_state:
            self._expectations.append(
                lambda: self._check_inplace(tuple(inplace_state)))
        if max_syncs is not None:
            self._expectations.append(lambda: self._check_syncs(max_syncs))
        if syncs_delta is not None:
            self._expectations.append(lambda: self._check_syncs(
                syncs_delta[1], syncs_delta[0]))
        for frag, n in (calls or {}).items():
            self._expectations.append(
                lambda frag=frag, n=n: self._check_calls(frag, n))
        return self

    # -- individual checks ------------------------------------------------
    def _check_collectives(self, want: Dict[str, int]) -> List[str]:
        got = self.recorded.collectives
        return [f"collective {op}: expected {n}, the step ran "
                f"{got.get(op, 0)}"
                for op, n in sorted(want.items()) if got.get(op, 0) != n]

    def _check_delta(self, base: "Contract",
                     delta: Dict[str, int]) -> List[str]:
        mine, theirs = self.recorded.collectives, base.recorded.collectives
        out = []
        for op, d in sorted(delta.items()):
            got = mine.get(op, 0) - theirs.get(op, 0)
            if got != d:
                out.append(f"collective delta {op}: expected "
                           f"{base.name!r}+{d}, got "
                           f"{theirs.get(op, 0)}+{got}")
        return out

    def _check_identical(self, other: "Contract") -> List[str]:
        a, b = self.recorded.prog.text(), other.recorded.prog.text()
        if not a and not b:
            return ["identical_to needs traced steps (record_step("
                    "trace=True)): both op traces are empty"]
        if a == b:
            return []
        return [f"op trace differs from {other.name!r} (must be "
                "identical):\n" + prg.diff_summary(a, b, self.name,
                                                   other.name)]

    def _check_module(self, fragment: str, forbid: bool = True
                      ) -> List[str]:
        ran = _ran(self.recorded, fragment)
        if forbid and ran:
            return [f"forbidden code {fragment!r} ran during the step: "
                    f"{ran[:3]}"]
        if not forbid and not ran:
            return [f"required code {fragment!r} never ran during the "
                    "step"]
        return []

    def _check_no_f64(self) -> List[str]:
        bad = sorted({e.prim for e in self.recorded.prog.eqns
                      if "float64" in e.params.get("sig", "")})
        if not self.recorded.prog.eqns:
            return ["no_f64 needs a traced step"]
        if bad:
            return [f"float64 values in the step (ops {bad[:4]}): the "
                    "pipeline contract is f32/bf16 end to end"]
        return []

    def _check_inplace(self, prefixes) -> List[str]:
        rec = self.recorded
        out = []
        for k, same in rec.same.items():
            if not any(k == p or k.startswith(p + ".") for p in prefixes):
                continue
            if not same:
                out.append(f"state leaf {k} was replaced by a fresh "
                           "storage (the step must update it in place)")
        if not any(any(k == p or k.startswith(p + ".") for p in prefixes)
                   for k in rec.same):
            out.append(f"inplace_state: no state leaf under {prefixes}")
        return out

    def _check_syncs(self, n: int, base: Optional["Contract"] = None
                     ) -> List[str]:
        s = self.recorded.syncs
        if s is None:
            return ["syncs are read on the card only: record the step "
                    "with record_step(..., syncs=True) on a CUDA fixture"]
        got = sum(s.values())
        if base is not None:
            b = base.recorded.syncs
            if b is None:
                return [f"baseline {base.name!r} has no sync count"]
            if got - sum(b.values()) > n:
                return [f"synchronising calls {s} exceed {base.name!r}'s "
                        f"{b} by more than {n}"]
            return []
        if got > n:
            return [f"synchronising calls {s}: more than {n}"]
        return []

    def _check_calls(self, fragment: str, n: int) -> List[str]:
        got = sum(self.recorded.functions[k]
                  for k in _ran(self.recorded, fragment))
        if got != n:
            return [f"calls of {fragment!r}: expected {n}, the step made "
                    f"{got}"]
        return []

    # -- evaluation --------------------------------------------------------
    def check(self) -> List[str]:
        """Run all expectations; return violation strings (empty = pass)."""
        out: List[str] = []
        for exp in self._expectations:
            out.extend(exp())
        return out

    def enforce(self) -> "Contract":
        violations = self.check()
        if violations:
            raise ContractViolation(self.name, violations)
        return self


class BuildGuard:
    """Counts, across a block, the kernel libraries built or loaded
    (``ops.build.build`` calls that compile, new ``ops.build.library``
    loads) and the engines constructed (``FlatDGCEngine`` /
    ``FlatDenseExchange``); on exit asserts at most ``expect`` of them —
    a second same-shape step must repeat none::

        with BuildGuard(expect=0, name="second-step"):
            step(state)
    """

    def __init__(self, expect: int = 0, name: str = ""):
        self.expect = expect
        self.name = name or "build-guard"
        self.events: List[str] = []
        self._saved = []

    def __enter__(self) -> "BuildGuard":
        from dgc_tpu_torch.compression import flat
        from dgc_tpu_torch.ops import build
        self._loaded0 = set(build._loaded)
        real_build = build.build
        events = self.events

        def counted_build(sources=build.SOURCES, verbose=False):
            missing = [s for s in sources if not build._target(s).exists()]
            if missing:
                events.append(f"build {missing}")
            return real_build(sources, verbose)
        self._saved.append((build, "build", real_build))
        build.build = counted_build
        for cls in (flat.FlatDGCEngine, flat.FlatDenseExchange):
            init = cls.__init__

            def counted_init(obj, *a, _init=init, _cls=cls, **k):
                events.append(f"construct {_cls.__name__}")
                return _init(obj, *a, **k)
            self._saved.append((cls, "__init__", init))
            cls.__init__ = counted_init
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        from dgc_tpu_torch.ops import build
        for obj, attr, v in reversed(self._saved):
            setattr(obj, attr, v)
        self._saved = []
        self.events += [f"load {s}" for s in set(build._loaded)
                        - self._loaded0]
        if exc_type is not None:
            return
        if len(self.events) > self.expect:
            raise ContractViolation(
                f"build-guard:{self.name}",
                [f"expected at most {self.expect} build/load/construction "
                 f"event(s), observed {self.events} — a same-shape step "
                 "repeated set-up work"])
