"""A recorded step: the port's counterpart of ``hlo.py`` and ``jaxpr.py``.

The JAX analysis layer reads two texts the compiler gives it: the lowered
StableHLO (op and collective counts, byte identity) and the jaxpr (a
dataflow graph with provenance). Eager PyTorch has neither, so a step is
*recorded* while it runs:

* :class:`RecordingComm` wraps any :class:`~dgc_tpu_torch.parallel.comm.
  Comm` (and the groups its :meth:`split` returns) and counts its
  ``all_gather``, ``all_reduce`` and ``swap`` calls with each call's axis
  label (``data`` for the flat comm; ``local`` and ``hosts`` for the two
  tiers, the JAX ``DEFAULT_POLICY``'s names) and its lane's dtype and
  shape. The calls map to the JAX suite's op names: ``all-gather``,
  ``all-reduce`` and ``collective-permute`` (Adasum's pairwise swap).
* :class:`Recorder` flattens one step into a :class:`FlatProgram` of
  :class:`FlatEqn` through a ``TorchDispatchMode``: every aten op with its
  input and output value ids, dtypes and shapes. Its op lines stand for
  the lowered text (:func:`op_counts`, :func:`diff_summary`, byte
  identity). It also counts the calls of this package's functions (for
  the ``forbid_modules`` contract) and records the ``dgcver.*`` anchors
  the engine reports through :func:`~dgc_tpu_torch.ops.kernels.vtag`.

Value ids follow storages, not tensors: a view shares its base's id, and
an op that writes a tensor (in place, or through ``out=``: the schema's
``alias_info.is_write``) gives that storage a new id whose equation reads
the old one. Storages are keyed by identity and held through weakrefs, so
an address the allocator reuses never inherits a dead storage's taint.
The provenance ``file:line (function)`` (the innermost frame of this
package outside the analysis layer) is taken only at casts, anchors and
collectives, where a pass may report it.

Kernels launched through ctypes on the card are opaque to the dispatch
trace, so the taint passes record the step on the CPU, where every
kernel wrapper runs its plain version (:mod:`~dgc_tpu_torch.analysis.
verify`).

:func:`forward_taint`, :func:`tags`, :func:`collectives` and
:func:`peak_live_bytes` keep ``dgc_tpu/analysis/jaxpr.py``'s names and
meaning over this program.
"""

import difflib
import os
import sys
import threading
import weakref
from dataclasses import dataclass, field
from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Set, Tuple)

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from dgc_tpu_torch.parallel.comm import Comm

__all__ = ["FlatEqn", "FlatProgram", "CollectiveSite", "RecordingComm",
           "Recorder", "collectives", "tags", "forward_taint",
           "peak_live_bytes", "op_counts", "collective_counts",
           "normalize_op", "diff_summary", "sync_calls", "SYNC_CALLS",
           "COLLECTIVE_OPS", "COMM_OPS", "CAST_OPS"]

#: canonical (hyphenated, HLO-style) names of cross-worker collectives
COLLECTIVE_OPS = ("all-gather", "all-reduce", "all-to-all",
                  "collective-permute", "reduce-scatter")

#: ``Comm`` method -> the JAX suite's op name
COMM_OPS = {"all_gather": "all-gather", "all_reduce": "all-reduce",
            "swap": "collective-permute"}

#: the aten ops that change a tensor's dtype (``Tensor.to`` and its
#: shorthands dispatch as ``_to_copy``)
CAST_OPS = frozenset({"aten._to_copy", "aten.copy_"})

#: ops whose outputs do not depend on their tensor inputs' values
_NO_DATA = frozenset({"aten.zeros_like", "aten.ones_like",
                      "aten.empty_like", "aten.full_like",
                      "aten.new_zeros", "aten.new_ones", "aten.new_empty",
                      "aten.new_full", "aten.new_empty_strided",
                      "aten.rand_like", "aten.randn_like"})

#: in-place ops that overwrite every element they write
_OVERWRITE = frozenset({"aten.copy_", "aten.fill_", "aten.zero_"})

#: the host calls that wait for the device (CUDA runtime names)
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")

_PKG = os.sep + "dgc_tpu_torch" + os.sep
_SKIP_FRAMES = (os.sep + "analysis" + os.sep, os.sep + "parallel"
                + os.sep + "comm.py")


def normalize_op(name: str) -> str:
    """'all_gather' / 'all-gather' -> 'all-gather'."""
    return COMM_OPS.get(name, name.split(".")[-1].replace("_", "-"))


@dataclass(frozen=True)
class FlatEqn:
    """One recorded op: name, value ids, params, provenance. ``invars``/
    ``outvars`` are ids into the owning :class:`FlatProgram`'s value
    space."""
    prim: str
    invars: Tuple[int, ...]
    outvars: Tuple[int, ...]
    params: Dict
    source: str          # "path/to/file.py:123 (fn_name)" or ""


@dataclass
class FlatProgram:
    """A recorded step: the op list, the values that existed before it
    (``invars``), those the caller marks live after it (``outvars``), and
    each value's ``(shape, dtype, storage serial, storage bytes)``."""
    eqns: List[FlatEqn] = field(default_factory=list)
    invars: Tuple[int, ...] = ()
    outvars: Tuple[int, ...] = ()
    avals: Dict[int, Tuple] = field(default_factory=dict)
    #: ``"file:function"`` -> calls, for this package's functions that
    #: ran during the step
    functions: Dict[str, int] = field(default_factory=dict)

    def op_lines(self) -> List[str]:
        """One line per op: name, input and output dtypes and shapes —
        the counterpart of the lowered text a byte-identity check
        compares."""
        return [f"{e.prim} {e.params.get('sig', '')}" for e in self.eqns]

    def text(self) -> str:
        return "\n".join(self.op_lines())


@dataclass(frozen=True)
class CollectiveSite:
    """One collective with its axis labels."""
    prim: str
    axes: Tuple[str, ...]
    source: str
    eqn_index: int


# --------------------------------------------------------------------- #
# the recording Comm                                                     #
# --------------------------------------------------------------------- #

class RecordingComm(Comm):
    """A :class:`Comm` that counts its collectives. ``calls`` (by method
    name) and ``sites`` (``(op, axis, lane dtype, lane shape)`` per call)
    are shared with the groups :meth:`split` returns, which are labelled
    ``local`` and ``hosts``. Inside an active :class:`Recorder` each call
    is one collective equation of the program (the ops the wrapped comm
    runs to simulate it are not recorded)."""

    def __init__(self, inner: Comm, axis: str = "data",
                 calls: Optional[Dict[str, int]] = None,
                 sites: Optional[List[Tuple]] = None):
        self.inner = inner
        self.axis = axis
        self.world = inner.world
        self.ranks = inner.ranks
        self.calls = (calls if calls is not None
                      else {name: 0 for name in COMM_OPS})
        self.sites = sites if sites is not None else []

    def _call(self, name: str, xs, *a):
        self.calls[name] += 1
        x0 = xs[0]
        self.sites.append((COMM_OPS[name], self.axis, str(x0.dtype),
                           tuple(x0.shape)))
        run = getattr(self.inner, name)
        rec = Recorder.active
        if rec is None:
            return run(xs, *a)
        return rec.collective(COMM_OPS[name], self.axis, xs,
                              lambda: run(xs, *a))

    def all_gather(self, xs):
        return self._call("all_gather", xs)

    def all_reduce(self, xs):
        return self._call("all_reduce", xs)

    def swap(self, xs, d):
        return self._call("swap", xs, d)

    def split(self, local_size):
        local, cross = self.inner.split(local_size)
        return (RecordingComm(local, "local", self.calls, self.sites),
                RecordingComm(cross, "hosts", self.calls, self.sites))

    def reset(self) -> None:
        for k in self.calls:
            self.calls[k] = 0
        del self.sites[:]

    def counts(self, axis: Optional[str] = None) -> Dict[str, int]:
        """Collective counts in the JAX suite's names, zero-filled, over
        every axis or one."""
        out = {op: 0 for op in COLLECTIVE_OPS}
        for op, ax, _, _ in self.sites:
            if axis is None or ax == axis:
                out[op] += 1
        return out


# --------------------------------------------------------------------- #
# the recorder                                                           #
# --------------------------------------------------------------------- #

def _frame_source(frame) -> str:
    """``file:line (function)`` of the innermost frame of this package
    outside the analysis layer and the comm wrapper."""
    f = frame
    while f is not None:
        fn = f.f_code.co_filename
        if _PKG in fn and not any(s in fn for s in _SKIP_FRAMES) and not (
                fn.endswith("kernels.py") and f.f_code.co_name == "vtag"):
            return f"{fn}:{f.f_lineno} ({f.f_code.co_name})"
        f = f.f_back
    return ""


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _sig(ts: Sequence[torch.Tensor]) -> str:
    return ",".join(f"{str(t.dtype)[6:]}{list(t.shape)}" for t in ts)


class _Mode(TorchDispatchMode):
    def __init__(self, rec: "Recorder"):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        rec = self.rec
        if rec.paused:
            return func(*args, **kwargs)
        schema = func._schema
        ins = _tensors((args, kwargs))
        written: List[torch.Tensor] = []
        for i, a in enumerate(schema.arguments):
            if a.alias_info is None or not a.alias_info.is_write:
                continue
            v = (kwargs.get(a.name) if a.kwarg_only or i >= len(args)
                 else args[i])
            written.extend(_tensors(v))
        name = f"aten.{func._opname}"
        in_ids = [] if name in _NO_DATA else [rec.vid(t) for t in ins]
        if name in _OVERWRITE and written and all(
                w.numel() * w.element_size() == w.untyped_storage().nbytes()
                for w in written):
            # a whole storage overwritten: its old value is not an input
            old = {rec.vid(w) for w in written}
            keep = [t for t in ins if not any(t is w for w in written)]
            in_ids = [i for i in in_ids
                      if i not in old or any(rec.vid(t) == i for t in keep)]
        out = func(*args, **kwargs)
        outs = _tensors(out)
        out_ids = [rec.write(w) for w in written]
        wst = {id(w.untyped_storage()) for w in written}
        for t in outs:
            if id(t.untyped_storage()) in wst:
                continue
            if rec.known(t):
                out_ids.append(rec.vid(t))    # a view: same storage
            else:
                out_ids.append(rec.vid(t, fresh=True))
        params = {"sig": f"{_sig(ins)}->{_sig(outs)}"}
        src = ""
        if (name in CAST_OPS and ins and outs
                and outs[-1].dtype != ins[0].dtype):
            params["src_dtype"] = ins[-1].dtype if name == "aten.copy_" \
                else ins[0].dtype
            params["dst_dtype"] = outs[-1].dtype
            src = _frame_source(sys._getframe(1))
        rec.prog.eqns.append(FlatEqn(name, tuple(in_ids), tuple(out_ids),
                                     params, src))
        return out


class Recorder:
    """Records what a block of code does to tensors (see the module
    docstring). ``trace``: flatten every aten op into :attr:`prog`;
    ``modules``: count the calls of this package's Python functions
    (``sys.monitoring``'s function-start events, each other code object
    switched off at its first call); ``probe``: an object whose
    ``on_tag(name, tensor)`` sees every anchor (the runtime conservation
    check). Use as a context manager; one recorder at a time."""

    #: the recorder inside whose block the code runs, or None
    active: Optional["Recorder"] = None

    def __init__(self, trace: bool = True, modules: bool = True,
                 probe=None):
        self.trace = trace
        self.modules = modules
        self.probe = probe
        self.prog = FlatProgram()
        self.paused = False
        self._next = 0
        #: id(storage) -> (weakref to it, current value id, serial)
        self._ids: Dict[int, Tuple[weakref.ref, int, int]] = {}
        self._invars: List[int] = []
        self._mode = None
        self._tool = None
        self._thread = None

    # -- value ids -------------------------------------------------------
    def known(self, t: torch.Tensor) -> bool:
        s = t.untyped_storage()
        e = self._ids.get(id(s))
        return e is not None and e[0]() is s

    def vid(self, t: torch.Tensor, fresh: bool = False) -> int:
        """The current value id of ``t``'s storage; a storage first seen
        here (not made by a recorded op) is an input of the program."""
        s = t.untyped_storage()
        e = self._ids.get(id(s))
        if e is not None and e[0]() is s and not fresh:
            return e[1]
        v = self._new(t, s)
        if not fresh:
            self._invars.append(v)
        return v

    def write(self, t: torch.Tensor) -> int:
        """A new value id for ``t``'s storage (its contents changed)."""
        return self._new(t, t.untyped_storage())

    def _new(self, t: torch.Tensor, s) -> int:
        v = self._next
        self._next += 1
        e = self._ids.get(id(s))
        # a storage's serial is its first value id (``id(s)`` is reused
        # once a storage dies)
        serial = e[2] if e is not None and e[0]() is s else v
        self._ids[id(s)] = (weakref.ref(s), v, serial)
        self.prog.avals[v] = (tuple(t.shape), t.dtype, serial, s.nbytes())
        return v

    # -- anchors and collectives ---------------------------------------
    def tag(self, x, name: str) -> None:
        for t in _tensors(x):
            if self.probe is not None:
                self.probe.on_tag(name, t)
            if self.trace:
                v = self.vid(t)
                self.prog.eqns.append(FlatEqn(
                    "name", (v,), (v,), {"name": name},
                    _frame_source(sys._getframe(1))))

    def collective(self, op: str, axis: str, xs, run: Callable):
        if not self.trace:
            return run()
        in_ids = [self.vid(t) for t in _tensors(xs)]
        src = _frame_source(sys._getframe(1))
        self.paused = True
        try:
            out = run()
        finally:
            self.paused = False
        out_ids = []
        seen = set()
        for t in _tensors(out):
            if id(t) in seen:
                continue
            seen.add(id(t))
            out_ids.append(self.vid(t, fresh=not self.known(t)))
        self.prog.eqns.append(FlatEqn(
            op, tuple(in_ids), tuple(out_ids),
            {"axes": (axis,), "sig": f"{_sig(_tensors(xs)[:1])}@{axis}"},
            src))
        return out

    def mark_outputs(self, x) -> None:
        """The values live after the block (the state the step returns)."""
        self.prog.outvars = tuple(self.vid(t) for t in _tensors(x))

    # -- activation ------------------------------------------------------
    def _on_start(self, code, offset):
        fn = code.co_filename
        if _PKG not in fn:
            return sys.monitoring.DISABLE
        if threading.get_ident() != self._thread:
            return None                  # the events are process-wide
        key = f"{fn}:{code.co_name}"
        funcs = self.prog.functions
        funcs[key] = funcs.get(key, 0) + 1
        return None

    def _start_monitoring(self) -> None:
        mon = sys.monitoring
        self._thread = threading.get_ident()
        self._tool = next(i for i in (5, 4, 3) if mon.get_tool(i) is None)
        mon.use_tool_id(self._tool, "dgc_tpu_torch.analysis")
        mon.register_callback(self._tool, mon.events.PY_START,
                              self._on_start)
        mon.restart_events()
        mon.set_events(self._tool, mon.events.PY_START)

    def _stop_monitoring(self) -> None:
        mon = sys.monitoring
        mon.set_events(self._tool, 0)
        mon.register_callback(self._tool, mon.events.PY_START, None)
        mon.free_tool_id(self._tool)
        self._tool = None

    def __enter__(self) -> "Recorder":
        from dgc_tpu_torch.ops import kernels
        if Recorder.active is not None:
            raise RuntimeError("a Recorder is already active")
        Recorder.active = self
        kernels.VTAG_RECORDER = self
        if self.trace:
            self._mode = _Mode(self)
            self._mode.__enter__()
        if self.modules:
            self._start_monitoring()
        return self

    def __exit__(self, *exc) -> None:
        from dgc_tpu_torch.ops import kernels
        if self._tool is not None:
            self._stop_monitoring()
        if self._mode is not None:
            self._mode.__exit__(*exc)
            self._mode = None
        kernels.VTAG_RECORDER = None
        Recorder.active = None
        self.prog.invars = tuple(self._invars)



# --------------------------------------------------------------------- #
# passes' helpers (jaxpr.py's names)                                     #
# --------------------------------------------------------------------- #

def collectives(prog: FlatProgram) -> List[CollectiveSite]:
    """Every collective equation with its axis labels, in program order."""
    return [CollectiveSite(e.prim, tuple(e.params.get("axes", ())),
                           e.source, i)
            for i, e in enumerate(prog.eqns) if e.prim in COLLECTIVE_OPS]


def tags(prog: FlatProgram) -> Dict[str, List[FlatEqn]]:
    """Anchor equations by tag name (``dgcver.*``, planted through
    ``kernels.vtag``)."""
    out: Dict[str, List[FlatEqn]] = {}
    for e in prog.eqns:
        if e.prim == "name":
            out.setdefault(str(e.params.get("name", "")), []).append(e)
    return out


def forward_taint(prog: FlatProgram, seeds: Iterable[int],
                  through: Optional[Callable[[FlatEqn], bool]] = None,
                  ) -> Set[int]:
    """Forward reachability from ``seeds`` (value ids). ``through(eqn)``
    — when given, an equation only propagates taint from its inputs to
    its outputs if the predicate holds. The program is in execution
    order and value ids are never reused, so one pass reaches the
    fixpoint."""
    tainted: Set[int] = set(seeds)
    for e in prog.eqns:
        if through is not None and not through(e):
            continue
        if any(v in tainted for v in e.invars):
            tainted.update(e.outvars)
    return tainted


def peak_live_bytes(prog: FlatProgram) -> int:
    """Linear-scan liveness estimate over the recorded op list, by
    storage: a storage is live from the op that makes it (inputs from
    entry) to the last op that reads or writes any of its values
    (outputs to the end); the peak is the largest sum of live storages'
    bytes. A config-comparable estimate, as the reference's is: a doubled
    peak means a buffer stayed live that the plain build frees."""
    first: Dict[int, int] = {}
    last: Dict[int, int] = {}
    size: Dict[int, int] = {}
    n = len(prog.eqns)
    for v in prog.invars:
        sk = prog.avals[v][2]
        first[sk] = -1
        size[sk] = prog.avals[v][3]
    for i, e in enumerate(prog.eqns):
        for v in e.invars + e.outvars:
            sk = prog.avals[v][2]
            first.setdefault(sk, i)
            last[sk] = i
            size[sk] = prog.avals[v][3]
    for v in prog.outvars:
        last[prog.avals[v][2]] = n
    delta = [0] * (n + 3)
    for sk, f in first.items():
        delta[f + 1] += size[sk]
        delta[last.get(sk, f) + 2] -= size[sk]
    peak = cur = 0
    for d in delta:
        cur += d
        peak = max(peak, cur)
    return int(peak)


def op_counts(prog: FlatProgram) -> Dict[str, int]:
    """Histogram of the recorded ops (collectives in their hyphenated
    names)."""
    counts: Dict[str, int] = {}
    for e in prog.eqns:
        counts[e.prim] = counts.get(e.prim, 0) + 1
    return counts


def collective_counts(prog: FlatProgram) -> Dict[str, int]:
    """Counts of just the collectives (zero-filled)."""
    counts = op_counts(prog)
    return {op: counts.get(op, 0) for op in COLLECTIVE_OPS}


def diff_summary(a: str, b: str, label_a: str = "a", label_b: str = "b",
                 context: int = 2, max_lines: int = 40) -> str:
    """Small unified diff for contract failure messages."""
    lines = list(difflib.unified_diff(
        a.splitlines(), b.splitlines(), fromfile=label_a, tofile=label_b,
        n=context, lineterm=""))
    if len(lines) > max_lines:
        lines = lines[:max_lines] + [f"... ({len(lines) - max_lines} more)"]
    return "\n".join(lines)


def sync_calls(fn: Callable[[], object],
               where: Optional[List[Tuple[str, str]]] = None
               ) -> Dict[str, int]:
    """Run ``fn`` on the card under the profiler: the synchronising calls
    (:data:`SYNC_CALLS`) the calling thread made inside it, by name.
    ``where``: a list that receives ``(call, innermost enclosing op)`` for
    each of them."""
    import json
    import tempfile

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function("analysis.sync_window"):
                fn()
            torch.cuda.synchronize()
        path = os.path.join(d, "t.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    win = [e for e in events if e.get("name") == "analysis.sync_window"
           and e.get("cat") == "user_annotation"]
    if len(win) != 1:
        raise RuntimeError(f"the profiler window: {len(win)} ranges")
    tid, t0 = win[0]["tid"], float(win[0]["ts"])
    t1 = t0 + float(win[0]["dur"])
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and e.get("tid") == tid]
    out: Dict[str, int] = {}
    for e in events:
        if (e.get("cat") == "cuda_runtime" and e.get("tid") == tid
                and e.get("name") in SYNC_CALLS
                and t0 <= float(e["ts"]) <= t1):
            out[e["name"]] = out.get(e["name"], 0) + 1
            if where is not None:
                ts = float(e["ts"])
                inside = [o for o in ops if float(o["ts"]) <= ts
                          <= float(o["ts"]) + float(o.get("dur", 0))]
                where.append((e["name"], max(
                    inside, key=lambda o: float(o["ts"]))["name"]
                    if inside else ""))
    return out
