"""Visitor-based AST linter for the step's hot path (layer 1).

Counterpart of ``dgc_tpu/analysis/astlint.py``. Pure ``ast`` work — no
torch import, so the whole tree lints in milliseconds. Two analyses feed
the rules:

**Hot-path inference.** Where the JAX linter infers *traced scope* from
jit decorators and tracing combinators, eager PyTorch has no trace: the
scope that must not stall is the train step itself. A function is *hot*
if it is one of the declared roots (:data:`HOT_ROOTS`: the flat and
per-tensor train steps, the engines' ``exchange``, the gossip round), if
its ``def`` line carries a ``# dgclint: hot`` marker (fixtures use it),
or if it is reachable from a hot function through the module-set call
graph (bare-name calls, method-name calls, and function references
passed as arguments). Name-based matching over-approximates on purpose:
it is cheap, never misses a real hazard, and the same-name host function
it pulls in is exactly what the audited allowlist is for.

**Taint.** Within a hot function, parameters (minus ``self``/``cls``,
parameters annotated ``int``/``bool``/``str``/``float`` and parameters
with a bool/str default) may hold tensors; taint propagates through
assignments, arithmetic and calls. Shape/dtype/device attribute reads,
``numel()``/``dim()``/``size()``, ``is``/``is not`` comparisons and
``isinstance``/``len`` are host values and neutralise taint — so ``if x
is None`` and ``if g.shape[0] == n`` stay clean while ``if torch.any(x)``
and ``float(loss)`` fire.
"""

import ast
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from dgc_tpu_torch.analysis.rules import Allowlist, Finding, load_allowlist

__all__ = ["lint_paths", "lint_source", "collect_files", "DEFAULT_ROOTS",
           "HOT_ROOTS", "hot_functions"]

#: default lint roots, relative to the repo root
DEFAULT_ROOTS = ("dgc_tpu_torch",)

#: the step's hot path: ``<path suffix>::<qualified name>``
HOT_ROOTS = (
    "training/step.py::train_step",
    "training/step.py::train_step_per_tensor",
    "compression/flat.py::FlatDGCEngine.exchange",
    "compression/flat.py::FlatDenseExchange.exchange",
    "compression/gossip.py::round_state",
    "compression/gossip.py::row_weights",
)

_HOT_MARK = re.compile(r"#\s*dgclint:\s*hot\b")

#: attribute reads that are host metadata of a tensor (or of a Comm)
_NEUTRAL_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                  "itemsize", "requires_grad", "world", "ranks"}

#: methods returning host values even on a tensor
_NEUTRAL_METHODS = {"numel", "dim", "size", "element_size", "stride",
                    "is_contiguous", "data_ptr", "get_device",
                    "is_floating_point", "nbytes"}

#: torch.* calls returning host values
_NEUTRAL_TORCH_CALLS = {"device", "finfo", "iinfo", "is_tensor",
                        "is_available", "get_default_dtype", "Size",
                        "Generator", "get_num_threads", "device_count",
                        "is_initialized", "current_device",
                        "get_device_name", "promote_types", "result_type",
                        "can_cast", "is_grad_enabled"}

#: builtins whose result is static even on tensor args
_NEUTRAL_BUILTINS = {"len", "isinstance", "hasattr", "getattr", "type",
                     "repr", "str", "id", "callable", "set", "frozenset",
                     "range", "enumerate", "zip", "sorted"}

#: module roots whose calls produce tensors
_ARRAY_MODULES = {"torch", "F"}

_STATIC_ANNOTATIONS = {"int", "bool", "str", "float", "bytes"}

_STEP_CALL_RE = re.compile(r"(^|_)(step|eval)(_fn)?$")

#: torch RNG entry points: those without a ``generator=`` keyword draw
#: from the global generator
_TORCH_RNG = {"rand", "randn", "randint", "randperm", "normal",
              "bernoulli", "multinomial", "poisson", "rand_like",
              "randn_like", "randint_like"}
_TENSOR_RNG = {"uniform_", "normal_", "bernoulli_", "random_",
               "exponential_", "geometric_", "cauchy_", "log_normal_"}

#: host reads of a tensor
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")


def _terminal_name(node: ast.AST) -> Optional[str]:
    """`a.b.c` -> 'c'; `name` -> 'name'; else None."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _root_name(node: ast.AST) -> Optional[str]:
    """`a.b.c` -> 'a'; `name` -> 'name'; else None."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _dotted_parts(node: ast.AST) -> List[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return parts[::-1]


def _is_static_annotation(ann: Optional[ast.AST]) -> bool:
    """int/bool/str/float (optionally Optional[...]-wrapped) params hold
    host values, not tensors."""
    if ann is None:
        return False
    if isinstance(ann, ast.Name):
        return ann.id in _STATIC_ANNOTATIONS
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value.strip() in _STATIC_ANNOTATIONS
    if isinstance(ann, ast.Subscript):
        if _terminal_name(ann.value) in ("Optional", "Union"):
            inner = ann.slice
            elts = inner.elts if isinstance(inner, ast.Tuple) else [inner]
            return all(
                _is_static_annotation(e)
                or (isinstance(e, ast.Constant) and e.value is None)
                for e in elts)
    return False


class _FuncInfo:
    __slots__ = ("key", "qual", "name", "node", "path", "calls", "hot")

    def __init__(self, key, qual, name, node, path):
        self.key = key
        self.qual = qual
        self.name = name
        self.node = node
        self.path = path
        self.calls: Set[str] = set()   # names this function invokes/passes
        self.hot = False


class _Module:
    def __init__(self, path: str, tree: ast.Module, lines: List[str]):
        self.path = path
        self.tree = tree
        self.lines = lines
        self.functions: List[_FuncInfo] = []


# --------------------------------------------------------------------- #
# pass 1: function collection + hot-path inference                       #
# --------------------------------------------------------------------- #

def _collect_functions(mod: _Module) -> None:
    path = mod.path

    def visit(node, qual):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{qual}{child.name}"
                mod.functions.append(_FuncInfo(f"{path}::{q}", q,
                                               child.name, child, path))
                visit(child, f"{q}.")
            elif isinstance(child, ast.ClassDef):
                visit(child, f"{qual}{child.name}.")
            else:
                visit(child, qual)

    visit(mod.tree, "")


def _marked_hot(mod: _Module, fn: ast.AST) -> bool:
    """A ``# dgclint: hot`` comment on the ``def`` line (or a decorator
    line) makes the function a hot root."""
    lines = [fn.lineno] + [d.lineno for d in fn.decorator_list]
    return any(0 < ln <= len(mod.lines) and _HOT_MARK.search(
        mod.lines[ln - 1]) for ln in lines)


def _is_root(info: _FuncInfo, roots: Sequence[str]) -> bool:
    for r in roots:
        suffix, _, qual = r.partition("::")
        if info.qual == qual and (info.path == suffix
                                  or info.path.endswith("/" + suffix)):
            return True
    return False


def _function_edges(info: _FuncInfo, own_names: Set[str]) -> None:
    """Names ``info`` calls or passes as function references (excluding
    nested defs, which are their own nodes)."""
    nested = {id(n) for child in ast.iter_child_nodes(info.node)
              for n in ast.walk(child)
              if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
              and n is not info.node}

    for sub in ast.walk(info.node):
        if id(sub) in nested and sub is not info.node:
            continue
        if isinstance(sub, ast.Call):
            name = _terminal_name(sub.func)
            if name:
                info.calls.add(name)
            for arg in list(sub.args) + [k.value for k in sub.keywords]:
                ref = _terminal_name(arg)
                if ref and ref in own_names:
                    info.calls.add(ref)


def _seed_hot(modules: Sequence[_Module], roots: Sequence[str]) -> None:
    by_name: Dict[str, List[_FuncInfo]] = {}
    for mod in modules:
        for f in mod.functions:
            by_name.setdefault(f.name, []).append(f)
    for mod in modules:
        for f in mod.functions:
            if _is_root(f, roots) or _marked_hot(mod, f.node):
                f.hot = True
    own_names = set(by_name)
    for mod in modules:
        for f in mod.functions:
            _function_edges(f, own_names)
    changed = True
    while changed:
        changed = False
        for mod in modules:
            for f in mod.functions:
                if not f.hot:
                    continue
                for callee in f.calls:
                    for g in by_name.get(callee, ()):
                        if not g.hot:
                            g.hot = True
                            changed = True


# --------------------------------------------------------------------- #
# taint                                                                  #
# --------------------------------------------------------------------- #

class _Taint:
    """Sequential forward taint over one function body (no CFG: joins are
    union-by-walk-order, which over-approximates — fine for a linter)."""

    def __init__(self, fn: ast.AST):
        self.names: Set[str] = set()
        args = fn.args
        # params with a bool/str literal default are config flags
        static_by_default: Set[str] = set()
        pos = args.posonlyargs + args.args
        for a, d in zip(pos[len(pos) - len(args.defaults):], args.defaults):
            if isinstance(d, ast.Constant) and isinstance(d.value,
                                                          (bool, str)):
                static_by_default.add(a.arg)
        for a, d in zip(args.kwonlyargs, args.kw_defaults):
            if isinstance(d, ast.Constant) and isinstance(d.value,
                                                          (bool, str)):
                static_by_default.add(a.arg)
        for a in (pos + args.kwonlyargs
                  + ([args.vararg] if args.vararg else [])
                  + ([args.kwarg] if args.kwarg else [])):
            if a.arg in ("self", "cls") or a.arg in static_by_default:
                continue
            if _is_static_annotation(a.annotation):
                continue
            self.names.add(a.arg)

    # -- expression taint ------------------------------------------------
    def expr(self, e: ast.AST) -> bool:
        if e is None or isinstance(e, (ast.Constant, ast.Lambda)):
            return False
        if isinstance(e, ast.Name):
            return e.id in self.names
        if isinstance(e, ast.Attribute):
            if e.attr in _NEUTRAL_ATTRS:
                return False
            return self.expr(e.value)
        if isinstance(e, ast.Call):
            name = _terminal_name(e.func)
            if name in _NEUTRAL_BUILTINS and isinstance(e.func, ast.Name):
                return False
            if name in _NEUTRAL_METHODS and isinstance(e.func,
                                                       ast.Attribute):
                return False
            root = _root_name(e.func)
            if root in _ARRAY_MODULES:
                return name not in _NEUTRAL_TORCH_CALLS
            if self.expr(e.func):
                return True
            return any(self.expr(a) for a in e.args) or any(
                self.expr(k.value) for k in e.keywords)
        if isinstance(e, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in e.ops):
                return False
            return self.expr(e.left) or any(self.expr(c)
                                            for c in e.comparators)
        if isinstance(e, ast.BoolOp):
            return any(self.expr(v) for v in e.values)
        if isinstance(e, ast.BinOp):
            return self.expr(e.left) or self.expr(e.right)
        if isinstance(e, ast.UnaryOp):
            return self.expr(e.operand)
        if isinstance(e, ast.Subscript):
            return self.expr(e.value) or self.expr(e.slice)
        if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
            return any(self.expr(v) for v in e.elts)
        if isinstance(e, ast.Dict):
            return any(self.expr(v) for v in e.values if v is not None)
        if isinstance(e, ast.IfExp):
            return (self.expr(e.test) or self.expr(e.body)
                    or self.expr(e.orelse))
        if isinstance(e, ast.Starred):
            return self.expr(e.value)
        if isinstance(e, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            return any(self.expr(g.iter) for g in e.generators) or \
                self.expr(e.elt)
        if isinstance(e, ast.DictComp):
            return any(self.expr(g.iter) for g in e.generators) or \
                self.expr(e.key) or self.expr(e.value)
        if isinstance(e, ast.JoinedStr):
            return any(self.expr(v) for v in e.values)
        if isinstance(e, ast.FormattedValue):
            return self.expr(e.value)
        if isinstance(e, ast.Slice):
            return any(self.expr(x) for x in (e.lower, e.upper, e.step)
                       if x is not None)
        if isinstance(e, ast.NamedExpr):
            t = self.expr(e.value)
            if t and isinstance(e.target, ast.Name):
                self.names.add(e.target.id)
            return t
        return False

    # -- statement walk --------------------------------------------------
    def mark_target(self, t: ast.AST) -> None:
        if isinstance(t, ast.Name):
            self.names.add(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                self.mark_target(e)
        elif isinstance(t, ast.Starred):
            self.mark_target(t.value)

    def feed(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, ast.Assign) and self.expr(stmt.value):
            for t in stmt.targets:
                self.mark_target(t)
        elif isinstance(stmt, ast.AugAssign) and (
                self.expr(stmt.value) or self.expr(stmt.target)):
            self.mark_target(stmt.target)
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None \
                and self.expr(stmt.value):
            self.mark_target(stmt.target)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)) \
                and self.expr(stmt.iter):
            self.mark_target(stmt.target)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                if item.optional_vars is not None \
                        and self.expr(item.context_expr):
                    self.mark_target(item.optional_vars)


# --------------------------------------------------------------------- #
# pass 2: rule checks                                                    #
# --------------------------------------------------------------------- #

def _is_f64_node(a: ast.AST) -> bool:
    return ((isinstance(a, ast.Constant) and a.value == "float64")
            or (isinstance(a, ast.Attribute)
                and a.attr in ("float64", "double")))


class _FileLinter:
    def __init__(self, mod: _Module, findings: List[Finding]):
        self.mod = mod
        self.findings = findings

    def emit(self, rule: str, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", 1)
        snippet = (self.mod.lines[line - 1].strip()
                   if 0 < line <= len(self.mod.lines) else "")
        if Allowlist.inline_waiver(snippet, rule):
            return
        self.findings.append(Finding(
            rule=rule, path=self.mod.path, line=line,
            col=getattr(node, "col_offset", 0), snippet=snippet,
            message=message))

    # -- whole-module rules (taint-free) --------------------------------
    def lint_module_wide(self) -> None:
        for node in ast.walk(self.mod.tree):
            if isinstance(node, ast.Attribute) and node.attr in (
                    "float64", "double") and _root_name(node) in (
                    "np", "numpy", "torch"):
                self.emit("f64-dtype", node,
                          f"{_root_name(node)}.{node.attr} in a pipeline "
                          "whose contract is f32 end to end")
            elif isinstance(node, ast.Call):
                self._check_call_f64(node)

    def _check_call_f64(self, call: ast.Call) -> None:
        func = call.func
        name = _terminal_name(func)
        if isinstance(func, ast.Attribute) and name == "double" \
                and not call.args:
            self.emit("f64-dtype", call,
                      ".double() casts to float64 (pin f32/bf16 "
                      "explicitly)")
            return
        str_f64 = any(isinstance(a, ast.Constant) and a.value == "float64"
                      for a in call.args)
        float_arg = any(isinstance(a, ast.Name) and a.id == "float"
                        for a in call.args)
        kw_f64 = any(
            k.arg == "dtype" and (
                (isinstance(k.value, ast.Constant)
                 and k.value.value == "float64")
                or (isinstance(k.value, ast.Name)
                    and k.value.id == "float"))
            for k in call.keywords)
        if (name in ("astype", "to", "type") and (str_f64 or float_arg)) \
                or kw_f64:
            self.emit("f64-dtype", call,
                      "float64 dtype literal (astype(float) / "
                      "dtype=float is float64; pin f32/bf16 explicitly)")

    # -- hot-path rules -------------------------------------------------
    def lint_hot_function(self, fn: ast.AST) -> None:
        taint = _Taint(fn)
        nested = [n for n in ast.walk(fn)
                  if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                  and n is not fn]
        skip = {id(x) for n in nested for x in ast.walk(n)}
        for node in ast.walk(fn):
            if id(node) in skip:
                continue
            if isinstance(node, ast.stmt):
                taint.feed(node)
            if isinstance(node, (ast.If, ast.While)):
                if taint.expr(node.test):
                    self.emit("tracer-branch", node,
                              "Python branch on a tensor-valued test in "
                              "the hot path — a host sync on the card; use "
                              "torch.where or hoist the condition to "
                              "static config")
            elif isinstance(node, ast.Assert):
                if taint.expr(node.test):
                    self.emit("tracer-branch", node,
                              "assert on a tensor value in the hot path — "
                              "a host sync on the card; check a static "
                              "precondition instead")
            elif isinstance(node, ast.IfExp):
                if taint.expr(node.test):
                    self.emit("tracer-branch", node,
                              "conditional expression on a tensor test in "
                              "the hot path — use torch.where")
            elif isinstance(node, ast.Call):
                self._check_hot_call(node, taint)

    def _check_hot_call(self, call: ast.Call, taint: _Taint) -> None:
        func = call.func
        name = _terminal_name(func)
        root = _root_name(func)
        parts = _dotted_parts(func)
        arg0 = call.args[0] if call.args else None

        if isinstance(func, ast.Name) and func.id in ("float", "int",
                                                      "bool"):
            if arg0 is not None and taint.expr(arg0):
                self.emit("host-sync", call,
                          f"{func.id}() of a tensor waits for every kernel "
                          "queued before it (a host sync in the hot path)")
            return
        if isinstance(func, ast.Attribute):
            if func.attr in _SYNC_METHODS and taint.expr(func.value):
                self.emit("host-sync", call,
                          f".{func.attr}() of a tensor in the hot path is "
                          "a host sync")
                return
            if func.attr in ("asarray", "array") and root in (
                    "np", "numpy") and arg0 is not None \
                    and taint.expr(arg0):
                self.emit("host-sync", call,
                          f"np.{func.attr} of a tensor copies it to the "
                          "host in the hot path")
                return
            if func.attr == "synchronize":
                self.emit("host-sync", call,
                          f"{'.'.join(parts) or 'synchronize'}() in the "
                          "hot path waits for the device")
                return
        if isinstance(func, ast.Name) and func.id == "print":
            if any(taint.expr(a) for a in call.args) or any(
                    taint.expr(k.value) for k in call.keywords):
                self.emit("host-sync", call,
                          "print() of a tensor in the hot path copies it "
                          "to the host")
            return

        # host entropy
        has_gen = any(k.arg == "generator" for k in call.keywords)
        if parts[:1] == ["time"] and name in ("time", "perf_counter",
                                              "monotonic", "process_time",
                                              "time_ns"):
            self.emit("host-entropy", call,
                      "host wall clock in the hot path — take times in "
                      "the driver and pass them in (the fleet's clock)")
        elif root in ("np", "numpy") and "random" in parts:
            self.emit("host-entropy", call,
                      "np.random global state in the hot path — draw from "
                      "a torch.Generator the step is given")
        elif root == "random" and name in ("random", "randint", "uniform",
                                           "choice", "shuffle", "gauss",
                                           "sample", "randrange"):
            self.emit("host-entropy", call,
                      "stdlib random in the hot path — draw from a "
                      "torch.Generator the step is given")
        elif root == "torch" and name in _TORCH_RNG and not has_gen:
            self.emit("host-entropy", call,
                      f"torch.{name} without generator= draws from the "
                      "global generator — pass the worker's generator")
        elif isinstance(func, ast.Attribute) and name in _TENSOR_RNG \
                and not has_gen:
            self.emit("host-entropy", call,
                      f".{name}() without generator= draws from the "
                      "global generator — pass the worker's generator")

    # -- host driver-loop rule ------------------------------------------
    def lint_host_loops(self, host_fns: List[ast.AST]) -> None:
        for fn in host_fns:
            nodes = list(ast.walk(fn))
            nested = {id(x)
                      for n in nodes
                      if isinstance(n, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)) and n is not fn
                      for x in ast.walk(n)}
            for node in nodes:
                if id(node) in nested or not isinstance(
                        node, (ast.For, ast.While, ast.AsyncFor)):
                    continue
                self._check_driver_loop(node)

    def _check_driver_loop(self, loop: ast.AST) -> None:
        body_nodes = [x for stmt in loop.body for x in ast.walk(stmt)]
        calls_step = any(
            isinstance(n, ast.Call)
            and _STEP_CALL_RE.search(_terminal_name(n.func) or "")
            for n in body_nodes)
        if not calls_step:
            return
        # nodes inside nested loops belong to *those* loops' cadence
        inner = {id(x)
                 for n in body_nodes
                 if isinstance(n, (ast.For, ast.While, ast.AsyncFor))
                 for x in ast.walk(n) if x is not n}
        body_nodes = [n for n in body_nodes if id(n) not in inner]
        for n in body_nodes:
            if not isinstance(n, ast.Call):
                continue
            f = n.func
            if isinstance(f, ast.Name) and f.id in ("float", "int") \
                    and n.args and not isinstance(n.args[0], ast.Constant):
                self.emit("sync-in-loop", n,
                          f"{f.id}() on a step output inside the driver "
                          "loop blocks the dispatch pipeline every "
                          "iteration — collect device values and convert "
                          "after the loop")
            elif isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS:
                self.emit("sync-in-loop", n,
                          f".{f.attr}() inside the driver loop blocks the "
                          "dispatch pipeline every iteration")


# --------------------------------------------------------------------- #
# entry points                                                           #
# --------------------------------------------------------------------- #

def collect_files(paths: Sequence[str], root: Optional[str] = None
                  ) -> List[str]:
    """Expand files/directories into a sorted .py file list (paths
    returned relative to ``root`` when given)."""
    out = []
    for p in paths:
        full = os.path.join(root, p) if root and not os.path.isabs(p) else p
        if os.path.isdir(full):
            for dirpath, dirnames, filenames in os.walk(full):
                dirnames[:] = [d for d in dirnames
                               if not d.startswith((".", "__pycache__"))]
                for f in filenames:
                    if f.endswith(".py"):
                        out.append(os.path.join(dirpath, f))
        elif full.endswith(".py"):
            out.append(full)
    if root:
        out = [os.path.relpath(p, root) for p in out]
    return sorted(set(p.replace(os.sep, "/") for p in out))


def _read_sources(paths: Sequence[str], root: str):
    sources = []
    for rel in collect_files(paths, root=root):
        with open(os.path.join(root, rel), "r", encoding="utf-8") as f:
            sources.append((rel, f.read()))
    return sources


def _parse(sources: Sequence[Tuple[str, str]], findings: List[Finding]):
    modules: List[_Module] = []
    for path, src in sources:
        try:
            tree = ast.parse(src)
        except SyntaxError as e:
            findings.append(Finding(
                rule="host-sync", path=path, line=e.lineno or 1, col=0,
                snippet="", message=f"syntax error: {e.msg}"))
            continue
        modules.append(_Module(path, tree, src.splitlines()))
    for mod in modules:
        _collect_functions(mod)
    return modules


def hot_functions(paths: Sequence[str] = DEFAULT_ROOTS,
                  root: Optional[str] = None,
                  roots: Sequence[str] = HOT_ROOTS) -> List[str]:
    """The hot path's functions, as ``path::qualified name`` keys."""
    modules = _parse(_read_sources(paths, root or os.getcwd()), [])
    _seed_hot(modules, roots)
    return sorted(f.key for m in modules for f in m.functions if f.hot)


def lint_source(source: str, path: str = "<string>",
                allowlist: Optional[Allowlist] = None) -> List[Finding]:
    """Lint one source string (fixture tests use this)."""
    return _lint_modules([(path, source)], allowlist or Allowlist())


def lint_paths(paths: Sequence[str] = DEFAULT_ROOTS,
               allowlist: Optional[Allowlist] = None,
               root: Optional[str] = None) -> List[Finding]:
    """Lint files/directories. Returns ALL findings; allowlisted ones are
    flagged ``allowed=True`` (the CLI gate fails only on un-allowed)."""
    root = root or os.getcwd()
    if allowlist is None:
        allowlist = load_allowlist()
    return _lint_modules(_read_sources(paths, root), allowlist)


def _lint_modules(sources: Sequence[Tuple[str, str]],
                  allowlist: Allowlist) -> List[Finding]:
    findings: List[Finding] = []
    modules = _parse(sources, findings)
    _seed_hot(modules, HOT_ROOTS)

    for mod in modules:
        linter = _FileLinter(mod, findings)
        linter.lint_module_wide()
        hot_nodes = set()
        for f in mod.functions:
            if f.hot:
                hot_nodes.add(id(f.node))
                linter.lint_hot_function(f.node)
        linter.lint_host_loops([f.node for f in mod.functions
                                if id(f.node) not in hot_nodes])

    seen = set()
    unique: List[Finding] = []
    for fd in findings:
        key = (fd.rule, fd.path, fd.line, fd.col)
        if key in seen:
            continue
        seen.add(key)
        unique.append(fd)
    for fd in unique:
        reason = allowlist.match(fd)
        if reason is not None:
            fd.allowed = True
            fd.allowed_by = reason
    unique.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return unique
