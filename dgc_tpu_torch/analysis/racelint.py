"""Host-concurrency lint (layer 4, static half): DGC201-204.

Counterpart of ``dgc_tpu/analysis/racelint.py``: DGC201, DGC202 and
DGC204 are API-free and read the same; DGC203 reads the step's hot path
(:data:`~dgc_tpu_torch.analysis.astlint.HOT_ROOTS` and ``# dgclint: hot``
markers, closed over this module's calls) where the reference reads
traced scope.

Eraser-style lockset reasoning over a thread-escape analysis of the host
call graph — pure ``ast`` work like the AST lints, so the whole tree
lints in milliseconds. The analysis:

1. find every ``threading.Thread(target=...)`` spawn and resolve its
   target (``self.method`` or a module function);
2. compute the *thread scope*: the closure of functions reachable from
   each target through ``self.m()`` / bare-name calls in the module;
3. census every ``self.attr`` access (and ``global``-declared module
   state) per function, tagging reads/writes and whether the access sits
   under a ``with <something lock-ish>:`` block;
4. fire when thread scope and non-thread scope share mutable state with
   no consistent lock (DGC201), when a spawned thread and a crash/exit
   handler write the same file (DGC202), when a thread mutates state a
   hot-path function consumes (DGC203 — the step reads a value torn
   between two of the thread's updates), or when a non-daemon thread is
   never joined (DGC204 — interpreter shutdown blocks on it).

Attributes holding sync primitives (``threading.Lock/Event/...``,
``queue.Queue``, ``collections.deque``) are exempt — they are the fix,
not the hazard. Everything else goes through the same audited
machinery as the AST lints: ``allowlist.toml`` entries and inline
``# dgclint: ok[rule-id]`` waivers, reused verbatim.

Like the AST lints, the analysis over-approximates on purpose (no alias
tracking, name-based call edges): it never misses a real unlocked
escape, and the benign rest is exactly what the audited allowlist is
for.
"""

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from dgc_tpu_torch.analysis.astlint import (DEFAULT_ROOTS, HOT_ROOTS,
                                            _FuncInfo, _is_root,
                                            _marked_hot, _Module,
                                            _terminal_name, collect_files)
from dgc_tpu_torch.analysis.rules import Allowlist, Finding, load_allowlist

__all__ = ["race_lint_paths", "race_lint_source"]

#: constructors whose result IS a synchronization/handoff primitive —
#: sharing one across threads is the documented fix, not a hazard
_SYNC_TYPES = {"Lock", "RLock", "Event", "Condition", "Semaphore",
               "BoundedSemaphore", "Barrier", "Queue", "SimpleQueue",
               "LifoQueue", "PriorityQueue", "deque"}

#: a ``with X:`` whose expression mentions one of these guards its body
_LOCKY_FRAGMENTS = ("lock", "mutex")

#: open() modes that write
_WRITE_MODES = set("wxa")


def _is_locky(expr: ast.AST) -> bool:
    for sub in ast.walk(expr):
        name = None
        if isinstance(sub, ast.Attribute):
            name = sub.attr
        elif isinstance(sub, ast.Name):
            name = sub.id
        if name and any(f in name.lower() for f in _LOCKY_FRAGMENTS):
            return True
    return False


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


class _Access:
    __slots__ = ("attr", "kind", "locked", "node", "scope")

    def __init__(self, attr, kind, locked, node, scope):
        self.attr = attr      # attribute name, or global variable name
        self.kind = kind      # 'r' | 'w'
        self.locked = locked
        self.node = node
        self.scope = scope    # (class_name_or_None, func_name)


class _Spawn:
    __slots__ = ("node", "scope", "entry", "daemon")

    def __init__(self, node, scope, entry, daemon):
        self.node = node
        self.scope = scope    # where the Thread(...) call appears
        self.entry = entry    # (class_name_or_None, func_name) target
        self.daemon = daemon


class _RaceModule:
    """Per-module census: scopes, spawns, accesses, file writes."""

    def __init__(self, mod: _Module):
        self.mod = mod
        #: top-level classes -> {method name -> FunctionDef}
        self.classes: Dict[str, Dict[str, ast.AST]] = {}
        #: top-level functions
        self.functions: Dict[str, ast.AST] = {}
        self.spawns: List[_Spawn] = []
        #: per-scope attribute/global accesses
        self.accesses: List[_Access] = []
        #: (class, attr) / (None, global) holding sync primitives
        self.sync_state: Set[Tuple[Optional[str], str]] = set()
        #: scope -> unparsed path exprs written as files
        self.file_writes: Dict[Tuple[Optional[str], str],
                               List[Tuple[str, ast.AST]]] = {}
        #: crash/exit handler entries (signal.signal / atexit.register)
        self.handlers: List[Tuple[Optional[str], str]] = []
        #: does any ``.join(`` appear in the module?
        self.has_join = any(
            isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute) and n.func.attr == "join"
            and not (isinstance(n.func.value, ast.Constant)
                     and isinstance(n.func.value.value, str))
            for n in ast.walk(mod.tree))
        self._collect()

    # -- structure ---------------------------------------------------- #

    def _collect(self) -> None:
        for node in self.mod.tree.body:
            if isinstance(node, ast.ClassDef):
                methods = {c.name: c for c in node.body
                           if isinstance(c, (ast.FunctionDef,
                                             ast.AsyncFunctionDef))}
                self.classes[node.name] = methods
                for name, fn in methods.items():
                    self._scan_function(fn, (node.name, name))
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[node.name] = node
                self._scan_function(node, (None, node.name))

    def _scan_function(self, fn: ast.AST, scope) -> None:
        cls = scope[0]
        globals_here: Set[str] = {
            name for sub in ast.walk(fn) if isinstance(sub, ast.Global)
            for name in sub.names}
        writes = self.file_writes.setdefault(scope, [])

        def record(attr, ctx, locked, node):
            kind = "w" if isinstance(ctx, (ast.Store, ast.Del)) else "r"
            self.accesses.append(_Access(attr, kind, locked, node, scope))

        def visit(node, depth):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node is not fn:
                return          # nested defs get no separate scope; skip
            if isinstance(node, (ast.With, ast.AsyncWith)):
                locky = any(_is_locky(i.context_expr) for i in node.items)
                for i in node.items:
                    visit(i.context_expr, depth)
                    if i.optional_vars is not None:
                        visit(i.optional_vars, depth)
                for s in node.body:
                    visit(s, depth + (1 if locky else 0))
                return
            locked = depth > 0
            attr = _self_attr(node)
            if attr is not None and cls is not None:
                record((cls, attr), node.ctx, locked, node)
                if isinstance(node.ctx, ast.Store):
                    self._note_sync_assign(node, fn, (cls, attr))
            elif isinstance(node, ast.Name) and node.id in globals_here:
                record((None, node.id), node.ctx, locked, node)
            if isinstance(node, ast.Subscript) \
                    and isinstance(node.ctx, (ast.Store, ast.Del)):
                # self.x[k] = v / del g[k]: a WRITE to the container
                inner = _self_attr(node.value)
                if inner is not None and cls is not None:
                    self.accesses.append(_Access(
                        (cls, inner), "w", locked, node, scope))
                elif isinstance(node.value, ast.Name) \
                        and node.value.id in globals_here:
                    self.accesses.append(_Access(
                        (None, node.value.id), "w", locked, node, scope))
            if isinstance(node, ast.Call):
                self._scan_call(node, scope, locked, writes)
            for child in ast.iter_child_nodes(node):
                visit(child, depth)

        visit(fn, 0)

    def _note_sync_assign(self, target: ast.AST, fn: ast.AST, key) -> None:
        """``self.x = threading.Lock()`` (anywhere) exempts ``x``."""
        for sub in ast.walk(fn):
            if isinstance(sub, ast.Assign) and target in sub.targets \
                    and isinstance(sub.value, ast.Call) \
                    and _terminal_name(sub.value.func) in _SYNC_TYPES:
                self.sync_state.add(key)

    # -- calls: spawns, handlers, file writes -------------------------- #

    def _scan_call(self, call: ast.Call, scope, locked: bool,
                   writes) -> None:
        name = _terminal_name(call.func)
        if name == "Thread":
            self._scan_spawn(call, scope)
        elif name == "signal" and len(call.args) >= 2:
            self._note_handler(call.args[1])
        elif name == "register" and call.args:
            self._note_handler(call.args[0])
        elif name == "open":
            mode = None
            if len(call.args) >= 2 and isinstance(call.args[1],
                                                  ast.Constant):
                mode = call.args[1].value
            for k in call.keywords:
                if k.arg == "mode" and isinstance(k.value, ast.Constant):
                    mode = k.value.value
            if isinstance(mode, str) and set(mode) & _WRITE_MODES \
                    and call.args:
                writes.append((ast.unparse(call.args[0]), call))
        elif name in ("replace", "rename") and len(call.args) >= 2:
            writes.append((ast.unparse(call.args[1]), call))
        elif name in ("unlink", "remove", "rmtree") and call.args:
            writes.append((ast.unparse(call.args[0]), call))

    def _entry_of(self, ref: ast.AST, scope) -> Optional[Tuple]:
        attr = _self_attr(ref)
        if attr is not None and scope[0] is not None:
            return (scope[0], attr)
        if isinstance(ref, ast.Name):
            return (None, ref.id)
        return None

    def _scan_spawn(self, call: ast.Call, scope) -> None:
        target = None
        daemon = False
        for k in call.keywords:
            if k.arg == "target":
                target = k.value
            elif (k.arg == "daemon" and isinstance(k.value, ast.Constant)
                  and k.value.value):
                daemon = True
        if target is None:
            return
        entry = self._entry_of(target, scope)
        if entry is None:
            return
        self.spawns.append(_Spawn(call, scope, entry, daemon))

    def _note_handler(self, ref: ast.AST) -> None:
        # handlers registered from methods are ``self.m``; from module
        # scope, bare names — scope[0] is unknown here, so try both forms
        if isinstance(ref, ast.Attribute) and isinstance(ref.value,
                                                         ast.Name):
            if ref.value.id == "self":
                for cls, methods in self.classes.items():
                    if ref.attr in methods:
                        self.handlers.append((cls, ref.attr))
        elif isinstance(ref, ast.Name) and ref.id in self.functions:
            self.handlers.append((None, ref.id))

    # -- closures ------------------------------------------------------ #

    def closure(self, entry: Tuple[Optional[str], str]
                ) -> Set[Tuple[Optional[str], str]]:
        """Functions reachable from ``entry`` via ``self.m()`` and
        bare-name module calls (name-based, over-approximate)."""
        seen: Set[Tuple[Optional[str], str]] = set()
        stack = [entry]
        while stack:
            cls, name = stack.pop()
            if (cls, name) in seen:
                continue
            seen.add((cls, name))
            fn = (self.classes.get(cls, {}).get(name) if cls
                  else self.functions.get(name))
            if fn is None:
                continue
            for sub in ast.walk(fn):
                if not isinstance(sub, ast.Call):
                    continue
                attr = _self_attr(sub.func)
                if attr is not None and cls is not None \
                        and attr in self.classes.get(cls, {}):
                    stack.append((cls, attr))
                elif isinstance(sub.func, ast.Name) \
                        and sub.func.id in self.functions:
                    stack.append((None, sub.func.id))
        return seen


class _RaceLinter:
    def __init__(self, mod: _Module, findings: List[Finding]):
        self.mod = mod
        self.rm = _RaceModule(mod)
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

    def run(self) -> None:
        rm = self.rm
        if not rm.spawns:
            return
        thread_scope: Set[Tuple[Optional[str], str]] = set()
        entry_of: Dict[Tuple[Optional[str], str], str] = {}
        for sp in rm.spawns:
            clos = rm.closure(sp.entry)
            thread_scope |= clos
            label = (f"{sp.entry[0]}.{sp.entry[1]}" if sp.entry[0]
                     else sp.entry[1])
            for s in clos:
                entry_of.setdefault(s, label)
        self._check_shared_state(thread_scope, entry_of)
        self._check_crash_files(thread_scope, entry_of)
        self._check_traced_state(thread_scope, entry_of)
        self._check_no_join()

    # -- DGC201: unlocked cross-thread state --------------------------- #

    def _check_shared_state(self, thread_scope, entry_of) -> None:
        by_state: Dict[Tuple, List[_Access]] = {}
        for a in self.rm.accesses:
            by_state.setdefault(a.attr, []).append(a)
        for key, accesses in sorted(by_state.items(),
                                    key=lambda kv: str(kv[0])):
            if key in self.rm.sync_state:
                continue
            cls, attr = key
            if any(f in attr.lower() for f in _LOCKY_FRAGMENTS):
                continue
            live = [a for a in accesses if a.scope[1] != "__init__"]
            thread_side = [a for a in live if a.scope in thread_scope]
            main_side = [a for a in live if a.scope not in thread_scope]
            if not thread_side or not main_side:
                continue
            if not any(a.kind == "w" for a in live):
                continue
            unlocked = [a for a in live if not a.locked]
            if not unlocked:
                continue
            site = next((a for a in unlocked if a.kind == "w"),
                        unlocked[0])
            owner = cls + "." if cls else "global "
            tscope = thread_side[0].scope
            entry = entry_of.get(tscope, tscope[1])
            other = main_side[0].scope
            other_name = (f"{other[0]}.{other[1]}" if other[0]
                          else other[1])
            self.emit(
                "thread-shared-state", site.node,
                f"{owner}{attr} is shared between thread entry "
                f"{entry} and {other_name} with at least one unlocked "
                "access — guard every access with one shared lock (or "
                "hand the value over a queue/Event)")

    # -- DGC202: thread + crash handler write the same file ------------ #

    def _check_crash_files(self, thread_scope, entry_of) -> None:
        handler_scope: Set[Tuple[Optional[str], str]] = set()
        for h in self.rm.handlers:
            handler_scope |= self.rm.closure(h)
        if not handler_scope:
            return
        handler_writes = {expr for s in handler_scope
                          for expr, _n in self.rm.file_writes.get(s, ())}
        if not handler_writes:
            return
        for s in sorted(thread_scope - handler_scope, key=str):
            for expr, node in self.rm.file_writes.get(s, ()):
                if expr in handler_writes:
                    self.emit(
                        "thread-crash-file", node,
                        f"thread entry {entry_of.get(s, s[1])} writes "
                        f"{expr} which a signal/atexit handler also "
                        "writes — a crash mid-write interleaves the two "
                        "writers on the same path (route both through "
                        "one atomic publisher)")

    # -- DGC203: thread writes state the hot path reads ---------------- #

    def _check_traced_state(self, thread_scope, entry_of) -> None:
        # the hot path here is SEEDED in this module only (a declared hot
        # root, or a ``# dgclint: hot`` marker) plus the local call
        # closure — dgclint's cross-module name-matched fixpoint is the
        # right over-approximation for host-sync rules, but for DGC203 it
        # would mark half the control plane "hot" through same-name host
        # methods and drown the rule in noise
        def hot(fn, qual):
            info = _FuncInfo("", qual, fn.name, fn, self.mod.path)
            return _is_root(info, HOT_ROOTS) or _marked_hot(self.mod, fn)

        seeds: Set[Tuple[Optional[str], str]] = set()
        for cls, methods in self.rm.classes.items():
            for name, fn in methods.items():
                if hot(fn, f"{cls}.{name}"):
                    seeds.add((cls, name))
        for name, fn in self.rm.functions.items():
            if hot(fn, name):
                seeds.add((None, name))
        traced: Set[Tuple[Optional[str], str]] = set()
        for s in seeds:
            traced |= self.rm.closure(s)
        if not traced:
            return
        traced_reads = {a.attr for a in self.rm.accesses
                        if a.scope in traced and a.kind == "r"}
        for a in self.rm.accesses:
            if a.kind != "w" or a.scope not in thread_scope \
                    or a.scope[1] == "__init__":
                continue
            if a.attr not in traced_reads or a.attr in self.rm.sync_state:
                continue
            cls, attr = a.attr
            owner = cls + "." if cls else "global "
            self.emit(
                "thread-traced-state", a.node,
                f"thread entry {entry_of.get(a.scope, a.scope[1])} "
                f"mutates {owner}{attr}, which the step's hot path reads "
                "— the step sees a value torn between the thread's "
                "updates (thread the value as a step argument instead)")

    # -- DGC204: non-daemon thread never joined ------------------------ #

    def _check_no_join(self) -> None:
        for sp in self.rm.spawns:
            if sp.daemon or self.rm.has_join:
                continue
            self.emit(
                "thread-no-join", sp.node,
                "non-daemon Thread is never joined anywhere in this "
                "module — interpreter shutdown blocks on it forever; "
                "set daemon=True or join with a timeout")


# --------------------------------------------------------------------- #
# entry points (mirror astlint's)                                        #
# --------------------------------------------------------------------- #

def race_lint_source(source: str, path: str = "<string>",
                     allowlist: Optional[Allowlist] = None
                     ) -> List[Finding]:
    """Race-lint one source string (fixture tests use this)."""
    return _race_lint_modules([(path, source)], allowlist or Allowlist())


def race_lint_paths(paths: Sequence[str] = DEFAULT_ROOTS,
                    allowlist: Optional[Allowlist] = None,
                    root: Optional[str] = None) -> List[Finding]:
    """Race-lint files/directories; allowlisted findings are flagged
    ``allowed=True`` (the CLI gate fails only on un-allowed)."""
    import os
    root = root or os.getcwd()
    if allowlist is None:
        allowlist = load_allowlist()
    files = collect_files(paths, root=root)
    sources = []
    for rel in files:
        with open(os.path.join(root, rel), "r", encoding="utf-8") as f:
            sources.append((rel, f.read()))
    return _race_lint_modules(sources, allowlist)


def _race_lint_modules(sources: Sequence[Tuple[str, str]],
                       allowlist: Allowlist) -> List[Finding]:
    modules: List[_Module] = []
    findings: List[Finding] = []
    for path, src in sources:
        try:
            tree = ast.parse(src)
        except SyntaxError:
            continue                  # the AST lints report these
        modules.append(_Module(path, tree, src.splitlines()))
    for mod in modules:
        _RaceLinter(mod, findings).run()

    seen = set()
    unique: List[Finding] = []
    for fd in findings:
        key = (fd.rule, fd.path, fd.line, fd.col)
        if key not in seen:
            seen.add(key)
            unique.append(fd)
    for fd in unique:
        reason = allowlist.match(fd)
        if reason is not None:
            fd.allowed = True
            fd.allowed_by = reason
    unique.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return unique
