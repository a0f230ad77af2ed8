"""Interprocedural facts: package call graph + fixpoint fact propagation.

PR 3's checkers were lexical — each function analyzed in isolation, so a
fact that lives in the CALLER (holds the shard lock, runs on a worker
thread) or in the CALLEE (may raise a typed QueryError) was invisible.
This module builds the package-wide index the v2 rule families share:

  * **function units** — every def/method in the analyzed set, keyed
    ``path::Class.method`` / ``path::func``, with its call sites resolved
    where pure-AST resolution is sound: ``self.m()`` -> same class (one
    level of in-package base classes), ``f()`` -> same module,
    ``mod.f()`` -> the from-import/relative-import target module.
  * **exception hierarchy** — every class def in the set with its base
    names; ``descendants_of("QueryError")`` gives the typed hierarchy the
    except-flow rules protect.
  * **may-raise** — per function, the set of typed exception CLASS NAMES
    that can escape it: direct ``raise X(...)`` plus callees' sets,
    filtered at each call site by the enclosing ``try`` handlers in the
    caller (a call under ``except QueryError`` does not propagate
    QueryError).  Computed as a monotone fixpoint over the call graph, so
    recursion and arbitrary depth converge.
  * **thread entry points** — functions used as ``threading.Thread``
    targets (``target=self._loop`` / ``target=fn``) and ``run`` methods of
    in-package Thread subclasses.  Thread entries are exception SINKS:
    nothing above them can classify a typed error, so the except-flow
    rules treat them as boundaries, and the resource rules require their
    loops to fail loud instead of dying silently.

Unresolvable calls (third-party, attribute chains on unknown objects)
contribute no facts — the engine under-approximates rather than guess.
Pure stdlib ``ast``; no torch import.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

BROAD_EXCEPTION_NAMES = {"Exception", "BaseException"}


def dotted_name(node: ast.expr) -> str | None:
    """'a.b.c' for Attribute/Name chains, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def leaf_name(node: ast.expr) -> str | None:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def attr_root(expr: ast.expr, receivers: tuple = ("self",)) -> str | None:
    """First attribute name hanging off a receiver: ``self.a.b[...]`` ->
    "a". One definition for every checker that tracks state at
    object-attribute granularity (receivers varies: resource tracking also
    accepts the socketserver ``outer`` closure idiom)."""
    node = expr
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        parent = node.value
        if isinstance(node, ast.Attribute) and \
                isinstance(parent, ast.Name) and parent.id in receivers:
            return node.attr
        node = parent
    return None


def handler_names(handler: ast.ExceptHandler) -> list[str]:
    """Leaf class names a handler catches ('<bare>' for ``except:``)."""
    t = handler.type
    if t is None:
        return ["BaseException"]
    if isinstance(t, ast.Tuple):
        return [leaf_name(e) or "<?>" for e in t.elts]
    return [leaf_name(t) or "<?>"]


def is_broad_handler(handler: ast.ExceptHandler) -> bool:
    return bool(set(handler_names(handler)) & BROAD_EXCEPTION_NAMES)


def handler_reraises(handler: ast.ExceptHandler) -> bool:
    """Does the handler re-raise what it caught (bare ``raise``)? Such a
    handler observes the exception but does NOT terminate it — it must not
    strip the class from may-raise propagation."""
    return any(isinstance(n, ast.Raise) and n.exc is None
               for n in ast.walk(handler))


def catching_names(handlers: list) -> frozenset:
    """Exception names a try's handler chain TERMINATES: names of handlers
    that don't re-raise (the log-and-reraise idiom keeps propagating)."""
    out: set = set()
    for h in handlers:
        if not handler_reraises(h):
            out.update(handler_names(h))
    return frozenset(out)


def handler_is_observable(handler: ast.ExceptHandler) -> bool:
    """Does the handler leave ANY trace — a raise, a call (logging, counter,
    cleanup helper), an assignment? Pass/continue/bare-return bodies are the
    silent-swallow shape. Shared by except-swallow and
    resource-worker-silent-death so the two families cannot drift on what
    'observable' means."""
    for stmt in handler.body:
        for node in ast.walk(stmt):
            if isinstance(node, (ast.Raise, ast.Call, ast.Assign,
                                 ast.AugAssign, ast.AnnAssign)):
                return True
    return False


@dataclass
class CallSite:
    callee_key: str          # resolved FuncUnit key
    line: int
    caught: frozenset        # exception names caught around this site


@dataclass
class FuncUnit:
    key: str                 # "path::Class.method" / "path::func"
    path: str
    qualname: str            # "Class.method" / "func"
    name: str
    cls: str | None
    node: ast.AST
    calls: list[CallSite] = field(default_factory=list)
    direct_raises: set = field(default_factory=set)   # class NAMES raised
    # names `raise`d bare inside an except handler count as re-raise, not a
    # typed raise (the type is whatever was caught)


@dataclass
class ClassInfo:
    name: str
    path: str
    node: ast.ClassDef
    bases: list[str] = field(default_factory=list)    # leaf base names
    methods: dict = field(default_factory=dict)       # name -> FuncUnit key


class _ImportMap:
    """Module-local name -> (module rel path, symbol) for in-package imports.

    ``from .config import parse_duration_ms`` in filodb_tpu_torch/standalone.py
    maps "parse_duration_ms" -> ("filodb_tpu_torch/config.py", same name);
    ``from . import broker`` / ``import x.y as z`` map the module alias.
    """

    def __init__(self, path: str, known_paths: set):
        self.path = path
        self.known = known_paths
        self.symbols: dict[str, tuple[str, str]] = {}
        self.modules: dict[str, str] = {}             # alias -> module path

    def _resolve_relative(self, level: int, module: str | None) -> str | None:
        base = self.path.rsplit("/", 1)[0]            # containing package dir
        for _ in range(level - 1):
            if "/" not in base:
                return None
            base = base.rsplit("/", 1)[0]
        tail = (module or "").replace(".", "/")
        return f"{base}/{tail}" if tail else base

    def add_import_from(self, node: ast.ImportFrom) -> None:
        if node.level:
            prefix = self._resolve_relative(node.level, node.module)
        else:
            prefix = (node.module or "").replace(".", "/")
        if prefix is None:
            return
        for a in node.names:
            alias = a.asname or a.name
            as_module = f"{prefix}/{a.name}.py"
            as_symbol = f"{prefix}.py"
            if as_module in self.known:
                self.modules[alias] = as_module
            elif as_symbol in self.known:
                self.symbols[alias] = (as_symbol, a.name)

    def add_import(self, node: ast.Import) -> None:
        for a in node.names:
            p = a.name.replace(".", "/") + ".py"
            if p in self.known:
                self.modules[a.asname or a.name.split(".")[-1]] = p


class PackageIndex:
    """Shared interprocedural index over one analysis run's modules."""

    def __init__(self, modules: dict[str, ast.Module]):
        self.modules = modules
        self.funcs: dict[str, FuncUnit] = {}
        self.classes: dict[str, ClassInfo] = {}       # "path::Class"
        self.class_by_name: dict[str, list[ClassInfo]] = {}
        self._imports: dict[str, _ImportMap] = {}
        self.thread_entries: set = set()              # FuncUnit keys
        self._index()
        self._resolve_calls()
        self._find_thread_entries()
        self._may_raise: dict[str, frozenset] | None = None

    # -- construction -------------------------------------------------------

    def _index(self) -> None:
        known = set(self.modules)
        for path, tree in self.modules.items():
            imap = _ImportMap(path, known)
            self._imports[path] = imap
            # function-local imports count too (standalone.py defers most of
            # its wiring imports into start()); name shadowing across
            # functions is rare enough to accept one flat namespace
            for node in ast.walk(tree):
                if isinstance(node, ast.ImportFrom):
                    imap.add_import_from(node)
                elif isinstance(node, ast.Import):
                    imap.add_import(node)
            for node in tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self._add_func(path, None, node)
                    self._index_nested(path, node)
                elif isinstance(node, ast.ClassDef):
                    ci = ClassInfo(node.name, path, node,
                                   [leaf_name(b) or "<?>" for b in node.bases])
                    self.classes[f"{path}::{node.name}"] = ci
                    self.class_by_name.setdefault(node.name, []).append(ci)
                    for m in node.body:
                        if isinstance(m, (ast.FunctionDef,
                                          ast.AsyncFunctionDef)):
                            u = self._add_func(path, node.name, m)
                            ci.methods[m.name] = u.key
                            self._index_nested(path, m, cls=node.name)

    def _index_nested(self, path: str, fn: ast.AST,
                      cls: str | None = None) -> None:
        """Nested defs (closure workers like standalone's loop targets) get
        their own units, qualified under the enclosing function."""
        for node in ast.walk(fn):
            if node is fn:
                continue
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{fn.name}.{node.name}" if cls is None \
                    else f"{cls}.{fn.name}.{node.name}"
                key = f"{path}::{qual}"
                if key not in self.funcs:
                    self.funcs[key] = FuncUnit(key, path, qual, node.name,
                                               cls, node)

    def _add_func(self, path: str, cls: str | None,
                  node: ast.AST) -> FuncUnit:
        qual = f"{cls}.{node.name}" if cls else node.name
        u = FuncUnit(f"{path}::{qual}", path, qual, node.name, cls, node)
        self.funcs[u.key] = u
        return u

    # -- call resolution ----------------------------------------------------

    def _method_key(self, path: str, cls: str | None,
                    name: str) -> str | None:
        """Resolve a self.NAME() call: the class, then one level of
        in-package bases (same module or imported)."""
        seen = set()
        todo = [f"{path}::{cls}"] if cls else []
        while todo:
            ck = todo.pop(0)
            if ck in seen:
                continue
            seen.add(ck)
            ci = self.classes.get(ck)
            if ci is None:
                continue
            if name in ci.methods:
                return ci.methods[name]
            imap = self._imports.get(ci.path)
            for b in ci.bases:
                if f"{ci.path}::{b}" in self.classes:
                    todo.append(f"{ci.path}::{b}")
                elif imap and b in imap.symbols:
                    bpath, bname = imap.symbols[b]
                    todo.append(f"{bpath}::{bname}")
        return None

    def resolve_call(self, path: str, cls: str | None,
                     call: ast.Call) -> str | None:
        fn = call.func
        if isinstance(fn, ast.Attribute):
            if isinstance(fn.value, ast.Name):
                base = fn.value.id
                if base in ("self", "cls", "outer"):
                    return self._method_key(path, cls, fn.attr)
                imap = self._imports.get(path)
                if imap and base in imap.modules:
                    key = f"{imap.modules[base]}::{fn.attr}"
                    return key if key in self.funcs else None
            return None
        if isinstance(fn, ast.Name):
            imap = self._imports.get(path)
            if imap and fn.id in imap.symbols:
                spath, sname = imap.symbols[fn.id]
                key = f"{spath}::{sname}"
                return key if key in self.funcs else None
            key = f"{path}::{fn.id}"
            return key if key in self.funcs else None
        return None

    def _resolve_calls(self) -> None:
        for u in self.funcs.values():
            collector = _CallCollector(self, u)
            body = getattr(u.node, "body", [])
            for stmt in body:
                collector.visit(stmt)

    # -- thread entries ------------------------------------------------------

    def _thread_subclasses(self) -> set:
        """'path::Class' keys of classes transitively deriving Thread."""
        cached = getattr(self, "_thread_subclass_cache", None)
        if cached is not None:
            return cached
        out: set = set()
        changed = True
        while changed:
            changed = False
            for ck, ci in self.classes.items():
                if ck in out:
                    continue
                for b in ci.bases:
                    is_thread = b == "Thread"
                    if not is_thread:
                        imap = self._imports.get(ci.path)
                        tgt = imap.symbols.get(b) if imap else None
                        bk = f"{ci.path}::{b}" if f"{ci.path}::{b}" in \
                            self.classes else (f"{tgt[0]}::{tgt[1]}"
                                               if tgt else None)
                        is_thread = bk in out if bk else False
                    if is_thread:
                        out.add(ck)
                        changed = True
                        break
        self._thread_subclass_cache = out
        return out

    def _find_thread_entries(self) -> None:
        for ck in self._thread_subclasses():
            ci = self.classes[ck]
            if "run" in ci.methods:
                self.thread_entries.add(ci.methods["run"])
        for path, tree in self.modules.items():
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call):
                    continue
                target = next((kw.value for kw in node.keywords
                               if kw.arg == "target"), None)
                if target is None:
                    continue
                name = dotted_name(node.func) or ""
                if not (name.endswith("Thread") or name == "Thread"):
                    continue
                key = self._resolve_target(path, node, target)
                if key:
                    self.thread_entries.add(key)

    def _enclosing_class(self, path: str, call: ast.Call) -> str | None:
        tree = self.modules.get(path)
        if tree is None:
            return None
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                for sub in ast.walk(node):
                    if sub is call:
                        return node.name
        return None

    def _resolve_target(self, path: str, call: ast.Call,
                        target: ast.expr) -> str | None:
        """Thread target= expression -> FuncUnit key (best effort)."""
        if isinstance(target, ast.Attribute) and \
                isinstance(target.value, ast.Name) and \
                target.value.id in ("self", "outer"):
            cls = self._enclosing_class(path, call)
            return self._method_key(path, cls, target.attr)
        if isinstance(target, ast.Name):
            # nested closure worker first (standalone's loop targets), then a
            # module-level function
            for key, u in self.funcs.items():
                if u.path == path and u.name == target.id and "." in u.qualname:
                    return key
            key = f"{path}::{target.id}"
            return key if key in self.funcs else None
        return None

    # -- exception hierarchy -------------------------------------------------

    def ancestry(self, class_name: str) -> set:
        """All ancestor class NAMES reachable from class_name (by-name
        resolution across the analyzed set; diamond-safe)."""
        out: set = set()
        todo = [class_name]
        while todo:
            n = todo.pop()
            for ci in self.class_by_name.get(n, ()):
                for b in ci.bases:
                    if b not in out:
                        out.add(b)
                        todo.append(b)
        return out

    def descendants_of(self, root: str) -> set:
        out = set()
        for name in self.class_by_name:
            if name == root or root in self.ancestry(name):
                out.add(name)
        return out

    def catches(self, caught: frozenset, exc_name: str) -> bool:
        """Would a handler naming `caught` intercept an exception of class
        exc_name? (exact, ancestor, or broad match)."""
        if caught & BROAD_EXCEPTION_NAMES:
            return True
        if exc_name in caught:
            return True
        return bool(self.ancestry(exc_name) & caught)

    # -- reverse call graph ---------------------------------------------------

    def callers_of(self) -> dict:
        """Callee FuncUnit key -> set of caller keys (sound edges only —
        same under-approximation as the forward graph). Cached."""
        cached = getattr(self, "_callers_cache", None)
        if cached is not None:
            return cached
        out: dict = {}
        for key, u in self.funcs.items():
            for site in u.calls:
                out.setdefault(site.callee_key, set()).add(key)
        self._callers_cache = out
        return out

    def reachable_only_from(self, key: str, sanctioned: set) -> bool:
        """True iff every reverse-call chain from ``key`` hits a function in
        ``sanctioned`` before it hits an unsanctioned root (a function with
        no in-package callers — a thread entry, an HTTP handler, a public
        API). A sanctioned ancestor terminates its chain: whatever it does
        around the call is its declared responsibility. A chain that ends
        in an unsanctioned root means ``key`` can run with no declared
        site above it. Pure cycles with no outside entry are vacuously
        sanctioned (nothing can invoke them). Under-approximated edges
        (getattr dispatch, third-party callbacks) make this lenient, never
        falsely loud — consistent with the forward graph's contract."""
        if key in sanctioned:
            return True
        callers = self.callers_of()
        seen: set = set()
        todo = [key]
        while todo:
            k = todo.pop()
            if k in seen:
                continue
            seen.add(k)
            ups = callers.get(k, ())
            if not ups and k != key:
                return False          # unsanctioned root reached
            if not ups and k == key:
                return False          # key itself is a root
            for up in ups:
                if up in sanctioned:
                    continue          # this chain is accounted for
                todo.append(up)
        return True

    # -- may-raise fixpoint ---------------------------------------------------

    def may_raise(self, typed_only: set | None = None) -> dict[str, frozenset]:
        """Function key -> exception class names that can escape it.

        ``typed_only`` restricts the domain (the except-flow rules pass the
        QueryError hierarchy) — smaller sets, faster fixpoint. Cached for
        the index's lifetime when typed_only is None-or-first-call."""
        if self._may_raise is not None and typed_only is None:
            return self._may_raise
        domain = typed_only
        cur: dict[str, set] = {}
        for key, u in self.funcs.items():
            direct = set(u.direct_raises)
            if domain is not None:
                direct &= domain
            cur[key] = direct
        changed = True
        while changed:
            changed = False
            for key, u in self.funcs.items():
                mine = cur[key]
                for site in u.calls:
                    callee = cur.get(site.callee_key)
                    if not callee:
                        continue
                    for exc in callee:
                        if exc not in mine and \
                                not self.catches(site.caught, exc):
                            mine.add(exc)
                            changed = True
        out = {k: frozenset(v) for k, v in cur.items()}
        if typed_only is None:
            self._may_raise = out
        return out


class _CallCollector(ast.NodeVisitor):
    """One pass over a function: resolved call sites with their enclosing
    try-handler context, plus direct typed raises."""

    def __init__(self, index: PackageIndex, unit: FuncUnit):
        self.index = index
        self.u = unit
        self._caught: list[frozenset] = []

    def visit_Try(self, node: ast.Try):  # noqa: N802
        # only handlers that TERMINATE the exception filter propagation —
        # `except QueryError: log(); raise` keeps the typed class flowing
        names = catching_names(node.handlers)
        self._caught.append(names)
        for stmt in node.body:
            self.visit(stmt)
        self._caught.pop()
        for part in (node.handlers, node.orelse, node.finalbody):
            for stmt in part:
                self.visit(stmt)

    visit_TryStar = visit_Try

    def visit_Raise(self, node: ast.Raise):  # noqa: N802
        exc = node.exc
        if isinstance(exc, ast.Call):
            exc = exc.func
        name = leaf_name(exc) if exc is not None else None
        if name:
            self.u.direct_raises.add(name)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):  # noqa: N802
        key = self.index.resolve_call(self.u.path, self.u.cls, node)
        if key is not None:
            caught = frozenset().union(*self._caught) if self._caught \
                else frozenset()
            self.u.calls.append(CallSite(key, node.lineno, caught))
        self.generic_visit(node)

    def visit_FunctionDef(self, node):  # noqa: N802
        pass        # nested defs are their own units

    visit_AsyncFunctionDef = visit_FunctionDef
