"""Except-flow checker: typed-error discipline on broad handlers.

The typed ``QueryError`` hierarchy is the repo's error *protocol*: the
HTTP layer classifies it into status codes, the dispatch layer into
replan/shed decisions. A broad ``except Exception`` between the raise and
the classifier silently downgrades the protocol — and a swallow-all
handler on an ingest/commit path turns data loss into a no-op. Three
rules, all running on the shared interprocedural facts
(analysis/callgraph.py):

  * ``except-swallow`` — a broad handler (``except Exception`` /
    ``except BaseException`` / bare) whose body leaves NO observable
    trace: no raise, no call (logging, counter, cleanup helper), no
    assignment. ``pass``/``continue``/bare-``return`` bodies silently
    drop errors; every such site must either narrow the type, leave a
    trace (the ``filodb_swallowed_errors`` counter exists for exactly
    this), or carry an inline suppression with a reason.
  * ``except-overbroad-typed`` — a broad handler catching a try body
    that MAY RAISE a typed ``QueryError`` descendant (computed
    interprocedurally through helper calls, filtered by intermediate
    handlers), where no PRECEDING handler in the chain names the typed
    class (or an ancestor), and the broad handler neither re-raises nor
    forwards the exception object. Thread entry points are exempt —
    they are sinks; nothing above them can classify.
  * ``except-state-leak`` — the two-phase-commit shape: state CLAIMED
    under a lock (``self.X.pop(...)`` / ``.remove(...)`` inside ``with
    self.<lock>:``) before or inside a try whose broad handler neither
    re-raises nor restores the claimed attribute (directly or via one
    helper call). The claim dies with the handler and the rows are
    gone — memstore's flush requeue and the downsampler's claim-restore
    are the positive patterns.
"""

from __future__ import annotations

import ast

from .callgraph import (PackageIndex, attr_root, catching_names,
                        handler_is_observable, handler_names,
                        is_broad_handler, leaf_name)
from .findings import Finding

ERROR_ROOT = "QueryError"
CLAIM_METHODS = {"pop", "popitem", "remove", "popleft"}
LOCK_ATTRS = {"lock", "_lock", "owner_lock", "_sink_lock"}


_handler_observable = handler_is_observable   # shared definition (callgraph)


def _own_trys(fn: ast.AST) -> list[ast.Try]:
    """Try statements belonging to THIS function only. Nested defs are
    their own FuncUnits (analyzed with their own sink status); re-walking
    them from the enclosing unit would both duplicate findings and drop a
    worker closure's thread-entry exemption."""
    out: list[ast.Try] = []

    def rec(node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            if isinstance(child, ast.Try):
                out.append(child)
            rec(child)

    rec(fn)
    return out


def _handler_reraises_or_forwards(handler: ast.ExceptHandler) -> bool:
    """Bare `raise`, `raise X(...) from e`, or the bound exception object
    passed onward (fut.set_exception(e), out.append(e), log(..., e))."""
    bound = handler.name
    for stmt in handler.body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Raise):
                return True
            if bound and isinstance(node, ast.Call):
                for arg in list(node.args) + [kw.value
                                              for kw in node.keywords]:
                    for sub in ast.walk(arg):
                        if isinstance(sub, ast.Name) and sub.id == bound:
                            return True
    return False


def _self_attr_root(expr: ast.expr) -> str | None:
    return attr_root(expr, receivers=("self",))


def _claims_in(stmts: list[ast.stmt]) -> dict[str, int]:
    """Attr roots claimed (popped/removed from a self collection) inside a
    `with self.<lock>:` block within these statements -> first line."""
    out: dict[str, int] = {}
    for stmt in stmts:
        for node in ast.walk(stmt):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            locked = any(
                isinstance(item.context_expr, ast.Attribute)
                and item.context_expr.attr in LOCK_ATTRS
                for item in node.items)
            if not locked:
                continue
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call) and \
                        isinstance(sub.func, ast.Attribute) and \
                        sub.func.attr in CLAIM_METHODS:
                    root = _self_attr_root(sub.func.value)
                    if root:
                        out.setdefault(root, sub.lineno)
    return out


class _TypedEscapes(ast.NodeVisitor):
    """Typed exception names that can ESCAPE a statement list: direct raises
    plus resolved callees' may-raise sets, filtered by nested try handlers
    encountered on the way (and not collected from nested defs, whose raises
    don't execute inline)."""

    def __init__(self, index: PackageIndex, unit, typed: set,
                 may_raise: dict):
        self.index = index
        self.u = unit
        self.typed = typed
        self.may_raise = may_raise
        self.out: set = set()
        self._caught: list[frozenset] = []

    def _escapes(self, exc: str) -> bool:
        return not any(self.index.catches(frame, exc)
                       for frame in self._caught)

    def visit_Try(self, node: ast.Try):  # noqa: N802
        # re-raising handlers don't terminate the exception (shared
        # catching_names semantics with the may-raise fixpoint)
        names = catching_names(node.handlers)
        self._caught.append(names)
        for stmt in node.body:
            self.visit(stmt)
        self._caught.pop()
        # handler bodies and finally re-raise to the OUTER context; orelse
        # runs only when nothing raised, and this try's handlers don't
        # cover it either
        for part in (node.handlers, node.orelse, node.finalbody):
            for sub in part:
                body = sub.body if isinstance(sub, ast.ExceptHandler) else [sub]
                for stmt in body:
                    self.visit(stmt)

    visit_TryStar = visit_Try

    def visit_Raise(self, node: ast.Raise):  # noqa: N802
        exc = node.exc
        if isinstance(exc, ast.Call):
            exc = exc.func
        n = leaf_name(exc) if exc is not None else None
        if n in self.typed and self._escapes(n):
            self.out.add(n)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):  # noqa: N802
        key = self.index.resolve_call(self.u.path, self.u.cls, node)
        if key and key in self.may_raise:
            for exc in self.may_raise[key]:
                if self._escapes(exc):
                    self.out.add(exc)
        self.generic_visit(node)

    def visit_FunctionDef(self, node):  # noqa: N802
        pass        # a nested def's body doesn't raise at definition time

    visit_AsyncFunctionDef = visit_FunctionDef


class ExceptChecker:
    rules = ("except-swallow", "except-overbroad-typed", "except-state-leak")

    def __init__(self, error_root: str = ERROR_ROOT):
        self.error_root = error_root
        self._modules: dict[str, ast.Module] = {}
        self.project: PackageIndex | None = None

    def check_module(self, path: str, tree: ast.Module) -> list[Finding]:
        self._modules[path] = tree
        return []

    def finalize(self) -> list[Finding]:
        index = self.project or PackageIndex(self._modules)
        typed = index.descendants_of(self.error_root)
        may_raise = index.may_raise(typed_only=typed) if typed else {}
        findings: list[Finding] = []
        for key, u in sorted(index.funcs.items()):
            if u.path not in self._modules:
                continue
            findings += self._check_func(u, index, typed, may_raise)
        return findings

    def _check_func(self, u, index: PackageIndex, typed: set,
                    may_raise: dict) -> list[Finding]:
        findings: list[Finding] = []
        is_sink = u.key in index.thread_entries or u.name == "__del__"
        for node in _own_trys(u.node):
            findings += self._check_try(u, node, index, typed, may_raise,
                                        is_sink)
        return findings

    def _check_try(self, u, node: ast.Try, index: PackageIndex, typed: set,
                   may_raise: dict, is_sink: bool) -> list[Finding]:
        findings: list[Finding] = []
        # typed classes the try body can raise (direct + via resolved calls,
        # minus anything an inner handler already caught — the collector
        # tracks nested try frames, so a defensive inner `except QueryError`
        # keeps the outer broad handler clean)
        collector = _TypedEscapes(index, u, typed, may_raise)
        for stmt in node.body:
            collector.visit(stmt)
        body_typed = collector.out
        seen_names: set = set()
        for h in node.handlers:
            names = set(handler_names(h))
            if is_broad_handler(h):
                if not _handler_observable(h):
                    findings.append(Finding(
                        "except-swallow", u.path, h.lineno, u.qualname,
                        f"swallow:{h.lineno - u.node.lineno}",
                        "broad except with no observable action silently "
                        "drops the error — narrow the type, log/count it "
                        "(filodb_swallowed_errors), or suppress inline "
                        "with a reason"))
                uncovered = {t for t in body_typed
                             if t not in seen_names
                             and not (index.ancestry(t) & seen_names)}
                if uncovered and not is_sink \
                        and not _handler_reraises_or_forwards(h):
                    sample = sorted(uncovered)[0]
                    findings.append(Finding(
                        "except-overbroad-typed", u.path, h.lineno,
                        u.qualname, f"overbroad:{sample}",
                        f"broad except catches typed {sorted(uncovered)} "
                        f"(the {self.error_root} protocol) without a "
                        "preceding typed handler and without re-raising or "
                        "forwarding — upstream classification (HTTP status, "
                        "replan/shed) is silently lost"))
                findings += self._check_state_leak(u, node, h)
            seen_names |= names
        return findings

    def _check_state_leak(self, u, node: ast.Try,
                          h: ast.ExceptHandler) -> list[Finding]:
        # claims: inside the try body, or in the with-block immediately
        # preceding the try in the same statement list
        claims = _claims_in(node.body)
        prev = self._prev_sibling(u.node, node)
        if prev is not None:
            claims = {**_claims_in([prev]), **claims}
        if not claims:
            return []
        restored = self._restored_attrs(u, h)
        for stmt in h.body:
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Raise):
                    return []
        leaked = {a: ln for a, ln in claims.items() if a not in restored}
        if len(leaked) < len(claims):
            return []        # some claimed state restored: treated as handled
        attr, line = sorted(leaked.items())[0]
        return [Finding(
            "except-state-leak", u.path, h.lineno, u.qualname,
            f"leak:{attr}",
            f"state claimed from self.{attr} under a lock before/inside "
            "this try is neither restored nor re-raised in the broad "
            "handler — a publish/commit failure silently drops the claimed "
            "rows; restore the claim (see downsample._emit_complete) or "
            "re-raise")]

    @staticmethod
    def _prev_sibling(fn: ast.AST, target: ast.Try) -> ast.stmt | None:
        for node in ast.walk(fn):
            body = getattr(node, "body", None)
            for part in (body, getattr(node, "orelse", None),
                         getattr(node, "finalbody", None)):
                if not isinstance(part, list):
                    continue
                for i, stmt in enumerate(part):
                    if stmt is target:
                        return part[i - 1] if i else None
        return None

    def _restored_attrs(self, u, h: ast.ExceptHandler) -> set:
        out: set = set()
        index = self.project
        for stmt in h.body:
            for sub in ast.walk(stmt):
                if isinstance(sub, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                    targets = sub.targets if isinstance(sub, ast.Assign) \
                        else [sub.target]
                    for t in targets:
                        root = _self_attr_root(t)
                        if root:
                            out.add(root)
                if isinstance(sub, ast.Call):
                    if isinstance(sub.func, ast.Attribute):
                        root = _self_attr_root(sub.func.value)
                        if root and sub.func.attr in (
                                "update", "extend", "append", "add",
                                "setdefault", "insert", "appendleft"):
                            out.add(root)
                    # one helper hop: self._requeue_...() restoring the attr
                    if index is not None:
                        key = index.resolve_call(u.path, u.cls, sub)
                        uu = index.funcs.get(key) if key else None
                        if uu is not None:
                            for n2 in ast.walk(uu.node):
                                root = None
                                if isinstance(n2, (ast.Assign, ast.AugAssign)):
                                    tgts = n2.targets if isinstance(
                                        n2, ast.Assign) else [n2.target]
                                    for t in tgts:
                                        root = _self_attr_root(t) or root
                                elif isinstance(n2, ast.Call) and \
                                        isinstance(n2.func, ast.Attribute):
                                    root = _self_attr_root(n2.func.value)
                                if root:
                                    out.add(root)
        return out
