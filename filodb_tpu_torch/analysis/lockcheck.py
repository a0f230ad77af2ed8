"""Lock-discipline checker.

Invariants (see core/memstore.py:140-144 — the shard lock guards the donating
device append against concurrent query capture/dispatch):

  * ``lock-unheld-call`` — a call to a ``*_locked`` method must come from a
    holder: a function that is itself ``*_locked``, or a call site lexically
    inside ``with <owner lock>:`` (the owning object's ``lock`` / ``_lock`` /
    ``owner_lock``). Group-flush and sink locks do NOT qualify — they guard
    different resources.
  * ``lock-unheld-write`` — state written by ``*_locked`` methods (including
    container mutators: append/pop/update/...) is shard state; writing it
    from a non-holder races the lock-holding mutators. ``__init__`` is exempt
    (no concurrency before construction completes).
  * ``lock-guard-inconsistent`` — a class that guards writes to an attribute
    under ``with self.<some lock>:`` in one method but READ-MODIFY-WRITES the
    same attribute unguarded in another (classic lost-update shape for
    metrics counters updated from dispatch threads). Plain rebinding
    assignments are GIL-atomic and exempt — only += / subscript stores /
    container mutators count.
  * ``lock-order-cycle`` / ``lock-order`` — nested ``with`` acquisitions
    (lexical, plus same-class ``self.method()`` propagation) build a directed
    graph over the lock CLASSES (group_flush, sink, shard). A cycle is a
    potential deadlock; an edge contradicting the declared global order
    (utils/diagnostics.LOCK_ORDER — also asserted at runtime under
    FILODB_LOCK_DEBUG=1) is an ordering violation.

Holder forms recognized: the ``_locked`` suffix, a lexical ``with <owner
lock>:``, ``stack.enter_context(<owner lock>)`` (multi-shard ExitStack
acquisition — treated as held for the rest of the function), a
``diagnostics.assert_owned(self.lock, ...)`` call in the body (the contract
is then runtime-checked instead), and — new in v2 — the INHERITED holder: a
private helper (leading underscore) every one of whose in-class call sites
holds the owner lock inherits the fact, transitively through other inherited
helpers (computed as a shrinking fixpoint).  That closes PR 3's documented
lexical blind spot: ``def _bump(self)`` called only from inside ``with
self.lock:`` no longer needs a rename or a suppression.  A helper with even
ONE non-holder call site — or with no in-class call site at all (it may be
called externally) — still must carry the suffix or the runtime assert.
Remaining pure-AST limits (ANALYSIS.md): bare .acquire()/.release() pairs,
and private helpers invoked from OUTSIDE their class, are not recognized.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from .findings import Finding

# attribute names that, used as a `with` context manager, count as holding the
# OWNING OBJECT's lock (qualifies as holder for *_locked calls / writes)
OWNER_LOCK_ATTRS = {"lock", "_lock", "owner_lock"}

# lock CLASS names for the order graph; must match utils/diagnostics.LOCK_ORDER
LOCK_CLASS_OF_ATTR = {
    "lock": "shard", "owner_lock": "shard",
    "_sink_lock": "sink",
}
GROUP_FLUSH_ATTR = "_group_flush_locks"
# declared global acquisition order (rank increases left to right); kept in
# sync with filodb_tpu_torch/utils/diagnostics.py LOCK_ORDER (the runtime
# assert) — tests/test_torch_static_analysis.py cross-checks the two.
LOCK_ORDER = ("group_flush", "sink", "shard")

MUTATOR_METHODS = {"append", "extend", "insert", "pop", "popitem", "remove",
                   "discard", "clear", "update", "add", "setdefault",
                   "appendleft", "popleft"}


def lock_class_of(expr: ast.expr) -> str | None:
    """Classify a `with` context expression as one of the ordered lock
    classes, "object" (an unranked per-object `_lock`), or None (not a
    recognized lock)."""
    if isinstance(expr, ast.Subscript):
        base = expr.value
        if isinstance(base, ast.Attribute) and base.attr == GROUP_FLUSH_ATTR:
            return "group_flush"
        return None
    if isinstance(expr, ast.Attribute):
        cls = LOCK_CLASS_OF_ATTR.get(expr.attr)
        if cls:
            return cls
        if expr.attr == "_lock":
            return "object"
        return None
    if isinstance(expr, ast.Name):
        # bare `with lock:` in module-level helpers / fixtures
        if expr.id in ("lock", "owner_lock"):
            return "shard"
        if expr.id == "_lock":
            return "object"
    return None


def _is_owner_lock(expr: ast.expr) -> bool:
    """Does this `with` context hold the owning object's lock (holder-
    qualifying for *_locked calls and locked-state writes)?"""
    if isinstance(expr, ast.Attribute):
        return expr.attr in OWNER_LOCK_ATTRS
    if isinstance(expr, ast.Name):
        return expr.id in OWNER_LOCK_ATTRS
    return False


def _self_attr_root(target: ast.expr) -> str | None:
    """The first attribute name of a `self.X...` store target ("X"), walking
    through nested attributes/subscripts (self.a.b, self.a[i]) — writes are
    tracked at the granularity of the object hanging off self."""
    node = target
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        parent = node.value
        if isinstance(node, ast.Attribute) and isinstance(parent, ast.Name) \
                and parent.id == "self":
            return node.attr
        node = parent
    return None


@dataclass
class _FuncInfo:
    name: str
    qualname: str
    node: ast.AST
    is_locked: bool                      # name ends with _locked
    direct_locks: set = field(default_factory=set)   # lock classes acquired
    calls: set = field(default_factory=set)          # self.X() callee names


class _FunctionScanner(ast.NodeVisitor):
    """Single pass over one function: tracks the lexical stack of held locks,
    records *_locked calls, self-attr writes, acquisitions, and (for the
    order graph) which self-methods are called under which held lock."""

    def __init__(self, info: _FuncInfo):
        self.info = info
        self.held: list[tuple[str | None, bool]] = []  # (lock_class, owner?)
        self.locked_calls: list[tuple[ast.Call, str, bool]] = []
        # (node, attr, holder?, guard_class, rmw?)
        self.writes: list[tuple[ast.AST, str, bool, str | None, bool]] = []
        self.nested_edges: list[tuple[str, str, int]] = []
        self.calls_under: list[tuple[str, str, int]] = []  # (lockcls, callee, line)
        # every self.X() site with the lexical holder state at the site —
        # feeds the v2 inherited-holder fixpoint
        self.self_call_sites: list[tuple[str, bool]] = []
        # set by enter_context(<owner lock>) / assert_owned(...): the rest of
        # the function counts as holding the owner lock
        self.asserted_owner = False

    def _holding_owner(self) -> bool:
        return (self.info.is_locked or self.asserted_owner
                or any(o for _, o in self.held))

    def _held_classes(self) -> list[str]:
        return [c for c, _ in self.held if c and c != "object"]

    def visit_With(self, node: ast.With):  # noqa: N802
        entered = 0
        for item in node.items:
            cls = lock_class_of(item.context_expr)
            owner = _is_owner_lock(item.context_expr)
            if cls is None and not owner:
                continue
            if cls is not None:
                for h in self._held_classes():
                    if h != cls:
                        self.nested_edges.append((h, cls, node.lineno))
                if cls != "object":
                    self.info.direct_locks.add(cls)
            self.held.append((cls, owner))
            entered += 1
        for stmt in node.body:
            self.visit(stmt)
        for _ in range(entered):
            self.held.pop()

    visit_AsyncWith = visit_With

    def visit_Call(self, node: ast.Call):  # noqa: N802
        func = node.func
        callee = None
        if isinstance(func, ast.Attribute):
            callee = func.attr
            if isinstance(func.value, ast.Name) and func.value.id == "self":
                self.info.calls.add(callee)
                self.self_call_sites.append((callee, self._holding_owner()))
                for h in self._held_classes():
                    self.calls_under.append((h, callee, node.lineno))
        elif isinstance(func, ast.Name):
            callee = func.id
        # ExitStack multi-lock acquisition / runtime ownership assert: both
        # make the rest of this function a holder
        if callee == "enter_context" and node.args \
                and _is_owner_lock(node.args[0]):
            self.asserted_owner = True
        if callee == "assert_owned" and node.args \
                and _is_owner_lock(node.args[0]):
            self.asserted_owner = True
        if callee and callee.endswith("_locked"):
            self.locked_calls.append((node, callee, self._holding_owner()))
        self.generic_visit(node)

    def _record_write(self, target: ast.expr, line_node: ast.AST,
                      rmw: bool = False):
        attr = _self_attr_root(target)
        if attr is not None:
            # a subscript / nested-attribute store mutates shared structure
            # in place (read-modify-write); rebinding self.X is GIL-atomic
            rmw = rmw or not (isinstance(target, ast.Attribute)
                              and isinstance(target.value, ast.Name))
            self.writes.append((line_node, attr, self._holding_owner(),
                                self._guard_class(), rmw))

    def _guard_class(self) -> str | None:
        """The innermost recognized lock class currently held (any class —
        used by the guard-consistency rule, which is per-attribute, not
        owner-specific)."""
        for cls, owner in reversed(self.held):
            if cls is not None or owner:
                return cls or "shard"
        return None

    def visit_Assign(self, node: ast.Assign):  # noqa: N802
        for t in node.targets:
            self._record_write(t, node)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign):  # noqa: N802
        self._record_write(node.target, node, rmw=True)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign):  # noqa: N802
        if node.value is not None:
            self._record_write(node.target, node)
        self.generic_visit(node)

    # container mutators count as writes to the container attribute
    def _maybe_mutator(self, node: ast.Call):
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr in MUTATOR_METHODS:
            attr = _self_attr_root(func.value)
            if attr is not None:
                self.writes.append((node, attr, self._holding_owner(),
                                    self._guard_class(), True))

    # nested defs: conservatively descend (closures run on the same thread
    # unless handed to an executor; lexical lock state is the best signal)
    def visit_FunctionDef(self, node):  # noqa: N802
        self.generic_visit(node)

    def generic_visit(self, node):
        if isinstance(node, ast.Call):
            self._maybe_mutator(node)
        super().generic_visit(node)


class LockChecker:
    """Per-module pass + cross-module finalize (order graph over the repo)."""

    rules = ("lock-unheld-call", "lock-unheld-write", "lock-guard-inconsistent",
             "lock-order", "lock-order-cycle")

    def __init__(self):
        self._edges: list[tuple[str, str, str, int]] = []  # a, b, path, line

    def check_module(self, path: str, tree: ast.Module) -> list[Finding]:
        findings: list[Finding] = []
        for cls in [n for n in tree.body if isinstance(n, ast.ClassDef)]:
            findings += self._check_class(path, cls)
        # module-level functions: *_locked calls / order edges only
        for fn in [n for n in tree.body
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]:
            info = _FuncInfo(fn.name, fn.name, fn,
                             fn.name.endswith("_locked"))
            sc = _FunctionScanner(info)
            for stmt in fn.body:
                sc.visit(stmt)
            findings += self._call_findings(path, fn.name, sc)
            for a, b, line in sc.nested_edges:
                self._edges.append((a, b, path, line))
        return findings

    def _check_class(self, path: str, cls: ast.ClassDef) -> list[Finding]:
        findings: list[Finding] = []
        methods = {n.name: n for n in cls.body
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        infos: dict[str, _FuncInfo] = {}
        scanners: dict[str, _FunctionScanner] = {}
        for name, fn in methods.items():
            info = _FuncInfo(name, f"{cls.name}.{name}", fn,
                             name.endswith("_locked"))
            sc = _FunctionScanner(info)
            for stmt in fn.body:
                sc.visit(stmt)
            infos[name] = info
            scanners[name] = sc

        # interprocedural holder inheritance (v2): a PRIVATE helper whose
        # every in-class call site holds the owner lock inherits the holder
        # fact, transitively. Shrinking fixpoint: start optimistic, demote a
        # candidate when any site's caller neither holds lexically, is
        # *_locked, nor (still) inherits.
        sites: dict[str, list[tuple[str, bool]]] = {}
        for caller, sc in scanners.items():
            for callee, held in sc.self_call_sites:
                if callee in methods:
                    sites.setdefault(callee, []).append((caller, held))
        # a method whose REFERENCE escapes (Thread(target=self._m), a stored
        # callback) can run from anywhere — the call-site census is
        # incomplete for it, so it must never inherit the holder fact
        escaped_refs: set[str] = set()
        for fn in methods.values():
            call_funcs = {id(n.func) for n in ast.walk(fn)
                          if isinstance(n, ast.Call)}
            for n in ast.walk(fn):
                if isinstance(n, ast.Attribute) \
                        and isinstance(n.value, ast.Name) \
                        and n.value.id == "self" \
                        and isinstance(n.ctx, ast.Load) \
                        and id(n) not in call_funcs and n.attr in methods:
                    escaped_refs.add(n.attr)
        inherited = {m: True for m in methods
                     if m.startswith("_") and not m.startswith("__")
                     and m not in escaped_refs and sites.get(m)}
        changed = True
        while changed:
            changed = False
            for m in inherited:
                if not inherited[m]:
                    continue
                for caller, held in sites[m]:
                    if not (held or infos[caller].is_locked
                            or inherited.get(caller, False)):
                        inherited[m] = False
                        changed = True
                        break
        holder_inherited = {m for m, ok in inherited.items() if ok}

        # protected state: attrs written by *_locked methods
        protected: set[str] = set()
        for name, sc in scanners.items():
            if infos[name].is_locked:
                protected.update(attr for _, attr, _, _, _ in sc.writes)

        # per-attribute guard census for lock-guard-inconsistent
        guarded_attrs: dict[str, set[str]] = {}
        for name, sc in scanners.items():
            if name == "__init__":
                continue
            for _, attr, _, guard, _ in sc.writes:
                if guard is not None:
                    guarded_attrs.setdefault(attr, set()).add(
                        infos[name].qualname)

        for name, sc in scanners.items():
            qual = infos[name].qualname
            is_inherited = name in holder_inherited
            findings += self._call_findings(path, qual, sc,
                                            exempt=is_inherited)
            if name == "__init__":
                continue
            for node, attr, holder, guard, rmw in sc.writes:
                if attr in protected and not holder \
                        and not infos[name].is_locked and not is_inherited:
                    findings.append(Finding(
                        "lock-unheld-write", path, node.lineno, qual,
                        f"write:{attr}",
                        f"writes self.{attr} (state mutated by *_locked "
                        f"methods of {cls.name}) without holding the owner "
                        "lock — wrap in `with self.lock:` or rename the "
                        "method *_locked"))
                elif attr not in protected and guard is None and rmw \
                        and attr in guarded_attrs \
                        and qual not in guarded_attrs[attr]:
                    findings.append(Finding(
                        "lock-guard-inconsistent", path, node.lineno, qual,
                        f"guard:{attr}",
                        f"read-modify-writes self.{attr} unguarded, but "
                        f"{sorted(guarded_attrs[attr])[0]} guards the same "
                        "attribute under a lock — concurrent updates lose "
                        "increments; take the lock on both paths"))

        # order edges: lexical + one-hop self-call propagation with
        # transitive closure of each method's acquisitions
        trans: dict[str, set[str]] = {n: set(i.direct_locks)
                                      for n, i in infos.items()}
        changed = True
        while changed:
            changed = False
            for name, info in infos.items():
                for callee in info.calls:
                    if callee in trans and not trans[callee] <= trans[name]:
                        trans[name] |= trans[callee]
                        changed = True
        for name, sc in scanners.items():
            for a, b, line in sc.nested_edges:
                self._edges.append((a, b, path, line))
            for lockcls, callee, line in sc.calls_under:
                for acquired in trans.get(callee, ()):
                    if acquired != lockcls:
                        self._edges.append((lockcls, acquired, path, line))
        return findings

    def _call_findings(self, path: str, qual: str, sc: _FunctionScanner,
                       exempt: bool = False) -> list[Finding]:
        if exempt:      # inherited holder: every in-class call site holds
            return []
        out = []
        for node, callee, holder in sc.locked_calls:
            if not holder:
                out.append(Finding(
                    "lock-unheld-call", path, node.lineno, qual,
                    f"call:{callee}",
                    f"calls {callee}() without holding the owner lock — "
                    "*_locked methods must run under `with <owner>.lock:` "
                    "(or from another *_locked method, or — v2 — be a "
                    "private helper whose every in-class call site holds)"))
        return out

    def finalize(self) -> list[Finding]:
        findings: list[Finding] = []
        rank = {c: i for i, c in enumerate(LOCK_ORDER)}
        graph: dict[str, set[str]] = {}
        where: dict[tuple[str, str], tuple[str, int]] = {}
        for a, b, path, line in self._edges:
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
            where.setdefault((a, b), (path, line))
        # declared-order violations
        for (a, b), (path, line) in sorted(where.items()):
            if a in rank and b in rank and rank[a] >= rank[b]:
                findings.append(Finding(
                    "lock-order", path, line, "<lock-graph>", f"{a}->{b}",
                    f"acquires {b!r} lock while holding {a!r} — violates the "
                    f"declared order {LOCK_ORDER} (diagnostics.LOCK_ORDER); "
                    "a concurrent thread taking them in order can deadlock"))
        # cycles (covers classes outside the declared order too)
        for cyc in _cycles(graph):
            a, b = cyc[0], cyc[1 % len(cyc)]
            path, line = where.get((a, b), ("<unknown>", 0))
            findings.append(Finding(
                "lock-order-cycle", path, line, "<lock-graph>",
                "->".join(cyc),
                f"lock acquisition cycle {' -> '.join(cyc + (cyc[0],))}: "
                "two threads entering at different points deadlock"))
        return findings


def _cycles(graph: dict[str, set[str]]) -> list[tuple[str, ...]]:
    """Elementary cycles via DFS (the graph has a handful of nodes)."""
    out: list[tuple[str, ...]] = []
    seen_cycles: set[frozenset] = set()

    def dfs(node: str, path: list[str], on_path: set[str]):
        for nxt in sorted(graph.get(node, ())):
            if nxt in on_path:
                cyc = tuple(path[path.index(nxt):])
                key = frozenset(cyc)
                if key not in seen_cycles:
                    seen_cycles.add(key)
                    out.append(cyc)
                continue
            path.append(nxt)
            on_path.add(nxt)
            dfs(nxt, path, on_path)
            on_path.discard(nxt)
            path.pop()

    for start in sorted(graph):
        dfs(start, [start], {start})
    return out
