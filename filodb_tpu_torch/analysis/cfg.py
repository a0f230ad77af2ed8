"""Per-function control-flow graph + all-paths release analysis.

The resource-lifecycle rules need path sensitivity the lexical checkers
never had: "this file handle is closed" is not a fact about the function,
it is a fact about every path from the ``open()`` to the function exit —
including the exceptional ones. The CFG here is statement-granular and
deliberately small:

  * nodes are statements; EXIT is a synthetic sink;
  * ``if``/``while``/``for`` contribute both arms (loops: body + skip +
    back edge; ``break``/``continue`` resolve to the innermost loop);
  * ``return`` / ``raise`` route through every enclosing ``finally`` block
    (inner to outer) and then to EXIT;
  * inside a ``try`` body, every statement that contains a call (or other
    raise-capable expression) gets an edge to each handler entry and to
    the ``finally`` entry — the "any statement may raise" approximation;
  * OUTSIDE any try, a raise-capable statement gets an edge toward the
    enclosing ``finally`` chain and EXIT, so an unguarded exception path
    is visible to the analysis.

``releases_on_all_paths`` then answers the rule's question directly: from
the acquire statement, can EXIT be reached without passing a release
statement?  Over-approximated paths (a finally entered from contexts that
cannot mix) can only produce false *findings*, never false silence, and
in practice the repo's release idioms (``with``, ``try/finally``) are
exactly the shapes the approximation models faithfully.
"""

from __future__ import annotations

import ast

EXIT = -1


def _may_raise_stmt(stmt: ast.stmt) -> bool:
    """Can evaluating this statement plausibly raise? Calls, subscripts and
    attribute loads are the realistic sources; constants/pass/simple name
    rebinds are not."""
    for node in ast.walk(stmt):
        if isinstance(node, (ast.Call, ast.Subscript, ast.BinOp, ast.Raise)):
            return True
        if isinstance(node, ast.Attribute) and isinstance(node.ctx, ast.Load):
            return True
    return False


class CFG:
    def __init__(self):
        self.stmts: list[ast.stmt] = []
        self.succ: dict[int, set[int]] = {EXIT: set()}
        # exceptional edges kept separate: the must-release query ignores
        # them for the ACQUIRE node itself (if the acquisition raises, the
        # resource was never acquired) but follows them everywhere else
        self.exc_succ: dict[int, set[int]] = {}

    def _node(self, stmt: ast.stmt) -> int:
        idx = len(self.stmts)
        self.stmts.append(stmt)
        self.succ[idx] = set()
        self.exc_succ[idx] = set()
        return idx

    def _link(self, frm: set[int], to: int) -> None:
        for f in frm:
            self.succ[f].add(to)

    def node_of(self, stmt: ast.stmt) -> int | None:
        for i, s in enumerate(self.stmts):
            if s is stmt:
                return i
        return None


_BROAD = {"Exception", "BaseException"}


def _frame_is_terminal(handlers: list) -> bool:
    """Does some handler in this try frame catch EVERYTHING (bare except /
    Exception / BaseException)? Only then can an exception not continue
    outward."""
    for h in handlers:
        t = h.type
        if t is None:
            return True
        names = t.elts if isinstance(t, ast.Tuple) else [t]
        for n in names:
            leaf = n.attr if isinstance(n, ast.Attribute) else \
                (n.id if isinstance(n, ast.Name) else None)
            if leaf in _BROAD:
                return True
    return False


class _Builder:
    def __init__(self):
        self.g = CFG()
        # innermost-first stacks
        self._loops: list[tuple[set[int], int]] = []   # (break-outs, head)
        # (handler entry nodes, frame catches-everything?) per enclosing try
        self._handlers: list[tuple[list[int], bool]] = []
        self._finals: list[int] = []                   # finally entry nodes

    # every raise-capable stmt gets edges to the active handler entries of
    # EVERY enclosing frame up to (and including) the first terminal one —
    # an exception of a type a frame doesn't catch continues outward; with
    # no terminal frame it escapes through the finally chain to EXIT
    def _exceptional_edges(self, idx: int,
                           edges: dict | None = None) -> None:
        edges = self.g.exc_succ if edges is None else edges
        for entries, terminal in reversed(self._handlers):
            for entry in entries:
                edges[idx].add(entry)
            if terminal:
                return
        for entry in reversed(self._finals):
            edges[idx].add(entry)
            return
        edges[idx].add(EXIT)

    def _to_exit(self, frm: set[int]) -> None:
        """Route a frontier through enclosing finally blocks, then EXIT."""
        for entry in reversed(self._finals):
            self.g._link(frm, entry)
            return      # the finally subgraph's own exits continue the chain
        self.g._link(frm, EXIT)

    def seq(self, stmts: list[ast.stmt], frontier: set[int]) -> set[int]:
        for stmt in stmts:
            frontier = self.stmt(stmt, frontier)
            if not frontier:
                break               # unreachable tail
        return frontier

    def stmt(self, stmt: ast.stmt, frontier: set[int]) -> set[int]:
        g = self.g
        if isinstance(stmt, ast.If):
            n = g._node(stmt)
            g._link(frontier, n)
            out = self.seq(stmt.body, {n})
            out |= self.seq(stmt.orelse, {n}) if stmt.orelse else {n}
            return out
        if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            n = g._node(stmt)
            g._link(frontier, n)
            breaks: set[int] = set()
            self._loops.append((breaks, n))
            body_out = self.seq(stmt.body, {n})
            self._loops.pop()
            g._link(body_out, n)                      # back edge
            out = {n} | breaks
            out |= self.seq(stmt.orelse, {n}) if stmt.orelse else set()
            return out
        if isinstance(stmt, ast.Break):
            n = g._node(stmt)
            g._link(frontier, n)
            if self._loops:
                self._loops[-1][0].add(n)
            return set()
        if isinstance(stmt, ast.Continue):
            n = g._node(stmt)
            g._link(frontier, n)
            if self._loops:
                g.succ[n].add(self._loops[-1][1])
            return set()
        if isinstance(stmt, ast.Raise):
            n = g._node(stmt)
            g._link(frontier, n)
            # a raise DEFINITELY transfers control: route through every
            # enclosing non-terminal handler frame (normal edges — the
            # must-release query must always follow them)
            self._exceptional_edges(n, edges=g.succ)
            return set()
        if isinstance(stmt, ast.Return):
            n = g._node(stmt)
            g._link(frontier, n)
            self._to_exit({n})
            return set()
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            n = g._node(stmt)
            g._link(frontier, n)
            if _may_raise_stmt(stmt):
                self._exceptional_edges(n)
            return self.seq(stmt.body, {n})
        if isinstance(stmt, (ast.Try, getattr(ast, "TryStar", ast.Try))):
            return self._try(stmt, frontier)
        # simple statement
        n = g._node(stmt)
        g._link(frontier, n)
        if _may_raise_stmt(stmt):
            self._exceptional_edges(n)
        return {n}

    def _try(self, stmt: ast.Try, frontier: set[int]) -> set[int]:
        g = self.g
        fin_entry = None
        fin_out: set[int] = set()
        if stmt.finalbody:
            # the finally block is built TWICE — one copy per entry context.
            # This (exceptional) copy is what raise statements and implicit
            # exception edges route into; after it runs, the in-flight
            # exception CONTINUES outward (outer frames / EXIT), never into
            # the code after the try. A separate normal-flow copy is built
            # below, so the two contexts can't contaminate each other's
            # paths (a shared copy gave the normal path a phantom EXIT edge)
            fin_entry = g._node(stmt.finalbody[0])
            fin_out = self.seq(stmt.finalbody[1:], {fin_entry})
            self._finals.append(fin_entry)
        handler_entries: list[int] = []
        handler_nodes: list[tuple[ast.ExceptHandler, int]] = []
        for h in stmt.handlers:
            entry = g._node(h)
            handler_entries.append(entry)
            handler_nodes.append((h, entry))
        if handler_entries:
            self._handlers.append((handler_entries,
                                   _frame_is_terminal(stmt.handlers)))
        body_out = self.seq(stmt.body, frontier)
        if handler_entries:
            self._handlers.pop()
        out: set[int] = set()
        for h, entry in handler_nodes:
            h_out = self.seq(h.body, {entry})
            # an exception inside a handler propagates outward
            out |= h_out
        body_out = self.seq(stmt.orelse, body_out) if stmt.orelse \
            else body_out
        out |= body_out
        if fin_entry is not None:
            self._finals.pop()
            # the exceptional copy's exit continues the in-flight exception
            # outward (definite transfer: normal edges, like a raise)
            for n in sorted(fin_out or {fin_entry}):
                self._exceptional_edges(n, edges=g.succ)
            # normal-flow copy: body/handler completions run it, then
            # control proceeds to the statements after the try
            fin_entry_norm = g._node(stmt.finalbody[0])
            fin_out_norm = self.seq(stmt.finalbody[1:], {fin_entry_norm})
            g._link(out, fin_entry_norm)
            out = fin_out_norm or {fin_entry_norm}
        return out


def build_cfg(fn: ast.AST) -> CFG:
    b = _Builder()
    out = b.seq(getattr(fn, "body", []), set())
    b.g._link(out, EXIT)
    return b.g


def releases_on_all_paths(cfg: CFG, acquire_idx: int, release) -> bool:
    """True iff every CFG path from ``acquire_idx`` to EXIT passes a
    statement for which ``release(stmt)`` is True. The acquire node's OWN
    exceptional edge is excluded — if the acquisition raises, there is
    nothing to release — but every later node's exceptional edges count."""
    seen = set()
    todo = list(cfg.succ.get(acquire_idx, ()))
    while todo:
        n = todo.pop()
        if n in seen:
            continue
        seen.add(n)
        if n == EXIT:
            return False
        if release(cfg.stmts[n]):
            continue
        todo.extend(cfg.succ.get(n, ()))
        todo.extend(cfg.exc_succ.get(n, ()))
    return True


def dominated_from_entry(cfg: CFG, idx: int, pred) -> bool:
    """True iff every CFG path from function ENTRY to ``idx`` passes a
    statement for which ``pred(stmt)`` is True — classical dominance of a
    predicate over ``idx``. Walks forward from node 0 (the first statement
    is always node 0: the builder numbers statements in visit order),
    stopping at pred-satisfying nodes; if ``idx`` is still reachable, some
    path avoids the predicate."""
    if not cfg.stmts:
        return False
    if pred(cfg.stmts[0]) and idx != 0:
        return True
    if idx == 0:
        return False
    seen = {0}
    todo = list(cfg.succ.get(0, ())) + list(cfg.exc_succ.get(0, ()))
    while todo:
        n = todo.pop()
        if n in seen or n == EXIT:
            continue
        seen.add(n)
        if n == idx:
            return False
        if pred(cfg.stmts[n]):
            continue
        todo.extend(cfg.succ.get(n, ()))
        todo.extend(cfg.exc_succ.get(n, ()))
    return True


def backedge_dominated(cfg: CFG, head: int, pred) -> bool:
    """True iff every CFG path from the loop statement at ``head`` BACK to
    itself passes a statement for which ``pred(stmt)`` is True — the
    value-flow question behind bounded-retry checking: an attempt-count
    guard (``if attempt >= max: raise``) bounds the loop only when the
    guard is evaluated on every iteration, i.e. it dominates the back
    edge. Paths that LEAVE the loop (break / return / the loop-exit
    continuation) never re-reach ``head`` and are vacuously fine. A loop
    whose back edge is unreachable (every iteration returns or raises)
    is vacuously dominated."""
    seen: set = set()
    todo = list(cfg.succ.get(head, ())) + list(cfg.exc_succ.get(head, ()))
    while todo:
        n = todo.pop()
        if n == head:
            return False            # completed an iteration pred-free
        if n in seen or n == EXIT:
            continue
        seen.add(n)
        if pred(cfg.stmts[n]):
            continue
        todo.extend(cfg.succ.get(n, ()))
        todo.extend(cfg.exc_succ.get(n, ()))
    return True


def guarded_between(cfg: CFG, frm: int, target_pred, guard_pred) -> bool:
    """True iff every CFG path from ``frm`` to a target-matching statement
    passes a guard statement first — the deadline-bounds-the-socket query:
    from the socket's creation, every path to its first blocking op must
    cross a ``settimeout``. Unreachable targets are vacuously guarded."""
    seen: set = set()
    todo = list(cfg.succ.get(frm, ())) + list(cfg.exc_succ.get(frm, ()))
    while todo:
        n = todo.pop()
        if n in seen or n == EXIT:
            continue
        seen.add(n)
        if guard_pred(cfg.stmts[n]):
            continue
        if target_pred(cfg.stmts[n]):
            return False
        todo.extend(cfg.succ.get(n, ()))
        todo.extend(cfg.exc_succ.get(n, ()))
    return True


def covered_on_all_paths(cfg: CFG, idx: int, pred) -> bool:
    """True iff the statement at ``idx`` is *fenced* by the predicate: every
    path from ENTRY to ``idx`` passes a pred statement, OR every path from
    ``idx`` to EXIT does. This is the epoch-bump coverage query — a
    visibility mutation is safe whether the bump precedes it (flush stages:
    bump, then scatter) or follows it (compaction: compact, then bump), as
    long as both run under one lock hold. Mixed coverage (some paths fenced
    before, the rest after) is deliberately NOT accepted: it would be
    correct only if no path exists that misses both, and proving that
    needs a per-path product the repo's idioms never require — the
    over-approximation can only produce findings, never silence."""
    return dominated_from_entry(cfg, idx, pred) \
        or releases_on_all_paths(cfg, idx, pred)
