"""Liveness & bounded-wait contracts: no blocking under locks, deadline-
bounded I/O, bounded retry loops.

The store's "real-time" claim is a liveness claim: one slow peer, hung
socket, or unbounded retry must not wedge a shard lock, a drain loop, or
a tenant's admission slot. PR 6 and PR 10 each caught such stalls by
hand-review (teardown behind a 30 s recv; a whole-log rewrite under all
group-flush locks); this family makes the discipline structural.
``utils/diagnostics.py`` declares the surface as ``LATENCY_SPEC`` (a
pure-literal dict, read from the AST like EPOCH_SPEC): the lock classes,
the blocking-call taxonomy, the blocking protocol surface of the sink
(``self.sink.*`` is unresolvable by the call graph, so it is declared
the way EPOCH_SPEC declares visible_calls), and the sanctioned sites —
each with a REQUIRED reason string saying why it is allowed to block.

Rules (interprocedural — PackageIndex closure + shared per-function
CFGs):

  * ``live-block-under-lock`` — no socket connect/recv/send/accept, file
    open, ``time.sleep``, ``Thread.join``, subprocess, or HTTP call on
    any CFG path while a shard/group/sink lock is held (lexical
    ``with``, ``_locked``-suffix contract on a lock-owner class,
    ``enter_context``, or ``assert_owned``). Blocking propagates through
    undeclared helpers exactly like epochcheck's obligations: a helper
    that sleeps taints every undeclared caller, and the finding lands
    where the lock is held. A declared site caps its subtree — whatever
    it does is its stated responsibility.
  * ``live-unbounded-io`` — every socket created or connected must be
    deadline-bounded before its first blocking op on ALL CFG paths:
    ``create_connection`` needs a timeout argument (which the stdlib
    applies to the socket itself, so it bounds later recv/send too);
    a raw ``socket.socket()`` needs a ``settimeout`` that dominates
    every path from creation to the first connect/accept/recv/send.
    A socket that never blocks (bind-and-inspect, like free_port) is
    vacuously fine.
  * ``live-unbounded-retry`` — a retry loop (a ``while`` whose body
    retries a failed operation via try/except, or a ``for … in
    range(…)`` attempt loop) must carry a statically visible bound AND a
    backoff. Bound evidence is value-flow: a counter compared in the
    loop test and advanced in the body, a deadline (``time.monotonic``
    or a deadline-named value) in the test, a stop-event ``.wait(t)`` /
    ``.is_set()`` pacing test, or a guard (``if attempt >= max: raise``)
    that DOMINATES the loop back edge — a guard a path can skip bounds
    nothing. Backoff evidence: a sleep (direct or through a resolved
    helper — the taint fixpoint above), a timed ``.wait``/``.get``, or
    a backoff-named call. Serve loops on thread entries that reference
    a shutdown signal are exempt: they are bounded by shutdown and the
    resource family already requires them to survive faults.
  * ``live-wait-no-timeout`` — ``Condition.wait``/``Event.wait`` with no
    timeout, ``Queue.get()`` with neither timeout nor block=False, and
    zero-argument ``thread.join()`` park a thread on a wakeup that one
    lost notify, dead producer, or wedged peer cancels forever. Every
    such wait needs a timeout operand (re-check your predicate; you were
    going to loop anyway) or a declared shutdown-aware wrapper in
    LATENCY_SPEC's ``wait_ok``.

Sanctions: ``sites`` (rule 1) and ``wait_ok`` (rule 4) entries are
``{name: {"fn": "Class.method", "reason": "..."}}``; an entry with no
reason is itself a finding. Sanction extends down reverse-call chains
via ``reachable_only_from`` — a helper only callable from declared
sites inherits their sanction.

Fixture twins: bad/good_live_{block,io,retry,wait}.py. Pure stdlib
``ast``; no torch import.
"""

from __future__ import annotations

import ast
import re
import time

from .callgraph import dotted_name, leaf_name
from .cfg import CFG, backedge_dominated, guarded_between
from .findings import Finding

_SPEC_NAME = "LATENCY_SPEC"

_SOCK_BLOCKING_OPS = ("connect", "accept", "recv", "recv_into", "recvfrom",
                      "send", "sendall", "makefile")
_SLEEP_LEAVES = ("sleep", "_sleep")
_CLOCK_LEAVES = ("monotonic", "time", "perf_counter")
_SHUTDOWN_RE = re.compile(
    r"stop|shutdown|closed?|running|done|cancel|alive|quit|halt",
    re.IGNORECASE)
_DEADLINE_RE = re.compile(r"deadline|until|budget|expir", re.IGNORECASE)
_QUEUE_RECV_RE = re.compile(r"(?:^|_)q(?:ueue)?s?\d*$|queue", re.IGNORECASE)


def _own_nodes(fn: ast.AST):
    """Walk a function's body without descending into nested defs (nested
    functions are their own FuncUnits)."""
    todo = list(getattr(fn, "body", []))
    while todo:
        node = todo.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            todo.append(child)


def _subtree_no_defs(root: ast.AST):
    """Walk a subtree (including ``root``) without entering nested defs."""
    todo = [root]
    while todo:
        node = todo.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            todo.append(child)


def _stmt_map_of(cfg: CFG) -> dict[int, int]:
    """id(node) -> index of the innermost CFG statement containing it
    (compound statements are CFG nodes too, so the smallest subtree
    wins). One walk per CFG; lookups are O(1) after that."""
    best: dict[int, tuple[int, int]] = {}       # id -> (size, index)
    for i, s in enumerate(cfg.stmts):
        subs = list(ast.walk(s))
        size = len(subs)
        for sub in subs:
            got = best.get(id(sub))
            if got is None or size < got[0]:
                best[id(sub)] = (size, i)
    return {k: i for k, (_sz, i) in best.items()}


def _names_in(node: ast.AST):
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            yield n.id
        elif isinstance(n, ast.Attribute):
            yield n.attr


def _target_names(t: ast.AST):
    """Plain names an assignment target binds — recursing through tuple/
    list/star unpacking (``ready, _, _ = select.select(...)``) but NOT
    into attribute/subscript targets, whose value names aren't bindings."""
    if isinstance(t, ast.Name):
        yield t.id
    elif isinstance(t, (ast.Tuple, ast.List)):
        for e in t.elts:
            yield from _target_names(e)
    elif isinstance(t, ast.Starred):
        yield from _target_names(t.value)


def _end_line(node: ast.AST) -> int:
    return max((s.lineno for s in ast.walk(node) if hasattr(s, "lineno")),
               default=getattr(node, "lineno", 0))


def _extract_spec(tree: ast.Module) -> tuple[dict, int] | None:
    """The module's ``LATENCY_SPEC`` literal and its line, or None.
    literal_eval keeps the contract honest: a computed spec cannot be
    statically checked."""
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == _SPEC_NAME:
            try:
                spec = ast.literal_eval(node.value)
            except (ValueError, SyntaxError):
                return None
            return (spec, node.lineno) if isinstance(spec, dict) else None
    return None


def _lock_class_of(expr: ast.expr, locks: dict) -> str | None:
    """``self.lock`` / ``self._group_flush_locks[g]`` / a bare spec-named
    Name -> the declared lock class, else None."""
    node = expr
    if isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute):
        return locks.get(node.attr)
    if isinstance(node, ast.Name):
        return locks.get(node.id)
    return None


def _is_thread_join(call: ast.Call) -> bool:
    """A join that can PARK the calling thread: zero args, or one numeric
    timeout. ``",".join(parts)`` / ``os.path.join(a, b)`` take non-numeric
    arguments and never match."""
    if any(kw.arg not in ("timeout",) for kw in call.keywords):
        return False
    if not call.args:
        return True
    if len(call.args) == 1 and isinstance(call.args[0], ast.Constant) \
            and isinstance(call.args[0].value, (int, float)) \
            and not isinstance(call.args[0].value, bool):
        return True
    return False


def _timed_call(call: ast.Call) -> bool:
    """Does this wait/get carry a bound (positional timeout or kwarg)?"""
    if call.args:
        return True
    return any(kw.arg in ("timeout", "block") for kw in call.keywords)


class LiveChecker:
    rules = ("live-block-under-lock", "live-unbounded-io",
             "live-unbounded-retry", "live-wait-no-timeout")

    # the one module whose spec governs cross-file analysis in a full run;
    # a fixture twin's own spec governs only itself
    GLOBAL_SPEC_PATH = re.compile(r"(?:^|/)utils/diagnostics\.py$")

    def __init__(self):
        self.project = None
        self.corpus = None
        self.sub_timings: dict[str, float] = {}
        self._modules: dict[str, ast.Module] = {}
        self._specs: dict[str, tuple[dict, int]] = {}
        self._stmt_maps: dict[int, dict[int, int]] = {}
        self._owner_cache: dict[tuple, str | None] = {}

    def check_module(self, path: str, tree: ast.Module) -> list[Finding]:
        self._modules[path] = tree
        got = _extract_spec(tree)
        if got is not None:
            self._specs[path] = got
        return []

    # -- spec resolution ------------------------------------------------------

    def _global_spec(self) -> tuple[str, dict] | None:
        for path, (spec, _line) in self._specs.items():
            if self.GLOBAL_SPEC_PATH.search(path):
                return path, spec
        if len(self._specs) == 1:
            path, (spec, _line) = next(iter(self._specs.items()))
            return path, spec
        return None

    def _spec_for(self, path: str) -> tuple[str, dict] | None:
        if path in self._specs:
            return path, self._specs[path][0]
        return self._global_spec()

    def _cfg(self, fn: ast.AST) -> CFG:
        if self.corpus is not None:
            return self.corpus.cfg(fn)
        from .cfg import build_cfg
        return build_cfg(fn)

    def _stmt_idx(self, cfg: CFG, node: ast.AST) -> int | None:
        m = self._stmt_maps.get(id(cfg))
        if m is None:
            m = self._stmt_maps[id(cfg)] = _stmt_map_of(cfg)
        return m.get(id(node))

    # -- finalize -------------------------------------------------------------

    def finalize(self) -> list[Finding]:
        findings: list[Finding] = []
        if self.project is None:
            return findings
        t0 = time.perf_counter()
        prep = self._prepare()
        self.sub_timings["prep"] = time.perf_counter() - t0
        findings += prep["spec_errors"]
        for name, fn in (("block", self._block_pass),
                         ("io", self._io_pass),
                         ("retry", self._retry_pass),
                         ("wait", self._wait_pass)):
            t0 = time.perf_counter()
            findings += fn(prep)
            self.sub_timings[name] = time.perf_counter() - t0
        return findings

    # -- shared preparation ---------------------------------------------------

    def _prepare(self) -> dict:
        """Per-spec declared sets (with reason validation), per-function
        direct blocking events, and the transitive blocking-kinds fixpoint
        that both the block-under-lock and retry-backoff queries consume."""
        spec_errors: list[Finding] = []
        declared: dict[str, set] = {}       # spec path -> sanctioned keys
        declared_retry: set = set()         # retry_ok keys (rule 3 only)
        for spec_path, (spec, line) in self._specs.items():
            keys: set = set()
            for section, rule in (("sites", "live-block-under-lock"),
                                  ("wait_ok", "live-wait-no-timeout"),
                                  ("retry_ok", "live-unbounded-retry")):
                for name, site in (spec.get(section) or {}).items():
                    if not isinstance(site, dict) or not site.get("fn"):
                        continue
                    resolved = self._resolve_site(spec_path,
                                                  str(site["fn"]))
                    if not resolved and getattr(self, "full_scope", True):
                        spec_errors.append(Finding(
                            rule, spec_path, line, _SPEC_NAME,
                            f"site:{name}:unresolved",
                            f"declared sanction {name!r} names "
                            f"{site['fn']!r}, which matches no function "
                            "in the analyzed corpus — a stale sanction "
                            "silently re-sanctions whatever takes that "
                            "name next; fix or delete it"))
                    if section == "retry_ok":
                        # rule-3 only: a sanctioned serve loop is still
                        # forbidden to block under a lock
                        declared_retry.update(resolved)
                    else:
                        keys.update(resolved)
                    if not str(site.get("reason") or "").strip():
                        spec_errors.append(Finding(
                            rule, spec_path, line, _SPEC_NAME,
                            f"site:{name}",
                            f"declared sanction {name!r} ({site['fn']}) "
                            "has no reason string — every site allowed to "
                            "block must say why (what bounds it, who "
                            "guarantees progress)"))
            declared[spec_path] = keys
        declared_all = set().union(*declared.values()) if declared else set()

        scoped: dict[str, dict] = {}        # key -> governing spec
        events: dict[str, list] = {}        # key -> direct blocking events
        kinds: dict[str, set] = {}          # key -> transitive kinds
        nodes: dict[str, list] = {}         # key -> own-node list (cached
        #                                     once; every pass re-iterates
        #                                     it instead of re-walking)
        for key, u in self.project.funcs.items():
            got = self._spec_for(u.path)
            if got is None:
                continue
            spec_path, spec = got
            scoped[key] = {"spec_path": spec_path, "spec": spec}
            own = list(_own_nodes(u.node))
            nodes[key] = own
            evs = self._direct_events(u, spec, own)
            events[key] = evs
            kinds[key] = {e["kind"] for e in evs}
        changed = True
        while changed:
            changed = False
            for key in scoped:
                u = self.project.funcs[key]
                mine = kinds[key]
                for site in u.calls:
                    if site.callee_key in declared_all:
                        continue            # a declared site caps its subtree
                    add = kinds.get(site.callee_key, set()) - mine
                    if add:
                        mine |= add
                        changed = True
        return {"spec_errors": spec_errors, "declared": declared,
                "declared_all": declared_all,
                "declared_retry": declared_retry, "scoped": scoped,
                "events": events, "kinds": kinds, "nodes": nodes}

    def _resolve_site(self, spec_path: str, fn: str) -> set:
        """Keys a declared sanction covers: an explicit ``path::qualname``
        verbatim, else every function in the corpus whose qualname matches
        (the spec names sites in OTHER modules — resolution must not be
        anchored to the spec's own path)."""
        if "::" in fn:
            return {fn} if fn in self.project.funcs else set()
        return {k for k, u in self.project.funcs.items()
                if u.qualname == fn}

    def _direct_events(self, u, spec: dict, own: list) -> list[dict]:
        blocking = spec.get("blocking") or {}
        attr_calls = {k: tuple(v) for k, v in
                      (spec.get("blocking_attr_calls") or {}).items()}
        aliases: dict[str, str] = {}
        for node in own:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Attribute) \
                    and node.value.attr in attr_calls:
                aliases[node.targets[0].id] = node.value.attr
        out: list[dict] = []
        for node in own:
            if not isinstance(node, ast.Call):
                continue
            leaf = leaf_name(node.func)
            if leaf in blocking:
                if leaf == "join" and not _is_thread_join(node):
                    continue
                out.append({"line": node.lineno, "kind": blocking[leaf],
                            "detail": leaf})
                continue
            if isinstance(node.func, ast.Attribute):
                recv = node.func.value
                attr = recv.attr if isinstance(recv, ast.Attribute) \
                    else aliases.get(recv.id) \
                    if isinstance(recv, ast.Name) else None
                if attr in attr_calls and node.func.attr in attr_calls[attr]:
                    out.append({"line": node.lineno, "kind": f"{attr}-io",
                                "detail": f"{attr}.{node.func.attr}"})
        return out

    def _lock_owner_class(self, path: str, cls: str | None,
                          locks: dict) -> str | None:
        """The lock class a ``_locked``-suffix method holds by contract:
        the class must actually OWN a spec lock (``self.<attr> = …``
        somewhere in its body) — a private object mutex named ``_lock``
        on a non-owner class is not a latency-spec lock."""
        if cls is None:
            return None
        # fixture twins carry their own specs: the lock table is part of
        # the answer's identity, not just the class
        ck = (path, cls, frozenset(locks.items()))
        if ck in self._owner_cache:
            return self._owner_cache[ck]
        out = None
        ci = self.project.classes.get(f"{path}::{cls}")
        if ci is not None:
            for node in ast.walk(ci.node):
                if isinstance(node, ast.Assign):
                    for t in node.targets:
                        if isinstance(t, ast.Attribute) \
                                and isinstance(t.value, ast.Name) \
                                and t.value.id == "self" \
                                and t.attr in locks:
                            out = locks[t.attr]
                            break
                    if out:
                        break
        self._owner_cache[ck] = out
        return out

    def _held_spans(self, u, locks: dict,
                    own: list) -> list[tuple[int, int, str]]:
        """(start_line, end_line, lock_class) regions where ``u`` holds a
        declared lock: lexical ``with``, ``enter_context`` (including the
        ExitStack-over-all-group-locks idiom), ``assert_owned``, and the
        ``_locked`` caller-holds contract on lock-owner classes."""
        spans: list[tuple[int, int, str]] = []
        if u.name.endswith("_locked"):
            cls = self._lock_owner_class(u.path, u.cls, locks)
            if cls:
                spans.append((0, 10 ** 9, cls))
        lockish_names: dict[str, str] = {}      # for lk in self.<locks>: …
        for node in own:
            if isinstance(node, ast.For) and isinstance(node.target, ast.Name):
                cls = _lock_class_of(node.iter, locks)
                if cls:
                    lockish_names[node.target.id] = cls
        for node in own:
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    cls = _lock_class_of(item.context_expr, locks)
                    if cls:
                        spans.append((node.lineno, _end_line(node), cls))
            elif isinstance(node, ast.Call):
                leaf = leaf_name(node.func)
                if leaf in ("enter_context", "assert_owned") and node.args:
                    arg = node.args[0]
                    cls = _lock_class_of(arg, locks)
                    if cls is None and isinstance(arg, ast.Name):
                        cls = lockish_names.get(arg.id)
                    if cls:
                        spans.append((node.lineno, 10 ** 9, cls))
        return spans

    # -- rule 1: live-block-under-lock ---------------------------------------

    def _block_pass(self, prep: dict) -> list[Finding]:
        findings: list[Finding] = []
        declared_all = prep["declared_all"]
        for key, scope in prep["scoped"].items():
            u = self.project.funcs[key]
            locks = scope["spec"].get("locks") or {}
            spans = self._held_spans(u, locks, prep["nodes"][key])
            if not spans:
                continue

            def held(line: int) -> str | None:
                for lo, hi, cls in spans:
                    if lo <= line <= hi:
                        return cls
                return None

            hits: list[tuple[int, str, str, str]] = []
            for ev in prep["events"][key]:
                cls = held(ev["line"])
                if cls:
                    hits.append((ev["line"], cls, ev["detail"], ev["kind"]))
            for site in u.calls:
                if site.callee_key in declared_all:
                    continue
                ck = prep["kinds"].get(site.callee_key)
                if not ck:
                    continue
                cls = held(site.line)
                if cls:
                    cu = self.project.funcs[site.callee_key]
                    hits.append((site.line, cls,
                                 f"call:{cu.qualname}",
                                 ",".join(sorted(ck))))
            if not hits:
                continue
            if key in declared_all or self.project.reachable_only_from(
                    key, declared_all):
                continue
            for line, cls, detail, kind in hits:
                findings.append(Finding(
                    "live-block-under-lock", u.path, line, u.qualname,
                    f"{cls}:{detail}",
                    f"{detail} ({kind}) can block while the {cls} lock is "
                    "held — one slow peer or hung fd wedges every reader "
                    "and writer behind this lock; move the blocking work "
                    "outside the hold (copy-out → block → swap-in) or "
                    "declare the site with its reason in LATENCY_SPEC "
                    "(utils/diagnostics.py)"))
        return findings

    # -- rule 2: live-unbounded-io -------------------------------------------

    def _io_pass(self, prep: dict) -> list[Finding]:
        findings: list[Finding] = []
        for key, _scope in prep["scoped"].items():
            u = self.project.funcs[key]
            creations: list[tuple[ast.Call, str]] = []
            for node in prep["nodes"][key]:
                if isinstance(node, ast.Call) \
                        and leaf_name(node.func) == "create_connection":
                    if len(node.args) >= 2 or any(
                            kw.arg == "timeout" for kw in node.keywords):
                        continue        # stdlib applies it to the socket
                    findings.append(Finding(
                        "live-unbounded-io", u.path, node.lineno,
                        u.qualname, "create_connection",
                        "create_connection without a timeout argument — "
                        "a SYN-blackholed peer parks this thread for the "
                        "kernel default (minutes); pass timeout= (it also "
                        "bounds every later recv/send on the socket)"))
                elif isinstance(node, ast.Assign) \
                        and len(node.targets) == 1 \
                        and isinstance(node.value, ast.Call) \
                        and leaf_name(node.value.func) == "socket":
                    token = dotted_name(node.targets[0])
                    if token:
                        creations.append((node.value, token))
                elif isinstance(node, (ast.With, ast.AsyncWith)):
                    for item in node.items:
                        if isinstance(item.context_expr, ast.Call) \
                                and leaf_name(item.context_expr.func) \
                                == "socket" \
                                and item.optional_vars is not None:
                            token = dotted_name(item.optional_vars)
                            if token:
                                creations.append(
                                    (item.context_expr, token))
            if not creations:
                continue
            cfg = self._cfg(u.node)

            for call, token in creations:
                def op_on(stmt: ast.AST, attrs: tuple,
                          _token=token) -> bool:
                    for n in ast.walk(stmt):
                        if isinstance(n, ast.Call) \
                                and isinstance(n.func, ast.Attribute) \
                                and n.func.attr in attrs \
                                and dotted_name(n.func.value) == _token:
                            return True
                    return False

                idx = self._stmt_idx(cfg, call)
                if idx is None:
                    continue
                if not guarded_between(
                        cfg, idx,
                        lambda s: op_on(s, _SOCK_BLOCKING_OPS),
                        lambda s: op_on(s, ("settimeout",))):
                    findings.append(Finding(
                        "live-unbounded-io", u.path, call.lineno,
                        u.qualname, f"socket:{token}",
                        f"socket {token} reaches a blocking op on a CFG "
                        "path with no settimeout before it — the op "
                        "inherits no deadline and can hang forever; call "
                        f"{token}.settimeout(...) immediately after "
                        "creation, before any connect/accept/recv/send"))
        return findings

    # -- rule 3: live-unbounded-retry ----------------------------------------

    def _retry_pass(self, prep: dict) -> list[Finding]:
        findings: list[Finding] = []
        for key, _scope in prep["scoped"].items():
            if key in prep["declared_retry"]:
                continue        # sanctioned serve loop (reason required)
            u = self.project.funcs[key]
            loops = [n for n in prep["nodes"][key]
                     if isinstance(n, (ast.While, ast.For))]
            if not loops:
                continue
            cfg = None
            for loop in loops:
                shape = self._retry_shape(loop)
                if shape is None:
                    continue
                if isinstance(loop, ast.While) \
                        and key in self.project.thread_entries \
                        and any(_SHUTDOWN_RE.search(n)
                                for n in _names_in(loop)):
                    continue    # shutdown-bounded serve loop on a worker
                if cfg is None:
                    cfg = self._cfg(u.node)
                bounded = shape == "for-range" \
                    or self._loop_bounded(u, loop, cfg)
                if not bounded:
                    findings.append(Finding(
                        "live-unbounded-retry", u.path, loop.lineno,
                        u.qualname, f"loop:{loop.lineno}:no-bound",
                        "retry loop has no statically visible attempt "
                        "bound or deadline — a persistently failing peer "
                        "spins this path forever; compare an attempt "
                        "counter or monotonic deadline in the loop test, "
                        "or guard the back edge with one (the guard must "
                        "run on EVERY iteration)"))
                elif not self._loop_backoff(u, loop, prep["kinds"],
                                            _scope["spec"]):
                    findings.append(Finding(
                        "live-unbounded-retry", u.path, loop.lineno,
                        u.qualname, f"loop:{loop.lineno}:no-backoff",
                        "bounded retry loop has no backoff — hot "
                        "re-attempts hammer the failing peer and burn the "
                        "attempt budget in microseconds; sleep (ideally "
                        "exponentially) or pace on a timed wait between "
                        "attempts"))
        return findings

    def _retry_shape(self, loop: ast.AST) -> str | None:
        """Is this loop a RETRY of a failed operation? ``while`` + an own
        try whose handler reaches the back edge, or ``for … in range`` +
        the same try shape (bounded by construction). Iteration over a
        collection (``for addr in addrs``) is failover, not retry."""
        if isinstance(loop, ast.For):
            it = loop.iter
            if not (isinstance(it, ast.Call)
                    and leaf_name(it.func) == "range"):
                return None
        tries = []
        todo = list(loop.body) + list(getattr(loop, "orelse", []))
        while todo:
            node = todo.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.While, ast.For)):
                continue        # nested loops judge their own tries
            if isinstance(node, ast.Try):
                tries.append(node)
            todo.extend(ast.iter_child_nodes(node))
        for t in tries:
            for h in t.handlers:
                if self._handler_retries(h):
                    return "for-range" if isinstance(loop, ast.For) \
                        else "while"
        return None

    _TRANSIENT_EXC = frozenset((
        "Exception", "BaseException", "OSError", "IOError",
        "EnvironmentError", "error", "timeout"))
    _TRANSIENT_EXC_RE = re.compile(
        r"Connection|Timeout|Retry|Unavailable|Transient|BrokenPipe", re.I)

    @classmethod
    def _handler_retries(cls, handler: ast.ExceptHandler) -> bool:
        """Does the handler retry the failed operation? A ``continue``
        anywhere, or a fall-through tail (last statement is not raise/
        return/break) that caught a TRANSIENT fault class — ``except
        ValueError: x = fallback`` is value repair inside an ordinary
        loop, not a retry of a failing peer."""
        if any(isinstance(n, ast.Continue) for n in ast.walk(handler)):
            return True
        tail = handler.body[-1] if handler.body else None
        if isinstance(tail, (ast.Raise, ast.Return, ast.Break)):
            return False
        if handler.type is None:
            return True                      # bare except swallows faults
        types = handler.type.elts if isinstance(handler.type, ast.Tuple) \
            else [handler.type]
        for e in types:
            leaf = leaf_name(e)
            if leaf and (leaf in cls._TRANSIENT_EXC
                         or cls._TRANSIENT_EXC_RE.search(leaf)):
                return True
        return False

    def _loop_bounded(self, u, loop: ast.While, cfg: CFG) -> bool:
        assigned: set = set()
        for node in _subtree_no_defs(loop):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target] if isinstance(node, ast.AugAssign) \
                else []
            for t in targets:
                assigned.update(_target_names(t))
        test = loop.test
        if not (isinstance(test, ast.Constant) and test.value is True):
            tn = set(_names_in(test))
            if tn & assigned:
                return True         # counter compared in the test
            if any(_SHUTDOWN_RE.search(n) or _DEADLINE_RE.search(n)
                   for n in tn):
                return True         # shutdown- or deadline-bounded
            for n in ast.walk(test):
                if isinstance(n, ast.Call):
                    if leaf_name(n.func) in _CLOCK_LEAVES:
                        return True
                    if isinstance(n.func, ast.Attribute) \
                            and (n.func.attr == "is_set"
                                 or (n.func.attr == "wait"
                                     and _timed_call(n))):
                        return True
        # guards bound the loop only if their UNION dominates the back
        # edge: a loop with three distinct retry outcomes (fenced / shed /
        # transport-fail) is bounded when every path back to the head
        # crosses SOME counter guard, even though no single guard sits on
        # all of them
        loop_idx = self._stmt_idx(cfg, loop)
        if loop_idx is None:
            return False
        guards: list = []
        for node in _subtree_no_defs(loop):
            if not isinstance(node, ast.If):
                continue
            gn = set(_names_in(node.test))
            named = bool(gn & assigned) or any(
                _SHUTDOWN_RE.search(n) or _DEADLINE_RE.search(n)
                for n in gn)
            clocked = any(isinstance(c, ast.Call)
                          and leaf_name(c.func) in _CLOCK_LEAVES
                          for c in ast.walk(node.test))
            if not (named or clocked):
                continue
            if not any(isinstance(n, (ast.Raise, ast.Return, ast.Break))
                       for n in ast.walk(node)):
                continue
            guards.append(node)
        if not guards:
            return False
        return backedge_dominated(
            cfg, loop_idx, lambda s: any(s is g for g in guards))

    def _loop_backoff(self, u, loop: ast.AST, kinds: dict,
                      spec: dict) -> bool:
        pacing = set(spec.get("pacing_calls") or ())
        for node in _subtree_no_defs(loop):
            if not isinstance(node, ast.Call):
                continue
            leaf = leaf_name(node.func)
            if leaf in _SLEEP_LEAVES or leaf in pacing:
                return True
            if leaf and "backoff" in leaf.lower():
                return True
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in ("wait", "get") \
                    and _timed_call(node):
                return True
        lo, hi = loop.lineno, _end_line(loop)
        for site in u.calls:
            if lo <= site.line <= hi \
                    and "sleep" in kinds.get(site.callee_key, ()):
                return True         # backoff through a resolved helper
        return False

    # -- rule 4: live-wait-no-timeout ----------------------------------------

    def _wait_pass(self, prep: dict) -> list[Finding]:
        findings: list[Finding] = []
        declared_all = prep["declared_all"]
        for key, _scope in prep["scoped"].items():
            u = self.project.funcs[key]
            events: list[tuple[int, str, str]] = []
            for node in prep["nodes"][key]:
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)):
                    continue
                meth = node.func.attr
                recv = leaf_name(node.func.value) or "<expr>"
                if meth in ("wait", "wait_for") and not _timed_call(node):
                    events.append((node.lineno, f"{recv}.{meth}()",
                                   "one lost notify or a dead producer "
                                   "parks this thread forever"))
                elif meth == "get" and not node.args and not node.keywords \
                        and _QUEUE_RECV_RE.search(recv):
                    events.append((node.lineno, f"{recv}.get()",
                                   "a producer that dies without its "
                                   "sentinel parks this consumer forever"))
                elif meth == "join" and not node.args \
                        and not node.keywords \
                        and isinstance(node.func.value,
                                       (ast.Name, ast.Attribute)):
                    if _is_thread_join(node):
                        events.append((node.lineno, f"{recv}.join()",
                                       "a wedged worker blocks shutdown "
                                       "indefinitely"))
            if not events:
                continue
            if key in declared_all or self.project.reachable_only_from(
                    key, declared_all):
                continue
            for line, what, why in events:
                findings.append(Finding(
                    "live-wait-no-timeout", u.path, line, u.qualname,
                    what,
                    f"{what} has no timeout — {why}; pass a timeout and "
                    "re-check your predicate (you were looping anyway), "
                    "or declare a shutdown-aware wrapper in "
                    "LATENCY_SPEC['wait_ok'] (utils/diagnostics.py)"))
        return findings
