"""Resource-lifecycle checker (threads, servers, sockets, file handles).

PR 4 made the ingest plane thread- and socket-heavy; these rules machine-
check the lifecycle conventions a production database survives on — a
silently-dead decode thread or a leaked gateway socket is an ingest
outage, not a test failure:

  * ``resource-thread-no-stop`` — every started ``threading.Thread`` needs
    a shutdown story: ``daemon=True`` at construction (incl. a Thread
    subclass whose ``__init__`` passes it), or a ``join()`` reachable from
    the owning class (directly, via an iterated collection the thread was
    appended to, or through a helper method — the interprocedural class
    closure).  An anonymous non-daemon ``Thread(...).start()`` can never
    be joined and is always flagged.
  * ``resource-server-no-stop`` — a ``serve_forever`` thread target
    additionally needs a paired ``<server>.shutdown()`` in the owning
    class, and the thread must be STORED and joined (a deterministic
    ``stop()``); an anonymous serve_forever thread is flagged even when
    daemon (daemon teardown never releases the listening socket
    deterministically).
  * ``resource-worker-silent-death`` — a thread-entry function (Thread
    target / Thread-subclass ``run``, from the shared call-graph facts)
    whose loop can die on an exception with no observable trace: the loop
    must be inside — or contain — a ``try`` with a broad handler that does
    something observable (logs, counts, stores the error for the
    consumer).  A worker that exits silently turns into a stalled shard
    hours later with nothing in the logs.
  * ``resource-no-release`` — a locally-acquired file handle or socket
    (``open(...)``, ``socket.socket(...)``, ``socket.create_connection``)
    must be released on ALL CFG paths (``with`` / ``try: ... finally:
    close()``), unless it is returned or stored on ``self`` (then the
    class-level rules own it).  Path analysis comes from analysis/cfg.py,
    including the exceptional edges.  The same rule covers TRANSITIVE
    socket ownership (the replicated-ingest tier's shape): an in-package
    class that stores a raw socket on ``self`` is a *socket owner*
    (BrokerBus, FollowerLink), a class storing an instance of an owner is
    transitively one (Replicator holds FollowerLinks, FiloServer holds
    BrokerBuses), and every class that INSTANTIATES an owner into a self
    attribute must have a ``close()``/``stop()`` for that attribute
    reachable in the class — a replication link pool with no teardown is
    a socket leak per failover, invisible until the fd limit.

The class-level rules use the shared PackageIndex (analysis/callgraph.py)
so a release that lives in a helper (``stop()`` -> ``_teardown()``) still
counts. Pure stdlib ``ast``.
"""

from __future__ import annotations

import ast

from .callgraph import (PackageIndex, attr_root, dotted_name,
                        handler_is_observable, is_broad_handler)
from .cfg import build_cfg, releases_on_all_paths
from .findings import Finding

THREAD_CTORS = {"Thread", "threading.Thread"}
SOCKET_CTORS = {"socket.socket", "socket.create_connection",
                "create_connection"}


def _attr_root(expr: ast.expr) -> str | None:
    """self.a.b / self.a[...] -> "a" (also the socketserver ``outer``
    closure idiom)."""
    return attr_root(expr, receivers=("self", "outer"))


def _kw(call: ast.Call, name: str) -> ast.expr | None:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _is_true(expr: ast.expr | None) -> bool:
    return isinstance(expr, ast.Constant) and expr.value is True


_observable_handler = handler_is_observable   # shared definition (callgraph)


class _ClassResources:
    """Per-class acquisition/release census with interprocedural closure."""

    def __init__(self, path: str, cls: ast.ClassDef, index: PackageIndex):
        self.path = path
        self.cls = cls
        self.index = index
        # attr root -> (line, kind, extra) for acquisitions stored on self
        self.threads: list[tuple] = []    # (attr|None, line, call, qual)
        self.serves: list[tuple] = []     # (attr|None, line, server_root, qual)
        self.sockets: list[tuple] = []    # (attr, line, qual)
        # in-package class instantiations stored on self: candidates for
        # the transitive socket-owner closure (filtered in finalize once
        # the owner set is known)
        self.owned: list[tuple] = []      # (attr, line, class leaf, qual)
        # per-method direct release effects
        self.joined: dict[str, set] = {}      # method -> attr roots joined
        self.closed: dict[str, set] = {}
        self.shutdown: dict[str, set] = {}
        self.self_calls: dict[str, set] = {}  # method -> called self methods
        self._scan()
        self._close()

    def _thread_ctor_daemonizes(self, call: ast.Call) -> bool:
        """daemon=True at the ctor, or an in-package Thread subclass whose
        __init__ passes daemon=True to super().__init__ / sets self.daemon."""
        if _is_true(_kw(call, "daemon")):
            return True
        name = dotted_name(call.func) or ""
        leaf = name.rsplit(".", 1)[-1]
        for ci in self.index.class_by_name.get(leaf, ()):
            init_key = ci.methods.get("__init__")
            if not init_key:
                continue
            init = self.index.funcs[init_key].node
            for node in ast.walk(init):
                if isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Attribute) and \
                        node.func.attr == "__init__" and \
                        isinstance(node.func.value, ast.Call) and \
                        dotted_name(node.func.value.func) == "super":
                    if _is_true(_kw(node, "daemon")):
                        return True
                if isinstance(node, ast.Assign):
                    for t in node.targets:
                        if isinstance(t, ast.Attribute) and \
                                t.attr == "daemon" and _is_true(node.value):
                            return True
        return False

    def _scan(self) -> None:
        for m in self.cls.body:
            if not isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            qual = f"{self.cls.name}.{m.name}"
            joined = self.joined.setdefault(m.name, set())
            closed = self.closed.setdefault(m.name, set())
            shut = self.shutdown.setdefault(m.name, set())
            calls = self.self_calls.setdefault(m.name, set())
            # names bound by iterating a self collection: `for c in
            # self.consumers:` lets `c.join()` credit "consumers"
            iter_alias: dict[str, str] = {}
            for node in ast.walk(m):
                if isinstance(node, ast.For) and \
                        isinstance(node.target, ast.Name):
                    root = _attr_root(node.iter)
                    if root is None and isinstance(node.iter, ast.Call):
                        root = _attr_root(node.iter.func) \
                            if _attr_root(node.iter.func) else \
                            (_attr_root(node.iter.args[0])
                             if node.iter.args else None)
                    if root:
                        iter_alias[node.target.id] = root
            for node in ast.walk(m):
                if not isinstance(node, ast.Call):
                    continue
                fname = dotted_name(node.func) or ""
                leaf = fname.rsplit(".", 1)[-1]
                if isinstance(node.func, ast.Attribute):
                    recv = node.func.value
                    root = _attr_root(recv)
                    if root is None and isinstance(recv, ast.Name):
                        root = iter_alias.get(recv.id)
                    if root is not None:
                        if leaf == "join":
                            joined.add(root)
                        elif leaf in ("close", "server_close", "stop",
                                      "close_locked", "_close_locked"):
                            closed.add(root)
                        elif leaf == "shutdown":
                            shut.add(root)
                    if isinstance(recv, ast.Name) and recv.id in ("self",
                                                                  "outer"):
                        calls.add(node.func.attr)
                # acquisitions
                self._scan_acquire(node, qual, m)

    def _scan_acquire(self, call: ast.Call, qual: str, method) -> None:
        fname = dotted_name(call.func) or ""
        leaf = fname.rsplit(".", 1)[-1]
        target_expr = _kw(call, "target")
        is_thread = (fname in THREAD_CTORS or leaf == "Thread"
                     or self._is_pkg_thread_subclass(fname))
        if is_thread and leaf != "start":
            serve = isinstance(target_expr, ast.Attribute) and \
                target_expr.attr == "serve_forever"
            attr = self._store_attr(call, method)
            if serve:
                server_root = _attr_root(target_expr.value)
                self.serves.append((attr, call.lineno, server_root, qual))
            else:
                daemonized = self._thread_ctor_daemonizes(call)
                if not daemonized:
                    self.threads.append((attr, call.lineno, call, qual))
        if fname in SOCKET_CTORS:
            attr = self._store_attr(call, method)
            if attr:
                self.sockets.append((attr, call.lineno, qual))
        elif leaf and leaf[0].isupper() and leaf in self.index.class_by_name:
            # instantiation of an in-package class stored on self — a
            # candidate owned resource (meaningful once the socket-owner
            # closure says the class owns sockets)
            attr = self._store_attr(call, method)
            if attr:
                self.owned.append((attr, call.lineno, leaf, qual))

    def _is_pkg_thread_subclass(self, fname: str) -> bool:
        leaf = fname.rsplit(".", 1)[-1]
        for ci in self.index.class_by_name.get(leaf, ()):
            if f"{ci.path}::{ci.name}" in self.index._thread_subclasses():
                return True
        return False

    def _store_attr(self, call: ast.Call, method) -> str | None:
        """The self-attr root this call's result is stored under (plain
        assign, or append/add into a self collection)."""
        for node in ast.walk(method):
            if isinstance(node, ast.Assign) and node.value is call:
                for t in node.targets:
                    root = _attr_root(t)
                    if root:
                        return root
                # local var later stored? track one hop: x = Thread();
                # self.a = x / self.a.append(x)
                if len(node.targets) == 1 and \
                        isinstance(node.targets[0], ast.Name):
                    var = node.targets[0].id
                    for n2 in ast.walk(method):
                        if isinstance(n2, ast.Assign) and \
                                isinstance(n2.value, ast.Name) and \
                                n2.value.id == var:
                            for t2 in n2.targets:
                                root = _attr_root(t2)
                                if root:
                                    return root
                        if isinstance(n2, ast.Call) and \
                                isinstance(n2.func, ast.Attribute) and \
                                n2.func.attr in ("append", "add") and \
                                n2.args and \
                                isinstance(n2.args[0], ast.Name) and \
                                n2.args[0].id == var:
                            root = _attr_root(n2.func.value)
                            if root:
                                return root
            if isinstance(node, ast.Call) and node is not call and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in ("append", "add") and \
                    call in node.args:
                root = _attr_root(node.func.value)
                if root:
                    return root
        return None

    def _close(self) -> None:
        """Interprocedural closure: a method inherits the release effects of
        the self-methods it calls (stop() -> _teardown() counts)."""
        changed = True
        while changed:
            changed = False
            for m, calls in self.self_calls.items():
                for callee in calls:
                    for table in (self.joined, self.closed, self.shutdown):
                        if callee in table and \
                                not table[callee] <= table[m]:
                            table[m] |= table[callee]
                            changed = True

    def all_joined(self) -> set:
        return set().union(*self.joined.values()) if self.joined else set()

    def all_closed(self) -> set:
        return set().union(*self.closed.values()) if self.closed else set()

    def all_shutdown(self) -> set:
        return set().union(*self.shutdown.values()) if self.shutdown else set()


class ResourceChecker:
    rules = ("resource-thread-no-stop", "resource-server-no-stop",
             "resource-worker-silent-death", "resource-no-release")

    def __init__(self):
        self._modules: dict[str, ast.Module] = {}
        self.project: PackageIndex | None = None
        self.corpus = None           # shared CFG memo, set by the runner

    def check_module(self, path: str, tree: ast.Module) -> list[Finding]:
        self._modules[path] = tree
        return []

    def finalize(self) -> list[Finding]:
        index = self.project or PackageIndex(self._modules)
        findings: list[Finding] = []
        class_res: list[tuple[str, _ClassResources]] = []
        for path, tree in self._modules.items():
            for node in tree.body:
                if isinstance(node, ast.ClassDef):
                    class_res.append((path,
                                      _ClassResources(path, node, index)))
            findings += self._check_module_threads(path, tree, index)
        owners = self._socket_owner_closure(class_res)
        for path, res in class_res:
            findings += self._check_class(path, res, owners)
        findings += self._check_worker_loops(index)
        findings += self._check_local_releases(index)
        return findings

    # -- class-level thread/server/socket lifecycle --------------------------

    @staticmethod
    def _socket_owner_closure(
            class_res: list[tuple[str, "_ClassResources"]]) -> set[str]:
        """Class names that own sockets, directly (self-stored
        SOCKET_CTORS) or transitively (self-stored instantiation of an
        owner class) — the replicated-ingest link/bus shape."""
        owners = {res.cls.name for _p, res in class_res if res.sockets}
        changed = True
        while changed:
            changed = False
            for _p, res in class_res:
                if res.cls.name in owners:
                    continue
                if any(leaf in owners for _a, _l, leaf, _q in res.owned):
                    owners.add(res.cls.name)
                    changed = True
        return owners

    def _check_class(self, path: str, res: "_ClassResources",
                     owners: set[str]) -> list[Finding]:
        findings: list[Finding] = []
        joined, closed, shut = (res.all_joined(), res.all_closed(),
                                res.all_shutdown())
        for attr, line, _call, qual in res.threads:
            if attr is None:
                findings.append(Finding(
                    "resource-thread-no-stop", path, line, qual,
                    "thread:<anonymous>",
                    "starts an anonymous non-daemon Thread — it can never "
                    "be joined; store it and join in stop()/close(), or "
                    "construct with daemon=True"))
            elif attr not in joined:
                findings.append(Finding(
                    "resource-thread-no-stop", path, line, qual,
                    f"thread:{attr}",
                    f"Thread stored in self.{attr} is neither daemon nor "
                    "joined anywhere in the class — a stop() must join it "
                    "(with a timeout) or the ctor must pass daemon=True"))
        for attr, line, server_root, qual in res.serves:
            missing = []
            if server_root is not None and server_root not in shut:
                missing.append(f"no {server_root}.shutdown() call")
            if attr is None:
                missing.append("thread not stored (never joinable)")
            elif attr not in joined:
                missing.append(f"self.{attr} never joined")
            if missing:
                findings.append(Finding(
                    "resource-server-no-stop", path, line, qual,
                    f"server:{server_root or '<anonymous>'}",
                    "serve_forever thread without a deterministic stop: "
                    + "; ".join(missing)
                    + " — shut the server down AND join the thread with a "
                      "timeout so the listening socket is released"))
        for attr, line, qual in res.sockets:
            if attr not in closed:
                findings.append(Finding(
                    "resource-no-release", path, line, qual,
                    f"socket:{attr}",
                    f"socket stored in self.{attr} has no close() reachable "
                    "from this class — a close()/stop() must release it"))
        seen: set[tuple[str, str]] = set()
        for attr, line, leaf, qual in res.owned:
            if leaf not in owners or attr in closed \
                    or (attr, leaf) in seen:
                continue
            seen.add((attr, leaf))
            findings.append(Finding(
                "resource-no-release", path, line, qual,
                f"owned:{attr}",
                f"socket-owning {leaf} stored in self.{attr} has no "
                "close()/stop() reachable from this class — every "
                "instantiated link/bus needs a teardown path or its "
                "sockets leak per reconnect"))
        return findings

    def _check_module_threads(self, path: str, tree: ast.Module,
                              index: PackageIndex) -> list[Finding]:
        """Module-level functions starting anonymous non-daemon threads."""
        findings: list[Finding] = []
        for fn in tree.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                fname = dotted_name(node.func) or ""
                if fname not in THREAD_CTORS:
                    continue
                if _is_true(_kw(node, "daemon")):
                    continue
                # stored/returned threads are the caller's responsibility;
                # only the start-and-forget shape is flagged here
                stored = any(isinstance(n, ast.Assign) and n.value is node
                             for n in ast.walk(fn))
                ret = any(isinstance(n, ast.Return) and n.value is node
                          for n in ast.walk(fn))
                if not stored and not ret:
                    findings.append(Finding(
                        "resource-thread-no-stop", path, node.lineno,
                        fn.name, "thread:<anonymous>",
                        "starts an anonymous non-daemon Thread — it can "
                        "never be joined; store/return it or pass "
                        "daemon=True"))
        return findings

    # -- worker loops must fail loud -----------------------------------------

    def _check_worker_loops(self, index: PackageIndex) -> list[Finding]:
        findings: list[Finding] = []
        for key in sorted(index.thread_entries):
            u = index.funcs.get(key)
            if u is None or u.path not in self._modules:
                continue
            fn = u.node
            loops = [n for n in ast.walk(fn)
                     if isinstance(n, (ast.While, ast.For))]
            if not loops:
                continue
            guarded = self._has_guarded_loop(fn)
            if not guarded:
                findings.append(Finding(
                    "resource-worker-silent-death", u.path, fn.lineno,
                    u.qualname, "worker-loop",
                    "thread worker loop has no broad exception handler with "
                    "an observable action — an unexpected exception kills "
                    "the thread silently and the pipeline stalls hours "
                    "later; wrap the loop in try/except that logs, counts "
                    "(filodb_swallowed_errors) or stores the error for the "
                    "consumer"))
        return findings

    @staticmethod
    def _has_guarded_loop(fn: ast.AST) -> bool:
        """Some loop in fn is enclosed by — or contains — a try with a
        broad, observable handler."""
        broad_trys = [n for n in ast.walk(fn) if isinstance(n, ast.Try)
                      and any(is_broad_handler(h) and _observable_handler(h)
                              for h in n.handlers)]
        if not broad_trys:
            return False
        loops = [n for n in ast.walk(fn)
                 if isinstance(n, (ast.While, ast.For))]
        for t in broad_trys:
            inside_t = set(map(id, ast.walk(t)))
            for lp in loops:
                if id(lp) in inside_t:
                    return True             # loop under the try
                if id(t) in set(map(id, ast.walk(lp))):
                    return True             # try inside the loop body
        return False

    # -- local file/socket handles: all-paths release -------------------------

    _LOCAL_ACQUIRES = {"open"} | SOCKET_CTORS

    def _check_local_releases(self, index: PackageIndex) -> list[Finding]:
        findings: list[Finding] = []
        for key, u in sorted(index.funcs.items()):
            if u.path not in self._modules:
                continue
            findings += self._check_func_releases(u)
        return findings

    def _check_func_releases(self, u) -> list[Finding]:
        fn = u.node
        acquires: list[tuple[ast.stmt, str, int]] = []  # (stmt, var, line)
        with_managed: set = set()
        for node in ast.walk(fn):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    with_managed.add(id(item.context_expr))
        body = getattr(fn, "body", [])
        for stmt in ast.walk(fn):
            if not isinstance(stmt, ast.Assign):
                continue
            call = stmt.value
            if not isinstance(call, ast.Call):
                continue
            fname = dotted_name(call.func) or ""
            if fname not in self._LOCAL_ACQUIRES or id(call) in with_managed:
                continue
            if len(stmt.targets) == 1 and isinstance(stmt.targets[0],
                                                     ast.Name):
                acquires.append((stmt, stmt.targets[0].id, stmt.lineno))
        if not acquires:
            return []
        # returned or stored on self -> ownership escapes this function
        escaped: set = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Return) and \
                    isinstance(node.value, ast.Name):
                escaped.add(node.value.id)
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Name) and \
                    any(_attr_root(t) for t in node.targets):
                escaped.add(node.value.id)
        cfg = self.corpus.cfg(fn) if self.corpus is not None \
            else build_cfg(fn)
        findings = []
        for stmt, var, line in acquires:
            if var in escaped:
                continue
            idx = cfg.node_of(stmt)
            if idx is None:
                continue

            def _releases(s, _var=var):
                for n in ast.walk(s):
                    if isinstance(n, ast.Call) and \
                            isinstance(n.func, ast.Attribute) and \
                            n.func.attr in ("close", "shutdown") and \
                            isinstance(n.func.value, ast.Name) and \
                            n.func.value.id == _var:
                        return True
                return False

            if not releases_on_all_paths(cfg, idx, _releases):
                findings.append(Finding(
                    "resource-no-release", u.path, line, u.qualname,
                    f"handle:{var}",
                    f"{var} acquired here is not released on every path to "
                    "function exit (including exceptional ones) — use "
                    "`with` or close it in a finally block"))
        return findings
