"""Epoch & visibility contracts: static cache-coherence for the write path.

Every serving-path cache (the PR 8 result cache's watermark-vector
equality, the PR 13 fragment cache's per-step validity, the mesh topk
release-epoch validation) is correct only because every mutation of
query-visible store state bumps ``data_epoch`` under the shard lock with
an honest min-affected timestamp. This family makes that discipline
structural. ``core/memstore.py`` declares the surface as ``EPOCH_SPEC``
(a pure-literal dict the checker reads from the AST): the field-sensitive
mutator shapes (``self.store.append`` / ``self.index.remove_part_keys`` /
a local alias of ``self.sink``), the sanctioned visibility sites with
their affected-timestamp class, and the admission-only shapes that need
declaration but no bump (a zero-sample series changes no query result).

Write-side rules (interprocedural — PackageIndex call graph + shared
per-function CFGs):

  * ``epoch-undeclared-visibility`` — a function that mutates a visible
    (or admission) shape and is neither a declared EPOCH_SPEC site nor
    reachable ONLY from declared sites (reverse-call closure): a
    visibility point the spec does not know about.
  * ``epoch-bump-uncovered`` — a visible-data mutation not fenced by the
    bump on every CFG path: every ENTRY→mutation path passes a bump, or
    every mutation→EXIT path does (either order is atomic under one lock
    hold). A conditional fence guarded by the mutation's own result
    (``dropped = sink.age_out(...)`` … ``if dropped: bump``) counts —
    a zero-row rewrite mutated nothing. An uncovered mutation in an
    UNdeclared helper propagates the obligation to its callers' call
    sites (the caller must fence the call).
  * ``epoch-bump-unlocked`` — a bump call neither inside ``with
    <recv>.lock:``, nor in a ``*_locked`` method (caller-holds contract),
    nor after ``assert_owned(self.lock …)``: the epoch/log pair would
    tear against ``epoch_state()`` readers.
  * ``epoch-bump-overclaim`` — a bump passing ``EPOCH_AFFECTS_ALL`` while
    a batch minimum is provably in scope (a ``*min*`` local or a
    ``.min()`` reduction assigned earlier in the function), or a declared
    ``batch_min_ts`` site whose every bump names only the destructive
    sentinel: over-claiming turns per-step fragment validity into
    full invalidation on every flush.

Read-side rules (the dual contract — per-function, CFG-ordered):

  * ``epoch-capture-after-execute`` — an epoch capture
    (``_epoch_state``/``_epoch_vector``/``epoch_state`` call, or a
    comprehension over ``data_epoch``/``_release_epoch``) on a CFG path
    AFTER an execution dispatch, or a cache probe (``.get/.probe/.hit``
    with an epoch argument) reachable from a dispatch: a capture taken
    after execution cannot fence the data the execution read — a
    concurrent mutation lands between the read and the capture and the
    validation passes vacuously. (Stores — ``.put``/``.store`` — after
    execution are the NORMAL pattern and stay legal: they must use the
    pre-execution capture, which the next rule enforces.)
  * ``epoch-validate-refetched`` — a cache get/probe/put/store/hit whose
    epoch argument refetches inline (a capture call or epoch attribute
    read inside the argument) instead of passing the pre-execution
    capture by name: validating against a refreshed vector accepts
    entries the mutation between capture and validation invalidated.

Fixture twins: bad/good_epoch_visibility.py (undeclared + uncovered),
bad/good_epoch_bump.py (unlocked + overclaim), bad/good_epoch_probe.py
(capture-after-execute + validate-refetched). Pure stdlib ``ast``.
"""

from __future__ import annotations

import ast
import re

from .callgraph import leaf_name
from .cfg import CFG, EXIT, covered_on_all_paths
from .findings import Finding

_SPEC_NAME = "EPOCH_SPEC"
_DEFAULT_BUMP = "_bump_epoch_locked"
_ALL_SENTINEL = "EPOCH_AFFECTS_ALL"

# read-side shapes are universal (no spec needed): how this codebase
# captures epoch state, dispatches execution, and talks to caches
_CAPTURE_CALLS = ("_epoch_state", "_epoch_vector", "epoch_state")
_CAPTURE_ATTRS = ("data_epoch", "_release_epoch")
_EXEC_RE = re.compile(
    r"^(_?exec\w*|evaluate\w*|resolve|topk|bottomk|aggregate|quantile"
    r"|to_plan|query_range|query_instant)$")
_PROBE_OPS = ("get", "probe", "hit")
_PUT_OPS = ("put", "store")
_CACHE_RECV = re.compile(r"cache", re.IGNORECASE)


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


def _extract_spec(tree: ast.Module) -> dict | None:
    """The module's ``EPOCH_SPEC`` literal, or None. literal_eval keeps the
    contract honest: a computed spec cannot be statically checked."""
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == _SPEC_NAME:
            try:
                spec = ast.literal_eval(node.value)
            except (ValueError, SyntaxError):
                return None
            return spec if isinstance(spec, dict) else None
    return None


def _receiver_attr(recv: ast.expr, aliases: dict) -> str | None:
    """The state-attribute name a mutator receiver resolves to:
    ``self.store`` -> "store", a local alias (``sink = self.sink``) ->
    "sink", a bare matching Name -> itself."""
    if isinstance(recv, ast.Attribute):
        return recv.attr
    if isinstance(recv, ast.Name):
        return aliases.get(recv.id, recv.id)
    return None


def _call_leaf(node: ast.Call) -> str | None:
    return leaf_name(node.func)


def _contains_bump(node: ast.AST, bump: str) -> bool:
    return any(isinstance(n, ast.Call) and _call_leaf(n) == bump
               for n in ast.walk(node))


def _names_in(node: ast.AST):
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            yield n.id
        elif isinstance(n, ast.Attribute):
            yield n.attr


def _stmt_index_of(cfg: CFG, target: ast.AST) -> int | None:
    """The innermost CFG statement containing ``target`` (compound
    statements are CFG nodes too, so pick the smallest subtree)."""
    best, best_size = None, None
    for i, s in enumerate(cfg.stmts):
        for sub in ast.walk(s):
            if sub is target:
                size = sum(1 for _ in ast.walk(s))
                if best_size is None or size < best_size:
                    best, best_size = i, size
                break
    return best


def _reaches(cfg: CFG, frm: int, to: int) -> bool:
    seen = set()
    todo = list(cfg.succ.get(frm, ())) + list(cfg.exc_succ.get(frm, ()))
    while todo:
        n = todo.pop()
        if n in seen or n == EXIT:
            continue
        seen.add(n)
        if n == to:
            return True
        todo.extend(cfg.succ.get(n, ()))
        todo.extend(cfg.exc_succ.get(n, ()))
    return False


class EpochChecker:
    rules = ("epoch-undeclared-visibility", "epoch-bump-uncovered",
             "epoch-bump-unlocked", "epoch-bump-overclaim",
             "epoch-capture-after-execute", "epoch-validate-refetched")

    # the one module whose spec governs cross-file analysis in a full run;
    # a fixture twin's own spec governs only itself
    GLOBAL_SPEC_PATH = re.compile(r"(?:^|/)core/memstore\.py$")

    def __init__(self):
        self.project = None
        self.corpus = None
        self._modules: dict[str, ast.Module] = {}
        self._specs: dict[str, dict] = {}

    def check_module(self, path: str, tree: ast.Module) -> list[Finding]:
        self._modules[path] = tree
        spec = _extract_spec(tree)
        if spec is not None:
            self._specs[path] = spec
        return []

    # -- spec resolution ------------------------------------------------------

    def _global_spec(self) -> tuple[str, dict] | None:
        for path, spec in self._specs.items():
            if self.GLOBAL_SPEC_PATH.search(path):
                return path, spec
        if len(self._specs) == 1:
            return next(iter(self._specs.items()))
        return None

    def _spec_for(self, path: str) -> tuple[str, dict] | None:
        if path in self._specs:
            return path, self._specs[path]
        return self._global_spec()

    def _cfg(self, fn: ast.AST) -> CFG:
        if self.corpus is not None:
            return self.corpus.cfg(fn)
        from .cfg import build_cfg
        return build_cfg(fn)

    # -- finalize -------------------------------------------------------------

    def finalize(self) -> list[Finding]:
        findings: list[Finding] = []
        if self.project is None:
            return findings
        findings += self._write_side()
        findings += self._read_side()
        return findings

    # -- write side -----------------------------------------------------------

    def _write_side(self) -> list[Finding]:
        findings: list[Finding] = []
        # pass 1: per-function facts under that module's governing spec
        facts: dict[str, dict] = {}       # FuncUnit key -> fact record
        sanctioned_by_spec: dict[str, set] = {}   # spec path -> site keys
        for key, u in self.project.funcs.items():
            got = self._spec_for(u.path)
            if got is None:
                continue
            spec_path, spec = got
            sites = sanctioned_by_spec.get(spec_path)
            if sites is None:
                sites = {f"{spec_path}::{s['fn']}"
                         for s in (spec.get("sites") or {}).values()}
                sanctioned_by_spec[spec_path] = sites
            rec = self._collect_fn(u, spec)
            if rec is not None:
                rec["spec_path"], rec["spec"] = spec_path, spec
                facts[key] = rec

        # pass 2: coverage of direct visible mutations; obligation
        # propagation from uncovered UNdeclared helpers to their callers
        uncovered_helpers: set = set()
        for key, rec in facts.items():
            u = self.project.funcs[key]
            spec, spec_path = rec["spec"], rec["spec_path"]
            declared = key in sanctioned_by_spec[spec_path]
            affects = self._affects_of(key, spec, spec_path)
            uncovered = [m for m in rec["visible"]
                         if not self._covered(u, m, rec["bump_name"])]
            if uncovered and affects == "admit":
                uncovered = []       # admission sites carry no data bump
            if uncovered and declared:
                for m in uncovered:
                    findings.append(Finding(
                        "epoch-bump-uncovered", u.path, m["line"],
                        u.qualname, m["detail"],
                        f"visible-state mutation {m['detail']} is not "
                        "fenced by a data-epoch bump on every CFG path — "
                        "a query caching between the mutation and the "
                        "bump validates against a stale vector forever; "
                        "bump before or after the mutation under the same "
                        "lock hold (core/memstore.py EPOCH_SPEC)"))
            elif uncovered:
                uncovered_helpers.add(key)
            if rec["visible"] or rec["admit"]:
                sanctioned = declared or self.project.reachable_only_from(
                    key, sanctioned_by_spec[spec_path])
                if not sanctioned:
                    m = (rec["visible"] or rec["admit"])[0]
                    findings.append(Finding(
                        "epoch-undeclared-visibility", u.path, m["line"],
                        u.qualname, m["detail"],
                        f"{u.qualname} mutates query-visible store state "
                        f"({m['detail']}) but is not a declared EPOCH_SPEC "
                        "site and is reachable outside every declared "
                        "site — an epoch-invisible visibility point; "
                        "declare it in core/memstore.py EPOCH_SPEC with "
                        "its affected-ts class, or route it through a "
                        "declared site"))
            findings += self._bump_rules(u, rec, declared, affects)

        # pass 3: callers of uncovered undeclared helpers must fence the
        # call like a mutation of their own (bounded propagation)
        findings += self._propagate(facts, uncovered_helpers,
                                    sanctioned_by_spec)
        return findings

    def _affects_of(self, key: str, spec: dict, spec_path: str) -> str | None:
        qual = key.split("::", 1)[1]
        for s in (spec.get("sites") or {}).values():
            if s["fn"] == qual:
                return s.get("affects")
        return None

    def _collect_fn(self, u, spec: dict) -> dict | None:
        """One lexical pass over a function: local aliases of spec state
        attrs, visible/admission mutation events, bump calls."""
        visible_calls = spec.get("visible_calls") or {}
        admit_calls = spec.get("admit_calls") or {}
        admit_maps = tuple(spec.get("admit_maps") or ())
        bump_name = spec.get("bump") or _DEFAULT_BUMP
        state_attrs = set(visible_calls) | set(admit_calls)
        aliases: dict[str, str] = {}
        for node in _own_nodes(u.node):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Attribute) \
                    and node.value.attr in state_attrs:
                aliases[node.targets[0].id] = node.value.attr
        visible, admit, bumps = [], [], []
        for node in _own_nodes(u.node):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute):
                attr = _receiver_attr(node.func.value, aliases)
                meth = node.func.attr
                ev = {"node": node, "line": node.lineno,
                      "detail": f"{attr}.{meth}"}
                if meth == bump_name:
                    bumps.append(ev)
                elif attr in visible_calls and meth in visible_calls[attr]:
                    visible.append(ev)
                elif attr in admit_calls and meth in admit_calls[attr]:
                    admit.append(ev)
                elif meth in ("pop", "update", "clear", "setdefault",
                              "popitem") \
                        and isinstance(node.func.value, ast.Attribute) \
                        and node.func.value.attr in admit_maps:
                    ev["detail"] = f"{node.func.value.attr}.{meth}"
                    admit.append(ev)
            elif isinstance(node, (ast.Assign, ast.AugAssign, ast.Delete)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else ([node.target] if hasattr(node, "target")
                          else node.targets)
                for t in targets:
                    base = t.value if isinstance(t, ast.Subscript) else t
                    if isinstance(base, ast.Attribute) \
                            and base.attr in admit_maps:
                        admit.append({"node": node, "line": node.lineno,
                                      "detail": f"{base.attr}[]"})
        if not (visible or admit or bumps):
            return None
        return {"visible": visible, "admit": admit, "bumps": bumps,
                "bump_name": bump_name, "aliases": aliases}

    def _covered(self, u, m: dict, bump_name: str) -> bool:
        """Is mutation ``m`` bump-fenced in ``u`` on every path? A
        result-guarded fence (``x = mutate(); if x: bump``) counts: the
        skipped branch is the nothing-mutated case."""
        cfg = self._cfg(u.node)
        idx = _stmt_index_of(cfg, m["node"])
        if idx is None:
            return False
        stmt = cfg.stmts[idx]
        if _contains_bump(stmt, bump_name):
            return True               # mutation and bump share a statement
        result_name = None
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name):
            result_name = stmt.targets[0].id

        def fence(s: ast.stmt) -> bool:
            if _contains_bump(s, bump_name) and not isinstance(
                    s, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if not isinstance(s, (ast.If, ast.For, ast.While,
                                      ast.With, ast.Try)):
                    return True
                # a compound node only fences when EVERY continuation out
                # of it bumped — accept the one guarded idiom we can prove:
                # ``if <result>: ...bump...`` with no else
                if isinstance(s, ast.If) and result_name is not None \
                        and not s.orelse \
                        and result_name in set(_names_in(s.test)) \
                        and _contains_bump(s, bump_name):
                    return True
            return False

        return covered_on_all_paths(cfg, idx, fence)

    def _bump_rules(self, u, rec: dict, declared: bool,
                    affects: str | None) -> list[Finding]:
        """Lock discipline + over-claim at each bump call site."""
        findings: list[Finding] = []
        if not rec["bumps"]:
            if declared and affects == "batch_min_ts" and rec["visible"]:
                # a batch_min site with no bump of its own is only legal
                # when its mutations route through covered callees — the
                # coverage rule already judged that; nothing extra here
                pass
            return findings
        lock_name = rec["spec"].get("lock") or "lock"
        fn_locked = u.name.endswith("_locked")
        with_lock_spans: list[tuple[int, int]] = []
        assert_lines: list[int] = []
        for node in _own_nodes(u.node):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    if any(isinstance(n, ast.Attribute)
                           and n.attr == lock_name
                           for n in ast.walk(item.context_expr)):
                        end = max((s.lineno for s in ast.walk(node)
                                   if hasattr(s, "lineno")),
                                  default=node.lineno)
                        with_lock_spans.append((node.lineno, end))
            elif isinstance(node, ast.Call) \
                    and _call_leaf(node) == "assert_owned" \
                    and any(a == lock_name for a in _names_in(node)):
                assert_lines.append(node.lineno)
        saw_min_source = any(
            isinstance(n, ast.Assign) and (
                any("min" in name for t in n.targets
                    for name in _names_in(t))
                or any(isinstance(c, ast.Call)
                       and _call_leaf(c) in ("min",)
                       or (isinstance(c, ast.Call)
                           and isinstance(c.func, ast.Attribute)
                           and c.func.attr == "min")
                       for c in ast.walk(n.value)))
            for n in _own_nodes(u.node))
        all_only = True
        for b in rec["bumps"]:
            line = b["line"]
            held = fn_locked \
                or any(lo <= line <= hi for lo, hi in with_lock_spans) \
                or any(al <= line for al in assert_lines)
            if not held:
                findings.append(Finding(
                    "epoch-bump-unlocked", u.path, line, u.qualname,
                    "bump", f"{rec['bump_name']} called without the shard "
                    f"lock (no enclosing `with …{lock_name}:`, no "
                    "`*_locked` caller-holds contract, no assert_owned) — "
                    "the epoch/log pair tears against epoch_state() "
                    "readers"))
            args = b["node"].args
            names = set()
            for a in args:
                names.update(_names_in(a))
            mentions_all = _ALL_SENTINEL in names
            mentions_min = any("min" in n for n in names)
            if not (mentions_all and not mentions_min):
                all_only = False
            if mentions_all and not mentions_min and saw_min_source:
                findings.append(Finding(
                    "epoch-bump-overclaim", u.path, line, u.qualname,
                    "overclaim", "bump records EPOCH_AFFECTS_ALL while a "
                    "batch minimum is in scope in this function — the "
                    "destructive sentinel turns per-step fragment "
                    "validity into full invalidation; pass the batch "
                    "min-ts instead"))
        if declared and affects == "batch_min_ts" and all_only \
                and rec["bumps"]:
            b = rec["bumps"][0]
            findings.append(Finding(
                "epoch-bump-overclaim", u.path, b["line"], u.qualname,
                "site-class", "declared batch_min_ts site bumps only "
                "EPOCH_AFFECTS_ALL — the site's class promises a batch "
                "minimum (core/memstore.py EPOCH_SPEC); record it or "
                "re-class the site"))
        return findings

    def _propagate(self, facts: dict, uncovered: set,
                   sanctioned_by_spec: dict) -> list[Finding]:
        """An uncovered mutation in an undeclared helper becomes a fencing
        obligation at every caller's call site, transitively."""
        findings: list[Finding] = []
        callers = self.project.callers_of()
        seen: set = set(uncovered)
        todo = list(uncovered)
        while todo:
            helper = todo.pop()
            hu = self.project.funcs[helper]
            for caller in callers.get(helper, ()):  # may be empty: rule 1
                cu = self.project.funcs.get(caller)
                if cu is None:
                    continue
                # the caller may carry no mutation facts of its own —
                # resolve its governing spec directly, not via `facts`
                got = self._spec_for(cu.path)
                bump = (got[1].get("bump") if got else None) \
                    or _DEFAULT_BUMP
                call_nodes = [
                    n for n in _own_nodes(cu.node)
                    if isinstance(n, ast.Call)
                    and leaf_name(n.func) == hu.name]
                declared = False
                if got is not None:
                    sites = sanctioned_by_spec.get(got[0])
                    if sites is None:
                        sites = {f"{got[0]}::{s['fn']}"
                                 for s in (got[1].get("sites")
                                           or {}).values()}
                        sanctioned_by_spec[got[0]] = sites
                    declared = caller in sites
                for cn in call_nodes:
                    m = {"node": cn, "line": cn.lineno,
                         "detail": f"call:{hu.qualname}"}
                    if self._covered(cu, m, bump):
                        continue
                    if declared:
                        findings.append(Finding(
                            "epoch-bump-uncovered", cu.path, cn.lineno,
                            cu.qualname, m["detail"],
                            f"call to {hu.qualname} (which mutates "
                            "visible state without its own bump) is not "
                            "bump-fenced here on every CFG path"))
                    elif caller not in seen:
                        seen.add(caller)
                        todo.append(caller)
        return findings

    # -- read side ------------------------------------------------------------

    def _read_side(self) -> list[Finding]:
        findings: list[Finding] = []
        for key, u in self.project.funcs.items():
            captures, execs, cache_ops = [], [], []
            capture_names: set[str] = set()
            for node in _own_nodes(u.node):
                if isinstance(node, ast.Assign) \
                        and self._is_capture_expr(node.value):
                    captures.append(node)
                    for t in node.targets:
                        els = t.elts if isinstance(t, ast.Tuple) else [t]
                        capture_names.update(
                            e.id for e in els if isinstance(e, ast.Name))
                elif isinstance(node, ast.Call):
                    leaf = _call_leaf(node)
                    if leaf and _EXEC_RE.match(leaf):
                        execs.append(node)
                    elif isinstance(node.func, ast.Attribute) \
                            and node.func.attr in _PROBE_OPS + _PUT_OPS:
                        recv = leaf_name(node.func.value)
                        if recv and _CACHE_RECV.search(recv):
                            cache_ops.append(node)
            for op in cache_ops:
                for a in list(op.args) + [k.value for k in op.keywords]:
                    if self._is_capture_expr(a) \
                            and not isinstance(a, ast.Name):
                        findings.append(Finding(
                            "epoch-validate-refetched", u.path, op.lineno,
                            u.qualname, f"{op.func.attr}",
                            "cache validation refetches the epoch vector "
                            "inline instead of passing the pre-execution "
                            "capture — a mutation between capture and "
                            "validation is accepted as current; capture "
                            "once BEFORE execution and pass that name"))
                        break
            if not execs or not (captures or cache_ops):
                continue
            cfg = self._cfg(u.node)
            exec_idx = {i for e in execs
                        if (i := _stmt_index_of(cfg, e)) is not None}
            for cap in captures:
                ci = _stmt_index_of(cfg, cap)
                if ci is None:
                    continue
                if any(ei != ci and _reaches(cfg, ei, ci)
                       for ei in exec_idx):
                    findings.append(Finding(
                        "epoch-capture-after-execute", u.path, cap.lineno,
                        u.qualname, "capture",
                        "epoch state captured on a path AFTER an "
                        "execution dispatch — a mutation landing between "
                        "the data read and this capture makes every later "
                        "validation pass vacuously; capture before "
                        "dispatch"))
            for op in cache_ops:
                if op.func.attr not in _PROBE_OPS:
                    continue
                has_epoch_arg = any(
                    isinstance(a, ast.Name) and a.id in capture_names
                    for a in list(op.args)
                    + [k.value for k in op.keywords])
                if not has_epoch_arg:
                    continue
                oi = _stmt_index_of(cfg, op)
                if oi is None:
                    continue
                if any(ei != oi and _reaches(cfg, ei, oi)
                       for ei in exec_idx):
                    findings.append(Finding(
                        "epoch-capture-after-execute", u.path, op.lineno,
                        u.qualname, f"probe:{op.func.attr}",
                        "cache probed with a captured epoch vector on a "
                        "path AFTER an execution dispatch — probe before "
                        "executing (the probe exists to skip the work)"))
        return findings

    @staticmethod
    def _is_capture_expr(expr: ast.AST) -> bool:
        for n in ast.walk(expr):
            if isinstance(n, ast.Call) and _call_leaf(n) in _CAPTURE_CALLS:
                return True
            if isinstance(n, ast.Attribute) and n.attr in _CAPTURE_ATTRS \
                    and isinstance(n.ctx, ast.Load):
                return True
        return False
