"""Declared-surface checker: config keys and metric names.

A production system's operational surface — the config knobs it reads and
the metrics it exports — must be DECLARED, not discovered by grepping.
The reference keeps 367 lines of documented defaults in
filodb-defaults.conf; here one dict is the single source of truth per
surface, and these rules make drift impossible:

  * ``surface-config-undeclared`` — every dotted config key read through
    a Config receiver (``cfg["ingest.decode_ahead"]``, ``cfg.get(...)``,
    ``self.config[...]``) must be a key of ``CONFIG_SPEC`` (declared in
    filodb_tpu_torch/config.py with type/default/doc; DEFAULTS is derived from
    it, so an undeclared key is also an unreadable one).
  * ``surface-config-unused`` — a declared key that no code reads (by
    full dotted name or by leaf segment — ``store_config()`` reads leaves
    off the sub-dict) is dead surface: a typo'd rename or a removed
    feature still showing up in docs.
  * ``surface-config-type`` — a declared default literal that cannot
    satisfy its declared type string (an ``int`` defaulting to a string,
    a ``duration`` defaulting to ``"5x"``, a non-null default missing its
    ``|null``): DEFAULTS derives from the spec, so such a key ships a
    value the declared readers (``int(...)``, ``parse_duration_ms``)
    crash on the first time an operator relies on the default. Only
    LITERAL defaults are judged — computed expressions (``1 << 20``) are
    skipped, never guessed.
  * ``surface-metric-undeclared`` — every ``filodb_*`` metric registered
    via ``registry.counter/gauge/histogram`` must be one of the declared
    name CONSTANTS in utils/metrics.py's ``METRICS_SPEC`` (call sites use
    the constant; a raw string literal is flagged even when the name
    matches). F-string names must match a declared wildcard family
    (``filodb_shard_*``).
  * ``surface-metric-kind`` — registering a declared name under a
    different instrument kind than the spec (a counter re-registered as a
    gauge is a Prometheus type conflict at scrape time).
  * ``surface-metric-duplicate`` — two declared constants sharing one
    metric-name string: both sites export under the same series name and
    their values interleave meaninglessly.
  * ``surface-metric-unused`` — a declared metric no code registers.
  * ``surface-trace-undeclared`` — every span name at a ``span(...)`` /
    ``tracer.span(...)`` call site must be one of the declared ``SPAN_*``
    constants in utils/tracing.py's ``TRACE_SPEC`` (a raw string literal
    is flagged even when the name matches — the taxonomy has exactly one
    spelling per span).
  * ``surface-trace-unused`` — a declared span no code opens.
  * ``surface-cache-unbounded`` / ``surface-cache-no-eviction-metric`` —
    every class named ``*Cache`` must expose a capacity bound (a
    ``capacity``/``maxsize``/``max_entries`` parameter or attribute, or a
    ``maxlen=``-bounded container) and account its evictions (an
    identifier or metric name containing "eviction"). An unbounded cache
    is a slow memory leak with no operational signal; the PR 8 plan and
    result caches set the contract and this rule keeps every future cache
    honest.
  * ``surface-cache-unbounded-bytes`` — a ``*Cache`` class that ACCOUNTS
    bytes (stores an attribute whose name contains "bytes") holds
    variable-size entries, so an entry-count bound alone does not bound
    memory: it must also declare a byte capacity (``max_bytes`` /
    ``capacity_bytes`` parameter or attribute). The PR 13 fragment cache
    (per-step value columns of wildly varying width) set this contract.

In the port, tests/test_torch_diagnostics.py holds METRICS_SPEC and
TRACE_SPEC to the reference's (less the plan cache's names), and
``metrics_markdown_table``/``trace_markdown_table`` render them. When an
analysis run's module set contains no spec (narrow ``--changed-only``
scopes, fixture self-tests that define their own), the corresponding
rules are skipped rather than guessed.
"""

from __future__ import annotations

import ast

from .callgraph import dotted_name
from .findings import Finding

CONFIG_RECEIVERS = {"cfg", "config"}
METRIC_KINDS = {"counter", "gauge", "histogram"}
METRIC_PREFIX = "filodb_"


def _const_str(node: ast.expr) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _is_config_receiver(expr: ast.expr) -> bool:
    if isinstance(expr, ast.Name):
        return expr.id in CONFIG_RECEIVERS
    if isinstance(expr, ast.Attribute):
        return expr.attr in CONFIG_RECEIVERS
    return False


def _fstring_prefix(node: ast.JoinedStr) -> str | None:
    """Leading literal text of an f-string ('' if it starts dynamic)."""
    if node.values and isinstance(node.values[0], ast.Constant) and \
            isinstance(node.values[0].value, str):
        return node.values[0].value
    return ""


CACHE_CAP_NAMES = {"capacity", "maxsize", "max_entries", "maxlen"}
# byte-capacity spellings: required for caches that ACCOUNT bytes (their
# entries vary in size — an entry-count bound alone does not bound memory)
CACHE_BYTE_CAP_NAMES = {"max_bytes", "capacity_bytes", "bytes_capacity",
                        "byte_capacity"}


class SurfaceChecker:
    rules = ("surface-config-undeclared", "surface-config-unused",
             "surface-config-type",
             "surface-metric-undeclared", "surface-metric-kind",
             "surface-metric-duplicate", "surface-metric-unused",
             "surface-trace-undeclared", "surface-trace-unused",
             "surface-cache-unbounded", "surface-cache-no-eviction-metric",
             "surface-cache-unbounded-bytes")

    def __init__(self):
        self._modules: dict[str, ast.Module] = {}
        self.project = None             # unused; kept for checker symmetry
        # ``full_scope=False`` (narrow --changed-only runs) skips the
        # *-unused rules: a registration outside the analyzed set is not
        # evidence of dead surface
        self.full_scope = True

    def check_module(self, path: str, tree: ast.Module) -> list[Finding]:
        self._modules[path] = tree
        return self._check_cache_classes(path, tree)

    # -- bounded caches -------------------------------------------------------

    def _check_cache_classes(self, path: str,
                             tree: ast.Module) -> list[Finding]:
        """Every ``*Cache`` class needs a capacity bound and eviction
        accounting — purely lexical (names and keywords), which is exactly
        the contract: the bound and the signal must be VISIBLE in the
        class, not implied by usage elsewhere."""
        findings: list[Finding] = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.ClassDef) \
                    or not node.name.lower().endswith("cache"):
                continue
            has_cap = has_evict = False
            has_byte_cap = has_byte_acct = False
            # docstrings don't count as eviction ACCOUNTING — "eviction is
            # handled elsewhere" in prose must not satisfy the rule
            doc_ids = {
                id(sub.body[0].value) for sub in ast.walk(node)
                if isinstance(sub, (ast.ClassDef, ast.FunctionDef,
                                    ast.AsyncFunctionDef))
                and sub.body and isinstance(sub.body[0], ast.Expr)
                and isinstance(sub.body[0].value, ast.Constant)
                and isinstance(sub.body[0].value.value, str)
            }
            for sub in ast.walk(node):
                if isinstance(sub, ast.arg) and sub.arg in CACHE_CAP_NAMES:
                    has_cap = True
                elif isinstance(sub, ast.Attribute) \
                        and isinstance(sub.ctx, ast.Store) \
                        and sub.attr in CACHE_CAP_NAMES:
                    has_cap = True
                elif isinstance(sub, ast.keyword) \
                        and sub.arg in ("maxlen", "maxsize"):
                    has_cap = True
                if isinstance(sub, ast.arg) \
                        and sub.arg in CACHE_BYTE_CAP_NAMES:
                    has_byte_cap = True
                elif isinstance(sub, ast.Attribute) \
                        and isinstance(sub.ctx, ast.Store):
                    if sub.attr in CACHE_BYTE_CAP_NAMES:
                        has_byte_cap = True
                    elif "bytes" in sub.attr.lower():
                        # byte ACCOUNTING (e.g. self._bytes running total):
                        # variable-size entries — demands a byte capacity
                        has_byte_acct = True
                ident = None
                if isinstance(sub, ast.Attribute):
                    ident = sub.attr
                elif isinstance(sub, ast.Name):
                    ident = sub.id
                elif isinstance(sub, ast.Constant) \
                        and isinstance(sub.value, str) \
                        and id(sub) not in doc_ids:
                    ident = sub.value
                if ident is not None and "eviction" in ident.lower():
                    has_evict = True
            if not has_cap:
                findings.append(Finding(
                    "surface-cache-unbounded", path, node.lineno, node.name,
                    f"class:{node.name}",
                    f"cache class {node.name} has no visible capacity bound "
                    "(capacity/maxsize/max_entries attribute or param, or a "
                    "maxlen-bounded container) — an unbounded cache is a "
                    "slow memory leak"))
            if not has_evict:
                findings.append(Finding(
                    "surface-cache-no-eviction-metric", path, node.lineno,
                    node.name, f"evictions:{node.name}",
                    f"cache class {node.name} never accounts evictions (no "
                    "identifier or metric containing 'eviction') — capacity "
                    "pressure must be operationally visible, not silent"))
            if has_byte_acct and not has_byte_cap:
                findings.append(Finding(
                    "surface-cache-unbounded-bytes", path, node.lineno,
                    node.name, f"bytes:{node.name}",
                    f"cache class {node.name} accounts bytes (its entries "
                    "vary in size) but declares no byte capacity "
                    "(max_bytes/capacity_bytes) — an entry-count bound "
                    "alone does not bound memory for variable-size "
                    "entries"))
        return findings

    def finalize(self) -> list[Finding]:
        findings: list[Finding] = []
        findings += self._check_config()
        findings += self._check_metrics()
        findings += self._check_traces()
        return findings

    # -- config ---------------------------------------------------------------

    def _find_spec_dict(self, name: str) -> tuple[str, ast.Dict] | None:
        for path, tree in self._modules.items():
            for node in tree.body:
                if isinstance(node, ast.Assign) and \
                        isinstance(node.value, ast.Dict):
                    for t in node.targets:
                        if isinstance(t, ast.Name) and t.id == name:
                            return path, node.value
                if isinstance(node, ast.AnnAssign) and \
                        isinstance(node.value, ast.Dict) and \
                        isinstance(node.target, ast.Name) and \
                        node.target.id == name:
                    return path, node.value
        return None

    _DURATION_RE = None     # compiled lazily (module import stays light)

    @classmethod
    def _default_matches(cls, typ: str, node: ast.expr) -> bool:
        """True unless the default LITERAL provably violates ``typ``.
        Computed expressions return True (skipped, never guessed)."""
        import re as _re
        if typ.endswith("|null"):
            if isinstance(node, ast.Constant) and node.value is None:
                return True
            typ = typ[:-len("|null")]
        if isinstance(node, ast.UnaryOp) and \
                isinstance(node.op, ast.USub) and \
                isinstance(node.operand, ast.Constant):
            node = node.operand
        if typ.startswith("list[") and typ.endswith("]"):
            if not isinstance(node, ast.List):
                return not isinstance(node, (ast.Constant, ast.Dict))
            inner = typ[5:-1]
            return all(cls._default_matches(inner, el) for el in node.elts)
        if typ == "dict":
            return isinstance(node, ast.Dict) or \
                not isinstance(node, (ast.Constant, ast.List))
        if not isinstance(node, ast.Constant):
            return True            # computed expression: not judged
        v = node.value
        if typ == "bool":
            return isinstance(v, bool)
        if typ == "int":
            return isinstance(v, int) and not isinstance(v, bool)
        if typ == "float":
            return isinstance(v, (int, float)) and not isinstance(v, bool)
        if typ == "str":
            return isinstance(v, str)
        if typ == "duration":
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                return True        # raw milliseconds are accepted anywhere
            if cls._DURATION_RE is None:
                cls._DURATION_RE = _re.compile(r"\d+(?:\.\d+)?(?:ms|[smhd])")
            return isinstance(v, str) and \
                cls._DURATION_RE.fullmatch(v) is not None
        return True                # unknown type string: out of scope

    def _check_config(self) -> list[Finding]:
        spec = self._find_spec_dict("CONFIG_SPEC")
        if spec is None:
            return []              # narrow scope: nothing to check against
        spec_path, spec_dict = spec
        declared: dict[str, int] = {}
        spec_key_ids: set = set()
        for k in spec_dict.keys:
            s = _const_str(k) if k is not None else None
            if s is not None:
                declared[s] = k.lineno
                spec_key_ids.add(id(k))
        findings: list[Finding] = []
        # default-vs-type parity: the spec IS the deployment contract, so
        # a default its own declared type cannot represent is a shipped bug
        for k, v in zip(spec_dict.keys, spec_dict.values):
            key = _const_str(k) if k is not None else None
            if key is None or not isinstance(v, ast.Tuple) \
                    or len(v.elts) < 2:
                continue
            typ = _const_str(v.elts[0])
            if typ and not self._default_matches(typ, v.elts[1]):
                findings.append(Finding(
                    "surface-config-type", spec_path, k.lineno,
                    "CONFIG_SPEC", f"type:{key}",
                    f"config key {key!r} declares type {typ!r} but its "
                    "default literal cannot satisfy it — the derived "
                    "DEFAULTS tree would hand readers a value their "
                    "declared parser crashes on"))
        used_full: set = set()
        all_strings: set = set()
        for path, tree in self._modules.items():
            for node in ast.walk(tree):
                if isinstance(node, ast.Constant) and \
                        isinstance(node.value, str) and \
                        id(node) not in spec_key_ids:
                    # the spec's own key literals don't count as usage —
                    # otherwise a dead TOP-LEVEL key (leaf == key) could
                    # never be flagged unused
                    all_strings.add(node.value)
                key = recv = None
                if isinstance(node, ast.Subscript) and \
                        _is_config_receiver(node.value):
                    key = _const_str(node.slice)
                    recv = node.value
                elif isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Attribute) and \
                        node.func.attr == "get" and \
                        _is_config_receiver(node.func.value) and node.args:
                    key = _const_str(node.args[0])
                    recv = node.func.value
                if key is None or recv is None:
                    continue
                used_full.add(key)
                if key not in declared:
                    qual = self._enclosing(tree, node)
                    findings.append(Finding(
                        "surface-config-undeclared", path, node.lineno,
                        qual, f"key:{key}",
                        f"config key {key!r} is not declared in CONFIG_SPEC "
                        f"({spec_path}) — declare it with type/default/doc "
                        "(DEFAULTS derives from the spec, so an undeclared "
                        "key KeyErrors at runtime anyway)"))
        for key, line in sorted(declared.items()):
            if not self.full_scope:
                break
            leaf = key.rsplit(".", 1)[-1]
            if key not in used_full and leaf not in all_strings:
                findings.append(Finding(
                    "surface-config-unused", spec_path, line, "CONFIG_SPEC",
                    f"key:{key}",
                    f"declared config key {key!r} is never read anywhere in "
                    "the analyzed set — dead surface; remove it or wire it "
                    "up"))
        return findings

    # -- metrics --------------------------------------------------------------

    def _metric_constants(self) -> tuple[str, dict, dict] | None:
        """(spec path, constant name -> value, metric value -> (kind, const
        name)) from the module that declares METRICS_SPEC."""
        spec = self._find_spec_dict("METRICS_SPEC")
        if spec is None:
            return None
        path, spec_dict = spec
        tree = self._modules[path]
        consts: dict[str, str] = {}
        for node in tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name):
                v = _const_str(node.value)
                if v is not None and v.startswith(METRIC_PREFIX):
                    consts[node.targets[0].id] = v
        entries: dict[str, tuple[str, str, int]] = {}   # value -> (kind, const, line)
        for k, v in zip(spec_dict.keys, spec_dict.values):
            name = None
            const = None
            if isinstance(k, ast.Name):
                const = k.id
                name = consts.get(k.id)
            else:
                name = _const_str(k)
            kind = ""
            if isinstance(v, ast.Tuple) and v.elts:
                kind = _const_str(v.elts[0]) or ""
            if name is not None:
                entries[name] = (kind, const or name, k.lineno)
        return path, consts, entries

    def _check_metrics(self) -> list[Finding]:
        meta = self._metric_constants()
        if meta is None:
            return []
        spec_path, consts, entries = meta
        findings: list[Finding] = []
        # duplicate name values in the spec/constants
        by_value: dict[str, str] = {}
        for cname, value in sorted(consts.items()):
            if value in by_value:
                findings.append(Finding(
                    "surface-metric-duplicate", spec_path, 1, "METRICS_SPEC",
                    f"dup:{value}",
                    f"metric constants {by_value[value]} and {cname} share "
                    f"the name {value!r} — two semantic sites exporting one "
                    "series interleave meaninglessly; rename one"))
            else:
                by_value[value] = cname
        registered: set = set()
        wildcards = {n[:-1] for n in entries if n.endswith("*")}
        for path, tree in self._modules.items():
            for node in ast.walk(tree):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr in METRIC_KINDS and node.args):
                    continue
                recv = dotted_name(node.func.value) or ""
                if not (recv == "registry" or recv.endswith(".reg")
                        or recv in ("reg", "self.reg")):
                    continue
                kind = node.func.attr
                arg = node.args[0]
                qual = self._enclosing(tree, node)
                lit = _const_str(arg)
                if lit is not None and lit.startswith(METRIC_PREFIX):
                    findings.append(Finding(
                        "surface-metric-undeclared", path, node.lineno, qual,
                        f"literal:{lit}",
                        f"metric {lit!r} registered from a string literal — "
                        "use the declared constant from utils/metrics.py "
                        "METRICS_SPEC so the name has exactly one spelling"))
                    continue
                if isinstance(arg, ast.JoinedStr):
                    prefix = _fstring_prefix(arg)
                    if prefix.startswith(METRIC_PREFIX):
                        fam = next((w for w in wildcards
                                    if prefix.startswith(w)), None)
                        if fam is None:
                            findings.append(Finding(
                                "surface-metric-undeclared", path,
                                node.lineno, qual, f"family:{prefix}",
                                f"dynamic metric family {prefix!r}* has no "
                                "wildcard entry in METRICS_SPEC — declare "
                                "the family with kind and doc"))
                        else:
                            registered.add(fam + "*")
                            spec_kind = entries.get(fam + "*", ("",))[0]
                            if spec_kind and spec_kind != kind:
                                findings.append(Finding(
                                    "surface-metric-kind", path, node.lineno,
                                    qual, f"kind:{prefix}*",
                                    f"family {prefix!r}* registered as "
                                    f"{kind} but declared as {spec_kind}"))
                    continue
                cname = None
                if isinstance(arg, ast.Name):
                    cname = arg.id
                elif isinstance(arg, ast.Attribute):
                    cname = arg.attr
                if cname is None:
                    continue
                value = consts.get(cname)
                if value is None:
                    if cname.startswith("FILODB_"):
                        findings.append(Finding(
                            "surface-metric-undeclared", path, node.lineno,
                            qual, f"const:{cname}",
                            f"metric constant {cname} is not declared in "
                            "utils/metrics.py METRICS_SPEC"))
                    continue
                registered.add(value)
                spec_kind = entries.get(value, ("",))[0]
                if spec_kind and spec_kind != kind:
                    findings.append(Finding(
                        "surface-metric-kind", path, node.lineno, qual,
                        f"kind:{value}",
                        f"metric {value!r} registered as {kind} but "
                        f"declared as {spec_kind} — a kind mismatch is a "
                        "Prometheus type conflict at scrape time"))
        for name, (kind, const, line) in sorted(entries.items()):
            if not self.full_scope:
                break
            if name not in registered:
                findings.append(Finding(
                    "surface-metric-unused", spec_path, line, "METRICS_SPEC",
                    f"unused:{name}",
                    f"declared metric {name!r} is never registered in the "
                    "analyzed set — dead surface; remove the entry or wire "
                    "it up"))
        return findings

    # -- traces ---------------------------------------------------------------

    SPAN_CONST_PREFIX = "SPAN_"

    def _trace_constants(self) -> tuple[str, dict, dict] | None:
        """(spec path, constant name -> span name, span name -> (const,
        line)) from the module declaring TRACE_SPEC (utils/tracing.py in
        production; fixtures declare their own)."""
        spec = self._find_spec_dict("TRACE_SPEC")
        if spec is None:
            return None
        path, spec_dict = spec
        tree = self._modules[path]
        consts: dict[str, str] = {}
        for node in tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name) and \
                    node.targets[0].id.startswith(self.SPAN_CONST_PREFIX):
                v = _const_str(node.value)
                if v is not None:
                    consts[node.targets[0].id] = v
        entries: dict[str, tuple[str, int]] = {}   # span name -> (const, line)
        for k in spec_dict.keys:
            if isinstance(k, ast.Name):
                name = consts.get(k.id)
                if name is not None:
                    entries[name] = (k.id, k.lineno)
            else:
                s = _const_str(k) if k is not None else None
                if s is not None:
                    entries[s] = (s, k.lineno)
        return path, consts, entries

    @staticmethod
    def _is_span_call(node: ast.Call) -> bool:
        """A ``span(...)`` / ``<tracer>.span(...)`` call site with a
        positional name argument (re.Match.span() and friends take none)."""
        if not node.args:
            return False
        f = node.func
        if isinstance(f, ast.Name):
            return f.id == "span"
        return isinstance(f, ast.Attribute) and f.attr == "span"

    def _check_traces(self) -> list[Finding]:
        meta = self._trace_constants()
        if meta is None:
            return []              # narrow scope: nothing to check against
        spec_path, consts, entries = meta
        findings: list[Finding] = []
        used: set[str] = set()
        for path, tree in self._modules.items():
            for node in ast.walk(tree):
                if not (isinstance(node, ast.Call)
                        and self._is_span_call(node)):
                    continue
                arg = node.args[0]
                qual = self._enclosing(tree, node)
                lit = _const_str(arg)
                if lit is not None:
                    findings.append(Finding(
                        "surface-trace-undeclared", path, node.lineno, qual,
                        f"literal:{lit}",
                        f"span {lit!r} opened from a string literal — use "
                        "the declared SPAN_* constant from utils/tracing.py "
                        "TRACE_SPEC so the taxonomy has exactly one "
                        "spelling"))
                    continue
                cname = None
                if isinstance(arg, ast.Name):
                    cname = arg.id
                elif isinstance(arg, ast.Attribute):
                    cname = arg.attr
                if cname is None or \
                        not cname.startswith(self.SPAN_CONST_PREFIX):
                    continue       # a non-SPAN_ expression: not our surface
                value = consts.get(cname)
                if value is None or value not in entries:
                    findings.append(Finding(
                        "surface-trace-undeclared", path, node.lineno, qual,
                        f"const:{cname}",
                        f"span constant {cname} is not declared in "
                        f"TRACE_SPEC ({spec_path}) — declare it with a "
                        "one-line doc"))
                    continue
                used.add(value)
        for name, (const, line) in sorted(entries.items()):
            if not self.full_scope:
                break
            if name not in used:
                findings.append(Finding(
                    "surface-trace-unused", spec_path, line, "TRACE_SPEC",
                    f"unused:{name}",
                    f"declared span {name!r} ({const}) is never opened in "
                    "the analyzed set — dead surface; remove the entry or "
                    "wire it up"))
        return findings

    # -- shared ---------------------------------------------------------------

    @staticmethod
    def _enclosing(tree: ast.Module, target: ast.AST) -> str:
        best = "<module>"
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                for sub in ast.walk(node):
                    if sub is target:
                        best = node.name if best == "<module>" \
                            else f"{best}.{node.name}"
                        break
        return best
