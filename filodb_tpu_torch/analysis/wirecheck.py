"""Wire-protocol exhaustiveness checker (query/wire.py and its consumers).

The tagged-binary result codec and the plan envelope are a convention pair:
encoder and decoder live in the same file but nothing forces them to agree.
PR 2's batched dispatch made the failure mode concrete — a tag encoded but
not decoded surfaces as "unknown remote result tag" on the PEER'S caller,
i.e. a cross-node incident, not a unit-test failure.

  * ``wire-tag-parity`` — every single-byte tag literal the encode side
    (serialize_result / pack_multipart) emits must be matched on the decode
    side (deserialize_result / unpack_multipart), and vice versa. The same
    rule also covers REQUEST-OP constants of the framework's TCP services
    (``op_specs`` below): every ``OP_*`` constant a module defines must be
    dispatched by the server function AND sent by the client class — a new
    op wired on only one side is a live protocol desync — and two op names
    must never share a value.
  * ``wire-nesting-bound`` — the plan envelope's nesting bound must be ONE
    shared module constant compared on both _enc_plan and _dec_plan (a
    literal on either side lets the sides drift: the planner would ship
    plans the peer rejects).
  * ``wire-error-classified`` — every typed error wire.py raises
    (QueryError subclasses + QueryError itself) must be classified by the
    HTTP dispatch table (the except-chain in http/api.py) either directly or
    via a handled ancestor, and a subclass handler must come BEFORE its
    ancestor's (Python takes the first matching except — a dead subclass
    handler silently degrades a 503 to a 422).
  * ``wire-trace-parity`` — the trace-context carriers (the /exec
    ``TRACE_HEADER`` and the broker/replication ``pack_trace_hdr`` /
    ``unpack_trace_hdr`` payload blocks) must be referenced on EVERY side
    listed in ``trace_specs``: an inject without its extract (or vice
    versa) silently severs cross-node traces — or worse, leaves the
    receiver parsing a payload whose first bytes it no longer strips.

The function/file names checked are configured in ``WIRE_SPEC`` below —
extend it when a new codec pair appears.
"""

from __future__ import annotations

import ast

from .findings import Finding

WIRE_SPEC = {
    "wire_module": "filodb_tpu_torch/query/wire.py",
    "classifier_module": "filodb_tpu_torch/http/api.py",
    "error_base_modules": ["filodb_tpu_torch/query/rangevector.py"],
    # (encode fn, decode fn) pairs whose 1-byte bytes literals must agree
    "codec_pairs": [("serialize_result", "deserialize_result"),
                    ("pack_multipart", "unpack_multipart")],
    # functions that must share one named depth-bound constant
    "depth_pair": ("_enc_plan", "_dec_plan"),
    # the root of the typed-error hierarchy the HTTP layer classifies
    "error_root": "QueryError",
    # request-op constant parity for the framework's TCP services: every
    # `prefix`-named module constant must be dispatched in `server_fn` and
    # sent from `client_class`
    "op_specs": [
        {"module": "filodb_tpu_torch/ingest/broker.py", "prefix": "OP_",
         "server_fn": "_serve", "client_class": "BrokerBus"},
        # the replication stream: OP_REPLICATE lives in replication.py with
        # both its sender (FollowerLink) and its dispatch (serve_replication,
        # delegated to from BrokerServer._serve)
        {"module": "filodb_tpu_torch/ingest/replication.py",
         "prefix": "OP_",
         "server_fn": "serve_replication", "client_class": "FollowerLink"},
        # the durable chunk tier (PR 10): every StoreServer op — including
        # the streaming OP_APPEND_CRC and atomic OP_CHECKPOINT — must be
        # dispatched by StoreServer._serve AND sent by the RemoteStore
        # client; a one-sided op is a live flush/recovery protocol desync
        {"module": "filodb_tpu_torch/core/diststore.py", "prefix": "OP_",
         "server_fn": "_serve", "client_class": "RemoteStore"},
        # the elastic-cluster op family (PR 12): gossip digests, epoch
        # read/claim/announce, and the REJOIN log sync all live in
        # cluster/gossip.py with serve_cluster as the one dispatch (brokers
        # and GossipServers both delegate there) and ClusterLink as the one
        # sender — a one-sided op desyncs failover or membership
        {"module": "filodb_tpu_torch/cluster/gossip.py", "prefix": "OP_",
         "server_fn": "serve_cluster", "client_class": "ClusterLink"},
    ],
    # trace-context carrier parity: every (module, scope) side must
    # reference the symbol — scopes are function OR class names, so the
    # sender may be a whole client class (BrokerBus packs inside its group
    # sender) while the receiver is one dispatch function
    "trace_specs": [
        {"symbol": "TRACE_HEADER",
         "sides": [["filodb_tpu_torch/query/wire.py",
                    "_dispatch_post_traced"],
                   ["filodb_tpu_torch/http/api.py", "_trace_ctx"]]},
        {"symbol": "pack_trace_hdr",
         "sides": [["filodb_tpu_torch/ingest/broker.py", "BrokerBus"],
                   ["filodb_tpu_torch/ingest/replication.py",
                    "FollowerLink"]]},
        {"symbol": "unpack_trace_hdr",
         "sides": [["filodb_tpu_torch/ingest/broker.py", "_serve"],
                   ["filodb_tpu_torch/ingest/replication.py",
                    "serve_replication"]]},
    ],
}


def _functions(tree: ast.Module) -> dict[str, ast.FunctionDef]:
    return {n.name: n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _byte_tags(fn: ast.FunctionDef) -> dict[bytes, int]:
    """All single-byte bytes literals in a function -> first line seen."""
    out: dict[bytes, int] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Constant) and isinstance(node.value, bytes) \
                and len(node.value) == 1:
            out.setdefault(node.value, node.lineno)
    return out


class WireChecker:
    rules = ("wire-tag-parity", "wire-nesting-bound", "wire-error-classified",
             "wire-trace-parity")

    def __init__(self, spec: dict | None = None):
        self.spec = spec or WIRE_SPEC
        self._modules: dict[str, ast.Module] = {}

    def check_module(self, path: str, tree: ast.Module) -> list[Finding]:
        # cross-file rule: stash and run in finalize
        self._modules[path] = tree
        return []

    def finalize(self) -> list[Finding]:
        findings: list[Finding] = []
        wire_path = self.spec["wire_module"]
        wire = self._modules.get(wire_path)
        if wire is not None:
            fns = _functions(wire)
            findings += self._tag_parity(wire_path, fns)
            findings += self._nesting_bound(wire_path, wire, fns)
            findings += self._error_classified(wire_path, wire)
        for op_spec in self.spec.get("op_specs", ()):
            tree = self._modules.get(op_spec["module"])
            if tree is not None:
                findings += self._op_parity(op_spec, tree)
        for t_spec in self.spec.get("trace_specs", ()):
            findings += self._trace_parity(t_spec)
        return findings

    # -- tags --------------------------------------------------------------

    def _tag_parity(self, path: str,
                    fns: dict[str, ast.FunctionDef]) -> list[Finding]:
        findings = []
        for enc_name, dec_name in self.spec["codec_pairs"]:
            enc, dec = fns.get(enc_name), fns.get(dec_name)
            if enc is None or dec is None:
                missing = enc_name if enc is None else dec_name
                findings.append(Finding(
                    "wire-tag-parity", path, 1, "<module>",
                    f"missing-fn:{missing}",
                    f"codec function {missing}() not found — update "
                    "analysis/wirecheck.WIRE_SPEC if it moved"))
                continue
            etags, dtags = _byte_tags(enc), _byte_tags(dec)
            for tag, line in sorted(etags.items()):
                if tag not in dtags:
                    findings.append(Finding(
                        "wire-tag-parity", path, line, enc_name,
                        f"undecoded:{tag!r}",
                        f"envelope tag {tag!r} is encoded by {enc_name}() "
                        f"but {dec_name}() has no branch for it — peers "
                        "answer payloads this side cannot decode"))
            for tag, line in sorted(dtags.items()):
                if tag not in etags:
                    findings.append(Finding(
                        "wire-tag-parity", path, line, dec_name,
                        f"unencoded:{tag!r}",
                        f"decode branch for tag {tag!r} in {dec_name}() has "
                        f"no encoder in {enc_name}() — dead protocol arm or "
                        "a missing encode path"))
        return findings

    # -- request-op constants -----------------------------------------------

    def _op_parity(self, spec: dict, tree: ast.Module) -> list[Finding]:
        """Every `prefix`-named module constant must be referenced by the
        server dispatch function AND by the client class, and op values must
        be distinct (two ops sharing a value silently route one to the
        other's branch)."""
        path, prefix = spec["module"], spec["prefix"]
        consts: dict[str, tuple[int, object]] = {}   # name -> (line, value)
        for node in tree.body:
            if not isinstance(node, ast.Assign):
                continue
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id.startswith(prefix):
                    v = node.value
                    consts[tgt.id] = (node.lineno,
                                      v.value if isinstance(v, ast.Constant)
                                      else None)
                elif isinstance(tgt, ast.Tuple) \
                        and isinstance(node.value, ast.Tuple) \
                        and len(tgt.elts) == len(node.value.elts):
                    for el, val in zip(tgt.elts, node.value.elts):
                        if isinstance(el, ast.Name) \
                                and el.id.startswith(prefix):
                            consts[el.id] = (node.lineno,
                                             val.value if isinstance(
                                                 val, ast.Constant) else None)
        if not consts:
            return []
        findings: list[Finding] = []
        by_value: dict[object, str] = {}
        for name, (line, value) in sorted(consts.items()):
            if value is not None and value in by_value:
                findings.append(Finding(
                    "wire-tag-parity", path, line, "<module>",
                    f"op-collision:{name}",
                    f"op constant {name} shares value {value!r} with "
                    f"{by_value[value]} — the server dispatches one of them "
                    "as the other"))
            elif value is not None:
                by_value[value] = name
        server = client = None
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name == spec["server_fn"] and server is None:
                server = node
            if isinstance(node, ast.ClassDef) \
                    and node.name == spec["client_class"]:
                client = node
        for role, scope, missing_fn in ((
                "server", server, spec["server_fn"]),
                ("client", client, spec["client_class"])):
            if scope is None:
                findings.append(Finding(
                    "wire-tag-parity", path, 1, "<module>",
                    f"missing-{role}:{missing_fn}",
                    f"op {role} {missing_fn} not found — update "
                    "analysis/wirecheck.WIRE_SPEC op_specs if it moved"))
                continue
            used = {n.id for n in ast.walk(scope)
                    if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}
            for name, (line, _value) in sorted(consts.items()):
                if name not in used:
                    side = ("no dispatch branch in the server — clients "
                            "sending it get 'unknown op'"
                            if role == "server" else
                            "never sent by the client — dead protocol arm "
                            "or a missing send path")
                    findings.append(Finding(
                        "wire-tag-parity", path, line, missing_fn,
                        f"op-un{'served' if role == 'server' else 'sent'}:"
                        f"{name}",
                        f"op constant {name} has {side}"))
        return findings

    # -- trace-context carriers ---------------------------------------------

    def _trace_parity(self, spec: dict) -> list[Finding]:
        """Every (module, scope) side of a trace-context carrier must
        reference ``symbol`` (by Name or attribute). Sides whose module is
        outside the analyzed set are skipped — narrow --changed-only runs
        must not invent cross-file findings."""
        symbol = spec["symbol"]
        findings: list[Finding] = []
        for module, scope_name in spec.get("sides", ()):
            tree = self._modules.get(module)
            if tree is None:
                continue
            scope = None
            for node in ast.walk(tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)) \
                        and node.name == scope_name:
                    scope = node
                    break
            if scope is None:
                findings.append(Finding(
                    "wire-trace-parity", module, 1, "<module>",
                    f"missing-scope:{scope_name}",
                    f"trace-carrier scope {scope_name} not found in "
                    f"{module} — update analysis/wirecheck.WIRE_SPEC "
                    "trace_specs if it moved"))
                continue
            referenced = any(
                (isinstance(n, ast.Name) and n.id == symbol)
                or (isinstance(n, ast.Attribute) and n.attr == symbol)
                for n in ast.walk(scope))
            if not referenced:
                findings.append(Finding(
                    "wire-trace-parity", module, scope.lineno, scope_name,
                    f"one-sided:{symbol}",
                    f"{scope_name} no longer references trace carrier "
                    f"{symbol} — the other side still speaks it, so "
                    "cross-node traces sever (or the receiver misparses "
                    "the payload head)"))
        return findings

    # -- nesting bound ------------------------------------------------------

    def _nesting_bound(self, path: str, tree: ast.Module,
                       fns: dict[str, ast.FunctionDef]) -> list[Finding]:
        enc_name, dec_name = self.spec["depth_pair"]
        findings: list[Finding] = []
        bounds: dict[str, tuple[set, list]] = {}
        for name in (enc_name, dec_name):
            fn = fns.get(name)
            if fn is None:
                findings.append(Finding(
                    "wire-nesting-bound", path, 1, "<module>",
                    f"missing-fn:{name}",
                    f"{name}() not found — update WIRE_SPEC if it moved"))
                continue
            names: set[str] = set()
            literals: list[int] = []
            for node in ast.walk(fn):
                if not isinstance(node, ast.Compare):
                    continue
                for side in [node.left, *node.comparators]:
                    d = _depth_const(side)
                    if d is None:
                        continue
                    if isinstance(d, str):
                        names.add(d)
                    else:
                        literals.append(node.lineno)
            bounds[name] = (names, literals)
            for line in literals:
                findings.append(Finding(
                    "wire-nesting-bound", path, line, name,
                    "literal-bound",
                    f"{name}() compares depth against a numeric literal — "
                    "use the shared module constant so encoder and decoder "
                    "cannot drift"))
            if not names and not literals:
                findings.append(Finding(
                    "wire-nesting-bound", path, fn.lineno, name,
                    "no-bound",
                    f"{name}() has no depth-bound comparison — unbounded "
                    "recursion on hostile nested envelopes"))
        if len(bounds) == 2:
            (n1, _), (n2, _) = bounds.values()
            if n1 and n2 and n1.isdisjoint(n2):
                findings.append(Finding(
                    "wire-nesting-bound", path, 1, "<module>",
                    f"split-bound:{sorted(n1)[0]}!={sorted(n2)[0]}",
                    f"{enc_name}() bounds depth by {sorted(n1)} but "
                    f"{dec_name}() by {sorted(n2)} — the nesting bound must "
                    "be one shared constant"))
        return findings

    # -- error classification ------------------------------------------------

    def _error_classified(self, wire_path: str,
                          wire: ast.Module) -> list[Finding]:
        root = self.spec["error_root"]
        # class -> direct base names, across wire.py + the base modules
        bases: dict[str, list[str]] = {}
        def_line: dict[str, int] = {}
        mods = [(wire_path, wire)]
        for p in self.spec["error_base_modules"]:
            if p in self._modules:
                mods.append((p, self._modules[p]))
        wire_classes: list[str] = []
        for p, tree in mods:
            for node in ast.walk(tree):
                if isinstance(node, ast.ClassDef):
                    bnames = [b.id for b in node.bases
                              if isinstance(b, ast.Name)]
                    bases[node.name] = bnames
                    def_line.setdefault(node.name, node.lineno)
                    if p == wire_path:
                        wire_classes.append(node.name)

        def ancestry(name: str) -> list[str]:
            out, todo = [], [name]
            while todo:
                n = todo.pop(0)
                for b in bases.get(n, ()):
                    if b not in out:
                        out.append(b)
                        todo.append(b)
            return out

        typed = [c for c in wire_classes if root in ancestry(c)]
        if root in bases:
            typed.append(root)
        if not typed:
            return []

        cl_path = self.spec["classifier_module"]
        cl = self._modules.get(cl_path)
        if cl is None:
            return [Finding(
                "wire-error-classified", wire_path, 1, "<module>",
                f"missing-classifier:{cl_path}",
                f"classifier module {cl_path} not analyzed — cannot verify "
                "the typed-error dispatch table")]
        handler_chains = self._handler_chains(cl)

        findings: list[Finding] = []
        for err in typed:
            anc = set(ancestry(err))
            covered = None
            for chain in handler_chains:
                names = [n for grp in chain for n in grp]
                if err in names or anc & set(names):
                    covered = chain
                    break
            if covered is None:
                findings.append(Finding(
                    "wire-error-classified", wire_path,
                    def_line.get(err, 1), err, f"unclassified:{err}",
                    f"typed error {err} (a {root} descendant) is never "
                    f"classified by the dispatch table in {cl_path} — peers "
                    "see a bare 500 instead of a typed, retryable status"))
                continue
            # subclass handler must precede ancestor handler
            names_in_order = [n for grp in covered for n in grp]
            if err in names_in_order:
                ei = names_in_order.index(err)
                for a in anc:
                    if a in names_in_order and names_in_order.index(a) < ei:
                        findings.append(Finding(
                            "wire-error-classified", wire_path,
                            def_line.get(err, 1), err, f"shadowed:{err}",
                            f"{err} handler in {cl_path} comes AFTER its "
                            f"ancestor {a}'s — Python takes the first match, "
                            "so the specific classification is dead code"))
        return findings

    @staticmethod
    def _handler_chains(tree: ast.Module) -> list[list[list[str]]]:
        """Each Try's except chain as a list of per-handler name groups."""
        chains = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Try):
                continue
            chain = []
            for h in node.handlers:
                t = h.type
                if t is None:
                    chain.append(["BaseException"])
                elif isinstance(t, ast.Tuple):
                    chain.append([_leaf_name(e) for e in t.elts])
                else:
                    chain.append([_leaf_name(t)])
            chains.append(chain)
        return chains


def _leaf_name(node: ast.expr) -> str:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return "<?>"


def _depth_const(node: ast.expr):
    """A depth-bound operand: an UPPERCASE constant Name mentioning
    DEPTH/NEST/MAX (returned as str — lowercase names are the counters, not
    the bound) or an int literal >= 2 (returned as int); else None."""
    if isinstance(node, ast.Name) and node.id == node.id.upper() and any(
            k in node.id for k in ("DEPTH", "NEST", "MAX")):
        return node.id
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool) and node.value >= 2:
        return node.value
    return None
