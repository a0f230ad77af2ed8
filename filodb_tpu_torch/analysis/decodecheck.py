"""surface-decode-variant-twin: every decode variant has both of its halves.

The port's fused tier streams each block format through two halves: the
plain PyTorch ``decode`` a variant registers in ``ops/decodereg.py`` (the
CPU twin, and the oracle the card's checks hold K1 against), and K1's own
decode in ``csrc/fusedgrid.cu``, selected by the variant's code in
``ops/fusedgrid.py``'s ``KIND_CODES``. A variant with only one half passes
every test of the other: a registered name with no kernel code cannot be
served on the card, and a kernel code with no registered twin has no
oracle and no CPU path. The reference's form of the rule (``pallas=`` and
``xla=`` keywords, filodb_tpu/analysis/decodecheck.py) has no object here;
its contract does:

  * every ``register_variant(...)`` call passes a ``decode=`` keyword, and
    not the literal ``None``;
  * the set of registered names equals the keys of the ``KIND_CODES``
    literal: a registered name missing from it, or a key with no
    registration, is the finding.

The registry and the kernel codes live in two modules, so the set check
runs at finalize and only when both sides are in scope (a fixture twin
carries both in one file, with a ``bad_``/``good_`` prefix).
"""

from __future__ import annotations

import ast
import re

from .findings import Finding

_FIXTURE = (r"|(?:^|/)fixtures/filolint(?:_torch)?/"
            r"(?:bad_|good_)decode_variant\.py$")
# the registry side: register_variant(...) calls
_DECODE_MODULE = re.compile(r"(?:^|/)ops/decodereg\.py$" + _FIXTURE)
# the kernel side: the KIND_CODES literal
_KIND_MODULE = re.compile(r"(?:^|/)ops/fusedgrid\.py$" + _FIXTURE)

_REQUIRED = "decode"
_KIND_TABLE = "KIND_CODES"
RULE = "surface-decode-variant-twin"


def _is_register_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    name = f.id if isinstance(f, ast.Name) else (
        f.attr if isinstance(f, ast.Attribute) else None)
    return name == "register_variant"


def _variant_name(node: ast.Call) -> str:
    if node.args and isinstance(node.args[0], ast.Constant) \
            and isinstance(node.args[0].value, str):
        return node.args[0].value
    for k in node.keywords:
        if k.arg == "name" and isinstance(k.value, ast.Constant) \
                and isinstance(k.value.value, str):
            return k.value.value
    return "<dynamic>"


def _kind_table(tree: ast.Module):
    """{name: line} of a module-level ``KIND_CODES = {...}`` literal's
    string keys, or None."""
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == _KIND_TABLE \
                and isinstance(node.value, ast.Dict):
            return {k.value: k.lineno for k in node.value.keys
                    if isinstance(k, ast.Constant)
                    and isinstance(k.value, str)}
    return None


class DecodeChecker:
    rules = (RULE,)

    def __init__(self):
        self.project = None          # unused; kept for checker symmetry
        # name -> (path, line, symbol) of each register_variant call
        self._registered: dict[str, tuple[str, int, str]] = {}
        # (path, {name: line}) of the KIND_CODES literal
        self._kinds: tuple[str, dict[str, int]] | None = None

    def check_module(self, path: str, tree: ast.Module) -> list[Finding]:
        findings: list[Finding] = []
        if _KIND_MODULE.search(path):
            table = _kind_table(tree)
            if table is not None:
                self._kinds = (path, table)
        if not _DECODE_MODULE.search(path):
            return findings
        for node in ast.walk(tree):
            if not _is_register_call(node):
                continue
            vname = _variant_name(node)
            sym = self._enclosing(tree, node)
            self._registered.setdefault(vname, (path, node.lineno, sym))
            kws = {k.arg: k.value for k in node.keywords}
            val = kws.get(_REQUIRED)
            if _REQUIRED not in kws:
                findings.append(Finding(
                    RULE, path, node.lineno, sym, f"missing:{vname}:decode",
                    f"decode variant {vname!r} is registered without a "
                    "decode= twin — the plain path and the card's checks "
                    "have no oracle for K1's decode of this format; pass "
                    "the plain PyTorch decode (ops/decodereg.py "
                    "register_variant)"))
            elif isinstance(val, ast.Constant) and val.value is None:
                findings.append(Finding(
                    RULE, path, node.lineno, sym, f"none:{vname}:decode",
                    f"decode variant {vname!r} passes decode=None — a "
                    "placeholder the CPU twin calls and cannot run; wire "
                    "the real plain decode"))
        return findings

    def finalize(self) -> list[Finding]:
        if self._kinds is None or not self._registered:
            return []               # one side out of scope: nothing to pair
        kpath, kinds = self._kinds
        findings: list[Finding] = []
        for name, (path, line, sym) in sorted(self._registered.items()):
            if name != "<dynamic>" and name not in kinds:
                findings.append(Finding(
                    RULE, path, line, sym, f"no-kernel:{name}",
                    f"decode variant {name!r} is registered but has no "
                    f"code in {_KIND_TABLE} ({kpath}) — K1 cannot decode "
                    "it, so the card cannot serve what the plain twin "
                    "accepts; add its code and its case in the kernel"))
        for name, line in sorted(kinds.items()):
            if name not in self._registered:
                findings.append(Finding(
                    RULE, kpath, line, "<module>", f"no-twin:{name}",
                    f"kernel variant {name!r} in {_KIND_TABLE} has no "
                    "register_variant(...) with a plain decode= twin — "
                    "the CPU path cannot serve it and the card's checks "
                    "have nothing to hold it against"))
        return findings

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
