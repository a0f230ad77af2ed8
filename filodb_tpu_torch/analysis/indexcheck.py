"""index-pure-python-postings: the vectorized-ops-only contract of the
columnar index modules.

The part-key index's postings plane (``core/index*.py`` — the columnar
engine of ISSUE 15) exists because per-element Python iteration over
posting arrays is exactly what cannot survive 1M series: one innocuous
``for pid in postings:`` in the hot module quietly turns an O(words)
bitmap AND back into an interpreter loop, and no unit test notices until a
production shard does. This rule makes the contract structural: inside any
module whose basename matches ``index*.py`` (fixture twins carry a
``bad_``/``good_`` prefix), a ``for`` statement or comprehension whose
ITERABLE mentions a posting identifier (any name or attribute containing
"posting", or a ``.tolist()`` of one) is a finding. Loops over terms,
staged segment lists, or trigram codes are fine — only the posting arrays
themselves are ops-only."""

from __future__ import annotations

import ast
import re

from .findings import Finding

# the hot-module scope: core/index*.py (the columnar engine and future
# index_* modules) plus the fixture twins — NOT every module that happens
# to be named index*.py (this checker included)
_INDEX_MODULE = re.compile(
    r"(?:^|/)core/index[^/]*\.py$"
    r"|(?:^|/)fixtures/filolint(?:_torch)?/(?:bad_|good_)index[^/]*\.py$")

_POSTING = re.compile("posting", re.IGNORECASE)


def _mentions_postings(expr: ast.expr) -> str | None:
    """The first posting-ish identifier inside ``expr``, or None."""
    for node in ast.walk(expr):
        name = None
        if isinstance(node, ast.Name):
            name = node.id
        elif isinstance(node, ast.Attribute):
            name = node.attr
        if name is not None and _POSTING.search(name):
            return name
    return None


class IndexChecker:
    rules = ("index-pure-python-postings",)

    def __init__(self):
        self.project = None          # unused; kept for checker symmetry

    def check_module(self, path: str, tree: ast.Module) -> list[Finding]:
        if not _INDEX_MODULE.search(path):
            return []
        findings: list[Finding] = []
        for node in ast.walk(tree):
            iters: list[ast.expr] = []
            if isinstance(node, (ast.For, ast.AsyncFor)):
                iters.append(node.iter)
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                   ast.GeneratorExp)):
                iters.extend(g.iter for g in node.generators)
            for it in iters:
                name = _mentions_postings(it)
                if name is None:
                    continue
                findings.append(Finding(
                    "index-pure-python-postings", path, node.lineno,
                    self._enclosing(tree, node), f"loop:{name}",
                    f"per-element Python loop over posting array {name!r} "
                    "in a columnar index module — postings are "
                    "vectorized-ops-only (bitmap algebra, searchsorted "
                    "merges, fancy-index gathers); an interpreter loop "
                    "here is the 1M-series bottleneck the module exists "
                    "to prevent"))
        return findings

    def finalize(self) -> list[Finding]:
        return []

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
