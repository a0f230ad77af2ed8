"""Shared analysis corpus: one parse, one index, memoized CFGs per run.

Before this module each rule family paid its own interprocedural costs:
the runner parsed every file once, but the resource/except rules each
rebuilt per-function CFGs on demand, fixture self-tests rebuilt a fresh
PackageIndex per file, and a naive per-family runner (the comparison mode
``run_analysis(shared_corpus=False)`` preserves it for the tier-1 timing
assertion) re-parses the whole package once per family. The Corpus is the
single shared substrate: module ASTs + raw sources, the PackageIndex
built lazily exactly once, and a per-function CFG cache keyed by node
identity (module ASTs live as long as the corpus, so ``id`` is stable).

Pure stdlib ``ast`` — importable with no torch/numpy on the path.
"""

from __future__ import annotations

import ast
import time
from pathlib import Path

from .callgraph import PackageIndex
from .cfg import CFG, build_cfg


class Corpus:
    """One run's shared AST/index/CFG substrate."""

    def __init__(self, modules: dict[str, ast.Module],
                 sources: dict[str, str] | None = None):
        self.modules = modules
        self.sources = sources or {}
        self._index: PackageIndex | None = None
        self._cfgs: dict[int, CFG] = {}
        # observability for --stats and the tier-1 sharing assertion
        self.index_builds = 0
        self.index_build_s = 0.0
        self.cfg_builds = 0
        self.cfg_hits = 0

    @property
    def index(self) -> PackageIndex:
        if self._index is None:
            t0 = time.perf_counter()
            self._index = PackageIndex(self.modules)
            self.index_build_s += time.perf_counter() - t0
            self.index_builds += 1
        return self._index

    def cfg(self, fn: ast.AST) -> CFG:
        """The per-function CFG, built at most once per corpus — every rule
        family that asks about the same function shares one graph."""
        key = id(fn)
        got = self._cfgs.get(key)
        if got is not None:
            self.cfg_hits += 1
            return got
        self.cfg_builds += 1
        g = build_cfg(fn)
        self._cfgs[key] = g
        return g

    def stats(self) -> dict:
        return {"modules": len(self.modules),
                "index_builds": self.index_builds,
                "index_build_s": round(self.index_build_s, 4),
                "cfg_builds": self.cfg_builds,
                "cfg_hits": self.cfg_hits}


def parse_corpus(files: list[tuple[str, Path]]) -> tuple[Corpus, list]:
    """Parse ``(relpath, path)`` pairs into a Corpus. Returns the corpus
    plus ``(relpath, error)`` pairs for unreadable/unparseable files (the
    runner renders those as parse-error findings)."""
    modules: dict[str, ast.Module] = {}
    sources: dict[str, str] = {}
    errors: list = []
    for rel, path in files:
        try:
            source = path.read_text()
            modules[rel] = ast.parse(source, filename=str(path))
            sources[rel] = source
        except (OSError, SyntaxError) as e:
            errors.append((rel, e))
    return Corpus(modules, sources), errors
