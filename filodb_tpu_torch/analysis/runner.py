"""Orchestration: file discovery, checker dispatch, suppression + baseline.

Pure stdlib + ast — importable with no torch/numpy on the path, so the
tier-1 test and CI hooks pay only parse time.

All rule families run over ONE shared :class:`~.corpus.Corpus`: module ASTs
parsed once, the PackageIndex built lazily exactly once, per-function CFGs
memoized by node identity. ``run_analysis(shared_corpus=False)`` preserves
the naive cost model (each family re-parses the package and builds its own
index), kept for ``--stats`` comparisons — findings are
fingerprint-identical in both modes.
"""

from __future__ import annotations

import ast
import time
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path

from .corpus import Corpus, parse_corpus
from .decodecheck import DecodeChecker
from .epochcheck import EpochChecker
from .exceptcheck import ExceptChecker
from .findings import (Baseline, Finding, STALE_IGNORE_RULE, is_suppressed,
                       load_suppressions)
from .indexcheck import IndexChecker
from .livecheck import LiveChecker
from .lockcheck import LockChecker
from .resourcecheck import ResourceChecker
from .surfacecheck import SurfaceChecker
from .wirecheck import WireChecker

# generated / vendored files never analyzed (the port's remote-storage
# codec is hand-written and analyzed like any module)
DEFAULT_EXCLUDES = ("remote_storage_pb2.py",)

# the analyzed package, relative to the repo root
PACKAGE = "filodb_tpu_torch"

ALL_RULES = tuple(sorted(
    set(LockChecker.rules) | set(WireChecker.rules)
    | set(ResourceChecker.rules) | set(ExceptChecker.rules)
    | set(SurfaceChecker.rules) | set(IndexChecker.rules)
    | set(DecodeChecker.rules)
    | set(EpochChecker.rules) | set(LiveChecker.rules)
    | {STALE_IGNORE_RULE}))

# the port's own baseline, empty: every finding is fixed or suppressed
# inline with its reason
DEFAULT_BASELINE = "filodb_tpu_torch/analysis/baseline.json"


@dataclass
class AnalysisReport:
    new: list[Finding] = field(default_factory=list)
    suppressed: list[Finding] = field(default_factory=list)
    baselined: list[Finding] = field(default_factory=list)
    files_analyzed: int = 0
    # repo-relative paths actually analyzed — narrow-scope tooling
    # (--changed-only --update-baseline) must not touch baseline entries
    # for files outside this set
    analyzed_paths: list[str] = field(default_factory=list)
    # --stats observability: seconds per rule family (+ "parse",
    # "stale-ignore"), total wall time, and Corpus build/hit counters
    timings: dict = field(default_factory=dict)
    corpus_stats: dict = field(default_factory=dict)
    wall_s: float = 0.0

    @property
    def all_findings(self) -> list[Finding]:
        return self.new + self.suppressed + self.baselined

    def counts_by_rule(self, which: str = "new") -> dict[str, int]:
        items = getattr(self, which)
        return dict(Counter(f.rule for f in items))

    def summary(self) -> str:
        lines = [f"filolint: {self.files_analyzed} files analyzed, "
                 f"{len(self.new)} new finding(s), "
                 f"{len(self.suppressed)} suppressed inline, "
                 f"{len(self.baselined)} baselined"]
        per_rule = Counter(f.rule for f in self.all_findings)
        for rule in ALL_RULES:
            n_all = per_rule.get(rule, 0)
            n_new = sum(1 for f in self.new if f.rule == rule)
            if n_all or n_new:
                lines.append(f"  {rule:<24} {n_all:>3} total, {n_new} new")
        return "\n".join(lines)

    def stats_lines(self) -> list[str]:
        lines = [f"filolint --stats: wall {self.wall_s:.3f}s"]
        for name, secs in sorted(self.timings.items(),
                                 key=lambda kv: -kv[1]):
            lines.append(f"  {name:<20} {secs:.4f}s")
        if self.corpus_stats:
            cs = self.corpus_stats
            lines.append(
                f"  corpus: {cs.get('modules', 0)} modules, "
                f"{cs.get('index_builds', 0)} index build(s) "
                f"({cs.get('index_build_s', 0.0)}s), "
                f"{cs.get('cfg_builds', 0)} CFG build(s) / "
                f"{cs.get('cfg_hits', 0)} hit(s)")
        return lines


def _discover(root: Path, paths: list[str] | None) -> list[Path]:
    if paths:
        out: list[Path] = []
        for p in paths:
            pp = (root / p) if not Path(p).is_absolute() else Path(p)
            if pp.is_dir():
                out.extend(sorted(pp.rglob("*.py")))
            else:
                out.append(pp)
    else:
        out = sorted((root / PACKAGE).rglob("*.py"))
    return [p for p in out if p.name not in DEFAULT_EXCLUDES]


def analyze_file(path: Path, root: Path | None = None,
                 checkers=None) -> list[Finding]:
    """Analyze one file standalone (fixture self-tests use this). Cross-file
    rules (lock-order graph, wire classification) still run via finalize over
    just this file."""
    root = root or path.parent
    checkers = checkers if checkers is not None else _default_checkers()
    rel = _relpath(path, root)
    source = path.read_text()
    tree = ast.parse(source, filename=str(path))
    findings: list[Finding] = []
    for c in checkers:
        findings += c.check_module(rel, tree)
    findings += _finalize(checkers, {rel: tree})
    supp = load_suppressions(source)
    findings += _stale_ignores(findings, {rel: supp})
    return [f for f in findings if not is_suppressed(f, supp)]


def _default_checkers(wire_spec: dict | None = None, full_scope: bool = True):
    surface = SurfaceChecker()
    surface.full_scope = full_scope
    live = LiveChecker()
    # unresolved-sanction errors need the whole package in view — a scoped
    # run would call a live sanction stale just because its target module
    # wasn't analyzed
    live.full_scope = full_scope
    return [LockChecker(), WireChecker(spec=wire_spec),
            ResourceChecker(), ExceptChecker(), IndexChecker(),
            DecodeChecker(), EpochChecker(), live, surface]


def _finalize(checkers, modules: dict, corpus: Corpus | None = None,
              timings: dict | None = None) -> list[Finding]:
    """Run every checker's finalize with ONE shared interprocedural corpus —
    the call graph / may-raise / thread-entry facts and per-function CFGs are
    built once and the resource/except/lock/epoch checkers all consume them."""
    if corpus is None:
        corpus = Corpus(modules)
    findings: list[Finding] = []
    for c in checkers:
        t0 = time.perf_counter()
        if hasattr(c, "project"):
            c.project = corpus.index
        if hasattr(c, "corpus"):
            c.corpus = corpus
        fin = getattr(c, "finalize", None)
        if fin is not None:
            findings += fin()
        if timings is not None:
            name = type(c).__name__
            timings[name] = timings.get(name, 0.0) + \
                (time.perf_counter() - t0)
            # per-rule sub-timings (livecheck reports its four passes)
            for sub, secs in getattr(c, "sub_timings", {}).items():
                timings[f"{name}.{sub}"] = \
                    timings.get(f"{name}.{sub}", 0.0) + secs
    return findings


def _stale_ignores(findings: list[Finding],
                   per_file_supp: dict[str, dict]) -> list[Finding]:
    """An inline ``# filolint: ignore[...]`` that no longer suppresses any
    finding is itself a finding: the comment documents an exception that no
    longer exists, and silently keeps suppressing whatever fires there NEXT.
    Judged against pre-suppression findings; skip-file markers (line 0) and
    ignores naming only the meta-rule are exempt."""
    out: list[Finding] = []
    fired: dict[tuple, set] = {}
    for f in findings:
        fired.setdefault((f.path, f.line), set()).add(f.rule)
    for path, supp in per_file_supp.items():
        for line, rules in sorted(supp.items()):
            if line == 0:
                continue
            here = fired.get((path, line), set())
            for r in sorted(rules):
                if r == STALE_IGNORE_RULE:
                    continue            # naming the meta-rule is always meta
                stale = not here if r == "*" else r not in here
                if stale:
                    out.append(Finding(
                        STALE_IGNORE_RULE, path, line, "<module>",
                        f"ignore[{r}]",
                        f"inline ignore[{r}] suppresses nothing — the "
                        "finding it excused is gone (or the rule name is "
                        "wrong); delete the comment, or it will silently "
                        "swallow the next finding on this line"))
    return out


def _relpath(path: Path, root: Path) -> str:
    try:
        return path.resolve().relative_to(root.resolve()).as_posix()
    except ValueError:
        return path.as_posix()


def run_analysis(root: Path | str, paths: list[str] | None = None,
                 baseline_path: Path | str | None = "auto",
                 wire_spec: dict | None = None,
                 shared_corpus: bool = True) -> AnalysisReport:
    """Analyze ``paths`` (default: the filodb_tpu_torch package under
    ``root``).

    ``baseline_path="auto"`` uses <root>/filodb_tpu_torch/analysis/
    baseline.json when present.
    ``shared_corpus=False`` runs each rule family against its own freshly
    parsed corpus + index (the pre-sharing cost model, kept for
    comparisons; findings are identical). Returns an AnalysisReport
    with findings split into new / inline-suppressed / baselined."""
    t_start = time.perf_counter()
    root = Path(root)
    if baseline_path == "auto":
        baseline_path = root / DEFAULT_BASELINE
    baseline = Baseline.load(baseline_path)
    full_scope = paths is None
    files = [(_relpath(p, root), p) for p in _discover(root, paths)]
    report = AnalysisReport()
    per_file_supp: dict[str, dict[int, set[str]]] = {}
    findings: list[Finding] = []

    def _ingest(corpus: Corpus, errors: list) -> None:
        for rel, e in errors:
            findings.append(Finding("parse-error", rel, 1, "<module>",
                                    "parse", f"cannot analyze: {e}"))
        for rel in corpus.modules:
            per_file_supp[rel] = load_suppressions(corpus.sources[rel])
            report.files_analyzed += 1
            report.analyzed_paths.append(rel)

    if shared_corpus:
        t0 = time.perf_counter()
        corpus, errors = parse_corpus(files)
        report.timings["parse"] = time.perf_counter() - t0
        _ingest(corpus, errors)
        checkers = _default_checkers(wire_spec, full_scope)
        for c in checkers:
            t0 = time.perf_counter()
            for rel, tree in corpus.modules.items():
                findings += c.check_module(rel, tree)
            report.timings[type(c).__name__] = time.perf_counter() - t0
        findings += _finalize(checkers, corpus.modules, corpus=corpus,
                              timings=report.timings)
        report.corpus_stats = corpus.stats()
    else:
        # legacy per-family cost model: every family pays its own parse of
        # the whole file set AND its own PackageIndex/CFG builds
        n_families = len(_default_checkers(wire_spec, full_scope))
        for i in range(n_families):
            c = _default_checkers(wire_spec, full_scope)[i]
            t0 = time.perf_counter()
            corpus, errors = parse_corpus(files)
            if i == 0:
                _ingest(corpus, errors)
            for rel, tree in corpus.modules.items():
                findings += c.check_module(rel, tree)
            findings += _finalize([c], corpus.modules, corpus=corpus)
            report.timings[type(c).__name__] = \
                report.timings.get(type(c).__name__, 0.0) + \
                (time.perf_counter() - t0)

    if full_scope:
        # *-unused-style judgements need the whole package in view; a scoped
        # run would call live suppressions stale just because the rule that
        # fires there didn't run
        t0 = time.perf_counter()
        findings += _stale_ignores(findings, per_file_supp)
        report.timings["stale-ignore"] = time.perf_counter() - t0

    for f in findings:
        if is_suppressed(f, per_file_supp.get(f.path, {})):
            report.suppressed.append(f)
        elif baseline.covers(f):
            report.baselined.append(f)
        else:
            report.new.append(f)
    report.wall_s = time.perf_counter() - t_start
    return report
