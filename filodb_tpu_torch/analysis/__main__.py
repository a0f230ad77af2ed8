"""CLI: ``python -m filodb_tpu_torch.analysis [paths...]``.

Exit status: 0 when no NEW findings (inline-suppressed and baselined
findings are reported but don't fail); 1 otherwise; 2 on usage errors.

Output modes (``--format``): ``text`` (default, per-finding lines +
summary), ``json`` (full report for CI annotators / the bench harness),
``sarif`` (SARIF 2.1.0 for GitHub code scanning / editor viewers).

``--changed-only`` analyzes only files ``git status`` reports as modified
(plus the spec anchor modules the cross-file rules compare against) — the
fast pre-commit mode. ``--update-baseline`` rewrites the baseline with the
current NEW findings and REFUSES to run without ``--reason``: a baseline
entry is a promise, not a TODO.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

from .corpus import parse_corpus
from .findings import (Baseline, is_suppressed, load_suppressions,
                       report_json, report_sarif)
from .livecheck import LiveChecker
from .runner import ALL_RULES, DEFAULT_BASELINE, PACKAGE, run_analysis

# modules the cross-file rules need in scope even when unchanged: the wire
# codec + its HTTP classifier, the typed-error bases, the broker op spec,
# the declared-surface dicts, the epoch-visibility spec (EPOCH_SPEC — the
# epoch rules judge every mutator against it), the liveness contract
# (LATENCY_SPEC in utils/diagnostics.py — livecheck judges lock-held spans
# and waits against it), and both sides of the decode-registry rule (the
# registered variants and K1's KIND_CODES)
ANCHOR_MODULES = (
    "filodb_tpu_torch/config.py",
    "filodb_tpu_torch/core/memstore.py",
    "filodb_tpu_torch/utils/metrics.py",
    "filodb_tpu_torch/utils/tracing.py",
    "filodb_tpu_torch/utils/diagnostics.py",
    "filodb_tpu_torch/query/wire.py",
    "filodb_tpu_torch/query/rangevector.py",
    "filodb_tpu_torch/http/api.py",
    "filodb_tpu_torch/ingest/broker.py",
    "filodb_tpu_torch/ops/decodereg.py",
    "filodb_tpu_torch/ops/fusedgrid.py",
)

# the analyzed package; the trailing slash matters: "filodb_tpu_torch/"
# must never match the JAX package's "filodb_tpu/" paths or vice versa
_PACKAGE_PREFIX = PACKAGE + "/"

# the port's tools the --include-tools audit reads (warnings only)
TOOLS = ("chip_smoke.py", "scripts/profile_torch_query.py")

# a change to any of these invalidates every scoped judgement: the checkers
# themselves, or the fixture twins that pin their behavior — escalate a
# --changed-only run to a full one instead of lint-checking the new rules
# against a partial corpus
_ESCALATE_PREFIXES = ("filodb_tpu_torch/analysis/",
                      "tests/fixtures/filolint/",
                      "tests/fixtures/filolint_torch/")


def _porcelain_paths(root: Path) -> list[str] | None:
    """Root-relative paths git reports changed (staged, unstaged or
    untracked), any extension/location. None on git failure. Porcelain
    paths are TOPLEVEL-relative; when ``root`` sits below the git toplevel
    (a vendored checkout), they are rebased via ``--show-prefix`` so a
    changed-only run never silently analyzes nothing."""
    try:
        out = subprocess.run(
            ["git", "status", "--porcelain"], cwd=root, capture_output=True,
            text=True, timeout=30, check=True).stdout
        prefix = subprocess.run(
            ["git", "rev-parse", "--show-prefix"], cwd=root,
            capture_output=True, text=True, timeout=30,
            check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    paths: list[str] = []
    for line in out.splitlines():
        p = line[3:].split(" -> ")[-1].strip().strip('"')
        if prefix:
            if not p.startswith(prefix):
                continue                    # outside the analysis root
            p = p[len(prefix):]
        paths.append(p)
    return paths


def _changed_files(root: Path) -> list[str] | None:
    """Root-relative changed .py paths under filodb_tpu_torch/ (the analyzable
    subset of :func:`_porcelain_paths`)."""
    raw = _porcelain_paths(root)
    if raw is None:
        return None
    return [p for p in raw
            if p.endswith(".py") and p.startswith(_PACKAGE_PREFIX)
            and (root / p).exists()]


def _tools_audit(root: Path) -> list[str]:
    """Liveness audit of the port's own tools (``chip_smoke.py`` and
    ``scripts/profile_torch_query.py``) that sit OUTSIDE the package the
    main run analyzes.
    Tool code still deadlocks and still hangs CI, but it has no baseline
    and no fixture twins — so findings here are WARNINGS only: printed,
    never counted toward the exit status. The LATENCY_SPEC anchor module
    rides along so the livecheck rules have a contract in scope; findings
    in the anchor itself are the main run's business and are dropped."""
    anchor_rel = "filodb_tpu_torch/utils/diagnostics.py"
    files = [root / t for t in TOOLS if (root / t).exists()]
    if (root / anchor_rel).exists():
        files.append(root / anchor_rel)
    pairs = []
    for p in files:
        try:
            rel = p.resolve().relative_to(root.resolve()).as_posix()
        except ValueError:
            rel = p.as_posix()
        pairs.append((rel, p))
    corpus, errors = parse_corpus(pairs)
    checker = LiveChecker()
    findings = []
    for rel, tree in corpus.modules.items():
        findings += checker.check_module(rel, tree)
    if hasattr(checker, "project"):
        checker.project = corpus.index
    if hasattr(checker, "corpus"):
        checker.corpus = corpus
    findings += checker.finalize()
    lines = [f"filolint: tools-audit parse error in {rel}: {e}"
             for rel, e in errors]
    for f in sorted(findings, key=lambda f: (f.path, f.line)):
        if f.path == anchor_rel:
            continue
        supp = load_suppressions(corpus.sources.get(f.path, ""))
        if is_suppressed(f, supp):
            continue
        lines.append(f"filolint: tools-audit warning: {f.render()}")
    return lines


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m filodb_tpu_torch.analysis",
        description="filolint: project-invariant static analysis "
                    "(lock discipline, JIT hygiene, wire exhaustiveness, "
                    "resource lifecycle, except-flow, declared surface)")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to analyze (default: the "
                         "filodb_tpu_torch package next to this module)")
    ap.add_argument("--root", default=None,
                    help="repo root (default: parent of the "
                         "filodb_tpu_torch package)")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline file (default: <root>/{DEFAULT_BASELINE})")
    ap.add_argument("--format", choices=("text", "json", "sarif"),
                    default="text", help="output format (default: text)")
    ap.add_argument("--changed-only", action="store_true",
                    help="analyze only git-modified files under "
                         "filodb_tpu_torch/ "
                         "(plus the cross-file anchor modules) — fast "
                         "pre-commit mode; *-unused rules are skipped")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline: keep entries that still "
                         "match, add the current NEW findings (requires "
                         "--reason), then exit 0")
    ap.add_argument("--reason", default=None,
                    help="why the findings being baselined are intentional "
                         "(required by --update-baseline)")
    ap.add_argument("--quiet", action="store_true",
                    help="summary only, no per-finding lines (text format)")
    ap.add_argument("--stats", action="store_true",
                    help="print per-rule-family timings and shared-corpus "
                         "build/hit counters to stderr")
    ap.add_argument("--include-tools", action="store_true",
                    help="additionally audit the port's tools ("
                         + ", ".join(TOOLS) + ") with the liveness rules "
                         "— warnings only, never affects the exit status")
    ap.add_argument("--no-shared-corpus", action="store_true",
                    help="re-parse the package and rebuild the index per "
                         "rule family (the pre-sharing cost model; findings "
                         "are identical — kept for benchmarking)")
    args = ap.parse_args(argv)

    root = Path(args.root) if args.root else \
        Path(__file__).resolve().parents[2]
    baseline_path = Path(args.baseline) if args.baseline \
        else root / DEFAULT_BASELINE

    paths = args.paths or None
    if args.changed_only:
        if paths:
            ap.error("--changed-only and explicit paths are exclusive")
        raw = _porcelain_paths(root)
        changed = None if raw is None else [
            p for p in raw if p.endswith(".py")
            and p.startswith(_PACKAGE_PREFIX) and (root / p).exists()]
        if changed is None:
            print("filolint: git unavailable; falling back to a full run",
                  file=sys.stderr)
        elif any(p.startswith(_ESCALATE_PREFIXES) for p in raw):
            print("filolint: analysis code or fixture twins changed — "
                  "escalating --changed-only to a full run", file=sys.stderr)
        elif not changed:
            print("filolint: no changed files under filodb_tpu_torch/ — "
                  "nothing to analyze")
            return 0
        else:
            anchors = [a for a in ANCHOR_MODULES if (root / a).exists()]
            paths = sorted(set(changed) | set(anchors))

    report = run_analysis(root, paths, baseline_path=baseline_path,
                          shared_corpus=not args.no_shared_corpus)
    if args.include_tools:
        for line in _tools_audit(root):
            print(line, file=sys.stderr)
    if args.stats:
        for line in report.stats_lines():
            print(line, file=sys.stderr)

    if args.update_baseline:
        if report.new and not (args.reason and args.reason.strip()):
            print("filolint: --update-baseline refuses entries without a "
                  "--reason (a baseline entry is a promise that the finding "
                  "is intentional)", file=sys.stderr)
            return 2
        # keep existing entries that still correspond to a live finding, so
        # stale promises age out of the file instead of accreting — but only
        # judge entries for files THIS run analyzed: a narrow scope
        # (--changed-only / explicit paths) must not delete out-of-scope
        # promises it never re-checked
        analyzed = set(report.analyzed_paths)
        live = {f.fingerprint for f in report.baselined}
        old = Baseline.load(baseline_path)
        keep = [e for e in old.entries
                if e["file"] not in analyzed
                or (e["rule"], e["file"], e["symbol"], e["detail"]) in live]
        Baseline.write(baseline_path, report.new, reason=args.reason,
                       keep=keep)
        print(f"baseline updated: {len(keep)} kept, {len(report.new)} added "
              f"-> {baseline_path}")
        return 0

    if args.format == "json":
        print(report_json(report))
    elif args.format == "sarif":
        print(report_sarif(report, ALL_RULES))
    else:
        if not args.quiet:
            for f in sorted(report.new, key=lambda f: (f.path, f.line)):
                print(f.render())
        print(report.summary())
    return 1 if report.new else 0


if __name__ == "__main__":
    sys.exit(main())
