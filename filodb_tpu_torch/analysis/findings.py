"""Finding model, inline suppressions, and the checked-in baseline.

A finding's identity for baseline matching is (rule, file, symbol, detail) —
deliberately NOT the line number, so a baseline entry survives unrelated
edits to the file. ``detail`` is a short stable key chosen by each checker
(the attribute written, the callee name, the missing tag...).
"""

from __future__ import annotations

import json
import re
from dataclasses import asdict, dataclass
from pathlib import Path

SUPPRESS_RE = re.compile(r"#\s*filolint:\s*ignore\[([A-Za-z0-9_\-*,\s]+)\]")
SKIP_FILE_RE = re.compile(r"#\s*filolint:\s*skip-file")

# the meta-rule reported when an inline ignore no longer suppresses
# anything (see runner._stale_ignores)
STALE_IGNORE_RULE = "filolint-stale-ignore"


@dataclass(frozen=True)
class Finding:
    rule: str          # e.g. "lock-unheld-call"
    path: str          # repo-relative posix path
    line: int          # 1-based
    symbol: str        # enclosing qualname ("Class.method", "func", "<module>")
    detail: str        # stable short key for baseline identity
    message: str

    @property
    def fingerprint(self) -> tuple:
        return (self.rule, self.path, self.symbol, self.detail)

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.symbol}: {self.message}"


def load_suppressions(source: str) -> dict[int, set[str]]:
    """line (1-based) -> set of suppressed rule names ("*" = all).

    A whole-file opt-out (``# filolint: skip-file`` in the first 5 lines)
    maps to line 0 carrying {"*"}."""
    out: dict[int, set[str]] = {}
    lines = source.splitlines()
    for head in lines[:5]:
        if SKIP_FILE_RE.search(head):
            out[0] = {"*"}
    for i, text in enumerate(lines, start=1):
        m = SUPPRESS_RE.search(text)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return out


def is_suppressed(f: Finding, supp: dict[int, set[str]]) -> bool:
    if 0 in supp:
        return True
    rules = supp.get(f.line)
    if not rules:
        return False
    if f.rule == STALE_IGNORE_RULE:
        # a stale-ignore finding points AT an ignore comment; letting that
        # comment's own ``*`` (or the stale rule name it carries) swallow
        # the finding would make the rule unfireable. Only an ignore that
        # names the meta-rule explicitly counts as an accepted exception.
        return STALE_IGNORE_RULE in rules
    return "*" in rules or f.rule in rules


class Baseline:
    """Checked-in list of intentionally-kept findings, each with a reason.

    Format (filolint_baseline.json):
        {"entries": [{"rule": ..., "file": ..., "symbol": ..., "detail": ...,
                      "reason": "why this one stays"}]}
    """

    def __init__(self, entries: list[dict] | None = None):
        self.entries = entries or []
        self._index = {(e["rule"], e["file"], e["symbol"], e["detail"])
                       for e in self.entries}

    @classmethod
    def load(cls, path: Path | str | None) -> "Baseline":
        if path is None:
            return cls()
        p = Path(path)
        if not p.exists():
            return cls()
        data = json.loads(p.read_text())
        return cls(data.get("entries", []))

    def covers(self, f: Finding) -> bool:
        return f.fingerprint in self._index

    @staticmethod
    def write(path: Path | str, findings: list[Finding],
              reason: str | None = None,
              keep: list[dict] | None = None) -> None:
        """Write ``findings`` (appended to ``keep``) as baseline entries.

        A baseline entry is a PROMISE that the finding is intentional, so a
        reason is mandatory — callers without one are refused (the
        ``--update-baseline`` CLI surfaces this as an error instead of
        writing 'TODO' placeholders that nobody ever fills in)."""
        if findings and not (reason and reason.strip()):
            raise ValueError(
                "baseline entries require a reason — pass --reason "
                "'why these findings are intentional'")
        entries = list(keep or [])
        entries += [{"rule": f.rule, "file": f.path, "symbol": f.symbol,
                     "detail": f.detail, "reason": reason}
                    for f in findings]
        Path(path).write_text(json.dumps({"entries": entries}, indent=2) + "\n")


def as_json(findings: list[Finding]) -> str:
    return json.dumps([asdict(f) for f in findings], indent=2)


def report_json(report) -> str:
    """Machine-readable report: per-bucket findings + counts (the shape CI
    annotators and the bench harness consume)."""
    return json.dumps({
        "files_analyzed": report.files_analyzed,
        "counts": {"new": len(report.new),
                   "suppressed": len(report.suppressed),
                   "baselined": len(report.baselined)},
        "new": [asdict(f) for f in report.new],
        "suppressed": [asdict(f) for f in report.suppressed],
        "baselined": [asdict(f) for f in report.baselined],
    }, indent=2)


SARIF_RULE_HELP = "see ANALYSIS.md for the invariant behind each rule"


def report_sarif(report, rule_ids: tuple) -> str:
    """SARIF 2.1.0 — the interchange format GitHub code scanning, VS Code
    SARIF viewers and most CI annotators ingest. Only NEW findings are
    results (suppressed/baselined are accepted states, not alerts)."""
    return json.dumps({
        "$schema": ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                    "master/Schemata/sarif-schema-2.1.0.json"),
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "filolint",
                "informationUri": "ANALYSIS.md",
                "rules": [{"id": r,
                           "shortDescription": {"text": SARIF_RULE_HELP}}
                          for r in rule_ids],
            }},
            "results": [{
                "ruleId": f.rule,
                "level": "error",
                "message": {"text": f"{f.symbol}: {f.message}"},
                "partialFingerprints": {
                    "filolint/v1": "/".join(map(str, f.fingerprint))},
                "locations": [{"physicalLocation": {
                    "artifactLocation": {"uri": f.path},
                    "region": {"startLine": max(1, f.line)},
                }}],
            } for f in report.new],
        }],
    }, indent=2)
