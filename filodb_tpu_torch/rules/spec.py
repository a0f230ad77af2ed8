"""Rule specifications: config -> validated recording/alerting rule groups.

Reference: Prometheus rule-group YAML (``groups: [{name, interval, rules:
[{record|alert, expr, labels, for}]}]``) — the reference FiloDB exposes the
Prometheus API surface (SURVEY §1 layer 8) but never evaluates rules; this
subsystem closes that loop. Specs are validated at LOAD time: every
expression must parse, ``@``-pinned selectors are rejected (a rule must be a
pure function of its evaluation timestamp so crash-replay pub-ids dedupe),
and the reserved ``__rule__`` label cannot be forged through rule labels —
the evaluator owns it.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..config import parse_duration_ms
from ..promql.parser import ParseError, parse_query, reject_at_modifier

# Reserved label every derived series carries (value = "group/rule"): makes
# rule output auditable cluster-wide and lets the write edges reject
# external writes that try to forge it (gateway drop + remote-write 422).
RULE_LABEL = "__rule__"

# labels a rule spec may never set: the evaluator derives them
_FORBIDDEN_RULE_LABELS = (RULE_LABEL, "_metric_", "__name__")


@dataclass(frozen=True)
class RuleSpec:
    """One recording or alerting rule inside a group."""
    name: str                                # record metric / alert name
    expr: str                                # PromQL, validated at load
    kind: str                                # "record" | "alert"
    group: str                               # owning group name
    labels: tuple[tuple[str, str], ...] = ()
    for_ms: int = 0                          # alerts: pending -> firing wait

    @property
    def uid(self) -> str:
        """Stable identity — the __rule__ label value AND the pub-id seed."""
        return f"{self.group}/{self.name}"


@dataclass(frozen=True)
class RuleGroupSpec:
    name: str
    interval_ms: int
    rules: tuple[RuleSpec, ...] = field(default_factory=tuple)


def _validate_rule(raw: dict, group: str) -> RuleSpec:
    if "record" in raw and "alert" in raw:
        raise ParseError(
            f"rule in group {group!r} sets both 'record' and 'alert'")
    if "record" in raw:
        kind, name = "record", str(raw["record"])
    elif "alert" in raw:
        kind, name = "alert", str(raw["alert"])
    else:
        raise ParseError(
            f"rule in group {group!r} needs 'record' or 'alert'")
    if not name:
        raise ParseError(f"rule in group {group!r} has an empty name")
    expr = str(raw.get("expr") or "")
    if not expr:
        raise ParseError(f"rule {group}/{name} has no 'expr'")
    parse_query(expr)                        # syntax errors fail the load
    # rules re-evaluate after crash/failover with the SAME (rule, eval_ts)
    # pub-ids; an @-pinned selector would break that purity contract
    reject_at_modifier(expr)
    labels = {str(k): str(v) for k, v in (raw.get("labels") or {}).items()}
    for forbidden in _FORBIDDEN_RULE_LABELS:
        if forbidden in labels:
            raise ParseError(
                f"rule {group}/{name} sets reserved label {forbidden!r}: "
                "the evaluator derives the metric name and the __rule__ "
                "audit label; rule labels cannot override them")
    for_ms = parse_duration_ms(raw.get("for", 0))
    if for_ms and kind != "alert":
        raise ParseError(
            f"rule {group}/{name}: 'for' only applies to alerting rules")
    return RuleSpec(name=name, expr=expr, kind=kind, group=group,
                    labels=tuple(sorted(labels.items())), for_ms=for_ms)


def load_groups(spec: list[dict] | None,
                default_interval_ms: int = 30_000) -> list[RuleGroupSpec]:
    """``rules.groups`` config -> validated group specs. Any invalid entry
    fails the whole load with a typed ParseError naming the rule — a server
    must refuse to start with a rule set it cannot evaluate."""
    groups: list[RuleGroupSpec] = []
    seen_groups: set[str] = set()
    seen_uids: set[str] = set()
    for g in (spec or []):
        name = str(g.get("name") or "")
        if not name:
            raise ParseError("rule group has no 'name'")
        if name in seen_groups:
            raise ParseError(f"duplicate rule group {name!r}")
        seen_groups.add(name)
        interval = parse_duration_ms(g.get("interval",
                                           default_interval_ms))
        if interval <= 0:
            raise ParseError(f"rule group {name!r}: interval must be > 0")
        rules = tuple(_validate_rule(dict(r), name)
                      for r in (g.get("rules") or []))
        if not rules:
            raise ParseError(f"rule group {name!r} has no rules")
        for r in rules:
            if r.uid in seen_uids:
                raise ParseError(f"duplicate rule {r.uid!r}")
            seen_uids.add(r.uid)
        groups.append(RuleGroupSpec(name=name, interval_ms=interval,
                                    rules=rules))
    return groups
