"""Streaming recording rules & alerting (port of ``filodb_tpu/rules/``).

Only the rule-file spec is ported so far: ``rules/spec.py`` (rule groups,
``load_groups`` and the reserved ``RULE_LABEL`` the gateway refuses on
external lines). The evaluator, scheduler, alert state machines, state
store and derived-series publisher come in the next slice; until then a
``FiloServer`` configured with ``rules.groups`` refuses to start.
"""

from .spec import RULE_LABEL, RuleGroupSpec, RuleSpec, load_groups

__all__ = ["RULE_LABEL", "RuleGroupSpec", "RuleSpec", "load_groups"]
