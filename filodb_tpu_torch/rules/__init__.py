"""Streaming recording rules & alerting (port of ``filodb_tpu/rules/``).

A rule-group scheduler evaluates PromQL through the full QueryEngine (on
the card, one K1 launch a shard leaf for a fused rule) and publishes the
derived series back through the gateway/broker path with DETERMINISTIC
(rule, eval_ts) pub-ids, so a re-evaluation after a crash or a leader
failover is exactly-once by the broker's pub-id idempotence. Alerting rules
run ``for``-duration state machines whose timers persist to the durable
ring, and a webhook notifier delivers firing/resolved transitions with
retry/backoff. The pub-ids, the meta document and the wire bytes are the
reference's, so either package resumes the other's state.
"""

from .alerts import AlertManager, WebhookNotifier
from .evaluator import RULES_TENANT, RuleEvaluator
from .manager import RulesManager
from .publish import DerivedSeriesPublisher, derive_pub_id
from .scheduler import RuleGroupScheduler
from .spec import RULE_LABEL, RuleGroupSpec, RuleSpec, load_groups
from .state import RuleStateStore

__all__ = [
    "AlertManager", "WebhookNotifier", "RuleEvaluator", "RULES_TENANT",
    "RulesManager", "DerivedSeriesPublisher", "derive_pub_id",
    "RuleGroupScheduler", "RULE_LABEL", "RuleGroupSpec", "RuleSpec",
    "load_groups", "RuleStateStore",
]
