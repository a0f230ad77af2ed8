"""RulesManager: one handle wiring spec -> evaluator -> scheduler ->
alerts -> notifier, plus the /api/v1/rules and /api/v1/alerts payloads.

Constructed by the FiloServer when ``rules.groups`` is non-empty; tests and
the bench suite construct it directly around an in-process engine.

Port of ``filodb_tpu/rules/manager.py``.
"""

from __future__ import annotations

from .alerts import AlertManager, WebhookNotifier
from .evaluator import RuleEvaluator
from .scheduler import RuleGroupScheduler
from .spec import RuleGroupSpec, load_groups
from .state import RuleStateStore


class RulesManager:
    def __init__(self, groups: list[RuleGroupSpec], engine, publisher=None,
                 sink=None, dataset: str = "", webhook_url: str | None = None,
                 webhook_retries: int = 3, webhook_backoff_s: float = 1.0,
                 max_concurrent: int = 2, max_catchup: int = 2,
                 clock_ms=None, streaming: bool = False):
        self.groups = list(groups)
        self.state = RuleStateStore(sink, dataset)
        self.notifier = (WebhookNotifier(webhook_url, webhook_retries,
                                         webhook_backoff_s)
                         if webhook_url else None)
        alert_rules = [r for g in self.groups for r in g.rules
                       if r.kind == "alert"]
        self.alerts = AlertManager(alert_rules, state_store=self.state,
                                   notifier=self.notifier)
        self.evaluator = RuleEvaluator(engine, publisher=publisher,
                                       alert_manager=self.alerts,
                                       streaming=streaming)
        self.scheduler = RuleGroupScheduler(
            self.groups, self.evaluator, self.state,
            max_concurrent=max_concurrent, max_catchup=max_catchup,
            clock_ms=clock_ms)

    @classmethod
    def from_config(cls, cfg, engine, publisher, sink, dataset: str,
                    clock_ms=None) -> "RulesManager | None":
        from ..config import parse_duration_ms
        spec = cfg.get("rules.groups")
        if not spec:
            return None
        groups = load_groups(spec, parse_duration_ms(
            cfg["rules.default_interval"]))
        return cls(groups, engine, publisher=publisher, sink=sink,
                   dataset=dataset, webhook_url=cfg.get("rules.webhook_url"),
                   webhook_retries=int(cfg["rules.webhook_retries"]),
                   webhook_backoff_s=parse_duration_ms(
                       cfg["rules.webhook_backoff"]) / 1000.0,
                   max_concurrent=int(cfg["rules.max_concurrent"]),
                   max_catchup=int(cfg["rules.max_catchup"]),
                   clock_ms=clock_ms,
                   streaming=bool(cfg["rules.streaming"]))

    def start(self, ready=None) -> "RulesManager":
        """Start the group loops; none evaluates before ``ready()`` first
        returns True (RuleGroupScheduler.start)."""
        self.scheduler.start(ready)
        return self

    def stop(self) -> None:
        self.scheduler.stop()
        if self.notifier is not None:
            self.notifier.stop()

    # -- HTTP payloads (Prometheus /api/v1/rules & /api/v1/alerts shapes) -----

    def rules_payload(self) -> dict:
        firing = self.alerts.snapshot()
        out = []
        for g in self.groups:
            rules = []
            for r in g.rules:
                st = self.evaluator.status.get(r.uid) or {}
                row = {
                    "name": r.name, "query": r.expr,
                    "type": "recording" if r.kind == "record" else "alerting",
                    "labels": dict(r.labels),
                    "health": st.get("health", "unknown"),
                    "lastError": st.get("last_error") or "",
                    "lastEvaluation": (st.get("last_eval_ms") or 0) / 1000.0,
                    "evaluationTime": (st.get("last_duration_ms") or 0.0)
                    / 1000.0,
                }
                if r.kind == "alert":
                    instances = firing.get(r.uid) or {}
                    row["duration"] = r.for_ms / 1000.0
                    row["state"] = max(
                        (s["state"] for s in instances.values()),
                        key=("inactive", "pending", "firing").index,
                        default="inactive")
                    row["alerts"] = [
                        {"labels": dict(s["labels"]), "state": s["state"],
                         "activeAt": s["active_at"] / 1000.0,
                         "value": s.get("value")}
                        for s in instances.values()]
                rules.append(row)
            out.append({"name": g.name, "interval": g.interval_ms / 1000.0,
                        "rules": rules})
        return {"groups": out}

    def alerts_payload(self) -> dict:
        return {"alerts": self.alerts.active_alerts()}
