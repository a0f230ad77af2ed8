"""Rule evaluator: one group tick -> PromQL instant queries -> derived
writes / alert transitions.

Evaluation goes through the full QueryEngine — fused kernels, caches,
retention routing, admission, tracing all apply, exactly as a dashboard's
instant query would (the rules workload is deliberately NOT a side door).
Rules inside a group evaluate SEQUENTIALLY at one shared eval timestamp, so
a recording rule can feed a later rule of the same group on the next tick
(the Prometheus contract).

Port of ``filodb_tpu/rules/evaluator.py``. On the card a rule's instant query
is one K1 launch a shard leaf where it fuses; a query that fails on the
card counts as a failed evaluation (``health: err``) and is never retried
on the CPU.
"""

from __future__ import annotations

import logging
import time

import numpy as np

from ..utils.metrics import (FILODB_RULES_EVAL_FAILURES,
                             FILODB_RULES_EVALUATIONS, registry)
from ..utils.tracing import SPAN_RULES_EVAL, span
from .spec import RULE_LABEL, RuleGroupSpec, RuleSpec

log = logging.getLogger("filodb_tpu_torch.rules")

# admission-quota identity of every rule-driven query (X-Filo-Tenant
# analog): operators can cap the rules workload per tenant_quotas like any
# other tenant, and its sheds are attributable in the metrics
RULES_TENANT = "__rules__"


class RuleEvaluator:
    def __init__(self, engine, publisher=None, alert_manager=None,
                 streaming: bool = False):
        self.engine = engine
        self.publisher = publisher
        self.alert_manager = alert_manager
        # rules.streaming: rules consume per-step increments from a
        # QuerySubscription (query/incremental.py) — the degenerate
        # subscriber of the streaming-query machinery. Each tick takes its
        # grid step; a catch-up span prefetches as ONE range query instead
        # of one full-window evaluation per missed tick. Per-step
        # independence makes the step bit-identical to the instant query
        # it replaces; anything unbuffered falls back to the instant path.
        self.streaming = bool(streaming)
        self._subs: dict[str, object] = {}
        # rule uid -> {"health", "last_error", "last_eval_ms",
        #              "last_duration_ms"} for the /api/v1/rules payload
        self.status: dict[str, dict] = {}

    def _sub_for(self, rule: RuleSpec, interval_ms: int):
        sub = self._subs.get(rule.uid)
        if sub is None or sub.step_ms != int(interval_ms):
            from ..query.incremental import QuerySubscription
            sub = QuerySubscription(self.engine, rule.expr, int(interval_ms),
                                    tenant=RULES_TENANT)
            self._subs[rule.uid] = sub
        return sub

    def prefetch(self, group: RuleGroupSpec, ticks: list[int]) -> None:
        """Catch-up batcher (called by the scheduler before a multi-tick
        span): buffer every pending step of every rule in one range query
        per rule — the whole point of rules-as-subscribers."""
        if not self.streaming or len(ticks) < 2:
            return
        for rule in group.rules:
            self._sub_for(rule, group.interval_ms).prefetch(ticks[0],
                                                            ticks[-1])

    def _eval_series(self, rule: RuleSpec, eval_ts: int,
                     interval_ms: int | None) -> list[tuple[dict, float]]:
        """(labels, value) pairs at ``eval_ts`` — from the rule's streaming
        subscription when enabled (bit-identical to the instant query by
        per-step independence), else an instant query."""
        if self.streaming and interval_ms:
            got = self._sub_for(rule, interval_ms).take(int(eval_ts))
            if got is not None:
                return [(dict(key.labels), v) for key, v in got]
        res = self.engine.query_instant(rule.expr, int(eval_ts),
                                        tenant=RULES_TENANT)
        return self._series_of(res, eval_ts)

    def _series_of(self, result, eval_ts: int) -> list[tuple[dict, float]]:
        """Instant-vector output as (labels, value) pairs; NaN points are
        stale/absent and drop (matrix iteration already omits them)."""
        out: list[tuple[dict, float]] = []
        for key, _ts, vals in result.matrix.iter_series():
            v = float(np.asarray(vals)[-1])
            labels = dict(key.labels)
            out.append((labels, v))
        return out

    def _derived_rows(self, rule: RuleSpec,
                      series: list[tuple[dict, float]]) -> list:
        rows = []
        for labels, value in series:
            d = dict(labels)
            d.pop("_metric_", None)       # the record name IS the metric
            d.update(rule.labels)         # rule labels override (Prometheus)
            d["_metric_"] = rule.name
            d[RULE_LABEL] = rule.uid      # provenance: audit + spoof guard
            d.setdefault("_ws_", "default")
            d.setdefault("_ns_", "default")
            rows.append((d, value))
        return rows

    def _alert_instances(self, rule: RuleSpec,
                         series: list[tuple[dict, float]]) -> list:
        out = []
        for labels, value in series:
            d = dict(labels)
            d.pop("_metric_", None)       # Prometheus drops __name__
            d.update(rule.labels)
            out.append((d, value))
        return out

    def evaluate_rule(self, rule: RuleSpec, eval_ts: int,
                      interval_ms: int | None = None) -> int:
        """Evaluate one rule at ``eval_ts``; returns derived rows written
        (0 for alerts). Failures count and re-raise — the group loop
        decides whether the tick's watermark advances."""
        t0 = time.perf_counter_ns()
        try:
            with span(SPAN_RULES_EVAL, group=rule.group, rule=rule.name,
                      eval_ts=int(eval_ts)):
                series = self._eval_series(rule, eval_ts, interval_ms)
                n = 0
                if rule.kind == "record":
                    if self.publisher is not None:
                        n = self.publisher.publish(
                            rule.uid, rule.group, eval_ts,
                            self._derived_rows(rule, series))
                elif self.alert_manager is not None:
                    self.alert_manager.observe(
                        rule, eval_ts, self._alert_instances(rule, series))
            registry.counter(FILODB_RULES_EVALUATIONS,
                             {"group": rule.group,
                              "rule": rule.name}).increment()
            self.status[rule.uid] = {
                "health": "ok", "last_error": None,
                "last_eval_ms": int(eval_ts),
                "last_duration_ms": (time.perf_counter_ns() - t0) / 1e6}
            return n
        except Exception as e:
            registry.counter(FILODB_RULES_EVAL_FAILURES,
                             {"group": rule.group,
                              "rule": rule.name}).increment()
            self.status[rule.uid] = {
                "health": "err", "last_error": f"{type(e).__name__}: {e}",
                "last_eval_ms": int(eval_ts),
                "last_duration_ms": (time.perf_counter_ns() - t0) / 1e6}
            raise

    def evaluate_group(self, group: RuleGroupSpec, eval_ts: int) -> int:
        """One group tick: every rule, sequentially, at one timestamp.
        A failing rule is logged+counted and the REST of the group still
        evaluates (Prometheus semantics); the tick is only considered
        incomplete — watermark held — when every rule failed."""
        rows = 0
        failures = 0
        for rule in group.rules:
            try:
                rows += self.evaluate_rule(rule, eval_ts,
                                           interval_ms=group.interval_ms)
            except Exception:  # noqa: BLE001 — counted per rule above; one
                # bad rule must not starve the rest of its group
                failures += 1
                log.warning("rule %s evaluation failed at %d",
                            rule.uid, eval_ts, exc_info=True)
        if failures == len(group.rules):
            raise RuntimeError(
                f"every rule of group {group.name!r} failed at {eval_ts}")
        return rows
