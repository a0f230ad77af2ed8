"""Alerting: per-series ``for``-duration state machines + webhook notifier.

Reference: Prometheus alerting rules — an alert instance (one label set of
the rule expression's output) walks inactive -> pending -> firing, with the
``for`` duration gating pending -> firing. State is keyed on the instance's
label set, persisted through :class:`..rules.state.RuleStateStore` on every
transition, and RESTORED on construction: a restarted node resumes pending
timers (active_at survives) instead of resetting them.

Timekeeping: all transitions are driven by the scheduler's EVAL timestamps
(the deterministic grid), never by wall-clock reads here — replaying the
same evaluations reproduces the same state machine.

Port of ``filodb_tpu/rules/alerts.py`` (host Python; the persisted timers are
the reference's JSON).
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time

from ..utils.metrics import (FILODB_RULES_ALERT_TRANSITIONS,
                             FILODB_RULES_ALERTS_FIRING,
                             FILODB_RULES_NOTIFICATIONS, registry)
from .spec import RuleSpec

log = logging.getLogger("filodb_tpu_torch.rules")

INACTIVE, PENDING, FIRING = "inactive", "pending", "firing"


def _series_key(labels: dict) -> str:
    """Canonical instance identity: sorted label pairs, JSON-encoded (the
    persisted dict's key — must survive a JSON round trip unchanged)."""
    return json.dumps(sorted(labels.items()), separators=(",", ":"))


class AlertManager:
    """State machines for every alerting rule, fed by the evaluator."""

    def __init__(self, rules: list[RuleSpec], state_store=None,
                 notifier=None):
        self.rules = {r.uid: r for r in rules if r.kind == "alert"}
        self.state_store = state_store
        self.notifier = notifier
        self._lock = threading.Lock()
        # rule uid -> series key -> {state, active_at, value, labels}
        self._states: dict[str, dict[str, dict]] = {
            uid: {} for uid in self.rules}
        if state_store is not None:
            persisted = state_store.alert_states()
            for uid in self.rules:
                for key, st in (persisted.get(uid) or {}).items():
                    if st.get("state") in (PENDING, FIRING):
                        self._states[uid][key] = dict(st)

    def _count_transition(self, rule: str, to: str) -> None:
        registry.counter(FILODB_RULES_ALERT_TRANSITIONS,
                         {"rule": rule, "to": to}).increment()

    def observe(self, rule: RuleSpec, eval_ts: int,
                active: list[tuple[dict, float]]) -> list[dict]:
        """Apply one evaluation's output (the label-set/value pairs the
        alert expression matched at ``eval_ts``) to the rule's state
        machines; returns notification events (firing/resolved)."""
        events: list[dict] = []
        with self._lock:
            states = self._states[rule.uid]
            seen: set[str] = set()
            for labels, value in active:
                key = _series_key(labels)
                seen.add(key)
                st = states.get(key)
                if st is None:
                    st = states[key] = {"state": PENDING,
                                        "active_at": int(eval_ts),
                                        "value": float(value),
                                        "labels": dict(labels)}
                    self._count_transition(rule.uid, PENDING)
                st["value"] = float(value)
                if (st["state"] == PENDING
                        and eval_ts - st["active_at"] >= rule.for_ms):
                    st["state"] = FIRING
                    st["fired_at"] = int(eval_ts)
                    self._count_transition(rule.uid, FIRING)
                    events.append({"event": "firing", "rule": rule.uid,
                                   "labels": dict(st["labels"]),
                                   "value": st["value"],
                                   "active_at": st["active_at"],
                                   "at": int(eval_ts)})
            for key in list(states):
                if key not in seen:
                    st = states.pop(key)
                    self._count_transition(rule.uid, INACTIVE)
                    if st["state"] == FIRING:
                        events.append({"event": "resolved",
                                       "rule": rule.uid,
                                       "labels": dict(st["labels"]),
                                       "at": int(eval_ts)})
            registry.gauge(FILODB_RULES_ALERTS_FIRING,
                           {"rule": rule.uid}).update(float(sum(
                               1 for s in states.values()
                               if s["state"] == FIRING)))
            # two-level copy: the persist below runs OUTSIDE the lock, and
            # a concurrent observe() mutates the per-series dicts — a
            # shallow copy would hand json.dump live state mid-mutation
            snapshot = {uid: {k: dict(v) for k, v in sts.items()}
                        for uid, sts in self._states.items()}
        if self.state_store is not None:
            # outside the lock: the sink write must never serialize
            # evaluation against durable I/O
            self.state_store.set_alert_states(snapshot)
        if self.notifier is not None:
            for ev in events:
                self.notifier.enqueue(ev)
        return events

    def snapshot(self) -> dict[str, dict[str, dict]]:
        with self._lock:
            return {uid: {k: dict(v) for k, v in sts.items()}
                    for uid, sts in self._states.items()}

    def active_alerts(self) -> list[dict]:
        """The /api/v1/alerts payload: every pending/firing instance."""
        out = []
        for uid, sts in self.snapshot().items():
            rule = self.rules[uid]
            for st in sts.values():
                labels = dict(rule.labels)
                labels.update(st["labels"])
                labels["alertname"] = rule.name
                out.append({"labels": labels, "state": st["state"],
                            "activeAt": st["active_at"] / 1000.0,
                            "value": st.get("value")})
        return out


class WebhookNotifier:
    """Background webhook delivery with bounded retry/backoff. Events queue
    (bounded — a dead endpoint must not hold alert state in memory forever)
    and a daemon thread POSTs them as JSON; each event retries up to
    ``retries`` times with doubling backoff before being counted failed."""

    QUEUE_MAX = 1024

    def __init__(self, url: str, retries: int = 3, backoff_s: float = 1.0,
                 timeout_s: float = 5.0):
        self.url = url
        self.retries = max(1, int(retries))
        self.backoff_s = float(backoff_s)
        self.timeout_s = float(timeout_s)
        self._q: queue.Queue = queue.Queue(maxsize=self.QUEUE_MAX)
        self._stop_ev = threading.Event()
        self._sleep = time.sleep          # injectable: tests run sleep-free
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="rules-notifier")
        self._thread.start()

    def enqueue(self, event: dict) -> None:
        try:
            self._q.put_nowait(event)
        except queue.Full:
            # bounded loss, counted: a blackholed webhook must not grow an
            # unbounded backlog of stale alerts
            registry.counter(FILODB_RULES_NOTIFICATIONS,
                             {"status": "failed"}).increment()
            log.warning("notification queue full; dropped %s event for %s",
                        event.get("event"), event.get("rule"))

    def _post(self, event: dict) -> None:
        import urllib.request
        body = json.dumps(event).encode()
        req = urllib.request.Request(
            self.url, data=body, method="POST",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
            r.read()

    def _deliver(self, event: dict) -> None:
        for attempt in range(self.retries):
            try:
                self._post(event)
                registry.counter(FILODB_RULES_NOTIFICATIONS,
                                 {"status": "ok"}).increment()
                return
            except Exception:  # noqa: BLE001 — delivery faults retry, then
                # count as failed; a dead collector must never kill the loop
                if attempt + 1 >= self.retries:
                    break
                self._sleep(self.backoff_s * (2 ** attempt))
        registry.counter(FILODB_RULES_NOTIFICATIONS,
                         {"status": "failed"}).increment()
        log.warning("webhook delivery to %s failed after %d attempts",
                    self.url, self.retries)

    def _run(self) -> None:
        while not self._stop_ev.is_set():
            try:
                event = self._q.get(timeout=0.25)
            except queue.Empty:
                continue
            try:
                self._deliver(event)
            except Exception:  # noqa: BLE001 — ANY fault must not kill the
                # delivery loop for the process lifetime (filolint:
                # resource-worker-silent-death)
                log.exception("notification delivery loop fault")

    def drain(self, timeout_s: float = 5.0) -> None:
        """Test/shutdown barrier: wait for the queue to empty."""
        deadline = time.monotonic() + timeout_s
        while not self._q.empty() and time.monotonic() < deadline:
            time.sleep(0.01)

    def stop(self) -> None:
        self._stop_ev.set()
        self._thread.join(timeout=3)
