"""Rule-group scheduler: grid-aligned ticks, staggered starts, bounded
concurrency, crash-resumable watermarks.

Scheduling contract (what makes exactly-once possible):

  * eval timestamps are ALIGNED to the group's interval grid
    (``floor(now / interval) * interval``) — deterministic, so the
    (rule, eval_ts) pub-ids a re-evaluation derives are identical.
  * groups START staggered (group i delays ``i/N`` of its interval past
    the grid tick) so N groups don't all storm the query engine at the
    same instant — but the eval timestamp stays the grid tick, not the
    staggered wall instant.
  * at most ``rules.max_concurrent`` group evaluations run at once,
    enforced by an AdmissionController (cost 1 per group); a group that
    cannot be admitted waits, visible as lag.
  * the group's durable WATERMARK advances only after the whole tick
    evaluated and published; a restart resumes at the watermark and
    re-evaluates up to ``rules.max_catchup`` missed ticks (newest last),
    deduped by the broker's pub-id journal.

Port of ``filodb_tpu/rules/scheduler.py``. A group's thread runs its rules'
queries, which launch K1 on the card; ``stop()`` joins every group thread
before it returns (the reference gives up after 3 s), so no launch outlives
the server's shutdown. ``start(ready)`` holds every group until ``ready()``
(the server's own shards have recovered; the reference starts at once).
"""

from __future__ import annotations

import logging
import threading
import time

from ..query.scheduler import AdmissionController, AdmissionRejected
from ..utils.metrics import (FILODB_RULES_EVAL_LAG_MS,
                             FILODB_RULES_EVAL_LATENCY_MS, registry)
from .spec import RuleGroupSpec

log = logging.getLogger("filodb_tpu_torch.rules")


class RuleGroupScheduler:
    def __init__(self, groups: list[RuleGroupSpec], evaluator, state,
                 max_concurrent: int = 2, max_catchup: int = 2,
                 clock_ms=None):
        self.groups = list(groups)
        self.evaluator = evaluator
        self.state = state
        self.max_catchup = max(1, int(max_catchup))
        # the admission gate, cost 1 per group evaluation: its own
        # controller (scope-tagged so the gauge never collides with a
        # query engine's), because rule evals must contend with each
        # other here and with queries only via the engine's own gate
        self.admission = AdmissionController(float(max(1, max_concurrent)),
                                             tags={"scope": "rules"})
        self._clock_ms = clock_ms or (lambda: int(time.time() * 1000))
        self._stop_ev = threading.Event()
        self._threads: list[threading.Thread] = []
        self._ready = None

    # -- one tick (also the test/bench entry) ---------------------------------

    def run_group_once(self, group: RuleGroupSpec, eval_ts: int,
                       advance_watermark: bool = True) -> bool:
        """Evaluate one group tick under the admission gate; returns True
        when the tick completed (watermark advanced)."""
        while True:
            try:
                got = self.admission.acquire(1.0)
                break
            except AdmissionRejected:
                # concurrency bound reached: wait (lag, not loss)
                if self._stop_ev.wait(0.05):
                    return False
        t0 = time.perf_counter_ns()
        try:
            self.evaluator.evaluate_group(group, int(eval_ts))
        except Exception:  # noqa: BLE001 — per-rule failures already
            # counted; a fully-failed tick holds the watermark so the next
            # pass re-evaluates it (idempotent via pub-ids)
            log.warning("group %s tick %d failed; watermark held",
                        group.name, eval_ts, exc_info=True)
            return False
        finally:
            self.admission.release(got)
            registry.histogram(FILODB_RULES_EVAL_LATENCY_MS,
                               {"group": group.name}).record(
                (time.perf_counter_ns() - t0) / 1e6)
        if advance_watermark:
            self.state.set_watermark(group.name, int(eval_ts))
        registry.gauge(FILODB_RULES_EVAL_LAG_MS,
                       {"group": group.name}).update(
            float(max(self._clock_ms() - int(eval_ts), 0)))
        return True

    def pending_ticks(self, group: RuleGroupSpec, now_ms: int) -> list[int]:
        """Grid ticks due for ``group`` at ``now_ms``: everything past the
        watermark up to the current grid point, capped at ``max_catchup``
        (newest kept — the freshest data matters most after a stall)."""
        iv = group.interval_ms
        due = (now_ms // iv) * iv
        wm = self.state.watermark(group.name)
        if wm < 0:
            return [due]          # fresh start: no historical backfill
        missed = (due - wm) // iv
        if missed <= 0:
            return []
        return [wm + k * iv for k in range(1, missed + 1)][-self.max_catchup:]

    # -- the per-group loop ---------------------------------------------------

    def _stagger_ms(self, idx: int, interval_ms: int) -> int:
        return (idx * interval_ms) // max(len(self.groups), 1)

    def _loop(self, idx: int, group: RuleGroupSpec) -> None:
        iv = group.interval_ms
        stagger = self._stagger_ms(idx, iv)
        # no tick before ``ready()``: a tick over a shard still recovering
        # would publish a derived sample from part of its data, and its
        # pub-id would then dedupe the whole one
        while self._ready is not None and not self._ready():
            if self._stop_ev.wait(0.05):
                return
        while not self._stop_ev.is_set():
            try:
                now = self._clock_ms()
                ticks = self.pending_ticks(group, now)
                # run only once the group's staggered instant has passed,
                # so N groups spread over the interval instead of storming
                # the engine together at the grid tick
                if ticks and now >= ticks[0] + stagger:
                    prefetch = getattr(self.evaluator, "prefetch", None)
                    if len(ticks) > 1 and prefetch is not None:
                        # catch-up span: one range query per rule buffers
                        # every pending step (rules-as-subscribers) — the
                        # per-tick loop below then consumes buffered steps,
                        # keeping the per-tick watermark/pub-id discipline
                        prefetch(group, ticks)
                    failed = False
                    for ts in ticks:
                        if self._stop_ev.is_set():
                            return
                        if not self.run_group_once(group, ts):
                            # watermark held: later ticks must NOT advance
                            # past the failed one, or its derived samples
                            # are silently gapped forever
                            failed = True
                            break
                    if failed:
                        # back off before the retry pass — a persistently
                        # failing group must not hot-loop a core
                        if self._stop_ev.wait(min(iv / 1000.0, 1.0)):
                            return
                    continue
                nxt = (ticks[0] + stagger) if ticks \
                    else ((now // iv) * iv + iv + stagger)
                wait_s = max((nxt - now) / 1000.0, 0.02)
                if self._stop_ev.wait(min(wait_s, 0.5)):
                    return
            except Exception:  # noqa: BLE001 — ANY fault must not kill the
                # group's loop for the server lifetime (filolint:
                # resource-worker-silent-death); the tick retries next pass
                log.exception("rule group %s scheduler fault", group.name)
                if self._stop_ev.wait(1.0):
                    return

    def start(self, ready=None) -> "RuleGroupScheduler":
        """Start a loop a group; ``ready``, if given, is polled until it
        first returns True before a loop evaluates anything."""
        self._ready = ready
        for idx, group in enumerate(self.groups):
            t = threading.Thread(target=self._loop, args=(idx, group),
                                 daemon=True, name=f"rules-{group.name}")
            self._threads.append(t)
            t.start()
        return self

    def stop(self) -> None:
        """Stop every group loop and join it. A loop checks the stop flag
        between ticks and while it waits for admission; a tick in flight
        ends within its queries' timeout."""
        self._stop_ev.set()
        for t in self._threads:
            t.join()
        self._threads.clear()
