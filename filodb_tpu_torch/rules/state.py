"""Durable rule state: group watermarks + alert timers on the chunk sink.

The rules subsystem keeps two pieces of state that must survive a restart
or a shard takeover:

  * per-group evaluation WATERMARKS — the last eval timestamp whose derived
    writes were fully published. A restarted scheduler resumes at the
    watermark and RE-evaluates the possibly-in-flight tick; the re-publish
    carries the same deterministic (rule, eval_ts) pub-ids, so the broker's
    id journal dedupes it — exactly-once end to end.
  * per-alert ``for``-duration TIMERS — a pending alert's active_at must
    survive a node restart, or every restart silently resets the clock and
    a flapping node never pages.

Both persist in the sink's meta store (the same durable ring the
downsampler's publish floors live in: ``read_meta``/``write_meta`` on the
FileColumnStore / ReplicatedColumnStore), under the reserved dataset name
``{dataset}:rules`` shard 0. A deployment without a sink degrades to
in-memory state — documented, and the scheduler then starts from "now".

Port of ``filodb_tpu/rules/state.py``: the meta document is the reference's
JSON, so either package resumes from the other's sink.
"""

from __future__ import annotations

import logging
import threading

log = logging.getLogger("filodb_tpu_torch.rules")


class RuleStateStore:
    """Read-modify-write guard over the one meta document the rules
    subsystem persists. All mutations funnel through this lock so the
    scheduler's watermark bumps and the alert manager's timer snapshots
    never clobber each other's keys."""

    SHARD = 0

    def __init__(self, sink, dataset: str):
        self.sink = sink if (sink is not None and hasattr(sink, "read_meta")
                             and hasattr(sink, "write_meta")) else None
        self.meta_dataset = f"{dataset}:rules"
        self._lock = threading.Lock()
        self._mem: dict = {}            # sink-less fallback (tests, dev)
        if self.sink is not None:
            try:
                self._mem = dict(self.sink.read_meta(self.meta_dataset,
                                                     self.SHARD) or {})
            except Exception:  # noqa: BLE001 — unreadable state must not
                # keep the server down; the scheduler starts fresh and the
                # fault is visible in the log
                log.exception("rule state restore failed; starting fresh")
                self._mem = {}

    def _flush_locked(self) -> None:
        if self.sink is None:
            return
        try:
            self.sink.write_meta(self.meta_dataset, self.SHARD,
                                 dict(self._mem))
        except Exception:  # noqa: BLE001 — persistence is best-effort per
            # write; the next transition retries, and losing a watermark
            # only widens the idempotent replay window
            log.warning("rule state persist failed", exc_info=True)

    # -- group watermarks -----------------------------------------------------

    def watermark(self, group: str) -> int:
        with self._lock:
            return int((self._mem.get("wm") or {}).get(group, -1))

    def set_watermark(self, group: str, eval_ts: int) -> None:
        with self._lock:
            self._mem.setdefault("wm", {})[group] = int(eval_ts)
            self._flush_locked()

    # -- alert timers ---------------------------------------------------------

    def alert_states(self) -> dict:
        with self._lock:
            return dict(self._mem.get("alerts") or {})

    def set_alert_states(self, states: dict) -> None:
        with self._lock:
            self._mem["alerts"] = states
            self._flush_locked()
