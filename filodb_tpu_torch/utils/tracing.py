"""Tracing: in-process spans with a per-thread context stack.

Host copy of the span recorder of ``filodb_tpu/utils/tracing.py``, limited
to what the port's query path opens: ``with span(SPAN_QUERY_EXECUTE, ...)``
records one span into a bounded ring, parented under the innermost open span
of the thread. Durations come from the monotonic clock; the wall clock is
read once per span for its start timestamp. Cross-node propagation and the
Zipkin exporter come with the port's cluster slice.
"""

from __future__ import annotations

import contextlib
import os
import random
import threading
import time
from collections import deque
from dataclasses import dataclass, field

from .metrics import FILODB_TRACE_SPANS, registry

SPAN_QUERY = "query"
SPAN_QUERY_PARSE = "query.parse"
SPAN_QUERY_PLAN = "query.plan"
SPAN_QUERY_EXECUTE = "query.execute"
SPAN_QUERY_LEAF = "query.exec.leaf"
SPAN_QUERY_REDUCE = "query.exec.reduce"


@dataclass
class SpanRecord:
    trace_id: str
    span_id: str
    parent_id: str | None
    name: str
    start_us: int
    duration_us: int
    tags: dict = field(default_factory=dict)


class Tracer:
    """Process-global span recorder; ``current_context`` names the
    innermost open span of the calling thread."""

    def __init__(self, capacity: int = 4096):
        self.spans: deque[SpanRecord] = deque(maxlen=capacity)
        self._local = threading.local()
        self._lock = threading.Lock()
        self.enabled = True
        self._span_counter = registry.counter(FILODB_TRACE_SPANS)

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _new_id(self) -> str:
        rng = getattr(self._local, "rng", None)
        if rng is None:
            rng = self._local.rng = random.Random(
                int.from_bytes(os.urandom(16), "little"))
        return f"{rng.getrandbits(64):016x}"

    def current_context(self) -> dict | None:
        st = self._stack()
        if not st:
            return None
        trace_id, span_id = st[-1]
        return {"trace_id": trace_id, "span_id": span_id, "sampled": True}

    @contextlib.contextmanager
    def span(self, name: str, **tags):
        """Record one span; yields the tags dict so callers can attach
        outcome tags discovered mid-span."""
        stack = self._stack()
        if stack:
            trace_id, parent_id = stack[-1]
        elif not self.enabled:
            yield tags
            return
        else:
            trace_id, parent_id = self._new_id(), None
        span_id = self._new_id()
        stack.append((trace_id, span_id))
        t0_wall_us = int(time.time() * 1e6)
        t0 = time.perf_counter_ns()
        try:
            yield tags
        finally:
            stack.pop()
            dur_us = (time.perf_counter_ns() - t0) // 1000
            rec = SpanRecord(trace_id, span_id, parent_id, name, t0_wall_us,
                             int(dur_us), tags)
            with self._lock:
                self.spans.append(rec)
            self._span_counter.increment()

    def snapshot(self) -> list[SpanRecord]:
        with self._lock:
            return list(self.spans)


tracer = Tracer()


def span(name: str, **tags):
    """``with span(SPAN_QUERY_EXECUTE, dataset=...):`` on the global tracer."""
    return tracer.span(name, **tags)
