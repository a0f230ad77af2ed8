"""Metrics registry: counters and histograms, one process-global registry.

Host copy of the parts of ``filodb_tpu/utils/metrics.py`` the port's main
path records: the query latency histogram and the fused-tier served/fallback
counters. Metric names are the reference's, so dashboards read both.
"""

from __future__ import annotations

import threading
from bisect import bisect_right

FILODB_QUERY_LATENCY_MS = "filodb_query_latency_ms"
FILODB_QUERY_FUSED_SERVED = "filodb_query_fused_served"
FILODB_QUERY_FUSED_FALLBACK = "filodb_query_fused_fallback"
FILODB_TRACE_SPANS = "filodb_trace_spans"


class Counter:
    def __init__(self):
        self._v = 0.0
        self._lock = threading.Lock()

    def increment(self, by: float = 1.0):
        with self._lock:
            self._v += by

    @property
    def value(self) -> float:
        return self._v


class Histogram:
    """Fixed-boundary histogram (ms-scale latencies by default); keeps the
    last observation's trace id as its exemplar."""

    DEFAULT_BOUNDS = (1, 2, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000,
                      10000)

    def __init__(self, bounds=DEFAULT_BOUNDS):
        self.bounds = list(bounds)
        self.buckets = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0
        self.last_trace_id: str | None = None
        self._lock = threading.Lock()

    def record(self, v: float, trace_id: str | None = None):
        with self._lock:
            self.buckets[bisect_right(self.bounds, v)] += 1
            self.sum += v
            self.count += 1
            if trace_id:
                self.last_trace_id = trace_id


class MetricsRegistry:
    def __init__(self):
        self._metrics: dict[tuple, object] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, tags: dict | None):
        key = (name, tuple(sorted((tags or {}).items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls()
            return m

    def counter(self, name: str, tags: dict | None = None) -> Counter:
        return self._get(Counter, name, tags)

    def histogram(self, name: str, tags: dict | None = None) -> Histogram:
        return self._get(Histogram, name, tags)


registry = MetricsRegistry()
