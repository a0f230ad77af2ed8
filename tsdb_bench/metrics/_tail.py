"""The 95th percentile of the latency of every request sent in the traced
window, send to answer on the host, a failed one missing any limit."""

from tsdb_bench.stats import percentile


def read(run):
    if not run.requests:
        return None
    v = percentile([r.latency_ms for r in run.requests], 95)
    return v if v != float("inf") else None
