"""shard_lock_wait_ms_per_query: host ms a query waits for a shard lock
that another thread holds, the program's ``query.exec.lock_wait`` spans
(utils/diagnostics.py::TimedRLock.acquire, its contended branch) over the
window, a query. 0.0 where the program records its leaves' lock holds and
no query waited; nothing where it records no hold (a program without the
wait spans), or when the tracer's ring lost a span."""

LEAF = "query.exec.leaf"
WAIT = "query.exec.lock_wait"


def read(run):
    tr = run.device
    if tr is None or tr.spans_lost or not run.requests:
        return None
    if not any(sp.name == LEAF and "lock_held_us" in sp.tags
               for sp in tr.spans):
        return None
    wait = sum(sp.duration_us for sp in tr.spans if sp.name == WAIT)
    return wait / 1000.0 / len(run.requests)
