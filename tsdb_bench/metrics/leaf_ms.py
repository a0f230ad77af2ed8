"""leaf_ms: host ms a query spends in leaf selection under the shard lock,
the durations of the program's ``query.exec.leaf`` spans
(query/exec.py::SelectRawPartitionsExec, core/partkey_index.py) over the
window, a query. Nothing when the tracer's ring lost a span."""

LEAF = "query.exec.leaf"


def read(run):
    tr = run.device
    if tr is None or tr.spans_lost or not run.requests:
        return None
    leaf = [sp.duration_us for sp in tr.spans if sp.name == LEAF]
    return sum(leaf) / 1000.0 / len(run.requests) if leaf else None
