"""leaf_select_ms: host ms a query spends in its leaves' index selection
and capture under the shard lock, the program's ``query.exec.select``
spans (query/exec.py::SelectRawPartitionsExec.select: the index lookup,
the keys, the store's tensors) over the window, a query. Nothing when the
program records no such span or the tracer's ring lost one."""

SELECT = "query.exec.select"


def read(run):
    tr = run.device
    if tr is None or tr.spans_lost or not run.requests:
        return None
    sel = [sp.duration_us for sp in tr.spans if sp.name == SELECT]
    return sum(sel) / 1000.0 / len(run.requests) if sel else None
