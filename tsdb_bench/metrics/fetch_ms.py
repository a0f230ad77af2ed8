"""fetch_ms: host ms a query waits in the program's blocking
device-to-host copies, where the host waits for every kernel queued ahead
on the card: its ``query.exec.fetch`` spans (K1's partials in
ops/fusedgrid.py, the ``histogram_quantile`` route's answer in
query/engine.py, order-statistic candidates, quantile sketches and the
result matrix in query/exec.py) over the window, a query. Nothing when the
program records no such span or the tracer's ring lost one."""

FETCH = "query.exec.fetch"


def read(run):
    tr = run.device
    if tr is None or tr.spans_lost or not run.requests:
        return None
    f = [sp.duration_us for sp in tr.spans if sp.name == FETCH]
    return sum(f) / 1000.0 / len(run.requests) if f else None
