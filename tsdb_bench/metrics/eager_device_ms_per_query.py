"""eager_device_ms_per_query: device ms of every kernel the port does not
write by hand (the eager PyTorch passes of ops/rangefns.py,
ops/windows.py, ops/gridfns.py, ops/aggregators.py and the pool
corrections) over the window, a query. Copies and fills are not kernels
and are left out."""

NOT_KERNELS = ("Memcpy", "Memset")


def read(run):
    tr = run.device
    if tr is None or not run.requests:
        return None
    ns = sum(e - s for (n, s, e), fam in zip(tr.kernels, tr.families)
             if fam is None and not n.startswith(NOT_KERNELS))
    return ns / 1e6 / len(run.requests) if ns else None
