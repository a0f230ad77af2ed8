"""segfold_ms_per_query: device ms of the group fold's ``segfold<...>``
kernels (ops/aggregators.py::partial_aggregate -> ops/segfold.py,
ops/csrc/segfold.cu) over the window, a query. Not a roofline: the fold
is bound by its chain of dependent adds, not its bytes."""


def read(run):
    tr = run.device
    if tr is None or not run.requests:
        return None
    ns = sum(e - s for (_n, s, e), fam in zip(tr.kernels, tr.families)
             if fam == "segfold")
    return ns / 1e6 / len(run.requests) if ns else None
