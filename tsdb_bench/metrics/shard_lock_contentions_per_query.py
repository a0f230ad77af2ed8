"""shard_lock_contentions_per_query: how often a query found a shard's lock
held, the program's ``TimedRLock.contentions`` (utils/diagnostics.py) on
every shard, differenced across the window, a query."""


def read(run):
    n = run.n_requests
    c = run.counters.get("shard_lock_contentions")
    return c / n if n and c is not None else None
