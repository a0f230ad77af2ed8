"""shard_lock_held_share: the share of the traced window in which the
busiest shard's lock was held by a query's leaf, the ``lock_held_us`` tags
of the program's ``query.exec.leaf`` spans (query/exec.py and the
``histogram_quantile`` route of query/engine.py: the outer hold only),
summed by shard, the largest sum over the window's seconds. Near 100 % the
lock sets the pace; over 100 % only if the spans are wrong. Nothing when
no leaf span carries the tag or the tracer's ring lost a span."""

LEAF = "query.exec.leaf"


def read(run):
    tr = run.device
    if tr is None or tr.spans_lost or not tr.window_s:
        return None
    held: dict = {}
    for sp in tr.spans:
        if sp.name == LEAF and "lock_held_us" in sp.tags:
            shard = sp.tags.get("shard")
            held[shard] = held.get(shard, 0) + int(sp.tags["lock_held_us"])
    if not held:
        return None
    return 100.0 * max(held.values()) / 1e6 / tr.window_s
