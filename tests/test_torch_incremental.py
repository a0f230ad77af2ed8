"""Incremental serving in both packages: per-step validity over the shards'
epoch logs, the fragment cache, the engine's delta evaluation of a shifted
range, and the streaming increments built on it.

The pure functions and the cache class run on the same inputs in each
package and must give the same answers and stats. The engines run on the
same seeded integer counters (tests/test_torch_result_cache.py's ``Pair``:
one f32 GAUGE shard per package, the K1 twin on the CPU): every route,
``QueryStats`` counter, fragment-cache stat and value must agree. Values
bit for bit: against the JAX engine, and the port's extension against the
port's own cache-free engine (the reference's extension is bit-identical
by construction; the port's plain twin keeps that on the CPU).
"""

import numpy as np
import pytest

from filodb_tpu.core.memstore import EPOCH_AFFECTS_ALL as J_AFFECTS_ALL
from filodb_tpu.promql import parser as jpromql
from filodb_tpu.query import incremental as jinc
from filodb_tpu_torch.core.memstore import EPOCH_AFFECTS_ALL
from filodb_tpu_torch.promql import parser as tpromql
from filodb_tpu_torch.query import incremental as tinc
from filodb_tpu_torch.query.engine import QueryEngine
from tests.test_torch_result_cache import (START, Pair, assert_same_state,
                                           assert_same_step, assert_values,
                                           fresh_dataset, jax_xla_mode)

__all__ = ["jax_xla_mode"]      # the autouse fixture, re-exported

IV = 10_000
STEP = 30_000
Q = "sum by (dc) (rate(m[2m]))"
S1, E1 = START + 300_000, START + 500_000


def make_pair(n_series: int = 4, cells: int = 60) -> Pair:
    p = Pair(fresh_dataset("inc"), max_series=32, capacity=512)
    for i in range(n_series):
        p.ingest(i, 0, cells)
    p.flush()
    return p


def rendered(res):
    """Per-series output with NaN points dropped, values at full f64
    precision (what a presenter serializes)."""
    return sorted(
        (k.labels, ts.tolist(), np.asarray(v, np.float64).tolist())
        for k, ts, v in res.matrix.to_host().iter_series())


def both(jeng, teng, q, start, end, step=STEP, what=""):
    """One range query on both engines: same route, counters, values,
    fragment-cache stats; returns the port's result."""
    jr = jeng.query_range(q, start, end, step)
    tr = teng.query_range(q, start, end, step)
    assert_same_step(jr, tr, what or q)
    return tr


# ---------------------------------------------------------------- validity

STABLE_CASES = [
    # (recorded, current, logs, expected)
    ((("local", 0, 3), ("local", 1, 5)),) * 2 + ({}, "forever"),
    ((("local", 0, 3), ("local", 1, 5)), (("local", 0, 4), ("local", 1, 5)),
     {("local", "0"): [(3, 500), (4, 700)]}, 700),
    ((("local", 0, 3), ("local", 1, 5)), (("local", 0, 4), ("local", 1, 6)),
     {("local", "0"): [(4, 700)], ("local", "1"): [(6, 650)]}, 650),
    ((("local", 0, 3), ("local", 1, 5)), (("local", 0, 5), ("local", 1, 5)),
     {("local", "0"): [(5, 700)]}, None),                       # a log gap
    ((("local", 0, 3), ("local", 1, 5)), (("local", 0, 4), ("local", 1, 5)),
     {("local", "0"): [(4, "ALL")]}, None),                   # destructive
    ((("local", 0, 3), ("local", 1, 5)), (("local", 0, 2), ("local", 1, 5)),
     {("local", "0"): [(3, 500)]}, None),                        # backward
    ((("local", 0, 3), ("local", 1, 5)), (("local", 0, 3),),
     {}, None),                                           # topology change
]


@pytest.mark.parametrize("case", range(len(STABLE_CASES)))
def test_stable_before_matches_the_reference(case):
    rec, cur, logs, want = STABLE_CASES[case]

    def logs_for(sentinel):
        return {k: [(e, sentinel if m == "ALL" else m) for e, m in v]
                for k, v in logs.items()}

    got = tinc.stable_before(rec, cur, logs_for(EPOCH_AFFECTS_ALL))
    ref = jinc.stable_before(rec, cur, logs_for(J_AFFECTS_ALL))
    assert got == ref
    assert got == (tinc.STABLE_FOREVER if want == "forever" else want)
    assert EPOCH_AFFECTS_ALL == J_AFFECTS_ALL


@pytest.mark.parametrize("q,cacheable", [
    ("sum(rate(m[2m]))", True), (f"sum(m @ {START // 1000})", False),
    ("sort(sum by (dc) (m))", False), ("sort_desc(m)", False),
    ("max_over_time(sum(rate(m[2m]))[5m:1m])", True),
    (f"rate(m[2m] @ {START // 1000}) / 2", False),
    ("sum(m) / count(m)", True)])
def test_plan_cacheable_matches_the_reference(q, cacheable):
    args = (START, START + 10 * IV, IV)
    got = tinc.plan_cacheable(tpromql.query_to_logical_plan(q, *args))
    ref = jinc.plan_cacheable(jpromql.query_to_logical_plan(q, *args))
    assert got == ref == cacheable


# ---------------------------------------------------------------- cache unit

def _vec(e=1):
    return (("local", 0, e),)


def _hit_tuple(h):
    if h is None:
        return None
    return (h.keep_ts.tolist(), h.keep_vals.tolist(), list(h.keys),
            list(h.warnings), list(h.missing), h.reused_steps)


def _cache_ops(mod, affects_all):
    """The reference test's probe/extension sequence against one
    FragmentCache class; returns every probe outcome, the stats and the
    per-entry byte accounting along the way."""
    fc = mod.FragmentCache(capacity=4, tags={"dataset": fresh_dataset("fc")})
    key = ("q", 10, None, None)
    out = []
    ts = np.arange(100, 200, 10, dtype=np.int64)
    vals = np.arange(10, dtype=np.float64).reshape(1, 10)
    fc.store(key, ts, vals, [], ["w"], _vec(), 10)
    out.append(fc.entries_debug())
    for args in ((130, 240, 10, _vec(), {}),        # overlap + tail
                 (131, 240, 10, _vec(), {}),        # off-grid phase
                 (250, 300, 10, _vec(), {}),        # gap past the entry
                 (200, 200, 10, _vec(), {}),        # adjacent, no overlap
                 (50, 150, 10, _vec(), {}),         # head missing
                 (100, 190, 10, _vec(2),            # append bump at 160
                  {("local", "0"): [(2, 160)]}),
                 (100, 190, 10, _vec(2),            # destructive bump
                  {("local", "0"): [(2, affects_all)]})):
        out.append(_hit_tuple(fc.probe(key, *args)))
        out.append(fc.stats())
    # bounds: entries, bytes, the per-entry step trim, an oversized entry
    fc2 = mod.FragmentCache(capacity=2, max_bytes=4000, max_steps=8,
                            tags={"dataset": fresh_dataset("fc")})
    for k in range(3):
        fc2.store((f"q{k}", 10, None, None),
                  np.arange(0, 200, 10, dtype=np.int64), np.zeros((2, 20)),
                  [], [], _vec(), 10, extended=k == 2)
    out.append(fc2.stats())
    out.append(_hit_tuple(fc2.probe(("q2", 10, None, None), 0, 190, 10,
                                    _vec(), {})))
    fc2.store(("big", 10, None, None), np.arange(0, 10000, 10, np.int64),
              np.zeros((8, 1000)), [], [], _vec(), 10)
    out.append(fc2.stats())
    out.append(fc2.entries_debug())
    fc2.clear()
    out.append(fc2.stats())
    return out


def test_fragment_cache_matches_the_reference_class():
    got = _cache_ops(tinc, EPOCH_AFFECTS_ALL)
    ref = _cache_ops(jinc, J_AFFECTS_ALL)
    assert got == ref
    hit = got[1]
    assert hit[4] == [(200, 240)] and hit[5] == 7


# ---------------------------------------------------------------- engine

def test_extension_after_a_tail_ingest_is_bit_equal():
    pair = make_pair()
    jeng, teng = pair.engines(fragment_cache_size=16)
    r1 = both(jeng, teng, Q, S1, E1)
    assert r1.exec_path == "local"
    for i in range(4):
        pair.ingest(i, 60, 30)
    pair.flush()
    s2, e2 = S1 + 60_000, START + 800_000
    r2 = both(jeng, teng, Q, s2, e2)
    assert r2.exec_path.startswith("incremental["), r2.exec_path
    assert r2.stats.fragment_steps_reused > 0
    cold = QueryEngine(pair.tms, pair.ds, device="cpu")
    want = cold.query_range(Q, s2, e2, STEP)
    assert rendered(r2) == rendered(want)
    assert_values(r2, want, "extension vs cold")
    assert_same_state(pair, jeng, teng, "extension")
    st = teng.fragment_cache.stats()
    assert st["hits"] >= 1 and st["extensions"] == 1
    r3 = both(jeng, teng, Q, s2, e2)
    assert r3.exec_path == "fragment-cache[full]"
    assert rendered(r3) == rendered(r2)
    assert_same_state(pair, jeng, teng, "full serve")


def test_result_and_fragment_caches_together():
    """With both caches on, a repeat is a result-cache hit of the
    fragment serve, and a shifted range an incremental extension."""
    pair = make_pair()
    jeng, teng = pair.engines(fragment_cache_size=8, result_cache_size=8)
    seen = [both(jeng, teng, Q, S1 + k * STEP, E1 + k * STEP).exec_path
            for k in (0, 0, 2, 2)]
    assert seen == ["local", "result-cache[local]",
                    "incremental[reused=5,computed=2]",
                    "result-cache[incremental[reused=5,computed=2]]"]
    assert_same_state(pair, jeng, teng, "both caches")


def _race(side: int):
    """The reference test's race on one engine (``side`` 0: JAX, 1: the
    port) of a fresh pair: a flush lands after the epoch state was read
    and before the tail executes. Returns (the mid-race answer, the next
    answer, a cache-free answer over the final store), rendered, and the
    two routes."""
    pair = make_pair()
    eng = pair.engines(fragment_cache_size=16)[side]
    eng.query_range(Q, S1, E1, STEP)
    for i in range(4):
        pair.ingest(i, 60, 10)
    pair.flush()
    real = eng._exec_admitted
    fired = []

    def racing(plan, ctx, tenant):
        if not fired:
            fired.append(1)
            # a new series inside the steps the extension reuses
            pair.ingest(99, 30, 20)
            pair.flush()
        return real(plan, ctx, tenant)

    s2, e2 = S1 + 60_000, START + 750_000
    eng._exec_admitted = racing
    try:
        mid = eng.query_range(Q, s2, e2, STEP)
    finally:
        eng._exec_admitted = real
    assert fired
    after = eng.query_range(Q, s2, e2, STEP)
    want = QueryEngine(pair.tms, pair.ds, device="cpu").query_range(
        Q, s2, e2, STEP)
    return ([rendered(r) for r in (mid, after, want)],
            (mid.exec_path, after.exec_path))


def test_ingest_mid_extension_stays_provable():
    """The extension serves the pre-flush capture; the next query
    revalidates and equals a cache-free engine bit for bit; both packages
    take the same routes to the same answers."""
    (tmid, tafter, twant), troutes = _race(1)
    ref, jroutes = _race(0)
    assert troutes == jroutes
    assert troutes[0].startswith("incremental[")
    assert troutes[1] != "fragment-cache[full]"
    assert tafter == twant and tmid != twant
    assert [tmid, tafter] == ref[:2]


def test_destructive_release_invalidates_the_whole_entry():
    pair = make_pair()
    jeng, teng = pair.engines(fragment_cache_size=16)
    both(jeng, teng, "sum(rate(m[2m]))", S1, E1)
    for sh in pair.shards():
        with sh.lock:
            sh._release_partitions_locked(np.asarray([0], np.int32))
    r = both(jeng, teng, "sum(rate(m[2m]))", S1 + STEP, E1 + STEP)
    assert not r.exec_path.startswith("incremental")
    assert teng.fragment_cache.stats()["invalidations"] == 1
    assert_same_state(pair, jeng, teng, "release")
    want = QueryEngine(pair.tms, pair.ds, device="cpu").query_range(
        "sum(rate(m[2m]))", S1 + STEP, E1 + STEP, STEP)
    assert rendered(r) == rendered(want)


def test_at_and_sort_results_never_stored():
    pair = make_pair()
    jeng, teng = pair.engines(fragment_cache_size=16)
    both(jeng, teng, f"sum(m @ {(START + 400_000) // 1000})", S1, E1)
    both(jeng, teng, "sort(sum by (dc) (m))", S1, E1)
    assert len(teng.fragment_cache) == len(jeng.fragment_cache) == 0
    both(jeng, teng, "sum by (dc) (m)", S1, E1)
    assert len(teng.fragment_cache) == len(jeng.fragment_cache) == 1
    assert teng.fragment_cache.entries_debug() == \
        jeng.fragment_cache.entries_debug()


# ---------------------------------------------------------------- streaming

def test_poll_increment_matches_the_reference_and_a_posthoc_range():
    pair = make_pair(cells=30)
    jeng, teng = pair.engines(fragment_cache_size=16)
    assert tinc.data_lead_ms(teng) == jinc.data_lead_ms(jeng)
    since = (tinc.data_lead_ms(teng) // STEP) * STEP - STEP
    first = cursors = since
    pieces = []
    for burst in range(3):
        jres, jnext = jinc.poll_increment(jeng, Q, STEP, cursors)
        tres, tnext = tinc.poll_increment(teng, Q, STEP, cursors)
        assert tnext == jnext and tres is not None
        assert_same_step(jres, tres, f"increment {burst}")
        pieces.append(tres)
        cursors = tnext
        assert tinc.poll_increment(teng, Q, STEP, cursors) == (None, cursors)
        assert jinc.poll_increment(jeng, Q, STEP, cursors) == (None, cursors)
        for i in range(4):
            pair.ingest(i, 30 + 6 * burst, 6)
        pair.flush()
    whole = QueryEngine(pair.tms, pair.ds, device="cpu").query_range(
        Q, first + STEP, cursors, STEP)
    got = {}
    for p in pieces:
        for k, ts, v in p.matrix.to_host().iter_series():
            for t, x in zip(ts.tolist(), np.asarray(v).tolist()):
                got[(k.labels, t)] = x
    want = {(k.labels, t): x
            for k, ts, v in whole.matrix.to_host().iter_series()
            for t, x in zip(ts.tolist(), np.asarray(v).tolist())}
    assert got == want
    # a stale cursor is clamped to the newest POLL_MAX_STEPS steps
    jres, jnext = jinc.poll_increment(jeng, "sum(m)", STEP, 0)
    tres, tnext = tinc.poll_increment(teng, "sum(m)", STEP, 0)
    assert tnext == jnext
    assert len(tres.matrix.out_ts) == len(jres.matrix.out_ts)


def test_query_subscription_matches_the_reference():
    pair = make_pair(cells=60)
    jeng, teng = pair.engines(fragment_cache_size=16)
    q = "sum by (dc) (m)"
    t0 = (tinc.data_lead_ms(teng) // STEP) * STEP
    subs = (jinc.QuerySubscription(jeng, q, STEP, buffer_steps=8),
            tinc.QuerySubscription(teng, q, STEP, buffer_steps=8))

    def as_rows(got):
        return None if got is None else sorted(
            (k.labels, v) for k, v in got)

    assert as_rows(subs[1].take(t0)) == as_rows(subs[0].take(t0))
    want = teng.query_instant(q, t0)
    assert as_rows(subs[1].take(t0)) == sorted(
        (k.labels, float(np.asarray(v)[-1]))
        for k, _ts, v in want.matrix.to_host().iter_series())
    ticks = [t0 - 5 * STEP + k * STEP for k in range(5)]
    pre = (jinc.QuerySubscription(jeng, q, STEP),
           tinc.QuerySubscription(teng, q, STEP))
    for s in pre:
        s.prefetch(ticks[0], ticks[-1])
    for t in ticks:
        assert as_rows(pre[1].take(t)) == as_rows(pre[0].take(t))
        assert pre[1].take(t) is not None
    for k in range(12):
        for s in subs:
            s.take(t0 - (11 - k) * STEP)
    assert subs[1].take(t0 - 11 * STEP) is None
    assert subs[0].take(t0 - 11 * STEP) is None
