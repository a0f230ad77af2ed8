"""The query leaf's spans inside the port, on small CPU shards.

A leaf records ``query.exec.leaf`` (tagged with its shard lock's outer
hold, ``lock_held_us``), ``query.exec.select`` under it (the index lookup
and capture), ``query.exec.lock_wait`` when another thread holds the shard
lock, and ``query.exec.fetch`` where the host copies a tensor back and so
waits for the device's queue. The ``histogram_quantile`` route records the
same leaf as the general path. Span times lie on one clock: a start plus
its duration is its end, read on the same clock.
"""

import threading
import time

import numpy as np
import pytest

from filodb_tpu_torch.core.memstore import StoreConfig, TimeSeriesMemStore
from filodb_tpu_torch.core.record import RecordBuilder
from filodb_tpu_torch.core.schemas import GAUGE, PROM_HISTOGRAM
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.utils import diagnostics, tracing
from filodb_tpu_torch.utils.tracing import (SPAN_QUERY_FETCH, SPAN_QUERY_LEAF,
                                            SPAN_QUERY_LOCK_WAIT,
                                            SPAN_QUERY_SELECT, tracer)

START = 1_600_000_000_000
IV = 10_000
N = 60
SERIES = 16
RANGE = (START + 300_000, START + 590_000, 30_000)
SUM_RATE = "sum(rate(m[5m]))"
HQ = "histogram_quantile(0.9, sum(rate(h[5m])))"


def counter_engine():
    ms = TimeSeriesMemStore(device="cpu")
    sh = ms.setup("p", GAUGE, 0, StoreConfig(
        max_series_per_shard=32, samples_per_series=64,
        flush_batch_size=10**9, device="cpu"))
    rng = np.random.default_rng(3)
    vals = np.cumsum(rng.integers(1, 9, (SERIES, N)), axis=1)
    for t in range(N):
        b = RecordBuilder(GAUGE)
        for s in range(SERIES):
            b.add({"_metric_": "m", "host": f"h{s}"}, START + t * IV,
                  float(vals[s, t]))
        sh.ingest(b.build())
    sh.flush()
    return QueryEngine(ms, "p", device="cpu"), sh


def hist_engine():
    les = np.concatenate([2.0 ** np.arange(7), [np.inf]])
    ms = TimeSeriesMemStore(device="cpu")
    sh = ms.setup("p", PROM_HISTOGRAM, 0, StoreConfig(
        max_series_per_shard=16, samples_per_series=64,
        flush_batch_size=10**9, compressed_residency="all", device="cpu"))
    rng = np.random.default_rng(4)
    for s in range(8):
        c = np.cumsum(np.cumsum(rng.poisson(0.5, (N, 8)), axis=0),
                      axis=1).astype(np.float64)
        b = RecordBuilder(PROM_HISTOGRAM, bucket_les=les)
        for t in range(N):
            b.add({"_metric_": "h", "host": f"h{s}"}, START + t * IV, c[t])
        sh.ingest(b.build())
    sh.flush()
    return QueryEngine(ms, "p", device="cpu"), sh


@pytest.fixture(scope="module")
def counters():
    return counter_engine()


@pytest.fixture(scope="module")
def hists():
    return hist_engine()


@pytest.fixture
def traced():
    """The global tracer on, sampling every query, its ring emptied before
    and after."""
    saved = tracer.enabled, tracer.sample_rate
    tracer.enabled, tracer.sample_rate = True, 1.0
    tracer.drain()
    try:
        yield
    finally:
        tracer.drain()
        tracer.enabled, tracer.sample_rate = saved


def query_spans(engine, promql):
    """The answer and the spans of one query (one trace)."""
    tracer.drain()
    res = engine.query_range(promql, *RANGE)
    spans = tracer.drain()
    assert len({sp.trace_id for sp in spans}) == 1
    return res, spans


def named(spans, name):
    return [sp for sp in spans if sp.name == name]


def test_a_held_shard_lock_records_one_wait_under_the_leaf(counters, traced):
    engine, sh = counters
    engine.query_range(SUM_RATE, *RANGE)          # warm: nothing to build
    held, go = threading.Event(), threading.Event()

    def holder():
        with sh.lock:
            held.set()
            go.wait(5)
            time.sleep(0.05)

    before = sh.lock.contentions
    t = threading.Thread(target=holder, daemon=True)
    t.start()
    assert held.wait(5)
    tracer.drain()
    go.set()
    engine.query_range(SUM_RATE, *RANGE)
    t.join(5)
    assert not t.is_alive()
    spans = tracer.drain()
    waits = named(spans, SPAN_QUERY_LOCK_WAIT)
    assert len(waits) == 1
    (leaf,) = named(spans, SPAN_QUERY_LEAF)
    assert waits[0].parent_id == leaf.span_id
    assert waits[0].tags["lock"] == sh.lock.name
    assert waits[0].duration_us >= 40_000
    assert sh.lock.contentions - before == 1


def test_an_uncontended_query_records_no_wait(counters, traced):
    engine, sh = counters
    before = sh.lock.contentions
    _, spans = query_spans(engine, SUM_RATE)
    assert named(spans, SPAN_QUERY_LEAF)
    assert not named(spans, SPAN_QUERY_LOCK_WAIT)
    assert sh.lock.contentions == before


def test_a_lock_held_outside_any_trace_records_no_wait(traced):
    lk = diagnostics.TimedRLock("untraced")
    held, release = threading.Event(), threading.Event()

    def holder():
        with lk:
            held.set()
            release.wait(5)

    t = threading.Thread(target=holder, daemon=True)
    t.start()
    assert held.wait(5)
    threading.Timer(0.02, release.set).start()
    with lk:                              # no open frame on this thread
        pass
    t.join(5)
    assert not t.is_alive()
    assert lk.contentions == 1
    assert not named(tracer.drain(), SPAN_QUERY_LOCK_WAIT)


class _Clocks:
    """``time`` with every read counted."""

    def __init__(self):
        self.reads: dict = {}

    def __getattr__(self, name):
        fn = getattr(time, name)

        def counted(*a):
            self.reads[name] = self.reads.get(name, 0) + 1
            return fn(*a)
        return counted


def test_an_uncontended_acquire_gains_no_clock_read_and_no_span(
        traced, monkeypatch):
    lk = diagnostics.TimedRLock("quiet")
    clocks = _Clocks()
    with tracer.span(SPAN_QUERY_LEAF, shard=0):
        monkeypatch.setattr(diagnostics, "time", clocks)
        monkeypatch.setattr(tracing, "time", clocks)
        monkeypatch.setattr(tracer, "span", None)     # any span would raise
        with lk:
            with lk:                      # a re-entry alike
                pass
        monkeypatch.undo()
    # the hold's own start and end (long-hold check), as before the spans
    assert clocks.reads == {"monotonic": 2}
    assert [sp.name for sp in tracer.drain()] == [SPAN_QUERY_LEAF]
    assert lk.contentions == 0


def test_the_general_leaf_records_select_and_its_lock_hold(counters, traced):
    engine, _ = counters
    res, spans = query_spans(engine, 'sum(rate(m{host=~"h1.*"}[5m]))')
    (leaf,) = named(spans, SPAN_QUERY_LEAF)
    (sel,) = named(spans, SPAN_QUERY_SELECT)
    assert sel.parent_id == leaf.span_id
    assert sel.tags == {"shard": 0, "series": 7}       # h1, h10-h15
    held = leaf.tags["lock_held_us"]
    assert sel.duration_us <= held <= leaf.duration_us
    assert res.matrix.num_series == 1


def test_a_sum_rate_through_k1s_partials_records_a_fetch(counters, traced):
    engine, _ = counters
    res, spans = query_spans(engine, SUM_RATE)
    assert res.stats.fused_kernels >= 1
    sites = [sp.tags["site"] for sp in named(spans, SPAN_QUERY_FETCH)]
    assert "k1_partials" in sites


def test_an_eager_query_records_the_result_fetch(counters, traced):
    engine, _ = counters
    _, spans = query_spans(engine, "max(max_over_time(m[5m]))")
    assert "result" in [sp.tags["site"]
                        for sp in named(spans, SPAN_QUERY_FETCH)]


def test_order_statistics_record_their_candidate_fetch(counters, traced):
    engine, _ = counters
    res, spans = query_spans(engine, "topk(3, rate(m[5m]))")
    assert res.matrix.num_series >= 3
    assert "order_stats" in [sp.tags["site"]
                             for sp in named(spans, SPAN_QUERY_FETCH)]


def test_histogram_quantile_records_leaf_select_and_fetch(hists, traced):
    engine, _ = hists
    res, spans = query_spans(engine, HQ)
    assert res.exec_path.startswith("fused-hist")
    (leaf,) = named(spans, SPAN_QUERY_LEAF)
    (sel,) = named(spans, SPAN_QUERY_SELECT)
    (fetch,) = named(spans, SPAN_QUERY_FETCH)
    assert sel.parent_id == leaf.span_id
    assert sel.tags == {"shard": 0, "series": 8}
    assert leaf.tags["shard"] == 0
    assert 0 <= leaf.tags["lock_held_us"] <= leaf.duration_us
    assert fetch.tags == {"site": "fused_hist"}
    # the copy follows the lock's release, outside the leaf
    assert fetch.start_us >= leaf.start_us + leaf.duration_us
    assert np.isfinite(np.asarray(res.matrix.values)).any()


def test_a_spans_start_plus_duration_is_its_end_on_one_clock(traced):
    with tracer.span(SPAN_QUERY_LEAF, shard=0):
        time.sleep(0.01)
    end = tracing.now_us()
    (sp,) = tracer.drain()
    assert sp.duration_us >= 10_000
    assert abs(sp.start_us + sp.duration_us - end) <= 1_000
    # and the clock is the wall clock's
    assert abs(tracing.now_us() - time.time_ns() // 1000) <= 50_000
