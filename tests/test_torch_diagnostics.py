"""The port's lock diagnostics and declared surfaces against the JAX
package's.

The same contention, long-hold and lock-order sequences run on both
packages' ``TimedRLock`` and must leave equal counters and raise equal
``DiagnosticsError``s; the hold watchdog flags a wedged holder while it
still holds; ``METRICS_SPEC`` and ``TRACE_SPEC`` are the reference's less
the names of its compiled-plan cache (which has no port); and a scrape of
a two-shard CPU node carries the reference's per-shard series, the two
lock gauges included.
"""

import re
import threading
import time
import urllib.request

import pytest

from filodb_tpu.query.engine import QueryEngine as JQueryEngine
from filodb_tpu.http.api import FiloHttpServer as JHttpServer
from filodb_tpu.utils import diagnostics as jdiag
from filodb_tpu.utils import metrics as jmetrics
from filodb_tpu.utils import tracing as jtracing
from filodb_tpu_torch.http.api import FiloHttpServer
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.utils import diagnostics, metrics, tracing
from tests import test_torch_http_api as http_parity

BOTH = (jdiag, diagnostics)


@pytest.fixture
def lock_debug():
    saved = [(d.lock_debug, d.enabled) for d in BOTH]
    for d in BOTH:
        d.enable_lock_debug(True)
        d.enable(True)
    try:
        yield
    finally:
        for d, (dbg, en) in zip(BOTH, saved):
            d.enable_lock_debug(dbg)
            d.enable(en)


def _contend(diag):
    """A holder thread keeps the lock; the caller fails two non-blocking
    acquires and one timed one, then takes it after the release."""
    lk = diag.TimedRLock("contend", order_class="shard")
    held, release = threading.Event(), threading.Event()

    def holder():
        with lk:
            held.set()
            release.wait(5)

    t = threading.Thread(target=holder, daemon=True)
    t.start()
    assert held.wait(5)
    got = [lk.acquire(blocking=False), lk.acquire(blocking=False),
           lk.acquire(timeout=0.02)]
    release.set()
    t.join(5)
    assert not t.is_alive()
    with lk:
        with lk:            # reentry counts nothing
            pass
    return got, lk.contentions, lk.long_holds


def test_contention_sequence_counts_alike():
    ref = _contend(jdiag)
    port = _contend(diagnostics)
    assert port == ref == ([False, False, False], 3, 0)


@pytest.mark.parametrize("debug", [False, True])
def test_long_hold_sequence_counts_alike(monkeypatch, debug):
    for d in BOTH:
        monkeypatch.setattr(d, "HOLD_WARN_S", 0.05)
    saved = [d.lock_debug for d in BOTH]
    try:
        out = []
        for d in BOTH:
            d.enable_lock_debug(debug)
            lk = d.TimedRLock("hold", order_class="sink")
            with lk:
                with lk:
                    time.sleep(0.12)
            with lk:        # a short hold adds nothing
                pass
            out.append((lk.contentions, lk.long_holds))
        assert out[0] == out[1] and out[1][1] == 1
    finally:
        for d, dbg in zip(BOTH, saved):
            d.enable_lock_debug(dbg)


def _violations(diag):
    shard0 = diag.TimedRLock("t-shard", order_class="shard", order_index=0)
    shard1 = diag.TimedRLock("t-shard-1", order_class="shard", order_index=1)
    sink = diag.TimedRLock("t-sink", order_class="sink")
    grp = diag.TimedRLock("t-grp", order_class="group_flush")
    with grp, sink, shard0, shard0, shard1:
        pass
    errors = []
    with shard0:
        with pytest.raises(diag.DiagnosticsError) as ei:
            sink.acquire()
        errors.append(str(ei.value))
    with shard1:
        with pytest.raises(diag.DiagnosticsError) as ei:
            shard0.acquire()
        errors.append(str(ei.value))
    with grp, sink, shard0:         # the failed acquires left nothing
        pass
    return errors, [lk.contentions for lk in (shard0, shard1, sink, grp)]


def test_order_violations_raise_alike(lock_debug):
    ref = _violations(jdiag)
    port = _violations(diagnostics)
    assert port == ref
    assert "lock-order violation" in port[0][0]


def test_assert_owned_raises_alike(lock_debug):
    for d in BOTH:
        lk = d.TimedRLock("owned", order_class="shard")
        with pytest.raises(d.DiagnosticsError, match="shard lock"):
            d.assert_owned(lk, "append")
        with lk:
            d.assert_owned(lk, "append")


def test_watchdog_flags_a_wedged_holder(monkeypatch, lock_debug):
    """The scan counts a long hold while the lock is still held: the
    release-time check never sees a holder whose release never comes."""
    monkeypatch.setattr(diagnostics, "HOLD_WARN_S", 0.2)
    lk = diagnostics.TimedRLock("wedge", order_class="shard")
    with lk:
        deadline = time.monotonic() + 5.0
        while lk.long_holds == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert lk.long_holds == 1        # flagged before the release
    assert lk.long_holds == 1            # and not counted twice at it


def test_hold_histogram_records_first_depth_releases(lock_debug):
    h = metrics.registry.histogram(metrics.FILODB_LOCK_HOLD_MS,
                                   {"class": "group_flush"})
    before = h.count
    lk = diagnostics.TimedRLock("hist", order_class="group_flush")
    with lk:
        with lk:
            pass
    assert h.count == before + 1


def test_counters_survive_many_threads(lock_debug):
    """More threads than cores hammer one lock with a short switch
    interval: every first-depth release lands in the hold histogram
    exactly once, contentions stay within the acquisitions, and the lock
    ends free."""
    import os
    import sys
    n_threads, rounds = 2 * (os.cpu_count() or 4), 200
    lk = diagnostics.TimedRLock("stress", order_class="sink")
    h = metrics.registry.histogram(metrics.FILODB_LOCK_HOLD_MS,
                                   {"class": "sink"})
    before = h.count
    errors = []

    def worker():
        try:
            for _ in range(rounds):
                with lk:
                    with lk:
                        pass
        except BaseException as exc:   # noqa: BLE001 — asserted below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    total = n_threads * rounds
    assert h.count - before == total
    assert 0 <= lk.contentions <= total
    assert lk._depth == 0 and lk.acquire(blocking=False)
    lk.release()


def test_hold_timing_is_off_without_lock_debug():
    was = diagnostics.lock_debug
    diagnostics.enable_lock_debug(False)
    try:
        lk = diagnostics.TimedRLock("quiet", order_class="shard")
        with lk:
            pass
        assert lk._hold_hist is None and not lk._registered
    finally:
        diagnostics.enable_lock_debug(was)


# -- declared surfaces --------------------------------------------------------

def test_not_ported_names_are_the_plan_caches():
    assert set(metrics.NOT_PORTED) == {
        jmetrics.FILODB_QUERY_COMPILE_CACHE_HITS,
        jmetrics.FILODB_QUERY_COMPILE_CACHE_MISSES,
        jmetrics.FILODB_QUERY_COMPILE_CACHE_EVICTIONS}
    assert tracing.NOT_PORTED == (jtracing.SPAN_QUERY_COMPILE,)


def test_metrics_spec_is_the_references_less_the_plan_cache():
    ref = {k: v for k, v in jmetrics.METRICS_SPEC.items()
           if k not in metrics.NOT_PORTED}
    assert {k: v[0] for k, v in metrics.METRICS_SPEC.items()} \
        == {k: v[0] for k, v in ref.items()}
    # the docs are the reference's, but for the two that name the
    # backend: the port's tags say cuda/plain and eager
    differ = {k for k in ref if metrics.METRICS_SPEC[k][1] != ref[k][1]}
    assert differ == {metrics.FILODB_QUERY_FUSED_SERVED,
                      metrics.FILODB_QUERY_MESH_SERVED}
    for name in ("FILODB_SHARD_LOCK_CONTENTIONS",
                 "FILODB_SHARD_LOCK_LONG_HOLDS", "FILODB_LOCK_HOLD_MS"):
        assert getattr(metrics, name) == getattr(jmetrics, name)


def test_trace_spec_is_the_references_less_the_plan_cache():
    ref = {k: v for k, v in jtracing.TRACE_SPEC.items()
           if k not in tracing.NOT_PORTED}
    assert tracing.TRACE_SPEC == ref
    consts = {v for k, v in vars(tracing).items() if k.startswith("SPAN_")}
    assert consts == set(tracing.TRACE_SPEC)


def test_markdown_tables_render_the_specs():
    m = metrics.metrics_markdown_table().splitlines()
    t = tracing.trace_markdown_table().splitlines()
    assert len(m) == len(metrics.METRICS_SPEC) + 2
    assert len(t) == len(tracing.TRACE_SPEC) + 2
    assert "`filodb_shard_lock_contentions`" in "\n".join(m)


# -- the scrape ---------------------------------------------------------------

SCRAPE_DS = "lockscrape"


def _scrape_names(srv):
    """Metric names of the scrape's lines tagged with this test's dataset
    (each package's registry is process-global, so other tests' series
    ride along untagged by it)."""
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics",
                                timeout=30) as r:
        text = r.read().decode()
    names = set()
    for line in text.splitlines():
        if f'dataset="{SCRAPE_DS}"' in line:
            names.add(re.match(r"[A-Za-z_:][A-Za-z0-9_:]*", line).group(0))
    return names, text


@pytest.fixture(scope="module")
def scraped(monkeypatch_module):
    monkeypatch_module.setattr(http_parity, "DS", SCRAPE_DS)
    tsrv = FiloHttpServer({SCRAPE_DS: QueryEngine(
        http_parity._build(False), SCRAPE_DS, device="cpu")}, port=0).start()
    jsrv = JHttpServer({SCRAPE_DS: JQueryEngine(
        http_parity._build(True), SCRAPE_DS)}, port=0).start()
    try:
        q = (f"/promql/{SCRAPE_DS}/api/v1/query_range?query="
             "sum(rate(m%5B1m%5D))&start=1500&end=1600&step=10")
        out = []
        for srv in (tsrv, jsrv):
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{q}",
                                   timeout=60).read()
            out.append(_scrape_names(srv))
        yield out
    finally:
        tsrv.stop()
        jsrv.stop()


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_scrape_name_set_equals_the_references(scraped):
    (port, _), (ref, _) = scraped
    ref = {n for n in ref if not n.startswith(
        tuple(metrics.NOT_PORTED))}
    assert port == ref
    assert {"filodb_shard_lock_contentions",
            "filodb_shard_lock_long_holds", "filodb_shard_num_series",
            "filodb_query_latency_ms_exemplar"} <= port


@pytest.mark.parametrize("shard", ["0", "1"])
def test_scrape_carries_both_lock_gauges_per_shard(scraped, shard):
    (_, text), _ = scraped
    for name in ("filodb_shard_lock_contentions",
                 "filodb_shard_lock_long_holds"):
        pat = rf'^{name}{{dataset="{SCRAPE_DS}",shard="{shard}"}} \d+$'
        assert re.search(pat, text, re.M), name
