"""On-demand paging in the port against the JAX package: a query that
reaches behind a shard's resident rows merges its cold chunks from the
durable sink, one batch when narrow, ``ODP_BATCH``-sized pid batches when
wide; ``raw_series`` pages the same way; the mesh hands such a selection to
the host path and counts a ``paging`` fallback.

Both packages ingest the same seeded integer data into a sink-backed shard,
persist it, and compact the store so the early samples live only in the
sink (``store.compact``), mirroring ``tests/test_server.py``'s
``test_on_demand_paging`` / ``test_wide_on_demand_paging_batches`` and
``tests/test_retention.py``'s ``test_paged_read_dedups_duplicate_sink_frames``.

Tolerance: bit for bit — the same answers (f64 paged selections through
the general path in both packages), the same ``rows_paged_in`` and route.
"""

import numpy as np
import pytest

import filodb_tpu.query.exec as jexec
from filodb_tpu.core import filters as JF
from filodb_tpu.core.memstore import StoreConfig as JStoreConfig
from filodb_tpu.core.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.core.record import RecordBuilder as JRecordBuilder
from filodb_tpu.core.schemas import GAUGE as JGAUGE
from filodb_tpu.core.store import FileColumnStore as JFileColumnStore
from filodb_tpu.ops import fusedresident as jfusedresident
from filodb_tpu.query.engine import QueryEngine as JQueryEngine
import filodb_tpu_torch.query.exec as texec
from filodb_tpu_torch.core import filters as TF
from filodb_tpu_torch.core.memstore import StoreConfig, TimeSeriesMemStore
from filodb_tpu_torch.core.record import RecordBuilder
from filodb_tpu_torch.core.schemas import GAUGE
from filodb_tpu_torch.core.store import FileColumnStore
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.utils.metrics import (FILODB_QUERY_MESH_FALLBACK,
                                            FILODB_RETENTION_ODP_ROWS,
                                            registry)
from filodb_tpu_torch.utils.tracing import (SPAN_ODP_DURABLE, SPAN_QUERY_ODP,
                                            tracer)

BASE = 1_700_000_000_000
IV = 10_000
DS = "prometheus"


@pytest.fixture(autouse=True)
def jax_xla_mode():
    old = jfusedresident.mode()
    jfusedresident.set_mode("xla")
    try:
        yield
    finally:
        jfusedresident.set_mode(old)


def series_values(i, n):
    return np.cumsum(np.random.default_rng(40 + i).integers(0, 9, n)) \
        .astype(np.float64)


def build(tmp_path, n_series, residency="off", shards=1, cut=20):
    """(jax memstore, port memstore): ``n_series`` series of 30 samples
    each, persisted, then compacted so samples before cell ``cut`` are
    sink-only."""
    out = []
    for tag, MS, Cfg, RB, G, Sink, kw in (
            ("j", JMemStore, JStoreConfig, JRecordBuilder, JGAUGE,
             JFileColumnStore, {}),
            ("t", TimeSeriesMemStore, StoreConfig, RecordBuilder, GAUGE,
             FileColumnStore, {"device": "cpu"})):
        ms = MS(**kw)
        for sh_num in range(shards):
            cfg = Cfg(max_series_per_shard=max(n_series, 8),
                      samples_per_series=32, flush_batch_size=10**9,
                      groups_per_shard=2, retention_ms=200_000,
                      dtype="float64" if residency == "off" else "float32",
                      compressed_residency=residency, **kw)
            sh = ms.setup(DS, G, sh_num, cfg,
                          sink=Sink(str(tmp_path / tag / f"s{sh_num}")))
            b = RB(G)
            for i in range(n_series):
                b.add_batch({"_metric_": "m", "host": f"h{i}",
                             "dc": f"dc{i % 3}", "sh": str(sh_num)},
                            BASE + IV * np.arange(30, dtype=np.int64),
                            series_values(i + 100 * sh_num, 30))
            sh.ingest(b.build(), offset=0)
            sh.flush_all_groups()
            with sh.lock:
                sh.store.compact(BASE + cut * IV)
            sh.flush()      # re-adopts compressed residency
        out.append(ms)
    return out


def engines(jms, tms, **kw):
    return JQueryEngine(jms, DS), QueryEngine(tms, DS, device="cpu", **kw)


def assert_same(jr, tr, what):
    assert tr.exec_path.split("[")[0] == jr.exec_path.split("[")[0], what
    assert tr.stats.rows_paged_in == jr.stats.rows_paged_in, what
    assert tr.stats.series_matched == jr.stats.series_matched, what
    j, t = jr.matrix.to_host(), tr.matrix.to_host()
    assert [k.labels for k in t.keys] == [k.labels for k in j.keys], what
    np.testing.assert_array_equal(t.out_ts, j.out_ts, err_msg=what)
    np.testing.assert_array_equal(
        np.asarray(t.values, np.float64)[:len(t.keys)],
        np.asarray(j.values, np.float64)[:len(j.keys)], err_msg=what)


NARROW_QUERIES = (
    'sum_over_time(m{host="h0"}[1m])',
    "sum(rate(m[1m]))",
    "max by (dc) (max_over_time(m[2m]))",
    "m",
)


@pytest.mark.parametrize("residency", ["off", "gauge"])
def test_narrow_paging_matches_the_reference(residency, tmp_path):
    jms, tms = build(tmp_path, 6, residency)
    tsh = tms.shard(DS, 0)
    if residency == "gauge":
        assert tsh.store.is_narrow_resident   # pages through gather_rows
    t_mem, _ = tsh.store.series_snapshot(0)
    assert len(t_mem) == 10
    jeng, teng = engines(jms, tms)
    tracer.spans.clear()
    rows0 = registry.counter(FILODB_RETENTION_ODP_ROWS,
                             {"dataset": DS, "tier": "local"}).value
    for q in NARROW_QUERIES:
        rng_ = (BASE + 60_000, BASE + 290_000, 30_000)
        jr, tr = jeng.query_range(q, *rng_), teng.query_range(q, *rng_)
        assert tr.stats.rows_paged_in > 0, q
        assert_same(jr, tr, q)
    names = [s.name for s in tracer.spans]
    assert SPAN_QUERY_ODP in names and SPAN_ODP_DURABLE in names
    assert registry.counter(FILODB_RETENTION_ODP_ROWS,
                            {"dataset": DS, "tier": "local"}).value > rows0
    # a range inside the resident rows does not page
    jr = jeng.query_range("sum(rate(m[1m]))", BASE + 270_000,
                          BASE + 290_000, 10_000)
    tr = teng.query_range("sum(rate(m[1m]))", BASE + 270_000,
                          BASE + 290_000, 10_000)
    assert tr.stats.rows_paged_in == 0
    assert_same(jr, tr, "resident")


def test_paged_rows_equal_the_reference_reads(tmp_path):
    jms, tms = build(tmp_path, 5)
    jsh, tsh = jms.shard(DS, 0), tms.shard(DS, 0)
    pids = np.arange(5, dtype=np.int32)
    assert tsh.needs_paging(pids, BASE) and jsh.needs_paging(pids, BASE)
    assert not tsh.needs_paging(pids, BASE + 25 * IV)
    got = tsh.read_with_paging(pids, BASE, BASE + 290_000)
    want = jsh.read_with_paging(pids, BASE, BASE + 290_000)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert (got[2] == 30).all()


WIDE_QUERIES = (
    ("sum(count_over_time(m[1m]))", (BASE + 60_000, BASE + 290_000, 30_000)),
    ("sum by (dc) (rate(m[1m]))", (BASE + 60_000, BASE + 290_000, 30_000)),
    ("last_over_time(m[1m])", (BASE + 60_000, BASE + 90_000, 30_000)),
    ("topk(3, sum_over_time(m[1m]))", (BASE + 60_000, BASE + 90_000, 30_000)),
    ("quantile(0.5, max_over_time(m[1m]))",
     (BASE + 60_000, BASE + 120_000, 30_000)),
    ("sort(sum_over_time(m[1m]))", (BASE + 60_000, BASE + 90_000, 30_000)),
)


def test_wide_paging_batches_match_the_reference(tmp_path, monkeypatch):
    """Selections wider than ODP_BATCH (lowered to 64) page in batches whose
    partials or matrices merge: the same answers and rows_paged_in."""
    monkeypatch.setattr(jexec, "ODP_BATCH", 64)
    monkeypatch.setattr(texec, "ODP_BATCH", 64)
    jms, tms = build(tmp_path, 200)
    jeng, teng = engines(jms, tms)
    for q, rng_ in WIDE_QUERIES:
        jr, tr = jeng.query_range(q, *rng_), teng.query_range(q, *rng_)
        assert tr.stats.rows_paged_in == 200, q
        assert_same(jr, tr, q)
    r = teng.query_range("sum(count_over_time(m[1m]))",
                         BASE + 60_000, BASE + 290_000, 30_000)
    np.testing.assert_allclose(np.asarray(r.matrix.values), 7.0 * 200)


def test_paged_read_dedups_duplicate_sink_frames(tmp_path):
    """A duplicated chunk frame (a requeued flush) must not double-count on
    the paged read, in either package."""
    jms, tms = build(tmp_path, 4)
    jeng, teng = engines(jms, tms)
    q, rng_ = "sum(sum_over_time(m[1m]))", (BASE + 60_000, BASE + 290_000,
                                            30_000)
    before = teng.query_range(q, *rng_)
    for ms in (jms, tms):
        sh = ms.shard(DS, 0)
        for g, recs in list(sh.sink.read_chunksets(DS, 0)):
            sh.sink.write_chunkset(DS, 0, g, recs)
    jr, tr = jeng.query_range(q, *rng_), teng.query_range(q, *rng_)
    assert tr.stats.rows_paged_in > 0
    assert_same(jr, tr, "dups")
    np.testing.assert_array_equal(np.asarray(tr.matrix.values),
                                  np.asarray(before.matrix.values))


def test_raw_series_pages_cold_data(tmp_path):
    jms, tms = build(tmp_path, 3)
    jeng, teng = engines(jms, tms)
    for filters_j, filters_t in (
            ([JF.Equals("_metric_", "m")], [TF.Equals("_metric_", "m")]),
            ([JF.Equals("host", "h1")], [TF.Equals("host", "h1")])):
        want = list(jeng.raw_series(filters_j, BASE, BASE + 290_000))
        got = list(teng.raw_series(filters_t, BASE, BASE + 290_000))
        assert len(got) == len(want) > 0
        for (gl, gt, gv), (wl, wt, wv) in zip(got, want):
            assert gl == wl
            np.testing.assert_array_equal(gt, wt)
            np.testing.assert_array_equal(gv, wv)
            assert len(gt) == 30          # 20 cold + 10 resident samples


def test_mesh_hands_paged_selections_to_the_host_path(tmp_path):
    """The mesh counts a ``paging`` fallback and the host path pages; its
    answer is the JAX host path's."""
    jms, tms = build(tmp_path, 4, shards=2)
    jeng = JQueryEngine(jms, DS)
    teng = QueryEngine(tms, DS, device="cpu", mesh=["cpu", "cpu"])
    c = registry.counter(FILODB_QUERY_MESH_FALLBACK, {"reason": "paging"})
    before = c.value
    q, rng_ = "sum(rate(m[1m]))", (BASE + 60_000, BASE + 290_000, 30_000)
    jr, tr = jeng.query_range(q, *rng_), teng.query_range(q, *rng_)
    assert c.value == before + 1
    assert tr.exec_path == "local"
    assert_same(jr, tr, "mesh paging")
    # a resident range stays on the mesh
    tr = teng.query_range(q, BASE + 270_000, BASE + 290_000, 10_000)
    assert tr.exec_path.startswith("mesh-")
