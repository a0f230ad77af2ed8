"""Histogram stores of the port against the JAX package's: ingest, flush and
compressed residency.

The same seeded cumulative bucket counts go through each package's
RecordBuilder(PROM_HISTOGRAM, bucket_les=...) -> TimeSeriesMemStore.ingest
-> flush, with ``compressed_residency`` "off" and "all". The stores must
hold the same n, extra scalar columns (sum, count), timestamps and decoded
bucket blocks — bit for bit: integer counts round-trip exactly through the
2D-delta form — and the same residency choices (i8 for quiet series, i16
for bursty ones, counter-reset rows in the cohort pool).

One place differs on purpose: rows of non-integer counts. The reference's
encoder checks the round trip on the unrounded f32 dd and then truncates it
into int16, so it marks such rows ok and stores them wrong; the port's
checks the dd as stored and pools them (test_mixed_rows_pool_and_the_
reference_defect).
"""

import numpy as np
import pytest
import torch

from filodb_tpu.core.memstore import StoreConfig as JStoreConfig
from filodb_tpu.core.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.core.record import RecordBuilder as JRecordBuilder
from filodb_tpu.core.schemas import PROM_HISTOGRAM as JPROM_HISTOGRAM
from filodb_tpu.query.engine import QueryEngine as JQueryEngine
from filodb_tpu_torch.core.chunkstore import DeferredDecodeHist, DeferredTs
from filodb_tpu_torch.core.memstore import StoreConfig, TimeSeriesMemStore
from filodb_tpu_torch.core.record import RecordBuilder
from filodb_tpu_torch.core.schemas import GAUGE, PROM_COUNTER, PROM_HISTOGRAM
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.utils.metrics import (FILODB_STORE_RESIDENCY_FALLBACK,
                                            registry)

START = 1_000_000
IV = 10_000
N = 96
B = 8
LES = np.concatenate([2.0 ** np.arange(B - 1), [np.inf]])


def series(kind: str):
    """[(labels, counts [N, B])]: ``quiet`` integer counts (i8 tier),
    ``bursty`` (i16 tier), ``mixed`` (rows 3 and 7 scaled by 0.3:
    non-integer), ``reset`` (8 series, rows 0 and 4 restart mid-stream: a
    quarter of the rows, at the cohort gate)."""
    rng = np.random.default_rng(7)
    out = []
    for s in range(8 if kind == "reset" else 10):
        lam = 200.0 if kind == "bursty" else 0.4
        c = np.cumsum(np.cumsum(rng.poisson(lam, (N, B)), axis=0),
                      axis=1).astype(np.float64)
        if kind == "bursty":
            c += np.cumsum((np.arange(N) % 2) * 300, dtype=np.int64)[:, None]
        if kind == "mixed" and s % 4 == 3:
            c = c * 0.3
        if kind == "reset" and s % 4 == 0:
            c[N // 2:] -= c[N // 2][None, :]
        out.append(({"_metric_": "h", "host": f"x{s}"}, c))
    return out


def build(pkg: str, mode: str, kind: str = "quiet"):
    """(memstore, shard) of one package, fed one container per series."""
    if pkg == "jax":
        ms = JMemStore()
        sh = ms.setup("prometheus", JPROM_HISTOGRAM, 0, JStoreConfig(
            max_series_per_shard=16, samples_per_series=128,
            flush_batch_size=10**9, compressed_residency=mode))
        builder, schema = JRecordBuilder, JPROM_HISTOGRAM
    else:
        ms = TimeSeriesMemStore(device="cpu")
        sh = ms.setup("prometheus", PROM_HISTOGRAM, 0, StoreConfig(
            max_series_per_shard=16, samples_per_series=128,
            flush_batch_size=10**9, compressed_residency=mode, device="cpu"))
        builder, schema = RecordBuilder, PROM_HISTOGRAM
    for labels, c in series(kind):
        b = builder(schema, bucket_les=LES)
        for t in range(N):
            b.add(labels, START + t * IV, c[t])
        ms.ingest("prometheus", 0, b.build())
    sh.flush()
    return ms, sh


def assert_same_store(t, j, values_exact: bool = True):
    """The port's store holds what the JAX store holds."""
    assert t.is_narrow_resident == j.is_narrow_resident
    np.testing.assert_array_equal(t.n.numpy(), np.asarray(j.n))
    np.testing.assert_array_equal(t.n_host, j.n_host)
    assert sorted(t.extra) == sorted(j.extra) == ["count", "sum"]
    for k in t.extra:
        np.testing.assert_array_equal(t.extra[k].numpy(),
                                      np.asarray(j.extra[k]))
    np.testing.assert_array_equal(t.ts_block().numpy(),
                                  np.asarray(j.ts_block()))
    if values_exact:
        np.testing.assert_array_equal(t.value_block().numpy(),
                                      np.asarray(j.value_block()))
    assert t.grid_info() == j.grid_info()


@pytest.mark.parametrize("kind", ("quiet", "bursty", "reset"))
@pytest.mark.parametrize("mode", ("off", "all"))
def test_store_matches_jax(mode, kind):
    _, jsh = build("jax", mode, kind)
    _, tsh = build("port", mode, kind)
    t, j = tsh.store, jsh.store
    assert t.nbuckets == j.nbuckets == B
    np.testing.assert_array_equal(tsh.bucket_les, jsh.bucket_les)
    assert_same_store(t, j)
    if mode == "off":
        assert not t.is_narrow_resident and t.val is not None
        np.testing.assert_array_equal(t.val.numpy(), np.asarray(j.val))
        return
    assert t.val is None and t.ts is None
    assert isinstance(t.column_array(), DeferredDecodeHist)
    dd, first_d, ok = t.hist_operands()
    jdd, jfirst_d, jok = j.hist_operands()
    assert dd.dtype == (torch.int16 if kind == "bursty" else torch.int8)
    assert str(jdd.dtype) == str(dd.dtype).replace("torch.", "")
    np.testing.assert_array_equal(dd.numpy(), np.asarray(jdd))
    np.testing.assert_array_equal(first_d.numpy(), np.asarray(jfirst_d))
    np.testing.assert_array_equal(ok, jok)
    if kind == "reset":
        # counter resets break the telescoped products: pooled, raw f32
        assert (~ok[:8:4]).all() and ok[1:8:4].all() and ok[2:8:4].all()


@pytest.mark.parametrize("mode", ("off", "all"))
def test_compact_and_free_rows_match_jax(mode):
    """Retention compaction shifts the [S, C, B] block and the extra
    columns with one set of indices; freeing rows resets them. Both
    rehydrate a resident store first; the next flush re-adopts."""
    _, jsh = build("jax", mode)
    _, tsh = build("port", mode)
    for sh in (jsh, tsh):
        with sh.lock:
            sh.store.compact(START + 30 * IV)
            sh.store.free_rows(np.array([2, 5], np.int32))
    assert not tsh.store.is_narrow_resident
    assert_same_store(tsh.store, jsh.store)
    np.testing.assert_array_equal(tsh.store.first_ts, jsh.store.first_ts)
    jsh.flush()
    tsh.flush()
    assert tsh.store.is_narrow_resident == (mode == "all")
    assert_same_store(tsh.store, jsh.store)


def test_retention_at_least_three_times_the_raw_store():
    _, raw = build("port", "off")
    _, res = build("port", "all")
    assert raw.store.resident_sample_bytes() \
        / res.store.resident_sample_bytes() >= 3.0
    _, jres = build("jax", "all")
    assert res.store.resident_sample_bytes() \
        == jres.store.resident_sample_bytes()


def test_append_rehydrates_and_the_next_flush_recompresses():
    jms, jsh = build("jax", "all")
    tms, tsh = build("port", "all")
    rng = np.random.default_rng(3)
    tail = np.cumsum(rng.poisson(0.4, (8, B)), axis=1).astype(np.float64) + 500
    for ms, builder, schema in ((jms, JRecordBuilder, JPROM_HISTOGRAM),
                                (tms, RecordBuilder, PROM_HISTOGRAM)):
        b = builder(schema, bucket_les=LES)
        for t in range(8):
            b.add({"_metric_": "h", "host": "x0"}, START + (N + t) * IV,
                  np.maximum.accumulate(tail[t]))
        ms.ingest("prometheus", 0, b.build())
    st = tsh.store
    with tsh.lock:
        tsh._flush_staged_locked()          # lands: the store rehydrates
    assert not st.is_narrow_resident and st.val is not None
    tsh.flush()                             # ... and the flush re-adopts
    jsh.flush()
    assert st.is_narrow_resident
    assert_same_store(st, jsh.store)


def test_two_phase_commit_skips_a_store_that_mutated_meanwhile():
    """The build runs outside the shard lock; an append between prepare and
    commit makes the prepared state stale, and it is dropped."""
    _, sh = build("port", "off")
    st = sh.store
    sh.config.compressed_residency = "all"
    prepare = st.compress_prepare

    def racing_prepare():
        prep = prepare()
        b = RecordBuilder(PROM_HISTOGRAM, bucket_les=LES)
        b.add({"_metric_": "h", "host": "x1"}, START + N * IV,
              np.full(B, 1e6))
        sh.ingest(b.build())
        with sh.lock:
            sh._flush_staged_locked()
        return prep

    st.compress_prepare = racing_prepare
    sh._compress_resident_two_phase()
    assert not st.is_narrow_resident
    del st.compress_prepare
    sh.flush()                              # the next attempt adopts
    assert st.is_narrow_resident


def test_mixed_rows_pool_and_the_reference_defect():
    """Rows 3 and 7 hold non-integer counts. The port's encoder rebuilds
    each row from the dd it stores, so those rows fail and keep raw f32 in
    the cohort pool: the decode equals the raw store's bit for bit, and the
    hist quantile matches the JAX engine on a raw ("off") store within the
    reference's own bar for pooled rows (allclose 1e-5). The JAX "all"
    store checks its round trip on the unrounded dd and truncates it into
    int16 (filodb_tpu/ops/narrow.py:113-124): it marks those rows ok and
    decodes them wrongly — the one place the port differs on purpose."""
    tms, tsh = build("port", "all", "mixed")
    tms_off, tsh_off = build("port", "off", "mixed")
    jms_off, jsh_off = build("jax", "off", "mixed")
    jms_all, jsh_all = build("jax", "all", "mixed")
    st = tsh.store
    assert st.is_narrow_resident
    _dd, _fd, ok = st.hist_operands()
    np.testing.assert_array_equal(np.nonzero(~ok[:10])[0], [3, 7])
    raw = np.asarray(jsh_off.store.val)[:10, :N]
    np.testing.assert_array_equal(st.value_block().numpy()[:10, :N], raw)
    np.testing.assert_array_equal(tsh_off.store.val.numpy()[:10, :N], raw)
    # the reference's resident store: rows 3 and 7 pass its check and are
    # stored truncated
    _jdd, _jfd, jok = jsh_all.store.hist_operands()
    assert jok[:10].all()
    jdec = np.asarray(jsh_all.store.value_block())[:10, :N]
    err = np.abs(jdec - raw).max(axis=(1, 2))
    assert err[[3, 7]].min() > 1.0 and err[[0, 1, 2, 4, 5, 6, 8, 9]].max() == 0
    jeng = JQueryEngine(jms_off, "prometheus")
    teng = QueryEngine(tms, "prometheus", device="cpu")
    start, end, step = START + 300_000, START + 800_000, 30_000
    for q in ("histogram_quantile(0.9, sum(rate(h[2m])))",
              "histogram_quantile(0.5, sum by (host) (increase(h[3m])))",
              "histogram_quantile(0.9, sum(delta(h[2m])))"):
        ref = jeng.query_range(q, start, end, step)
        got = teng.query_range(q, start, end, step)
        assert got.exec_path == "fused-hist-narrow[plain]"
        assert [k.labels for k in got.matrix.keys] == \
            [k.labels for k in ref.matrix.keys]
        np.testing.assert_allclose(np.asarray(got.matrix.values),
                                   np.asarray(ref.matrix.values),
                                   rtol=1e-5, atol=1e-6, equal_nan=True)


def test_gather_rows_match_the_full_materialization():
    _, sh = build("port", "all", "mixed")
    st = sh.store
    rid = torch.tensor([0, 3, 7, 9])
    rows = st.column_array().gather_rows(rid).numpy()
    np.testing.assert_array_equal(rows, st.value_block().numpy()[rid.numpy()])
    trows = DeferredTs(st).gather_rows(rid).numpy()
    np.testing.assert_array_equal(trows, st.ts_block().numpy()[rid.numpy()])


def test_flush_of_a_resident_store_does_not_rebuild_it():
    """A flush with nothing staged on an already resident store keeps the
    compressed state it has: no second build, the same tensors."""
    _, sh = build("port", "all")
    st = sh.store
    held = st._nhist
    calls = []
    prepare = st.compress_prepare
    st.compress_prepare = lambda: calls.append(1) or prepare()
    sh.flush()
    assert calls == [] and st._nhist is held and st.val is None


def test_a_store_that_declines_says_why():
    """Continuous-float counts fail the contract on most rows: the store
    stays raw and the fallback counter names the reason."""
    ms = TimeSeriesMemStore(device="cpu")
    sh = ms.setup("prometheus", PROM_HISTOGRAM, 0, StoreConfig(
        max_series_per_shard=16, samples_per_series=128,
        flush_batch_size=10**9, compressed_residency="all", device="cpu"))
    ctr = registry.counter(FILODB_STORE_RESIDENCY_FALLBACK,
                           {"reason": "non-integer"})
    before = ctr.value
    rng = np.random.default_rng(9)
    for s in range(8):
        b = RecordBuilder(PROM_HISTOGRAM, bucket_les=LES)
        c = np.cumsum(np.cumsum(rng.exponential(1.0, (N, B)), axis=0), axis=1)
        for t in range(N):
            b.add({"_metric_": "h", "host": f"x{s}"}, START + t * IV, c[t])
        ms.ingest("prometheus", 0, b.build())
    sh.flush()
    assert not sh.store.is_narrow_resident
    assert sh.store.residency_decline == "non-integer"
    assert ctr.value == before + 1
    sh.flush()                  # nothing mutated: no second attempt
    assert ctr.value == before + 1


def test_scalar_residency_is_refused_at_construction():
    """No longer refused: scalar shards (GAUGE, PROM_COUNTER) under "all"
    build, flush and compress — counter data lands on delta8, like the JAX
    store over the same samples."""
    ms = TimeSeriesMemStore(device="cpu")
    jms = JMemStore()
    from filodb_tpu.core.schemas import PROM_COUNTER as JPROM_COUNTER
    rng = np.random.default_rng(12)
    counts = np.cumsum(rng.integers(0, 40, (4, N)), axis=1).astype(np.float64)
    for schema, jschema in ((GAUGE, None), (PROM_COUNTER, JPROM_COUNTER)):
        sh = ms.setup(f"d-{schema.name}", schema, 0, StoreConfig(
            max_series_per_shard=8, samples_per_series=128,
            flush_batch_size=10**9, compressed_residency="all", device="cpu"))
        for s in range(4):
            b = RecordBuilder(schema)
            for t in range(N):
                b.add({"_metric_": "c", "host": f"x{s}"}, START + t * IV,
                      float(counts[s, t]))
            sh.ingest(b.build())
        sh.flush()
        st = sh.store
        assert st.is_narrow_resident and st.val is None and st.ts is None
        kind, (dv, _anchor), ok = st.narrow_operands()
        assert kind == "delta8" and dv.dtype == torch.int8 and ok.all()
        np.testing.assert_array_equal(st.value_block().numpy()[:4, :N],
                                      counts.astype(np.float32))
        if jschema is not None:
            jsh = jms.setup("c", jschema, 0, JStoreConfig(
                max_series_per_shard=8, samples_per_series=128,
                flush_batch_size=10**9, compressed_residency="all"))
            for s in range(4):
                b = JRecordBuilder(jschema)
                for t in range(N):
                    b.add({"_metric_": "c", "host": f"x{s}"}, START + t * IV,
                          float(counts[s, t]))
                jsh.ingest(b.build())
            jsh.flush()
            jkind, (jdv, _ja), jok = jsh.store.narrow_operands()
            assert jkind == kind
            np.testing.assert_array_equal(dv.numpy(), np.asarray(jdv))
            np.testing.assert_array_equal(ok, jok)


def test_store_config_matches_the_reference():
    """The port's residency modes are the reference's "off", "gauge" and
    "all" (the reference's ``narrow_resident=True`` is "gauge", which the
    port spells only one way); any other raises in both."""
    for mode in ("off", "gauge", "all"):
        assert StoreConfig(compressed_residency=mode).compressed_residency \
            == JStoreConfig(compressed_residency=mode).residency_mode()
    assert StoreConfig().compressed_residency \
        == JStoreConfig().residency_mode()
    assert JStoreConfig(narrow_resident=True).residency_mode() == "gauge"
    with pytest.raises(ValueError):
        StoreConfig(compressed_residency="everything")
    with pytest.raises(ValueError):
        JStoreConfig(compressed_residency="everything")


def test_histogram_store_is_created_by_the_first_container():
    ms = TimeSeriesMemStore(device="cpu")
    sh = ms.setup("prometheus", PROM_HISTOGRAM, 0, StoreConfig(
        max_series_per_shard=8, samples_per_series=16, device="cpu"))
    assert sh.store is None and sh.bucket_les is None
    eng = QueryEngine(ms, "prometheus", device="cpu")
    r = eng.query_range("histogram_quantile(0.9, sum(rate(h[2m])))",
                        START, START + 60_000, 30_000)
    assert r.matrix.num_series == 0
    b = RecordBuilder(PROM_HISTOGRAM, bucket_les=LES)
    b.add({"_metric_": "h", "host": "x"}, START, {"sum": 2.5, "count": 3.0,
                                                  "h": np.arange(B)})
    sh.ingest(b.build())
    assert sh.store.nbuckets == B and sh.store.val.shape == (8, 16, B)
    np.testing.assert_array_equal(sh.bucket_les, LES)
    sh.flush()
    assert sh.store.extra["sum"][0, 0].item() == 2.5
    assert sh.store.extra["count"][0, 0].item() == 3.0
