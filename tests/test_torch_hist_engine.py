"""The histogram slice end to end: ingest -> flush -> histogram_quantile in
both packages.

The same seeded integer cumulative bucket counts are ingested into each
package's memstore, raw ("off") and compressed-resident ("all"); both
QueryEngines answer ``histogram_quantile(q, sum [by (host)] (fn(h[w])))``.
They must agree on the values (rtol 1e-5: the folds sum rows in different
orders), the series keys, the route (``exec_path``; the K2 route is
``fused-hist-narrow[...]``, whose bracket names the implementation —
"pallas" in the JAX package, "plain" for the port's CPU twin, "cuda" on the
card) and ``QueryStats``. The JAX package's fused-kernel mode stays at its
default.

Histogram queries off the fused pattern (other shapes, churned or off-grid
shards, several shards) take the general hist ExecPlan path in both
engines, with the same answers and route.
"""

import numpy as np
import pytest

from filodb_tpu.core.memstore import StoreConfig as JStoreConfig
from filodb_tpu.core.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.core.record import RecordBuilder as JRecordBuilder
from filodb_tpu.core.schemas import PROM_HISTOGRAM as JPROM_HISTOGRAM
from filodb_tpu.query.engine import QueryEngine as JQueryEngine
from filodb_tpu_torch.core.memstore import StoreConfig, TimeSeriesMemStore
from filodb_tpu_torch.core.record import RecordBuilder
from filodb_tpu_torch.core.schemas import PROM_HISTOGRAM
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.utils.metrics import (FILODB_QUERY_FUSED_FALLBACK,
                                            FILODB_QUERY_FUSED_SERVED,
                                            registry)

START = 1_000_000
IV = 10_000
N = 96
RANGE = (START + 300_000, START + 800_000, 30_000)
QUERIES = (
    "histogram_quantile(0.9, sum(rate(h[2m])))",
    "histogram_quantile(0.5, sum by (host) (increase(h[3m])))",
    "histogram_quantile(0.99, sum(delta(h[2m])))",
    "histogram_quantile(0.9, sum(sum_over_time(h[2m])))",
    "histogram_quantile(0.75, sum by (host) (last_over_time(h[2m])))",
    'histogram_quantile(0.9, sum(rate(h{host="h1"}[2m])))',
)


def les_of(B):
    return np.concatenate([2.0 ** np.arange(B - 1), [np.inf]])


def ingest(ms, builder, schema, B, n_series=12, layout="aligned"):
    """Integer cumulative counts, one container per series. ``churned``:
    a sixth of the series start 20 cells late; ``offgrid``: timestamps a
    few ms off the grid."""
    rng = np.random.default_rng(11)
    for s in range(n_series):
        late = 20 if layout == "churned" and s % 6 == 5 else 0
        c = np.cumsum(np.cumsum(rng.poisson(0.5, (N, B)), axis=0),
                      axis=1).astype(np.float64)
        b = builder(schema, bucket_les=les_of(B))
        for t in range(late, N):
            ts = START + t * IV + (int(rng.integers(1, 900))
                                   if layout == "offgrid" else 0)
            b.add({"_metric_": "h", "host": f"h{s % 4}", "inst": f"i{s}"},
                  ts, c[t])
        ms.ingest("prometheus", 0, b.build())


def engines_for(mode, B=8, layout="aligned"):
    jms = JMemStore()
    jsh = jms.setup("prometheus", JPROM_HISTOGRAM, 0, JStoreConfig(
        max_series_per_shard=16, samples_per_series=128,
        flush_batch_size=10**9, compressed_residency=mode))
    ingest(jms, JRecordBuilder, JPROM_HISTOGRAM, B, layout=layout)
    jsh.flush()
    tms = TimeSeriesMemStore(device="cpu")
    tsh = tms.setup("prometheus", PROM_HISTOGRAM, 0, StoreConfig(
        max_series_per_shard=16, samples_per_series=128,
        flush_batch_size=10**9, compressed_residency=mode, device="cpu"))
    ingest(tms, RecordBuilder, PROM_HISTOGRAM, B, layout=layout)
    tsh.flush()
    return (JQueryEngine(jms, "prometheus"),
            QueryEngine(tms, "prometheus", device="cpu"), tsh)


@pytest.fixture(scope="module", params=["off", "all"])
def engines(request):
    return engines_for(request.param) + (request.param,)


def route(exec_path):
    """The route without its implementation tag."""
    return exec_path.split("[")[0]


def assert_same_answer(got, ref, q):
    assert [k.labels for k in got.matrix.keys] == \
        [k.labels for k in ref.matrix.keys], q
    np.testing.assert_array_equal(got.matrix.out_ts, ref.matrix.out_ts)
    g = np.asarray(got.matrix.values, np.float64)
    r = np.asarray(ref.matrix.values, np.float64)
    assert g.shape == r.shape, q
    np.testing.assert_array_equal(np.isnan(g), np.isnan(r))
    assert np.isfinite(r).any(), q
    np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-9, equal_nan=True,
                               err_msg=q)
    assert route(got.exec_path) == route(ref.exec_path), \
        (q, got.exec_path, ref.exec_path)
    for f in ("fused_kernels", "series_matched", "blocks_raw",
              "blocks_narrow"):
        assert getattr(got.stats, f) == getattr(ref.stats, f), (q, f)


@pytest.mark.parametrize("q", QUERIES)
def test_query_matches_jax_engine(engines, q):
    jeng, teng, _, mode = engines
    ref = jeng.query_range(q, *RANGE)
    got = teng.query_range(q, *RANGE)
    assert_same_answer(got, ref, q)
    k2_shape = "h{" not in q and any(f"({fn}(" in q for fn in
                                     ("rate", "increase", "delta"))
    if mode == "all" and k2_shape:
        assert got.exec_path == "fused-hist-narrow[plain]"
        assert ref.exec_path == "fused-hist-narrow[pallas]"
        assert got.stats.fused_kernels == 1
    else:
        assert got.exec_path == "fused-hist"
        assert got.stats.fused_kernels == 0


def test_instant_query_matches_jax_engine(engines):
    jeng, teng, _, _ = engines
    q = "histogram_quantile(0.9, sum by (host) (rate(h[2m])))"
    ref = jeng.query_instant(q, START + 700_000)
    got = teng.query_instant(q, START + 700_000)
    assert got.result_type == ref.result_type == "vector"
    assert_same_answer(got, ref, q)


def test_wide_buckets_take_the_narrow_route_outside_k2():
    """B = 64 at Tp = 128 is past K2's Tp * B <= 4096 gate: the resident
    store answers through the narrow grid kernel, in both packages, and the
    fused tier counts a fallback."""
    jeng, teng, tsh = engines_for("all", B=64)
    assert tsh.store.is_narrow_resident
    fallback = registry.counter(FILODB_QUERY_FUSED_FALLBACK,
                                {"shape": "hist_quantile"})
    before = fallback.value
    for q in QUERIES[:3]:
        ref = jeng.query_range(q, *RANGE)
        got = teng.query_range(q, *RANGE)
        assert_same_answer(got, ref, q)
        assert got.exec_path == "fused-hist" and got.stats.fused_kernels == 0
    assert fallback.value == before + 3


def test_fused_route_streams_the_resident_block():
    """The K2 route never decodes the [S, C, B] block nor derives the
    timestamps, and counts as served by the plain twin on the CPU."""
    _, teng, tsh = engines_for("all")
    st = tsh.store
    calls = {"v": 0, "t": 0}
    orig_v, orig_t = st.value_block, st.ts_block
    st.value_block = lambda: calls.__setitem__("v", calls["v"] + 1) or orig_v()
    st.ts_block = lambda: calls.__setitem__("t", calls["t"] + 1) or orig_t()
    served = registry.counter(FILODB_QUERY_FUSED_SERVED,
                              {"shape": "hist_quantile", "mode": "plain"})
    before = served.value
    r = teng.query_range(QUERIES[0], *RANGE)
    assert r.exec_path == "fused-hist-narrow[plain]"
    assert r.matrix.num_series == 1 and r.stats.blocks_narrow == 1
    assert calls == {"v": 0, "t": 0}, calls
    assert served.value == before + 1
    assert st.is_narrow_resident          # queries never rehydrate


def test_empty_selection_answers_empty_without_a_decode():
    jeng, teng, tsh = engines_for("all")
    st = tsh.store
    calls = {"v": 0}
    orig_v = st.value_block
    st.value_block = lambda: calls.__setitem__("v", calls["v"] + 1) or orig_v()
    for q in ("histogram_quantile(0.9, sum(rate(nope[2m])))",
              "sum(rate(nope[2m]))", "nope"):
        got = teng.query_range(q, *RANGE)
        ref = jeng.query_range(q, *RANGE)
        assert got.matrix.num_series == ref.matrix.num_series == 0, q
        assert got.exec_path == ref.exec_path == "local", q
        assert got.stats.series_matched == 0
    assert calls == {"v": 0}, calls


@pytest.mark.parametrize("q", ("sum(rate(h[2m]))", "h", "rate(h[2m])",
                               "histogram_quantile(0.9, rate(h[2m]))",
                               "sum by (host) (increase(h[3m]))"))
def test_general_hist_path_matches_jax_engine(q):
    """Off the fused pattern both engines take the general hist ExecPlan
    path over the resident store, with the same answer."""
    jeng, teng, _ = engines_for("all")
    ref = jeng.query_range(q, *RANGE)
    got = teng.query_range(q, *RANGE)
    assert ref.matrix.num_series > 0
    assert_same_answer(got, ref, q)
    assert got.exec_path == "local"


@pytest.mark.parametrize("layout", ("churned", "offgrid"))
def test_churned_or_offgrid_hist_shards_match_jax_engine(layout):
    jeng, teng, tsh = engines_for("off", layout=layout)
    q = QUERIES[0]
    ref = jeng.query_range(q, *RANGE)
    got = teng.query_range(q, *RANGE)
    assert ref.exec_path == "local" and ref.matrix.num_series == 1
    assert_same_answer(got, ref, q)


def test_hist_dataset_over_several_shards_matches_jax_engine():
    jms = JMemStore()
    tms = TimeSeriesMemStore(device="cpu")
    for shard in (0, 1):
        jms.setup("prometheus", JPROM_HISTOGRAM, shard, JStoreConfig(
            max_series_per_shard=16, samples_per_series=128))
        tms.setup("prometheus", PROM_HISTOGRAM, shard, StoreConfig(
            max_series_per_shard=16, samples_per_series=128, device="cpu"))
    ingest(jms, JRecordBuilder, JPROM_HISTOGRAM, 8)
    ingest(tms, RecordBuilder, PROM_HISTOGRAM, 8)
    jeng = JQueryEngine(jms, "prometheus")
    teng = QueryEngine(tms, "prometheus", device="cpu")
    ref = jeng.query_range(QUERIES[0], *RANGE)
    got = teng.query_range(QUERIES[0], *RANGE)
    assert ref.exec_path == "local" and ref.matrix.num_series == 1
    assert_same_answer(got, ref, QUERIES[0])
