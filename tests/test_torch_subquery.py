"""Subqueries, the ``@`` modifier, chunk metadata and ``__col__`` value
columns end to end in both packages.

The cases of tests/test_subquery.py (an f64 gauge store of three sine
series) run through the JAX QueryEngine and the port's
``QueryEngine(device="cpu")``: subqueries under every ``*_over_time``
outer function and nested, an aggregate over a subquery, a subquery over a
binary expression, ``@`` on a selector, a range and an aggregate, and a
join against live series. Then on f32 stores through real ingest and
flush (grid-aligned, churned, off-grid): a subquery whose inner is a fused
``sum(rate)`` (K1's plain twin serves it on the CPU, once a query), ``@``
and ``_filodb_chunkmeta_all``; and ``__col__`` on a gauge and a
prom-histogram dataset.

They must agree on the keys and their order, NaN placement, the values,
``exec_path`` and ``QueryStats`` (``subquery_inner_cells`` included).
Tolerances are the inner query's bar: rtol 1e-12 of the array's largest
magnitude on the f64 store (the general range functions in f64 in both),
1e-5 on the f32 stores (the fused folds sum rows in different orders);
counts, chunk metadata and selected samples bit for bit.
"""

import contextlib

import numpy as np
import pytest

import tests.test_torch_engine as te
from filodb_tpu.core.memstore import StoreConfig as JStoreConfig
from filodb_tpu.core.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.core.record import RecordBuilder as JRecordBuilder
from filodb_tpu.core.schemas import GAUGE as JGAUGE
from filodb_tpu.ops import fusedresident as jfusedresident
from filodb_tpu.query.engine import QueryEngine as JQueryEngine
from filodb_tpu_torch.core.memstore import StoreConfig, TimeSeriesMemStore
from filodb_tpu_torch.core.record import RecordBuilder
from filodb_tpu_torch.core.schemas import GAUGE
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.utils.metrics import FILODB_QUERY_FUSED_SERVED, registry
from tests.test_torch_hist_general import RANGE as HIST_RANGE
from tests.test_torch_hist_general import engines_for as hist_engines_for

START = 1_000_000
IV = 10_000
N = 120
RANGE = (START + 600_000, START + 900_000, 30_000)
AT_MS = START + 500_000


@contextlib.contextmanager
def jax_xla_mode():
    old = jfusedresident.mode()
    jfusedresident.set_mode("xla")
    try:
        yield
    finally:
        jfusedresident.set_mode(old)


def sine_store(mem_cls, cfg_cls, builder, schema, **dev):
    """tests/test_subquery.py's store: three f64 sine series."""
    ms = mem_cls(**dev)
    ms.setup("ds", schema, 0, cfg_cls(
        max_series_per_shard=16, samples_per_series=256,
        flush_batch_size=10**9, dtype="float64", **dev))
    b = builder(schema)
    for i in range(3):
        for t in range(N):
            b.add({"_metric_": "m", "host": f"h{i}"},
                  START + t * IV, 100.0 * (i + 1) + 10.0 * np.sin(t / 7 + i))
    ms.ingest("ds", 0, b.build())
    ms.flush_all()
    return ms


@pytest.fixture(scope="module")
def sine():
    jeng = JQueryEngine(sine_store(JMemStore, JStoreConfig, JRecordBuilder,
                                   JGAUGE), "ds")
    teng = QueryEngine(sine_store(TimeSeriesMemStore, StoreConfig,
                                  RecordBuilder, GAUGE, device="cpu"), "ds",
                       device="cpu")
    return jeng, teng


def assert_same(got, ref, q, rtol, exact=False):
    assert [k.labels for k in got.matrix.keys] == \
        [k.labels for k in ref.matrix.keys], q
    np.testing.assert_array_equal(got.matrix.out_ts, ref.matrix.out_ts)
    r = np.asarray(ref.matrix.values, np.float64)
    g = np.asarray(got.matrix.values, np.float64)
    assert g.shape == r.shape, (q, g.shape, r.shape)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(r), err_msg=q)
    if exact:
        np.testing.assert_array_equal(g, r, err_msg=q)
    else:
        scale = float(np.nanmax(np.abs(r), initial=0.0))
        np.testing.assert_allclose(g, r, rtol=rtol, atol=rtol * scale,
                                   equal_nan=True, err_msg=q)
    assert got.exec_path == ref.exec_path, (q, got.exec_path, ref.exec_path)
    for f in ("fused_kernels", "series_matched", "blocks_raw",
              "blocks_narrow", "subquery_inner_cells"):
        assert getattr(got.stats, f) == getattr(ref.stats, f), (q, f)


def oracle_subquery(engine, inner_q, fn, start, end, step, rng, sub):
    """A hand-nested evaluation (tests/test_subquery.py's oracle): the
    inner query on the absolute sub-step grid, then ``fn`` over each
    window's finite values."""
    inner = engine.query_range(inner_q, ((start - rng) // sub + 1) * sub,
                               (end // sub) * sub, sub)
    sub_ts = inner.matrix.out_ts
    vals = np.asarray(inner.matrix.values, np.float64)
    out_ts = np.arange(start, end + 1, step)
    want = np.full((vals.shape[0], len(out_ts)), np.nan)
    for j, t in enumerate(out_ts):
        m = (sub_ts > t - rng) & (sub_ts <= t)
        for i in range(vals.shape[0]):
            w = vals[i, m]
            w = w[np.isfinite(w)]
            if len(w):
                want[i, j] = fn(w)
    return want


OUTER = (("max_over_time", np.max), ("min_over_time", np.min),
         ("avg_over_time", np.mean), ("sum_over_time", np.sum),
         ("count_over_time", len))


@pytest.mark.parametrize("outer,npfn", OUTER, ids=[o for o, _ in OUTER])
def test_subquery_matches_jax_and_the_nested_oracle(sine, outer, npfn):
    jeng, teng = sine
    q = f"{outer}(rate(m[1m])[5m:1m])"
    ref = jeng.query_range(q, *RANGE)
    got = teng.query_range(q, *RANGE)
    assert_same(got, ref, q, 1e-12, exact=outer == "count_over_time")
    assert got.stats.subquery_inner_cells > 0
    want = oracle_subquery(teng, "rate(m[1m])", npfn, *RANGE, 300_000,
                           60_000)
    np.testing.assert_allclose(np.asarray(got.matrix.values), want,
                               rtol=1e-12, equal_nan=True)


SUBQUERIES = (
    "max_over_time(avg_over_time(rate(m[1m])[5m:1m])[10m:2m])",
    "sum(max_over_time(rate(m[1m])[5m:1m]))",
    "avg_over_time((m * 2)[5m:1m])",
    "quantile_over_time(0.5, m[10m:1m])",
    "rate(m[5m:30s])",
    "max_over_time(m[5m:1m] offset 2m)",
    "stddev_over_time(sum by (host) (m)[10m:1m])",
    "last_over_time(vector(1)[5m:1m])",
)


@pytest.mark.parametrize("q", SUBQUERIES)
def test_nested_and_composed_subqueries_match_jax(sine, q):
    jeng, teng = sine
    assert_same(teng.query_range(q, *RANGE), jeng.query_range(q, *RANGE), q,
                1e-12)


AT_QUERIES = (f"m @ {AT_MS / 1000.0}", f"rate(m[2m] @ {AT_MS / 1000.0})",
              f"sum(rate(m[2m] @ {AT_MS / 1000.0}))",
              f"m - m @ {AT_MS / 1000.0}",
              f"max_over_time(m[5m] @ {AT_MS / 1000.0})")


@pytest.mark.parametrize("q", AT_QUERIES)
def test_at_modifier_matches_jax(sine, q):
    jeng, teng = sine
    ref = jeng.query_range(q, *RANGE)
    got = teng.query_range(q, *RANGE)
    assert_same(got, ref, q, 1e-12, exact=q.startswith("m @"))


def test_at_pins_and_broadcasts_bit_for_bit(sine):
    """Every step of an ``@``-pinned range query is the instant query at
    the pinned time, bit for bit."""
    _jeng, teng = sine
    for q, inner in ((f"sum(rate(m[2m] @ {AT_MS / 1000.0}))",
                      "sum(rate(m[2m]))"),
                     (f"m @ {AT_MS / 1000.0}", "m")):
        got = np.asarray(teng.query_range(q, *RANGE).matrix.values)
        pinned = np.asarray(teng.query_instant(inner, AT_MS).matrix.values)
        assert got.shape[1] == 11
        np.testing.assert_array_equal(
            np.sort(got, axis=0), np.sort(np.repeat(pinned[:, -1:], 11, 1),
                                          axis=0))


def test_instant_subquery_and_at_match_jax(sine):
    jeng, teng = sine
    t = START + 800_000
    for q in ("max_over_time(rate(m[1m])[5m:1m])",
              f"m @ {AT_MS / 1000.0}"):
        ref = jeng.query_instant(q, t)
        got = teng.query_instant(q, t)
        assert got.result_type == ref.result_type == "vector"
        assert_same(got, ref, q, 1e-12)


# -- f32 stores through real ingest and flush --------------------------------

LAYOUT_QUERIES = ("max_over_time(rate(m[5m])[10m:1m])",
                  f"m @ {(te.START + 600_000) // 1000}",
                  "_filodb_chunkmeta_all(m)",
                  "max_over_time(sum(rate(m[5m]))[30m:1m])")
LAYOUT_RANGE = (te.START + 300_000, te.START + 990_000, 30_000)


@pytest.fixture(scope="module", params=["aligned", "churned", "offgrid"])
def f32_engines(request):
    data = te.samples(request.param)
    jms = JMemStore()
    jsh = jms.setup("p", JGAUGE, 0, JStoreConfig(
        max_series_per_shard=64, samples_per_series=128,
        flush_batch_size=10**9))
    te.ingest(jsh, JRecordBuilder, JGAUGE, data)
    tms = TimeSeriesMemStore(device="cpu")
    tsh = tms.setup("p", GAUGE, 0, StoreConfig(
        max_series_per_shard=64, samples_per_series=128,
        flush_batch_size=10**9, device="cpu"))
    te.ingest(tsh, RecordBuilder, GAUGE, data)
    return (JQueryEngine(jms, "p"), QueryEngine(tms, "p", device="cpu"),
            request.param)


@pytest.mark.parametrize("q", LAYOUT_QUERIES)
def test_f32_store_routes_match_jax(f32_engines, q):
    """Were cases of tests/test_torch_engine.py's unported-route test."""
    jeng, teng, _layout = f32_engines
    with jax_xla_mode():
        ref = jeng.query_range(q, *LAYOUT_RANGE)
    got = teng.query_range(q, *LAYOUT_RANGE)
    assert got.matrix.num_series > 0
    assert_same(got, ref, q, 1e-5, exact=q.startswith(("m @", "_filodb")))


def test_a_fused_inner_runs_k1_once(f32_engines):
    """The inner ``sum(rate(m[5m]))`` of a subquery takes the fused map
    phase once a query on a grid-aligned shard (K1's plain twin on the
    CPU), and the outer max is a windowed max over the inner's own 1m-grid
    answer."""
    jeng, teng, layout = f32_engines
    q = "max_over_time(sum(rate(m[5m]))[30m:1m])"
    served = registry.counter(FILODB_QUERY_FUSED_SERVED,
                              {"shape": "rate_sum", "mode": "plain"})
    before = served.value
    got = teng.query_range(q, *LAYOUT_RANGE)
    fused = 0 if layout == "offgrid" else 1
    assert got.stats.fused_kernels == fused
    assert served.value == before + fused
    want = oracle_subquery(teng, "sum(rate(m[5m]))", np.max, *LAYOUT_RANGE,
                           1_800_000, 60_000)
    np.testing.assert_array_equal(np.asarray(got.matrix.values), want)


def test_chunk_metadata_keys_match_jax(f32_engines):
    jeng, teng, _layout = f32_engines
    q = '_filodb_chunkmeta_all(m{host="h1"})'
    with jax_xla_mode():
        ref = jeng.query_range(q, *LAYOUT_RANGE)
    got = teng.query_range(q, *LAYOUT_RANGE)
    assert got.matrix.num_series == 12
    assert_same(got, ref, q, 0.0, exact=True)
    d = got.matrix.keys[0].as_dict()
    assert d["_readerKlazz_"] == "SeriesStoreRow" and d["_sinkChunks_"] == "0"
    assert int(d["_numBytes_"]) == 12 * int(d["_numRows_"])


@pytest.mark.parametrize("q", ('m{__col__="value"}',
                               'rate(m{__col__="value"}[5m])',
                               'sum(rate(m{__col__="value"}[5m]))'))
def test_gauge_value_column_is_the_default_selection(f32_engines, q):
    jeng, teng, _layout = f32_engines
    with jax_xla_mode():
        ref = jeng.query_range(q, *LAYOUT_RANGE)
    got = teng.query_range(q, *LAYOUT_RANGE)
    plain = teng.query_range(q.replace('{__col__="value"}', ""),
                             *LAYOUT_RANGE)
    assert_same(got, ref, q, 1e-5, exact=q.startswith("m{"))
    np.testing.assert_array_equal(np.asarray(got.matrix.values),
                                  np.asarray(plain.matrix.values))


HIST_COL_QUERIES = ('h{__col__="count"}', 'rate(h{__col__="sum"}[2m])',
                    'h{__col__="h"}', "_filodb_chunkmeta_all(h)",
                    'sum(rate(h{__col__="count"}[2m]))')


@pytest.mark.parametrize("mode", ("off", "all"))
@pytest.mark.parametrize("q", HIST_COL_QUERIES)
def test_histogram_dataset_columns_match_jax(mode, q):
    """``__col__`` names the prom-histogram schema's scalar sum/count
    columns (the bucket tops do not ride) or its histogram column; on a
    hist-resident store the scalar columns stay raw f32 beside the
    2D-delta block, timestamps elided."""
    jeng, _route, teng = hist_engines_for(mode, "aligned")
    ref = jeng.query_range(q, *HIST_RANGE)
    got = teng.query_range(q, *HIST_RANGE)
    assert (got.matrix.bucket_les is None) == (ref.matrix.bucket_les is None)
    assert (got.matrix.bucket_les is None) == ('"h"' not in q)
    assert_same(got, ref, q, 1e-5,
                exact=not q.startswith(("rate", "sum")))


def test_subquery_rows_match_the_reference_loop():
    """The port builds each series' sample rows with one stable sort of
    the finiteness mask; the reference loops over series. On an inner
    matrix with NaN gaps, +/-Inf steps, an empty series and a full one,
    both give the same rows, so the same answers and the same
    ``subquery_inner_cells``."""
    import torch

    from filodb_tpu.query import exec as jexec
    from filodb_tpu.query.rangevector import RangeVectorKey as JKey
    from filodb_tpu.query.rangevector import ResultMatrix as JMatrix
    from filodb_tpu_torch.query import exec as texec
    from filodb_tpu_torch.query.rangevector import RangeVectorKey, ResultMatrix
    rng = np.random.default_rng(2)
    sub_ts = START + np.arange(40, dtype=np.int64) * 60_000
    vals = rng.normal(10.0, 3.0, (5, 40))
    vals[rng.random((5, 40)) < 0.3] = np.nan
    vals[1, 7], vals[2, 30] = np.inf, -np.inf
    vals[3] = np.nan
    vals[4] = rng.normal(0.0, 1.0, 40)
    labels = [(("i", str(i)),) for i in range(5)]

    class Child:
        def __init__(self, m):
            self.m = m

        def execute(self, ctx):
            return self.m

    kw = dict(start_ms=START + 900_000, step_ms=30_000,
              end_ms=START + 2_300_000, window_ms=600_000)
    for fn in ("avg_over_time", "max_over_time", "count_over_time",
               "rate", "last_over_time"):
        ref_plan = jexec.SubqueryWindowExec(
            child=Child(JMatrix(sub_ts, vals, [JKey(k) for k in labels])),
            function=fn, **kw)
        jctx = jexec.QueryContext(None, "x")
        ref = np.asarray(ref_plan.do_execute(jctx).values)
        plan = texec.SubqueryWindowExec(
            child=Child(ResultMatrix(sub_ts, torch.from_numpy(vals),
                                     [RangeVectorKey(k) for k in labels])),
            function=fn, **kw)
        tctx = texec.QueryContext(None, "x", torch.device("cpu"))
        got = np.asarray(plan.do_execute(tctx).values)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        np.testing.assert_allclose(got, ref, rtol=1e-12, equal_nan=True,
                                   err_msg=fn)
        assert tctx.stats.subquery_inner_cells == \
            jctx.stats.subquery_inner_cells == 5 * 40
