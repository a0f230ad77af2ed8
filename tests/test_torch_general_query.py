"""The general PromQL path end to end: ingest -> flush -> PromQL in both
packages.

The same seeded samples go through each package's RecordBuilder, ingest
and flush; then the JAX QueryEngine (its CPU path, the fused tier through
the XLA twin) and the port's ``QueryEngine(device="cpu")`` answer the mix
the chip run's phase 8a sends: every range function and the instant
selector, scalar and vector operators (``bool``, ``on``/``ignoring``,
``group_left``/``group_right``), ``and``/``or``/``unless``, the instant
functions, classic ``le`` ``histogram_quantile`` fed by a fused
``sum by (le) (rate(...))``, ``label_replace``/``label_join``,
``sort``/``sort_desc``, ``scalar``/``vector``/``time``, and the order
statistics. They must agree on the series keys and their order, the NaN
placement, the values (rtol 1e-5 of the array's largest magnitude; exact
for counts and count_values) and ``QueryStats.fused_kernels``.

Three shards, as in tests/test_torch_engine.py: grid-aligned, a churned
late-start cohort, and off the scrape grid. Metrics: ``m`` counters with
resets (48 series), ``g`` small-integer gauges (16 series: ties for topk
and repeated values for count_values), ``lat_bucket`` classic histogram
counters (two hosts x four ``le`` buckets).
"""

import contextlib

import numpy as np
import pytest

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
from filodb_tpu_torch.query.rangevector import QueryError

START = 1_600_000_000_000
IV = 10_000
N_SAMPLES = 100
RANGE = (START + 300_000, START + 990_000, 30_000)
LES = ("0.1", "0.5", "1", "+Inf")

RANGE_QUERIES = (
    "rate(m[5m])", "increase(m[5m])", "delta(m[5m])", "irate(m[5m])",
    "idelta(m[5m])", "sum_over_time(m[5m])", "count_over_time(m[5m])",
    "avg_over_time(m[5m])", "min_over_time(m[5m])", "max_over_time(m[5m])",
    "stddev_over_time(m[5m])", "stdvar_over_time(m[5m])",
    "last_over_time(m[5m])", "changes(g[5m])", "resets(m[5m])",
    "deriv(m[5m])", "predict_linear(m[5m], 600)",
    "quantile_over_time(0.9, m[5m])", "holt_winters(m[5m], 0.5, 0.1)",
    "m", "g",
)
OPERATOR_QUERIES = (
    "rate(m[5m]) * 2", "2 / rate(m[5m])", "rate(m[5m]) % 0.3",
    "rate(m[5m]) ^ 2", "-rate(m[5m])", "rate(m[5m]) > 0.5",
    "rate(m[5m]) > bool 0.5", "0.5 < rate(m[5m])", "g == 3",
    "g != bool 3", "rate(m[5m]) * scalar(sum(g))", "time() - timestamp(m)",
    "rate(m[5m]) / irate(m[5m])",
    "rate(m[5m]) / on(host) group_left sum by (host) (rate(m[5m]))",
    "sum by (host) (g) * on(host) group_right rate(m[5m])",
    "rate(m[5m]) * ignoring(inst) group_left sum by (host) (g)",
    "rate(m[5m]) + on(inst) g",
    "rate(m[5m]) and on(inst) (g > 3)", "m or g",
    "rate(m[5m]) unless on(inst) (g > 2)",
)
FUNCTION_QUERIES = (
    "abs(delta(m[5m]))", "clamp_min(rate(m[5m]), 0.4)",
    "clamp_max(rate(m[5m]), 0.6)", "round(rate(m[5m]), 0.1)",
    "ceil(rate(m[5m]))", "floor(avg_over_time(m[5m]))", "ln(m)",
    "sqrt(m)", "exp(-rate(m[5m]))", "hour(timestamp(m))",
    "day_of_week(timestamp(m))", "year(timestamp(g))", "absent(nope)",
    "absent(m)",
    "histogram_quantile(0.9, sum by (le) (rate(lat_bucket[5m])))",
    "histogram_quantile(0.5, sum by (le, host) (rate(lat_bucket[5m])))",
    'label_replace(rate(m[5m]), "hostnum", "$1", "host", "h(.*)")',
    'label_join(g, "hi", "-", "host", "inst")', "sort_desc(rate(m[5m]))",
    "sort(g)", "scalar(sum(g))", "vector(1)", "time()",
)
ORDER_QUERIES = (
    "topk(3, rate(m[5m]))", "topk(2, g)", "bottomk(3, g)",
    "topk by (host) (2, rate(m[5m]))", "bottomk by (host) (1, g)",
    "bottomk(4, rate(m[5m]))", "quantile(0.9, rate(m[5m]))",
    "quantile by (host) (0.5, g)", 'count_values("v", g)',
    'count_values by (host) ("v", g)', "count(rate(m[5m]) > 0.5)",
    "sum(rate(m[5m]) > 0.5)", "max(max_over_time(m[5m]))",
    "avg(irate(m[5m]))",
)
QUERIES = RANGE_QUERIES + OPERATOR_QUERIES + FUNCTION_QUERIES + ORDER_QUERIES
INSTANT = ("m", "topk(2, g)", "rate(m[5m]) > 0.5", 'count_values("v", g)',
           "sum(m)")


# answers that are counts or small integers: the engines agree bit for bit
EXACT = {"count_over_time(m[5m])", "changes(g[5m])", "resets(m[5m])", "g",
         "g == 3", "g != bool 3", "rate(m[5m]) > bool 0.5", "topk(2, g)",
         "bottomk(3, g)", "bottomk by (host) (1, g)", 'count_values("v", g)',
         'count_values by (host) ("v", g)', "count(rate(m[5m]) > 0.5)",
         "sort(g)", "scalar(sum(g))", "vector(1)", "absent(nope)",
         "absent(m)", 'label_join(g, "hi", "-", "host", "inst")',
         "quantile by (host) (0.5, g)"}


def samples(layout: str):
    """[(labels, ts[], vals[])]: ``churned``: a sixth of the series start
    20 cells late; ``offgrid``: every sample is a few ms off its cell."""
    rng = np.random.default_rng(8)
    out = []

    def add(labels, s, vals_of):
        late = 20 if layout == "churned" and s % 6 == 5 else 0
        k = N_SAMPLES - late
        ts = START + (late + np.arange(k, dtype=np.int64)) * IV
        if layout == "offgrid":
            ts = ts + rng.integers(1, 900, k)
        out.append((labels, ts, vals_of(k)))

    for s in range(48):
        def counter(k, s=s):
            vals = np.cumsum(rng.exponential(5.0, k))
            if s % 7 == 3:
                vals[k // 2:] -= vals[k // 2] - 1.0      # counter reset
            return vals
        add({"_metric_": "m", "host": f"h{s % 4}", "inst": f"i{s}"}, s,
            counter)
    for s in range(16):
        add({"_metric_": "g", "host": f"h{s % 4}", "inst": f"i{s}"}, s,
            lambda k: rng.integers(0, 6, k).astype(np.float64))
    for h in range(2):
        inc = rng.poisson(2.0, (N_SAMPLES, len(LES)))
        cum = np.cumsum(np.cumsum(inc, axis=1), axis=0).astype(np.float64)
        for b, le in enumerate(LES):
            add({"_metric_": "lat_bucket", "host": f"h{h}", "le": le}, h,
                lambda k, b=b: cum[N_SAMPLES - k:, b])
    return out


def ingest(shard, builder_cls, schema, data):
    """One container per sample time, series in a fixed order."""
    for t in range(N_SAMPLES):
        b = builder_cls(schema)
        for labels, ts, vals in data:
            j = t - (N_SAMPLES - len(ts))
            if j >= 0:
                b.add(labels, int(ts[j]), float(vals[j]))
        shard.ingest(b.build())
    shard.flush()


@contextlib.contextmanager
def jax_xla_mode():
    old = jfusedresident.mode()
    jfusedresident.set_mode("xla")
    try:
        yield
    finally:
        jfusedresident.set_mode(old)


@pytest.fixture(scope="module", params=["aligned", "churned", "offgrid"])
def engines(request):
    data = samples(request.param)
    jms = JMemStore()
    jsh = jms.setup("p", JGAUGE, 0, JStoreConfig(
        max_series_per_shard=128, samples_per_series=128,
        flush_batch_size=10**9))
    ingest(jsh, JRecordBuilder, JGAUGE, data)
    tms = TimeSeriesMemStore(device="cpu")
    tsh = tms.setup("p", GAUGE, 0, StoreConfig(
        max_series_per_shard=128, samples_per_series=128,
        flush_batch_size=10**9, device="cpu"))
    ingest(tsh, RecordBuilder, GAUGE, data)
    return JQueryEngine(jms, "p"), QueryEngine(tms, "p", device="cpu")


def assert_same(got, ref, q):
    """Keys in order, shape, NaN placement, values, fused count."""
    assert [k.labels for k in got.matrix.keys] == \
        [k.labels for k in ref.matrix.keys], q
    np.testing.assert_array_equal(got.matrix.out_ts, ref.matrix.out_ts)
    r = np.asarray(ref.matrix.values, np.float64)
    g = np.asarray(got.matrix.values, np.float64)
    assert g.shape == r.shape, q
    np.testing.assert_array_equal(np.isnan(g), np.isnan(r), err_msg=q)
    if q in EXACT:
        np.testing.assert_array_equal(g, r, err_msg=q)
    else:
        scale = float(np.nanmax(np.abs(np.where(np.isinf(r), np.nan, r)),
                                initial=0.0))
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5 * scale,
                                   equal_nan=True, err_msg=q)
    assert got.stats.fused_kernels == ref.stats.fused_kernels, q
    assert got.exec_path == "local", q


@pytest.mark.parametrize("q", QUERIES)
def test_query_range_matches_jax_engine(engines, q):
    jeng, teng = engines
    with jax_xla_mode():
        ref = jeng.query_range(q, *RANGE)
    assert_same(teng.query_range(q, *RANGE), ref, q)


@pytest.mark.parametrize("q", INSTANT)
def test_query_instant_matches_jax_engine(engines, q):
    jeng, teng = engines
    t = START + 700_000
    with jax_xla_mode():
        ref = jeng.query_instant(q, t)
    got = teng.query_instant(q, t)
    assert got.result_type == ref.result_type == "vector"
    assert_same(got, ref, q)


@pytest.mark.parametrize("q", ("rate(m[5m]) > ignoring(inst) group_left g",
                               "rate(m[5m]) + on(host) g"))
def test_join_cardinality_errors_match(engines, q):
    """A 'one' side (or a one-to-one side) with duplicate join keys is an
    error in both engines, with the same message."""
    jeng, teng = engines
    with pytest.raises(Exception) as ref:
        jeng.query_range(q, *RANGE)
    with pytest.raises(QueryError) as got:
        teng.query_range(q, *RANGE)
    assert str(got.value) == str(ref.value)


def test_the_ratio_and_the_histogram_legs_run_fused(engines):
    """Each leg of a ratio of sums, and a classic histogram's
    ``sum by (le) (rate(...))``, take the fused map phase (K1 on the card)
    on the grid-aligned shards, as in the reference."""
    jeng, teng = engines
    for q, legs in (("sum(rate(m[5m])) / sum(rate(m[5m]))", 2),
                    ("histogram_quantile(0.9, sum by (le) "
                     "(rate(lat_bucket[5m])))", 1)):
        with jax_xla_mode():
            ref = jeng.query_range(q, *RANGE)
        got = teng.query_range(q, *RANGE)
        assert_same(got, ref, q)
        if teng.memstore.shard("p", 0).store.grid_info() is not None:
            assert got.stats.fused_kernels == legs, q
