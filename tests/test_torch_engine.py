"""The slice end to end: ingest -> flush -> PromQL in both packages.

The same seeded samples are built into RecordContainers by each package's
RecordBuilder, ingested into each package's memstore and flushed; then both
QueryEngines answer the slice's queries. They must agree on the values
(rtol 1e-5 of the result's largest magnitude: the fused folds sum rows in
different orders), the series keys, and the route that served
(``QueryStats.fused_kernels``). The JAX engine runs its fused tier through
the XLA twin (the JAX package's own CPU path); the port's CPU tensors take
the plain twin of K1.

Three shards: one grid-aligned, one with a churned late-start cohort whose
minority rows the engines recompute through the general kernels, and one
off the scrape grid (jittered timestamps), served by the general kernels
alone.
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
N_SERIES = 48
QUERIES = ("sum(rate(m[5m]))", "avg by (host) (rate(m[5m]))",
           "stddev(rate(m[5m]))", "sum(increase(m[5m]))",
           "count(avg_over_time(m[5m]))", "rate(m[5m])")


def samples(layout: str):
    """[(labels, ts[], vals[])]: counters with resets. ``churned``: a sixth
    of the series start 20 cells late; ``offgrid``: every sample is a few
    ms off its grid cell."""
    rng = np.random.default_rng(5)
    out = []
    for s in range(N_SERIES):
        late = 20 if layout == "churned" and s % 6 == 5 else 0
        k = N_SAMPLES - late
        vals = np.cumsum(rng.exponential(5.0, k))
        if s % 7 == 3:
            vals[k // 2:] -= vals[k // 2] - 1.0          # counter reset
        ts = START + (late + np.arange(k, dtype=np.int64)) * IV
        if layout == "offgrid":
            ts = ts + rng.integers(1, 900, k)
        out.append(({"_metric_": "m", "host": f"h{s % 4}", "inst": f"i{s}"},
                    ts, vals))
    return out


def labels_of(matrix):
    return [k.labels for k in matrix.keys]


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
        max_series_per_shard=64, samples_per_series=128,
        flush_batch_size=10**9))
    ingest(jsh, JRecordBuilder, JGAUGE, data)
    tms = TimeSeriesMemStore(device="cpu")
    tsh = tms.setup("p", GAUGE, 0, StoreConfig(
        max_series_per_shard=64, samples_per_series=128,
        flush_batch_size=10**9, device="cpu"))
    ingest(tsh, RecordBuilder, GAUGE, data)
    return (JQueryEngine(jms, "p"), QueryEngine(tms, "p", device="cpu"), tsh,
            request.param)


@pytest.mark.parametrize("q", QUERIES)
def test_query_matches_jax_engine(engines, q):
    jeng, teng, _, _ = engines
    start, end, step = START + 300_000, START + 990_000, 30_000
    with jax_xla_mode():
        ref = jeng.query_range(q, start, end, step)
    got = teng.query_range(q, start, end, step)
    assert labels_of(got.matrix) == labels_of(ref.matrix)
    np.testing.assert_array_equal(got.matrix.out_ts, ref.matrix.out_ts)
    r = np.asarray(ref.matrix.values, np.float64)
    g = np.asarray(got.matrix.values, np.float64)
    assert g.shape == r.shape
    np.testing.assert_array_equal(np.isnan(g), np.isnan(r))
    scale = float(np.nanmax(np.abs(r), initial=0.0))
    np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5 * scale,
                               equal_nan=True)
    assert got.stats.fused_kernels == ref.stats.fused_kernels
    assert got.stats.series_matched == ref.stats.series_matched == N_SERIES
    assert got.exec_path == "local"


def test_grid_state_of_the_fixture(engines):
    _, _, shard, layout = engines
    if layout == "offgrid":
        assert shard.store.grid_info() is None
    else:
        assert shard.store.grid_info() is not None
        kind, _ = shard.store.grid_cohorts()
        assert kind == ("mixed" if layout == "churned" else "uniform")


def test_instant_query_matches_jax_engine(engines):
    jeng, teng, _, _ = engines
    t = START + 700_000
    with jax_xla_mode():
        ref = jeng.query_instant("sum by (host) (rate(m[5m]))", t)
    got = teng.query_instant("sum by (host) (rate(m[5m]))", t)
    assert got.result_type == ref.result_type == "vector"
    assert labels_of(got.matrix) == labels_of(ref.matrix)
    np.testing.assert_allclose(np.asarray(got.matrix.values),
                               np.asarray(ref.matrix.values), rtol=1e-5)


# the general routes are parity cases of tests/test_torch_general_query.py,
# tests/test_torch_orderstats.py, tests/test_torch_subquery.py and
# tests/test_torch_hist_general.py, __col__ over a downsample family of
# tests/test_torch_downsample.py. With no family loaded, the column names a
# dataset that does not exist: the reference's typed error
UNPORTED = ('m{__col__="dAvg"}',)


@pytest.mark.parametrize("q", UNPORTED)
def test_unported_routes_raise_typed_errors(engines, q):
    jeng, teng, _, _ = engines
    with pytest.raises(QueryError, match="unknown column dAvg of dataset") \
            as got:
        teng.query_range(q, START + 300_000, START + 990_000, 30_000)
    with pytest.raises(Exception) as ref:
        jeng.query_range(q, START + 300_000, START + 990_000, 30_000)
    assert str(got.value) == str(ref.value)
