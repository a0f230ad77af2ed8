"""``query.fused_kernels="off"`` in the port against the JAX package's.

In "off" both packages route every query through the composed two-step
chain (the range function over the store, then the aggregators) instead
of the fused tier: the fused tier's A/B baseline. The same seeded samples
go through each package's RecordBuilder -> memstore -> flush; with both
packages' mode set to "off" (each under try/finally), the answers must
agree within the reference's bar (integer-valued answers exactly, the rest
within rtol 1e-5 of the result's largest magnitude), with the same
``exec_path`` route before any bracket and the same
``QueryStats.fused_kernels`` (0). The queries: ``sum(rate)``, ``sum by
(job) (rate)``, ``sum(avg_over_time)``, ``histogram_quantile(0.9,
sum(rate(h[5m])))`` over an "all" (2D-delta resident) store, and
``sum(rate)`` over an 8-shard mesh. In "off" neither K1's nor K2's entry
point (``fusedgrid.fused_grid_partials``, ``fusedresident.fused_hist_map``)
is called; in the default mode the same queries take the fused route
again. A FiloServer configured with "off" starts and sets the mode.
"""

import contextlib
import re

import numpy as np
import pytest

from filodb_tpu.core.memstore import StoreConfig as JStoreConfig
from filodb_tpu.core.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.core.record import RecordBuilder as JRecordBuilder
from filodb_tpu.core.schemas import GAUGE as JGAUGE
from filodb_tpu.core.schemas import PROM_HISTOGRAM as JPROM_HISTOGRAM
from filodb_tpu.ops import fusedresident as jfr
from filodb_tpu.parallel.distributed import make_mesh as jmake_mesh
from filodb_tpu.query.engine import QueryEngine as JQueryEngine
from filodb_tpu_torch.config import Config, fused_kernels_mode
from filodb_tpu_torch.core.memstore import StoreConfig, TimeSeriesMemStore
from filodb_tpu_torch.core.record import RecordBuilder
from filodb_tpu_torch.core.schemas import GAUGE, PROM_HISTOGRAM
from filodb_tpu_torch.ops import fusedgrid
from filodb_tpu_torch.ops import fusedresident as tfr
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.standalone import FiloServer

START = 1_700_000_000_000
IV = 10_000
N = 100
RANGE = (START + 300_000, START + 900_000, 30_000)
SCALAR_QUERIES = ("sum(rate(m[5m]))", "sum by (job) (rate(m[5m]))",
                  "sum(avg_over_time(m[5m]))")
HIST_QUERY = "histogram_quantile(0.9, sum(rate(h[5m])))"
MESH_QUERY = "sum(rate(m[1m]))"


@contextlib.contextmanager
def modes(mode: str):
    """Both packages' process-global fused mode set to ``mode``, restored
    after."""
    jold, told = jfr.mode(), tfr.mode()
    jfr.set_mode(mode)
    tfr.set_mode(mode)
    try:
        yield
    finally:
        jfr.set_mode(jold)
        tfr.set_mode(told)


def route(exec_path: str) -> str:
    """The route with its implementation brackets taken out: the port says
    ``[plain]`` on the CPU where the reference names its variant."""
    return re.sub(r"\[[^\]]*\]", "", exec_path or "")


def counters(n_series: int, seed: int):
    rng = np.random.default_rng(seed)
    return [np.cumsum(rng.integers(1, 50, N)).astype(np.float64)
            if s % 3 else np.cumsum(rng.exponential(5.0, N))
            for s in range(n_series)]


def scalar_store(pkg: str, nshards: int = 1, n_series: int = 48,
                 mesh_devs=None):
    ts = START + np.arange(N, dtype=np.int64) * IV
    if pkg == "jax":
        ms = JMemStore()
        cfg = JStoreConfig(max_series_per_shard=64, samples_per_series=128,
                           flush_batch_size=10**9)
        builder, schema = JRecordBuilder, JGAUGE
        for i in range(nshards):
            kw = {} if mesh_devs is None else {"device": mesh_devs[i % 8]}
            ms.setup("p", schema, i, cfg, **kw)
    else:
        ms = TimeSeriesMemStore(device="cpu")
        cfg = StoreConfig(max_series_per_shard=64, samples_per_series=128,
                          flush_batch_size=10**9, device="cpu")
        builder, schema = RecordBuilder, GAUGE
        for i in range(nshards):
            ms.setup("p", schema, i, cfg)
    for s, v in enumerate(counters(n_series, 7)):
        b = builder(schema)
        b.add_batch({"_metric_": "m", "job": f"J{s % 4}", "inst": f"i{s}"},
                    ts, v)
        ms.ingest("p", s % nshards, b.build())
    ms.flush_all()
    return ms


def hist_store(pkg: str, n_series: int = 24, B: int = 8):
    """Integer (Poisson) histograms in an "all" store: both packages keep
    every row in the 2D-delta block (the reference's encoder is exact on
    integer rows)."""
    les = np.concatenate([2.0 ** np.arange(B - 1), [np.inf]])
    rng = np.random.default_rng(12)
    data = [np.cumsum(np.cumsum(rng.poisson(0.3, (N, B)), axis=0),
                      axis=1).astype(np.float64) for _ in range(n_series)]
    ts = START + np.arange(N, dtype=np.int64) * IV
    if pkg == "jax":
        ms, builder, schema = JMemStore(), JRecordBuilder, JPROM_HISTOGRAM
        sh = ms.setup("h", schema, 0, JStoreConfig(
            max_series_per_shard=32, samples_per_series=128,
            flush_batch_size=10**9, compressed_residency="all"))
    else:
        ms, builder, schema = (TimeSeriesMemStore(device="cpu"),
                               RecordBuilder, PROM_HISTOGRAM)
        sh = ms.setup("h", schema, 0, StoreConfig(
            max_series_per_shard=32, samples_per_series=128,
            flush_batch_size=10**9, compressed_residency="all",
            device="cpu"))
    for s, c in enumerate(data):
        b = builder(schema, bucket_les=les)
        b.add_batch({"_metric_": "h", "host": f"x{s}"}, ts, c)
        ms.ingest("h", 0, b.build())
    sh.flush()
    assert sh.store.is_narrow_resident
    return ms


@pytest.fixture(scope="module")
def scalar():
    return (JQueryEngine(scalar_store("jax"), "p"),
            QueryEngine(scalar_store("torch"), "p", device="cpu"))


@pytest.fixture(scope="module")
def hist():
    return (JQueryEngine(hist_store("jax"), "h"),
            QueryEngine(hist_store("torch"), "h", device="cpu"))


@pytest.fixture(scope="module")
def mesh():
    jdevs = list(jmake_mesh().devices.ravel())
    jms = scalar_store("jax", nshards=8, n_series=64, mesh_devs=jdevs)
    tms = scalar_store("torch", nshards=8, n_series=64)
    return (JQueryEngine(jms, "p", mesh=jmake_mesh()),
            QueryEngine(tms, "p", device="cpu", mesh=["cpu"] * 8))


@pytest.fixture
def no_kernels(monkeypatch):
    """K1's and K2's entry points fail the test if anything calls them."""
    def refuse(*_a, **_k):
        raise AssertionError("a fused kernel ran in query.fused_kernels=off")
    monkeypatch.setattr(fusedgrid, "fused_grid_partials", refuse)
    monkeypatch.setattr(tfr, "fused_hist_map", refuse)


def series(res):
    return {k.labels: np.asarray(v, np.float64)
            for k, _t, v in res.matrix.iter_series()}


def assert_same_answer(got, ref):
    g, r = series(got), series(ref)
    assert set(g) == set(r)
    scale = max((float(np.nanmax(np.abs(v), initial=0.0)) for v in r.values()),
                default=0.0)
    for k, rv in r.items():
        np.testing.assert_array_equal(np.isnan(g[k]), np.isnan(rv))
        np.testing.assert_allclose(g[k], rv, rtol=0,
                                   atol=1e-5 * max(scale, 1e-30))


def off_pair(jeng, teng, q):
    with modes("off"):
        ref = jeng.query_range(q, *RANGE)
        got = teng.query_range(q, *RANGE)
    assert route(got.exec_path) == route(ref.exec_path), \
        (q, got.exec_path, ref.exec_path)
    assert got.stats.fused_kernels == ref.stats.fused_kernels == 0, q
    assert_same_answer(got, ref)
    return got


@pytest.mark.parametrize("q", SCALAR_QUERIES)
def test_off_mode_scalar_queries_match_jax(scalar, no_kernels, q):
    got = off_pair(*scalar, q)
    assert got.exec_path == "local"


def test_off_mode_hist_quantile_matches_jax(hist, no_kernels):
    got = off_pair(*hist, HIST_QUERY)
    # the fused-hist engine route is skipped: the general ExecPlan chain
    assert route(got.exec_path) == "local"


def test_off_mode_mesh_matches_jax(mesh, no_kernels):
    got = off_pair(*mesh, MESH_QUERY)
    assert got.exec_path == "mesh-twostep"


@pytest.mark.parametrize("q", SCALAR_QUERIES)
def test_default_mode_still_fuses_and_agrees_with_off(scalar, q):
    _jeng, teng = scalar
    fused = teng.query_range(q, *RANGE)
    assert tfr.mode() == "pallas"
    assert fused.stats.fused_kernels == 1, q
    with modes("off"):
        off = teng.query_range(q, *RANGE)
    assert off.stats.fused_kernels == 0
    assert_same_answer(fused, off)


def test_default_mode_hist_and_mesh_take_their_fused_routes(hist, mesh):
    _j, th = hist
    _j, tm = mesh
    assert route(th.query_range(HIST_QUERY, *RANGE).exec_path) \
        == "fused-hist-narrow"
    assert tm.query_range(MESH_QUERY, *RANGE).exec_path == "mesh-fused"


def test_set_mode_refuses_an_unknown_name():
    with pytest.raises(ValueError, match="fused_kernels"):
        tfr.set_mode("mosaic")
    assert tfr.MODES == jfr.MODES
    assert tfr.mode() == jfr.mode() == "pallas"


@pytest.mark.parametrize("mode", ["off", "xla", "pallas"])
def test_server_starts_with_the_configured_mode(mode):
    cfg = Config({"query": {"fused_kernels": mode}, "http": {"port": 0}})
    assert fused_kernels_mode(cfg) == mode
    old = tfr.mode()
    srv = FiloServer(cfg, device="cpu")
    try:
        srv.start()
        assert tfr.mode() == mode
        assert srv.http is not None
    finally:
        srv.shutdown()
        tfr.set_mode(old)
