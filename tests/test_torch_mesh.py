"""The port's mesh route against the JAX package's.

The same seeded counters go through each package's RecordBuilder(GAUGE)
-> TimeSeriesMemStore.ingest -> flush into a sharded dataset (8 shards of
3 series, 16 shards of 5, 16 series and 64 samples a shard at most: the
JAX package's own mesh test sizes). The JAX engine runs on the 8-device
CPU mesh ``tests/conftest.py`` sets up, with its fused tier in its default
mode; the port's runs on ``["cpu"] * 8`` (shard i on device i % 8) and on
``["cpu"]`` (every shard a slot of one device), where K1's wrapper takes
its plain twin. For every route — ``mesh-fused`` (each op x fn),
``mesh-fused-narrow`` (each decode kind), ``mesh-twostep``, ``mesh-topk``,
``mesh-sketch``, ``mesh-empty`` — and for every fallback the reference
takes, both must report the same ``exec_path`` and the same
``series_matched`` / ``fused_kernels``, the same series keys and NaN
placement, and values within rtol 1e-5 of the result's largest magnitude
(integer-valued answers, counts, exactly). The port's mesh answer must
also equal its own host loop's over the same shards bit for bit.
"""

import contextlib
import dataclasses

import numpy as np
import pytest

from filodb_tpu.core.memstore import StoreConfig as JStoreConfig
from filodb_tpu.core.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.core.record import RecordBuilder as JRecordBuilder
from filodb_tpu.core.schemas import GAUGE as JGAUGE
from filodb_tpu.core.schemas import PROM_HISTOGRAM as JPROM_HISTOGRAM
from filodb_tpu.parallel.distributed import make_mesh as jmake_mesh
from filodb_tpu.promql import parser as jpromql
from filodb_tpu.query.engine import QueryEngine as JQueryEngine
from filodb_tpu.utils.metrics import registry as jregistry
from filodb_tpu_torch.core.memstore import StoreConfig, TimeSeriesMemStore
from filodb_tpu_torch.core.record import RecordBuilder
from filodb_tpu_torch.core.schemas import GAUGE, PROM_HISTOGRAM
from filodb_tpu_torch.device import DeviceUnavailable
from filodb_tpu_torch.parallel import distributed
from filodb_tpu_torch.promql import parser as tpromql
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.query.rangevector import QueryError
from filodb_tpu_torch.utils.metrics import registry

START = 1_000_000
IV = 10_000
N = 60
RANGE = (START + 300_000, START + 500_000, 20_000)
MESHES = {"8dev": ["cpu"] * 8, "1dev": ["cpu"]}

FNS = ("rate", "increase", "delta", "sum_over_time", "avg_over_time",
       "count_over_time")
OPS = ("sum", "avg", "count", "group", "stddev", "stdvar")


def rows_of(kind: str, n: int, seed: int):
    """``n`` value rows: counters (``delta8``: integer increments; the
    default), half-integer gauges (``quant16``), wide odd increments
    (``delta16``), continuous floats (``float``); ``pool``: counters with
    two continuous rows, which no narrow variant carries exactly."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if kind == "quant16":
            v = 1000.0 + 0.5 * np.arange(N) + 4.0 * i
        elif kind == "delta16":
            v = np.cumsum(rng.integers(100, 3000, N) * 2 + 1).astype(float)
        elif kind == "float":
            v = np.cumsum(rng.exponential(5.0, N))
        else:
            v = np.cumsum(rng.integers(1, 50, N)).astype(float)
        if kind == "pool" and i in (2, 7):
            v = np.cumsum(rng.exponential(5.0, N))
        out.append(v)
    return out


def build(pkg: str, nshards: int = 8, per_shard: int = 3,
          kind: str = "delta8", dtype: str = "float32",
          residency: str = "off", seed: int = 5, hist: bool = False):
    """One package's memstore over the same rows: series i on shard
    i % nshards, the JAX stores on device i % 8 of its mesh."""
    jdevs = list(jmake_mesh().devices.ravel())
    if pkg == "jax":
        ms = JMemStore()
        cfg = JStoreConfig(max_series_per_shard=16, samples_per_series=64,
                           flush_batch_size=10**9, dtype=dtype,
                           compressed_residency=residency)
        builder, schema = JRecordBuilder, (JPROM_HISTOGRAM if hist
                                           else JGAUGE)
        for i in range(nshards):
            ms.setup("p", schema, i, cfg, device=jdevs[i % 8])
    else:
        ms = TimeSeriesMemStore(device="cpu")
        cfg = StoreConfig(max_series_per_shard=16, samples_per_series=64,
                          flush_batch_size=10**9, dtype=dtype,
                          compressed_residency=residency, device="cpu")
        builder, schema = RecordBuilder, (PROM_HISTOGRAM if hist else GAUGE)
        for i in range(nshards):
            ms.setup("p", schema, i, cfg)
    ts = START + np.arange(N, dtype=np.int64) * IV
    les = np.array([1.0, 5.0, 25.0, np.inf])
    for i, v in enumerate(rows_of(kind, nshards * per_shard, seed)):
        labels = {"_metric_": "h" if hist else "m", "host": f"h{i}",
                  "grp": f"g{i % 4}"}
        if hist:
            b = builder(schema, bucket_les=les)
            for t in range(N):
                c = np.floor(v[t] * np.array([0.1, 0.4, 0.8, 1.0]))
                b.add(labels, int(ts[t]),
                      {"sum": float(v[t]), "count": float(c[-1]), "h": c})
        else:
            b = builder(schema)
            b.add_batch(labels, ts, v)
        ms.ingest("p", i % nshards, b.build())
    ms.flush_all()
    return ms


class Pair:
    """The JAX engine on its 8-device mesh, the port's on each mesh, and
    the port's host loop (no mesh), over one dataset's rows."""

    def __init__(self, **kw):
        self.jms, self.tms = build("jax", **kw), build("torch", **kw)
        self.jeng = JQueryEngine(self.jms, "p", mesh=jmake_mesh())
        self.teng = {name: QueryEngine(self.tms, "p", device="cpu", mesh=m)
                     for name, m in MESHES.items()}
        self.host = QueryEngine(self.tms, "p", device="cpu")


@pytest.fixture(scope="module")
def counters():
    return Pair()


@pytest.fixture(scope="module")
def wide():
    return Pair(nshards=16, per_shard=5, seed=11)


@pytest.fixture(scope="module")
def f64_counters():
    return Pair(dtype="float64", kind="float", seed=3)


def series(res):
    return {k.labels: np.asarray(v, np.float64)
            for k, _t, v in res.matrix.iter_series()}


def assert_matches(got, ref, exact: bool = False):
    """Keys, NaN placement and values of two answers: exactly, or within
    rtol 1e-5 of the reference's largest magnitude."""
    g, r = series(got), series(ref)
    assert set(g) == set(r)
    scale = max((float(np.nanmax(np.abs(v), initial=0.0)) for v in r.values()),
                default=0.0)
    for k, rv in r.items():
        np.testing.assert_array_equal(np.isnan(g[k]), np.isnan(rv))
        if exact:
            np.testing.assert_array_equal(g[k], rv)
        else:
            np.testing.assert_allclose(g[k], rv, rtol=0,
                                       atol=1e-5 * max(scale, 1e-30))


def assert_bit_equal(got, ref):
    assert got.matrix.keys == ref.matrix.keys
    np.testing.assert_array_equal(np.asarray(got.matrix.values, np.float64),
                                  np.asarray(ref.matrix.values, np.float64))


def query(eng, promql, q: str):
    """``eng.query_range(q)``; ``group(...)``, which neither parser spells,
    goes in as the plan of ``sum(...)`` with its operator replaced."""
    if not q.startswith("group("):
        return eng.query_range(q, *RANGE)
    plan = promql.query_to_logical_plan("sum" + q[len("group"):], *RANGE)
    return eng.exec_logical(dataclasses.replace(plan, operator="group"))


def run(pair: Pair, q: str, mesh: str = "8dev", exact: bool = False,
        route: str | None = None, bit_equal: bool = True):
    """One query through both packages: route, stats and values agree; the
    port's mesh answer equals its host loop's bit for bit (``bit_equal``)."""
    ref = query(pair.jeng, jpromql, q)
    got = query(pair.teng[mesh], tpromql, q)
    assert got.exec_path == ref.exec_path, (q, got.exec_path, ref.exec_path)
    if route is not None:
        assert got.exec_path == route, (q, got.exec_path)
    for f in ("series_matched", "fused_kernels"):
        assert getattr(got.stats, f) == getattr(ref.stats, f), (q, f)
    assert_matches(got, ref, exact)
    host = query(pair.host, tpromql, q)
    assert host.exec_path == "local"
    # mesh-empty answers no series where the host path presents one
    # all-NaN group, in both packages
    if (bit_equal and got.exec_path.startswith("mesh-")
            and got.exec_path != "mesh-empty"):
        if got.exec_path == "mesh-topk":
            assert_matches(got, host, exact=True)
        else:
            assert_bit_equal(got, host)
    return got


@contextlib.contextmanager
def counted(reg, name: str, tags: dict):
    c = reg.counter(name, tags)
    v0 = c.value
    box = {}
    yield box
    box["delta"] = c.value - v0


# -- routes --------------------------------------------------------------------

@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("fn", FNS)
@pytest.mark.parametrize("op", OPS)
def test_fused(counters, op, fn, mesh):
    run(counters, f"{op}({fn}(m[5m]))", mesh,
        exact=op in ("count", "group") or fn == "count_over_time",
        route="mesh-fused")


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("q", ("avg by (grp) (rate(m[5m]))",
                               "sum without (host) (increase(m[5m]))",
                               'sum(rate(m{grp="g1"}[5m]))'))
def test_fused_grouped_and_filtered(counters, q, mesh):
    run(counters, q, mesh, route="mesh-fused")


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("kind", ("delta8", "quant16", "delta16"))
def test_fused_narrow(kind, mesh):
    pair = Pair(kind=kind, residency="gauge")
    for sh in pair.tms.shards_of("p"):
        assert sh.store.narrow_operands()[0] == kind
    for q in ("sum(rate(m[5m]))", "stddev by (grp) (increase(m[5m]))"):
        run(pair, q, mesh, route="mesh-fused-narrow")
    # the other routes read a transient decode of the narrow state
    run(pair, "max(rate(m[5m]))", mesh, route="mesh-twostep")


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("q", ("max(rate(m[5m]))", "min by (grp) (rate(m[5m]))",
                               "max(delta(m[5m]))", "sum(m)"))
def test_twostep(counters, q, mesh):
    run(counters, q, mesh, route="mesh-twostep")


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("q", ("sum(rate(m[5m]))", "max(rate(m[5m]))",
                               "min by (grp) (increase(m[5m]))",
                               "count(sum_over_time(m[5m]))"))
def test_twostep_f64_store(f64_counters, q, mesh):
    run(f64_counters, q, mesh, route="mesh-twostep")


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("q", ("topk(3, rate(m[5m]))",
                               "bottomk(2, rate(m[5m]))",
                               "topk(2, rate(m[5m])) by (grp)",
                               "bottomk(1, increase(m[5m])) by (grp)",
                               'topk(2, rate(m{grp="g1"}[5m]))'))
def test_topk(counters, q, mesh):
    run(counters, q, mesh, route="mesh-topk")


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("q", ("quantile(0.5, rate(m[5m]))",
                               "quantile(0.9, rate(m[5m])) by (grp)",
                               "quantile(0.25, m)"))
def test_sketch(counters, q, mesh):
    run(counters, q, mesh, route="mesh-sketch")


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_empty(counters, mesh):
    got = run(counters, "sum(rate(nosuch[5m]))", mesh, route="mesh-empty")
    assert got.matrix.num_series == 0


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("q", ("sum(rate(m[5m]))", "avg by (grp) (rate(m[5m]))",
                               "max(rate(m[5m]))", "topk(3, rate(m[5m]))",
                               "quantile(0.5, rate(m[5m]))"))
def test_sixteen_shards_on_eight_devices(wide, q, mesh):
    run(wide, q, mesh, route=None)
    assert wide.teng[mesh].query_range(q, *RANGE).exec_path.startswith("mesh-")


# -- fallbacks -----------------------------------------------------------------

def test_pool_rows_take_the_fused_route_over_the_decode():
    """Narrow-resident shards with cohort-pool rows: K1 raw over each
    shard's transient f32 decode. The host leaf streams the narrow block
    and folds the pool rows in through the general kernels instead, so the
    two agree within the bar, not bit for bit."""
    pair = Pair(kind="pool", per_shard=5, residency="gauge")
    ok = [sh.store.narrow_operands()[2] for sh in pair.tms.shards_of("p")]
    assert all(o is not None for o in ok) and not all(o[:5].all() for o in ok)
    for mesh in MESHES:
        run(pair, "sum(rate(m[5m]))", mesh, route="mesh-fused",
            bit_equal=False)


def test_one_shard_takes_the_host_path():
    pair = Pair(nshards=1, per_shard=12)
    for q in ("sum(rate(m[5m]))", "topk(2, rate(m[5m]))"):
        for mesh in MESHES:
            run(pair, q, mesh, route="local")


@pytest.mark.parametrize("ndev", (8, 3))
def test_shard_count_below_or_off_the_mesh_takes_the_host_path(ndev):
    """4 shards on 8 devices (fewer shards than devices) and on 3 (not a
    multiple); a one-device mesh divides any shard count."""
    import jax
    pair = Pair(nshards=4, per_shard=4)
    pair.jeng = JQueryEngine(pair.jms, "p",
                             mesh=jmake_mesh(jax.devices()[:ndev]))
    pair.teng["8dev"] = QueryEngine(pair.tms, "p", device="cpu",
                                    mesh=["cpu"] * ndev)
    run(pair, "sum(rate(m[5m]))", "8dev", route="local")
    got = pair.teng["1dev"].query_range("sum(rate(m[5m]))", *RANGE)
    assert got.exec_path == "mesh-fused"
    assert_bit_equal(got, pair.host.query_range("sum(rate(m[5m]))", *RANGE))


def test_histogram_store_takes_the_host_path():
    pair = Pair(hist=True)
    for mesh in MESHES:
        ref = pair.jeng.query_range("sum(rate(h[5m]))", *RANGE)
        got = pair.teng[mesh].query_range("sum(rate(h[5m]))", *RANGE)
        assert got.exec_path == ref.exec_path == "local"
        np.testing.assert_allclose(np.asarray(got.matrix.values),
                                   np.asarray(ref.matrix.values), rtol=1e-5)


def test_mixed_start_cohorts_take_the_twostep_route():
    """A second metric whose series start one cell late: every shard holds
    two start cohorts, so there is no fused grid. The host leaf recomputes
    at its selection's majority cohort, which the mesh does not see: the
    answers agree within the bar, not bit for bit."""
    pair = Pair()
    for ms, builder in ((pair.jms, JRecordBuilder), (pair.tms, RecordBuilder)):
        for i in range(8):
            b = builder(JGAUGE if builder is JRecordBuilder else GAUGE)
            b.add_batch({"_metric_": "late", "host": f"x{i}"},
                        START + (1 + np.arange(N - 1, dtype=np.int64)) * IV,
                        np.arange(N - 1, dtype=float))
            ms.ingest("p", i, b.build())
        ms.flush_all()
    for mesh in MESHES:
        run(pair, "sum(rate(late[5m]))", mesh, route="mesh-twostep",
            bit_equal=False)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_topk_over_sixteen_groups_falls_back(counters, mesh):
    q = "topk(1, rate(m[5m])) by (host)"
    tags = {"reason": "topk_caps"}
    with counted(registry, distributed.FILODB_QUERY_MESH_FALLBACK, tags) as t, \
            counted(jregistry, distributed.FILODB_QUERY_MESH_FALLBACK,
                    tags) as j:
        run(counters, q, mesh, route="local")
    assert t["delta"] == j["delta"] == 1


def test_quantile_over_the_group_cap_falls_back(wide):
    q = "quantile(0.5, rate(m[5m])) by (host)"
    tags = {"reason": "order_stat_caps"}
    with counted(registry, distributed.FILODB_QUERY_MESH_FALLBACK, tags) as t, \
            counted(jregistry, distributed.FILODB_QUERY_MESH_FALLBACK,
                    tags) as j:
        run(wide, q, "8dev", route="local")
    assert t["delta"] == j["delta"] == 1


@pytest.mark.parametrize("q", ("rate(m[5m])", 'count_values("v", m)',
                               "sum(rate(m[5m])) by (grp) > 0"))
def test_plans_off_the_mesh_take_the_host_path(counters, q):
    run(counters, q, "8dev", route="local")


def test_served_counter_names_route_and_mode(counters):
    tags = {"route": "fused", "mode": "eager"}
    with counted(registry, distributed.FILODB_QUERY_MESH_SERVED, tags) as t:
        counters.teng["8dev"].query_range("sum(rate(m[5m]))", *RANGE)
    assert t["delta"] == 1


# -- the lazy fetch ------------------------------------------------------------

def test_topk_release_between_launch_and_fetch_raises(monkeypatch):
    tms = build("torch")
    eng = QueryEngine(tms, "p", device="cpu", mesh=MESHES["8dev"])
    orig = distributed.LazyTopK.resolve

    def resolve(self):
        sh = tms.shard("p", 0)
        with sh.lock:                  # a purge lands before the fetch
            sh._release_partitions_locked(np.array([0], np.int32))
        return orig(self)

    monkeypatch.setattr(distributed.LazyTopK, "resolve", resolve)
    with pytest.raises(QueryError, match="retry"):
        eng.query_range("topk(24, rate(m[5m]))", *RANGE)


def test_make_mesh_needs_devices_without_a_card():
    assert distributed.make_mesh(["cpu", "cpu"]) == [distributed.torch.device(
        "cpu")] * 2
    with pytest.raises(ValueError):
        distributed.make_mesh([])
    if not distributed.torch.cuda.is_available():
        with pytest.raises(DeviceUnavailable):
            distributed.make_mesh()
