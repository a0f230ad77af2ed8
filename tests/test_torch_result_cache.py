"""The serving fast path's result and negative caches, the slow-query log
and the shards' data epochs, in both packages.

The same seeded integer counters go through each package's RecordBuilder,
ingest and flush (one GAUGE shard, f32, grid-aligned: the fused route, the
plain twin of K1 on the CPU). Both engines, with the same ``QueryConfig``,
then answer the same sequence: a cold query, its repeat (a result-cache
hit), an ingest + flush (the epoch moves; the entry invalidates), the
repeat (recomputed), its repeat (a hit), a release by eviction (a
destructive epoch bump), the repeat again; a typo'd metric twice (the
second a negative-cache hit). Each step must agree on ``exec_path``, the
``QueryStats`` counters, the caches' ``stats()``, the epoch vector and log,
the slow-query log's plan and stats, and the values.

Tolerance: bit for bit, against the JAX engine and against the port's own
cache-free engine (integer samples; the K1 twin's f32 folds round as the
reference's do on this data).
"""

import contextlib
import itertools

import numpy as np
import pytest

from filodb_tpu.core.memstore import StoreConfig as JStoreConfig
from filodb_tpu.core.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.core.record import RecordBuilder as JRecordBuilder
from filodb_tpu.core.schemas import GAUGE as JGAUGE
from filodb_tpu.ops import fusedresident as jfusedresident
from filodb_tpu.query import engine as jengine
from filodb_tpu.query.engine import QueryConfig as JQueryConfig
from filodb_tpu.query.engine import QueryEngine as JQueryEngine
from filodb_tpu_torch.core.memstore import (EPOCH_AFFECTS_ALL, StoreConfig,
                                            TimeSeriesMemStore)
from filodb_tpu_torch.core.record import RecordBuilder
from filodb_tpu_torch.core.schemas import GAUGE
from filodb_tpu_torch.query import engine as tengine
from filodb_tpu_torch.query.engine import QueryConfig, QueryEngine
from filodb_tpu_torch.query.rangevector import QueryStats

START = 1_000_000
IV = 10_000
CELLS = 90
RANGE = (START + 300_000, START + 800_000, 30_000)
Q_SUM = "sum by (dc) (sum_over_time(m[2m]))"
Q_RATE = "sum by (dc) (rate(m[2m]))"
TYPO = "sum(rate(typo_metric[2m]))"
_ds_ids = itertools.count()


@pytest.fixture(autouse=True)
def jax_xla_mode():
    """The JAX engine's fused tier through its XLA twin on the CPU."""
    old = jfusedresident.mode()
    jfusedresident.set_mode("xla")
    try:
        yield
    finally:
        jfusedresident.set_mode(old)


def fresh_dataset(prefix: str) -> str:
    """A dataset name no other test in the process used: the caches'
    counters live in each package's process-global registry, tagged by
    dataset."""
    return f"{prefix}{next(_ds_ids)}"


def series_values(i: int, t0: int, n: int) -> np.ndarray:
    """Cells ``[t0, t0 + n)`` of series ``i``: an integer counter whose
    increments come from a generator seeded with ``i``."""
    inc = np.random.default_rng(100 + i).integers(1, 9, t0 + n)
    return np.cumsum(inc)[t0:].astype(np.float64)


class Pair:
    """One memstore in each package, holding the same rows."""

    def __init__(self, ds: str, max_series: int = 16, capacity: int = 256,
                 residency: str = "off"):
        self.ds = ds
        kw = dict(max_series_per_shard=max_series,
                  samples_per_series=capacity, flush_batch_size=10**9,
                  compressed_residency=residency)
        self.jms = JMemStore()
        self.jms.setup(ds, JGAUGE, 0, JStoreConfig(**kw))
        self.tms = TimeSeriesMemStore(device="cpu")
        self.tms.setup(ds, GAUGE, 0, StoreConfig(**kw, device="cpu"))

    def ingest(self, i: int, t0: int, n: int, metric: str = "m") -> None:
        vals = series_values(i, t0, n)
        for rb, schema, ms in ((JRecordBuilder, JGAUGE, self.jms),
                               (RecordBuilder, GAUGE, self.tms)):
            b = rb(schema)
            for k in range(n):
                b.add({"_metric_": metric, "host": f"h{i}",
                       "dc": f"dc{i % 2}"}, START + (t0 + k) * IV,
                      float(vals[k]))
            ms.ingest(self.ds, 0, b.build())

    def flush(self) -> None:
        self.jms.flush_all()
        self.tms.flush_all()

    def shards(self):
        return self.jms.shard(self.ds, 0), self.tms.shard(self.ds, 0)

    def engines(self, **cfg):
        return (JQueryEngine(self.jms, self.ds, config=JQueryConfig(**cfg)),
                QueryEngine(self.tms, self.ds, config=QueryConfig(**cfg),
                            device="cpu"))


def make_pair(prefix: str, n_series: int = 6, **kw) -> Pair:
    p = Pair(fresh_dataset(prefix), **kw)
    for i in range(n_series):
        p.ingest(i, 0, CELLS)
    p.flush()
    return p


def counters(res) -> dict:
    """The port's QueryStats counters of a result (no stage times)."""
    d = res.stats.to_dict()
    return {f: d[f] for f in QueryStats.FIELDS}


def assert_values(got, ref, what: str) -> None:
    """Keys in order, steps, NaN placement, values bit for bit."""
    g, r = got.matrix.to_host(), ref.matrix.to_host()
    assert [k.labels for k in g.keys] == [k.labels for k in r.keys], what
    np.testing.assert_array_equal(g.out_ts, r.out_ts, err_msg=what)
    gv = np.asarray(g.values, np.float64)[:len(g.keys)]
    rv = np.asarray(r.values, np.float64)[:len(r.keys)]
    assert gv.shape == rv.shape, what
    np.testing.assert_array_equal(gv, rv, err_msg=what)


def assert_same_step(jr, tr, what: str) -> None:
    """One step of the sequence: route, counters, values."""
    assert tr.exec_path == jr.exec_path, (what, tr.exec_path, jr.exec_path)
    assert counters(tr) == counters(jr), what
    assert_values(tr, jr, what)


def assert_same_state(pair, jeng, teng, what: str) -> None:
    """Cache stats, epoch vectors and epoch logs equal in both packages."""
    for name in ("result_cache", "negative_cache", "fragment_cache"):
        jc, tc = getattr(jeng, name), getattr(teng, name)
        assert (jc is None) == (tc is None), (what, name)
        if jc is not None:
            js, ts = jc.stats(), tc.stats()
            assert ts == js, (what, name, ts, js)
    assert teng._epoch_vector() == jeng._epoch_vector(), what
    jsh, tsh = pair.shards()
    assert tsh.epoch_state() == jsh.epoch_state(), what
    assert tsh.visible_lead_ms == jsh.visible_lead_ms, what


@contextlib.contextmanager
def slow_logs_cleared():
    jengine.slow_query_log.clear()
    tengine.slow_query_log.clear()
    try:
        yield
    finally:
        jengine.slow_query_log.clear()
        tengine.slow_query_log.clear()


def slow_entries(log) -> list:
    """Newest first: the plan, the shed flag and the stats counters."""
    return [(e["promql"], e["plan"], e.get("shed", False),
             {f: e["stats"][f] for f in QueryStats.FIELDS})
            for e in log.entries()]


@pytest.mark.parametrize("q", (Q_SUM, Q_RATE))
def test_cache_sequence_matches_the_reference(q):
    pair = make_pair("rc", max_series=8)
    cfg = dict(result_cache_size=4, negative_cache_size=4,
               slow_log_threshold_ms=0.0)
    jeng, teng = pair.engines(**cfg)
    # the cache-free oracle logs nothing: its entries would join the
    # port's slow-query ring whenever a loaded host takes 1 s for a query
    oracle = QueryEngine(pair.tms, pair.ds, device="cpu",
                         config=QueryConfig(slow_log_threshold_ms=None))
    seen = []

    def step(what, query=q, rng=RANGE):
        jr, tr = jeng.query_range(query, *rng), teng.query_range(query, *rng)
        assert_same_step(jr, tr, what)
        assert_same_state(pair, jeng, teng, what)
        # the port's answer is bit for bit its cache-free engine's
        assert_values(tr, oracle.query_range(query, *rng), what)
        seen.append(tr.exec_path)
        return tr

    with slow_logs_cleared():
        cold = step("cold")
        hit = step("repeat")
        assert hit.exec_path == f"result-cache[{cold.exec_path}]"
        assert hit.stats.result_cache_hits == 1
        pair.ingest(6, 40, 50)      # a new series inside the range
        pair.flush()
        again = step("after ingest")
        assert not again.exec_path.startswith("result-cache")
        assert teng.result_cache.stats()["invalidations"] == 1
        step("repeat after ingest")
        # three more series than the shard's 8 slots: eviction releases
        # the least recently active series (a destructive bump)
        for i in (7, 8, 9):
            pair.ingest(i, 60, 30)
        pair.flush()
        assert pair.shards()[1].stats.partitions_evicted > 0
        assert any(m == EPOCH_AFFECTS_ALL
                   for _e, m in pair.shards()[1].epoch_state()[1])
        step("after release")
        assert teng.result_cache.stats()["invalidations"] == 2
        step("typo", TYPO)
        neg = step("typo repeat", TYPO)
        assert neg.exec_path == "negative-cache"
        assert neg.stats.negative_cache_hits == 1
        assert slow_entries(tengine.slow_query_log) == \
            slow_entries(jengine.slow_query_log)
    assert seen == ["local", "result-cache[local]", "local",
                    "result-cache[local]", "local", "local",
                    "negative-cache"]


def test_result_cache_lru_and_tenant_keys():
    pair = make_pair("lru")
    jeng, teng = pair.engines(result_cache_size=2)
    for eng in (jeng, teng):
        for q in ("sum(m)", "max(m)", "count(m)"):
            eng.query_range(q, *RANGE)
        r = eng.query_range("count(m)", *RANGE)
        assert r.exec_path.startswith("result-cache")
        ra = eng.query_range("sum(m)", *RANGE, tenant="a")
        rb = eng.query_range("sum(m)", *RANGE, tenant="b")
        assert not ra.exec_path.startswith("result-cache")
        assert not rb.exec_path.startswith("result-cache")
        assert eng.query_range("sum(m)", *RANGE, tenant="a") \
            .exec_path.startswith("result-cache")
    assert_same_state(pair, jeng, teng, "lru")
    assert len(teng.result_cache) == len(jeng.result_cache) == 2


def test_instant_queries_bypass_the_caches():
    pair = make_pair("inst")
    jeng, teng = pair.engines(result_cache_size=4, negative_cache_size=4)
    t = START + 800_000
    for eng in (jeng, teng):
        eng.query_instant("sum(m)", t)
        r = eng.query_instant("sum(m)", t)
        assert not r.exec_path.startswith("result-cache")
        assert eng.query_instant("sum(nope)", t).exec_path != \
            "negative-cache"
    assert_same_state(pair, jeng, teng, "instant")
    assert len(teng.result_cache) == len(teng.negative_cache) == 0


def test_negative_cache_range_ttl_and_matched_empty():
    """A negative hit needs the request inside the proven range, slid
    forward by the wall time since the proof; an empty answer whose
    selection matched series is never cached; the TTL evicts."""
    pair = make_pair("neg")
    jeng, teng = pair.engines(negative_cache_size=4, negative_cache_ttl_s=30)
    start, end, step = RANGE
    for eng in (jeng, teng):
        eng.query_range(TYPO, start, end, step)
        r = eng.query_range(TYPO, start + step, end + step, step)
        assert r.exec_path == "negative-cache"
        np.testing.assert_array_equal(
            r.matrix.out_ts, np.arange(start + step, end + step + 1, step))
        # an older range than the proof: executes again
        assert eng.query_range(TYPO, start - 10 * step, end, step) \
            .exec_path != "negative-cache"
        r = eng.query_range("topk(0, m)", *RANGE)
        assert r.matrix.num_series == 0 and r.stats.series_matched > 0
        assert eng.query_range("topk(0, m)", *RANGE).exec_path != \
            "negative-cache"
    assert_same_state(pair, jeng, teng, "negative")
    for mod in (jengine, tengine):
        c = mod.NegativeResultCache(capacity=2, ttl_s=1.0)
        c.put(("q", None), (0, 100, 10), now=0.0)
        assert c.hit(("q", None), (0, 100, 10), now=0.5)
        assert not c.hit(("q", None), (0, 100, 10), now=1.5)
        assert c.stats()["evictions"] == 1 and len(c) == 0


def test_recovering_shard_is_no_proof_of_emptiness():
    pair = make_pair("rec")
    jeng, teng = pair.engines(negative_cache_size=4)
    for eng, sh in zip((jeng, teng), pair.shards()):
        sh.recovering = True
        eng.query_range(TYPO, *RANGE)
        assert eng.query_range(TYPO, *RANGE).exec_path != "negative-cache"
        sh.recovering = False
        eng.query_range(TYPO, *RANGE)
        assert eng.query_range(TYPO, *RANGE).exec_path == "negative-cache"
    assert_same_state(pair, jeng, teng, "recovering")


def test_epochs_bump_only_where_visible_data_changes():
    """Ingest alone (staged rows) bumps nothing; the flush that lands them
    bumps once with the batch's minimum timestamp; a flush with nothing
    staged, and discarded staging, bump nothing; every bump logs one
    entry."""
    pair = make_pair("ep", n_series=2)
    jsh, tsh = pair.shards()
    e0 = tsh.data_epoch
    assert e0 == jsh.data_epoch == 1
    assert tsh.epoch_state() == (1, [(1, START)])
    assert tsh.visible_lead_ms == START + (CELLS - 1) * IV
    pair.ingest(0, CELLS, 3)
    assert tsh.data_epoch == jsh.data_epoch == e0
    assert tsh._stage_min_ts == START + CELLS * IV
    pair.flush()
    assert tsh.epoch_state() == jsh.epoch_state() == \
        (2, [(1, START), (2, START + CELLS * IV)])
    pair.flush()
    assert tsh.data_epoch == jsh.data_epoch == 2
    b = RecordBuilder(GAUGE)
    b.add({"_metric_": "m", "host": "h0", "dc": "dc0"},
          START + (CELLS + 3) * IV, 1e6)
    tsh.ingest(b.build())
    tsh.discard_staged()
    tsh.flush()
    assert tsh.data_epoch == 2 and tsh._stage_min_ts is None
    assert tsh.visible_lead_ms == jsh.visible_lead_ms == \
        START + (CELLS + 2) * IV
