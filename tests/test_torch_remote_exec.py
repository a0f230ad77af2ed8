"""Cross-node query dispatch in the port: two nodes, each a QueryEngine over
its own memstore (``device="cpu"``) and its own FiloHttpServer, answer
every query as one node owning every shard does, bit for bit.

Mirrors the reference's ``tests/test_remote_exec.py`` (the 19 query shapes
on the two-node and the batched four-shard topologies, the co-located
reduce, replan-once after a peer dies, the metadata federation, the
oversized plan, batch errors, histograms) and ``tests/test_peer_breaker.py``
(a peer that accepts and stalls trips its breaker; the breaker sheds as
503). Then the packages against each other on the same seeded rows: the
port's two-node answers within the numeric bar of the JAX one-node oracle,
and a mixed pair (a port node and a JAX node, each the other's peer)
answering from either side.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from filodb_tpu.core.memstore import StoreConfig as JStoreConfig
from filodb_tpu.core.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.core.record import RecordBuilder as JRecordBuilder
from filodb_tpu.core.schemas import GAUGE as JGAUGE
from filodb_tpu.http.api import FiloHttpServer as JHttpServer
from filodb_tpu.parallel.cluster import ShardManager as JShardManager
from filodb_tpu.parallel.shardmapper import ShardMapper as JShardMapper
from filodb_tpu.query.engine import QueryEngine as JQueryEngine
from filodb_tpu_torch.core import filters as F
from filodb_tpu_torch.core.memstore import StoreConfig, TimeSeriesMemStore
from filodb_tpu_torch.core.record import RecordBuilder
from filodb_tpu_torch.core.schemas import GAUGE, PROM_HISTOGRAM
from filodb_tpu_torch.http.api import FiloHttpServer
from filodb_tpu_torch.parallel.cluster import ShardManager
from filodb_tpu_torch.parallel.shardmapper import ShardMapper
from filodb_tpu_torch.promql import parser as promql
from filodb_tpu_torch.query import wire
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.query.exec import (AggregateMapReduce,
                                         PeriodicSamplesMapper,
                                         ReduceAggregateExec,
                                         SelectRawPartitionsExec)
from filodb_tpu_torch.query.rangevector import QueryError

START = 1_000_000
INTERVAL = 10_000
N = 120
DATASET = "prometheus"
RANGE = (START + 600_000, START + 900_000, 30_000)

QUERIES = [
    'sum(rate(m[2m]))',
    'sum by (host) (rate(m[2m]))',
    'avg by (dc) (m)',
    'max(m)',
    'min by (dc) (rate(m[2m]))',
    'stddev(m)',
    'count(m)',
    'topk(3, m)',
    'bottomk(2, rate(m[2m]))',
    'quantile(0.5, m)',
    'count_values("v", count(m) by (dc))',
    'm + on(host, dc) m2',
    'sum(rate(m[2m])) / sum(rate(m2[2m]))',
    'abs(m) * 2',
    'sort_desc(sum by (host) (m))',
    'sum(rate(absent_metric[2m]))',
    'm * scalar(sum(m2))',           # step-varying scalar operand subplan
    'clamp_max(rate(m[2m]), 0.5)',
    'm and on(host, dc) m2',
]


def _labels(i, metric="m"):
    return {"_ws_": "demo", "_ns_": "app", "_metric_": metric,
            "host": f"h{i}", "dc": f"dc{i % 2}"}


def _vals(i):
    t = np.arange(N)
    return 100.0 * (i + 1) + 10.0 * np.sin(t / 7.0 + i)


def _cfg(jax=False):
    kw = dict(max_series_per_shard=32, samples_per_series=256,
              flush_batch_size=10**9, dtype="float64")
    return JStoreConfig(**kw) if jax else StoreConfig(**kw, device="cpu")


def _ingest(ms, shard, i, metric="m", jax=False):
    b = (JRecordBuilder(JGAUGE) if jax else RecordBuilder(GAUGE))
    v = _vals(i)
    for t in range(N):
        b.add(_labels(i, metric), START + t * INTERVAL, float(v[t]))
    ms.ingest(DATASET, shard, b.build())


def _memstore(jax=False):
    return JMemStore() if jax else TimeSeriesMemStore(device="cpu")


def _populate(ms, shards, nshards, jax=False):
    """Series i of each metric on shard i % nshards; only ``shards`` held."""
    for s in shards:
        ms.setup(DATASET, JGAUGE if jax else GAUGE, s, _cfg(jax))
    for i in range(8):
        if i % nshards in shards:
            for metric in ("m", "m2"):
                _ingest(ms, i % nshards, i, metric, jax)
    ms.flush_all()
    return ms


def _manager(nshards, jax=False):
    mgr = JShardManager() if jax else ShardManager()
    mgr.add_node("a")
    mgr.add_node("b")
    mgr.add_dataset(DATASET, nshards)
    return mgr


def _owners(mgr, nshards):
    owner = {s: mgr.node_of(DATASET, s) for s in range(nshards)}
    assert set(owner.values()) == {"a", "b"}
    return owner


def _engine(ms, nshards, mgr=None, node=None, resolver=None, jax=False):
    if jax:
        return JQueryEngine(ms, DATASET, JShardMapper(nshards), cluster=mgr,
                            node=node, endpoint_resolver=resolver)
    return QueryEngine(ms, DATASET, ShardMapper(nshards), device="cpu",
                       cluster=mgr, node=node, endpoint_resolver=resolver)


def _cluster(nshards):
    """(engines, oracle, mgr, eps, servers): two port nodes splitting an
    ``nshards`` dataset, and a port one-node oracle holding every shard."""
    mgr = _manager(nshards)
    owner = _owners(mgr, nshards)
    eps: dict[str, str] = {}
    engines = {n: _engine(_populate(_memstore(), [s for s in owner
                                                  if owner[s] == n],
                                    nshards), nshards, mgr, n, eps.get)
               for n in ("a", "b")}
    servers = {n: FiloHttpServer({DATASET: engines[n]}, port=0).start()
               for n in ("a", "b")}
    for n, srv in servers.items():
        eps[n] = f"127.0.0.1:{srv.port}"
    oracle = _engine(_populate(_memstore(), range(nshards), nshards),
                     nshards)
    return engines, oracle, mgr, eps, servers


@pytest.fixture(scope="module")
def two_node():
    engines, oracle, mgr, eps, servers = _cluster(2)
    try:
        yield engines, oracle, mgr, eps, servers
    finally:
        for srv in servers.values():
            srv.stop()


@pytest.fixture(scope="module")
def four_shard_two_node():
    engines, oracle, mgr, eps, servers = _cluster(4)
    try:
        yield engines, oracle, mgr, eps
    finally:
        for srv in servers.values():
            srv.stop()


@pytest.fixture(scope="module")
def jax_oracle():
    """The JAX package's one-node engine over the same seeded rows."""
    return _engine(_populate(_memstore(True), (0, 1), 2, True), 2, jax=True)


def _as_comparable(res):
    return {k.labels: (ts.tolist(), vals.tolist())
            for k, ts, vals in res.matrix.iter_series()}


def _within_bar(got, want, what):
    """The parity bar against the reference: the same keys and sample
    steps, values within rtol 1e-5 of the answer's largest magnitude."""
    assert set(got) == set(want), what
    top = max([abs(v) for _ts, vs in want.values() for v in vs] + [1.0])
    for k, (ts, vs) in want.items():
        assert got[k][0] == ts, what
        np.testing.assert_allclose(got[k][1], vs, rtol=0, atol=1e-5 * top,
                                   err_msg=what)


@pytest.mark.parametrize("query", QUERIES)
def test_two_node_parity(two_node, jax_oracle, query):
    """A query to either node equals the port's one-node oracle bit for
    bit (the peer's leaf ships over /exec, partials come back) and the JAX
    one-node oracle within the bar."""
    engines, oracle, _mgr, _eps, _servers = two_node
    want = _as_comparable(oracle.query_range(query, *RANGE))
    for n in ("a", "b"):
        got = _as_comparable(engines[n].query_range(query, *RANGE))
        assert got == want, f"node {n} diverged from the oracle on {query!r}"
    _within_bar(want, _as_comparable(jax_oracle.query_range(query, *RANGE)),
                query)


def test_plan_materializes_remote_leaf(two_node):
    engines, _oracle, mgr, _eps, _servers = two_node
    plan = promql.query_to_logical_plan("sum(rate(m[2m]))", START,
                                        START + 60_000, 30_000)
    exec_plan = engines["a"].planner.materialize(plan)
    remote = [c for c in exec_plan.children
              if isinstance(c, wire.RemoteLeafExec)]
    local = [c for c in exec_plan.children
             if isinstance(c, SelectRawPartitionsExec)]
    assert len(remote) == 1 and len(local) == 1
    assert mgr.node_of(DATASET, remote[0].inner.shard) == "b"
    assert mgr.node_of(DATASET, local[0].shard) == "a"
    # the pushed-down map phase ships with the subtree
    assert any(isinstance(t, AggregateMapReduce)
               for t in remote[0].transformers)


def test_peer_stats_merge_into_the_callers(two_node):
    """The peer's QueryStats ride the /exec payload: series matched and
    fused launches are cluster totals, equal to the one-node oracle's."""
    engines, oracle, _mgr, _eps, _servers = two_node
    want = oracle.query_range("sum(rate(m[2m]))", *RANGE).stats
    got = engines["a"].query_range("sum(rate(m[2m]))", *RANGE).stats
    assert got.series_matched == want.series_matched == 8
    assert got.fused_kernels == want.fused_kernels
    assert "peer_exec" in got.stage_ms


def test_metadata_federation(two_node):
    engines, oracle, _mgr, _eps, _servers = two_node
    as_sets = lambda rows: {tuple(sorted(dict(r).items())) for r in rows}  # noqa: E731
    for n in ("a", "b"):
        assert engines[n].label_values("host") == oracle.label_values("host")
        assert engines[n].label_names() == oracle.label_names()
        filt = [F.Equals("dc", "dc1")]
        got = engines[n].label_values("host", filt)
        want = oracle.label_values("host", filt)
        assert got == want and 0 < len(got) < len(oracle.label_values("host"))
        # every host counts 2 series (m and m2): a top-k over ties is a
        # set, ordered by arrival
        assert sorted(engines[n].label_values("host", top_k=8)) == \
            oracle.label_values("host")
        assert engines[n].label_value_counts("dc") == \
            oracle.label_value_counts("dc")
        got = engines[n].series([F.Equals("_metric_", "m")], START,
                                START + N * INTERVAL)
        want = oracle.series([F.Equals("_metric_", "m")], START,
                             START + N * INTERVAL)
        assert as_sets(got) == as_sets(want)
        # local_only stops at this node's shards
        assert len(engines[n].label_values("host", local_only=True)) == 4


def test_exec_rejects_oversized_plan(two_node):
    _engines, _oracle, _mgr, eps, _servers = two_node
    req = urllib.request.Request(
        f"http://{eps['a']}/exec/{DATASET}", data=b"x" * 64, method="POST",
        headers={"Content-Length": str(64 << 20)})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=10)
    assert ei.value.code == 413


def test_peer_unreachable_is_loud(two_node):
    engines, _oracle, _mgr, eps, _servers = two_node
    saved = eps["b"]
    eps["b"] = "127.0.0.1:1"           # nothing listens there
    try:
        with pytest.raises(QueryError, match="unreachable"):
            engines["a"].query_range("sum(m)", *RANGE)
    finally:
        eps["b"] = saved


def test_labels_match_selector_union(two_node):
    """match[] on the labels endpoints restricts to matching series,
    repeated selectors union, __name__ aliases for every matcher kind."""
    import urllib.parse
    _engines, _oracle, _mgr, eps, _servers = two_node

    def get(path, params):
        qs = "&".join(f"{k}={urllib.parse.quote(v)}" for k, v in params)
        with urllib.request.urlopen(
                f"http://{eps['a']}/promql/{DATASET}/api/v1/{path}?{qs}",
                timeout=15) as r:
            return json.load(r)["data"]

    all_hosts = get("label/host/values", [])
    assert len(all_hosts) == 8
    one = get("label/host/values", [("match[]", '{dc="dc0"}')])
    assert 0 < len(one) < len(all_hosts)
    both = get("label/host/values", [("match[]", '{dc="dc0"}'),
                                     ("match[]", '{dc="dc1"}')])
    assert both == all_hosts
    assert get("label/host/values",
               [("match[]", '{__name__=~"m2?"}')]) == all_hosts
    assert get("label/host/values", [("match[]", '{__name__="absent"}')]) == []
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(
            f"http://{eps['a']}/promql/{DATASET}/api/v1/series", timeout=15)
    assert ei.value.code == 400


def _replan_cluster(nshards, per_shard):
    """(memstore of the survivor holding every shard's store, manager,
    owners): the state a survivor reaches after takeover recovery."""
    mgr = _manager(nshards)
    owner = {s: mgr.node_of(DATASET, s) for s in range(nshards)}
    ms = _memstore()
    for s in range(nshards):
        ms.setup(DATASET, GAUGE, s, _cfg())
        for i in range(per_shard):
            _ingest(ms, s, s * per_shard + i)
    ms.flush_all()
    return ms, mgr, owner


def test_peer_death_replans_once_to_survivor():
    """A peer dying between materialization and execution raises
    RemotePeerError; the engine re-plans against the updated shard map and
    retries once."""
    ms, mgr, owner = _replan_cluster(2, 4)
    me = owner[0]
    if owner[1] == me:
        pytest.skip("strategy assigned both shards to one node")
    state = {"failed": False}

    def resolver(node):
        if node == owner[1] and not state["failed"]:
            state["failed"] = True
            # the membership monitor declares the peer dead concurrently
            mgr.remove_node(owner[1])
            return "127.0.0.1:1"          # nothing listens there
        return None

    eng = _engine(ms, 2, mgr, me, resolver)
    r = eng.query_range("count(m)", *RANGE)
    assert state["failed"], "the dead peer was never dispatched to"
    assert r.exec_path == "local-replanned"
    assert float(np.asarray(r.matrix.values)[0, 0]) == 8.0
    assert r.stats.series_matched == 8          # the first attempt dropped


def test_batched_peer_death_replans_once():
    """A peer owning two shards dies: the batched dispatch fails with a
    RemotePeerError carrying both shards; replan-once reroutes the batch."""
    ms, mgr, owner = _replan_cluster(4, 2)
    if "b" not in owner.values():
        pytest.skip("strategy assigned every shard to one node")
    state = {"failed": False}

    def resolver(node):
        if node == "b" and not state["failed"]:
            state["failed"] = True
            mgr.remove_node("b")
            return "127.0.0.1:1"
        return None

    eng = _engine(ms, 4, mgr, "a", resolver)
    r = eng.query_range("count(m)", *RANGE)
    assert state["failed"]
    assert r.exec_path == "local-replanned"
    assert float(np.asarray(r.matrix.values)[0, 0]) == 8.0


@pytest.mark.parametrize("query", QUERIES)
def test_batched_dispatch_parity(four_shard_two_node, query):
    """Two shards a peer: every remote fan-out batches, and the answers
    stay bit for bit the one-node oracle's (the batch's results splice
    back into their slots)."""
    engines, oracle, _mgr, _eps = four_shard_two_node
    want = _as_comparable(oracle.query_range(query, *RANGE))
    for n in ("a", "b"):
        got = _as_comparable(engines[n].query_range(query, *RANGE))
        assert got == want, f"batched dispatch diverged on {query!r}"


def test_batched_dispatch_one_roundtrip_per_peer(four_shard_two_node):
    engines, _oracle, _mgr, eps = four_shard_two_node
    peer = eps["b"]
    for query in ('sum(rate(m[2m]))', 'avg by (dc) (m)', 'topk(3, m)', 'm'):
        before = wire.breakers.request_counts.get(peer, 0)
        engines["a"].query_range(query, *RANGE)
        made = wire.breakers.request_counts.get(peer, 0) - before
        assert made == 1, f"{query!r} cost {made} round trips to the peer"
    plan = promql.query_to_logical_plan("sum(rate(m[2m]))", START,
                                        START + 60_000, 30_000)
    exec_plan = engines["a"].planner.materialize(plan)
    batches = [c for c in exec_plan.children
               if isinstance(c, wire.RemoteBatchExec)]
    assert len(batches) == 1 and len(batches[0].members) == 2
    assert all(isinstance(m, wire.RemoteLeafExec)
               for m in batches[0].members)
    assert sorted(batches[0].slots) == batches[0].slots


def test_batch_partial_error_names_missing_shard(four_shard_two_node):
    """A peer that no longer serves one of a batch's shards fails that
    envelope alone: a typed QueryError naming the shard."""
    engines, _oracle, mgr, _eps = four_shard_two_node
    victim = sorted(mgr.shards_of_node(DATASET, "b"))[1]
    store_b = engines["b"].memstore
    shard_obj = store_b._shards.pop((DATASET, victim))
    try:
        with pytest.raises(QueryError, match=rf"\[{victim}\]"):
            engines["a"].query_range("sum(m)", *RANGE)
    finally:
        store_b._shards[(DATASET, victim)] = shard_obj


def test_colocated_reduce_single_roundtrip():
    """An aggregate whose children all live on one peer ships the reduce
    node itself: one POST, only the reduced result returns."""
    mgr = ShardManager()
    mgr.add_node("b")
    mgr.add_dataset(DATASET, 2)          # both shards on b
    eng_b = _engine(_populate(_memstore(), (0, 1), 2), 2, mgr, "b")
    srv = FiloHttpServer({DATASET: eng_b}, port=0).start()
    ep = f"127.0.0.1:{srv.port}"
    # node c owns nothing: every leaf of every fan-in routes to b
    eng_c = QueryEngine(TimeSeriesMemStore(device="cpu"), DATASET,
                        ShardMapper(2), device="cpu", cluster=mgr, node="c",
                        endpoint_resolver=lambda n: ep)
    oracle = _engine(_populate(_memstore(), (0, 1), 2), 2)
    try:
        plan = promql.query_to_logical_plan("sum(rate(m[2m]))", START,
                                            START + 60_000, 30_000)
        exec_plan = eng_c.planner.materialize(plan)
        assert isinstance(exec_plan, wire.RemoteLeafExec)
        assert isinstance(exec_plan.inner, ReduceAggregateExec)
        assert len(exec_plan.inner.children) == 2
        for query in ('sum(rate(m[2m]))', 'avg by (dc) (m)', 'topk(3, m)',
                      'quantile(0.5, m)',
                      'count_values("v", count(m) by (dc))',
                      'sum(rate(m[2m])) / sum(rate(m2[2m]))',
                      'sort_desc(sum by (host) (m))', 'm + on(host, dc) m2',
                      # nests past the wire's depth bound: co-location
                      # falls back, never ships a plan the peer rejects
                      'sum(avg(max(min(count(m)))))'):
            want = _as_comparable(oracle.query_range(query, *RANGE))
            got = _as_comparable(eng_c.query_range(query, *RANGE))
            assert got == want, f"co-located reduce diverged on {query!r}"
        before = wire.breakers.request_counts.get(ep, 0)
        eng_c.query_range('sum(rate(m[2m]))', *RANGE)
        assert wire.breakers.request_counts.get(ep, 0) - before == 1
    finally:
        srv.stop()


def test_two_node_histogram_parity():
    """Bucket-wise AggPartials (with their bucket tops) cross the wire;
    histogram_quantile presents as on one node."""
    mgr = ShardManager()
    mgr.add_node("a")
    mgr.add_node("b")
    mgr.add_dataset("histds", 2)
    owner = {s: mgr.node_of("histds", s) for s in (0, 1)}
    les = np.array([1.0, 2.0, 4.0, 8.0, np.inf])
    rng = np.random.default_rng(7)
    hcfg = StoreConfig(max_series_per_shard=8, samples_per_series=128,
                       flush_batch_size=10**9, dtype="float64", device="cpu")
    stores = {"a": _memstore(), "b": _memstore()}
    oracle_ms = _memstore()
    NH = 100
    for s in (0, 1):
        stores[owner[s]].setup("histds", PROM_HISTOGRAM, s, hcfg)
        oracle_ms.setup("histds", PROM_HISTOGRAM, s, hcfg)
        for r in range(3):
            counts = np.cumsum(np.cumsum(rng.poisson(0.4, (NH, 5)), axis=0),
                               axis=1).astype(np.float64)
            for ms in (stores[owner[s]], oracle_ms):
                b = RecordBuilder(PROM_HISTOGRAM, bucket_les=les)
                for t in range(NH):
                    b.add({"_metric_": "lat", "pod": f"p{s}-{r}"},
                          START + t * INTERVAL, counts[t])
                ms.ingest("histds", s, b.build())
    for ms in (*stores.values(), oracle_ms):
        ms.flush_all()
    eps: dict[str, str] = {}
    engines = {n: QueryEngine(stores[n], "histds", ShardMapper(2),
                              device="cpu", cluster=mgr, node=n,
                              endpoint_resolver=eps.get) for n in ("a", "b")}
    servers = {n: FiloHttpServer({"histds": engines[n]}, port=0).start()
               for n in ("a", "b")}
    for n, srv in servers.items():
        eps[n] = f"127.0.0.1:{srv.port}"
    oracle = QueryEngine(oracle_ms, "histds", device="cpu")
    try:
        rng_ = (START + 400_000, START + (NH - 10) * INTERVAL, 60_000)
        for q in ("histogram_quantile(0.9, sum(rate(lat[2m])))",
                  "sum(rate(lat[2m]))",
                  "sum by (pod) (rate(lat[2m]))"):
            want = _as_comparable(oracle.query_range(q, *rng_))
            for n in ("a", "b"):
                got = _as_comparable(engines[n].query_range(q, *rng_))
                assert got == want, f"node {n} diverged on {q!r}"
    finally:
        for srv in servers.values():
            srv.stop()


# -- a port node and a JAX node, each the other's peer ----------------------

@pytest.fixture(scope="module")
def mixed_pair():
    """Node a is the port's, node b the JAX package's; each owns one shard
    of the 2-shard dataset and serves /exec for it."""
    tmgr, jmgr = _manager(2), _manager(2, jax=True)
    owner = _owners(tmgr, 2)
    assert owner == {s: jmgr.node_of(DATASET, s) for s in (0, 1)}
    eps: dict[str, str] = {}
    a_shards = [s for s in owner if owner[s] == "a"]
    b_shards = [s for s in owner if owner[s] == "b"]
    eng_a = _engine(_populate(_memstore(), a_shards, 2), 2, tmgr, "a",
                    eps.get)
    eng_b = _engine(_populate(_memstore(True), b_shards, 2, True), 2, jmgr,
                    "b", eps.get, jax=True)
    srv_a = FiloHttpServer({DATASET: eng_a}, port=0).start()
    srv_b = JHttpServer({DATASET: eng_b}, port=0).start()
    eps.update(a=f"127.0.0.1:{srv_a.port}", b=f"127.0.0.1:{srv_b.port}")
    try:
        yield eng_a, eng_b
    finally:
        srv_a.stop()
        srv_b.stop()


@pytest.mark.parametrize("query", QUERIES)
def test_mixed_pair_answers_from_either_side(mixed_pair, jax_oracle, query):
    """A port caller over a JAX peer and a JAX caller over a port peer
    both answer as the JAX one-node oracle does, within the bar."""
    eng_a, eng_b = mixed_pair
    want = _as_comparable(jax_oracle.query_range(query, *RANGE))
    _within_bar(_as_comparable(eng_a.query_range(query, *RANGE)), want,
                f"port caller: {query}")
    _within_bar(_as_comparable(eng_b.query_range(query, *RANGE)), want,
                f"JAX caller: {query}")


def test_mixed_pair_integer_answers_are_exact(mixed_pair, jax_oracle):
    eng_a, eng_b = mixed_pair
    for query in ("count(m)", "count by (dc) (m)",
                  'count_values("v", count(m) by (dc))'):
        want = _as_comparable(jax_oracle.query_range(query, *RANGE))
        assert _as_comparable(eng_a.query_range(query, *RANGE)) == want
        assert _as_comparable(eng_b.query_range(query, *RANGE)) == want
    assert eng_a.label_values("host") == \
        jax_oracle.label_values("host", local_only=True)
    assert eng_b.label_values("host") == \
        jax_oracle.label_values("host", local_only=True)


# -- the per-peer circuit breaker (ref: tests/test_peer_breaker.py) ----------

TIMEOUT = 0.25


class StallingPeer:
    """Accepts TCP connections, reads nothing, never answers."""

    def __init__(self, port=0):
        self._srv = socket.socket()
        self._srv.settimeout(0.1)
        self._srv.bind(("127.0.0.1", port))
        self._srv.listen(16)
        self.port = self._srv.getsockname()[1]
        self._conns: list[socket.socket] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stop.is_set():
            try:
                c, _ = self._srv.accept()
                self._conns.append(c)
            except TimeoutError:
                continue
            except OSError:
                break

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2)
        self._srv.close()
        for c in self._conns:
            c.close()


@pytest.fixture()
def small_breaker():
    wire.breakers.configure(threshold=2, cooldown_s=0.6)
    try:
        yield wire.breakers
    finally:
        wire.breakers.configure(threshold=3, cooldown_s=5.0)


def _leaf(ep, timeout_s=TIMEOUT):
    psm = PeriodicSamplesMapper(START + 600_000, 30_000, START + 900_000,
                                None, None)
    return wire.RemoteLeafExec(
        endpoint=ep, dataset=DATASET, timeout_s=timeout_s,
        inner=SelectRawPartitionsExec(transformers=[psm], shard=0,
                                      start_ms=START, end_ms=START + 600_000))


def _serving_node():
    return _engine(_populate(_memstore(), (0,), 1), 1)


def test_breaker_unit_lifecycle():
    b = wire.PeerBreaker(threshold=2, cooldown_s=0.2)
    assert b.admit() and not b.is_open
    b.record_failure()
    assert b.admit()
    b.record_failure()
    assert b.is_open and not b.admit()
    time.sleep(0.25)
    assert b.admit()                       # the half-open probe
    assert not b.admit()                   # one a cooldown
    b.record_success()
    assert not b.is_open and b.admit()


def test_breaker_trips_sheds_fast_and_spares_healthy_peers(small_breaker):
    from filodb_tpu_torch.utils.metrics import registry
    stall = StallingPeer()
    stall_ep = f"127.0.0.1:{stall.port}"
    healthy = FiloHttpServer({DATASET: _serving_node()}, port=0).start()
    healthy_ep = f"127.0.0.1:{healthy.port}"
    try:
        for _ in range(2):
            t0 = time.perf_counter()
            with pytest.raises(wire.RemotePeerError):
                _leaf(stall_ep).execute(None)
            assert time.perf_counter() - t0 >= TIMEOUT * 0.8
        t0 = time.perf_counter()
        with pytest.raises(wire.PeerCircuitOpen):
            _leaf(stall_ep).execute(None)
        assert time.perf_counter() - t0 < TIMEOUT / 2
        assert _leaf(healthy_ep, 60.0).execute(None) is not None
        assert not wire.breakers.for_endpoint(healthy_ep).is_open
        assert registry.gauge("filodb_peer_exec_latency_ms",
                              {"endpoint": healthy_ep}).value > 0.0
        assert registry.gauge("filodb_peer_breaker_open",
                              {"endpoint": stall_ep}).value == 1.0
    finally:
        stall.stop()
        healthy.stop()


def test_breaker_recovery_closes_after_peer_returns(small_breaker):
    stall = StallingPeer()
    port = stall.port
    ep = f"127.0.0.1:{port}"
    for _ in range(2):
        with pytest.raises(wire.RemotePeerError):
            _leaf(ep).execute(None)
    assert wire.breakers.for_endpoint(ep).is_open
    stall.stop()
    srv = FiloHttpServer({DATASET: _serving_node()}, port=port).start()
    try:
        time.sleep(0.7)                    # past the cooldown
        assert _leaf(ep, 60.0).execute(None) is not None
        assert not wire.breakers.for_endpoint(ep).is_open
    finally:
        srv.stop()


def test_breaker_open_maps_to_503(small_breaker):
    stall = StallingPeer()
    stall_ep = f"127.0.0.1:{stall.port}"
    ms, mgr, owner = _replan_cluster(2, 1)
    if owner[0] == owner[1]:
        pytest.skip("strategy assigned both shards to one node")
    eng = _engine(ms, 2, mgr, owner[0], lambda n: stall_ep)
    eng.planner.remote_timeout_s = TIMEOUT
    srv = FiloHttpServer({DATASET: eng}, port=0).start()
    try:
        url = (f"http://127.0.0.1:{srv.port}/promql/{DATASET}/api/v1/"
               f"query_range?query=sum(m)&start={START // 1000 + 600}"
               f"&end={START // 1000 + 900}&step=30")
        codes = []
        for _ in range(3):
            try:
                urllib.request.urlopen(url, timeout=10)
                codes.append(200)
            except urllib.error.HTTPError as e:
                codes.append(e.code)
                body = json.load(e)
        assert codes == [422, 422, 503]
        assert body.get("errorType") == "unavailable"
    finally:
        stall.stop()
        srv.stop()


def test_peer_epochs_validate_the_result_cache():
    """The result cache keys on the cluster's epoch vector: the peer's
    shards probed over /api/v1/epochs. A hit while nothing changed; a
    flush on the peer invalidates; an unreachable peer makes the vector
    unreadable (every lookup misses, nothing is stored) and arms the
    cooldown; a downsample family's engine routes by its raw dataset."""
    from filodb_tpu_torch.query.engine import QueryConfig
    mgr = _manager(2)
    owner = _owners(mgr, 2)
    eps: dict[str, str] = {}
    stores = {n: _populate(_memstore(), [s for s in owner if owner[s] == n],
                           2) for n in ("a", "b")}
    cfg = QueryConfig(result_cache_size=8)
    engines = {n: QueryEngine(stores[n], DATASET, ShardMapper(2),
                              device="cpu", config=cfg, cluster=mgr, node=n,
                              endpoint_resolver=eps.get) for n in ("a", "b")}
    servers = {n: FiloHttpServer({DATASET: engines[n]}, port=0).start()
               for n in ("a", "b")}
    eps.update({n: f"127.0.0.1:{s.port}" for n, s in servers.items()})
    q = "sum(rate(m[2m]))"
    try:
        first = engines["a"].query_range(q, *RANGE)
        hit = engines["a"].query_range(q, *RANGE)
        assert hit.exec_path == "result-cache[local]"
        assert _as_comparable(hit) == _as_comparable(first)
        vec, logs = engines["a"]._epoch_state(with_logs=True)
        peer = eps["b"]
        assert {k for k in logs if k[0] == peer} == \
            {(peer, str(s)) for s in owner if owner[s] == "b"}
        # the peer's shard lands new rows: the vector moves, the entry
        # invalidates
        b_shard = next(s for s in owner if owner[s] == "b")
        _ingest(stores["b"], b_shard, b_shard + 6, "m")
        stores["b"].flush_all()
        assert engines["a"]._epoch_state()[0] != vec
        assert engines["a"].query_range(q, *RANGE).exec_path == "local"
        # the peer goes away: no vector, no cache, and a cooldown
        servers["b"].stop()
        assert engines["a"]._epoch_state() == (None, None)
        assert engines["a"]._epoch_probe_down_until > time.monotonic()
        # a family engine with the raw dataset's routing
        fam = QueryEngine(_memstore(), "fam", ShardMapper(2), device="cpu",
                          cluster=mgr, node="a", endpoint_resolver=eps.get,
                          route_dataset=DATASET)
        assert fam._route_endpoint(b_shard) == peer
        assert fam._route_endpoint(next(s for s in owner
                                        if owner[s] == "a")) is None
    finally:
        for srv in servers.values():
            srv.stop()                     # idempotent
