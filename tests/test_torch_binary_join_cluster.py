"""Binary joins across three port nodes, against one node and the JAX cluster.

Mirrors the reference's ``tests/test_binary_join_cluster.py`` (three
tests): ``on``/``ignoring`` and ``group_left``/``group_right`` vector
matching, set operators and ``bool`` comparisons over 8 shards dealt
over nodes a, b and c, both sides of each join fanning out to peers
over HTTP and concatenating on the caller. Every shape, from every node,
equals the port's one-node oracle bit for bit on the general join path
(``exec_path == "local"``), and the JAX package's three-node cluster over
the same rows within the numeric bar.
"""

import numpy as np
import pytest

from filodb_tpu.core.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.core.record import RecordBuilder as JRecordBuilder
from filodb_tpu.core.schemas import GAUGE as JGAUGE
from filodb_tpu.http.api import FiloHttpServer as JHttpServer
from filodb_tpu.parallel.cluster import ShardManager as JShardManager
from filodb_tpu.parallel.shardmapper import ShardMapper as JShardMapper
from filodb_tpu.query.engine import QueryEngine as JQueryEngine
from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
from filodb_tpu_torch.core.record import RecordBuilder
from filodb_tpu_torch.core.schemas import GAUGE
from filodb_tpu_torch.http.api import FiloHttpServer
from filodb_tpu_torch.parallel.cluster import ShardManager
from filodb_tpu_torch.parallel.shardmapper import ShardMapper
from filodb_tpu_torch.query.engine import QueryEngine

from .test_torch_remote_exec import (DATASET, INTERVAL, N, START,
                                     _as_comparable, _cfg, _within_bar)

NODES = ("a", "b", "c")
NSHARDS = 8
HOSTS = 6
RANGE = (START + 600_000, START + 900_000, 30_000)


def _series():
    """``m{host, dc, job}`` (two jobs a host: the many side) and
    ``cap{host}`` (one series a host: the one side), with their bases."""
    out = []
    for i in range(HOSTS):
        for j in range(2):
            out.append(({"_metric_": "m", "host": f"h{i}",
                         "dc": f"dc{i % 2}", "job": f"j{j}"},
                        100.0 * (i + 1) + 7.0 * j))
        out.append(({"_metric_": "cap", "host": f"h{i}"},
                    1000.0 + 50.0 * i))
    return out


def _ingest_series(ms, shard, labels, base_val, jax):
    b = JRecordBuilder(JGAUGE) if jax else RecordBuilder(GAUGE)
    for t in range(N):
        b.add(labels, START + t * INTERVAL,
              base_val + 10.0 * np.sin(t / 9.0 + base_val))
    ms.ingest(DATASET, shard, b.build())


def _cluster(jax: bool):
    """(engines, oracle, servers) of one package: three nodes whose
    memstores each hold every shard (routing honours the ownership map),
    and a one-node oracle."""
    mgr = JShardManager() if jax else ShardManager()
    for n in NODES:
        mgr.add_node(n)
    mgr.add_dataset(DATASET, NSHARDS)

    def memstore():
        return JMemStore() if jax else TimeSeriesMemStore(device="cpu")

    stores = {n: memstore() for n in NODES}
    oracle_ms = memstore()
    for s in range(NSHARDS):
        for ms in (oracle_ms, *stores.values()):
            ms.setup(DATASET, JGAUGE if jax else GAUGE, s, _cfg(jax))
    for idx, (labels, base) in enumerate(_series()):
        for ms in (oracle_ms, *stores.values()):
            _ingest_series(ms, idx % NSHARDS, labels, base, jax)
    for ms in (*stores.values(), oracle_ms):
        ms.flush_all()
    eps: dict[str, str] = {}
    if jax:
        engines = {n: JQueryEngine(stores[n], DATASET, JShardMapper(NSHARDS),
                                   cluster=mgr, node=n,
                                   endpoint_resolver=eps.get)
                   for n in NODES}
        servers = {n: JHttpServer({DATASET: engines[n]}, port=0).start()
                   for n in NODES}
        oracle = JQueryEngine(oracle_ms, DATASET, JShardMapper(NSHARDS))
    else:
        engines = {n: QueryEngine(stores[n], DATASET, ShardMapper(NSHARDS),
                                  device="cpu", cluster=mgr, node=n,
                                  endpoint_resolver=eps.get)
                   for n in NODES}
        servers = {n: FiloHttpServer({DATASET: engines[n]}, port=0).start()
                   for n in NODES}
        oracle = QueryEngine(oracle_ms, DATASET, ShardMapper(NSHARDS),
                             device="cpu")
    for n, srv in servers.items():
        eps[n] = f"127.0.0.1:{srv.port}"
    return engines, oracle, servers


@pytest.fixture(scope="module")
def join_cluster():
    """The port's three nodes and oracle, and the JAX package's three
    nodes over the same rows."""
    engines, oracle, servers = _cluster(False)
    jengines, _joracle, jservers = _cluster(True)
    try:
        yield engines, oracle, jengines
    finally:
        for srv in (*servers.values(), *jservers.values()):
            srv.stop()


JOIN_QUERIES = [
    # OneToOne on an explicit match label (sum collapses the many side)
    "sum by (host) (m) / on(host) cap",
    # OneToOne ignoring the labels only one side carries
    "sum by (host, dc) (m) / ignoring(dc) cap",
    # ManyToOne: every (host, job) series of m against its host's cap
    "m / on(host) group_left cap",
    # OneToMany: the mirrored direction
    "cap * on(host) group_right m",
    # group_left carrying an extra label from the one side via include
    "m / on(host) group_left() cap",
    # comparison filter + matching: only hosts whose m exceeds a bound
    "m > 300 and on(host) cap > 1000",
    # set ops with matching labels
    "sum by (host) (m) or cap",
    "sum by (host) (m) unless on(host) cap",
    # arithmetic with bool comparison across matched sides
    "sum by (host) (m) >= bool on(host) cap - 900",
]


def test_cluster_joins_match_single_node_oracle(join_cluster):
    """Every join shape, from every entry node, equals the one-node oracle
    bit for bit on the general join path, and the JAX cluster's answer
    from the same node within the bar."""
    engines, oracle, jengines = join_cluster
    for query in JOIN_QUERIES:
        want = _as_comparable(oracle.query_range(query, *RANGE))
        for n in NODES:
            got_res = engines[n].query_range(query, *RANGE)
            got = _as_comparable(got_res)
            assert got == want, \
                f"node {n} diverged from oracle on {query!r}"
            assert got_res.exec_path == "local"      # the general join path
            jres = jengines[n].query_range(query, *RANGE)
            assert jres.exec_path == got_res.exec_path
            _within_bar(got, _as_comparable(jres), (n, query))


def test_cluster_join_cardinality_shapes(join_cluster):
    """Structural assertions: group_left fans one cap row out to both jobs
    of its host, and the OneToOne collapse keeps one row a host; the JAX
    cluster's shapes are the same."""
    engines, _oracle, jengines = join_cluster
    for eng in (engines, jengines):
        many = eng["a"].query_range("m / on(host) group_left cap", *RANGE)
        assert many.matrix.num_series == HOSTS * 2   # the many side's shape
        one = eng["b"].query_range("sum by (host) (m) / on(host) cap",
                                   *RANGE)
        assert one.matrix.num_series == HOSTS
        # join keys kept the match labels; the metric name dropped
        for k, _t, _v in many.matrix.iter_series():
            labels = dict(k.labels)
            assert "host" in labels and "job" in labels
            assert "_metric_" not in labels


def test_cluster_join_instant_api(join_cluster):
    """The same joins through query_instant (the rules evaluator's entry
    point): vector-typed result, cluster-wide."""
    engines, oracle, jengines = join_cluster
    t = START + 900_000
    q = "m / on(host) group_left cap"
    want = _as_comparable(oracle.query_instant(q, t))
    got_res = engines["c"].query_instant(q, t)
    got = _as_comparable(got_res)
    assert got == want
    jres = jengines["c"].query_instant(q, t)
    assert got_res.result_type == jres.result_type
    _within_bar(got, _as_comparable(jres), q)
