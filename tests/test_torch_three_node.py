"""Three nodes in the port, against its one-node oracle and the JAX engine.

Mirrors the reference's ``tests/test_three_node.py`` (five tests, seven
cases): 8 shards dealt 3/3/2 over nodes a, b and c by ``ShardManager``'s
least-loaded strategy, every node's memstore holding every shard (the
state a survivor reaches after takeover) and serving over its own
``FiloHttpServer``; spanning queries from every node, one trace across
nodes, a node killed and its shards split across both survivors with one
replan, and the mesh against the three-node host loop and the oracle
over f32, gauge-resident (the reference's ``narrow``) and f64 stores, and
the i8 histogram residency's host merge. The port's answers are bit for
bit its own oracle's, and within the numeric bar of the JAX package's
one-node engine over the same rows (bit for bit where the values are
integers).
"""

import json
import urllib.request

import numpy as np
import pytest

from filodb_tpu.core.memstore import StoreConfig as JStoreConfig
from filodb_tpu.core.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.core.record import RecordBuilder as JRecordBuilder
from filodb_tpu.core.schemas import GAUGE as JGAUGE
from filodb_tpu.core.schemas import PROM_HISTOGRAM as JPROM_HISTOGRAM
from filodb_tpu.parallel.shardmapper import ShardMapper as JShardMapper
from filodb_tpu.query.engine import QueryEngine as JQueryEngine
from filodb_tpu_torch.core.memstore import StoreConfig, TimeSeriesMemStore
from filodb_tpu_torch.core.record import RecordBuilder
from filodb_tpu_torch.core.schemas import GAUGE, PROM_HISTOGRAM
from filodb_tpu_torch.http.api import FiloHttpServer
from filodb_tpu_torch.parallel.cluster import ShardManager
from filodb_tpu_torch.parallel.shardmapper import ShardMapper
from filodb_tpu_torch.query import wire
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.utils.tracing import (SPAN_QUERY, SPAN_QUERY_DISPATCH,
                                            SPAN_QUERY_SERVE, tracer)

from .test_torch_remote_exec import (DATASET, START, _as_comparable, _cfg,
                                     _ingest, _within_bar)

NODES = ("a", "b", "c")
# 8 shards (the mapper is power-of-two) over 3 nodes: the least-loaded
# strategy deals a=3, b=3, c=2 — killing c exercises a split reassignment
NSHARDS = 8
RANGE = (START + 600_000, START + 900_000, 30_000)
SPANNING = ('sum(rate(m[2m]))', 'avg by (dc) (m)', 'topk(3, m)', 'count(m)')


def _serve(stores, mgr, nshards=NSHARDS):
    """(engines, eps, servers): a port engine and HTTP server a node,
    peers resolved through ``eps``."""
    eps: dict[str, str] = {}
    engines = {n: QueryEngine(stores[n], DATASET, ShardMapper(nshards),
                              device="cpu", cluster=mgr, node=n,
                              endpoint_resolver=eps.get)
               for n in NODES}
    servers = {n: FiloHttpServer({DATASET: engines[n]}, port=0).start()
               for n in NODES}
    for n, srv in servers.items():
        eps[n] = f"127.0.0.1:{srv.port}"
    return engines, eps, servers


def _manager():
    mgr = ShardManager()
    for n in NODES:
        mgr.add_node(n)
    mgr.add_dataset(DATASET, NSHARDS)
    return mgr


@pytest.fixture()
def three_node():
    """Three port nodes, every memstore holding every shard's data;
    routing honours the ShardManager's ownership map. Also the port's
    one-node oracle and the JAX package's one-node engine over the same
    rows (the reference fixture's)."""
    mgr = _manager()
    owner = {s: mgr.node_of(DATASET, s) for s in range(NSHARDS)}
    per_node = {n: sorted(mgr.shards_of_node(DATASET, n)) for n in NODES}
    assert sorted(len(v) for v in per_node.values()) == [2, 3, 3]
    assert len(per_node["c"]) == 2

    stores = {n: TimeSeriesMemStore(device="cpu") for n in NODES}
    oracle_ms = TimeSeriesMemStore(device="cpu")
    jms = JMemStore()
    for s in range(NSHARDS):
        oracle_ms.setup(DATASET, GAUGE, s, _cfg())
        jms.setup(DATASET, JGAUGE, s, _cfg(jax=True))
        for n in NODES:
            stores[n].setup(DATASET, GAUGE, s, _cfg())
    for i in range(12):
        s = i % NSHARDS
        _ingest(oracle_ms, s, i)
        _ingest(jms, s, i, jax=True)
        for n in NODES:
            _ingest(stores[n], s, i)
    for ms in (*stores.values(), oracle_ms, jms):
        ms.flush_all()

    engines, eps, servers = _serve(stores, mgr)
    oracle = QueryEngine(oracle_ms, DATASET, ShardMapper(NSHARDS),
                         device="cpu")
    jeng = JQueryEngine(jms, DATASET, JShardMapper(NSHARDS))
    try:
        yield engines, oracle, jeng, mgr, eps, servers, owner
    finally:
        for srv in servers.values():
            srv.stop()


def test_three_node_spanning_parity(three_node):
    """A spanning query issued to any of the three nodes matches the
    one-node oracle bit for bit, costs one round trip a peer (two /exec
    POSTs), and lies within the bar of the JAX engine."""
    engines, oracle, jeng, _mgr, _eps, _servers, _owner = three_node
    for query in SPANNING:
        want = _as_comparable(oracle.query_range(query, *RANGE))
        _within_bar(want, _as_comparable(jeng.query_range(query, *RANGE)),
                    query)
        for n in NODES:
            before = wire.breakers.total_requests()
            got = _as_comparable(engines[n].query_range(query, *RANGE))
            made = wire.breakers.total_requests() - before
            assert got == want, f"node {n} diverged from oracle on {query!r}"
            assert made == 2, (f"node {n} cost {made} round-trips on "
                               f"{query!r}; expected one per peer")


def test_one_query_one_trace_with_spans_from_every_node(three_node):
    """A spanning query yields one trace id whose spans cover both remote
    peers, the response stats equal the one-node oracle's, and the trace
    is served at /api/v1/debug/traces, also as Zipkin v2 JSON."""
    engines, oracle, jeng, _mgr, eps, _servers, _owner = three_node
    want = oracle.query_range('sum(rate(m[2m]))', *RANGE)
    tracer.drain()
    got = engines["a"].query_range('sum(rate(m[2m]))', *RANGE)
    assert _as_comparable(got) == _as_comparable(want)
    jwant = jeng.query_range('sum(rate(m[2m]))', *RANGE)

    # stats: cluster-aggregated counters equal the oracle's local-only run
    # and the JAX engine's
    ws, gs = want.stats.to_dict(), got.stats.to_dict()
    js = jwant.stats.to_dict()
    for field in ("series_matched", "result_cells"):
        assert gs[field] == ws[field] == js[field] > 0, field
    assert gs["blocks_raw"] + gs["blocks_narrow"] \
        == ws["blocks_raw"] + ws["blocks_narrow"] == NSHARDS
    # the peers really contributed: their stage time crossed the wire
    assert gs["stage_ms"].get("peer_exec", 0) > 0

    # one trace id, spans from every participating node
    spans = tracer.snapshot()
    roots = [s for s in spans if s.name == SPAN_QUERY]
    assert len(roots) == 1
    tid = roots[0].trace_id
    members = [s for s in spans if s.trace_id == tid]
    serve_nodes = {s.tags.get("node") for s in members
                   if s.name == SPAN_QUERY_SERVE}
    assert serve_nodes == {"b", "c"}, serve_nodes
    dispatches = [s for s in members if s.name == SPAN_QUERY_DISPATCH]
    assert len(dispatches) == 2                 # one POST per peer
    leaf_shards = {s.tags.get("shard") for s in members
                   if s.name == "query.exec.leaf"}
    assert leaf_shards == set(range(NSHARDS))   # every shard's leaf joined

    # the debug plane serves the assembled trace...
    url = f"http://{eps['a']}/api/v1/debug/traces?trace_id={tid}"
    with urllib.request.urlopen(url, timeout=10.0) as r:
        data = json.load(r)["data"]
    assert len(data) == 1 and data[0]["trace_id"] == tid
    assert data[0]["spans"][0]["name"] == SPAN_QUERY    # parent -> child
    assert len(data[0]["spans"]) == len(members)
    # ...and valid Zipkin v2 JSON under ?format=zipkin
    with urllib.request.urlopen(url + "&format=zipkin", timeout=10.0) as r:
        zk = json.load(r)
    assert {z["traceId"] for z in zk} == {tid}
    assert all(set(z) >= {"traceId", "id", "name", "timestamp", "duration"}
               for z in zk)


def test_kill_one_node_splits_shards_and_replans(three_node):
    """Kill node c: its two shards split across both survivors, and a
    query in flight across the takeover window replans exactly once."""
    engines, oracle, jeng, mgr, eps, servers, _owner = three_node
    c_shards = sorted(mgr.shards_of_node(DATASET, "c"))
    assert len(c_shards) == 2

    # node c browns out hard: server stopped, then the membership monitor
    # declares it dead concurrently with the next dispatch (the resolver
    # hook plays the monitor, as in the two-node takeover test)
    servers["c"].stop()
    dead_ep = eps.pop("c")
    state = {"failed": False, "calls": 0}

    def resolver(node):
        if node == "c":
            state["calls"] += 1
        if node == "c" and not state["failed"]:
            state["failed"] = True
            mgr.remove_node("c")
            return "127.0.0.1:1"          # nothing listens there
        return eps.get(node)

    engines["a"].endpoint_resolver = resolver
    q = "sum by (dc) (m)"
    want_res = oracle.query_range(q, *RANGE)
    want = _as_comparable(want_res)
    got_res = engines["a"].query_range(q, *RANGE)
    got = _as_comparable(got_res)
    assert state["failed"], "the dead peer was never dispatched to"
    assert state["calls"] == 1, "the query replanned more than once"
    assert got_res.exec_path == "local-replanned"
    assert got == want
    _within_bar(got, _as_comparable(jeng.query_range(q, *RANGE)), q)
    # the replan retry re-executed every leg: the first attempt's partial
    # counts (successful peers, local leaves) must not double into stats
    assert got_res.stats.to_dict()["series_matched"] \
        == want_res.stats.to_dict()["series_matched"]

    # the dead node's shards split across both survivors
    new_owner = {s: mgr.node_of(DATASET, s) for s in c_shards}
    assert set(new_owner.values()) == {"a", "b"}, (
        f"expected {c_shards} split across both survivors, got {new_owner}")
    # and steady-state queries (no replan) stay correct on the new topology
    got2_res = engines["b"].query_range(q, *RANGE)
    assert _as_comparable(got2_res) == want
    assert got2_res.exec_path == "local"
    assert dead_ep not in eps.values()


# -- the mesh against the three-node host loop -------------------------------
#
# The port's mesh folds shard partials on the host in shard order, in f64,
# seeded with shard 0's partials, and presents them through the host
# loop's presenter: its answer is the host loop's bit for bit by
# construction. Every mesh shape, on raw f32, gauge-resident (delta8) and
# off-grid f64 stores: mesh == three-node host loop == one-node oracle,
# exactly; the JAX one-node engine within the bar (bit for bit where the
# answers are integers).

MESH_IV = 10_000
MESH_N = 64
RANGE_MESH = (START + 300_000, START + 800_000, 30_000)

MESH_PARITY_QUERIES = {
    "f32": ('sum(rate(m[2m]))', 'avg by (grp) (rate(m[2m]))',
            'stddev by (grp) (rate(m[2m]))', 'max by (grp) (m)',
            'topk(2, m)', 'quantile(0.5, m)'),
    "narrow": ('sum(rate(m[2m]))', 'avg by (grp) (rate(m[2m]))',
               'stddev by (grp) (rate(m[2m]))', 'max by (grp) (m)',
               'topk(2, m)', 'quantile(0.5, m)'),
    "f64": ('sum(sum_over_time(m[2m]))', 'max by (grp) (avg_over_time(m[2m]))',
            'topk(2, rate(m[2m]))', 'quantile(0.5, rate(m[2m]))'),
}
# answers that are sample copies or sums of integer samples: the packages
# agree bit for bit
EXACT_VS_JAX = {'max by (grp) (m)', 'topk(2, m)', 'quantile(0.5, m)'}


def _mesh_parity_rows():
    rng = np.random.default_rng(16)
    # integer cumsums: exactly representable in f32 and in the narrow
    # encoders' round-trip domains (increments 1..49 fit delta8)
    return [np.cumsum(rng.integers(1, 50, MESH_N)).astype(np.float64)
            for _ in range(24)]


def _mesh_parity_fill(ms, rows, jitter=None, jax=False):
    for i, vals in enumerate(rows):
        b = JRecordBuilder(JGAUGE) if jax else RecordBuilder(GAUGE)
        for t in range(MESH_N):
            ts = START + t * MESH_IV + (int(jitter[i][t]) if jitter is not None
                                        else 0)
            b.add({"_metric_": "m", "host": f"h{i}", "grp": f"g{i % 4}"},
                  ts, float(vals[t]))
        ms.ingest(DATASET, i % NSHARDS, b.build())
    ms.flush_all()


@pytest.mark.parametrize("residency", ["f32", "narrow", "f64"])
def test_mesh_bit_parity_grid_vs_host_loop_and_oracle(residency):
    """Every mesh shape (fused / fused-narrow, twostep, topk, sketch):
    mesh == three-node host loop == one-node oracle, exactly, the route
    tagged mesh-<path>; the JAX engine within the bar."""
    kw = dict(max_series_per_shard=16, samples_per_series=MESH_N,
              flush_batch_size=10**9,
              dtype="float64" if residency == "f64" else "float32")

    def cfg():
        return StoreConfig(**kw, device="cpu", compressed_residency=(
            "gauge" if residency == "narrow" else "off"))

    rows = _mesh_parity_rows()
    jitter = (np.random.default_rng(17).integers(0, MESH_IV // 2,
                                                 (24, MESH_N))
              if residency == "f64" else None)
    mesh_ms = TimeSeriesMemStore(device="cpu")
    oracle_ms = TimeSeriesMemStore(device="cpu")
    stores = {n: TimeSeriesMemStore(device="cpu") for n in NODES}
    jms = JMemStore()
    for s in range(NSHARDS):
        mesh_ms.setup(DATASET, GAUGE, s, cfg())
        oracle_ms.setup(DATASET, GAUGE, s, cfg())
        jms.setup(DATASET, JGAUGE, s, JStoreConfig(
            **kw, narrow_resident=(residency == "narrow")))
        for n in NODES:
            stores[n].setup(DATASET, GAUGE, s, cfg())
    for ms in (mesh_ms, oracle_ms, *stores.values()):
        _mesh_parity_fill(ms, rows, jitter)
    _mesh_parity_fill(jms, rows, jitter, jax=True)
    if residency == "narrow":
        assert all(sh.store.is_narrow_resident
                   for sh in mesh_ms.shards_of(DATASET))
        # the small-integer counters land on the narrowest variant
        assert {sh.store.narrow_operands()[0]
                for sh in mesh_ms.shards_of(DATASET)} == {"delta8"}
    mesh_eng = QueryEngine(mesh_ms, DATASET, ShardMapper(NSHARDS),
                           device="cpu", mesh=["cpu"] * NSHARDS)
    oracle = QueryEngine(oracle_ms, DATASET, ShardMapper(NSHARDS),
                         device="cpu")
    jeng = JQueryEngine(jms, DATASET, JShardMapper(NSHARDS))
    engines, _eps, servers = _serve(stores, _manager())

    tags = set()
    try:
        for q in MESH_PARITY_QUERIES[residency]:
            rm = mesh_eng.query_range(q, *RANGE_MESH)
            assert rm.exec_path.startswith("mesh-"), (q, rm.exec_path)
            tags.add(rm.exec_path)
            want = _as_comparable(oracle.query_range(q, *RANGE_MESH))
            got_loop = _as_comparable(engines["a"].query_range(q,
                                                               *RANGE_MESH))
            got_mesh = _as_comparable(rm)
            assert got_loop == want, f"host loop diverged from oracle: {q!r}"
            assert got_mesh == want, f"mesh diverged from oracle: {q!r}"
            jwant = _as_comparable(jeng.query_range(q, *RANGE_MESH))
            if q in EXACT_VS_JAX and residency != "f64":
                assert got_mesh == jwant, q
            else:
                _within_bar(got_mesh, jwant, q)
    finally:
        for srv in servers.values():
            srv.stop()
    if residency != "f64":
        fused_tag = ("mesh-fused-narrow" if residency == "narrow"
                     else "mesh-fused")
        assert fused_tag in tags, tags
    assert {"mesh-twostep", "mesh-topk", "mesh-sketch"} <= tags, tags



def test_mesh_engine_i8_hist_residency_host_merges_with_parity():
    """The i8 leg of the residency matrix: 2D-delta histogram blocks
    (``compressed_residency="all"``, quiet rows take the i8 tier); the
    mesh refuses bucketed stores, so the mesh-configured engine falls back
    to the host merge cleanly (no mesh tag) and matches a no-mesh oracle
    over the identical ingests bit for bit, and the JAX engine within the
    bar."""
    import torch
    B = 8
    les = np.concatenate([2.0 ** np.arange(B - 1), [np.inf]])

    def build(jax: bool):
        ms = JMemStore() if jax else TimeSeriesMemStore(device="cpu")
        kw = dict(max_series_per_shard=16, samples_per_series=128,
                  flush_batch_size=10**9, dtype="float32",
                  compressed_residency="all")
        cfg = JStoreConfig(**kw) if jax else StoreConfig(**kw, device="cpu")
        schema = JPROM_HISTOGRAM if jax else PROM_HISTOGRAM
        for s in range(NSHARDS):
            ms.setup(DATASET, schema, s, cfg)
        rng = np.random.default_rng(7)
        for i in range(16):
            b = (JRecordBuilder if jax else RecordBuilder)(
                schema, bucket_les=les)
            c = np.cumsum(np.cumsum(rng.poisson(0.4, (96, B)), axis=0),
                          axis=1).astype(np.float64)
            for t in range(96):
                b.add({"_metric_": "h", "host": f"x{i}"},
                      START + t * MESH_IV, c[t])
            ms.ingest(DATASET, i % NSHARDS, b.build())
        ms.flush_all()
        return ms

    ms_mesh, ms_host = build(False), build(False)
    assert any(sh.store._nhist[0].dtype == torch.int8
               for sh in ms_mesh.shards_of(DATASET)
               if sh.store.is_narrow_resident)
    em = QueryEngine(ms_mesh, DATASET, ShardMapper(NSHARDS), device="cpu",
                     mesh=["cpu"] * NSHARDS)
    eo = QueryEngine(ms_host, DATASET, ShardMapper(NSHARDS), device="cpu")
    ej = JQueryEngine(build(True), DATASET, JShardMapper(NSHARDS))
    for q in ('histogram_quantile(0.9, sum(rate(h[2m])))',
              'sum(rate(h[2m]))'):
        rm = em.query_range(q, *RANGE_MESH)
        assert not rm.exec_path.startswith("mesh"), (q, rm.exec_path)
        got = _as_comparable(rm)
        assert got == _as_comparable(eo.query_range(q, *RANGE_MESH)), q
        _within_bar(got, _as_comparable(ej.query_range(q, *RANGE_MESH)), q)
