"""The port's Prometheus HTTP API against the JAX package's, on the CPU.

The same seeded integer counters go into a port node and a JAX node; each
serves its engine through its own FiloHttpServer. The routes answer alike:
query_range and query JSON (byte for byte where the values are exact),
labels, label values (``counts=1``, ``top_k``), series, epochs (with the
``log=1`` form the fragment cache's peers read), /metrics, /__health,
/api/v1/cluster/status, the debug pages and the subscription long poll.
Then the error mapping (422, 503 with Retry-After on an admission shed,
503 when the scheduler is busy, 504 on a timeout, 429 from the
cardinality governor, 404s) and the trace context: one query over two port
nodes is one trace, with the peer's serve span under the caller's
dispatch span.
"""

import json
import urllib.error
import urllib.parse
import urllib.request
from concurrent.futures import TimeoutError as FuturesTimeout

import numpy as np
import pytest

from filodb_tpu.core.memstore import StoreConfig as JStoreConfig
from filodb_tpu.core.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.core.record import RecordBuilder as JRecordBuilder
from filodb_tpu.core.schemas import GAUGE as JGAUGE
from filodb_tpu.http.api import FiloHttpServer as JHttpServer
from filodb_tpu.query.engine import QueryEngine as JQueryEngine
from filodb_tpu_torch.core.cardinality import SeriesQuotaExceeded
from filodb_tpu_torch.core.memstore import StoreConfig, TimeSeriesMemStore
from filodb_tpu_torch.core.record import RecordBuilder
from filodb_tpu_torch.core.schemas import GAUGE
from filodb_tpu_torch.http.api import FiloHttpServer, matrix_to_prom_json
from filodb_tpu_torch.parallel.cluster import ShardManager
from filodb_tpu_torch.parallel.shardmapper import ShardMapper
from filodb_tpu_torch.query.engine import QueryConfig, QueryEngine
from filodb_tpu_torch.query.scheduler import SchedulerBusy
from filodb_tpu_torch.utils.tracing import (SPAN_QUERY_DISPATCH,
                                            SPAN_QUERY_SERVE, tracer)

DS = "prometheus"
START = 1_000_000
IV = 10_000
CELLS = 60


def _rows():
    rng = np.random.default_rng(3)
    return [({"_metric_": "m", "host": f"h{s}", "dc": f"dc{s % 2}"},
             np.cumsum(rng.integers(0, 9, CELLS)).astype(float))
            for s in range(6)]


def _build(jax):
    kw = dict(max_series_per_shard=16, samples_per_series=64,
              flush_batch_size=10**9)
    if jax:
        ms, rb, schema = JMemStore(), JRecordBuilder, JGAUGE
        for sh in (0, 1):
            ms.setup(DS, schema, sh, JStoreConfig(**kw))
    else:
        ms, rb, schema = TimeSeriesMemStore(device="cpu"), RecordBuilder, GAUGE
        for sh in (0, 1):
            ms.setup(DS, schema, sh, StoreConfig(**kw, device="cpu"))
    ts = START + np.arange(CELLS, dtype=np.int64) * IV
    for s, (labels, vals) in enumerate(_rows()):
        b = rb(schema)
        b.add_batch(labels, ts, vals)
        ms.ingest(DS, s % 2, b.build())
    ms.flush_all()
    return ms


@pytest.fixture(scope="module")
def servers():
    teng = QueryEngine(_build(False), DS, device="cpu")
    jeng = JQueryEngine(_build(True), DS)
    tsrv = FiloHttpServer({DS: teng}, port=0).start()
    jsrv = JHttpServer({DS: jeng}, port=0).start()
    try:
        yield tsrv, jsrv, teng
    finally:
        tsrv.stop()
        jsrv.stop()


def _get(srv, path, params=(), raw=False):
    qs = urllib.parse.urlencode(list(params))
    url = f"http://127.0.0.1:{srv.port}{path}" + (f"?{qs}" if qs else "")
    with urllib.request.urlopen(url, timeout=30) as r:
        body = r.read()
    return body if raw else json.loads(body)


def _err(srv, path, params=()):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(srv, path, params)
    return ei.value.code, json.load(ei.value), ei.value.headers


QR = [("start", str((START + 300_000) / 1000)),
      ("end", str((START + 590_000) / 1000)), ("step", "30s")]
EXACT_QUERIES = ["m", "count(m)", "sum by (dc) (m)", "max(m)",
                 "count_values(\"v\", count by (dc) (m))", "topk(2, m)"]


@pytest.mark.parametrize("query", EXACT_QUERIES)
def test_query_json_equals_the_reference(servers, query):
    tsrv, jsrv, _ = servers
    path = f"/promql/{DS}/api/v1/query_range"
    t = _get(tsrv, path, [("query", query)] + QR)
    j = _get(jsrv, path, [("query", query)] + QR)
    assert t["data"] == j["data"]
    assert t["stats"]["series_matched"] == j["stats"]["series_matched"]
    path = f"/promql/{DS}/api/v1/query"
    inst = [("query", query), ("time", str((START + 400_000) / 1000))]
    assert _get(tsrv, path, inst)["data"] == _get(jsrv, path, inst)["data"]


def test_query_json_is_matrix_to_prom_json(servers):
    tsrv, _jsrv, teng = servers
    got = _get(tsrv, f"/promql/{DS}/api/v1/query_range",
               [("query", "rate(m[2m])")] + QR)["data"]
    want = matrix_to_prom_json(teng.query_range(
        "rate(m[2m])", START + 300_000, START + 590_000, 30_000))
    assert got == json.loads(json.dumps(want))


@pytest.mark.parametrize("path,params", [
    ("labels", []),
    ("labels", [("match[]", '{dc="dc0"}')]),
    ("label/host/values", []),
    ("label/__name__/values", []),
    ("label/host/values", [("match[]", '{dc="dc1"}')]),
    ("label/dc/values", [("counts", "1")]),
    ("label/host/values", [("top_k", "2"), ("counts", "1")]),
    ("series", [("match[]", "m"), ("start", "0"), ("end", "99999")]),
    ("series", [("match[]", '{host=~"h[12]"}'),
                ("match[]", '{dc="dc0"}')]),
])
def test_metadata_routes_equal_the_reference(servers, path, params):
    tsrv, jsrv, _ = servers
    full = f"/promql/{DS}/api/v1/{path}"
    t, j = _get(tsrv, full, params), _get(jsrv, full, params)
    if path == "series":
        key = lambda rows: sorted(tuple(sorted(r.items())) for r in rows)  # noqa: E731
        assert key(t["data"]) == key(j["data"])
    else:
        assert t == j


def test_epochs_health_status_and_metrics(servers):
    tsrv, jsrv, teng = servers
    for srv in (tsrv, jsrv):
        assert _get(srv, "/__health") == {"status": "healthy"}
    plain = _get(tsrv, f"/promql/{DS}/api/v1/epochs")["data"]
    assert plain == {str(s.shard_num): s.data_epoch
                     for s in teng.memstore.shards_of(DS)}
    logged = _get(tsrv, f"/promql/{DS}/api/v1/epochs", [("log", "1")])["data"]
    for s in teng.memstore.shards_of(DS):
        ep, lg = s.epoch_state()
        assert logged[str(s.shard_num)] == [ep, [list(x) for x in lg]]
    assert _get(tsrv, "/api/v1/cluster/status") == \
        _get(jsrv, "/api/v1/cluster/status")
    text = _get(tsrv, "/metrics", raw=True).decode()
    assert f'filodb_shard_num_series{{dataset="{DS}",shard="0"}} 3' in text
    assert "filodb_query_latency_ms_count" in text
    code, body, _ = _err(tsrv, "/promql/nope/api/v1/query",
                         [("query", "m"), ("time", "1")])
    assert code == 404
    assert _err(tsrv, "/nowhere")[0] == 404


def test_debug_pages(servers):
    tsrv, _jsrv, _ = servers
    _get(tsrv, f"/promql/{DS}/api/v1/query_range", [("query", "sum(m)")] + QR)
    traces = _get(tsrv, "/api/v1/debug/traces", [("limit", "5")])["data"]
    assert traces and traces[0]["spans"][0]["name"] == "query"
    tid = traces[0]["trace_id"]
    zipkin = _get(tsrv, "/api/v1/debug/traces", [("format", "zipkin"),
                                                 ("trace_id", tid)])
    assert zipkin and all(s["traceId"] == tid for s in zipkin)
    assert isinstance(_get(tsrv, "/api/v1/debug/slow_queries")["data"], list)
    assert _get(tsrv, "/api/v1/debug/fragment_cache")["data"] == {}
    assert _get(tsrv, "/api/v1/debug/profile")["data"]["running"] is False
    assert _err(tsrv, "/api/v1/debug/profile", [("action", "start")])[0] == 404
    assert _err(tsrv, "/api/v1/rules")[0] == 404
    assert _err(tsrv, "/api/v1/debug/nope")[0] == 404


def test_subscribe_long_poll(servers):
    tsrv, _jsrv, teng = servers
    base = f"/promql/{DS}/api/v1/subscribe"
    body = _get(tsrv, base, [("query", "sum(m)"), ("step", "30"),
                             ("timeout", "5")])
    assert body["status"] == "success" and body["data"]["result"]
    nxt = body["next_since"]
    empty = _get(tsrv, base, [("query", "sum(m)"), ("step", "30"),
                              ("since", str(nxt)), ("timeout", "0.05")])
    assert empty["data"] is None and empty["next_since"] == nxt
    assert _err(tsrv, base, [("step", "30")])[0] == 422


class _Raising:
    """An engine whose queries raise ``exc``: the error mapping alone."""

    def __init__(self, exc):
        self.exc = exc
        self.memstore = TimeSeriesMemStore(device="cpu")
        self.dataset = DS

    def query_range(self, *a, **kw):
        raise self.exc

    query_instant = query_range


@pytest.mark.parametrize("exc,code,etype,retry", [
    (SchedulerBusy("full"), 503, "unavailable", None),
    (FuturesTimeout(), 504, "timeout", None),
    (SeriesQuotaExceeded("t1", 3, retry_after_s=2.5), 429,
     "too_many_series", "3"),
    (ValueError("boom"), 500, "internal", None),
])
def test_error_mapping(exc, code, etype, retry):
    srv = FiloHttpServer({DS: _Raising(exc)}, port=0).start()
    try:
        got, body, headers = _err(srv, f"/promql/{DS}/api/v1/query",
                                  [("query", "m"), ("time", "1")])
        assert (got, body["errorType"]) == (code, etype)
        assert headers.get("Retry-After") == retry
    finally:
        srv.stop()


def test_bad_query_is_422_and_admission_shed_is_503():
    ms = _build(False)
    eng = QueryEngine(ms, DS, device="cpu",
                      config=QueryConfig(max_concurrent_cost=1.0,
                                         shed_retry_after_s=2.2))
    srv = FiloHttpServer({DS: eng}, port=0).start()
    try:
        code, body, _ = _err(srv, f"/promql/{DS}/api/v1/query_range",
                             [("query", "rate(m)")] + QR)
        assert (code, body["errorType"]) == (422, "bad_data")
        # a cost over the whole budget is never admissible: 422; a shed
        # under load is 503 with the controller's hint
        code, body, _ = _err(srv, f"/promql/{DS}/api/v1/query_range",
                             [("query", "sum(rate(m[2m]))")] + QR)
        assert code == 422
        eng.admission.max_cost = 10**12
        eng.admission._in_use = 10**12
        code, body, headers = _err(srv, f"/promql/{DS}/api/v1/query_range",
                                   [("query", "sum(rate(m[2m]))")] + QR)
        assert (code, body["errorType"]) == (503, "unavailable")
        assert headers["Retry-After"] == "3"
    finally:
        srv.stop()


def test_one_trace_across_two_nodes():
    """A query over two port nodes records one trace: the caller's
    dispatch span parents the peer's serve span (the X-Filo-Trace header),
    and a peer's leaf spans join it."""
    mgr = ShardManager()
    mgr.add_node("a")
    mgr.add_node("b")
    mgr.add_dataset(DS, 2)
    owner = {s: mgr.node_of(DS, s) for s in (0, 1)}
    full = _build(False)
    eps = {}
    engines = {}
    for n in ("a", "b"):
        ms = TimeSeriesMemStore(device="cpu")
        for s in (0, 1):
            if owner[s] == n:
                ms._shards[(DS, s)] = full.shard(DS, s)
                ms._dataset_schema[DS] = GAUGE
        engines[n] = QueryEngine(ms, DS, ShardMapper(2), device="cpu",
                                 cluster=mgr, node=n,
                                 endpoint_resolver=eps.get)
    servers = {n: FiloHttpServer({DS: engines[n]}, port=0).start()
               for n in ("a", "b")}
    eps.update({n: f"127.0.0.1:{s.port}" for n, s in servers.items()})
    try:
        r = engines["a"].query_range("sum(rate(m[2m]))", START + 300_000,
                                     START + 590_000, 30_000)
        assert r.stats.series_matched == 6
        (trace,) = tracer.traces(limit=1)
        spans = {s["span_id"]: s for s in trace["spans"]}
        serve = [s for s in spans.values() if s["name"] == SPAN_QUERY_SERVE]
        assert len(serve) == 1 and serve[0]["tags"]["node"] == "b"
        parent = spans[serve[0]["parent_id"]]
        assert parent["name"] == SPAN_QUERY_DISPATCH
        assert parent["tags"]["endpoint"] == eps["b"]
        assert spans[trace["spans"][0]["span_id"]]["name"] == "query"
        # a malformed trace header is ignored: the peer roots its own trace
        assert tracer._valid_id("abc123") and not tracer._valid_id('x"}')
    finally:
        for s in servers.values():
            s.stop()


def test_queries_run_through_the_scheduler_lanes(servers):
    """With a QueryScheduler, query and metadata work runs on its lanes
    and answers as on the handler thread."""
    from filodb_tpu_torch.query.scheduler import QueryScheduler
    tsrv, _jsrv, teng = servers
    sched = QueryScheduler(num_threads=2)
    srv = FiloHttpServer({DS: teng}, port=0, scheduler=sched).start()
    before = sched.stats()["completed"]
    try:
        for path, params in ((f"/promql/{DS}/api/v1/query_range",
                              [("query", "sum by (dc) (m)")] + QR),
                             (f"/promql/{DS}/api/v1/label/host/values", [])):
            got = _get(srv, path, params)
            assert got["data"] == _get(tsrv, path, params)["data"]
        assert sched.stats()["completed"] - before == 2
    finally:
        srv.stop()
        sched.shutdown()
