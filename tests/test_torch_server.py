"""Standalone server + aux subsystem tests: config layering, bus-driven
ingestion lifecycle with recovery (ref analog: IngestionAndRecoverySpec
multi-jvm: ingest -> kill -> recover -> query parity), metrics exposition,
tracing, profiler, on-demand paging."""

import json
import time
import urllib.request

import numpy as np
import pytest
import torch

from filodb_tpu_torch.config import Config, parse_duration_ms
from filodb_tpu_torch.core.memstore import StoreConfig, TimeSeriesMemStore
from filodb_tpu_torch.core.record import RecordBuilder
from filodb_tpu_torch.core.schemas import GAUGE
from filodb_tpu_torch.core.store import FileColumnStore
from filodb_tpu_torch.ingest.bus import FileBus
from filodb_tpu_torch.standalone import FiloServer

BASE = 1_700_000_000_000
IV = 10_000


def test_config_layering(tmp_path):
    p = tmp_path / "server.json"
    p.write_text(json.dumps({"num_shards": 4, "store": {"dtype": "float64"}}))
    cfg = Config.load(str(p), {"store": {"samples_per_series": 77}})
    assert cfg["num_shards"] == 4
    assert cfg["store.dtype"] == "float64"
    assert cfg["store.samples_per_series"] == 77
    assert cfg["store.flush_batch_size"] == 65536       # default survives
    sc = cfg.store_config()
    assert sc.retention_ms == parse_duration_ms("3h")
    assert parse_duration_ms("90s") == 90_000


def test_metrics_registry_and_exposition():
    from filodb_tpu_torch.utils.metrics import MetricsRegistry
    reg = MetricsRegistry()
    reg.counter("filodb_rows", {"shard": "0"}).increment(5)
    reg.gauge("filodb_series").update(42)
    reg.histogram("filodb_latency_ms").record(12.5)
    text = reg.expose_prometheus()
    assert 'filodb_rows_total{shard="0"} 5' in text
    assert "filodb_series 42" in text
    assert 'le="25"' in text and "filodb_latency_ms_count 1" in text


def test_tracing_spans_nest():
    from filodb_tpu_torch.utils.tracing import Tracer
    tr = Tracer()
    with tr.span("query", dataset="ds"):
        with tr.span("leaf"):
            pass
    spans = tr.drain()
    assert [s.name for s in spans] == ["leaf", "query"]
    assert spans[0].parent_id == spans[1].span_id
    assert spans[0].trace_id == spans[1].trace_id
    assert spans[1].to_zipkin()["tags"] == {"dataset": "ds"}


def test_profiler_collects_samples():
    from filodb_tpu_torch.utils.profiler import SimpleProfiler
    prof = SimpleProfiler(interval_s=0.01).start()
    t0 = time.time()
    while time.time() - t0 < 0.3:
        sum(i * i for i in range(1000))
    prof.stop()
    rep = prof.report()
    assert "samples" in rep and len(rep.splitlines()) > 1


def _publish_demo(bus_dir, n_batches=6, start_batch=0):
    bus = FileBus(f"{bus_dir}/shard0.log")
    for i in range(start_batch, start_batch + n_batches):
        b = RecordBuilder(GAUGE)
        for t in range(10):
            for s in range(3):
                b.add({"_metric_": "m", "host": f"h{s}"},
                      BASE + (i * 10 + t) * IV, float(s * 100 + i * 10 + t))
        bus.publish(b.build())
    return bus


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}") as r:
        return json.load(r)


def test_server_end_to_end_with_recovery(tmp_path):
    cfg_dict = {
        "num_shards": 1,
        "data_dir": str(tmp_path / "data"),
        "bus_dir": str(tmp_path / "bus"),
        "http": {"port": 0},
        "store": {"max_series_per_shard": 16, "samples_per_series": 256,
                  "flush_batch_size": 1000000000, "groups_per_shard": 2,
                  "dtype": "float64"},
    }
    _publish_demo(str(tmp_path / "bus"))
    server = FiloServer(Config(cfg_dict), device="cpu").start()
    try:
        for _ in range(100):
            st = _get(server.http.port, "/api/v1/cluster/status")
            sh = st["data"]["datasets"]["prometheus"]["0"]
            if sh["status"] == "Active":
                break
            time.sleep(0.05)
        assert sh["status"] == "Active"
        # wait for ingestion of the published batches
        deadline = time.time() + 10
        while time.time() < deadline:
            q = _get(server.http.port,
                     "/promql/prometheus/api/v1/query_range?query=count(m)"
                     f"&start={(BASE // 1000) + 550}&end={(BASE // 1000) + 590}&step=15s")
            if q["data"]["result"]:
                break
            time.sleep(0.2)
        assert q["data"]["result"][0]["values"][0][1] == "3"
        metrics = urllib.request.urlopen(
            f"http://127.0.0.1:{server.http.port}/metrics").read().decode()
        assert "filodb_ingested_rows_total" in metrics
        assert "filodb_shard_status" in metrics
    finally:
        server.shutdown()

    # "crash": new server over the same data dir + bus; publish more batches
    _publish_demo(str(tmp_path / "bus"), n_batches=2, start_batch=6)
    server2 = FiloServer(Config(cfg_dict), device="cpu").start()
    try:
        deadline = time.time() + 10
        got = None
        while time.time() < deadline:
            q = _get(server2.http.port,
                     "/promql/prometheus/api/v1/query_range?"
                     "query=sum_over_time(m%7Bhost%3D%22h1%22%7D%5B2m%5D)"
                     f"&start={(BASE // 1000) + 700}&end={(BASE // 1000) + 790}&step=30s")
            if q["data"]["result"]:
                got = q["data"]["result"][0]["values"]
                break
            time.sleep(0.2)
        assert got, "no data after recovery"
        # full continuity: samples from before AND after the restart —
        # snapshot under the shard lock: the server's consumer thread flushes
        # concurrently and a flush DONATES the store buffers mid-read
        shard = server2.memstore.shard("prometheus", 0)
        with shard.lock:
            t0, _ = shard.store.series_snapshot(0)
        assert len(t0) == 80                     # 8 batches x 10 samples
    finally:
        server2.shutdown()


def test_on_demand_paging(tmp_path):
    """Data older than memory retention is paged from the sink at query time."""
    sink = FileColumnStore(str(tmp_path))
    ms = TimeSeriesMemStore(device="cpu")
    cfg = StoreConfig(max_series_per_shard=4, samples_per_series=32,
                      flush_batch_size=10**9, groups_per_shard=1,
                      retention_ms=200_000, dtype="float64")
    shard = ms.setup("prometheus", GAUGE, 0, cfg, sink=sink)
    b = RecordBuilder(GAUGE)
    for t in range(30):
        b.add({"_metric_": "m", "host": "h0"}, BASE + t * IV, float(t))
    shard.ingest(b.build(), offset=0)
    shard.flush_all_groups()
    # force eviction of the first 20 samples from memory
    shard.store.compact(BASE + 20 * IV)
    t_mem, _ = shard.store.series_snapshot(0)
    assert len(t_mem) == 10
    from filodb_tpu_torch.query.engine import QueryEngine
    eng = QueryEngine(ms, "prometheus", device="cpu")
    r = eng.query_range('sum_over_time(m{host="h0"}[1m])',
                        BASE + 60_000, BASE + 290_000, 30_000)
    (key, ts, vals), = list(r.matrix.iter_series())
    # first query point covers only evicted samples -> must come from the sink
    from .prom_reference import eval_range_fn
    tgrid = BASE + np.arange(30) * IV
    want = eval_range_fn("sum_over_time", tgrid, np.arange(30.0),
                         np.arange(BASE + 60_000, BASE + 290_001, 30_000), 60_000)
    np.testing.assert_allclose(vals, want[~np.isnan(want)])


def test_wide_on_demand_paging_batches(tmp_path, monkeypatch):
    """Selections wider than one paging batch stream through in bounded-memory
    pid batches whose per-batch results merge (previously a hard QueryError;
    ref: OnDemandPagingShard.scala:58 pages any width)."""
    import filodb_tpu_torch.query.exec as qe
    monkeypatch.setattr(qe, "ODP_BATCH", 64)
    sink = FileColumnStore(str(tmp_path))
    ms = TimeSeriesMemStore(device="cpu")
    N = 200
    cfg = StoreConfig(max_series_per_shard=256, samples_per_series=32,
                      flush_batch_size=10**9, groups_per_shard=1,
                      retention_ms=200_000, dtype="float64")
    shard = ms.setup("prometheus", GAUGE, 0, cfg, sink=sink)
    b = RecordBuilder(GAUGE)
    for t in range(30):
        for i in range(N):
            b.add({"_metric_": "m", "host": f"h{i}"}, BASE + t * IV, float(t))
    shard.ingest(b.build(), offset=0)
    shard.flush_all_groups()
    shard.store.compact(BASE + 20 * IV)     # early samples now sink-only
    from filodb_tpu_torch.query.engine import QueryEngine
    eng = QueryEngine(ms, "prometheus", device="cpu")
    # aggregated: partials merge across batches
    r = eng.query_range("sum(count_over_time(m[1m]))",
                        BASE + 60_000, BASE + 290_000, 30_000)
    (_k, ts, vals), = list(r.matrix.iter_series())
    np.testing.assert_allclose(vals, 7.0 * N)   # 7 samples per 1m window, all series
    # per-series: matrices concatenate across batches
    r = eng.query_range("last_over_time(m[1m])",
                        BASE + 60_000, BASE + 90_000, 30_000)
    assert r.matrix.num_series == N
    # order statistics: partials merge across batches too
    r = eng.query_range("topk(3, sum_over_time(m[1m]))",
                        BASE + 60_000, BASE + 90_000, 30_000)
    assert r.matrix.num_series <= 3


def test_server_inline_downsample_and_cascade(tmp_path):
    """downsample.enabled wires the inline flush publisher (durable 1m
    datasets) and the periodic cascade produces the coarser family."""
    cfg = {
        "num_shards": 1,
        "data_dir": str(tmp_path / "data"),
        "bus_dir": str(tmp_path / "bus"),
        "http": {"port": 0},
        "downsample": {"enabled": True, "resolutions": ["1m", "5m"],
                       "cascade_interval": "300ms"},
        "store": {"max_series_per_shard": 8, "samples_per_series": 720,
                  "flush_batch_size": 10**9, "groups_per_shard": 1,
                  "dtype": "float64"},
    }
    bus = FileBus(str(tmp_path / "bus" / "shard0.log"))
    # two separate bus batches -> two poll-driven ingest/flush cycles: the
    # streaming downsampler must still emit each 1m bucket exactly once,
    # with the mid-bucket split invisible in the output
    b = RecordBuilder(GAUGE)
    for t in range(63):
        b.add({"_metric_": "m", "host": "h0"}, BASE + t * IV, float(t))
    bus.publish(b.build())
    server = FiloServer(Config(cfg), device="cpu").start()
    try:
        deadline = time.time() + 40
        while time.time() < deadline:
            sh = server.memstore.shard("prometheus", 0)
            if sh.stats.rows_ingested >= 63:
                break
            time.sleep(0.1)
        b = RecordBuilder(GAUGE)
        for t in range(63, 120):   # 20 minutes of 10s data in total
            b.add({"_metric_": "m", "host": "h0"}, BASE + t * IV, float(t))
        bus.publish(b.build())
        deadline = time.time() + 40
        while time.time() < deadline:
            if sh.stats.rows_ingested >= 120:
                break
            time.sleep(0.1)
        sh.flush_all_groups()       # inline publisher fires at group flush
        sink = FileColumnStore(str(tmp_path / "data"))
        # ONE multi-column family dataset per resolution: dAvg is a column
        cols_1m = sink.read_meta("prometheus:ds_1m", 0)["columns"]
        one_m = [r for _g, recs in sink.read_chunksets("prometheus:ds_1m", 0)
                 for r in recs]
        assert one_m, "inline 1m downsample not published"
        ts_1m = np.concatenate([r.ts for r in one_m])
        assert len(ts_1m) == len(np.unique(ts_1m)), "duplicate 1m buckets"
        v_1m = np.concatenate([np.asarray(r.values)[:, cols_1m.index("dAvg")]
                               for r in one_m])
        for bts, bv in zip(ts_1m, v_1m):
            sel = (BASE + np.arange(120) * IV) // 60_000 == bts // 60_000
            np.testing.assert_allclose(bv, np.arange(120.0)[sel].mean())
        keys = list(sink.read_part_keys("prometheus:ds_1m", 0))
        assert keys and keys[0][1].get("host") == "h0"
        deadline = time.time() + 40
        five_m = []
        while time.time() < deadline and not five_m:
            five_m = [r for _g, recs in
                      sink.read_chunksets("prometheus:ds_5m", 0)
                      for r in recs]
            time.sleep(0.2)
        assert five_m, "cascade 5m downsample never ran"
        cols_5m = sink.read_meta("prometheus:ds_5m", 0)["columns"]
        # weighted 5m averages match a direct computation over complete buckets
        ts_all = np.concatenate([r.ts for r in five_m])
        v_all = np.concatenate([np.asarray(r.values)[:, cols_5m.index("dAvg")]
                                for r in five_m])
        raw_ts = BASE + np.arange(120) * IV
        raw_v = np.arange(120.0)
        for bts, bv in zip(ts_all, v_all):
            sel = raw_ts // 300_000 == bts // 300_000
            np.testing.assert_allclose(bv, raw_v[sel].mean())
    finally:
        server.shutdown()


def test_server_retention_routing_and_raw_ttl(tmp_path):
    """retention.* config reachability end-to-end: the router lands on the
    raw engine, the serving refresh publishes the family engine, HTTP
    queries route (auto + &resolution= override, resolution in response
    stats), and the raw_ttl age-out loop trims the durable raw log while
    bumping data_epoch."""
    cfg = {
        "num_shards": 1,
        "data_dir": str(tmp_path / "data"),
        "bus_dir": str(tmp_path / "bus"),
        "http": {"port": 0},
        "downsample": {"enabled": True, "resolutions": ["1m"],
                       "serve_interval": "300ms"},
        "retention": {"routing": True, "resolutions": ["raw", "1m"],
                      "raw_ttl": "10m", "compact_interval": "400ms"},
        "store": {"max_series_per_shard": 8, "samples_per_series": 720,
                  "flush_batch_size": 10**9, "groups_per_shard": 1,
                  "retention": "5m", "dtype": "float64"},
    }
    bus = FileBus(str(tmp_path / "bus" / "shard0.log"))
    n = 121                                   # 20 minutes of 10s data
    b = RecordBuilder(GAUGE)
    for t in range(n):
        b.add({"_metric_": "m", "host": "h0"}, BASE + t * IV, float(t))
    bus.publish(b.build())
    server = FiloServer(Config(cfg), device="cpu").start()
    try:
        eng = server.engines["prometheus"]
        assert eng.retention is not None
        assert eng.retention.policy.labels() == ["raw", "1m"]
        sh = server.memstore.shard("prometheus", 0)
        deadline = time.time() + 40
        while time.time() < deadline and sh.stats.rows_ingested < n:
            time.sleep(0.1)
        sh.flush_all_groups()                 # inline 1m publish
        # wait for the family serving view to appear
        deadline = time.time() + 40
        while time.time() < deadline \
                and "prometheus:ds_1m" not in server.engines:
            time.sleep(0.1)
        assert "prometheus:ds_1m" in server.engines
        lead = BASE + (n - 1) * IV
        port = server.http.port
        url = (f"http://127.0.0.1:{port}/promql/prometheus/api/v1/"
               f"query_range?query=sum(avg_over_time(m[2m]))"
               f"&start={BASE / 1000}&end={lead / 1000}&step=60")
        with urllib.request.urlopen(url) as r:
            body = json.load(r)
        # the range spans past the 5m raw window: stitched 1m body + raw tail
        assert body["stats"]["resolution"] == "1m+raw"
        with urllib.request.urlopen(url + "&resolution=raw") as r:
            assert json.load(r)["stats"]["resolution"] == "raw"
        with urllib.request.urlopen(url + "&resolution=1m") as r:
            assert json.load(r)["stats"]["resolution"] == "1m"
        # raw_ttl age-out: the durable raw log trims past lead - 10m and the
        # watermark epoch moves so cached results invalidate
        sink = FileColumnStore(str(tmp_path / "data"))
        deadline = time.time() + 40
        aged = False
        while time.time() < deadline and not aged:
            mins = [int(r.ts[0]) for _g, recs in
                    sink.read_chunksets("prometheus", 0) for r in recs]
            aged = bool(mins) and min(mins) >= lead - parse_duration_ms("10m")
            time.sleep(0.2)
        assert aged, "raw_ttl age-out never trimmed the durable log"
    finally:
        server.shutdown()


# ---------------------------------------------------------------------------
# across packages: a port FiloServer and a JAX FiloServer of the same config
# consuming the same broker answer the same queries over HTTP
# ---------------------------------------------------------------------------

XQUERIES = ("sum(rate(m[5m]))", "sum by (dc) (rate(m[5m]))",
            "avg_over_time(m[5m])", "count(m)", "max(m)",
            "topk(3, rate(m[5m]))")
XSERIES = 24                  # a shard
XSAMPLES = 60


def _x_containers(part, lo, hi):
    """Integer counters of shard ``part``, samples [lo, hi) on a 10 s grid."""
    rng = np.random.default_rng(40 + part)
    incs = rng.integers(0, 20, (XSERIES, XSAMPLES))
    vals = np.cumsum(incs, axis=1).astype(float)
    b = RecordBuilder(GAUGE)
    for i in range(XSERIES):
        b.add_batch({"_metric_": "m", "host": f"p{part}h{i}",
                     "dc": f"dc{i % 3}"},
                    BASE + np.arange(lo, hi, dtype=np.int64) * IV,
                    vals[i, lo:hi])
    return b.build()


def _x_config(tmp, name, addr):
    return {"num_shards": 2, "bus_addr": addr, "http": {"port": 0},
            "data_dir": str(tmp / name),
            "store": {"max_series_per_shard": 64, "samples_per_series": 128,
                      "flush_batch_size": 10**9, "groups_per_shard": 2},
            "query": {"result_cache_size": 0, "negative_cache_size": 0,
                      "fragment_cache_size": 0}}


def _x_query(port, q, kind="query_range"):
    import urllib.parse
    if kind == "query_range":
        params = {"query": q, "start": (BASE + 300_000) / 1000,
                  "end": (BASE + (XSAMPLES - 1) * IV) / 1000, "step": "30s"}
    else:
        # inside the data either side of the restart
        params = {"query": q, "time": (BASE + (XSAMPLES // 2 - 1) * IV)
                  / 1000}
    return _get(port, f"/promql/prometheus/api/v1/{kind}?"
                + urllib.parse.urlencode(params))["data"]


def _x_same(got, want, what):
    """Same series and steps; values bit for bit where integer-valued,
    else within rtol 1e-5 of the answer's largest magnitude."""
    assert got["resultType"] == want["resultType"], what
    g = {json.dumps(r["metric"], sort_keys=True): r.get("values")
         or [r["value"]] for r in got["result"]}
    w = {json.dumps(r["metric"], sort_keys=True): r.get("values")
         or [r["value"]] for r in want["result"]}
    assert set(g) == set(w) and w, what
    scale = max(abs(float(v)) for vals in w.values() for _t, v in vals
                if np.isfinite(float(v)))
    for k, wv in w.items():
        assert [t for t, _ in g[k]] == [t for t, _ in wv], (what, k)
        a = np.array([float(v) for _, v in g[k]])
        b = np.array([float(v) for _, v in wv])
        if np.all(b[np.isfinite(b)] == np.round(b[np.isfinite(b)])):
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * scale,
                                       equal_nan=True, err_msg=f"{what} {k}")


def _x_wait_rows(port, rows, last, deadline_s=60):
    """Until every one of ``rows`` samples, the last at sample index
    ``last``, answers."""
    import urllib.parse
    q = urllib.parse.urlencode({"query": "sum(count_over_time(m[1h]))",
                                "time": (BASE + last * IV) / 1000})
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        res = _get(port, f"/promql/prometheus/api/v1/query?{q}")["data"][
            "result"]
        if res and float(res[0]["value"][1]) == rows:
            return
        time.sleep(0.1)
    raise AssertionError(f"{rows} rows never became queryable: {res}")


@pytest.fixture()
def jax_server_globals():
    """A JAX FiloServer sets process-global modes at start; restore them."""
    from filodb_tpu.ops import fusedresident as jfr
    from filodb_tpu.utils import diagnostics as jdiag
    from filodb_tpu.utils.tracing import tracer as jtracer
    saved = (jfr.mode(), jdiag.enabled, jtracer.enabled,
             jtracer.sample_rate)
    try:
        yield
    finally:
        jfr.set_mode(saved[0])
        jdiag.enabled = saved[1]
        jtracer.enabled, jtracer.sample_rate = saved[2], saved[3]


def test_port_and_jax_servers_answer_alike_before_and_after_restart(
        tmp_path, jax_server_globals):
    from filodb_tpu.config import Config as JConfig
    from filodb_tpu.standalone import FiloServer as JFiloServer
    from filodb_tpu_torch.ingest.broker import BrokerBus, BrokerServer
    broker = BrokerServer(str(tmp_path / "broker"), 2).start()
    addr = f"127.0.0.1:{broker.port}"
    servers = []

    def publish(lo, hi):
        for p in (0, 1):
            bus = BrokerBus(addr, p)
            try:
                bus.publish(_x_containers(p, lo, hi))
            finally:
                bus.close()

    def start_both():
        t = FiloServer(Config(_x_config(tmp_path, "port", addr)),
                       device="cpu").start()
        servers.append(t)
        j = JFiloServer(JConfig(_x_config(tmp_path, "jax", addr))).start()
        servers.append(j)
        return t, j

    def compare(t, j, what):
        for q in XQUERIES:
            _x_same(_x_query(t.http.port, q), _x_query(j.http.port, q),
                    f"{what} {q}")
        _x_same(_x_query(t.http.port, "sum(rate(m[5m]))", "query"),
                _x_query(j.http.port, "sum(rate(m[5m]))", "query"), what)
        for path in ("/promql/prometheus/api/v1/label/dc/values",
                     "/promql/prometheus/api/v1/labels"):
            assert _get(t.http.port, path)["data"] \
                == _get(j.http.port, path)["data"], path

    try:
        publish(0, XSAMPLES // 2)
        t, j = start_both()
        for s in (t, j):
            _x_wait_rows(s.http.port, 2 * XSERIES * (XSAMPLES // 2),
                         XSAMPLES // 2 - 1)
        compare(t, j, "live")
        # a range inside the first half: it must answer the same after
        # the restart, bit for bit
        first = ("/promql/prometheus/api/v1/query_range?query=sum(rate(m"
                 f"%5B1m%5D))&start={(BASE + 100_000) / 1000}"
                 f"&end={(BASE + 290_000) / 1000}&step=30s")
        before = _get(t.http.port, first)["data"]
        assert before["result"]
        for s in (t, j):
            s.shutdown()
            servers.remove(s)
        # a crash with the second half on the bus: both recover from their
        # sinks and replay the broker past their checkpoints
        publish(XSAMPLES // 2, XSAMPLES)
        t, j = start_both()
        for s in (t, j):
            _x_wait_rows(s.http.port, 2 * XSERIES * XSAMPLES, XSAMPLES - 1)
        compare(t, j, "recovered")
        assert _get(t.http.port, first)["data"] == before
    finally:
        for s in servers:
            s.shutdown()
        broker.stop()


def test_filoserver_without_a_card_raises():
    from filodb_tpu_torch.device import DeviceUnavailable
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves to it")
    with pytest.raises(DeviceUnavailable):
        FiloServer(Config({"http": {"port": 0}}))
    with pytest.raises(DeviceUnavailable):
        FiloServer(Config({"http": {"port": 0}}), device="cuda")
    srv = FiloServer(Config({"http": {"port": 0}}), device="cpu")
    assert srv.device.type == "cpu" and srv.memstore.device.type == "cpu"
    assert srv._shard_device(3).type == "cpu"


@pytest.mark.parametrize("device_type,pinned,ncards,num_shards,n_owned,want", [
    ("cuda", False, 4, 8, 8, 4),     # every shard owned, divisible: mesh
    ("cuda", False, 2, 2, 2, 2),
    ("cuda", False, 1, 4, 4, 0),     # one card: the host loop
    ("cuda", True, 4, 8, 8, 0),      # cuda:k pins every shard to card k
    ("cuda", False, 4, 8, 4, 0),     # peer-owned shards: no mesh
    ("cuda", False, 4, 2, 2, 0),     # indivisible over the cards
    ("cuda", False, 4, 1, 1, 0),     # one shard
    ("cpu", False, 0, 8, 8, 0),
])
def test_shard_placement_and_mesh_are_one_decision(device_type, pinned, ncards,
                                                   num_shards, n_owned, want):
    """Shards spread over the cards exactly when the mesh is built: an
    unpinned ``cuda`` server, more than one card, every shard owned, the
    shards divisible over the cards. Otherwise every shard stays on the
    server's device."""
    from filodb_tpu_torch.standalone import mesh_cards
    assert mesh_cards(device_type, pinned, ncards, num_shards,
                      n_owned) == want


def test_trace_sampling_and_the_zipkin_reporter():
    """``trace.sample_rate`` decides at the root (a sampled-out trace
    records nothing, its children included); ``trace.zipkin_endpoint``'s
    reporter ships the spans newer than its watermark, once each, in the
    Zipkin v2 shape, leaving the ring to the debug plane."""
    import threading
    from http.server import BaseHTTPRequestHandler, HTTPServer

    from filodb_tpu_torch.utils.tracing import Tracer, ZipkinReporter
    got = []

    class Collector(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            got.append(json.loads(self.rfile.read(
                int(self.headers["Content-Length"]))))
            self.send_response(202)
            self.end_headers()

    http = HTTPServer(("127.0.0.1", 0), Collector)
    t = threading.Thread(target=http.serve_forever, daemon=True)
    t.start()
    try:
        tr = Tracer()
        tr.sample_rate = 0.0
        with tr.span("query"):
            with tr.span("query.execute"):
                pass
        assert tr.snapshot() == []
        tr.sample_rate = 1.0
        with tr.span("query", dataset="p"):
            with tr.span("query.execute"):
                pass
        rep = ZipkinReporter(
            tr, f"http://127.0.0.1:{http.server_address[1]}/api/v2/spans")
        assert rep.tick() == 2 and rep.tick() == 0
        assert [s["name"] for s in got[0]] == ["query.execute", "query"]
        assert got[0][1]["tags"] == {"dataset": "p"}
        assert len(tr.snapshot()) == 2
        with tr.span("ingest.consume"):
            pass
        assert rep.tick() == 1 and len(got) == 2
    finally:
        http.shutdown()
        http.server_close()
        t.join(timeout=5)
