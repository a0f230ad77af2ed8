"""Ingest-plane pipeline tests (PR 4): concurrent multi-connection gateway
parity, broker publish windowing (round-trip accounting), parse-error
surfacing, timed flush, and the consumer's decode-ahead double buffer."""

import math
import socket
import threading
import time
from collections import Counter

import numpy as np
import pytest

from filodb_tpu_torch.core.record import RecordBuilder
from filodb_tpu_torch.core.schemas import GAUGE, Schemas
from filodb_tpu_torch.ingest.broker import BrokerBus, BrokerServer
from filodb_tpu_torch.ingest.gateway import GatewayServer, InfluxParseError

BASE = 1_700_000_000


def _lines(n, n_series=37):
    return [f"cpu,host=h{i % n_series},dc=us-east "
            f"usage={i}.5,idle={i % 7}i {(BASE + i) * 1_000_000}"
            for i in range(n)]


def _row_multisets(published):
    """per-shard multiset of (canonical part key, ts, value) rows."""
    out = {}
    for shard, c in published:
        keys, _ = c.resolved_keys()
        ms = out.setdefault(shard, Counter())
        for i in range(len(c)):
            ms[(keys[int(c.part_idx[i])], int(c.ts[i]),
                float(c.values[i]))] += 1
    return out


def test_gateway_concurrent_multiconn_parity():
    """N client sockets publishing interleaved lines produce bit-identical
    per-shard row multisets to the same lines ingested serially."""
    lines = _lines(600)
    serial = []
    gw_s = GatewayServer(lambda s, c: serial.append((s, c)), num_shards=4,
                         flush_lines=97, flush_interval_ms=0)
    for ln in lines:
        gw_s.ingest_line(ln)
    gw_s.flush()
    want = _row_multisets(serial)
    assert sum(len(c) for _, c in serial) == 2 * len(lines)  # 2 fields/line

    got = []
    gw = GatewayServer(lambda s, c: got.append((s, c)), num_shards=4,
                       flush_lines=97, flush_interval_ms=50, port=0).start()
    try:
        slices = [lines[k::4] for k in range(4)]

        def send(sl):
            with socket.create_connection(("127.0.0.1", gw.port)) as s:
                for ln in sl:
                    s.sendall((ln + "\n").encode())

        threads = [threading.Thread(target=send, args=(sl,)) for sl in slices]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        deadline = time.time() + 15
        while time.time() < deadline:
            if sum(len(c) for _, c in got) == 2 * len(lines):
                break
            time.sleep(0.02)
    finally:
        gw.stop()
    assert _row_multisets(got) == want


def _store_rows(ms, dataset, nshards):
    """per-shard {labels: ((ts, value), ...)} read back from the DEVICE
    store — the actual store contents, not the published containers."""
    out = {}
    for s in range(nshards):
        try:
            sh = ms.shard(dataset, s)
        except KeyError:
            continue
        sh.flush()
        st = sh.store
        if st is None:
            continue
        rows = {}
        with sh.lock:
            ts = np.asarray(st.ts)
            val = np.asarray(st.val)
            for pid in np.flatnonzero(np.asarray(st.n_host) > 0):
                n = int(st.n_host[pid])
                labels = tuple(sorted(sh.index.labels_of(int(pid)).items()))
                rows[labels] = tuple(zip(ts[pid][:n].tolist(),
                                         val[pid][:n].tolist()))
        out[s] = rows
    return out


def test_gateway_concurrent_store_contents_parity():
    """The satellite's strong form: N client sockets each owning a distinct
    set of series (the sharded-agent shape — per-series sample order is
    preserved per connection) must produce bit-identical STORE contents to
    the same lines ingested serially."""
    from filodb_tpu_torch.core.memstore import StoreConfig, TimeSeriesMemStore

    n_conns, per_conn, n_samples = 4, 3, 60
    conn_lines = []
    for k in range(n_conns):
        ls = []
        for t in range(n_samples):
            for j in range(per_conn):
                i = k * per_conn + j
                ls.append(f"cpu,host=h{i},dc=east usage={t}.25 "
                          f"{(BASE + t) * 1_000_000_000}")
        conn_lines.append(ls)
    cfg = StoreConfig(max_series_per_shard=32, samples_per_series=128,
                      flush_batch_size=10**9, dtype="float64")

    def make_store():
        ms = TimeSeriesMemStore(device="cpu")
        for s in range(4):
            ms.setup("ds", GAUGE, s, cfg)
        return ms

    ms_serial = make_store()
    gw_s = GatewayServer(lambda s, c: ms_serial.ingest("ds", s, c),
                         num_shards=4, flush_lines=37, flush_interval_ms=0)
    for ls in conn_lines:
        for ln in ls:
            gw_s.ingest_line(ln)
    gw_s.flush()
    want = _store_rows(ms_serial, "ds", 4)
    assert sum(len(r) for r in want.values()) == n_conns * per_conn

    ms_conc = make_store()
    gw = GatewayServer(lambda s, c: ms_conc.ingest("ds", s, c),
                       num_shards=4, flush_lines=37, flush_interval_ms=50,
                       port=0).start()
    try:
        def send(ls):
            with socket.create_connection(("127.0.0.1", gw.port)) as s:
                s.sendall(("\n".join(ls) + "\n").encode())

        threads = [threading.Thread(target=send, args=(ls,))
                   for ls in conn_lines]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        total = n_conns * per_conn * n_samples
        deadline = time.time() + 15
        while time.time() < deadline:
            got = _store_rows(ms_conc, "ds", 4)
            if sum(len(v) for r in got.values() for v in r.values()) == total:
                break
            time.sleep(0.05)
    finally:
        gw.stop()
    assert got == want


def test_publish_window_round_trip_smoke(tmp_path):
    """CI smoke (fast): publishing F frames with window W costs at most
    ceil(F/W) broker round trips — asserted via the bus's request counter."""
    srv = BrokerServer(str(tmp_path / "b"), num_partitions=1).start()
    try:
        W, F = 16, 100
        bus = BrokerBus(f"127.0.0.1:{srv.port}", partition=0,
                        publish_window=W)
        conts = [_container(i) for i in range(F)]
        before = bus.requests
        for c in conts[:F // 2]:
            bus.publish_async(c)
        offs = bus.publish_batch(conts[F // 2:])
        assert bus.requests - before <= math.ceil(F / W)
        assert sorted(offs)[-1] == F - 1 and bus.end_offset == F
        # everything is replayable and distinct
        got = list(bus.consume(Schemas()))
        assert len(got) == F
        assert {c.label_sets[0]["i"] for _, c in got} == \
            {str(i) for i in range(F)}
        bus.close()
    finally:
        srv.stop()


def _container(i, n=4):
    b = RecordBuilder(GAUGE)
    for t in range(n):
        b.add({"_metric_": "m", "i": str(i)}, BASE * 1000 + t * 1000, float(t))
    return b.build()


def test_gateway_parse_errors_counted_and_sampled():
    from filodb_tpu_torch.utils.metrics import registry
    gw = GatewayServer(lambda s, c: None, num_shards=2, flush_interval_ms=0)
    ctr = registry.counter("filodb_gateway_parse_errors")
    before = ctr.value
    gw.ingest_line("cpu,host=h1 usage=1.5 1700000000000000000")   # fine
    gw.ingest_line("garbage without equals")
    gw.ingest_line("cpu,host= =broken")
    assert ctr.value - before == 2
    assert gw.last_parse_error is not None
    assert "broken" in gw.last_parse_error      # latest offender sampled


def test_gateway_strict_mode_raises():
    gw = GatewayServer(lambda s, c: None, num_shards=2, strict=True,
                       flush_interval_ms=0)
    with pytest.raises(InfluxParseError):
        gw.ingest_line("garbage without equals")


def test_gateway_timed_flush_delivers_low_rate_shards():
    """A trickle far below flush_lines still lands within ~the flush
    interval — the time bound of the size-or-time flush policy."""
    got = []
    gw = GatewayServer(lambda s, c: got.append((s, c)), num_shards=2,
                       flush_lines=10**9, flush_interval_ms=50).start()
    try:
        gw.ingest_line("mem,host=h1 value=1.0 1700000000000000000")
        deadline = time.time() + 10
        while not got and time.time() < deadline:
            time.sleep(0.01)
    finally:
        gw.stop()
    assert got and len(got[0][1]) == 1


def test_decode_ahead_yields_all_and_propagates_errors():
    from filodb_tpu_torch.standalone import _DecodeAhead

    items = [(i, f"c{i}") for i in range(100)]
    assert list(_DecodeAhead(iter(items), depth=3)) == items

    def broken():
        yield from items[:5]
        raise ConnectionError("bus gone")

    src = _DecodeAhead(broken(), depth=2)
    got = []
    with pytest.raises(ConnectionError):
        for item in src:
            got.append(item)
    src.close()
    assert got == items[:5]     # everything before the fault was delivered


def test_decode_ahead_ends_when_fill_thread_dies_without_sentinel():
    """The timed-get consumer (runtime twin of live-wait-no-timeout): a
    fill thread that dies without managing to enqueue its end sentinel —
    killed process pool, interpreter teardown — must not park the consumer
    forever. The bounded get re-checks producer liveness and ends the
    stream instead."""
    import queue

    from filodb_tpu_torch.standalone import _DecodeAhead

    src = _DecodeAhead(iter([]), depth=2)
    src._thread.join(timeout=5.0)
    assert not src._thread.is_alive()
    # simulate the unclean death: swallow the sentinel the thread DID
    # write, leaving an empty queue and a dead producer
    while True:
        try:
            src._q.get_nowait()
        except queue.Empty:
            break
    t0 = time.monotonic()
    with pytest.raises(StopIteration):
        src.__next__()
    assert time.monotonic() - t0 < 5.0      # bounded, not parked forever


def test_config_wired_gateway_end_to_end(tmp_path):
    """ingest.gateway_port wires the Influx TCP gateway into FiloServer:
    lines in over TCP, PromQL out over HTTP — through the windowed broker
    publish path and the decode-ahead consumer."""
    from filodb_tpu_torch.config import Config
    from filodb_tpu_torch.standalone import FiloServer

    broker = BrokerServer(str(tmp_path / "broker"), num_partitions=2).start()
    srv = None
    try:
        cfg = Config({
            "num_shards": 2,
            "bus_addr": f"127.0.0.1:{broker.port}",
            "http": {"port": 0},
            "ingest": {"gateway_port": 0, "publish_window": 8,
                       "gateway_flush_lines": 32,
                       "gateway_flush_interval": "50ms"},
            "store": {"max_series_per_shard": 64, "samples_per_series": 256,
                      "flush_batch_size": 10**9},
        })
        srv = FiloServer(cfg, device="cpu").start()
        assert srv.gateway is not None and srv.gateway.port
        with socket.create_connection(("127.0.0.1", srv.gateway.port)) as s:
            for i in range(120):
                s.sendall(f"heap_usage,host=h{i % 6} value={i}.5 "
                          f"{(BASE + i) * 1_000_000_000}\n".encode())
        eng = srv.engines["prometheus"]
        deadline = time.time() + 20
        while time.time() < deadline:
            r = eng.query_instant("count(heap_usage)", (BASE + 120) * 1000)
            if r.matrix.num_series and \
                    float(np.asarray(r.matrix.values)[0, 0]) == 6.0:
                break
            time.sleep(0.25)
        else:
            raise AssertionError("gateway lines never became queryable")
    finally:
        if srv:
            srv.shutdown()
        broker.stop()


def test_windowed_producer_to_consumer_end_to_end(tmp_path):
    """A windowed producer feeding a FiloServer through the broker: the
    decode-ahead consumer ingests everything, and queries see the data —
    durability/ordering semantics unchanged by the batched publish path."""
    from filodb_tpu_torch.config import Config
    from filodb_tpu_torch.standalone import FiloServer

    broker = BrokerServer(str(tmp_path / "broker"), num_partitions=1).start()
    srv = None
    try:
        cfg = Config({
            "num_shards": 1,
            "bus_addr": f"127.0.0.1:{broker.port}",
            "http": {"port": 0},
            "ingest": {"publish_window": 8, "decode_ahead": 2},
            "store": {"max_series_per_shard": 64, "samples_per_series": 64,
                      "flush_batch_size": 10**9},
        })
        srv = FiloServer(cfg, device="cpu").start()
        prod = BrokerBus(f"127.0.0.1:{broker.port}", 0, publish_window=8)
        prod.publish_batch([_container(i) for i in range(20)])
        prod.close()
        eng = srv.engines["prometheus"]
        deadline = time.time() + 15
        while time.time() < deadline:
            r = eng.query_instant("count(m)", BASE * 1000 + 3_000)
            if r.matrix.num_series and \
                    float(np.asarray(r.matrix.values)[0, 0]) == 20.0:
                break
            time.sleep(0.25)
        else:
            raise AssertionError("windowed publishes never became queryable")
    finally:
        if srv:
            srv.shutdown()
        broker.stop()


def test_gateway_stop_drains_builders_and_publish_window(tmp_path):
    """Shutdown parity (ISSUE 6 satellite): lines accepted before stop()
    must ALL be on the broker log after stop() returns — stop flushes
    pending per-connection builders AND drains the windowed publisher's
    sub-window remainder (no acked-but-unflushed lines)."""
    srv = BrokerServer(str(tmp_path / "b"), 1).start()
    try:
        bus = BrokerBus(f"127.0.0.1:{srv.port}", 0, publish_window=64)
        # size/time flushes disabled: ONLY the stop() path may deliver
        gw = GatewayServer(lambda s, c: bus.publish_async(c), num_shards=1,
                           flush_lines=10**9, flush_interval_ms=0,
                           port=0).start()
        gw.bus_drain = bus.flush_publishes
        n = 57
        with socket.create_connection(("127.0.0.1", gw.port)) as s:
            for i in range(n):
                s.sendall(f"mem,host=h{i % 9} value={i}.0 "
                          f"{(BASE + i) * 1_000_000_000}\n".encode())
        gw.stop()
        # every line is durably on the broker before stop() returned
        rows = sum(len(c) for _, c in bus.consume(Schemas()))
        assert rows == n
        assert srv._parts[0].end_offset > 0
        bus.close()
    finally:
        srv.stop()


def _assert_port_released(host, port, timeout_s=5.0):
    """The LISTENER must be gone: a live listen socket fails this bind for
    the whole window, while transient teardown states of severed
    connections (TIME_WAIT/CLOSE_WAIT under suite load) clear within it."""
    deadline = time.monotonic() + timeout_s
    while True:
        probe = socket.socket()
        probe.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            probe.bind((host, port))
            return
        except OSError:
            if time.monotonic() >= deadline:
                raise
            time.sleep(0.1)
        finally:
            probe.close()


def test_gateway_and_broker_deterministic_stop(tmp_path):
    """PR-5 lifecycle satellite: stop() shuts the server down, releases the
    listening socket, and JOINS the serve/flusher threads — the port is
    immediately rebindable and no thread outlives the stop."""
    published = []
    gw = GatewayServer(lambda s, c: published.append((s, c)), num_shards=2,
                       flush_interval_ms=50).start()
    host, port = "127.0.0.1", gw.port
    with socket.create_connection((host, port), timeout=5) as s:
        s.sendall(_lines(3)[0].encode() + b"\n")
    gw.flush()
    gw.stop()
    assert gw._serve_thread is None and gw._flusher is None
    _assert_port_released(host, port)

    brk = BrokerServer(str(tmp_path / "broker"), num_partitions=1).start()
    bport = brk.port
    serve_thread = brk._thread
    bus = BrokerBus(f"127.0.0.1:{bport}", 0)
    b = RecordBuilder(GAUGE)
    b.add({"_metric_": "m", "host": "h0"}, BASE * 1000, 1.0)
    bus.publish(b.build())
    brk.stop()
    assert brk._thread is None and not serve_thread.is_alive()
    _assert_port_released("127.0.0.1", bport)
    bus.close()


# ---------------------------------------------------------------------------
# across packages: the port's gateway against the JAX package's on one line
# corpus
# ---------------------------------------------------------------------------

def _line_corpus(seed=5, n_series=40, n_samples=12):
    """Influx lines a scrape fleet sends: repeated heads (the route memo's
    case), several fields a line, integer fields, escaped tag values,
    string fields (no sample), tags in varying order, a line without a
    timestamp, and malformed lines (counted drops)."""
    rng = np.random.default_rng(seed)
    lines = []
    for t in range(n_samples):
        ts = (1_700_000_000 + 10 * t) * 1_000_000_000
        for i in range(n_series):
            v = float(rng.integers(0, 10_000)) / 8
            if i % 5 == 0:
                lines.append(f"cpu,host=h{i},dc=dc{i % 3} usage={v},"
                             f"idle={int(v)}i {ts}")
            elif i % 5 == 1:
                lines.append(f"mem,dc=dc{i % 3},host=h{i} value={v} {ts}")
            elif i % 5 == 2:
                lines.append(f"disk,host=h\\ {i},path=/var\\,log "
                             f"used={v},note=\"xy\" {ts}")
            elif i % 5 == 3:
                lines.append(f"net,host=h{i},_ws_=demo,_ns_=app "
                             f"rx={v},tx={v * 2} {ts}")
            else:
                lines.append(f"mem,host=h{i},dc=dc{i % 3} value={-v} {ts}")
        lines += [f"bad line without fields {t}", f"cpu,host=x usage= {t}",
                  "", "# a comment",
                  f"cpu,host=h0 usage=1.0 notatime{t}"]
    lines.append("cpu,host=late usage=3.5")          # no timestamp
    lines.append("cpu,host=r,__rule__=g/r value=1 1700000000000000000")
    return lines


def _run_gateway(gw_cls, lines, num_shards=8, flush_lines=37):
    got = []
    gw = gw_cls(lambda shard, c: got.append((shard, c.to_bytes())),
                num_shards=num_shards, spread=2, flush_lines=flush_lines,
                flush_interval_ms=0)
    for ln in lines:
        gw.ingest_line(ln)
    gw.flush()
    return got, gw


def test_gateway_rows_equal_the_jax_gateway_on_one_corpus():
    """Parsed rows, their shard routing, container batching and every
    container's bytes equal the JAX gateway's; so do the dropped-line count
    and the sampled offender."""
    from filodb_tpu.ingest.gateway import GatewayServer as JGatewayServer
    from filodb_tpu.ingest.gateway import parse_influx_line as jparse
    from filodb_tpu_torch.ingest.gateway import parse_influx_line
    from filodb_tpu_torch.utils.metrics import (FILODB_GATEWAY_PARSE_ERRORS,
                                                registry)
    lines = _line_corpus()
    for ln in lines:
        try:
            want = jparse(ln)
        except ValueError:
            with pytest.raises(ValueError):
                parse_influx_line(ln)
            continue
        assert parse_influx_line(ln) == want, ln
    errs = registry.counter(FILODB_GATEWAY_PARSE_ERRORS)
    e0 = errs.value
    got, gw = _run_gateway(GatewayServer, lines)
    want, jgw = _run_gateway(JGatewayServer, lines)
    assert got == want
    assert len({s for s, _ in got}) > 4          # spread over the shards
    # every non-blank line that does not parse, and the spoofed rules tag
    assert errs.value - e0 == sum(
        1 for ln in lines if ln.strip() and not _parses(jparse, ln)) + 1
    assert gw.last_parse_error == jgw.last_parse_error
    # per-shard rows decode to the same samples in either package
    from filodb_tpu.core.record import RecordContainer as JRecordContainer
    from filodb_tpu.core.schemas import Schemas as JSchemas
    from filodb_tpu_torch.core.record import RecordContainer
    for (_s, tb), (_sj, jb) in zip(got, want):
        t = RecordContainer.from_bytes(tb, Schemas())
        j = JRecordContainer.from_bytes(jb, JSchemas())
        np.testing.assert_array_equal(t.ts, j.ts)
        np.testing.assert_array_equal(t.values, j.values)
        assert list(t.label_sets) == list(j.label_sets)


def _parses(parse, ln) -> bool:
    try:
        parse(ln)
        return True
    except ValueError:
        return False


def test_gateway_route_memo_serves_repeated_heads_identically():
    """The second pass over the same heads resolves every (series, field)
    from the route memo; its containers equal the first pass's and the JAX
    gateway's second pass."""
    from filodb_tpu.ingest.gateway import GatewayServer as JGatewayServer
    lines = [ln for ln in _line_corpus(n_samples=4)
             if "\\" not in ln and '"' not in ln]
    out = {}
    for name, cls in (("port", GatewayServer), ("jax", JGatewayServer)):
        got = []
        gw = cls(lambda shard, c: got.append((shard, c.to_bytes())),
                 num_shards=8, spread=2, flush_lines=10**9,
                 flush_interval_ms=0)
        for ln in lines:
            gw.ingest_line(ln)
        gw.flush()
        first = list(got)
        memo = sum(len(v) for v in gw._routes.values())
        assert memo > 0
        got.clear()
        for ln in lines:
            gw.ingest_line(ln)
        gw.flush()
        assert sum(len(v) for v in gw._routes.values()) == memo
        out[name] = (first, list(got))
    assert out["port"] == out["jax"]
    # the memo-hit pass builds the same rows as the cold one
    assert [s for s, _ in out["port"][0]] == [s for s, _ in out["port"][1]]
