"""TCP log broker tests (ref analog: kafka SourceSinkSuite — publish/consume
round trips, seek-to-checkpoint replay, one shard == one partition)."""

import contextlib
import threading

import numpy as np
import pytest

from filodb_tpu_torch.core.record import RecordBuilder, RecordContainer
from filodb_tpu_torch.core.schemas import GAUGE, Schemas
from filodb_tpu_torch.ingest.broker import BrokerBus, BrokerServer

BASE = 1_700_000_000_000


def make_container(tag: str, n=5):
    b = RecordBuilder(GAUGE)
    for t in range(n):
        b.add({"_metric_": "m", "tag": tag}, BASE + t * 1000, float(t))
    return b.build()


@pytest.fixture()
def broker(tmp_path):
    srv = BrokerServer(str(tmp_path / "broker"), num_partitions=4).start()
    yield srv
    srv.stop()


def test_publish_consume_roundtrip(broker):
    bus = BrokerBus(f"127.0.0.1:{broker.port}", partition=0)
    offs = [bus.publish(make_container(f"c{i}")) for i in range(5)]
    assert offs == [0, 1, 2, 3, 4]
    assert bus.end_offset == 5
    got = list(bus.consume(Schemas()))
    assert [o for o, _ in got] == offs
    assert got[2][1].label_sets[0]["tag"] == "c2"
    np.testing.assert_array_equal(got[0][1].values, make_container("c0").values)
    bus.close()


def test_seek_to_checkpoint_replay(broker):
    bus = BrokerBus(f"127.0.0.1:{broker.port}", partition=1)
    for i in range(10):
        bus.publish(make_container(f"c{i}"))
    # a restarting consumer replays from its watermark, not from 0
    got = [o for o, _ in bus.consume(Schemas(), from_offset=7)]
    assert got == [7, 8, 9]
    assert list(bus.consume(Schemas(), from_offset=10)) == []
    bus.close()


def test_partitions_are_independent(broker):
    b0 = BrokerBus(f"127.0.0.1:{broker.port}", partition=0)
    b2 = BrokerBus(f"127.0.0.1:{broker.port}", partition=2)
    b0.publish(make_container("p0"))
    assert b2.end_offset == 0
    b2.publish(make_container("p2"))
    (_, c0), = list(b0.consume(Schemas()))
    (_, c2), = list(b2.consume(Schemas()))
    assert c0.label_sets[0]["tag"] == "p0"
    assert c2.label_sets[0]["tag"] == "p2"
    b0.close(), b2.close()


def test_concurrent_producers(broker):
    def produce(tag):
        bus = BrokerBus(f"127.0.0.1:{broker.port}", partition=3)
        for i in range(20):
            bus.publish(make_container(f"{tag}-{i}", n=2))
        bus.close()

    threads = [threading.Thread(target=produce, args=(f"t{k}",)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    bus = BrokerBus(f"127.0.0.1:{broker.port}", partition=3)
    got = list(bus.consume(Schemas()))
    assert len(got) == 80
    assert [o for o, _ in got] == list(range(80))     # dense offsets, no loss
    tags = {c.label_sets[0]["tag"] for _, c in got}
    assert len(tags) == 80
    bus.close()


def test_broker_durability_across_restart(broker, tmp_path):
    bus = BrokerBus(f"127.0.0.1:{broker.port}", partition=0)
    for i in range(4):
        bus.publish(make_container(f"gen1-{i}"))
    bus.close()
    broker.stop()
    srv2 = BrokerServer(str(tmp_path / "broker"), num_partitions=4).start()
    try:
        bus2 = BrokerBus(f"127.0.0.1:{srv2.port}", partition=0)
        assert bus2.end_offset == 4
        assert bus2.publish(make_container("gen2")) == 4
        got = [c.label_sets[0]["tag"] for _, c in bus2.consume(Schemas())]
        assert got == [f"gen1-{i}" for i in range(4)] + ["gen2"]
        bus2.close()
    finally:
        srv2.stop()


def test_bad_partition_is_an_error(broker):
    bus = BrokerBus(f"127.0.0.1:{broker.port}", partition=99)
    with pytest.raises(RuntimeError, match="no partition"):
        bus.publish(make_container("x"))
    bus.close()


def test_server_ingests_from_broker(tmp_path):
    """End-to-end: FiloServer consumes broker partitions as its ingestion bus
    (bus_addr config), a producer publishes, queries see the data."""
    import time

    from filodb_tpu_torch.config import Config
    from filodb_tpu_torch.standalone import FiloServer

    broker = BrokerServer(str(tmp_path / "broker"), num_partitions=2).start()
    srv = None
    try:
        cfg = Config({
            "num_shards": 2,
            "bus_addr": f"127.0.0.1:{broker.port}",
            "data_dir": str(tmp_path / "data"),
            "http": {"port": 0},
            "store": {"max_series_per_shard": 16, "samples_per_series": 64,
                      "flush_batch_size": 10**9},
        })
        srv = FiloServer(cfg, device="cpu").start()
        prod0 = BrokerBus(f"127.0.0.1:{broker.port}", partition=0)
        prod1 = BrokerBus(f"127.0.0.1:{broker.port}", partition=1)
        prod0.publish(make_container("s0", n=20))
        prod1.publish(make_container("s1", n=20))
        deadline = time.time() + 10
        eng = srv.engines["prometheus"]
        while time.time() < deadline:
            r = eng.query_instant("count(m)", BASE + 19_000)
            if r.matrix.num_series and float(np.asarray(r.matrix.values)[0, 0]) == 2.0:
                break
            time.sleep(0.25)
        else:
            raise AssertionError("broker-fed ingestion never became queryable")
        prod0.close(), prod1.close()
    finally:
        if srv:
            srv.shutdown()
        broker.stop()


def test_publish_retry_is_idempotent(broker):
    """A retry after a lost response (same publish id) must not duplicate the
    frame — the broker replays the original offset."""
    from filodb_tpu_torch.ingest.broker import OP_PUBLISH
    bus = BrokerBus(f"127.0.0.1:{broker.port}", partition=0)
    payload = make_container("x").to_bytes()
    off1, _ = bus._request(OP_PUBLISH, offset=42, plen=len(payload), payload=payload)
    off2, _ = bus._request(OP_PUBLISH, offset=42, plen=len(payload), payload=payload)
    assert off1 == off2
    assert bus.end_offset == 1
    # a different id is a genuine new publish
    off3, _ = bus._request(OP_PUBLISH, offset=43, plen=len(payload), payload=payload)
    assert off3 == 1
    bus.close()


def test_publish_batch_window_and_parity(broker):
    """publish_batch ships F frames in ceil(F/W) PUBLISH_BATCH round trips;
    the replayed log is identical to per-round-trip publishes."""
    import math
    bus = BrokerBus(f"127.0.0.1:{broker.port}", partition=0, publish_window=7)
    conts = [make_container(f"b{i}", n=3) for i in range(23)]
    before = bus.requests
    offs = bus.publish_batch(conts)
    assert offs == list(range(23))
    assert bus.requests - before == math.ceil(23 / 7)
    got = list(bus.consume(Schemas()))
    assert [o for o, _ in got] == list(range(23))
    for (_, c), want in zip(got, conts):
        assert c.label_sets == want.label_sets
        np.testing.assert_array_equal(c.values, want.values)
    # async publishes drain on flush_publishes, offsets continue densely
    for i in range(5):
        bus.publish_async(make_container(f"a{i}", n=2))
    assert bus.flush_publishes() == [23, 24, 25, 26, 27]
    assert bus.flush_publishes() == []            # idempotent when drained
    assert bus.end_offset == 28
    bus.close()


def test_publish_batch_retry_is_idempotent(broker):
    """Replaying a whole batch with the SAME publish ids (the lost-response
    shape) returns the original offsets and appends nothing."""
    import struct

    from filodb_tpu_torch.ingest.broker import _ENTRY, OP_PUBLISH_BATCH
    bus = BrokerBus(f"127.0.0.1:{broker.port}", partition=1)

    def send_batch(entries):
        payload = b"".join(_ENTRY.pack(pid, len(f)) + f for pid, f in entries)
        _, body = bus._request(OP_PUBLISH_BATCH, offset=len(entries),
                               plen=len(payload), payload=payload)
        return list(struct.unpack(f"<{len(entries)}Q", body))

    entries = [(1000 + i, make_container(f"r{i}").to_bytes())
               for i in range(6)]
    first = send_batch(entries)
    assert first == list(range(6))
    assert send_batch(entries) == first           # full replay: no appends
    assert send_batch(entries[3:]) == first[3:]   # partial replay too
    assert bus.end_offset == 6
    bus.close()


def test_recent_ids_eviction_oldest_first_and_reconnect(tmp_path):
    """Publish-retry idempotence survives BOTH eviction pressure (eviction is
    oldest-first, and a retry hit refreshes recency) and a client reconnect
    (ids live on the broker, not the connection)."""
    import struct

    from filodb_tpu_torch.ingest.broker import _ENTRY, OP_PUBLISH_BATCH
    srv = BrokerServer(str(tmp_path / "b"), num_partitions=1,
                       recent_ids_max=16).start()
    try:
        bus = BrokerBus(f"127.0.0.1:{srv.port}", partition=0)

        def send_batch(entries):
            payload = b"".join(_ENTRY.pack(pid, len(f)) + f
                               for pid, f in entries)
            _, body = bus._request(OP_PUBLISH_BATCH, offset=len(entries),
                                   plen=len(payload), payload=payload)
            return list(struct.unpack(f"<{len(entries)}Q", body))

        keep = make_container("keep").to_bytes()
        (koff,) = send_batch([(7, keep)])
        # fill the id window to capacity-1 with other ids, then RETRY the
        # tracked id — the retry must hit (nothing evicted it yet) and
        # refresh its recency
        send_batch([(100 + i, make_container(f"f{i}").to_bytes())
                    for i in range(15)])
        assert send_batch([(7, keep)]) == [koff]
        # now push MORE ids past capacity: eviction is oldest-first, so the
        # just-refreshed id survives while ids 100.. are evicted
        send_batch([(200 + i, make_container(f"g{i}").to_bytes())
                    for i in range(12)])
        assert send_batch([(7, keep)]) == [koff]
        end_before = bus.end_offset
        # reconnect: the retry still resolves to the original offset
        bus.close()
        assert send_batch([(7, keep)]) == [koff]
        assert bus.end_offset == end_before
        # an id that WAS evicted (oldest) re-appends — the documented bound
        f0 = make_container("f0").to_bytes()
        (off2,) = send_batch([(100, f0)])
        assert off2 == end_before
        bus.close()
    finally:
        srv.stop()


def test_consumer_survives_broker_outage(tmp_path):
    """A broker restart must not kill shard ingestion: the consumer backs off,
    reports ERROR while disconnected, and resumes when the broker returns."""
    import socket
    import time

    from filodb_tpu_torch.config import Config
    from filodb_tpu_torch.parallel.cluster import ShardStatus
    from filodb_tpu_torch.standalone import FiloServer

    with socket.socket() as s:                   # reserve a reusable port
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    broker = BrokerServer(str(tmp_path / "broker"), num_partitions=1,
                          port=port).start()
    srv = None
    try:
        cfg = Config({
            "num_shards": 1, "bus_addr": f"127.0.0.1:{port}",
            "http": {"port": 0},
            "store": {"max_series_per_shard": 16, "samples_per_series": 64,
                      "flush_batch_size": 10**9},
        })
        srv = FiloServer(cfg, device="cpu").start()
        prod = BrokerBus(f"127.0.0.1:{port}", 0)
        prod.publish(make_container("before", n=10))
        prod.close()

        def wait_count(expect, deadline_s=15):
            eng = srv.engines["prometheus"]
            deadline = time.time() + deadline_s
            while time.time() < deadline:
                r = eng.query_instant("count(m)", BASE + 9_000)
                if r.matrix.num_series and \
                        float(np.asarray(r.matrix.values)[0, 0]) == expect:
                    return
                time.sleep(0.25)
            raise AssertionError(f"never saw count == {expect}")

        wait_count(1.0)
        broker.stop()
        deadline = time.time() + 15              # consumer notices the outage
        while time.time() < deadline:
            snap = srv.manager.snapshot("prometheus")
            if snap[0]["status"] == ShardStatus.ERROR.value:
                break
            time.sleep(0.25)
        else:
            raise AssertionError("shard never reported ERROR during outage")
        broker2 = BrokerServer(str(tmp_path / "broker"), num_partitions=1,
                               port=port).start()
        try:
            prod = BrokerBus(f"127.0.0.1:{port}", 0)
            prod.publish(make_container("after", n=10))
            prod.close()
            wait_count(2.0)                      # resumed and caught up
            assert srv.manager.snapshot("prometheus")[0]["status"] == \
                ShardStatus.ACTIVE.value
        finally:
            broker2.stop()
    finally:
        if srv:
            srv.shutdown()
        with contextlib.suppress(Exception):
            broker.stop()


# ---------------------------------------------------------------------------
# across packages: the port's broker and client against the JAX package's.
# The same containers must cross either way, and the two packages' brokers
# must write the same bytes (partition logs and pub-id journals).
# ---------------------------------------------------------------------------

def _both_containers(i: int, n: int = 6):
    """The same samples built by the JAX package's RecordBuilder and by the
    port's; their wire bytes must be identical."""
    from filodb_tpu.core.record import RecordBuilder as JRecordBuilder
    from filodb_tpu.core.schemas import GAUGE as JGAUGE
    rng = np.random.default_rng(100 + i)
    vals = np.cumsum(rng.integers(0, 50, n)).astype(float)
    out = []
    for builder in (JRecordBuilder(JGAUGE), RecordBuilder(GAUGE)):
        for s in range(3):
            builder.add_batch({"_metric_": "m", "host": f"h{i}-{s}",
                               "dc": f"dc{s % 2}"},
                              BASE + np.arange(n, dtype=np.int64) * 10_000,
                              vals + s)
        out.append(builder.build())
    jc, tc = out
    assert jc.to_bytes() == tc.to_bytes()
    return jc, tc


def _deterministic_ids(monkeypatch, *bus_classes):
    """Publish ids from a counter, the same sequence for every class (the
    ids are random per publish otherwise)."""
    import itertools
    for cls in bus_classes:
        it = itertools.count(1 << 40)
        monkeypatch.setattr(cls, "_pub_id",
                            staticmethod(lambda _it=it: next(_it)))


def test_port_bus_against_a_jax_broker(tmp_path):
    from filodb_tpu.core.schemas import Schemas as JSchemas
    from filodb_tpu.ingest.broker import BrokerBus as JBrokerBus
    from filodb_tpu.ingest.broker import BrokerServer as JBrokerServer
    srv = JBrokerServer(str(tmp_path / "jax"), num_partitions=2).start()
    try:
        addr = f"127.0.0.1:{srv.port}"
        pairs = [_both_containers(i) for i in range(7)]
        bus = BrokerBus(addr, 1, publish_window=3)
        try:
            assert bus.publish(pairs[0][1]) == 0
            assert sorted(bus.publish_batch([t for _, t in pairs[1:]])) \
                == list(range(1, 7))
            assert bus.requests <= 1 + 2       # ceil(6 / 3) windowed trips
            got = list(bus.consume(Schemas()))
            assert bus.end_offset == 7
        finally:
            bus.close()
        assert [o for o, _ in got] == list(range(7))
        assert [c.to_bytes() for _, c in got] == \
            [t.to_bytes() for _, t in pairs]
        # the JAX package's own client reads the same frames
        jbus = JBrokerBus(addr, 1)
        try:
            jgot = list(jbus.consume(JSchemas()))
        finally:
            jbus.close()
        assert [c.to_bytes() for _, c in jgot] == \
            [j.to_bytes() for j, _ in pairs]
    finally:
        srv.stop()


def test_jax_bus_against_a_port_broker(tmp_path):
    from filodb_tpu.ingest.broker import BrokerBus as JBrokerBus
    srv = BrokerServer(str(tmp_path / "port"), num_partitions=2).start()
    try:
        addr = f"127.0.0.1:{srv.port}"
        pairs = [_both_containers(i) for i in range(5)]
        jbus = JBrokerBus(addr, 0, publish_window=2)
        try:
            for j, _ in pairs[:2]:
                jbus.publish(j)
            jbus.publish_batch([j for j, _ in pairs[2:]])
            # a retry of an acked id lands on its first offset, no append
            from filodb_tpu.ingest.broker import OP_PUBLISH
            payload = pairs[0][0].to_bytes()
            assert jbus._request(OP_PUBLISH, offset=4242, plen=len(payload),
                                 payload=payload)[0] == 5
            assert jbus._request(OP_PUBLISH, offset=4242, plen=len(payload),
                                 payload=payload)[0] == 5
        finally:
            jbus.close()
        bus = BrokerBus(addr, 0)
        try:
            got = list(bus.consume(Schemas()))
        finally:
            bus.close()
        assert [o for o, _ in got] == list(range(6))
        assert [c.to_bytes() for _, c in got] == \
            [t.to_bytes() for _, t in pairs] + [pairs[0][1].to_bytes()]
    finally:
        srv.stop()


def test_logs_and_journals_are_byte_identical_across_packages(
        tmp_path, monkeypatch):
    """Both packages' brokers, fed the same containers under the same
    publish ids through their own clients (single publishes and windowed
    batches over two partitions), write the same partition logs and pub-id
    journals byte for byte."""
    from filodb_tpu.ingest.broker import BrokerBus as JBrokerBus
    from filodb_tpu.ingest.broker import BrokerServer as JBrokerServer
    _deterministic_ids(monkeypatch, JBrokerBus, BrokerBus)
    pairs = [_both_containers(i) for i in range(9)]
    dirs = {}
    for name, server_cls, bus_cls, which in (
            ("jax", JBrokerServer, JBrokerBus, 0),
            ("port", BrokerServer, BrokerBus, 1)):
        d = tmp_path / name
        srv = server_cls(str(d), num_partitions=2).start()
        try:
            addr = f"127.0.0.1:{srv.port}"
            for p in (0, 1):
                bus = bus_cls(addr, p, publish_window=4)
                try:
                    bus.publish(pairs[p][which])
                    bus.publish_batch([c[which] for c in pairs[2 + p::2]])
                finally:
                    bus.close()
        finally:
            srv.stop()
        dirs[name] = d
    files = sorted(f.name for f in dirs["jax"].iterdir())
    assert files == sorted(f.name for f in dirs["port"].iterdir())
    assert {"partition0.log", "partition1.log", "partition0.pubids",
            "partition1.pubids"} <= set(files)
    for f in files:
        assert (dirs["jax"] / f).read_bytes() == \
            (dirs["port"] / f).read_bytes(), f


def test_a_mixed_replica_pair_fails_over_without_loss_or_dup(tmp_path):
    """A JAX broker node and a port broker node as one replica set (R = 2):
    the replication stream and the pub-id journals cross packages; the
    JAX leader killed mid-window (a FaultPlan), the port client fails over
    to the port follower with the same pub-ids — zero lost, zero
    duplicated, both journals equal up to the kill."""
    from filodb_tpu.ingest.broker import BrokerServer as JBrokerServer
    from filodb_tpu.ingest.faults import FaultPlan as JFaultPlan
    from filodb_tpu.ingest.faults import FaultRule as JFaultRule
    from filodb_tpu_torch.parallel.bootstrap import free_port
    pa, pb = free_port(), free_port()
    peers = [f"127.0.0.1:{pa}", f"127.0.0.1:{pb}"]
    plan = JFaultPlan([JFaultRule("append", "kill_server", partition=0,
                                  at_offset=5)])
    a = JBrokerServer(str(tmp_path / "jax"), 1, port=pa, peers=peers,
                      node_index=0, replication=2, fault_plan=plan).start()
    b = BrokerServer(str(tmp_path / "port"), 1, port=pb, peers=peers,
                     node_index=1, replication=2).start()
    try:
        pairs = [_both_containers(i) for i in range(10)]
        bus = BrokerBus(peers, 0, publish_window=2, retry_backoff_ms=0,
                        track_acks=True)
        bus._sleep = lambda _s: None
        try:
            offs = bus.publish_batch([t for _, t in pairs])
        finally:
            bus.close()
        assert sorted(offs) == list(range(10))
        assert plan.fired and plan.fired[0][1] == "kill_server"
        items = b._journals[0].items()
        assert [o for o, _ in items] == list(range(10))
        ids = [i for _, i in items]
        assert len(set(ids)) == 10 and set(bus.acked_ids) == set(ids)
        jax_items = a._journals[0].items()
        assert jax_items == items[:len(jax_items)]
        reader = BrokerBus([peers[1]], 0)
        try:
            got = sorted(c.to_bytes() for _, c in reader.consume(Schemas()))
        finally:
            reader.close()
        assert got == sorted(t.to_bytes() for _, t in pairs)
    finally:
        with contextlib.suppress(Exception):
            a.stop()
        b.stop()
