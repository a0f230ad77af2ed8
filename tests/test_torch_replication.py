"""Replicated multi-partition ingest: quorum acks, leader failover,
backpressure, and the deterministic fault-injection harness (ISSUE 6).

Every failure here is INJECTED via FaultPlan (counter-based, seeded — no
wall clock) or an explicitly dead peer; client backoffs run with a zero
base and a recorded sleep hook, so the matrix is tier-1 fast and
deterministic."""

import contextlib
import os
import socket
import struct
import tempfile

import pytest

from filodb_tpu_torch.core.record import RecordBuilder
from filodb_tpu_torch.core.schemas import GAUGE, Schemas
from filodb_tpu_torch.ingest.broker import (BrokerBus, BrokerRetry, BrokerServer,
                                      OP_PUBLISH, ST_OK, ST_RETRY, _REQ,
                                      _RESP)
from filodb_tpu_torch.ingest.faults import FaultPlan, FaultRule

BASE = 1_700_000_000_000


def mk(tag, n=3):
    b = RecordBuilder(GAUGE)
    for t in range(n):
        b.add({"_metric_": "m", "tag": tag}, BASE + t * 1000, float(t))
    return b.build()


def reserve_port() -> int:
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_pair(tmp_path, partitions=1, min_insync=1, fault_plan_a=None,
              start_b=True):
    """Two-node replica set (R=2): returns (peers, serverA, serverB|None).
    Partition p's leader is peers[p % 2]."""
    pa, pb = reserve_port(), reserve_port()
    peers = [f"127.0.0.1:{pa}", f"127.0.0.1:{pb}"]
    a = BrokerServer(str(tmp_path / "a"), partitions, port=pa, peers=peers,
                     node_index=0, replication=2, min_insync=min_insync,
                     fault_plan=fault_plan_a).start()
    b = BrokerServer(str(tmp_path / "b"), partitions, port=pb, peers=peers,
                     node_index=1, replication=2,
                     min_insync=min_insync).start() if start_b else None
    return peers, a, b


def sleepless_bus(addrs, part, **kw):
    """Replica-aware bus with zero-base jittered backoff and NO real
    sleeps — retries/failovers run at test speed; the waits it WOULD have
    taken are recorded for assertions."""
    kw.setdefault("retry_backoff_ms", 0)
    kw.setdefault("seed", 7)
    bus = BrokerBus(addrs, part, **kw)
    bus.waits = []
    bus._sleep = bus.waits.append
    return bus


def log_tags(addr, part):
    bus = BrokerBus([addr], part)
    try:
        got = list(bus.consume(Schemas()))
    finally:
        bus.close()
    return [c.label_sets[0]["tag"] for _, c in got], [o for o, _ in got]


def test_publish_replicates_to_follower_with_id_parity(tmp_path):
    """An acked publish is on BOTH replicas (ack = all live in-sync
    replicas hold it), and the follower's pub-id journal matches the
    leader's — the handoff currency of failover idempotence."""
    peers, a, b = make_pair(tmp_path)
    try:
        bus = sleepless_bus(peers, 0, publish_window=4, track_acks=True)
        bus.publish_batch([mk(f"c{i}") for i in range(9)])
        bus.publish(mk("c9"))
        bus.close()
        tags_a, offs_a = log_tags(peers[0], 0)
        tags_b, offs_b = log_tags(peers[1], 0)
        assert tags_a == tags_b == [f"c{i}" for i in range(10)]
        assert offs_a == offs_b == list(range(10))
        assert a._journals[0].items() == b._journals[0].items()
        assert len(a._journals[0].items()) == 10
        # every acked id is journaled exactly once — zero loss, zero dup
        logged = {pid for _off, pid in a._journals[0].items()}
        assert set(bus.acked_ids) <= logged
        assert len([pid for _o, pid in a._journals[0].items()]) == len(logged)
    finally:
        a.stop()
        b.stop()


def test_kill_leader_mid_drain_replays_without_loss_or_dup(tmp_path):
    """The headline fault: the leader dies mid-window (kill-at-offset).
    The windowed publisher re-resolves the most-caught-up survivor and
    replays its unacked frames with the SAME pub-ids; the survivor's log
    ends dense with zero lost and zero duplicated frames."""
    plan = FaultPlan([FaultRule("append", "kill_server", partition=0,
                                at_offset=4)])
    peers, a, b = make_pair(tmp_path, fault_plan_a=plan)
    try:
        bus = sleepless_bus(peers, 0, publish_window=2, track_acks=True)
        offs = bus.publish_batch([mk(f"k{i}") for i in range(10)])
        assert sorted(offs) == list(range(10))
        assert plan.fired and plan.fired[0][1] == "kill_server"
        assert bus._cur == 1                    # failed over to the survivor
        tags, offsets = log_tags(peers[1], 0)
        assert offsets == list(range(10))       # dense: no loss
        assert sorted(tags) == sorted(f"k{i}" for i in range(10))  # no dup
        # client-side ledger reconciles against the survivor's journal
        logged = {pid for _off, pid in b._journals[0].items()}
        assert set(bus.acked_ids) == logged
        bus.close()
    finally:
        with contextlib.suppress(Exception):
            a.stop()
        b.stop()


def test_lost_response_replay_is_duplicate_free(tmp_path):
    """Satellite: a response lost mid-window (client_recv drop) must not
    strand frames — the bus reconnects and re-sends the unacked window
    immediately, and per-frame ids keep the broker log duplicate-free."""
    from filodb_tpu_torch.utils.metrics import FILODB_INGEST_RETRIES, registry
    plan = FaultPlan([FaultRule("client_recv", "drop_response", nth=1)])
    srv = BrokerServer(str(tmp_path / "x"), 1).start()
    try:
        before = registry.counter(FILODB_INGEST_RETRIES).value
        bus = sleepless_bus([f"127.0.0.1:{srv.port}"], 0, publish_window=3,
                            fault_plan=plan)
        offs = bus.publish_batch([mk(f"d{i}") for i in range(9)])
        assert sorted(offs) == list(range(9))
        tags, offsets = log_tags(f"127.0.0.1:{srv.port}", 0)
        assert offsets == list(range(9)) and len(set(tags)) == 9
        assert plan.fired                       # the drop really happened
        assert registry.counter(FILODB_INGEST_RETRIES).value > before
        bus.close()
    finally:
        srv.stop()


def test_follower_lag_quorum_stall_sheds_retry(tmp_path):
    """min_insync=2 with a dead follower: every publish must shed with the
    typed RETRY (never a silent local-only ack), surface as BrokerRetry
    after the bounded backoff, and count shed + retry metrics."""
    from filodb_tpu_torch.utils.metrics import (FILODB_INGEST_PUBLISH_SHED,
                                          registry)
    peers, a, _ = make_pair(tmp_path, min_insync=2, start_b=False)
    try:
        shed = registry.counter(FILODB_INGEST_PUBLISH_SHED)
        before = shed.value
        bus = sleepless_bus([peers[0]], 0, max_retries=2)
        with pytest.raises(BrokerRetry):
            bus.publish(mk("stall"))
        assert shed.value - before >= 3         # initial + both retries
        assert bus.waits and all(w >= 0.1 for w in bus.waits)
        # the RETRY's server hint (100ms) floors the client backoff
        # frames stayed appended locally; a later quorum recovery acks the
        # SAME id without duplicating
        pb = int(peers[1].rsplit(":", 1)[1])
        b = BrokerServer(str(tmp_path / "b"), 1, port=pb, peers=peers,
                         node_index=1, replication=2, min_insync=2).start()
        try:
            a._repl._links[(0, 1)].fails = 0    # rejoin without the skip lag
            off = bus.publish(mk("stall2"))
            assert off == 1
            tags, offsets = log_tags(peers[1], 0)
            assert offsets == [0, 1] and tags == ["stall", "stall2"]
        finally:
            b.stop()
        bus.close()
    finally:
        a.stop()


def _recv(sock, n):
    buf = b""
    while len(buf) < n:
        got = sock.recv(n - len(buf))
        if not got:
            raise ConnectionError("closed")
        buf += got
    return buf


def test_queue_cap_concurrent_shed_and_client_backoff(tmp_path):
    """Concurrency form of the overload test: a delay fault holds one
    publish in the partition's only admission slot; a concurrent publish
    is shed with ST_RETRY and the client backoff lands it afterwards."""
    import threading
    plan = FaultPlan([FaultRule("serve", "delay", nth=1, delay_s=0.3,
                                op=OP_PUBLISH)])
    srv = BrokerServer(str(tmp_path / "q2"), 1, max_queue=1,
                       fault_plan=plan).start()
    try:
        slow = BrokerBus([f"127.0.0.1:{srv.port}"], 0)
        t = threading.Thread(target=lambda: slow.publish(mk("slow")))
        t.start()
        # real (small) sleeps here: the fast bus must collide with the
        # in-flight slow publish, then succeed on backoff
        fast = BrokerBus([f"127.0.0.1:{srv.port}"], 0, retry_backoff_ms=50,
                         max_retries=8, seed=11)
        import time
        time.sleep(0.05)                        # slow publish is in-flight
        from filodb_tpu_torch.utils.metrics import (FILODB_INGEST_PUBLISH_SHED,
                                              registry)
        before = registry.counter(FILODB_INGEST_PUBLISH_SHED).value
        fast.publish(mk("fast"))
        t.join(timeout=5)
        assert registry.counter(FILODB_INGEST_PUBLISH_SHED).value > before
        tags, offsets = log_tags(f"127.0.0.1:{srv.port}", 0)
        assert sorted(tags) == ["fast", "slow"] and offsets == [0, 1]
        slow.close(), fast.close()
    finally:
        srv.stop()


def test_torn_frame_detected_on_follower_catchup(tmp_path):
    """A corrupted catch-up batch must be REJECTED by the follower's
    per-frame CRC (not silently appended) and re-sent intact on the next
    attempt — the follower ends bit-identical to the leader."""
    plan = FaultPlan([FaultRule("replicate", "corrupt", nth=1,
                                partition=0)], seed=9)
    peers, a, _ = make_pair(tmp_path, fault_plan_a=plan, start_b=False)
    try:
        a._repl.rejoin_every = 1                # retry the follower per call
        bus = sleepless_bus([peers[0]], 0)
        for i in range(5):
            bus.publish(mk(f"pre{i}"))          # degraded: follower down
        pb = int(peers[1].rsplit(":", 1)[1])
        b = BrokerServer(str(tmp_path / "b"), 1, port=pb, peers=peers,
                         node_index=1, replication=2).start()
        try:
            bus.publish(mk("post0"))            # catch-up batch is corrupted
            assert plan.fired and plan.fired[0][1] == "corrupt"
            assert BrokerBus([peers[1]], 0).end_offset == 0  # rejected whole
            bus.publish(mk("post1"))            # clean retry: full catch-up
            tags, offsets = log_tags(peers[1], 0)
            assert offsets == list(range(7))
            assert tags == [f"pre{i}" for i in range(5)] + ["post0", "post1"]
            assert a._journals[0].items() == b._journals[0].items()
        finally:
            b.stop()
        bus.close()
    finally:
        a.stop()


def test_torn_write_severed_stream_recovers(tmp_path):
    """torn_write (truncated frame + severed connection) on the
    replication stream: the leader reconnects and the follower converges
    with no gap and no partial frame."""
    plan = FaultPlan([FaultRule("replicate", "torn_write", nth=2,
                                partition=0)])
    peers, a, b = make_pair(tmp_path, fault_plan_a=plan)
    try:
        a._repl.rejoin_every = 1
        bus = sleepless_bus([peers[0]], 0)
        for i in range(4):
            bus.publish(mk(f"t{i}"))
        # one replicate was torn mid-frame; later publishes re-drive
        # catch-up until the follower converges
        tags, offsets = log_tags(peers[1], 0)
        assert offsets == list(range(4))
        assert tags == [f"t{i}" for i in range(4)]
        assert [f for f in plan.fired if f[1] == "torn_write"]
        bus.close()
    finally:
        a.stop()
        b.stop()


def test_retry_hint_floors_client_backoff(tmp_path):
    """The server's RETRY hint (ms, in the response offset field) is
    honored as the backoff floor — the broker-client analog of HTTP
    Retry-After."""
    srv = BrokerServer(str(tmp_path / "h"), 1).start()
    port = srv.port
    srv.stop()
    # hand-rolled single-response broker: first request -> ST_RETRY with a
    # 1234ms hint, second -> ST_OK
    import threading
    lsock = socket.socket()
    lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    lsock.bind(("127.0.0.1", port))
    lsock.listen(2)

    def serve_two():
        for i, st in enumerate((ST_RETRY, ST_OK)):
            c, _ = lsock.accept()
            hdr = _recv(c, _REQ.size)
            op, part, off, plen = _REQ.unpack(hdr)
            if plen:
                _recv(c, plen)
            c.sendall(_RESP.pack(st, 1234 if st == ST_RETRY else 0, 0))
            c.close()

    t = threading.Thread(target=serve_two, daemon=True)
    t.start()
    try:
        bus = sleepless_bus([f"127.0.0.1:{port}"], 0)
        assert bus.publish(mk("hint")) == 0
        # ST_RETRY closed the connection server-side after responding; the
        # reconnect replay carried the same pub id — and the recorded wait
        # honored the 1234ms hint as its floor
        assert any(w >= 1.234 for w in bus.waits), bus.waits
        bus.close()
    finally:
        t.join(timeout=5)
        lsock.close()


def test_partition_breaker_sheds_fast_when_replica_set_down(tmp_path):
    """PR-2 breaker machinery on the publish path: a partition whose whole
    replica set is down trips the breaker after 3 transport failures and
    later publishes shed WITHOUT paying connect attempts."""
    port = reserve_port()
    bus = sleepless_bus([f"127.0.0.1:{port}"], 0)
    for _ in range(3):
        with pytest.raises((ConnectionError, OSError)):
            bus.publish(mk("x"))
    assert bus._breaker.is_open
    before = bus.requests
    with pytest.raises((ConnectionError, OSError), match="breaker open"):
        bus.publish(mk("y"))
    assert bus.requests == before           # shed fast: nothing on the wire
    bus.close()


def test_replica_rank_prefers_most_caught_up_survivor(tmp_path):
    """Failover ranking: the survivor with the HIGHEST watermark wins even
    when it is not the next static replica — publishers converge on one
    deterministic writer."""
    pa, pb, pc = reserve_port(), reserve_port(), reserve_port()
    peers = [f"127.0.0.1:{pa}", f"127.0.0.1:{pb}", f"127.0.0.1:{pc}"]
    b = BrokerServer(str(tmp_path / "b"), 1, port=pb).start()
    c = BrokerServer(str(tmp_path / "c"), 1, port=pc).start()
    try:
        # seed c (index 2) further ahead than b
        seedc = BrokerBus([peers[2]], 0)
        for i in range(3):
            seedc.publish(mk(f"s{i}"))
        seedc.close()
        bus = sleepless_bus(peers, 0)       # static leader peers[0] is dead
        off = bus.publish(mk("after"))
        assert bus._cur == 2 and off == 3   # ranked by watermark, not index
        bus.close()
    finally:
        b.stop()
        c.stop()


def test_failed_over_client_converges_home_after_leader_recovery(tmp_path):
    """A transient leader outage must not split publishers across writers
    forever: once the restarted static leader catches back up, the
    client's periodic success re-rank (tie-break prefers the static
    leader) moves it home — and the home log is dense and complete."""
    peers, a, b = make_pair(tmp_path)
    try:
        b._repl.rejoin_every = 1            # retry the dead peer per publish
        bus = sleepless_bus(peers, 0)
        bus._RERANK_EVERY = 4               # converge fast in the test
        for i in range(3):
            bus.publish(mk(f"x{i}"))
        a.stop()                            # transient leader outage
        for i in range(3, 6):
            bus.publish(mk(f"x{i}"))        # failed over to the survivor
        assert bus._cur == 1
        pa = int(peers[0].rsplit(":", 1)[1])
        a2 = BrokerServer(str(tmp_path / "a"), 1, port=pa, peers=peers,
                          node_index=1 - 1, replication=2).start()
        try:
            for i in range(6, 20):          # B catches A up; client re-ranks
                bus.publish(mk(f"x{i}"))
            assert bus._cur == 0            # converged back onto the leader
            tags, offsets = log_tags(peers[0], 0)
            assert offsets == list(range(20))
            assert tags == [f"x{i}" for i in range(20)]
        finally:
            a2.stop()
        bus.close()
    finally:
        with contextlib.suppress(Exception):
            a.stop()
        b.stop()


def test_broker_restart_keeps_idempotence_window(tmp_path):
    """The pub-id journal makes retry idempotence survive a broker
    restart: the same id re-published against the restarted broker
    resolves to the original offset instead of appending."""
    d = str(tmp_path / "r")
    srv = BrokerServer(d, 1).start()
    bus = BrokerBus([f"127.0.0.1:{srv.port}"], 0)
    payload = mk("r0").to_bytes()
    off1, _ = bus._request(OP_PUBLISH, offset=4242, plen=len(payload),
                           payload=payload)
    bus.close()
    srv.stop()
    srv2 = BrokerServer(d, 1).start()
    try:
        bus2 = BrokerBus([f"127.0.0.1:{srv2.port}"], 0)
        off2, _ = bus2._request(OP_PUBLISH, offset=4242, plen=len(payload),
                                payload=payload)
        assert off2 == off1 and bus2.end_offset == 1
        bus2.close()
    finally:
        srv2.stop()


def test_pubid_journal_compacts_but_keeps_recent_window(tmp_path):
    """The journal is bounded (O(window), not O(lifetime ingest)): it
    compacts past 2x max_entries, survives a reload at the trimmed size,
    and the newest ids — every replay window lives there — stay
    resolvable."""
    from filodb_tpu_torch.ingest.replication import PubIdJournal
    p = str(tmp_path / "j.pubids")
    j = PubIdJournal(p, max_entries=64)
    for base in range(0, 256, 16):
        j.append_many([(off, 10_000 + off) for off in range(base, base + 16)])
    assert len(j.items()) <= 2 * 64
    assert os.path.getsize(p) <= 2 * 64 * PubIdJournal.REC.size
    # newest window intact and reloadable
    j2 = PubIdJournal(p, max_entries=64)
    for off in range(255, 255 - 32, -1):
        assert j2.get(off) == 10_000 + off
    recent: dict = {}
    j2.seed_recent(recent, 16)
    assert len(recent) == 16 and recent[10_000 + 255] == 255


def test_fault_plan_is_deterministic():
    """Same plan spec -> same decisions, independent of wall clock: the
    harness's core contract."""
    spec = [dict(site="serve", action="drop_response", nth=3, count=2,
                 partition=1)]

    def run():
        plan = FaultPlan.from_spec(spec, seed=5)
        out = []
        for i in range(8):
            r = plan.decide("serve", partition=1, op=OP_PUBLISH)
            out.append(None if r is None else r.action)
            plan.decide("serve", partition=0, op=OP_PUBLISH)  # filtered out
        return out

    assert run() == run() == [None, None, "drop_response", "drop_response",
                              None, None, None, None]


def test_filoserver_shared_partition_demux(tmp_path):
    """ingest.partitions < num_shards: shards share broker partitions and
    each consumer keeps only its own shard's containers — queries see
    every series exactly once."""
    import time

    import numpy as np

    from filodb_tpu_torch.config import Config
    from filodb_tpu_torch.standalone import FiloServer

    broker = BrokerServer(str(tmp_path / "broker"), 2).start()
    srv = None
    try:
        cfg = Config({
            "num_shards": 4,
            "bus_addrs": [f"127.0.0.1:{broker.port}"],
            "http": {"port": 0},
            "ingest": {"gateway_port": 0, "partitions": 2,
                       "publish_window": 8, "gateway_flush_lines": 16,
                       "gateway_flush_interval": "50ms"},
            "store": {"max_series_per_shard": 64, "samples_per_series": 128,
                      "flush_batch_size": 10**9},
        })
        srv = FiloServer(cfg, device="cpu").start()
        with socket.create_connection(("127.0.0.1",
                                       srv.gateway.port)) as s:
            for i in range(80):
                s.sendall(f"heap_usage,host=h{i % 8} value={i}.5 "
                          f"{(BASE // 1000 + i) * 1_000_000_000}\n".encode())
        eng = srv.engines["prometheus"]
        deadline = time.time() + 20
        while time.time() < deadline:
            r = eng.query_instant("count(heap_usage)",
                                  (BASE // 1000 + 80) * 1000)
            if r.matrix.num_series and \
                    float(np.asarray(r.matrix.values)[0, 0]) == 8.0:
                break
            time.sleep(0.25)
        else:
            raise AssertionError("shared-partition ingest never converged")
    finally:
        if srv:
            srv.shutdown()
        broker.stop()
