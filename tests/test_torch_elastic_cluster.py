"""Elastic cluster (ISSUE 12): membership gossip with counted suspicion,
epoch-fenced broker failover (the PR 6 known-limit closures: spurious-
failover split-brain + REJOIN after divergence), durable-ring store
fencing, live shard rebalance under load, and buddy-cluster query routing.

Determinism posture matches the ingest tier's: suspicion is counted in
probe rounds (tests drive rounds directly), faults are FaultPlan-injected
at exact offsets, and client backoffs run sleep-free."""

import contextlib
import socket
import time

import numpy as np
import pytest

from filodb_tpu_torch.cluster.epoch import FencedWriteError, StoreFence
from filodb_tpu_torch.cluster.gossip import ClusterLink
from filodb_tpu_torch.cluster.membership import (ALIVE, DEAD, SUSPECT, GossipAgent,
                                           MembershipTable)
from filodb_tpu_torch.core.record import RecordBuilder
from filodb_tpu_torch.core.schemas import GAUGE, Schemas
from filodb_tpu_torch.ingest.broker import BrokerBus, BrokerServer
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


def sleepless_bus(addrs, part, **kw):
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


def fenced_pair(tmp_path, fault_plan_a=None, start_b=True, min_insync=1):
    """Two epoch-fenced brokers (R=2); partition 0's static leader is a."""
    pa, pb = reserve_port(), reserve_port()
    peers = [f"127.0.0.1:{pa}", f"127.0.0.1:{pb}"]
    a = BrokerServer(str(tmp_path / "a"), 1, port=pa, peers=peers,
                     node_index=0, replication=2, min_insync=min_insync,
                     fault_plan=fault_plan_a, epoch_fencing=True).start()
    b = BrokerServer(str(tmp_path / "b"), 1, port=pb, peers=peers,
                     node_index=1, replication=2, min_insync=min_insync,
                     epoch_fencing=True).start() if start_b else None
    return peers, a, b


# ---------------------------------------------------------------------------
# membership gossip: counted suspicion, deterministic schedule, refutation
# ---------------------------------------------------------------------------

def make_agents(names=("a", "b", "c"), suspect_after=2, dead_after=4,
                events=None):
    """In-process gossip mesh keyed by node identity; servers started,
    probe rounds driven by the test."""
    addrs: dict[str, str] = {}
    agents: dict[str, GossipAgent] = {}
    for n in names:
        table = MembershipTable(
            n, suspect_after=suspect_after, dead_after=dead_after,
            on_down=(lambda peer, _n=n: events.append((_n, "down", peer)))
            if events is not None else None,
            on_up=(lambda peer, _n=n: events.append((_n, "up", peer)))
            if events is not None else None)
        ag = GossipAgent(n, lambda: dict(addrs), table)
        ag.server.start()
        addrs[n] = f"127.0.0.1:{ag.port}"
        agents[n] = ag
    return agents, addrs


def test_gossip_counted_suspicion_alive_suspect_dead(tmp_path):
    """The membership state machine: a silent peer ages alive→suspect→dead
    in COUNTED probe rounds (no wall clock), on_down fires exactly once on
    each survivor, and heartbeat counters flow transitively so a live peer
    two hops away never goes stale."""
    events: list = []
    agents, addrs = make_agents(events=events)
    try:
        for _ in range(6):          # full mesh converges
            for ag in agents.values():
                ag.probe_round()
        for ag in agents.values():
            for other in agents:
                assert ag.table.state_of(other) == ALIVE, (ag.self_addr, other)
        # kill c: its digests stop, its endpoint refuses. Suspicion is
        # counted — c ages alive→suspect→dead in bounded probe ROUNDS (a
        # survivor holding a fresher copy of c's counter can delay a peer's
        # aging by exactly the digest propagation, never by wall time)
        agents["c"].server.stop()
        a, b = agents["a"], agents["b"]
        timeline = []
        for _ in range(12):
            a.probe_round()
            b.probe_round()
            timeline.append((a.table.state_of("c"), b.table.state_of("c")))
        a_states = [s for s, _ in timeline]
        assert a_states.index(SUSPECT) < a_states.index(DEAD), a_states
        assert timeline[-1] == (DEAD, DEAD)
        # the counted thresholds bound the detection: a (probing c's dead
        # endpoint directly) reaches DEAD within dead_after + mesh slack
        assert a_states[:6].count(DEAD) > 0, a_states
        downs = [e for e in events if e[1] == "down"]
        assert sorted(downs) == [("a", "down", "c"), ("b", "down", "c")]
        # a and b keep each other alive throughout (transitive + direct)
        assert a.table.state_of("b") == ALIVE
        assert b.table.state_of("a") == ALIVE
    finally:
        for ag in agents.values():
            with contextlib.suppress(Exception):
                ag.server.stop()


def test_gossip_restart_refutes_and_revives(tmp_path):
    """A restarted node's fresh heartbeat counter would lose to its own
    stale record — SWIM refutation bumps its incarnation past it, and the
    survivors fire on_up when the counter advances again."""
    events: list = []
    agents, addrs = make_agents(names=("a", "b"), events=events)
    try:
        for _ in range(4):
            for ag in agents.values():
                ag.probe_round()
        old_hb = agents["a"].table._peers["b"]["hb"]
        agents["b"].server.stop()
        for _ in range(4):
            agents["a"].probe_round()
        assert agents["a"].table.state_of("b") == DEAD
        # restart b with a FRESH table (counter restarts at 0)
        table = MembershipTable("b", suspect_after=2, dead_after=4)
        b2 = GossipAgent("b", lambda: dict(addrs), table)
        b2.server.start()
        addrs["b"] = f"127.0.0.1:{b2.port}"
        agents["b"] = b2
        # b2 probes a: learns its own stale record (hb=old), refutes by
        # bumping incarnation; a adopts the refuted record and revives b
        b2.probe_round()
        assert b2.table.incarnation >= 1
        assert b2.table.heartbeat < old_hb      # counter really restarted
        agents["a"].probe_round()
        b2.probe_round()
        assert agents["a"].table.state_of("b") == ALIVE
        assert ("a", "up", "b") in events
    finally:
        for ag in agents.values():
            with contextlib.suppress(Exception):
                ag.server.stop()


def test_gossip_fault_plan_drops_probes_deterministically():
    """The FaultPlan ``gossip`` site: a symmetric network partition (both
    directions' probes dropped for exactly N rounds) is replayable — the
    same plans yield the same suspicion timeline, and the partition
    healing revives the peer without a restart."""
    def run():
        agents, _addrs = make_agents(names=("a", "b"))
        plans = {}
        for name, ag in agents.items():
            # rounds 2..5 partitioned, both directions (counter-matched)
            plans[name] = FaultPlan([FaultRule("gossip", "drop", nth=2,
                                               count=4)])
            ag.fault_plan = plans[name]
        timeline = []
        try:
            for _ in range(10):
                agents["a"].probe_round()
                agents["b"].probe_round()
                timeline.append((agents["a"].table.state_of("b"),
                                 agents["b"].table.state_of("a")))
        finally:
            for ag in agents.values():
                ag.server.stop()
        return timeline, [len(p.fired) for p in plans.values()]
    t1, f1 = run()
    t2, f2 = run()
    assert t1 == t2 and f1 == f2 == [4, 4]
    assert (SUSPECT, SUSPECT) in t1     # the partition aged both views
    assert t1[-1] == (ALIVE, ALIVE)     # healing revived without restart


# ---------------------------------------------------------------------------
# epoch fencing: the split-brain closures (property sweep over kill offsets)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kill_at", [2, 4, 6])
def test_epoch_fence_invariants_sweep_kill_offsets(tmp_path, kill_at):
    """Property sweep of the fencing invariants: whatever offset the
    leader dies at, (1) the failed-over client claims a higher epoch and
    lands every frame exactly once on the survivor; (2) the restarted
    ex-leader REJOINs (adopts the epoch, truncates any divergent tail,
    catches up byte-identically); (3) the fenced ex-leader can NEVER ack a
    publish again."""
    plan = FaultPlan([FaultRule("append", "kill_server", partition=0,
                                at_offset=kill_at)])
    peers, a, b = fenced_pair(tmp_path, fault_plan_a=plan)
    try:
        bus = sleepless_bus(peers, 0, publish_window=2, track_acks=True,
                            epoch_fencing=True)
        offs = bus.publish_batch([mk(f"k{i}") for i in range(10)])
        assert sorted(offs) == list(range(10))
        assert plan.fired and plan.fired[0][1] == "kill_server"
        # invariant 1: survivor owns a bumped epoch; log dense + dup-free
        e, owner = b.epochs.get(0)
        assert e == 2 and owner == peers[1]
        tags, offsets = log_tags(peers[1], 0)
        assert offsets == list(range(10))
        assert sorted(tags) == sorted(f"k{i}" for i in range(10))
        logged = {pid for _off, pid in b._journals[0].items()}
        assert set(bus.acked_ids) == logged
        # invariant 2: the restarted ex-leader adopts + converges
        pa = int(peers[0].rsplit(":", 1)[1])
        a2 = BrokerServer(str(tmp_path / "a"), 1, port=pa, peers=peers,
                          node_index=0, replication=2,
                          epoch_fencing=True).start()
        try:
            assert a2.epochs.get(0) == (2, peers[1])
            assert list(a2._parts[0].frames_from(0)) \
                == list(b._parts[0].frames_from(0))
            assert a2._journals[0].items() == b._journals[0].items()
            # invariant 3: the fenced ex-leader can never ack a publish
            direct = sleepless_bus([peers[0]], 0, max_retries=1)
            with pytest.raises(RuntimeError, match="fenced"):
                direct.publish(mk("zombie"))
            direct.close()
            assert a2._parts[0].end_offset == b._parts[0].end_offset
        finally:
            a2.stop()
        bus.close()
    finally:
        with contextlib.suppress(Exception):
            a.stop()
        b.stop()


def test_spurious_failover_snaps_home_without_split_brain(tmp_path):
    """THE PR 6 known-limit: a client that spuriously fails over while the
    real leader lives used to create a second writer for a whole re-rank
    window. With fencing, the survivor refuses the publish naming the live
    owner, and the client snaps home — one writer, no epoch churn."""
    peers, a, b = fenced_pair(tmp_path)
    try:
        bus = sleepless_bus(peers, 0, epoch_fencing=True)
        bus.publish(mk("x0"))
        assert bus._cur == 0
        bus._cur = 1                    # inject the spurious failover
        bus._close_locked()
        off = bus.publish(mk("x1"))
        assert off == 1
        assert bus._cur == 0            # snapped home to the live owner
        assert a.epochs.get(0) == (1, peers[0])     # no epoch churn
        tags, offsets = log_tags(peers[0], 0)
        assert tags == ["x0", "x1"] and offsets == [0, 1]
        assert b._parts[0].end_offset == 2          # replicated, not forked
        bus.close()
    finally:
        a.stop()
        b.stop()


def test_split_brain_divergent_tail_truncated_on_rejoin(tmp_path):
    """Divergence repair: a leader that acked local-only frames (follower
    out) and died must NOT rejoin with conflicting frames — it truncates
    its divergent tail at the fork point and catches up from the current
    leader, ending byte-identical (zero duplicates cluster-wide)."""
    peers, a, b = fenced_pair(tmp_path)
    try:
        bus = sleepless_bus(peers, 0, epoch_fencing=True)
        for i in range(3):
            bus.publish(mk(f"r{i}"))            # replicated to both
        b.stop()
        for i in range(3, 5):
            bus.publish(mk(f"fork{i}"))         # local-only acks on a
        assert a._parts[0].end_offset == 5
        a.stop()
        pb = int(peers[1].rsplit(":", 1)[1])
        b2 = BrokerServer(str(tmp_path / "b"), 1, port=pb, peers=peers,
                          node_index=1, replication=2,
                          epoch_fencing=True).start()
        for i in range(5, 8):
            bus.publish(mk(f"new{i}"))          # failover claims epoch 2
        assert b2.epochs.get(0)[0] == 2
        pa = int(peers[0].rsplit(":", 1)[1])
        a2 = BrokerServer(str(tmp_path / "a"), 1, port=pa, peers=peers,
                          node_index=0, replication=2,
                          epoch_fencing=True).start()
        try:
            la = list(a2._parts[0].frames_from(0))
            lb = list(b2._parts[0].frames_from(0))
            assert la == lb and len(la) == 6
            tags, _offs = log_tags(peers[0], 0)
            assert tags == ["r0", "r1", "r2", "new5", "new6", "new7"]
            assert not any(t.startswith("fork") for t in tags)
            assert a2._journals[0].items() == b2._journals[0].items()
        finally:
            a2.stop()
        bus.close()
        b2.stop()
    finally:
        with contextlib.suppress(Exception):
            a.stop()
        with contextlib.suppress(Exception):
            b.stop()


def test_concurrent_claims_epoch_tie_resolves_to_one_owner(tmp_path):
    """Two survivors that raced OP_EPOCH_LEAD can both compute the same
    epoch. Ordering is lexicographic over (epoch, owner), so the tie
    resolves deterministically: the higher owner's announce is adopted
    everywhere, the lower one's replication stream is refused as fenced,
    and exactly one broker keeps acking."""
    from filodb_tpu_torch.cluster.epoch import PartitionEpochs
    lo, hi = "127.0.0.1:9001", "127.0.0.1:9002"
    ea = PartitionEpochs(str(tmp_path / "a.json"))
    eb = PartitionEpochs(str(tmp_path / "b.json"))
    # the race: both claimed epoch 2 for themselves
    assert ea.adopt(0, 2, lo) and eb.adopt(0, 2, hi)
    # cross-announces: the higher owner wins on BOTH, lower is refused
    assert ea.adopt(0, 2, hi)           # lo's store adopts hi
    assert not eb.adopt(0, 2, lo)       # hi's store refuses lo
    assert ea.get(0) == eb.get(0) == (2, hi)
    # wire form: a live broker holding the tie refuses the lower owner's
    # replication batch (same epoch, lower owner => fenced)
    peers, a, b = fenced_pair(tmp_path)
    try:
        e, owner = a.epochs.get(0)
        assert (e, owner) == (1, peers[0])
        from filodb_tpu_torch.ingest.replication import (pack_entries,
                                                   pack_epoch_hdr)
        from filodb_tpu_torch.ingest.broker import pack_trace_hdr, _RESP, ST_ERR
        from filodb_tpu_torch.ingest.replication import serve_replication, \
            OP_REPLICATE
        payload = pack_trace_hdr(None) \
            + pack_epoch_hdr(1, "127.0.0.1:1") + pack_entries([])
        resp = serve_replication(a, OP_REPLICATE, 0, payload)
        st, _off, ln = _RESP.unpack(resp[:_RESP.size])
        assert st == ST_ERR and b"fenced" in resp[_RESP.size:]
    finally:
        a.stop()
        b.stop()


def test_fenced_exowner_cannot_store_write_or_checkpoint(tmp_path):
    """The store-ring half of the fencing acceptance: once a replacement
    claims a shard's durable epoch, the deposed owner's chunk writes,
    checkpoints, part-key writes, and age-out rewrites all raise
    FencedWriteError (counted refresh — no steady-state read tax)."""
    from filodb_tpu_torch.core.diststore import ReplicatedColumnStore
    from filodb_tpu_torch.core.store import FileColumnStore
    ring = ReplicatedColumnStore([FileColumnStore(str(tmp_path / "ring"))],
                                 replication=1)
    fence_a = StoreFence(ring, "node-a", refresh_every=4)
    ring.write_guard = fence_a
    fence_a.claim(0)
    ring.write_meta("ds", 0, {"ok": 1})                 # owner writes fine
    ring.write_checkpoint("ds", 0, 0, 42)
    # an UNclaimed shard is refused outright (no zombie default-allow)
    with pytest.raises(FencedWriteError):
        ring.write_meta("ds", 1, {"nope": 1})
    # node-b takes over shard 0: its claim supersedes ours in the ring
    fence_b = StoreFence(ring, "node-b", refresh_every=4)
    fence_b.claim(0)
    # within the counted refresh window the stale owner may still slip
    # writes; sweep until the refresh fires — then EVERYTHING is fenced
    with pytest.raises(FencedWriteError) as ei:
        for _ in range(6):
            ring.write_checkpoint("ds", 0, 1, 99)
    assert ei.value.current == 2 and ei.value.owner == "node-b"
    for fn in (lambda: ring.write_meta("ds", 0, {"x": 1}),
               lambda: ring.write_checkpoint("ds", 0, 2, 1),
               lambda: ring.write_part_keys("ds", 0, []),
               lambda: ring.age_out("ds", 0, BASE)):
        with pytest.raises(FencedWriteError):
            fn()
    # the new owner keeps writing
    ring.write_guard = fence_b
    ring.write_meta("ds", 0, {"owner": "b"})
    assert ring.read_meta("ds", 0) == {"owner": "b"}


# ---------------------------------------------------------------------------
# live rebalance + cluster status surface (two FiloServers, shared ring)
# ---------------------------------------------------------------------------

def _two_node_cluster(tmp_path, broker_port, store_addr, reg):
    from filodb_tpu_torch.config import Config
    from filodb_tpu_torch.standalone import FiloServer

    def server(name, gossip_port=0):
        return FiloServer(Config({
            "num_shards": 2, "bus_addr": f"127.0.0.1:{broker_port}",
            "http": {"port": 0},
            "store_nodes": [store_addr], "store_replication": 1,
            "cluster": {"registrar": reg, "self_addr": name,
                        "heartbeat_interval": "200ms", "stale_after": "5s",
                        "min_members": 2, "join_timeout": "15s",
                        "shard_fencing": True, "gossip_port": gossip_port},
            "store": {"max_series_per_shard": 32, "samples_per_series": 128,
                      "flush_batch_size": 10**9},
        }), device="cpu")
    return server


def test_live_rebalance_under_load_bit_parity(tmp_path):
    """Acceptance: an operator-triggered live shard move under publish
    load is bit-identical to the unmoved baseline — flush→handoff→
    catch-up→cutover, epoch-fenced, with both nodes' maps converging and
    ingest continuing on the new owner."""
    import json
    import threading
    import urllib.request

    from filodb_tpu_torch.core.diststore import StoreServer

    store = StoreServer(str(tmp_path / "ring")).start()
    broker = BrokerServer(str(tmp_path / "broker"), 2).start()
    reg = str(tmp_path / "members")
    server = _two_node_cluster(tmp_path, broker.port,
                               f"127.0.0.1:{store.port}", reg)
    servers = {}
    threads = {n: threading.Thread(
        target=lambda n=n: servers.update({n: server(n).start()}))
        for n in ("node-a:1", "node-b:1")}
    for t in threads.values():
        t.start()
    for t in threads.values():
        t.join(timeout=30)
    a, b = servers["node-a:1"], servers["node-b:1"]
    stop_pub = threading.Event()
    published = {"n": 0}
    try:
        # both shards get owners; find a shard owned by node-a
        mover = next(s for s in (0, 1)
                     if a.manager.node_of("prometheus", s) == "node-a:1")
        owner_srv = a
        target = "node-b:1"
        prod = BrokerBus(f"127.0.0.1:{broker.port}", mover)

        def publish_load():
            i = 0
            while not stop_pub.wait(0.02):
                bld = RecordBuilder(GAUGE)
                bld.add({"_metric_": "m", "host": f"h{i % 4}"},
                        BASE + i * 1000, float(i))
                prod.publish(bld.build())
                published["n"] += 1
                i += 1

        loader = threading.Thread(target=publish_load)
        loader.start()
        deadline = time.time() + 15         # some pre-move data ingested
        while published["n"] < 10 and time.time() < deadline:
            time.sleep(0.1)
        # the operator move, via the HTTP surface the CLI drives
        req = urllib.request.Request(
            f"http://127.0.0.1:{owner_srv.http.port}/api/v1/cluster/"
            f"rebalance?dataset=prometheus&shard={mover}&to={target}",
            method="POST", data=b"")
        with urllib.request.urlopen(req, timeout=60.0) as r:
            payload = json.load(r)
        assert payload["data"]["to"] == target
        # keep loading a little, then stop and settle
        deadline = time.time() + 10
        n_at_move = published["n"]
        while published["n"] < n_at_move + 10 and time.time() < deadline:
            time.sleep(0.1)
        stop_pub.set()
        loader.join(timeout=10)
        prod.close()
        total = published["n"]
        # ownership converged on BOTH nodes (cutover + claims adoption)
        assert a.manager.node_of("prometheus", mover) == target
        deadline = time.time() + 15
        while time.time() < deadline:
            if b.manager.node_of("prometheus", mover) == target \
                    and mover in b._running:
                break
            time.sleep(0.25)
        else:
            raise AssertionError("adopter never started the moved shard")
        assert mover not in a._running
        # epoch fenced: exactly one owner — node-b's claim supersedes
        assert b._fence.owned().get(mover, 0) >= 2
        assert mover not in a._fence.owned()
        # bit parity: every published sample served, from EITHER node,
        # equal to the arithmetic oracle (sum over i of i for i < total)
        want_count = 4.0 if total >= 4 else float(total)
        want_sum = float(sum(range(total)))
        for srv in (b, a):
            eng = srv.engines["prometheus"]
            deadline = time.time() + 20
            while time.time() < deadline:
                rc = eng.query_instant("count(m)", BASE + total * 1000)
                rs = eng.query_instant("sum(sum_over_time(m[1h]))",
                                       BASE + total * 1000)
                if rc.matrix.num_series and rs.matrix.num_series \
                        and float(np.asarray(rc.matrix.values)[0, -1]) \
                        == want_count \
                        and float(np.asarray(rs.matrix.values)[0, -1]) \
                        == want_sum:
                    break
                time.sleep(0.25)
            else:
                raise AssertionError(
                    f"post-move parity never converged on {srv.node}: "
                    f"want count={want_count} sum={want_sum}")
        # the elasticity surface reports the move
        with urllib.request.urlopen(
                f"http://127.0.0.1:{a.http.port}/api/v1/cluster/status",
                timeout=10.0) as r:
            data = json.load(r)["data"]
        assert data["last_failover"]["event"] == "rebalance"
        assert data["last_failover"]["shard"] == mover
        assert str(mover) not in (data.get("epochs") or {}).get("shards", {})
    finally:
        stop_pub.set()
        for srv in servers.values():
            with contextlib.suppress(Exception):
                srv.shutdown()
        broker.stop()
        store.stop()


def test_cluster_status_and_cli_surface(tmp_path, capsys):
    """The operator surface: /api/v1/cluster/status carries the
    membership table, this node's shard epochs and the shard map, and
    `filo-cli cluster` renders them."""
    import threading

    from filodb_tpu_torch.cli import main as cli_main
    from filodb_tpu_torch.core.diststore import StoreServer

    store = StoreServer(str(tmp_path / "ring")).start()
    broker = BrokerServer(str(tmp_path / "broker"), 2).start()
    reg = str(tmp_path / "members")
    server = _two_node_cluster(tmp_path, broker.port,
                               f"127.0.0.1:{store.port}", reg)
    servers = {}
    threads = {n: threading.Thread(
        target=lambda n=n: servers.update({n: server(n).start()}))
        for n in ("node-a:1", "node-b:1")}
    for t in threads.values():
        t.start()
    for t in threads.values():
        t.join(timeout=30)
    a, b = servers["node-a:1"], servers["node-b:1"]
    try:
        # gossip agents converge on each other via registrar-published addrs
        deadline = time.time() + 15
        while time.time() < deadline:
            if a.gossip is not None and b.gossip is not None \
                    and a.gossip.table.state_of("node-b:1") == ALIVE \
                    and "node-b:1" in {m["node"]
                                       for m in a.gossip.table.rows()}:
                break
            time.sleep(0.25)
        else:
            raise AssertionError("gossip mesh never converged")
        rc = cli_main(["cluster",
                       "--host", f"http://127.0.0.1:{a.http.port}"])
        assert rc == 0
        out = capsys.readouterr().out
        assert "membership:" in out
        assert "node-b:1" in out and "state=alive" in out
        assert "shard epochs" in out
        assert "shard map:" in out and "prometheus/" in out
    finally:
        for srv in servers.values():
            with contextlib.suppress(Exception):
                srv.shutdown()
        broker.stop()
        store.stop()


# ---------------------------------------------------------------------------
# buddy-cluster failure routing (open windows -> stitched answers)
# ---------------------------------------------------------------------------

def test_buddy_routing_covers_open_known_bad_window():
    """An OPEN window (node died, not yet recovered) steers the
    overlapping tail of a range query to the buddy cluster; closing the
    window on recovery seals it as a normal routable-around range. The
    wrapper passes everything else (instant queries, metadata) through."""
    from filodb_tpu_torch.core.memstore import StoreConfig, TimeSeriesMemStore
    from filodb_tpu_torch.http.api import FiloHttpServer
    from filodb_tpu_torch.parallel.cluster import (FailureProvider,
                                             HighAvailabilityEngine,
                                             RemotePromExec)
    from filodb_tpu_torch.query.engine import QueryEngine

    def build():
        ms = TimeSeriesMemStore(device="cpu")
        cfg = StoreConfig(max_series_per_shard=8, samples_per_series=256,
                          flush_batch_size=10**9, dtype="float64")
        shard = ms.setup("prometheus", GAUGE, 0, cfg)
        b = RecordBuilder(GAUGE)
        for t in range(120):
            b.add({"_metric_": "m", "host": "h0"}, 1_000_000 + t * 10_000,
                  float(t))
        shard.ingest(b.build())
        shard.flush()
        return QueryEngine(ms, "prometheus", device="cpu")

    local, buddy = build(), build()
    srv = FiloHttpServer({"prometheus": buddy}, port=0).start()
    try:
        fp = FailureProvider()
        ha = HighAvailabilityEngine(
            local, fp,
            RemotePromExec(f"http://127.0.0.1:{srv.port}", "prometheus"))
        direct = local.query_range("sum_over_time(m[1m])", 1_200_000,
                                   1_900_000, 50_000)
        (_, dts, dvals), = list(direct.matrix.iter_series())
        # open window: everything from 1_500_000 on routes to the buddy
        fp.open_window("node-x", 1_500_000)
        r = ha.query_range("sum_over_time(m[1m])", 1_200_000, 1_900_000,
                           50_000)
        assert r.exec_path == "ha-stitched"
        (_, ts, vals), = list(r.matrix.iter_series())
        np.testing.assert_array_equal(ts, dts)
        np.testing.assert_allclose(vals, dvals)
        # recovery closes the window at 1_600_000: the sealed range still
        # routes around, later ranges serve locally again
        fp.close_window("node-x", 1_600_000)
        assert fp.open_windows() == {}
        r2 = ha.query_range("sum_over_time(m[1m])", 1_200_000, 1_900_000,
                            50_000)
        (_, ts2, vals2), = list(r2.matrix.iter_series())
        np.testing.assert_allclose(vals2, dvals)
        local_only = ha.query_range("sum_over_time(m[1m])", 1_700_000,
                                    1_900_000, 50_000)
        assert local_only.exec_path != "ha-stitched"
        # transparent passthrough: instant queries + metadata untouched
        inst = ha.query_instant("count(m)", 1_900_000)
        assert float(np.asarray(inst.matrix.values)[0, -1]) == 1.0
        assert ha.label_values("host") == ["h0"]
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# across packages: a port broker restarting on a JAX broker's data dir
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kill_at", [2, 5])
def test_port_broker_rejoins_on_a_jax_brokers_epochs(tmp_path, kill_at):
    """A fenced JAX replica pair whose leader dies mid-window (the JAX
    FaultPlan): the JAX survivor claims epoch 2. The dead node comes back
    as a PORT BrokerServer on the JAX node's data dir — its epochs.json,
    partition log and pub-id journal written by the JAX package — and
    REJOINs: it adopts the survivor's epoch, truncates any divergent tail,
    catches up byte for byte, and as a deposed leader refuses to ack."""
    import json
    from filodb_tpu.ingest.broker import BrokerServer as JBrokerServer
    from filodb_tpu.ingest.faults import FaultPlan as JFaultPlan
    from filodb_tpu.ingest.faults import FaultRule as JFaultRule
    pa, pb = reserve_port(), reserve_port()
    peers = [f"127.0.0.1:{pa}", f"127.0.0.1:{pb}"]
    plan = JFaultPlan([JFaultRule("append", "kill_server", partition=0,
                                  at_offset=kill_at)])
    a = JBrokerServer(str(tmp_path / "a"), 1, port=pa, peers=peers,
                      node_index=0, replication=2, fault_plan=plan,
                      epoch_fencing=True).start()
    b = JBrokerServer(str(tmp_path / "b"), 1, port=pb, peers=peers,
                      node_index=1, replication=2,
                      epoch_fencing=True).start()
    try:
        bus = sleepless_bus(peers, 0, publish_window=2, track_acks=True,
                            epoch_fencing=True)
        offs = bus.publish_batch([mk(f"k{i}") for i in range(8)])
        assert sorted(offs) == list(range(8))
        assert plan.fired and b.epochs.get(0) == (2, peers[1])
        with open(tmp_path / "a" / "epochs.json") as f:
            assert json.load(f)                 # the JAX node's own claims
        a2 = BrokerServer(str(tmp_path / "a"), 1, port=pa, peers=peers,
                          node_index=0, replication=2,
                          epoch_fencing=True).start()
        try:
            assert a2.epochs.get(0) == (2, peers[1])
            assert list(a2._parts[0].frames_from(0)) \
                == list(b._parts[0].frames_from(0))
            assert a2._journals[0].items() == b._journals[0].items()
            logged = {pid for _o, pid in b._journals[0].items()}
            assert set(bus.acked_ids) == logged and len(logged) == 8
            assert (tmp_path / "a" / "partition0.log").read_bytes() \
                == (tmp_path / "b" / "partition0.log").read_bytes()
            direct = sleepless_bus([peers[0]], 0, max_retries=1)
            with pytest.raises(RuntimeError, match="fenced"):
                direct.publish(mk("zombie"))
            direct.close()
            # the JAX leader keeps acking through the client
            assert bus.publish(mk("after")) == 8
        finally:
            a2.stop()
        bus.close()
    finally:
        with contextlib.suppress(Exception):
            a.stop()
        b.stop()
