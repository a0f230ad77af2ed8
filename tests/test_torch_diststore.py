"""The port's distributed durable chunk store: remote storage nodes,
replication with failover, time-range scan splits (ref: the reference's
``tests/test_diststore.py``, CassandraColumnStore's chunk/partkey/
checkpoint tables and getScanSplits), over port shards on the CPU; then
the packages against each other: a JAX StoreServer serves a port
RemoteStore and a port StoreServer a JAX one, byte for byte the same
files, and a shard persisted through one package's ring recovers through
the other's."""

import numpy as np
import pytest

from filodb_tpu_torch.core.diststore import (ReplicatedColumnStore, RemoteStore,
                                       StoreServer, get_scan_splits)
from filodb_tpu_torch.core.memstore import StoreConfig, TimeSeriesMemStore
from filodb_tpu_torch.core.record import RecordBuilder
from filodb_tpu_torch.core.schemas import GAUGE
from filodb_tpu_torch.core.store import ChunkSetRecord, FileColumnStore

BASE = 1_700_000_000_000
IV = 10_000


def _shard_with(sink, tmp=None):
    ms = TimeSeriesMemStore(device="cpu")
    cfg = StoreConfig(max_series_per_shard=8, samples_per_series=64,
                      flush_batch_size=10**9, groups_per_shard=2,
                      dtype="float64", device="cpu")
    return ms, ms.setup("prometheus", GAUGE, 0, cfg, sink=sink)


def _ingest_demo(shard, n=20):
    b = RecordBuilder(GAUGE)
    for t in range(n):
        for s in range(3):
            b.add({"_metric_": "m", "host": f"h{s}"}, BASE + t * IV,
                  float(s * 100 + t))
    shard.ingest(b.build(), offset=0)
    shard.flush_all_groups()


def test_remote_store_roundtrip_and_recovery(tmp_path):
    """A shard persisting to a remote storage node recovers from it — the
    full sink surface (chunks, part keys, meta, checkpoints) over TCP."""
    srv = StoreServer(str(tmp_path / "node0")).start()
    try:
        remote = RemoteStore(f"127.0.0.1:{srv.port}")
        ms, shard = _shard_with(remote)
        _ingest_demo(shard)
        ms2, shard2 = _shard_with(RemoteStore(f"127.0.0.1:{srv.port}"))
        replayed = shard2.recover()
        assert shard2.num_series == 3
        ts0, v0 = shard2.store.series_snapshot(0)
        assert len(ts0) == 20 and v0[-1] == 19.0
        cps = remote.read_checkpoints("prometheus", 0)
        assert set(cps.values()) == {0}
    finally:
        srv.stop()


def test_replication_and_failover(tmp_path):
    """RF=2 over three nodes: both replicas hold the data; losing one node
    keeps reads AND writes working (consistency ONE)."""
    servers = [StoreServer(str(tmp_path / f"node{i}")).start() for i in range(3)]
    stores = [RemoteStore(f"127.0.0.1:{s.port}") for s in servers]
    try:
        repl = ReplicatedColumnStore(stores, replication=2)
        ms, shard = _shard_with(repl)
        _ingest_demo(shard)
        # exactly two backends hold the shard's chunks
        holders = [i for i, st in enumerate(stores)
                   if list(st.read_chunksets("prometheus", 0))]
        assert len(holders) == 2
        # kill one replica: reads fail over, writes still succeed
        servers[holders[0]].stop()
        stores[holders[0]].close()
        recs = list(repl.read_chunksets("prometheus", 0))
        assert recs, "failover read returned nothing"
        b = RecordBuilder(GAUGE)
        b.add({"_metric_": "m", "host": "h0"}, BASE + 30 * IV, 99.0)
        shard.ingest(b.build(), offset=1)
        shard.flush_all_groups()       # write tolerated with one replica down
        # a fresh shard recovers through the surviving replica
        ms2, shard2 = _shard_with(
            ReplicatedColumnStore(stores, replication=2))
        shard2.recover()
        assert shard2.num_series == 3
        ts0, v0 = shard2.store.series_snapshot(0)
        assert v0[-1] == 99.0
    finally:
        for s in servers:
            try:
                s.stop()
            except Exception:
                pass


def test_lagging_replica_does_not_mask_complete_one(tmp_path):
    """A replica that missed appends during an outage answers with a gappy
    log; reads must serve the most complete replica, and checkpoints merge
    per-group max (read-best in place of read repair)."""
    a = FileColumnStore(str(tmp_path / "a"))
    b = FileColumnStore(str(tmp_path / "b"))
    repl = ReplicatedColumnStore([a, b], replication=2)
    ts1 = BASE + np.arange(10) * IV
    repl.write_chunkset("ds", 0, 0, [ChunkSetRecord(0, ts1, np.arange(10.0))])
    repl.write_checkpoint("ds", 0, 0, 5)
    # replica A "missed" the first write: wipe it, then both receive a second
    import shutil
    shutil.rmtree(tmp_path / "a")
    ts2 = BASE + (10 + np.arange(10)) * IV
    repl.write_chunkset("ds", 0, 0, [ChunkSetRecord(0, ts2, np.arange(10.0))])
    repl.write_checkpoint("ds", 0, 0, 9)
    total = sum(len(r.ts) for _g, recs in repl.read_chunksets("ds", 0)
                for r in recs)
    assert total == 20        # complete replica B wins, not gappy A
    assert repl.read_checkpoints("ds", 0) == {0: 9}


def test_all_replicas_down_raises(tmp_path):
    srv = StoreServer(str(tmp_path / "n0")).start()
    st = RemoteStore(f"127.0.0.1:{srv.port}")
    repl = ReplicatedColumnStore([st], replication=1)
    srv.stop()
    st.close()
    with pytest.raises(IOError):
        repl.write_part_keys("ds", 0, [(0, {"a": "b"}, 1)])


def test_scan_splits_align_and_cover(tmp_path):
    store = FileColumnStore(str(tmp_path))
    ts = BASE + np.arange(0, 700) * IV          # ~117 minutes of data
    store.write_chunkset("ds", 0, 0, [ChunkSetRecord(0, ts, np.arange(700.0))])
    splits = get_scan_splits(store, "ds", 0, 4, align_ms=60_000)
    assert 1 <= len(splits) <= 4
    # aligned starts, disjoint, covering
    for i, (lo, hi) in enumerate(splits):
        assert lo % 60_000 == 0
        assert (hi + 1) % 60_000 == 0
        if i:
            assert lo == splits[i - 1][1] + 1
    assert splits[0][0] <= int(ts[0]) and splits[-1][1] >= int(ts[-1])
    assert get_scan_splits(store, "ds", 7, 4) == []   # empty shard


def test_batch_downsample_over_splits_matches_single_pass(tmp_path):
    """Mapping the batch downsampler over scan splits (the Spark-over-token-
    ranges analog) produces the same records as one full pass."""
    from filodb_tpu_torch.jobs.batch_downsampler import run_batch_downsample
    RES = 60_000
    store = FileColumnStore(str(tmp_path / "a"))
    store2 = FileColumnStore(str(tmp_path / "b"))
    ts = BASE + np.arange(0, 360) * IV
    vals = np.sin(np.arange(360.0)) * 10 + 50
    for st in (store, store2):
        st.write_chunkset("ds", 0, 0, [ChunkSetRecord(0, ts, vals)])
        st.write_part_keys("ds", 0, [(0, {"_metric_": "m"}, int(ts[0]))])
    run_batch_downsample(store, "ds", 0, RES)
    for lo, hi in get_scan_splits(store2, "ds", 0, 3, align_ms=RES):
        run_batch_downsample(store2, "ds", 0, RES, start_ms=lo, end_ms=hi)
    cols = store.read_meta("ds:ds_1m", 0)["columns"]
    ci = cols.index("dAvg")
    one = {r.part_id: r for _g, recs in
           store.read_chunksets("ds:ds_1m", 0) for r in recs}
    # split runs append multiple chunksets; merge by time
    split_ts, split_v = [], []
    for _g, recs in store2.read_chunksets("ds:ds_1m", 0):
        for r in recs:
            split_ts.append(r.ts)
            split_v.append(np.asarray(r.values)[:, ci])
    st_all = np.concatenate(split_ts)
    sv_all = np.concatenate(split_v)
    order = np.argsort(st_all)
    np.testing.assert_array_equal(st_all[order], one[0].ts)
    np.testing.assert_allclose(sv_all[order],
                               np.asarray(one[0].values)[:, ci])


# -- streaming/checkpoint ops, bounded timeouts, failover counter ----------

def test_crc_verified_append_refuses_corrupt_frame(tmp_path):
    """OP_APPEND_CRC: the server recomputes the payload checksum and refuses
    a damaged frame — nothing lands in the log (a bad frame would hide every
    later good one behind the WAL parser's truncation)."""
    import zlib
    from filodb_tpu_torch.core.diststore import OP_APPEND_CRC
    from filodb_tpu_torch.core.store import encode_chunkset
    srv = StoreServer(str(tmp_path / "n0")).start()
    try:
        st = RemoteStore(f"127.0.0.1:{srv.port}")
        buf = encode_chunkset(0, [ChunkSetRecord(
            0, BASE + np.arange(4) * IV, np.arange(4.0))])
        with pytest.raises(IOError, match="crc mismatch"):
            st._request(OP_APPEND_CRC, "ds", 0, "chunks.log", buf,
                        crc=zlib.crc32(buf) ^ 0xDEAD)
        assert st.chunk_log_size("ds", 0) == 0
        # the good frame (write_chunkset computes the crc) lands
        st.write_chunkset("ds", 0, 0, [ChunkSetRecord(
            0, BASE + np.arange(4) * IV, np.arange(4.0))])
        assert st.chunk_log_size("ds", 0) > 0
        assert sum(len(r.ts) for _g, recs in st.read_chunksets("ds", 0)
                   for r in recs) == 4
    finally:
        srv.stop()


def test_checkpoint_op_merges_atomically_across_groups(tmp_path):
    """OP_CHECKPOINT is a single server-side merge: concurrent groups can
    no longer lose each other's watermark to the old client
    read-modify-write (two groups committing at once raced on
    checkpoint.json)."""
    import threading
    srv = StoreServer(str(tmp_path / "n0")).start()
    try:
        st = RemoteStore(f"127.0.0.1:{srv.port}")
        # each group checkpoints over its own connection, concurrently
        clients = [RemoteStore(f"127.0.0.1:{srv.port}") for _ in range(8)]
        threads = [threading.Thread(target=clients[g].write_checkpoint,
                                    args=("ds", 0, g, 100 + g))
                   for g in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert st.read_checkpoints("ds", 0) == {g: 100 + g for g in range(8)}
    finally:
        srv.stop()


def test_dead_backend_times_out_and_fails_over(tmp_path):
    """A backend that accepts connections but never answers (dead disk,
    wedged node) must not stall the read: the bounded read timeout fails it
    over to the healthy replica and counts the failover."""
    import socket
    from filodb_tpu_torch.utils.metrics import (FILODB_RETENTION_REPLICA_FAILOVER,
                                          registry)
    # black hole: accepts and then ignores the connection
    hole = socket.socket()
    hole.bind(("127.0.0.1", 0))
    hole.listen(4)
    srv = StoreServer(str(tmp_path / "good")).start()
    try:
        dead = RemoteStore(f"127.0.0.1:{hole.getsockname()[1]}",
                           timeout_s=0.3, connect_timeout_s=0.3)
        live = RemoteStore(f"127.0.0.1:{srv.port}")
        live.write_part_keys("prometheus", 0, [(0, {"_metric_": "m"}, 1)])
        live.write_chunkset("prometheus", 0, 0, [ChunkSetRecord(
            0, BASE + np.arange(4) * IV, np.arange(4.0))])
        repl = ReplicatedColumnStore([dead, live], replication=2)
        c = registry.counter(FILODB_RETENTION_REPLICA_FAILOVER,
                             {"op": "read_part_keys"})
        before = c.value
        keys = list(repl.read_part_keys("prometheus", 0))
        assert len(keys) == 1
        assert c.value > before       # the dead replica's failure counted
        recs = list(repl.read_chunksets("prometheus", 0))
        assert recs and len(recs[0][1][0].ts) == 4
    finally:
        srv.stop()
        hole.close()


def test_stop_severs_established_connections_and_reads_fail_over(tmp_path):
    """StoreServer.stop() must reset pooled client sockets, not just close
    the listener: RemoteStore keeps one connection open, so a handler
    thread blocked in recv would keep SERVING a "stopped" node forever —
    an in-process kill has to look like a process kill for the
    ReplicatedColumnStore failover path (and its counter) to engage."""
    from filodb_tpu_torch.utils.metrics import (FILODB_RETENTION_REPLICA_FAILOVER,
                                          registry)
    a = StoreServer(str(tmp_path / "a")).start()
    b = StoreServer(str(tmp_path / "b")).start()
    try:
        repl = ReplicatedColumnStore(
            [RemoteStore(f"127.0.0.1:{a.port}", timeout_s=2.0,
                         connect_timeout_s=1.0),
             RemoteStore(f"127.0.0.1:{b.port}", timeout_s=2.0,
                         connect_timeout_s=1.0)], replication=2)
        repl.write_chunkset("ds", 0, 0, [ChunkSetRecord(
            0, BASE + np.arange(4) * IV, np.arange(4.0))])
        # both replicas hold the frame and both client sockets are pooled
        n0 = sum(len(r.ts) for _g, recs in repl.read_chunksets("ds", 0, 0,
                 BASE + 10 * IV) for r in recs)
        assert n0 == 4
        c = registry.counter(FILODB_RETENTION_REPLICA_FAILOVER,
                             {"op": "read_chunksets"})
        before = c.value
        a.stop()                       # no client-side close(): stop() alone
        n1 = sum(len(r.ts) for _g, recs in repl.read_chunksets("ds", 0, 0,
                 BASE + 10 * IV) for r in recs)
        assert n1 == 4                 # served by the survivor
        assert c.value > before        # the severed replica counted as
                                       # a failover, not silently served
    finally:
        for s in (a, b):
            try:
                s.stop()
            except Exception:  # noqa: BLE001 - already stopped
                pass


def test_ranged_read_detects_concurrent_age_out_rewrite(tmp_path):
    """An age-out commit (OP_COMMIT atomic rename) swaps chunks.log under a
    lock-free ranged reader: offsets from the old file land mid-frame in
    the rewritten one and iter_chunksets would silently truncate. The
    client brackets the read with the server's commit generation and
    raises instead — the replicated layer turns that into failover, the
    direct caller into a retry, never into a partial answer served as
    complete."""
    srv = StoreServer(str(tmp_path / "node0")).start()
    try:
        st = RemoteStore(f"127.0.0.1:{srv.port}")
        for g in range(2):
            st.write_chunkset("ds", 0, g, [ChunkSetRecord(
                g, BASE + np.arange(6) * IV, np.arange(6.0))])
        # a clean read completes (same generation on both sides)
        assert len(list(st.read_chunksets("ds", 0))) == 2
        it = st.read_chunksets("ds", 0)
        next(it)                               # generation captured
        st2 = RemoteStore(f"127.0.0.1:{srv.port}")
        dropped = st2.age_out("ds", 0, BASE + 100 * IV)   # rewrite + commit
        assert dropped == 12
        with pytest.raises(IOError, match="rewritten"):
            list(it)                           # exhaust -> detect the swap
        st.close()
        st2.close()
    finally:
        srv.stop()


def test_age_out_steady_state_skips_full_pass(tmp_path):
    """Between TTL boundaries nothing is past the cutoff: the head-frame
    probe must skip the whole read-decode-rewrite pass (local and remote)
    instead of materializing the full log to drop zero samples."""
    import filodb_tpu_torch.core.diststore as dst
    import filodb_tpu_torch.core.store as cst

    local = FileColumnStore(str(tmp_path / "local"))
    local.write_chunkset("ds", 0, 0, [ChunkSetRecord(
        0, BASE + np.arange(6) * IV, np.arange(6.0))])
    srv = StoreServer(str(tmp_path / "node0")).start()
    try:
        remote = RemoteStore(f"127.0.0.1:{srv.port}")
        remote.write_chunkset("ds", 0, 0, [ChunkSetRecord(
            0, BASE + np.arange(6) * IV, np.arange(6.0))])
        orig = cst.encode_age_out

        def _must_not_run(*_a, **_k):
            raise AssertionError("full age-out pass ran in steady state")

        cst.encode_age_out = dst.encode_age_out = _must_not_run
        try:
            assert local.age_out("ds", 0, BASE) == 0          # cutoff <= head
            assert remote.age_out("ds", 0, BASE) == 0
        finally:
            cst.encode_age_out = dst.encode_age_out = orig
        # once the head frame itself ages past the cutoff the pass runs
        assert local.age_out("ds", 0, BASE + 3 * IV) == 3
        assert remote.age_out("ds", 0, BASE + 3 * IV) == 3
        remote.close()
    finally:
        srv.stop()


# -- the packages against each other -----------------------------------------

def _tree(root):
    import os
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _jax_shard(sink):
    from filodb_tpu.core.memstore import StoreConfig as JStoreConfig
    from filodb_tpu.core.memstore import TimeSeriesMemStore as JMemStore
    from filodb_tpu.core.schemas import GAUGE as JGAUGE
    ms = JMemStore()
    cfg = JStoreConfig(max_series_per_shard=8, samples_per_series=64,
                       flush_batch_size=10**9, groups_per_shard=2,
                       dtype="float64")
    return ms, ms.setup("prometheus", JGAUGE, 0, cfg, sink=sink)


def _jax_ingest_demo(shard, n=20):
    from filodb_tpu.core.record import RecordBuilder as JRecordBuilder
    from filodb_tpu.core.schemas import GAUGE as JGAUGE
    b = JRecordBuilder(JGAUGE)
    for t in range(n):
        for s in range(3):
            b.add({"_metric_": "m", "host": f"h{s}"}, BASE + t * IV,
                  float(s * 100 + t))
    shard.ingest(b.build(), offset=0)
    shard.flush_all_groups()


@pytest.mark.parametrize("server_pkg", ["jax", "port"])
def test_store_servers_interoperate_byte_for_byte(tmp_path, server_pkg):
    """A port shard persists through a RemoteStore to either package's
    StoreServer, a JAX shard to the other server kind: every file on the
    two servers' disks is byte for byte the same, and a port shard
    recovers from either."""
    from filodb_tpu.core import diststore as jds
    other = "port" if server_pkg == "jax" else "jax"
    mk = {"jax": jds.StoreServer, "port": StoreServer}
    remote = {"jax": jds.RemoteStore, "port": RemoteStore}
    srv_a = mk[server_pkg](str(tmp_path / "a")).start()
    srv_b = mk[other](str(tmp_path / "b")).start()
    try:
        # the port client writes to server a, the JAX client to server b
        _ms, shard = _shard_with(RemoteStore(f"127.0.0.1:{srv_a.port}"))
        _ingest_demo(shard)
        _jms, jshard = _jax_shard(jds.RemoteStore(f"127.0.0.1:{srv_b.port}"))
        _jax_ingest_demo(jshard)
        assert _tree(tmp_path / "a") == _tree(tmp_path / "b")
        for srv in (srv_a, srv_b):
            _ms2, shard2 = _shard_with(RemoteStore(f"127.0.0.1:{srv.port}"))
            shard2.recover()
            assert shard2.num_series == 3
            ts0, v0 = shard2.store.series_snapshot(0)
            assert len(ts0) == 20 and v0[-1] == 19.0
        # the other package's client reads the same chunks back
        jrecs = list(remote[other](f"127.0.0.1:{srv_a.port}")
                     .read_chunksets("prometheus", 0))
        trecs = list(RemoteStore(f"127.0.0.1:{srv_b.port}")
                     .read_chunksets("prometheus", 0))
        assert [(g, [(r.part_id, r.ts.tolist(),
                      np.asarray(r.values).tolist()) for r in recs])
                for g, recs in jrecs] == \
            [(g, [(r.part_id, r.ts.tolist(), np.asarray(r.values).tolist())
                  for r in recs]) for g, recs in trecs]
    finally:
        srv_a.stop()
        srv_b.stop()


def test_port_ring_over_jax_servers_recovers_after_a_loss(tmp_path):
    """RF=2 over three JAX StoreServers, written and read by the port's
    ReplicatedColumnStore: one server stopped, the port shard recovers
    from the survivors; the JAX client's read of the same ring agrees."""
    from filodb_tpu.core import diststore as jds
    servers = [jds.StoreServer(str(tmp_path / f"n{i}")).start()
               for i in range(3)]
    try:
        stores = [RemoteStore(f"127.0.0.1:{s.port}") for s in servers]
        _ms, shard = _shard_with(ReplicatedColumnStore(stores, 2))
        _ingest_demo(shard)
        holders = [i for i, st in enumerate(stores)
                   if list(st.read_chunksets("prometheus", 0))]
        assert len(holders) == 2
        servers[holders[0]].stop()
        stores[holders[0]].close()
        _ms2, shard2 = _shard_with(ReplicatedColumnStore(
            [RemoteStore(f"127.0.0.1:{s.port}") for s in servers], 2))
        shard2.recover()
        assert shard2.num_series == 3
        jrepl = jds.ReplicatedColumnStore(
            [jds.RemoteStore(f"127.0.0.1:{s.port}") for s in servers], 2)
        assert sum(len(r.ts) for _g, recs in
                   jrepl.read_chunksets("prometheus", 0) for r in recs) == 60
    finally:
        for s in servers:
            try:
                s.stop()
            except Exception:  # noqa: BLE001 - already stopped
                pass
