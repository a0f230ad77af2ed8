"""TCP log broker — the Kafka-broker-equivalent data plane.

Reference: kafka/src/main/scala/filodb/kafka/KafkaIngestionStream.scala (one
shard == one partition; consumers seek to the checkpointed offset and replay)
and PartitionStrategy (shard -> partition routing). The reference outsources
the broker to Kafka; here the broker itself is part of the framework: a
threaded TCP server fronting one durable append-only log per partition (the
same offset-addressed frame format as FileBus, so logs are interchangeable
between in-process and brokered deployments).

Wire protocol (all little-endian, one request/response per round trip):

  request  = op:u8  partition:u32  offset:u64  payload_len:u32  payload
  response = status:u8  offset:u64  payload_len:u32  payload

  ops: PUBLISH (payload=container bytes; the offset field carries a random
                nonzero publish id — the broker remembers recent ids per
                partition and returns the original offset on a retry instead
                of appending a duplicate; returns assigned offset)
       FETCH   (offset=from_offset; payload_len field carries max_frames;
                returns concatenated [offset:u64 len:u32 bytes] entries)
       END     (returns the partition's end offset)
       PUBLISH_BATCH (payload=concatenated [pub_id:u64 len:u32 bytes] frames —
                MANY publishes per round trip, the publish-side mirror of
                FETCH's response batching; the offset field carries the frame
                count. Per-frame publish ids keep retries duplicate-free
                exactly like PUBLISH. Response payload: one u64 assigned
                offset per frame, in request order)
       ops >= 16 are the replication stream (ingest/replication.py:
                OP_REPLICATE — leader->follower CRC-checked frame batches).

  statuses: OK, ERR (payload = error message), RETRY (backpressure shed:
  quorum stall or per-partition queue overload; the offset field carries a
  retry-after hint in ms that clients honor as their backoff floor).

`BrokerBus` is a drop-in for FileBus (publish/consume/end_offset), so the
standalone server's IngestionConsumer works unchanged against a remote broker.
Its windowed publisher (`publish_async`/`publish_batch`/`flush_publishes`)
pipelines PUBLISH_BATCH requests: F frames with window W cost at most
ceil(F/W) round trips, and all of a drain's requests are on the wire before
the first response is read.

Replication + failure handling (ingest/replication.py): a BrokerServer
given a ``peers`` list replicates each partition to R nodes and acks
publishes only when >= ``min_insync`` replicas hold the frames (ST_RETRY
sheds otherwise — quorum-stall backpressure; the per-partition admission
cap sheds overload the same way). BrokerBus accepts the whole replica
address LIST: on a dead leader it re-ranks survivors by replication
watermark (highest wins, lowest index breaks ties — every publisher picks
the same survivor) and replays the unacked window with the SAME publish
ids, which the new leader resolves from its replicated id journal — the
handoff is duplicate-free end to end. Client retries use jittered
exponential backoff (``filodb_ingest_retries``); a persistently-dead
partition trips the PR-2 PeerBreaker so publishers shed fast instead of
paying connect timeouts forever.
"""

from __future__ import annotations

import logging
import os
import random
import socket
import socketserver
import struct
import threading
import time
from typing import Iterator

from ..core.record import RecordContainer
from ..utils.metrics import (FILODB_CLUSTER_FENCED_REJECTS,
                             FILODB_CLUSTER_REJOIN_TRUNCATED,
                             FILODB_INGEST_FAILOVERS, FILODB_INGEST_RETRIES,
                             FILODB_INGEST_PUBLISH_LATENCY_MS,
                             FILODB_INGEST_PUBLISH_SHED, registry)
from ..utils.tracing import (SPAN_BROKER_APPEND, SPAN_CLUSTER_REJOIN,
                             SPAN_INGEST_PUBLISH, span, tracer)
from .bus import FileBus

log = logging.getLogger("filodb_tpu_torch.broker")

_REQ = struct.Struct("<B I Q I")
_RESP = struct.Struct("<B Q I")
_ENTRY = struct.Struct("<Q I")

OP_PUBLISH, OP_FETCH, OP_END, OP_PUBLISH_BATCH = 1, 2, 3, 4
ST_OK, ST_ERR, ST_RETRY = 0, 1, 2

# trace-context block riding PUBLISH_BATCH (and OP_REPLICATE) payloads:
# ``u16 len + JSON context``, stripped server-side BEFORE frame parsing —
# durable log frames never carry it. pack/unpack are the one encode/decode
# pair; filolint's wire-trace-parity rule fails tier-1 when either the
# BrokerBus sender or the _serve receiver stops calling its side.
_TRACE_HDR = struct.Struct("<H")


def pack_trace_hdr(ctx: dict | None) -> bytes:
    import json
    blob = json.dumps(ctx, separators=(",", ":")).encode() if ctx else b""
    return _TRACE_HDR.pack(len(blob)) + blob


def unpack_trace_hdr(payload: bytes) -> tuple[dict | None, bytes]:
    """(context or None, payload with the block stripped). Malformed blocks
    degrade to no-context — a trace must never fail a publish."""
    import json
    try:
        (ln,) = _TRACE_HDR.unpack_from(payload, 0)
        body = payload[_TRACE_HDR.size:]
        if ln > len(body):
            return None, payload        # not a trace block: pass through
        ctx = json.loads(body[:ln]) if ln else None
        return (ctx if isinstance(ctx, dict) else None), body[ln:]
    except (struct.error, ValueError):
        return None, payload


class BrokerRetry(RuntimeError):
    """The broker shed the publish (quorum stall or queue-depth overload)
    and the client exhausted its backoff budget. Carries the server's
    retry-after hint; the HTTP layer maps this to 429 + Retry-After."""

    def __init__(self, retry_after_s: float = 1.0):
        super().__init__(
            f"broker backpressure: retry after {retry_after_s:.3f}s")
        self.retry_after_s = float(retry_after_s)

_MAX_PAYLOAD = 64 << 20     # refuse absurd frames instead of OOMing
_RECENT_IDS_MAX = 4096      # retry-able publish ids remembered per partition
_MAX_BATCH_BYTES = 8 << 20  # per-PUBLISH_BATCH payload bound (well under
                            # _MAX_PAYLOAD, so the broker never severs a
                            # batched connection for size)
# unacked frames per pipelined group: half the broker's id window, so a full
# group replay after a lost connection still resolves every id (no silent
# duplicates), and the unread-response backlog stays far below socket buffers
_MAX_UNACKED_FRAMES = _RECENT_IDS_MAX // 2


def _remember_id(recent: dict[int, int], pub_id: int, off: int,
                 limit: int) -> None:
    """Record a publish id -> offset (caller holds the partition's publish
    lock). Eviction is strictly oldest-first, one at a time — dicts iterate
    in insertion order and retry hits re-insert, so a recently retried id is
    never the one evicted."""
    recent[pub_id] = off
    while len(recent) > limit:
        recent.pop(next(iter(recent)))


def _recall_id(recent: dict[int, int], pub_id: int) -> int | None:
    """Offset of an already-seen publish id, refreshing its recency (caller
    holds the partition's publish lock)."""
    off = recent.pop(pub_id, None)
    if off is not None:
        recent[pub_id] = off
    return off


from ..utils.netio import recv_exact as _recv_exact  # noqa: E402 - shared framing helper


class BrokerServer:
    """Hosts partitions 0..num_partitions-1, each a durable FileBus log."""

    def __init__(self, data_dir: str, num_partitions: int,
                 host: str = "127.0.0.1", port: int = 0,
                 recent_ids_max: int = _RECENT_IDS_MAX,
                 peers: list[str] | None = None, node_index: int = 0,
                 replication: int = 1, min_insync: int = 1,
                 max_queue: int = 256, fault_plan=None,
                 epoch_fencing: bool = False):
        """``recent_ids_max`` below the default weakens the windowed
        publisher's replay idempotence: BrokerBus bounds a pipelined group to
        ``_RECENT_IDS_MAX // 2`` unacked frames on the assumption the server
        remembers at least the module default — shrink it only in tests that
        exercise eviction itself.

        ``peers``/``node_index``/``replication``/``min_insync`` enable the
        replicated tier (ingest/replication.py): partitions replicate to R
        of the peer nodes and publishes ack only at >= min_insync in-sync
        replicas. ``max_queue`` caps concurrent in-flight publishes per
        partition (overload sheds ST_RETRY). ``fault_plan`` wires the
        deterministic fault-injection hooks (ingest/faults.py).

        ``epoch_fencing`` enables monotonic leadership epochs
        (cluster/epoch.py, persisted in ``data_dir``): a publish or
        replication batch below the partition's current epoch is refused,
        so a deposed leader can never ack after deposition, and
        ``start()`` runs the REJOIN repair (truncate a divergent tail,
        catch up from the current leader) before serving."""
        from .replication import PubIdJournal, Replicator
        os.makedirs(data_dir, exist_ok=True)
        self.peers = list(peers or [])
        self.node_index = int(node_index)
        self.epochs = None
        if epoch_fencing:
            from ..cluster.epoch import PartitionEpochs
            self.epochs = PartitionEpochs(os.path.join(data_dir,
                                                       "epochs.json"))
        self._parts = [FileBus(os.path.join(data_dir, f"partition{p}.log"))
                       for p in range(num_partitions)]
        # publish idempotence: recent publish-id -> offset per partition, so a
        # client retry after a lost response doesn't append a duplicate frame
        self._recent_ids: list[dict[int, int]] = [{} for _ in range(num_partitions)]
        self._recent_ids_max = int(recent_ids_max)
        self._publish_locks = [threading.Lock() for _ in range(num_partitions)]
        # durable offset -> pub-id journal per partition: restart-proof
        # idempotence, replication id carry-over, and the soak audit surface
        self._journals = [PubIdJournal(os.path.join(data_dir,
                                                    f"partition{p}.pubids"))
                          for p in range(num_partitions)]
        for p in range(num_partitions):
            self._journals[p].seed_recent(self._recent_ids[p],
                                          self._recent_ids_max)
        self.fault_plan = fault_plan
        self._repl: Replicator | None = None
        if peers and len(peers) > 1 and replication > 1:
            self._repl = Replicator(self, peers, node_index, replication,
                                    min_insync=min_insync,
                                    fault_plan=fault_plan)
        # per-partition admission: concurrent in-flight publishes above
        # max_queue shed with ST_RETRY instead of queueing unboundedly
        self._max_queue = max(1, int(max_queue))
        self._inflight = [0] * num_partitions
        self._admit_lock = threading.Lock()
        self._shed = registry.counter(FILODB_INGEST_PUBLISH_SHED)
        self._stopped = False
        # live client connections, so stop() actually severs them (handler
        # threads would otherwise keep serving a "stopped" broker)
        self._conns: set[socket.socket] = set()
        self._conns_lock = threading.Lock()
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                with outer._conns_lock:
                    outer._conns.add(self.request)
                try:
                    while True:
                        hdr = _recv_exact(self.request, _REQ.size)
                        op, part, offset, plen = _REQ.unpack(hdr)
                        # replication ops (>= 16) get header headroom: a
                        # max-size accepted publish frame must still fit
                        # its OP_REPLICATE envelope (24B/frame; batches
                        # are byte-chunked leader-side)
                        limit = _MAX_PAYLOAD + (64 << 10) if op >= 16 \
                            else _MAX_PAYLOAD
                        if plen > limit:
                            raise ValueError(f"frame too large: {plen}")
                        # FETCH/END overload the length field as a count —
                        # every other op carries a real payload
                        payload = _recv_exact(self.request, plen) \
                            if op not in (OP_FETCH, OP_END) and plen \
                            else b""
                        resp = outer._serve(op, part, offset, plen, payload)
                        if resp is None:
                            break       # fault injection: sever, no reply
                        self.request.sendall(resp)
                except (ConnectionError, OSError):
                    pass    # client went away or the broker is stopping
                finally:
                    with outer._conns_lock:
                        outer._conns.discard(self.request)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self._thread: threading.Thread | None = None

    def _serve(self, op: int, part: int, offset: int, plen: int,
               payload: bytes) -> bytes | None:
        from ..cluster.gossip import CLUSTER_OPS, serve_cluster
        from .replication import OP_REPLICATE, serve_replication
        try:
            if op in CLUSTER_OPS:
                # membership/epoch/sync control plane (cluster/gossip.py);
                # partition bounds are checked per-op there (OP_EPOCH_* may
                # address partitions this node only replicates)
                return serve_cluster(self, op, part, payload)
            if not 0 <= part < len(self._parts):
                raise ValueError(f"no partition {part}")
            bus = self._parts[part]
            if op in (OP_PUBLISH, OP_PUBLISH_BATCH):
                tctx = None
                if op == OP_PUBLISH_BATCH:
                    # trace block stripped BEFORE frame parsing: the spans
                    # this append records join the publisher's trace, and
                    # the durable log never sees the block
                    tctx, payload = unpack_trace_hdr(payload)
                if not self._admit(part):
                    self._shed.increment()
                    return _RESP.pack(ST_RETRY, 100, 0)   # retry hint (ms)
                try:
                    with tracer.activate(tctx), \
                            span(SPAN_BROKER_APPEND, partition=part,
                                 broker=self.port):
                        resp = self._serve_publish(op, part, offset,
                                                   payload, bus)
                    # fault hook INSIDE the admission slot: a delayed
                    # response occupies partition capacity exactly like a
                    # slow disk/replica would
                    return self._fault_response(op, part, resp)
                finally:
                    self._release(part)
            if op == OP_REPLICATE:
                return serve_replication(self, op, part, payload)
            if op == OP_FETCH:
                max_frames = plen or 1024
                out = bytearray()
                n = 0
                for off, frame in bus.frames_from(offset):
                    out += _ENTRY.pack(off, len(frame))
                    out += frame
                    n += 1
                    if n >= max_frames:
                        break
                return _RESP.pack(ST_OK, bus.end_offset, len(out)) + bytes(out)
            if op == OP_END:
                return _RESP.pack(ST_OK, bus.end_offset, 0)
            raise ValueError(f"unknown op {op}")
        except Exception as e:  # noqa: BLE001 — delivered to the client
            msg = str(e).encode()[:1024]
            return _RESP.pack(ST_ERR, 0, len(msg)) + msg

    def _serve_publish(self, op: int, part: int, offset: int,
                       payload: bytes, bus: FileBus) -> bytes:
        """PUBLISH / PUBLISH_BATCH under the partition publish lock:
        recall-or-append with idempotent ids, journal fresh pub-ids, then
        replicate to quorum before acking."""
        jrnl = self._journals[part]
        with self._publish_locks[part]:
            fenced = self._fence_resp(part)
            if fenced is not None:
                return fenced
            recent = self._recent_ids[part]
            if op == OP_PUBLISH:
                pub_id = offset             # request offset field = publish id
                off = _recall_id(recent, pub_id) if pub_id else None
                appended = []
                if off is None:
                    off = bus.publish_bytes(payload)
                    if pub_id:
                        jrnl.append(off, pub_id)
                        _remember_id(recent, pub_id, off,
                                     self._recent_ids_max)
                    appended = [(off, pub_id, payload)]
                resp = _RESP.pack(ST_OK, off, 0)
            else:
                entries = []                # (pub_id, frame bytes)
                pos = 0
                while pos < len(payload):
                    pid, ln = _ENTRY.unpack_from(payload, pos)
                    pos += _ENTRY.size
                    entries.append((pid, payload[pos:pos + ln]))
                    pos += ln
                offs = [0] * len(entries)
                fresh: list[int] = []       # indexes needing an append
                first_idx: dict[int, int] = {}
                alias: dict[int, int] = {}  # in-batch duplicate ids
                for i, (pid, _frame) in enumerate(entries):
                    off = _recall_id(recent, pid) if pid else None
                    if off is not None:
                        offs[i] = off
                    elif pid and pid in first_idx:
                        alias[i] = first_idx[pid]
                    else:
                        fresh.append(i)
                        if pid:
                            first_idx[pid] = i
                # one open+write for the whole batch — per-frame appends
                # would re-open the log file once per frame
                new_offs = bus.publish_many_bytes(
                    [entries[i][1] for i in fresh])
                appended = []
                for i, off in zip(fresh, new_offs):
                    offs[i] = off
                    pid = entries[i][0]
                    appended.append((off, pid, entries[i][1]))
                    if pid:
                        _remember_id(recent, pid, off, self._recent_ids_max)
                # one journal open+write per batch (hot-path parity with
                # publish_many_bytes)
                jrnl.append_many([(off, pid) for off, pid, _f in appended
                                  if pid])
                for i, j in alias.items():
                    offs[i] = offs[j]
                body = struct.pack(f"<{len(offs)}Q", *offs)
                resp = _RESP.pack(ST_OK, bus.end_offset, len(body)) + body
            # kill-at-offset fault (leader death mid-stream) fires BEFORE
            # the ack: the client never learns the frames' offsets and must
            # replay them at the survivor
            if self.fault_plan is not None and appended:
                act = self.fault_plan.decide("append", partition=part,
                                             offset=bus.end_offset)
                if act is not None and act.action == "kill_server":
                    self._kill_async()
                    return None
            # quorum: ack only once >= min_insync replicas hold the log up
            # to end (the just-appended frames ride along so the steady
            # state skips the log re-read); on a stall the frames stay
            # appended and the client's idempotent replay re-drives this
            if self._repl is not None:
                ok, hint = self._repl.ensure(part, bus.end_offset,
                                             fresh=appended or None)
                # a follower may have fenced us DURING ensure (we adopted
                # its higher epoch and stepped down): the ack must be
                # refused, not retried — the client fails over and replays
                # with the same pub-ids at the real leader
                fenced = self._fence_resp(part)
                if fenced is not None:
                    return fenced
                if not ok:
                    self._shed.increment()
                    return _RESP.pack(ST_RETRY, hint, 0)
            return resp

    def _fence_resp(self, part: int) -> bytes | None:
        """ST_ERR fenced refusal when this node is not the partition's
        current epoch owner (epoch 0 = unclaimed: legacy convention
        leadership still applies). Caller holds the publish lock."""
        if self.epochs is None:
            return None
        e, owner = self.epochs.get(part)
        if e == 0 or owner == self.self_addr:
            return None
        from ..cluster.gossip import fence_message
        registry.counter(FILODB_CLUSTER_FENCED_REJECTS,
                         {"site": "publish"}).increment()
        msg = fence_message(part, e, owner)
        return _RESP.pack(ST_ERR, 0, len(msg)) + msg.encode()

    def _admit(self, part: int) -> bool:
        with self._admit_lock:
            if self._inflight[part] >= self._max_queue:
                return False
            self._inflight[part] += 1
            return True

    def _release(self, part: int) -> None:
        with self._admit_lock:
            self._inflight[part] -= 1

    def _fault_response(self, op: int, part: int,
                        resp: bytes | None) -> bytes | None:
        """serve-site fault hook: drop_response severs without replying
        (the lost-response shape); delay holds the ack."""
        if resp is None or self.fault_plan is None:
            return resp
        act = self.fault_plan.decide("serve", partition=part, op=op)
        if act is None:
            return resp
        if act.action == "drop_response":
            return None
        if act.action == "delay" and act.delay_s > 0:
            time.sleep(act.delay_s)
        return resp

    def _frames_with_ids(self, part: int, lo: int, hi: int,
                         max_bytes: int) -> list[tuple[int, int, bytes]]:
        """Log tail [lo, hi) with journaled pub-ids — the replication
        catch-up read (caller holds the partition's publish lock)."""
        out: list[tuple[int, int, bytes]] = []
        total = 0
        jrnl = self._journals[part]
        for off, frame in self._parts[part].frames_from(lo):
            if off >= hi:
                break
            out.append((off, jrnl.get(off), frame))
            total += len(frame)
            if total >= max_bytes:
                break
        return out

    def _kill_async(self) -> None:
        """Fault injection: die like a crashed node — sever every client
        and stop serving, from a side thread (stop() joins the serve
        thread, so it cannot run on the handler thread itself)."""
        def die():
            try:
                self.stop()
            except Exception:  # noqa: BLE001 — a fault-injected death must
                # still tear the server down visibly, not hang half-dead
                log.exception("fault-injected broker kill failed")

        threading.Thread(target=die, daemon=True,
                         name="filo-broker-kill").start()

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    @property
    def self_addr(self) -> str:
        """This node's cluster identity: its entry in the shared peers
        list (epoch owners are recorded by this address)."""
        if self.peers and 0 <= self.node_index < len(self.peers):
            return self.peers[self.node_index]
        return f"127.0.0.1:{self.port}"

    def cluster_peers(self, part: int) -> list[str]:
        """Replica addresses of ``part`` (the epoch claim/announce set)."""
        if self._repl is not None:
            return [self.peers[i] for i in self._repl.replica_indexes(part)]
        return list(self.peers)

    @property
    def num_partitions(self) -> int:
        return len(self._parts)

    def start(self) -> "BrokerServer":
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="filo-broker")
        self._thread.start()
        if self.epochs is not None and self.peers:
            self.rejoin_sync()
            self._claim_static_leaderships()
        return self

    # -- epoch-fenced lifecycle (cluster/: REJOIN + static claims) -----------

    def _claim_static_leaderships(self) -> None:
        """Bootstrap claims: the static leader of each still-unclaimed
        partition claims epoch 1 so fencing is live from the first publish
        (idempotent; a raced claim from elsewhere just wins by epoch)."""
        from ..cluster.gossip import ClusterError, lead_partition
        for part in range(len(self._parts)):
            if part % len(self.peers) != self.node_index:
                continue
            e, _owner = self.epochs.get(part)
            if e == 0:
                try:
                    lead_partition(self, part)
                except (ConnectionError, OSError, ClusterError):
                    log.warning("startup epoch claim failed for partition "
                                "%d; a client failover will claim instead",
                                part, exc_info=True)

    def rejoin_sync(self) -> dict[int, dict]:
        """REJOIN after divergence (the PR 6 known-limit repair): for each
        partition whose current epoch owner is another node, find the
        first offset where our log diverges from the leader's, truncate
        our tail there (a dead leader's unreplicated appends), and catch
        up from the leader's journaled log over OP_SYNC. Returns
        {partition: {"truncated": n, "appended": m}}."""
        from ..cluster.gossip import ClusterError, ClusterLink
        out: dict[int, dict] = {}
        for part in range(len(self._parts)):
            if self.node_index not in (
                    self._repl.replica_indexes(part) if self._repl is not None
                    else range(len(self.peers))):
                continue
            best: tuple[int, str] | None = None
            for addr in self.cluster_peers(part):
                if addr == self.self_addr:
                    continue
                try:
                    e, owner = ClusterLink(addr).epoch_read(part)
                except (ConnectionError, OSError, ClusterError):
                    continue
                if e and (best is None or e > best[0]):
                    best = (e, owner)
            if best is None:
                continue
            self.epochs.adopt(part, *best)
            e, owner = self.epochs.get(part)
            if e == 0 or owner == self.self_addr or owner == "":
                continue
            with span(SPAN_CLUSTER_REJOIN, partition=part, owner=owner):
                try:
                    out[part] = self._repair_from(part, owner)
                except (ConnectionError, OSError, ClusterError) as e:
                    log.warning("REJOIN repair of partition %d from %s "
                                "failed: %s", part, owner, e)
        return out

    def _repair_from(self, part: int, owner: str) -> dict:
        """Truncate-and-catch-up against the current leader: stream its
        journaled log (bounded OP_SYNC chunks), find the first offset
        where our frames differ byte-for-byte (or where our log runs past
        the leader's end), truncate there, then append the leader's
        frames with their pub-ids."""
        from ..cluster.gossip import ClusterLink
        link = ClusterLink(owner, timeout_s=5.0)
        bus = self._parts[part]
        jrnl = self._journals[part]
        with self._publish_locks[part]:
            my_end = bus.end_offset
            # walk the leader's log against a streaming local cursor (both
            # are offset-ordered and contiguous, so one pass holds one
            # bounded sync chunk + one local frame — never the whole log);
            # divergence = first byte mismatch
            mine = bus.frames_from(0)
            div = None
            off = 0
            leader_end, entries = link.sync(part, 0)
            while True:
                for loff, _pid, lframe in entries:
                    if loff >= my_end:
                        break
                    _moff, mframe = next(mine, (None, None))
                    if mframe != lframe:    # mismatch (or torn local tail)
                        div = loff
                        break
                off = entries[-1][0] + 1 if entries else leader_end
                if div is not None or not entries \
                        or off >= min(my_end, leader_end):
                    break
                leader_end, entries = link.sync(part, off)
            if div is None and my_end > leader_end:
                div = leader_end        # our extra tail: the leader never
                # saw it, so it is the diverged unreplicated remainder
            truncated = 0
            if div is not None and div < my_end:
                truncated = bus.truncate(div)
                jrnl.truncate_from(div)
                recent = self._recent_ids[part]
                for pid, r_off in list(recent.items()):
                    if r_off >= div:
                        del recent[pid]
                registry.counter(FILODB_CLUSTER_REJOIN_TRUNCATED,
                                 {"partition": str(part)}).increment(
                    float(truncated))
                log.warning("REJOIN: truncated %d divergent frames of "
                            "partition %d at offset %d", truncated, part,
                            div)
            # catch up [our end, leader end)
            appended = 0
            while bus.end_offset < leader_end:
                leader_end, entries = link.sync(part, bus.end_offset)
                fresh = [(o, p, f) for o, p, f in entries
                         if o >= bus.end_offset]
                if not fresh:
                    break
                bus.publish_many_bytes([f for _o, _p, f in fresh])
                jrnl.append_many([(o, p) for o, p, _f in fresh if p])
                recent = self._recent_ids[part]
                for o, p, _f in fresh:
                    if p:
                        _remember_id(recent, p, o, self._recent_ids_max)
                appended += len(fresh)
        return {"truncated": truncated, "appended": appended}

    def stop(self) -> None:
        """Deterministic teardown: stop the acceptor, release the listening
        socket, sever live client connections (handler threads would
        otherwise keep serving a 'stopped' broker), and join the serve
        thread with a timeout. Idempotent — the fault-injection kill path
        and a test's finally may both call it."""
        with self._conns_lock:
            if self._stopped:
                return
            self._stopped = True
        if self._repl is not None:
            self._repl.close()
        self._server.shutdown()
        self._server.server_close()
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass    # racing close: the connection is already gone
            c.close()
        if self._thread is not None:
            self._thread.join(timeout=3)
            self._thread = None


class BrokerBus:
    """Client for one broker partition; drop-in for FileBus.

    ``publish`` is the one-frame-per-round-trip op. The windowed publisher
    (``publish_async``/``publish_batch``/``flush_publishes``) buffers frames
    and ships them as pipelined PUBLISH_BATCH requests of up to
    ``publish_window`` frames each — F frames cost at most ceil(F/W) round
    trips, and every frame keeps its own idempotent publish id so a replay
    after a lost response (or a reconnect) never appends duplicates.
    ``requests`` counts round trips for tests/benchmarks."""

    def __init__(self, addr, partition: int, publish_window: int = 64,
                 retry_backoff_ms: float = 50.0, max_retries: int = 8,
                 seed: int | None = None, track_acks: bool = False,
                 fault_plan=None, epoch_fencing: bool = False):
        """``addr``: one ``host:port`` string, or the partition's whole
        replica address list — with >1 address the bus fails over to the
        most-caught-up survivor on connection loss. ``retry_backoff_ms`` /
        ``max_retries`` bound the jittered exponential backoff after
        RETRY sheds and reconnects (``seed`` pins the jitter for tests).
        ``track_acks=True`` records every acked publish id in
        ``acked_ids`` — the soak audit's client-side ledger.

        ``epoch_fencing=True`` makes the bus honor fenced refusals from
        epoch-enabled brokers: a refusal naming a reachable owner reroutes
        there (closing a spurious failover), one naming a dead owner
        triggers an OP_EPOCH_LEAD claim at the ranked survivor before the
        replay."""
        addrs = [addr] if isinstance(addr, str) else list(addr)
        self.epoch_fencing = bool(epoch_fencing)
        self._addr_strs = list(addrs)
        self._addrs = []
        for a in addrs:
            host, _, port = a.rpartition(":")
            self._addrs.append((host or "127.0.0.1", int(port)))
        self.partition = partition
        # static leader: peers[p % N] — matches the server's replica map
        self._cur = partition % len(self._addrs)
        self.publish_window = max(1, int(publish_window))
        self.retry_backoff_ms = float(retry_backoff_ms)
        self.max_retries = max(1, int(max_retries))
        self.track_acks = bool(track_acks)
        self.acked_ids: list[int] = []
        self.fault_plan = fault_plan
        self._rng = random.Random(
            seed if seed is not None
            else int.from_bytes(os.urandom(8), "little"))
        self._sleep = time.sleep        # injectable: tests run sleep-free
        self._sock: socket.socket | None = None
        self._lock = threading.Lock()   # one in-flight exchange per client
        self._pending: list[tuple[int, bytes]] = []   # (pub_id, frame)
        self.requests = 0               # round-trip count (instrumentation)
        self._ok_since_rank = 0         # successes since the last re-rank
        self._retries = registry.counter(FILODB_INGEST_RETRIES)
        self._failovers = registry.counter(FILODB_INGEST_FAILOVERS)
        self._publish_hist = registry.histogram(
            FILODB_INGEST_PUBLISH_LATENCY_MS,
            {"partition": str(partition)})
        self.failover_count = 0         # this bus only (span failover tag)
        # persistently-dead partition -> shed fast (PR 2 breaker machinery)
        from ..query.wire import PeerBreaker
        self._breaker = PeerBreaker(threshold=3, cooldown_s=5.0)

    def _conn_locked(self) -> socket.socket:
        if self._sock is None:
            self._sock = socket.create_connection(self._addrs[self._cur],
                                                  timeout=30)
        return self._sock

    def _transport_attempts(self) -> int:
        # single-address buses keep the historical fast-fail shape (one
        # reconnect); replicated buses spend the retry budget on failover
        return 2 if len(self._addrs) == 1 else max(2, self.max_retries)

    def _backoff_ms(self, k: int, floor_ms: float = 0.0) -> float:
        """Jittered exponential backoff for the k-th retry (k=0 -> no
        wait: the first replay is immediate, like the PR-4 reconnect)."""
        if k <= 0 and floor_ms <= 0:
            return 0.0
        base = self.retry_backoff_ms * (2 ** max(0, k - 1)) if k > 0 else 0.0
        base = min(base, self.retry_backoff_ms * 32)
        jittered = base * (0.5 + self._rng.random())
        return max(floor_ms, jittered)

    def _note_retry_locked(self, k: int, floor_ms: float = 0.0) -> None:
        self._retries.increment()
        wait = self._backoff_ms(k, floor_ms)
        if wait > 0:
            self._sleep(wait / 1000.0)

    def _failover_locked(self) -> None:
        """Re-rank the replica set by replication watermark (OP_END over a
        transient probe connection): highest watermark wins; ties prefer
        the STATIC leader, then the lowest index. The key is GLOBALLY
        shared — no term depends on this client's own state — so every
        publisher lands on the same survivor (one writer per partition),
        and once a recovered static leader has caught up the tie-break
        converges everyone back onto it instead of leaving the fleet
        split across writers forever. Probe connects are bounded well
        below the stream timeout: ranking runs under the bus lock."""
        if len(self._addrs) == 1:
            return
        static = self.partition % len(self._addrs)
        best: tuple[int, int, int] | None = None
        for i, a in enumerate(self._addrs):
            try:
                with socket.create_connection(a, timeout=0.75) as s:
                    s.sendall(_REQ.pack(OP_END, self.partition, 0, 0))
                    st, off, rlen = _RESP.unpack(_recv_exact(s, _RESP.size))
                    if rlen:
                        _recv_exact(s, rlen)
                if st != ST_OK:
                    continue
                cand = (-off, 0 if i == static else 1, i)
                if best is None or cand < best:
                    best = cand
            except (ConnectionError, OSError):
                continue
        if best is not None and best[2] != self._cur:
            self._cur = best[2]
            self.failover_count += 1
            self._failovers.increment()

    _RERANK_EVERY = 256

    def _maybe_rerank_locked(self) -> None:
        """Failed-over clients re-rank every _RERANK_EVERY successful
        exchanges: when the static leader returns AND catches up, the
        tie-break moves everyone home — without this, a transient outage
        would split publishers across writers permanently."""
        if self._cur == self.partition % len(self._addrs):
            return
        self._ok_since_rank += 1
        if self._ok_since_rank >= self._RERANK_EVERY:
            self._ok_since_rank = 0
            was = self._cur
            self._failover_locked()
            if self._cur != was:
                self._close_locked()    # next exchange dials the new pick

    def _close_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def _read_resp_locked(self, s: socket.socket) -> tuple[int, int, bytes]:
        st, off, rlen = _RESP.unpack(_recv_exact(s, _RESP.size))
        return st, off, _recv_exact(s, rlen) if rlen else b""

    def _exchange_locked(self, op: int, offset: int, plen: int,
                         payload: bytes) -> tuple[int, int, bytes]:
        if not self._breaker.admit():
            raise ConnectionError(
                f"partition {self.partition} breaker open (replica set down)")
        attempts = self._transport_attempts()
        last: Exception | None = None
        for attempt in range(attempts):
            if attempt:
                self._note_retry_locked(attempt - 1)
                self._failover_locked()     # dead leader -> ranked survivor
            try:
                s = self._conn_locked()
                s.sendall(_REQ.pack(op, self.partition, offset, plen) + payload)
                self.requests += 1
                if self.fault_plan is not None and self.fault_plan.decide(
                        "client_recv", partition=self.partition, op=op):
                    self._close_locked()
                    raise ConnectionError("fault: response dropped")
                st, off, body = self._read_resp_locked(s)
                self._breaker.record_success()
                self._maybe_rerank_locked()
                return st, off, body
            except (ConnectionError, OSError) as e:
                self._close_locked()
                last = e
        self._breaker.record_failure()
        raise last if last is not None else ConnectionError("unreachable")

    def _request(self, op: int, offset: int = 0, plen: int = 0,
                 payload: bytes = b"") -> tuple[int, bytes]:
        hint_ms = 0
        for k in range(self.max_retries + 1):
            with self._lock:
                if k:
                    self._note_retry_locked(k - 1, floor_ms=hint_ms)
                st, off, body = self._exchange_locked(op, offset, plen,
                                                      payload)
            if st == ST_ERR:
                if self.epoch_fencing and body.startswith(b"fenced:"):
                    # deposed/non-owner broker refused: follow the fence
                    # (reroute to the named owner, or claim a new epoch at
                    # the survivor) and replay with the SAME pub-ids
                    with self._lock:
                        self._handle_fenced_locked(body)
                    continue
                raise RuntimeError(
                    f"broker error: {body.decode(errors='replace')}")
            if st != ST_RETRY:
                return off, body
            hint_ms = off or 100    # RETRY carries the server's ms hint
        raise BrokerRetry(hint_ms / 1000.0)

    def _probe_end_ok(self, addr: tuple) -> bool:
        """Quick liveness probe (OP_END over a transient bounded connect)
        for fence-following: is the named epoch owner actually serving?"""
        try:
            with socket.create_connection(addr, timeout=0.75) as s:
                s.sendall(_REQ.pack(OP_END, self.partition, 0, 0))
                st, _off, rlen = _RESP.unpack(_recv_exact(s, _RESP.size))
                if rlen:
                    _recv_exact(s, rlen)
            return st == ST_OK
        except (ConnectionError, OSError):
            return False

    def _handle_fenced_locked(self, body: bytes) -> None:
        """React to a fenced refusal: (1) the named owner answers — it IS
        the leader, move there (a spurious failover snaps home); (2) the
        owner is provably dead — claim a new epoch at the ranked survivor
        so the replay lands on a fenced-in leader. An unparseable message
        or an ALIVE owner outside our address list (configuration skew)
        triggers a plain re-rank, never a claim — deposing a live leader
        on a string mismatch would ping-pong leadership forever."""
        from ..cluster.gossip import ClusterError, ClusterLink, parse_fenced
        parsed = parse_fenced(body.decode(errors="replace"))
        owner = parsed[2] if parsed else ""
        owner_alive = False
        if owner:
            host, _, port = owner.rpartition(":")
            try:
                owner_alive = self._probe_end_ok((host or "127.0.0.1",
                                                  int(port)))
            except ValueError:
                owner_alive = False     # malformed owner address
        if owner_alive:
            if owner in self._addr_strs:
                i = self._addr_strs.index(owner)
                if i != self._cur:
                    self._cur = i
                    self.failover_count += 1
                    self._failovers.increment()
            else:
                # live owner we cannot dial by our configured list: the
                # retry surfaces the fenced error instead of deposing it
                log.warning("fenced by live owner %s not in this bus's "
                            "address list for partition %d", owner,
                            self.partition)
            self._close_locked()
            return
        self._failover_locked()     # dead/unknown owner: rank survivors
        if parsed is not None:
            try:
                ClusterLink(self._addr_strs[self._cur]).epoch_lead(
                    self.partition)
            except (ConnectionError, OSError, ClusterError):
                # claim did not land (survivor flapping): the replay's next
                # fenced/transport error re-drives this handler
                log.warning("epoch claim at %s for partition %d failed",
                            self._addr_strs[self._cur], self.partition,
                            exc_info=True)
        self._close_locked()

    @staticmethod
    def _pub_id() -> int:
        # stable random id across the internal reconnect retry: if the broker
        # committed the append but the response was lost, the retry is a no-op
        return int.from_bytes(os.urandom(8), "little") | 1

    def publish(self, container: RecordContainer) -> int:
        return self.publish_with_id(container, self._pub_id())

    def publish_with_id(self, container: RecordContainer,
                        pub_id: int) -> int:
        """Publish one frame under a CALLER-SUPPLIED publish id (low bit
        forced — id 0 means 'no id' on the wire). The rules subsystem
        derives ids from (rule, eval_ts, shard), so re-publishing a
        re-evaluated tick resolves to the original offsets instead of
        appending duplicates — exactly-once derived writes ride the same
        journaled idempotence as retry replays."""
        payload = container.to_bytes()
        pid = int(pub_id) | 1
        off, _ = self._request(OP_PUBLISH, offset=pid,
                               plen=len(payload), payload=payload)
        if self.track_acks:
            with self._lock:
                self.acked_ids.append(pid)
        return off

    def publish_async(self, container: RecordContainer) -> None:
        """Queue one frame; a full window drains automatically (one
        PUBLISH_BATCH round trip). Call ``flush_publishes`` to drain the
        remainder — assigned offsets surface there."""
        payload = container.to_bytes()
        with self._lock:
            self._pending.append((self._pub_id(), payload))
            if len(self._pending) >= self.publish_window:
                self._drain_pending_locked()

    def publish_batch(self, containers) -> list[int]:
        """Publish many containers in ceil(n/window) pipelined round trips;
        returns their assigned offsets (plus any earlier async remainder's,
        in queue order)."""
        with self._lock:
            for c in containers:
                self._pending.append((self._pub_id(), c.to_bytes()))
            return self._drain_pending_locked()

    def flush_publishes(self) -> list[int]:
        """Drain queued async publishes; returns their assigned offsets."""
        with self._lock:
            return self._drain_pending_locked()

    def _next_group_locked(self) -> tuple[list[list], int]:
        """Head of the pending queue as PUBLISH_BATCH chunks: each chunk at
        most ``publish_window`` frames AND ``_MAX_BATCH_BYTES`` of payload;
        the group at most ``_MAX_UNACKED_FRAMES`` frames total."""
        chunks: list[list] = []
        cur: list = []
        cur_bytes = taken = 0
        for pid, frame in self._pending:
            if taken >= _MAX_UNACKED_FRAMES:
                break
            entry = _ENTRY.size + len(frame)
            if cur and (len(cur) >= self.publish_window
                        or cur_bytes + entry > _MAX_BATCH_BYTES):
                chunks.append(cur)
                cur, cur_bytes = [], 0
            cur.append((pid, frame))
            cur_bytes += entry
            taken += 1
        if cur:
            chunks.append(cur)
        return chunks, taken

    def _drain_pending_locked(self) -> list[int]:
        offs: list[int] = []
        while self._pending:
            chunks, taken = self._next_group_locked()
            offs.extend(self._send_group_locked(chunks))
            del self._pending[:taken]   # commit per group: a later failure
            if self.track_acks:         # never replays acked frames
                self.acked_ids.extend(pid for ch in chunks for pid, _ in ch)
        return offs

    def _send_group_locked(self, chunks: list[list]) -> list[int]:
        # one span per pipelined group: the SAME trace context rides every
        # request of the group — including replays after a leader failover,
        # so the survivor's append spans join the original publish trace
        # and the failover itself is tagged on the client span
        with span(SPAN_INGEST_PUBLISH, partition=self.partition,
                  frames=sum(len(c) for c in chunks)) as tags:
            fo0 = self.failover_count
            t0 = time.perf_counter_ns()
            try:
                offs = self._send_group_traced_locked(chunks)
            finally:
                if self.failover_count > fo0:
                    tags["failovers"] = self.failover_count - fo0
            # SUCCESSFUL groups only: a breaker-open shed raises within
            # microseconds and a timed-out group never completed — either
            # would poison the round-trip histogram's percentiles. The
            # exemplar carries the id only for SAMPLED traces (an id
            # nothing recorded dead-ends at /api/v1/debug/traces).
            tctx = tracer.current_context()
            self._publish_hist.record(
                (time.perf_counter_ns() - t0) / 1e6,
                trace_id=(tctx["trace_id"]
                          if tctx and tctx.get("sampled") else None))
            return offs

    def _send_group_traced_locked(self, chunks: list[list]) -> list[int]:
        # pipeline WITHIN a bounded group: all of the group's requests go
        # on the wire before its first response is read (the broker
        # serves one connection serially, so responses arrive in order),
        # then the group commits and drops off the pending queue. A
        # replay after a lost connection OR a RETRY shed re-sends the SAME
        # publish ids, which the (possibly failed-over) broker resolves to
        # the original offsets — and a group never exceeds half the
        # broker's id window, so none of its ids can have been evicted by
        # its own replay.
        if not self._breaker.admit():
            raise ConnectionError(
                f"partition {self.partition} breaker open (replica set down)")
        transport = self._transport_attempts()
        # the trace block is identical across replays (same publish span):
        # a failed-over broker's spans join the original trace
        thdr = pack_trace_hdr(tracer.current_context())
        t_fail = r_shed = fenced_n = 0
        while True:
            try:
                s = self._conn_locked()
                for ch in chunks:
                    payload = thdr + b"".join(_ENTRY.pack(pid, len(f)) + f
                                              for pid, f in ch)
                    s.sendall(_REQ.pack(OP_PUBLISH_BATCH, self.partition,
                                        len(ch), len(payload)) + payload)
                    self.requests += 1
                if self.fault_plan is not None and self.fault_plan.decide(
                        "client_recv", partition=self.partition,
                        op=OP_PUBLISH_BATCH):
                    self._close_locked()
                    raise ConnectionError("fault: response dropped")
                group_offs: list[int] = []
                err: bytes | None = None
                retry_hint = 0
                for ch in chunks:   # drain EVERY response before raising
                    st, _end, body = self._read_resp_locked(s)
                    if st == ST_ERR:
                        err = err or body
                    elif st == ST_RETRY:
                        retry_hint = max(retry_hint, _end or 100)
                    else:
                        group_offs.extend(
                            struct.unpack(f"<{len(ch)}Q", body))
                if err is not None:
                    if self.epoch_fencing and err.startswith(b"fenced:"):
                        # the whole group replays at the fenced-in leader
                        # with the SAME pub-ids: chunks the new leader
                        # already replicated resolve by id, nothing dups
                        fenced_n += 1
                        if fenced_n > self.max_retries:
                            raise RuntimeError(
                                "broker error: "
                                f"{err.decode(errors='replace')}")
                        self._handle_fenced_locked(err)
                        continue
                    raise RuntimeError(
                        f"broker error: {err.decode(errors='replace')}")
                if retry_hint:
                    # backpressure shed: back off (honoring the server's
                    # hint) and replay the whole group — OK'd chunks
                    # resolve by id, shed chunks get their append
                    r_shed += 1
                    if r_shed > self.max_retries:
                        raise BrokerRetry(retry_hint / 1000.0)
                    self._note_retry_locked(r_shed - 1, floor_ms=retry_hint)
                    continue
                self._breaker.record_success()
                self._maybe_rerank_locked()
                return group_offs
            except (ConnectionError, OSError):
                self._close_locked()
                t_fail += 1
                if t_fail >= transport:
                    self._breaker.record_failure()
                    raise
                self._note_retry_locked(t_fail - 1)
                self._failover_locked()

    def consume(self, schemas, from_offset: int = 0) -> Iterator[tuple[int, RecordContainer]]:
        """Replay containers from ``from_offset`` up to the end offset observed
        on the FIRST fetch (ref: Kafka seek + poll). The snapshot matters: a
        poll-loop consumer must regain control between polls to flush/
        checkpoint/purge, so under sustained publish load this terminates
        instead of chasing the moving end forever (FileBus.consume contract)."""
        next_off = from_offset
        end: int | None = None
        while True:
            resp_end, body = self._request(OP_FETCH, offset=next_off)
            if end is None:
                end = resp_end
            pos = 0
            got = 0
            while pos < len(body):
                off, ln = _ENTRY.unpack_from(body, pos)
                pos += _ENTRY.size
                if off >= end:
                    return
                yield off, RecordContainer.from_bytes(body[pos:pos + ln], schemas)
                pos += ln
                next_off = off + 1
                got += 1
            if not got or next_off >= end:
                return

    @property
    def end_offset(self) -> int:
        off, _ = self._request(OP_END)
        return off

    def close(self) -> None:
        # sever FIRST, without the exchange lock: a consumer blocked in a
        # 30s recv HOLDS that lock, and closing the socket out from under
        # it is exactly what unblocks it (teardown would otherwise stall
        # behind the full socket timeout)
        s = self._sock
        if s is not None:
            try:
                s.close()
            except OSError:
                pass    # racing close: already severed
        with self._lock:
            self._close_locked()
