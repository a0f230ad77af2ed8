"""Partition replication: leader->follower frame streaming + quorum acks.

Reference: Kafka's ISR replication model (the reference outsources this to
Kafka; the capability list ingests "millions of series from Kafka, sharded
across a peer-to-peer cluster" with replicated, durable partitions). Here
the broker tier replicates its own logs:

  * every partition has a replica set of R broker nodes (deterministic from
    the shared ``peers`` list: replicas of partition p are
    ``peers[(p + i) % N] for i in range(R)``, leader = ``peers[p % N]``);
  * the node serving a publish appends locally, then STREAMS the appended
    frames to the other replicas over ``OP_REPLICATE`` (offset-contiguous,
    CRC-checked, pub-ids included so the follower's idempotence window
    matches the leader's) and acks the publisher only once every in-sync
    replica holds the frames — an ack means the data survives one node
    loss while the replica set is healthy;
  * a follower that keeps failing drops out of the in-sync set after
    ``FAIL_THRESHOLD`` consecutive failures (counted, not timed — the
    tests are deterministic) and is retried every ``rejoin_every`` calls;
    ``min_insync`` floors the in-sync count required to ack — below it the
    publish sheds with a typed RETRY (quorum-stall backpressure);
  * catch-up is the same op: the leader re-reads its log tail (with pub-ids
    from the per-partition journal) from the follower's watermark and
    replays it; torn/corrupt frames are detected by per-frame CRC32 at the
    follower and re-sent intact.

The per-partition :class:`PubIdJournal` (offset -> publish id) makes the
idempotence window durable: a restarted broker reloads its recent-id map,
catch-up carries ids to followers, and the ``ingest_soak`` audit
reconciles acked pub-ids against the surviving log with zero loss / zero
duplication.

Split-brain note: deterministic client-side failover (all publishers rank
survivors by watermark with a shared tie-break) keeps one writer per
partition in practice; a dead leader that RESTARTS with unreplicated tail
frames diverges and must rejoin empty (operator wipe) — the same contract
as a Kafka replica that lost its disk.
"""

from __future__ import annotations

import logging
import os
import socket
import struct
import zlib

from ..utils.metrics import (FILODB_INGEST_REPLICATION_LAG, registry)
from ..utils.netio import recv_exact as _recv_exact
from ..utils.tracing import (SPAN_REPLICATE, SPAN_REPLICATE_SERVE, span,
                             tracer)
from .broker import (_REQ, _RESP, ST_ERR, ST_OK, _remember_id,
                     pack_trace_hdr, unpack_trace_hdr)

log = logging.getLogger("filodb_tpu_torch.replication")

# replication stream op (16+ keeps clear air from the client ops in
# broker.py; values must stay distinct ACROSS modules — both are checked by
# filolint's op-parity rule)
OP_REPLICATE = 16

# one replicated frame: offset, publish id, payload crc32, payload length
_RENTRY = struct.Struct("<QQII")

# leadership-epoch block riding every OP_REPLICATE payload (after the trace
# block, before the frames): ``u64 epoch + u16 owner_len + owner bytes``.
# Epoch 0 = unfenced legacy mode. A follower holding a HIGHER epoch refuses
# the batch with the shared fenced-refusal message (cluster/gossip.py
# fence_message), which the leader parses to step down — the epoch fence
# that closes the spurious-failover split-brain window.
_EPOCH_HDR = struct.Struct("<QH")

_MAX_CATCHUP_BYTES = 4 << 20    # per-OP_REPLICATE payload bound


def pack_epoch_hdr(epoch: int, owner: str) -> bytes:
    raw = owner.encode()
    return _EPOCH_HDR.pack(int(epoch), len(raw)) + raw


def unpack_epoch_hdr(payload: bytes) -> tuple[int, str, bytes]:
    """(epoch, owner, rest-of-payload). A malformed block degrades to
    epoch 0 — an unfenced peer's stream still replicates."""
    try:
        epoch, ln = _EPOCH_HDR.unpack_from(payload, 0)
        body = payload[_EPOCH_HDR.size:]
        if ln > len(body):
            return 0, "", payload
        return int(epoch), body[:ln].decode(errors="replace"), body[ln:]
    except (struct.error, ValueError):
        return 0, "", payload


class ReplicationError(RuntimeError):
    """Follower rejected a replication batch (torn frame, bad partition)."""


class PubIdJournal:
    """Durable offset -> publish-id map per partition (sidecar file of
    fixed ``<QQ`` records). Appends ride the partition publish lock; a torn
    tail record is dropped on load exactly like a torn log frame.

    Bounded: only the newest ``max_entries`` records are retained (memory
    AND file, compacted by rewrite at 2x) — far larger than every
    idempotence window (``_RECENT_IDS_MAX``) and any sane replication lag,
    so retries and catch-up always find their ids while a long-lived
    broker's journal stays O(window), not O(lifetime ingest). Frames that
    age past the floor replicate with id 0 (no dedupe needed: they are
    beyond every replay window)."""

    REC = struct.Struct("<QQ")

    def __init__(self, path: str, max_entries: int = 1 << 16):
        self.path = path
        self.max_entries = int(max_entries)
        self._ids: dict[int, int] = {}      # insertion == offset order
        try:
            with open(path, "rb") as f:
                buf = f.read()
        except FileNotFoundError:
            buf = b""
        n = len(buf) // self.REC.size
        for i in range(max(0, n - self.max_entries), n):
            off, pid = self.REC.unpack_from(buf, i * self.REC.size)
            self._ids[off] = pid

    def append(self, off: int, pub_id: int) -> None:
        """Caller holds the partition's publish lock."""
        self.append_many([(off, pub_id)])

    def append_many(self, pairs) -> None:
        """ONE open + ONE write for a whole batch's (offset, pub_id)
        records — the journal must not re-open per frame on the
        PUBLISH_BATCH hot path (caller holds the publish lock)."""
        if not pairs:
            return
        blob = bytearray()
        for off, pid in pairs:
            self._ids[off] = pid
            blob += self.REC.pack(off, pid)
        with open(self.path, "ab") as f:
            f.write(blob)
        if len(self._ids) > 2 * self.max_entries:
            self._compact()

    def _compact(self) -> None:
        """Trim to the newest max_entries and rewrite the file (atomic
        rename; caller holds the publish lock). Amortized: one rewrite per
        max_entries appends."""
        for off in list(self._ids)[:len(self._ids) - self.max_entries]:
            del self._ids[off]
        blob = b"".join(self.REC.pack(off, pid)
                        for off, pid in self._ids.items())
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, self.path)

    def get(self, off: int) -> int:
        return self._ids.get(off, 0)

    def truncate_from(self, off: int) -> int:
        """Drop records at offsets >= ``off`` and rewrite the file (the
        journal twin of FileBus.truncate for REJOIN repair; caller holds
        the partition's publish lock). Returns records dropped."""
        doomed = [o for o in self._ids if o >= off]
        for o in doomed:
            del self._ids[o]
        if doomed:
            blob = b"".join(self.REC.pack(o, pid)
                            for o, pid in self._ids.items())
            tmp = self.path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, self.path)
        return len(doomed)

    def items(self) -> list[tuple[int, int]]:
        """(offset, pub_id) pairs in offset order — the audit surface."""
        return sorted(self._ids.items())

    def seed_recent(self, recent: dict[int, int], limit: int) -> None:
        """Reload the newest ``limit`` ids into a broker recent-ids map so
        publish-retry idempotence survives a broker restart."""
        for off, pid in self.items()[-limit:]:
            _remember_id(recent, pid, off, limit)


def pack_entries(entries) -> bytes:
    """[(offset, pub_id, frame bytes)] -> OP_REPLICATE payload."""
    return b"".join(
        _RENTRY.pack(off, pid, zlib.crc32(frame), len(frame)) + frame
        for off, pid, frame in entries)


def serve_replication(server, op: int, part: int, payload: bytes) -> bytes:
    """Follower-side dispatch for the replication op space (>= 16;
    BrokerServer._serve delegates here).

    OP_REPLICATE appends offset-contiguous frames, skips frames already
    held, stops at a gap (the leader resends from the returned watermark),
    and rejects CRC mismatches as torn frames. Responds ST_OK with the
    follower's end offset — its replication watermark."""
    if op != OP_REPLICATE:
        raise ValueError(f"unknown replication op {op}")
    # the leader's trace block rides ahead of the frames (stripped before
    # CRC/frame parsing, never appended to the log): the follower's append
    # span joins the original publish trace
    tctx, payload = unpack_trace_hdr(payload)
    with tracer.activate(tctx), \
            span(SPAN_REPLICATE_SERVE, partition=part, broker=server.port):
        return _serve_replication_traced(server, part, payload)


def _serve_replication_traced(server, part: int, payload: bytes) -> bytes:
    epoch, owner, payload = unpack_epoch_hdr(payload)
    epochs = getattr(server, "epochs", None)
    if epochs is not None:
        known, kowner = epochs.get(part)
        # LEXICOGRAPHIC (epoch, owner) ordering, matching
        # PartitionEpochs.adopt: an epoch TIE between two concurrent
        # claimants resolves to the higher owner address — the lower one
        # is refused here exactly like a stale epoch, so it steps down
        if known and (epoch, owner) < (known, kowner):
            # the sender is a deposed leader: refuse the batch with the
            # shared fenced message so it steps down instead of skipping
            from ..cluster.gossip import fence_message
            from ..utils.metrics import (FILODB_CLUSTER_FENCED_REJECTS,
                                         registry)
            registry.counter(FILODB_CLUSTER_FENCED_REJECTS,
                             {"site": "replicate"}).increment()
            msg = fence_message(part, known, kowner)
            return _RESP.pack(ST_ERR, 0, len(msg)) + msg.encode()
        if (epoch, owner) > (known, kowner):
            epochs.adopt(part, epoch, owner)
    bus = server._parts[part]
    with server._publish_locks[part]:
        end = bus.end_offset
        fresh: list[tuple[int, int, bytes]] = []    # (offset, pub_id, frame)
        pos = 0
        while pos < len(payload):
            off, pid, crc, ln = _RENTRY.unpack_from(payload, pos)
            pos += _RENTRY.size
            frame = payload[pos:pos + ln]
            pos += ln
            if len(frame) < ln:
                msg = f"torn replication frame at offset {off} (short read)"
                return _RESP.pack(ST_ERR, 0, len(msg)) + msg.encode()
            if zlib.crc32(frame) != crc:
                msg = f"torn replication frame at offset {off} (crc mismatch)"
                return _RESP.pack(ST_ERR, 0, len(msg)) + msg.encode()
            if off < end + len(fresh):
                continue                    # already replicated
            if off > end + len(fresh):
                break                       # gap: leader resends from `end`
            fresh.append((off, pid, frame))
        if fresh:
            bus.publish_many_bytes([f for _, _, f in fresh])
            recent = server._recent_ids[part]
            server._journals[part].append_many(
                [(off, pid) for off, pid, _f in fresh if pid])
            for off, pid, _f in fresh:
                if pid:
                    _remember_id(recent, pid, off, server._recent_ids_max)
        return _RESP.pack(ST_OK, bus.end_offset, 0)


class FollowerLink:
    """Leader-side client for ONE (partition, follower) replication stream.
    Tracks the follower's watermark (its acked end offset) and consecutive
    failures for ISR bookkeeping."""

    def __init__(self, addr: str, partition: int, fault_plan=None,
                 timeout_s: float = 5.0):
        host, _, port = addr.rpartition(":")
        self.addr = addr
        self._addr = (host or "127.0.0.1", int(port))
        self.partition = partition
        self.fault_plan = fault_plan
        self.timeout_s = timeout_s
        self._sock: socket.socket | None = None
        self.watermark: int | None = None   # None = unknown (probe first)
        self.fails = 0

    def _conn(self) -> socket.socket:
        if self._sock is None:
            # connect stalls run under the partition publish lock — bound
            # them harder than established-stream reads (a SYN-blackholed
            # follower must not freeze the partition's ingest for the full
            # stream timeout while it falls out of the in-sync set)
            self._sock = socket.create_connection(
                self._addr, timeout=min(1.0, self.timeout_s))
            self._sock.settimeout(self.timeout_s)
        return self._sock

    def reset(self) -> None:
        """Drop the connection and watermark after a failure: the next
        attempt reconnects and re-probes."""
        self.watermark = None
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def replicate(self, entries, epoch: int = 0, owner: str = "") -> int:
        """Stream [(offset, pub_id, frame)] to the follower under the
        leader's ``epoch``; returns (and caches) its watermark. Raises
        ConnectionError/ReplicationError on transport faults / rejection
        (a fenced rejection carries the follower's higher epoch)."""
        with span(SPAN_REPLICATE, partition=self.partition, peer=self.addr,
                  frames=len(entries)):
            return self._replicate_traced(entries, epoch, owner)

    def _replicate_traced(self, entries, epoch: int = 0,
                          owner: str = "") -> int:
        payload = pack_trace_hdr(tracer.current_context()) \
            + pack_epoch_hdr(epoch, owner) + pack_entries(entries)
        base = entries[0][0] if entries else 0
        try:
            s = self._conn()
            # fault decisions count only sends that actually reach the
            # wire with frames aboard — probes and refused connects must
            # not consume a rule's deterministic event budget
            torn = None
            if self.fault_plan is not None and entries:
                torn = self.fault_plan.decide("replicate",
                                              partition=self.partition,
                                              offset=base)
            if torn is not None and torn.action == "drop":
                raise ConnectionError("fault: replicate send dropped")
            if torn is not None and torn.action == "corrupt":
                payload = self.fault_plan.corrupt(payload)
            req = _REQ.pack(OP_REPLICATE, self.partition, base, len(payload))
            if torn is not None and torn.action == "torn_write":
                s.sendall((req + payload)[: _REQ.size + len(payload) // 2])
                raise ConnectionError("fault: torn replicate write")
            s.sendall(req + payload)
            st, off, rlen = _RESP.unpack(_recv_exact(s, _RESP.size))
            body = _recv_exact(s, rlen) if rlen else b""
        except (ConnectionError, OSError):
            self.reset()
            raise
        if st != ST_OK:
            # the follower speaks but rejects (torn frame, bad partition):
            # reset the stream so the retry re-reads + re-sends intact bytes
            self.reset()
            raise ReplicationError(body.decode(errors="replace"))
        self.watermark = off
        return off

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None


class Replicator:
    """Leader-side replication driver for one BrokerServer node.

    ``ensure(part, target)`` pushes the log up to ``target`` to every other
    replica of the partition and answers whether the publish may ack
    (in-sync count >= min_insync). Called under the partition's publish
    lock, so follower streams stay ordered per partition."""

    FAIL_THRESHOLD = 3      # consecutive failures before a follower leaves
                            # the in-sync set (counted — deterministic)

    def __init__(self, server, peers: list[str], node_index: int,
                 replication: int, min_insync: int = 1,
                 fault_plan=None, rejoin_every: int = 8):
        self.server = server
        self.peers = list(peers)
        self.node_index = int(node_index)
        self.replication = max(1, min(int(replication), len(self.peers)))
        self.min_insync = max(1, int(min_insync))
        self.fault_plan = fault_plan
        self.rejoin_every = max(1, int(rejoin_every))
        self._links: dict[tuple[int, int], FollowerLink] = {}
        self._skips: dict[tuple[int, int], int] = {}

    def replica_indexes(self, part: int) -> list[int]:
        n = len(self.peers)
        return [(part + i) % n for i in range(self.replication)]

    def follower_indexes(self, part: int) -> list[int]:
        return [i for i in self.replica_indexes(part) if i != self.node_index]

    def _link(self, part: int, idx: int) -> FollowerLink:
        key = (part, idx)
        link = self._links.get(key)
        if link is None:
            link = FollowerLink(self.peers[idx], part,
                                fault_plan=self.fault_plan)
            self._links[key] = link
        return link

    def ensure(self, part: int, target: int, fresh=None) -> tuple[bool, int]:
        """Push partition ``part`` up to end offset ``target`` on every
        follower; returns (acked, retry_hint_ms). ``fresh`` optionally
        carries the just-appended (offset, pub_id, frame) entries so the
        steady state skips the log re-read."""
        insync = 1                          # self
        # our leadership epoch rides every batch; followers holding a higher
        # epoch refuse it and we step down (adopt + report not-acked)
        epoch, owner = (self.server.epochs.get(part)
                        if getattr(self.server, "epochs", None) is not None
                        else (0, ""))
        for idx in self.follower_indexes(part):
            link = self._link(part, idx)
            key = (part, idx)
            if link.fails >= self.FAIL_THRESHOLD:
                # out of the in-sync set: retry only every rejoin_every-th
                # publish so a dead peer doesn't tax every ack with a
                # connect attempt — and bound the rejoin probe's connect
                # stall hard (it runs under the partition publish lock; a
                # packet-dropping peer must not freeze ingest for the full
                # steady-state timeout)
                n = self._skips.get(key, 0) + 1
                self._skips[key] = n
                if n % self.rejoin_every:
                    self._lag_gauge(part, link).update(
                        float(target - (link.watermark or 0)))
                    continue
                link.timeout_s = 1.0
            else:
                link.timeout_s = 5.0
            try:
                wm = link.watermark
                if wm is None:
                    wm = link.replicate([], epoch, owner)   # probe
                while wm < target:
                    if fresh and fresh[0][0] == wm and \
                            sum(len(f) for _o, _p, f in fresh) \
                            <= _MAX_CATCHUP_BYTES:
                        batch = fresh       # steady state, byte-bounded —
                        # an oversized publish burst falls through to the
                        # chunked log read below
                    else:
                        batch = self.server._frames_with_ids(
                            part, wm, target, _MAX_CATCHUP_BYTES)
                    if not batch:
                        raise ReplicationError(
                            f"no frames to replicate at watermark {wm}")
                    new_wm = link.replicate(batch, epoch, owner)
                    if new_wm <= wm:
                        raise ReplicationError(
                            f"follower {link.addr} made no progress "
                            f"(watermark {new_wm})")
                    wm = new_wm
                link.fails = 0
                self._skips[key] = 0
                insync += 1
            except (ConnectionError, OSError, ReplicationError) as e:
                link.fails += 1
                link.reset()
                if isinstance(e, ReplicationError):
                    self._maybe_step_down(part, str(e))
                log.warning("replication to %s for partition %d failed "
                            "(%d consecutive): %s", self.peers[idx], part,
                            link.fails, e)
            self._lag_gauge(part, link).update(
                float(target - (link.watermark or 0)))
        return insync >= self.min_insync, 100

    def _maybe_step_down(self, part: int, msg: str) -> None:
        """A follower refused a batch with a fenced message: adopt the
        higher epoch so this node's publish path refuses further acks —
        the deposed leader steps down the moment it learns of its
        deposition."""
        epochs = getattr(self.server, "epochs", None)
        if epochs is None:
            return
        from ..cluster.gossip import parse_fenced
        parsed = parse_fenced(msg)
        if parsed is None:
            return
        fpart, fepoch, fowner = parsed
        if fpart == part and epochs.adopt(part, fepoch, fowner):
            log.warning("partition %d: stepped down — follower fenced us at "
                        "epoch %d (owner %s)", part, fepoch, fowner)

    def _lag_gauge(self, part: int, link: FollowerLink):
        return registry.gauge(FILODB_INGEST_REPLICATION_LAG,
                              {"partition": str(part), "peer": link.addr})

    def close(self) -> None:
        for link in self._links.values():
            link.close()
        self._links.clear()
