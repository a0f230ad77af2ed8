"""Distributed, durable chunk store — the Cassandra-layer equivalent.

Host copy of ``filodb_tpu/core/diststore.py``: pure host Python over the
port's ``core/store.py`` frame codecs, byte for byte the reference's wire
protocol and files, so a port ``RemoteStore`` reads and writes a JAX
``StoreServer`` and the reverse. Reference: cassandra/.../columnstore/CassandraColumnStore.scala:47 (chunk +
ingestion-time-index + partkey tables, token-range ``getScanSplits`` feeding
Spark batch jobs) and metastore/CheckpointTable.scala. Cassandra supplies
replication and remote durability; here the same story is built from the
framework's own parts:

  - ``StoreServer``: a TCP daemon exposing one node's column-store files
    through three verbs (APPEND for the chunk/part-key logs, PUT for atomic
    meta/checkpoint replacement, GET for reads) — the "storage node".
  - ``RemoteStore``: a ChunkSink client speaking that protocol; byte-level
    formats are identical to FileColumnStore (the chunk-log parser is
    shared), so local and remote stores interoperate.
  - ``ReplicatedColumnStore``: fans writes out to ``replication`` replicas
    chosen on a ring keyed by (dataset, shard); reads fail over to the first
    healthy replica. Write succeeds if at least one replica accepted. A
    replica that misses a write stays divergent for those frames (effective
    RF degrades until the log is re-replicated operationally); reads defend
    against divergence by picking the replica with the most distinct
    in-range samples (see ``read_chunksets``), and recovery's replay dedups
    duplicate frames from retried flushes.
  - ``get_scan_splits``: time-range splits (the token-range analog), aligned
    to a resolution so batch downsampling over splits never splits a bucket.
"""

from __future__ import annotations

import io
import json
import logging
import socket
import socketserver
import struct
import threading
import time
import zlib

import numpy as np

from ..utils.metrics import FILODB_RETENTION_REPLICA_FAILOVER, registry
from ..utils.netio import recv_exact as _recv_exact
from .store import (ChunkSink, encode_age_out, encode_chunkset,
                    head_frame_min_ts, iter_chunksets)

log = logging.getLogger(__name__)

_REQ = struct.Struct("<BII")      # op, header_len, payload_len
_RESP = struct.Struct("<BQ")      # status (0 ok), u64 body_len (logs can be big)

OP_APPEND, OP_PUT, OP_GET, OP_STAT = 1, 2, 3, 4
# streaming/checkpoint ops of the durable-tier flush path:
#   OP_APPEND_CRC — CRC32-verified chunk-frame append: the server recomputes
#     the payload checksum and refuses a torn/corrupted frame instead of
#     appending garbage the log parser would silently truncate at
#   OP_CHECKPOINT — server-side atomic per-(dataset, shard, group) watermark
#     merge: the old client read-modify-write of checkpoint.json lost a
#     concurrent group's commit when two flush groups checkpointed at once
#   OP_COMMIT — atomic rename of a staged ``.rewrite`` object over its live
#     twin: age-out rewrites stage slices beside the log and commit once,
#     so a connection lost mid-rewrite leaves the live log untouched (a
#     truncating in-place PUT destroyed already-replicated frames)
OP_APPEND_CRC, OP_CHECKPOINT, OP_COMMIT = 5, 6, 7

_MAX_HEADER = 1 << 16             # refuse absurd frames instead of OOMing
_MAX_PAYLOAD = 256 << 20

_ALLOWED = {"chunks.log", "partkeys.log", "meta.json", "checkpoint.json",
            "chunks.log.rewrite", "index.log"}


class StoreServer:
    """One storage node: serves a FileColumnStore directory over TCP."""

    def __init__(self, root: str, host: str = "127.0.0.1", port: int = 0):
        import os
        self.root = root
        os.makedirs(root, exist_ok=True)
        # serializes checkpoint merges (OP_CHECKPOINT): two flush groups
        # committing concurrently must not lose each other's watermark
        self._cp_lock = threading.Lock()
        # per-object commit generation, bumped whenever a whole object is
        # REPLACED (OP_COMMIT age-out promotion, OP_PUT): ranged readers
        # compare the generation across their read to detect that offsets
        # from the old file landed mid-frame in a rewritten one
        self._gen_lock = threading.Lock()
        self._gens: dict = {}
        # established connections, severed by stop(): RemoteStore clients
        # pool their socket, so a handler thread blocked in recv would keep
        # SERVING a "stopped" node forever — an in-process kill must look
        # like a process kill (reset the peer) for failover to engage
        self._conns: set[socket.socket] = set()
        self._conns_lock = threading.Lock()
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def setup(self):
                with outer._conns_lock:
                    outer._conns.add(self.request)

            def finish(self):
                with outer._conns_lock:
                    outer._conns.discard(self.request)

            def handle(self):
                try:
                    while True:
                        hdr = _recv_exact(self.request, _REQ.size)
                        op, hlen, plen = _REQ.unpack(hdr)
                        if hlen > _MAX_HEADER or plen > _MAX_PAYLOAD:
                            return   # garbage/hostile frame: drop connection
                        raw = _recv_exact(self.request, hlen)
                        payload = _recv_exact(self.request, plen) if plen else b""
                        try:
                            meta = json.loads(raw)
                            body = outer._serve(op, meta, payload)
                            self.request.sendall(_RESP.pack(0, len(body)) + body)
                        except Exception as e:  # noqa: BLE001 - to client
                            msg = str(e).encode()
                            self.request.sendall(_RESP.pack(1, len(msg)) + msg)
                except (ConnectionError, OSError):
                    return

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = Server((host, port), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="store-server")

    def _path(self, meta) -> str:
        import os
        name = meta["name"]
        dataset = str(meta["dataset"]).replace("/", "_").replace("..", "_")
        if name not in _ALLOWED:
            raise ValueError(f"unknown store object {name!r}")
        d = os.path.join(self.root, dataset, f"shard{int(meta['shard'])}")
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, name)

    def _serve(self, op: int, meta, payload: bytes) -> bytes:
        import os
        path = self._path(meta)
        if op == OP_APPEND:
            with open(path, "ab") as f:
                f.write(payload)
            return b""
        if op == OP_APPEND_CRC:
            # refuse a frame whose bytes were damaged in flight: appending it
            # would poison the log tail (the WAL parser stops at the first
            # bad frame, hiding every later good one)
            want = int(meta["crc"])
            got = zlib.crc32(payload)
            if got != want:
                raise ValueError(
                    f"chunk frame crc mismatch (got {got:#x}, want "
                    f"{want:#x}); refusing append")
            with open(path, "ab") as f:
                f.write(payload)
            return b""
        if op == OP_CHECKPOINT:
            # atomic server-side merge of one group's watermark
            with self._cp_lock:
                cp = {}
                if os.path.exists(path):
                    with open(path) as f:
                        cp = json.load(f)
                cp[str(int(meta["group"]))] = int(meta["offset"])
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(cp, f)
                os.replace(tmp, path)
            return b""
        if op == OP_PUT:
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(payload)
            os.replace(tmp, path)
            self._bump_gen(path)
            return b""
        if op == OP_COMMIT:
            # atomically promote a staged rewrite over the live object; the
            # stage must exist (a lost rewrite must surface, not no-op)
            if not path.endswith(".rewrite"):
                raise ValueError("commit target must be a staged "
                                 "'.rewrite' object")
            live = path[:-len(".rewrite")]
            os.replace(path, live)
            self._bump_gen(live)
            return b""
        if op == OP_GET:
            if not os.path.exists(path):
                return b""
            offset = int(meta.get("offset", 0))
            length = meta.get("length")
            with open(path, "rb") as f:
                f.seek(offset)
                return f.read(int(length)) if length is not None else f.read()
        if op == OP_STAT:
            size = os.path.getsize(path) if os.path.exists(path) else 0
            with self._gen_lock:
                gen = self._gens.get(path, 0)
            return struct.pack("<QQ", size, gen)
        raise ValueError(f"unknown op {op}")

    def _bump_gen(self, path: str) -> None:
        with self._gen_lock:
            self._gens[path] = self._gens.get(path, 0) + 1

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> "StoreServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        self._thread.join(timeout=3)


class RemoteStore(ChunkSink):
    """ChunkSink client of a StoreServer; wire formats match FileColumnStore.

    Connect and read are BOUNDED (``connect_timeout_s`` / ``timeout_s``): a
    dead backend surfaces as a timeout the ReplicatedColumnStore fails over
    from, instead of stalling the query/flush thread on a silent socket."""

    remote_tier = True     # ODP accounting: pages come over the wire

    def __init__(self, addr: str, timeout_s: float = 30.0,
                 connect_timeout_s: float = 5.0):
        self.addr = addr
        self.timeout_s = float(timeout_s)
        self.connect_timeout_s = float(connect_timeout_s)
        self._sock = None
        self._lock = threading.Lock()

    def _conn(self) -> socket.socket:
        if self._sock is None:
            host, port = self.addr.rsplit(":", 1)
            s = socket.create_connection((host, int(port)),
                                         timeout=self.connect_timeout_s)
            s.settimeout(self.timeout_s)   # bounds every recv/send after
            self._sock = s
        return self._sock

    def _request(self, op: int, dataset, shard, name, payload: bytes = b"",
                 **extra) -> bytes:
        meta = json.dumps({"dataset": dataset, "shard": shard,
                           "name": name, **extra}).encode()
        with self._lock:
            try:
                s = self._conn()
                s.sendall(_REQ.pack(op, len(meta), len(payload)) + meta + payload)
                status, blen = _RESP.unpack(_recv_exact(s, _RESP.size))
                body = _recv_exact(s, blen) if blen else b""
            except (ConnectionError, OSError):
                self.close()
                raise
        if status != 0:
            raise IOError(f"remote store error: {body.decode()}")
        return body

    # -- ChunkSink: writes ---------------------------------------------------

    def write_chunkset(self, dataset, shard, group, records):
        buf = encode_chunkset(group, records)
        self._request(OP_APPEND_CRC, dataset, shard, "chunks.log", buf,
                      crc=zlib.crc32(buf))

    def write_part_keys(self, dataset, shard, entries):
        lines = "".join(
            json.dumps({"id": pid, "labels": labels, "start": start},
                       separators=(",", ":")) + "\n"
            for pid, labels, start in entries)
        self._request(OP_APPEND, dataset, shard, "partkeys.log", lines.encode())

    def write_index_bucket(self, dataset, shard, frame: bytes):
        # CRC-verified append: a frame damaged in flight is refused by the
        # server, and the frame's OWN crc (inside the payload) still guards
        # the at-rest bytes at recovery time
        self._request(OP_APPEND_CRC, dataset, shard, "index.log", frame,
                      crc=zlib.crc32(frame))

    def read_index_frames(self, dataset, shard):
        from .store import iter_index_frames
        blob = self._request(OP_GET, dataset, shard, "index.log")
        yield from iter_index_frames(io.BytesIO(blob))

    def write_meta(self, dataset, shard, meta: dict):
        self._request(OP_PUT, dataset, shard, "meta.json",
                      json.dumps(meta).encode())

    def write_checkpoint(self, dataset, shard, group, offset):
        # one round trip, merged atomically server-side: the old client
        # read-modify-write lost a concurrent group's commit
        self._request(OP_CHECKPOINT, dataset, shard, "checkpoint.json",
                      group=int(group), offset=int(offset))

    # -- reads ---------------------------------------------------------------

    def read_chunksets(self, dataset, shard, start_ms: int = 0,
                       end_ms: int = 1 << 62):
        # stream the log in ranged chunks instead of buffering it whole: the
        # parser sees a buffered file-like over ranged GETs. The read takes
        # no lock against an age-out rewrite (OP_COMMIT swaps the file), so
        # bracket it with the server's commit generation: offsets from the
        # old file land mid-frame in the rewritten one and iter_chunksets
        # would silently truncate — raise instead, so the replicated layer
        # fails over (or the caller retries) rather than serving a partial
        # answer as complete
        gen0 = self._stat(dataset, shard, "chunks.log")[1]
        raw = _RangedReader(self, dataset, shard, "chunks.log")
        yield from iter_chunksets(io.BufferedReader(raw, 1 << 20),
                                  start_ms, end_ms)
        if self._stat(dataset, shard, "chunks.log")[1] != gen0:
            raise IOError("chunks.log was rewritten (age-out commit) during "
                          "a ranged read; rereading required")

    def read_part_keys(self, dataset, shard):
        blob = self._request(OP_GET, dataset, shard, "partkeys.log")
        for line in blob.decode().splitlines():
            if not line.strip():
                continue
            try:
                e = json.loads(line)
            except ValueError:
                return
            yield e["id"], e["labels"], e["start"]

    def _stat(self, dataset, shard, name) -> tuple:
        """(byte size, commit generation) of a store object."""
        body = self._request(OP_STAT, dataset, shard, name)
        return struct.unpack("<QQ", body) if body else (0, 0)

    def chunk_log_size(self, dataset, shard) -> int:
        """Byte size of the shard's chunk log (cheap best-replica probe)."""
        return self._stat(dataset, shard, "chunks.log")[0]

    def read_meta(self, dataset, shard) -> dict:
        blob = self._request(OP_GET, dataset, shard, "meta.json")
        return json.loads(blob) if blob else {}

    def read_checkpoints(self, dataset, shard):
        blob = self._request(OP_GET, dataset, shard, "checkpoint.json")
        return {int(k): v for k, v in json.loads(blob).items()} if blob else {}

    # age_out rewrite slice size: comfortably under the server's
    # _MAX_PAYLOAD frame cap (a whole-log single PUT would be silently
    # dropped — connection severed, no response — once the log outgrew it)
    _AGE_OUT_SLICE = 64 << 20

    def age_out(self, dataset, shard, cutoff_ms: int) -> int:
        """Durable raw retention: rewrite the shard's chunk log dropping
        samples older than ``cutoff_ms`` (the caller serializes against
        concurrent flush appends — see TimeSeriesShard.age_out_durable).
        The rewrite stages beside the live log in bounded CRC'd slices and
        commits with ONE atomic server-side rename (OP_COMMIT): a
        connection lost mid-rewrite leaves the live log untouched — a
        truncating in-place PUT would have destroyed already-replicated
        frames on that replica. Returns samples dropped."""
        # steady-state skip: probe the head frame with ONE small ranged
        # read — when it holds nothing past the cutoff, the full pass
        # would pull and decode the whole log over the network (and buffer
        # the rewrite in memory) to drop zero samples, all while the
        # caller holds every group flush lock (see head_frame_min_ts)
        raw = _RangedReader(self, dataset, shard, "chunks.log")
        head = head_frame_min_ts(io.BufferedReader(raw, 1 << 20))
        if head is None or head >= cutoff_ms:
            return 0
        buf, dropped = encode_age_out(
            self.read_chunksets(dataset, shard), cutoff_ms)
        if dropped:
            first, rest = buf[:self._AGE_OUT_SLICE], buf[self._AGE_OUT_SLICE:]
            self._request(OP_PUT, dataset, shard, "chunks.log.rewrite", first)
            for at in range(0, len(rest), self._AGE_OUT_SLICE):
                sl = rest[at:at + self._AGE_OUT_SLICE]
                self._request(OP_APPEND_CRC, dataset, shard,
                              "chunks.log.rewrite", sl, crc=zlib.crc32(sl))
            self._request(OP_COMMIT, dataset, shard, "chunks.log.rewrite")
        return dropped

    def close(self):
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None


class _RangedReader(io.RawIOBase):
    """File-like over ranged GETs (wrap in io.BufferedReader)."""

    _CHUNK = 4 << 20

    def __init__(self, store: "RemoteStore", dataset, shard, name):
        self._store = store
        self._args = (dataset, shard, name)
        self._pos = 0

    def readable(self):
        return True

    def readinto(self, b):
        want = min(len(b), self._CHUNK)
        blob = self._store._request(OP_GET, *self._args,
                                    offset=self._pos, length=want)
        b[:len(blob)] = blob
        self._pos += len(blob)
        return len(blob)


class ReplicatedColumnStore(ChunkSink):
    """Replication + failover over N backend stores (local or remote).

    Writes go to ``replication`` replicas chosen on a STABLE ring keyed by
    crc32(dataset:shard) — Python's hash() randomizes per process, which
    would strand previously written data. At least one replica must accept a
    write. Reads consult every reachable replica and serve the one with the
    most data: an outage can leave a replica with a gappy log, and a partial
    answer must not mask a complete one (ref: Cassandra replica placement;
    read-best stands in for read repair)."""

    remote_tier = True     # ODP accounting: pages come over the wire

    WRITE_ATTEMPTS = 2     # per-replica retries before the write is skipped
    # writes safe to re-send to the SAME replica: meta/checkpoint replace
    # atomically, and part-key / index-bucket events dedup at recovery
    # (latest-per-pid wins, so a duplicated frame replays identically).
    # Chunk appends are NOT here — a lost response after a server-side apply
    # would duplicate the frame in that replica's log; they get one attempt
    # per replica and rely on cross-replica failover instead
    _IDEMPOTENT_WRITES = frozenset({"write_meta", "write_checkpoint",
                                    "write_part_keys",
                                    "write_index_bucket"})

    def __init__(self, backends: list, replication: int = 2):
        assert backends, "need at least one backend"
        self.backends = backends
        self.replication = min(replication, len(backends))
        # optional epoch fence (cluster/epoch.py StoreFence): consulted
        # before EVERY replica write so a deposed shard owner's flush or
        # checkpoint raises FencedWriteError instead of corrupting the
        # shard a replacement node already warmed
        self.write_guard = None

    def _write(self, dataset, shard, fn_name, *args):
        if self.write_guard is not None:
            self.write_guard(dataset, shard, fn_name)
        return self._write_unguarded(dataset, shard, fn_name, *args)

    def _replicas(self, dataset, shard):
        key = f"{dataset}:{shard}".encode()
        start = zlib.crc32(key) % len(self.backends)
        return [self.backends[(start + i) % len(self.backends)]
                for i in range(self.replication)]

    @staticmethod
    def _count_failover(op: str) -> None:
        registry.counter(FILODB_RETENTION_REPLICA_FAILOVER,
                         {"op": op}).increment()

    def _write_unguarded(self, dataset, shard, fn_name, *args):
        wrote = 0
        last_err = None
        attempts = (self.WRITE_ATTEMPTS
                    if fn_name in self._IDEMPOTENT_WRITES else 1)
        for b in self._replicas(dataset, shard):
            # idempotent writes get one bounded same-replica retry (a
            # transient fault lands on retry); non-idempotent chunk appends
            # take one attempt per replica — failover, never re-send (see
            # _IDEMPOTENT_WRITES)
            for attempt in range(attempts):
                try:
                    getattr(b, fn_name)(dataset, shard, *args)
                    wrote += 1
                    break
                except Exception as e:  # noqa: BLE001 - replica tolerated
                    last_err = e
                    log.warning("replica write %s failed on %r "
                                "(attempt %d): %s", fn_name, b, attempt + 1, e)
                    if attempt + 1 < attempts:
                        # brief linear backoff before the same-replica
                        # retry: the transient fault (GC pause, fd churn)
                        # needs a beat to clear, and a hot re-send burns
                        # the attempt budget in microseconds
                        time.sleep(0.05 * (attempt + 1))
        if wrote == 0:
            raise IOError(f"all {self.replication} replicas failed") from last_err
        return wrote

    def write_chunkset(self, dataset, shard, group, records):
        self._write(dataset, shard, "write_chunkset", group, records)

    def write_part_keys(self, dataset, shard, entries):
        self._write(dataset, shard, "write_part_keys", list(entries))

    def write_meta(self, dataset, shard, meta):
        self._write(dataset, shard, "write_meta", meta)

    def write_checkpoint(self, dataset, shard, group, offset):
        self._write(dataset, shard, "write_checkpoint", group, offset)

    def _read_all(self, dataset, shard, fn_name, *args):
        """Results from every reachable replica: [(backend, result), ...]."""
        out = []
        last_err = None
        for b in self._replicas(dataset, shard):
            try:
                res = getattr(b, fn_name)(dataset, shard, *args)
                out.append((b, list(res) if res is not None and
                            fn_name in ("read_chunksets", "read_part_keys")
                            else res))
            except Exception as e:  # noqa: BLE001 - fail over
                last_err = e
                self._count_failover(fn_name)
                log.warning("replica read %s failed on %r: %s", fn_name, b, e)
        if not out:
            raise IOError("all replicas failed") from last_err
        return out

    def read_chunksets(self, dataset, shard, start_ms: int = 0,
                       end_ms: int = 1 << 62):
        """Best-replica read: a replica that missed appends during an outage
        must not mask a complete sibling.

        Range-bounded reads (queries, scan splits) materialize every
        reachable replica's overlapping records and serve the one with the
        most samples IN RANGE — exact, and bounded by the window. Unbounded
        reads (recovery scans the whole log) pick by a cheap size probe and
        stream, trying every replica in descending-size order; a failed stat
        only demotes a replica to the end of the order, never excludes it."""
        probed = []
        for b in self._replicas(dataset, shard):
            size = None
            if hasattr(b, "chunk_log_size"):
                try:
                    size = b.chunk_log_size(dataset, shard)
                except Exception as e:  # noqa: BLE001 - stat only demotes
                    log.warning("replica stat failed on %r: %s", b, e)
            probed.append((b, size))
        sizes = [s for _b, s in probed if s is not None]
        bounded = start_ms > 0 or end_ms < 1 << 62
        diverged = len(set(sizes)) != 1 or len(sizes) != len(probed)
        if bounded and diverged:
            # replicas disagree: materialize the window from each reachable
            # one and serve the most complete — exact, bounded by the window
            results = self._read_all(dataset, shard, "read_chunksets",
                                     start_ms, end_ms)

            def total(res):
                # count DISTINCT (pid, ts) samples: retried flushes can leave
                # duplicate frames, and raw lengths would let a
                # duplicate-inflated replica outrank a sibling holding more
                # distinct data
                per_pid: dict[int, list] = {}
                for _g, recs in res:
                    for r in recs:
                        per_pid.setdefault(r.part_id, []).append(r.ts)
                return sum(len(np.unique(np.concatenate(v)))
                           for v in per_pid.values())
            return max((res for _b, res in results), key=total)
        # replicas agree (or the read is an unbounded recovery scan): stream
        # from one, in descending-size order with failover
        order = sorted(probed, key=lambda p: -(p[1] if p[1] is not None else -1))
        last_err = None
        for b, _size in order:
            try:
                return list(b.read_chunksets(dataset, shard, start_ms, end_ms))
            except Exception as e:  # noqa: BLE001 - fail over
                last_err = e
                self._count_failover("read_chunksets")
                log.warning("replica read failed on %r: %s", b, e)
        raise IOError("all replicas failed") from last_err

    def read_part_keys(self, dataset, shard):
        results = self._read_all(dataset, shard, "read_part_keys")
        return max((res or [] for _b, res in results), key=len)

    def write_index_bucket(self, dataset, shard, frame: bytes):
        self._write(dataset, shard, "write_index_bucket", frame)

    def read_index_frames(self, dataset, shard):
        """Best-replica read of the index time buckets, trust-aware: a
        replica's log is only usable when a GENESIS frame follows its last
        RETIRE marker, and reachable replicas must AGREE on that — a
        sibling that missed a RETIRE write (gappy outage) could otherwise
        win the entry-count race and resurrect a stale log. On
        disagreement this returns an empty list, which recovery treats as
        untrusted (partkeys.log fallback — never a silent loss). Among
        agreeing-trusted replicas, the one holding the most index EVENTS
        wins."""
        from .store import INDEX_GENESIS_BUCKET, INDEX_RETIRE_BUCKET
        backends = [b for b in self._replicas(dataset, shard)
                    if hasattr(b, "read_index_frames")]
        if not backends:
            return []
        results = []
        last_err = None
        for b in backends:
            try:
                results.append(list(b.read_index_frames(dataset, shard)))
            except Exception as e:  # noqa: BLE001 - fail over
                last_err = e
                self._count_failover("read_index_frames")
                log.warning("replica index read failed on %r: %s", b, e)
        if not results:
            raise IOError("all replicas failed") from last_err

        def trusted(fr) -> bool:
            gen_at = retire_at = -1
            for i, frame in enumerate(fr):
                if frame[0] == INDEX_GENESIS_BUCKET:
                    gen_at = i
                elif frame[0] == INDEX_RETIRE_BUCKET:
                    retire_at = i
            return gen_at >= 0 and gen_at > retire_at

        verdicts = [trusted(fr) for fr in results]
        if not all(verdicts):
            if any(verdicts):
                log.warning("index.log replicas disagree on trust anchors "
                            "for %s shard %s; forcing partkeys.log fallback",
                            dataset, shard)
            return []
        return max(results,
                   key=lambda fr: sum(len(frame[1]) for frame in fr))

    def read_meta(self, dataset, shard) -> dict:
        for _b, res in self._read_all(dataset, shard, "read_meta"):
            if res:
                return res
        return {}

    def read_checkpoints(self, dataset, shard):
        # per-group max across replicas: the freshest durable watermark wins
        merged: dict[int, int] = {}
        for _b, res in self._read_all(dataset, shard, "read_checkpoints"):
            for g, off in (res or {}).items():
                merged[g] = max(merged.get(g, -1), off)
        return merged

    def age_out(self, dataset, shard, cutoff_ms: int) -> int:
        """Age raw samples past the retention horizon out of EVERY replica
        (each rewrites its own view — replicas may hold different frame
        sets after an outage; a per-replica rewrite never copies one
        replica's gaps onto another). Returns the max dropped count."""
        if self.write_guard is not None:
            self.write_guard(dataset, shard, "age_out")
        dropped = 0
        for b in self._replicas(dataset, shard):
            if not hasattr(b, "age_out"):
                continue
            try:
                dropped = max(dropped, b.age_out(dataset, shard, cutoff_ms))
            except Exception as e:  # noqa: BLE001 - replica tolerated
                self._count_failover("age_out")
                log.warning("replica age_out failed on %r: %s", b, e)
        return dropped

    def close(self):
        for b in self.backends:
            if hasattr(b, "close"):
                b.close()


def get_scan_splits(store, dataset, shard, n_splits: int,
                    align_ms: int = 60_000) -> list[tuple[int, int]]:
    """Time-range scan splits over a shard's persisted chunks (the
    ``getScanSplits`` token-range analog, CassandraColumnStore.scala:47).
    Boundaries align to ``align_ms`` so a batch job mapping over splits never
    splits a downsample bucket across two workers."""
    lo, hi = None, None
    for _g, records in store.read_chunksets(dataset, shard) or ():
        for r in records:
            if len(r.ts):
                lo = int(r.ts[0]) if lo is None else min(lo, int(r.ts[0]))
                hi = int(r.ts[-1]) if hi is None else max(hi, int(r.ts[-1]))
    if lo is None:
        return []
    n_splits = max(1, n_splits)
    lo_al = (lo // align_ms) * align_ms
    hi_al = ((hi // align_ms) + 1) * align_ms
    span = hi_al - lo_al
    per = max(((span // n_splits) // align_ms) * align_ms, align_ms)
    splits = []
    start = lo_al
    while start < hi_al:
        end = min(start + per, hi_al)
        if len(splits) == n_splits - 1:
            end = hi_al
        splits.append((start, end - 1))    # inclusive ranges, disjoint
        start = end
    return splits
