"""Chunk persistence: ChunkSink/ChunkSource traits + implementations.

Host copy of ``filodb_tpu/core/store.py``: every byte format (the chunk-log
frames, ``partkeys.log``, ``index.log``, ``checkpoint.json`` and
``meta.json``) is the reference's, so a sink written by either package
recovers in the other. No device code.

Reference: core/.../store/ChunkSink.scala:18 (sink trait + NullColumnStore:98),
ChunkSource.scala (read side), cassandra/.../columnstore/CassandraColumnStore.scala
(chunk table, ingestion-time index, partkey table).

TPU-native shape: a flushed chunkset is a *columnar batch* — one frame per flush
group holding per-series compressed vectors (delta-delta timestamps + XOR/
NibblePack values; the same codecs the reference stores in Cassandra cells).
The FileColumnStore keeps, per (dataset, shard):
    chunks.log     append-only chunkset frames (the chunk table)
    partkeys.log   part-key id -> labels json (the partkey/index table)
    checkpoint.json  per-flush-group offset watermarks (the checkpoint table)
"""

from __future__ import annotations

import io
import json
import os
import shutil
import struct
import threading
from dataclasses import dataclass

import numpy as np

from ..memory import deltadelta, hist as histcodec, intpack, nibblepack
from ..memory import native as _native

# nb-field flag marking a bit-packed integer value chunk (high bit: real
# histogram bucket counts never approach it)
_INTPACK_FLAG = 0x80000000
_MULTICOL_FLAG = 0x40000000

# persistence hot path prefers the C++ codecs (bit-identical; the numpy
# codecs are the spec, tests/test_torch_codecs.py); ``CODEC_BACKEND`` names
# the one this process runs
if _native.available():
    _pack_doubles, _unpack_doubles = _native.pack_doubles, _native.unpack_doubles
    CODEC_BACKEND = "native"
else:  # pragma: no cover - toolchain-less fallback
    _pack_doubles, _unpack_doubles = nibblepack.pack_doubles, nibblepack.unpack_doubles
    CODEC_BACKEND = "numpy"

# ---------------------------------------------------------------------------


@dataclass
class ChunkSetRecord:
    """One series' slice of a flushed chunkset. ``layout`` (from
    Schema.col_layout) marks multi-value-column rows: values is [n, W] with
    each named column encoded separately on the wire."""
    part_id: int
    ts: np.ndarray
    values: np.ndarray
    layout: tuple | None = None


class ChunkSink:
    """Write side (ref: ChunkSink.scala trait)."""

    def write_chunkset(self, dataset: str, shard: int, group: int,
                       records: list[ChunkSetRecord]) -> None:
        raise NotImplementedError

    def write_part_keys(self, dataset: str, shard: int, entries) -> None:
        raise NotImplementedError

    def write_checkpoint(self, dataset: str, shard: int, group: int,
                         offset: int) -> None:
        raise NotImplementedError

    def read_checkpoints(self, dataset: str, shard: int) -> dict[int, int]:
        raise NotImplementedError


class NullColumnStore(ChunkSink):
    """No-op sink for tests/ephemeral nodes (ref: ChunkSink.scala:98)."""

    def __init__(self):
        self.chunksets_written = 0
        self._checkpoints: dict[tuple, dict[int, int]] = {}

    def write_chunkset(self, dataset, shard, group, records):
        self.chunksets_written += 1

    def write_part_keys(self, dataset, shard, entries):
        pass

    def write_checkpoint(self, dataset, shard, group, offset):
        self._checkpoints.setdefault((dataset, shard), {})[group] = offset

    def read_checkpoints(self, dataset, shard):
        return dict(self._checkpoints.get((dataset, shard), {}))


_CHUNK_HDR = struct.Struct("<IIQ")     # group, n_records, flush_seq


_DD_HDR = struct.Struct("<Iqq")        # deltadelta: n, first, slope
_INT_HDR = struct.Struct("<BBIq")      # intpack: version, bits, n, base
_INT_BOUNDS = (2, 4, 16, 256, 1 << 16, 1 << 32)   # span < bound: 1..32 bits


def _int_columns(flat: np.ndarray, starts: np.ndarray, lens: np.ndarray):
    """Per record (a segment of ``flat``): whether its values are integral
    (``intpack.is_integral``), and for those the int64 values, the base
    (minimum) and the bit width ``intpack.pack_ints`` picks."""
    v = flat.astype(np.float64)
    ok = (np.abs(v) < 2**53) & (v == np.floor(v))
    integral = np.logical_and.reduceat(ok, starts)
    with np.errstate(invalid="ignore"):
        ints = np.where(ok, v, 0.0).astype(np.int64)
    base = np.minimum.reduceat(ints, starts)
    span = np.maximum.reduceat(ints, starts) - base
    bits = np.select([span == 0] + [span < b for b in _INT_BOUNDS],
                     [0, 1, 2, 4, 8, 16, 32], 64)
    return integral, ints, base, bits


def _encode_records_fast(records):
    """Each record's bytes (its header, timestamps and values) for a frame
    of scalar or multi-scalar-column records with at least one sample
    each, or None (the per-record encoding then runs). Byte for byte what
    the per-record encoding writes, with the same codecs: the checks each
    record's encoding makes (integrality, base, bit width, delta-delta
    slope) run once over the whole frame, and timestamps on their slope
    line (all-zero residual groups) are written without a pack call."""
    n_rec = len(records)
    layout = records[0].layout
    if any(r.layout != layout for r in records):
        return None
    if layout is not None and any(w != 1 or is_h
                                  for _nm, _o, w, is_h in layout):
        return None
    vals = [np.asarray(r.values) for r in records]
    if any(v.dtype.kind != "f" or v.ndim != (1 if layout is None else 2)
           for v in vals):
        return None
    lens = np.fromiter((len(r.ts) for r in records), np.int64, n_rec)
    if lens.min() < 1:
        return None
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    ts = np.concatenate([np.asarray(r.ts, np.int64) for r in records])
    first = ts[starts]
    diff = ts[starts + lens - 1] - first
    if np.abs(diff).max() >= 2**53:
        return None
    slope = np.where(lens > 1, np.rint(diff / np.maximum(lens - 1, 1)),
                     0).astype(np.int64)
    rec_of = np.repeat(np.arange(n_rec), lens)
    pos = np.arange(len(ts)) - starts[rec_of]
    on_line = np.logical_and.reduceat(
        ts == first[rec_of] + slope[rec_of] * pos, starts)
    flat = np.concatenate(vals)
    cols = ([flat] if layout is None
            else [flat[:, o] for _nm, o, _w, _h in layout])
    per_col = [_int_columns(c, starts, lens) for c in cols]
    lens_l, first_l, slope_l = lens.tolist(), first.tolist(), slope.tolist()
    out = []
    for i, r in enumerate(records):
        n = lens_l[i]
        if on_line[i]:
            ts_enc = _DD_HDR.pack(n, first_l[i], slope_l[i]) \
                + b"\x00" * (-(-n // 8))
        else:
            ts_enc = deltadelta.encode(r.ts)
        lo = int(starts[i])
        encs = []
        for c, (integral, ints, base, bits) in zip(cols, per_col):
            if integral[i]:
                b = int(bits[i])
                if b == 0:
                    enc = _INT_HDR.pack(1, 0, n, int(base[i]))
                elif b >= 8:
                    enc = _INT_HDR.pack(1, b, n, int(base[i])) + (
                        ints[lo:lo + n] - base[i]).astype(
                            f"<u{b // 8}").tobytes()
                else:
                    enc = intpack.pack_ints(ints[lo:lo + n])
                encs.append((1, enc))
            else:
                encs.append((0, _pack_doubles(
                    c[lo:lo + n].astype(np.float64))))
        if layout is None:
            kind, val_enc = encs[0]
            nb = _INTPACK_FLAG if kind else 0
        else:
            nb = _MULTICOL_FLAG
            val_enc = struct.pack("<H", len(layout)) + b"".join(
                struct.pack("<BHI", kind, 1, len(enc)) + enc
                for kind, enc in encs)
        out.append(struct.pack("<IIIII", r.part_id, n, nb, len(ts_enc),
                               len(val_enc)) + ts_enc + val_enc)
    return out


def encode_chunkset(group: int, records) -> bytes:
    """One chunk-log frame: header + per-record codec-compressed payload.
    Shared by the local file store and the remote store client."""
    fast = _encode_records_fast(records) if records else None
    if fast is not None:
        payload = b"".join(fast)
        return (_CHUNK_HDR.pack(group, len(records), 0)
                + struct.pack("<I", len(payload)) + payload)
    frames = []
    for r in records:
        ts_enc = deltadelta.encode(r.ts)
        vals = np.asarray(r.values)
        if r.layout is not None:   # multi-value-column row: per-column codecs
            nb = _MULTICOL_FLAG
            cols = [struct.pack("<H", len(r.layout))]
            for _nm, off, w, is_h in r.layout:
                cv = vals[:, off:off + w]
                if is_h:
                    enc = histcodec.encode_hist_series(cv)
                    kind = 2
                elif len(cv) and intpack.is_integral(cv[:, 0]):
                    enc = intpack.pack_ints(cv[:, 0].astype(np.int64))
                    kind = 1
                else:
                    enc = _pack_doubles(cv[:, 0].astype(np.float64))
                    kind = 0
                cols.append(struct.pack("<BHI", kind, w, len(enc)) + enc)
            val_enc = b"".join(cols)
        elif vals.ndim == 2:   # histogram: 2D-delta + NibblePack codec
            nb = vals.shape[1]
            val_enc = histcodec.encode_hist_series(vals)
        elif len(vals) and intpack.is_integral(vals):
            # integral chunk (counts, integer gauges): bit-packed int
            # vector, flagged in the nb field's high bit (ref:
            # IntBinaryVector bit-packed family)
            nb = _INTPACK_FLAG
            val_enc = intpack.pack_ints(vals.astype(np.int64))
        else:
            nb = 0
            val_enc = _pack_doubles(vals.astype(np.float64))
        frames.append(struct.pack("<IIIII", r.part_id, len(r.ts), nb,
                                  len(ts_enc), len(val_enc)) + ts_enc + val_enc)
    payload = b"".join(frames)
    return (_CHUNK_HDR.pack(group, len(records), 0)
            + struct.pack("<I", len(payload)) + payload)


def _decode_multicol(buf: bytes, n: int):
    """Inverse of the multi-column encoding: [n, W] f64 + wire layout
    (names are not on the wire; offsets/widths/kinds suffice — the consumer
    splits by its schema's layout, which recovery validates by width)."""
    (ncols,) = struct.unpack_from("<H", buf, 0)
    fast = _decode_scalar_columns(buf, n, ncols)
    if fast is not None:
        return fast
    off = 2
    cols = []
    layout = []
    at = 0
    for _ in range(ncols):
        kind, w, plen = struct.unpack_from("<BHI", buf, off); off += 7
        p = buf[off:off + plen]; off += plen
        if kind == 2:
            cols.append(histcodec.decode_hist_series(p).astype(np.float64))
        elif kind == 1:
            cols.append(intpack.unpack_ints(p).astype(np.float64)[:, None])
        else:
            cols.append(_unpack_doubles(p, n)[:, None])
        layout.append((f"c{len(layout)}", at, w, kind == 2))
        at += w
    return np.concatenate(cols, axis=1), tuple(layout)


_SCALAR_LAYOUTS: dict[int, tuple] = {}


def _decode_scalar_columns(buf: bytes, n: int, ncols: int):
    """``_decode_multicol`` for a record whose columns are all scalar
    (intpack at 0 or 8-64 bits, or doubles), written straight into one
    [n, ncols] f64 block; None for anything else (histogram or sub-byte
    columns, a payload whose sizes disagree), which the general decode
    then reads and checks."""
    out = np.empty((n, ncols), np.float64)
    off = 2
    for j in range(ncols):
        kind, w, plen = struct.unpack_from("<BHI", buf, off)
        off += 7
        if w != 1:
            return None
        if kind == 1:
            ver, bits, cnt, base = _INT_HDR.unpack_from(buf, off)
            if ver != 1 or cnt != n or bits not in (0, 8, 16, 32, 64) \
                    or plen != _INT_HDR.size + n * bits // 8:
                return None
            if bits:
                out[:, j] = np.frombuffer(
                    buf, f"<u{bits // 8}", n,
                    off + _INT_HDR.size).astype(np.int64) + base
            else:
                out[:, j] = np.int64(base)
        elif kind == 0:
            out[:, j] = _unpack_doubles(buf[off:off + plen], n)
        else:
            return None
        off += plen
    layout = _SCALAR_LAYOUTS.get(ncols)
    if layout is None:
        layout = _SCALAR_LAYOUTS[ncols] = tuple(
            (f"c{j}", j, 1, False) for j in range(ncols))
    return out, layout


def _decode_ts(payload: bytes, off: int, tlen: int) -> np.ndarray:
    """``deltadelta.decode`` of ``payload[off:off + tlen]``; timestamps on
    their slope line (every residual group zero) come back from the header
    alone."""
    if tlen > _DD_HDR.size:
        n, first, slope = _DD_HDR.unpack_from(payload, off)
        body = off + _DD_HDR.size
        if (tlen - _DD_HDR.size == -(-n // 8)
                and payload.count(b"\x00", body, off + tlen) == -(-n // 8)):
            return first + slope * np.arange(n, dtype=np.int64)
    return deltadelta.decode(payload[off:off + tlen])


def iter_chunksets(f, start_ms: int = 0, end_ms: int = 1 << 62):
    """Parse a chunk-log stream (any binary file-like): yields (group,
    [ChunkSetRecord...]) overlapping [start_ms, end_ms]. Shared by the local
    file store and the remote store client; a torn or corrupt tail frame
    truncates (WAL semantics)."""
    while True:
        hdr = f.read(_CHUNK_HDR.size)
        if len(hdr) < _CHUNK_HDR.size:
            return
        try:
            group, n_rec, _ = _CHUNK_HDR.unpack(hdr)
            raw_len = f.read(4)
            if len(raw_len) < 4:
                return            # torn tail: a crashed append; truncate
            (plen,) = struct.unpack("<I", raw_len)
            payload = f.read(plen)
            if len(payload) < plen:
                return            # torn tail
            records = []
            off = 0
            for _ in range(n_rec):
                pid, n, nb, tlen, vlen = struct.unpack_from("<IIIII", payload, off)
                off += 20
                ts = _decode_ts(payload, off, tlen); off += tlen
                layout = None
                if nb == _INTPACK_FLAG:
                    vals = intpack.unpack_ints(
                        payload[off:off + vlen]).astype(np.float64)
                elif nb == _MULTICOL_FLAG:
                    vals, layout = _decode_multicol(payload[off:off + vlen], n)
                elif nb:
                    vals = histcodec.decode_hist_series(
                        payload[off:off + vlen]).astype(np.float64)
                else:
                    vals = _unpack_doubles(payload[off:off + vlen], n)
                off += vlen
                if len(ts) and ts[-1] >= start_ms and ts[0] <= end_ms:
                    records.append(ChunkSetRecord(pid, ts, vals, layout))
        except (struct.error, ValueError, IndexError):
            return                # corrupt tail frame: stop at last good one
        if records:
            yield group, records


def head_frame_min_ts(f):
    """Min timestamp of the FIRST chunk-log frame on a stream (None when the
    log is empty/torn): the cheap age-out skip probe. Frames append in flush
    order, so between TTL boundaries (the steady state) the head frame holds
    nothing past the cutoff and the full read-decode-rewrite pass — which
    would drop nothing — can be skipped after one small read. Out-of-order
    older samples in LATER frames are only deferred, never retained forever:
    the cutoff advances with the data lead, so once it passes the head
    frame's own timestamps a full pass runs and drops them."""
    head = next(iter_chunksets(f), None)
    if head is None:
        return None
    _group, records = head
    return min(int(r.ts[0]) for r in records)


def encode_age_out(chunksets, cutoff_ms: int) -> tuple[bytes, int]:
    """Re-encode a chunk-log stream keeping only samples at or after
    ``cutoff_ms`` (the durable raw-retention compaction, shared by the local
    file store and the remote store client). Returns (new log bytes, samples
    dropped); records emptied entirely are elided, untouched records
    re-encode bit-identically (same codecs, same order)."""
    frames = []
    dropped = 0
    for group, records in chunksets or ():
        keep = []
        for r in records:
            sel = r.ts >= cutoff_ms
            if sel.all():
                keep.append(r)
            elif sel.any():
                keep.append(ChunkSetRecord(r.part_id, r.ts[sel],
                                           np.asarray(r.values)[sel],
                                           r.layout))
                dropped += int((~sel).sum())
            else:
                dropped += len(r.ts)
        if keep:
            frames.append(encode_chunkset(group, keep))
    return b"".join(frames), dropped


def _good_frame_prefix_len(data: bytes) -> int:
    """Byte length of the longest structurally complete frame prefix of a
    chunk log. The lock-free half of the age-out split snapshots the log
    while a flush append may be mid-write; cutting anywhere but a frame
    boundary would splice half a frame in front of the appends that land
    after the snapshot, and the WAL reader would truncate every one of
    them at the torn half."""
    off = 0
    hdr = _CHUNK_HDR.size
    while True:
        if off + hdr + 4 > len(data):
            return off
        (plen,) = struct.unpack_from("<I", data, off + hdr)
        end = off + hdr + 4 + plen
        if end > len(data):
            return off
        off = end


# ---------------------------------------------------------------------------
# Part-key index time buckets (ref: the reference persists its Lucene index
# as time-bucket blobs and recovers from them instead of re-indexing raw
# part keys — SURVEY §5 "Checkpoint / resume"). One frame per touched bucket
# per flush drain, appended to index.log in event order; every frame carries
# its own CRC so a torn or damaged tail truncates instead of poisoning
# recovery. Entries are COLUMNAR: pid/start arrays plus length-prefixed
# label blobs (the full label set in part-key pair encoding), so recovery
# rebuilds the index with bulk array loads, not per-key JSON parsing.
# ---------------------------------------------------------------------------

_INDEX_HDR = struct.Struct("<qII")     # bucket_start_ms, payload_len, crc32

# tombstone entries (releases) ride a dedicated pseudo-bucket: event order
# within the log is what resolves slot reuse, not the bucket tag
INDEX_TOMBSTONE_BUCKET = -1
# GENESIS: this frame's entries are a COMPLETE live-series snapshot — the
# log is trustworthy from the LAST genesis onward (written at shard birth,
# and re-written after any recovery that had to fall back to partkeys.log,
# so an upgraded or persistence-toggled shard never loses pre-log series)
INDEX_GENESIS_BUCKET = -2
# RETIRE: everything before this marker is STALE (appended by a recovery
# running with index persistence OFF — events will accrue only in
# partkeys.log from here, so a later persistence-on restart must not trust
# the pre-marker content; a fresh genesis after it restores trust)
INDEX_RETIRE_BUCKET = -3

# per-entry flags: bit0 = labels not representable in the pair encoding
# (separator bytes) — the entry is a placeholder and recovery must fall
# back to partkeys.log for the whole shard
INDEX_FLAG_UNPARSEABLE = 1


def encode_index_bucket(bucket_start_ms: int, entries) -> bytes:
    """One index.log frame: ``entries`` is [(pid, start_ms, label_blob)] or
    [(pid, start_ms, label_blob, flags)]; a tombstone entry carries an
    empty blob and start -1."""
    import zlib
    pids = np.asarray([e[0] for e in entries], np.int64)
    starts = np.asarray([e[1] for e in entries], np.int64)
    blobs = [e[2] for e in entries]
    flags = np.asarray([(e[3] if len(e) > 3 else 0) for e in entries],
                       np.uint8)
    lens = np.asarray([len(b) for b in blobs], np.uint32)
    payload = zlib.compress(
        struct.pack("<I", len(entries)) + pids.tobytes() + starts.tobytes()
        + lens.tobytes() + flags.tobytes() + b"".join(blobs), 1)
    return _INDEX_HDR.pack(int(bucket_start_ms), len(payload),
                           zlib.crc32(payload)) + payload


def iter_index_frames(f):
    """Parse an index.log stream: yields (bucket_start_ms, pids, starts,
    blobs, flags) per frame in append (= event) order. A torn tail or a
    CRC mismatch truncates (WAL semantics) — recovery falls back to the
    per-key partkeys.log rebuild for anything the index log cannot prove."""
    import zlib
    while True:
        hdr = f.read(_INDEX_HDR.size)
        if len(hdr) < _INDEX_HDR.size:
            return
        try:
            bucket, plen, crc = _INDEX_HDR.unpack(hdr)
            payload = f.read(plen)
            if len(payload) < plen or zlib.crc32(payload) != crc:
                return
            raw = zlib.decompress(payload)
            (n,) = struct.unpack_from("<I", raw, 0)
            off = 4
            pids = np.frombuffer(raw, np.int64, count=n, offset=off)
            off += 8 * n
            starts = np.frombuffer(raw, np.int64, count=n, offset=off)
            off += 8 * n
            lens = np.frombuffer(raw, np.uint32, count=n, offset=off)
            off += 4 * n
            flags = np.frombuffer(raw, np.uint8, count=n, offset=off)
            off += n
            blobs = []
            for ln in lens.tolist():
                blobs.append(raw[off:off + ln])
                off += ln
        except (struct.error, ValueError, zlib.error, IndexError):
            return
        yield bucket, pids, starts, blobs, flags


def labels_from_blob(blob: bytes) -> dict[str, str]:
    """Inverse of the part-key pair encoding (schemas.part_key_bytes over
    the FULL label set)."""
    if not blob:
        return {}
    out = {}
    for pair in blob.split(b"\x00"):
        k, _, v = pair.partition(b"\x01")
        out[k.decode()] = v.decode()
    return out


class FileColumnStore(ChunkSink):
    """Durable columnar chunk store on local disk (the Cassandra-equivalent)."""

    def __init__(self, root: str):
        self.root = root

    def _dir(self, dataset: str, shard: int) -> str:
        d = os.path.join(self.root, dataset, f"shard{shard}")
        os.makedirs(d, exist_ok=True)
        return d

    # -- chunks --------------------------------------------------------------

    def write_chunkset(self, dataset, shard, group, records):
        # one buffered append minimizes the torn-frame window; the reader
        # treats a torn tail as truncation (WAL semantics)
        buf = encode_chunkset(group, records)
        with open(os.path.join(self._dir(dataset, shard), "chunks.log"), "ab") as f:
            f.write(buf)

    def read_chunksets(self, dataset, shard, start_ms: int = 0,
                       end_ms: int = 1 << 62):
        """Yield (group, [ChunkSetRecord...]) overlapping [start_ms, end_ms]
        (ref: RawChunkSource.readRawPartitions time-filtered reads)."""
        path = os.path.join(self._dir(dataset, shard), "chunks.log")
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            yield from iter_chunksets(f, start_ms, end_ms)

    def age_out_prepare(self, dataset, shard, cutoff_ms: int):
        """Heavy half of durable raw retention, safe to run with NO locks
        held: snapshot the chunk log's good-frame prefix, read, decode and
        re-encode it dropping samples older than ``cutoff_ms``. Returns an
        opaque token for ``age_out_commit``, or None when nothing would
        drop (empty/absent log, or the head-frame probe shows the cutoff
        has not reached the oldest frame). Frames appended after the
        snapshot hold fresh samples by construction and are preserved
        verbatim by the commit's splice."""
        path = os.path.join(self._dir(dataset, shard), "chunks.log")
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            data = f.read()
        # cut at a frame boundary: a flush append may be mid-write while we
        # read (prepare holds no locks), and splicing half a frame in front
        # of later appends would truncate every frame behind it at read
        snap = _good_frame_prefix_len(data)
        bio = io.BytesIO(data[:snap])
        head = head_frame_min_ts(bio)
        if head is None or head >= cutoff_ms:
            return None
        bio.seek(0)
        buf, dropped = encode_age_out(list(iter_chunksets(bio)), cutoff_ms)
        if not dropped:
            return None
        return (path, snap, buf, dropped)

    def age_out_commit(self, token) -> int:
        """Cheap half of durable raw retention, run under the group flush
        locks (see TimeSeriesShard.age_out_durable): splice the rewritten
        prefix with whatever was appended since the prepare snapshot —
        bounded by one flush batch per group, since the locks serialize
        appends — and atomically swap the log. Returns samples dropped."""
        path, snap, buf, dropped = token
        tmp = path + ".tmp"
        with open(tmp, "wb") as out:
            out.write(buf)
            with open(path, "rb") as f:
                f.seek(snap)
                shutil.copyfileobj(f, out)
        os.replace(tmp, path)   # atomic commit
        return dropped

    def age_out(self, dataset, shard, cutoff_ms: int) -> int:
        """Durable raw retention: atomically rewrite the chunk log dropping
        samples older than ``cutoff_ms`` (caller serializes against
        concurrent flush appends — see TimeSeriesShard.age_out_durable).
        Returns samples dropped."""
        token = self.age_out_prepare(dataset, shard, cutoff_ms)
        return self.age_out_commit(token) if token is not None else 0

    # -- part keys ------------------------------------------------------------

    def chunk_log_size(self, dataset, shard) -> int:
        """Byte size of the shard's chunk log (cheap best-replica probe)."""
        path = os.path.join(self._dir(dataset, shard), "chunks.log")
        return os.path.getsize(path) if os.path.exists(path) else 0

    def write_part_keys(self, dataset, shard, entries):
        """entries: iterable of (part_id, labels_dict, start_time)."""
        with open(os.path.join(self._dir(dataset, shard), "partkeys.log"), "a") as f:
            for pid, labels, start in entries:
                f.write(json.dumps({"id": pid, "labels": labels, "start": start},
                                   separators=(",", ":")) + "\n")

    def read_part_keys(self, dataset, shard):
        path = os.path.join(self._dir(dataset, shard), "partkeys.log")
        if not os.path.exists(path):
            return
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                try:
                    e = json.loads(line)
                except ValueError:
                    return            # torn tail line from a crashed append
                yield e["id"], e["labels"], e["start"]

    def write_index_bucket(self, dataset, shard, frame: bytes) -> None:
        """Append one pre-encoded index time-bucket frame (CRC inside the
        frame; torn tails truncate at read)."""
        with open(os.path.join(self._dir(dataset, shard), "index.log"),
                  "ab") as f:
            f.write(frame)

    def read_index_frames(self, dataset, shard):
        """Yield (bucket_start_ms, pids, starts, blobs) in event order."""
        path = os.path.join(self._dir(dataset, shard), "index.log")
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            yield from iter_index_frames(f)

    def write_meta(self, dataset, shard, meta: dict):
        path = os.path.join(self._dir(dataset, shard), "meta.json")
        with open(path, "w") as f:
            json.dump(meta, f)

    def read_meta(self, dataset, shard) -> dict:
        path = os.path.join(self._dir(dataset, shard), "meta.json")
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            return json.load(f)

    # -- checkpoints (ref: cassandra/.../metastore/CheckpointTable.scala) ------

    # serializes the checkpoint read-modify-write across ALL instances of a
    # process (tests open several stores over one root): two flush groups
    # committing concurrently must not lose each other's watermark — the
    # same contract OP_CHECKPOINT gives the remote tier server-side
    _checkpoint_lock = threading.Lock()

    def write_checkpoint(self, dataset, shard, group, offset):
        path = os.path.join(self._dir(dataset, shard), "checkpoint.json")
        with FileColumnStore._checkpoint_lock:
            cp = self.read_checkpoints(dataset, shard)
            cp[group] = offset
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({str(k): v for k, v in cp.items()}, f)
            os.replace(tmp, path)   # atomic commit

    def read_checkpoints(self, dataset, shard):
        path = os.path.join(self._dir(dataset, shard), "checkpoint.json")
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            return {int(k): v for k, v in json.load(f).items()}
