"""Ingest record containers — the zero-copy batch format between sources and shards.

Reference: core/.../binaryrecord2/ (RecordBuilder/RecordContainer/RecordSchema):
off-heap BinaryRecords exist to avoid JVM allocation in the ingest hot loop.
The TPU-native equivalent is *columnar numpy batches*: a container holds parallel
arrays (part-key hash, timestamp, value[, histogram buckets]) plus a side table of
label sets for new series — exactly what the device scatter consumes, with no
per-record Python objects on the hot path.

Wire form (for the ingest bus / gateway): a compact self-describing binary blob,
versioned, little-endian. Layout:

    u32 magic 'FTRC' | u16 version | u16 schema_id | u32 n | u32 nlabels_blob_len
    i64 ts[n] | f64 value[n]  (or hist: u16 nbuckets + f64 buckets[n*nbuckets])
    u64 part_hash[n] | u32 shard_hash[n] | i32 part_idx[n]
    label blob: json-encoded list of label dicts (only distinct series in batch)
    v2 trailer (version >= 2): u32 n_sets | u32 key_len[n_sets]
                               | u64 set_hash[n_sets] | key bytes concatenated
    (canonical part-key bytes + fnv1a64 per label set, so consumers resolve
    partitions by hash-table probe without re-sorting/re-encoding labels;
    v1 frames are still readable — keys are recomputed lazily)
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass

import numpy as np

from .schemas import Schema, part_key_bytes, part_key_of, shard_key_of

_MAGIC = 0x46545243  # 'FTRC'
_HDR = struct.Struct("<IHHII")

# 64-bit FNV-1a for part-key hashing (stable across hosts, unlike Python's hash()).
_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3


def fnv1a64(data: bytes) -> int:
    h = _FNV_OFFSET
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & 0xFFFFFFFFFFFFFFFF
    return h


@dataclass
class RecordContainer:
    """One columnar ingest batch for a single schema.

    Like the reference's BinaryRecord2 ingest records — which carry their
    partition-key region so the shard's PartitionSet can probe without
    allocating (binaryrecord2/RecordContainer.scala, PartitionSet.scala) —
    a container carries the canonical part-key BYTES and 64-bit hash per
    label set, so shard resolution is a pure hash-table probe with no
    re-sorting/re-encoding of labels."""
    schema: Schema
    ts: np.ndarray            # int64 [n] epoch millis
    values: np.ndarray        # f64 [n] or [n, nbuckets] for histograms
    part_hash: np.ndarray     # uint64 [n] full part-key hash
    shard_hash: np.ndarray    # uint32 [n] shard-key hash (ws/ns/metric only)
    part_idx: np.ndarray      # int32 [n] -> index into label_sets
    label_sets: list[dict[str, str]]
    bucket_les: np.ndarray | None = None   # f64 [nbuckets] histogram bucket tops
    part_keys: list[bytes] | None = None   # canonical key bytes per label set
    set_hashes: np.ndarray | None = None   # uint64 [n_sets] fnv1a64(part_keys)
    # columnar label structure (fixed: dict, vary: [name], cols: [[value]])
    # when the whole container came from ONE add_series_batch call — the
    # index's columnar bulk add consumes it directly (never serialized;
    # wire consumers re-derive nothing and fall back to key-bytes parsing)
    label_columns: tuple | None = None

    def __len__(self) -> int:
        return len(self.ts)

    def resolved_keys(self):
        """(part_keys, set_hashes), computing them when absent (v1 wire
        frames, hand-built containers)."""
        if self.part_keys is None:
            opts = self.schema.options
            self.part_keys = [part_key_of(ls, opts) for ls in self.label_sets]
        if self.set_hashes is None:
            self.set_hashes = np.fromiter(
                (fnv1a64(k) for k in self.part_keys), np.uint64,
                count=len(self.part_keys))
        return self.part_keys, self.set_hashes

    def to_bytes(self) -> bytes:
        blob = json.dumps(list(self.label_sets),
                          separators=(",", ":")).encode()
        n = len(self.ts)
        parts = [
            _HDR.pack(_MAGIC, 3, self.schema.schema_id, n, len(blob)),
            self.ts.astype("<i8").tobytes(),
        ]
        # v3 values section: bucket-count and row width are independent
        # (multi-column rows are wider than the histogram span)
        nb = len(self.bucket_les) if self.bucket_les is not None else 0
        W = self.values.shape[1] if self.values.ndim == 2 else 0
        parts.append(struct.pack("<H", nb))
        if nb:
            parts.append(self.bucket_les.astype("<f8").tobytes())
        parts.append(struct.pack("<H", W))
        parts.append(self.values.astype("<f8").tobytes())
        parts += [
            self.part_hash.astype("<u8").tobytes(),
            self.shard_hash.astype("<u4").tobytes(),
            self.part_idx.astype("<i4").tobytes(),
            blob,
        ]
        # v2 trailer: canonical part-key bytes + per-set hashes, so consumers
        # resolve partitions by hash probe without re-encoding labels
        keys, hashes = self.resolved_keys()
        lens = np.fromiter((len(k) for k in keys), np.uint32, count=len(keys))
        parts += [
            struct.pack("<I", len(keys)),
            lens.astype("<u4").tobytes(),
            hashes.astype("<u8").tobytes(),
            b"".join(keys),
        ]
        return b"".join(parts)

    @classmethod
    def from_bytes(cls, buf: bytes, schemas) -> "RecordContainer":
        magic, ver, sid, n, blob_len = _HDR.unpack_from(buf, 0)
        if magic != _MAGIC:
            raise ValueError("bad container magic")
        schema = schemas[sid]
        off = _HDR.size
        ts = np.frombuffer(buf, "<i8", n, off); off += 8 * n
        (nb,) = struct.unpack_from("<H", buf, off); off += 2
        bucket_les = None
        if ver >= 3:
            if nb:
                bucket_les = np.frombuffer(buf, "<f8", nb, off); off += 8 * nb
            (W,) = struct.unpack_from("<H", buf, off); off += 2
            if W:
                values = np.frombuffer(buf, "<f8", n * W, off).reshape(n, W)
                off += 8 * n * W
            else:
                values = np.frombuffer(buf, "<f8", n, off); off += 8 * n
        elif nb:
            bucket_les = np.frombuffer(buf, "<f8", nb, off); off += 8 * nb
            values = np.frombuffer(buf, "<f8", n * nb, off).reshape(n, nb); off += 8 * n * nb
        else:
            values = np.frombuffer(buf, "<f8", n, off); off += 8 * n
        part_hash = np.frombuffer(buf, "<u8", n, off); off += 8 * n
        shard_hash = np.frombuffer(buf, "<u4", n, off); off += 4 * n
        part_idx = np.frombuffer(buf, "<i4", n, off); off += 4 * n
        label_sets = json.loads(buf[off : off + blob_len]); off += blob_len
        part_keys = set_hashes = None
        if ver >= 2:
            (nk,) = struct.unpack_from("<I", buf, off); off += 4
            lens = np.frombuffer(buf, "<u4", nk, off); off += 4 * nk
            set_hashes = np.frombuffer(buf, "<u8", nk, off); off += 8 * nk
            part_keys = []
            for ln in lens.tolist():
                part_keys.append(buf[off:off + ln]); off += ln
        return cls(schema, ts, values, part_hash, shard_hash, part_idx,
                   label_sets, bucket_les, part_keys, set_hashes)


class _LazyBatchLabels:
    """Label dicts of a pure add_series_batch container, materialized only on
    first access: the columnar registration path reads just ``len()``, so a
    1M-series container never builds its 1M dicts at all (ref: the
    reference's ingest never materializes label maps either — BinaryRecords
    carry the key bytes and Lucene docs build from those)."""

    __slots__ = ("fixed", "vary", "cols", "_real")

    def __init__(self, fixed: dict, vary: list, cols: list):
        self.fixed = fixed
        self.vary = vary
        self.cols = cols
        self._real = None

    def _mat(self) -> list:
        if self._real is None:
            fixed, vary = self.fixed, self.vary
            out = []
            for row in zip(*self.cols):
                d = dict(fixed)
                d.update(zip(vary, row))
                out.append(d)
            self._real = out
        return self._real

    def __len__(self) -> int:
        return len(self.cols[0]) if self.cols else 0

    def __getitem__(self, i):
        if self._real is not None:
            return self._real[i]
        if isinstance(i, slice):
            return self._mat()[i]
        # single-row access builds ONE dict — consumers that touch a few
        # rows (partkey-log flush, debug paths) never materialize the batch
        d = dict(self.fixed)
        d.update((k, c[i]) for k, c in zip(self.vary, self.cols))
        return d

    def __iter__(self):
        return iter(self._mat())

    def __eq__(self, other):
        return list(self) == list(other)


class RecordBuilder:
    """Accumulates samples into RecordContainers (ref: RecordBuilder.scala:31).

    Label-set hashing is memoized so repeated series pay one dict lookup, not a
    re-hash — the moral equivalent of the reference's partKey hash cache
    (RecordBuilder sortAndComputeHashes + shard-key hash memoization).
    """

    def __init__(self, schema: Schema, bucket_les: np.ndarray | None = None):
        self.schema = schema
        self.bucket_les = bucket_les
        # sorted-labels tuple -> [pk_bytes, sk_bytes, part_hash?, shard_hash?]
        # (hashes lazily filled by the first build(); persists across resets)
        self._hash_cache: dict[tuple, list] = {}
        # fixed for the builder's lifetime: (layout, flat width, hist col) —
        # per-add recomputation would dominate the multi-column hot path
        nb = len(bucket_les) if bucket_les is not None else 0
        layout = schema.col_layout(nb)
        self._layout_cache = (
            layout, schema.flat_width(nb),
            next((nm for nm, _o, _w, ih in layout if ih), None))
        self.reset()

    def reset(self) -> None:
        self._ts: list[int] = []
        self._vals: list = []
        self._pidx: list[int] = []
        self._batches: list[tuple] = []   # add_batch array groups
        self._labels: list[dict[str, str]] = []
        self._part_keys: list[bytes] = []   # canonical key bytes per label set
        self._shard_keys: list[bytes] = []  # shard-key bytes per label set
        self._set_entries: list[list] = []  # _hash_cache rows per label set
        self._label_key_to_idx: dict[tuple, int] = {}
        # (fixed, vary, cols) when the container is exactly ONE
        # add_series_batch call; anything else clears it
        self._batch_cols: tuple | None = None

    def _intern(self, labels: dict[str, str]) -> int:
        """Label interning: canonical part/shard key BYTES are computed once
        per unique label set (memoized across builds); the 64-bit hashes are
        computed in one batched pass at build() time — per-record hashes are
        a fancy-index of the per-set hashes, so add() does no hashing at all
        (ref: BinaryRecords carry their part-key region; RecordBuilder
        sortAndComputeHashes batches the hash work)."""
        items = sorted(labels.items())
        return self._intern_key(tuple(items), items, labels)

    def _intern_key(self, key: tuple, items: list, labels: dict) -> int:
        idx = self._label_key_to_idx.get(key)
        if idx is None:
            cached = self._hash_cache.get(key)
            if cached is None:
                opts = self.schema.options
                # [pk, sk, part_hash?, shard_hash?] — hashes filled in by the
                # first build() and reused across builds (long-lived gateway
                # builders must not re-hash stable series every flush); the
                # part key derives from the ALREADY-sorted memo items (one
                # sort per unique series, not three)
                cached = [part_key_bytes(items, opts.ignore_shard_key_tags),
                          shard_key_of(labels, opts), None, None]
                self._hash_cache[key] = cached
            idx = len(self._labels)
            self._labels.append(dict(labels))
            self._part_keys.append(cached[0])
            self._shard_keys.append(cached[1])
            self._set_entries.append(cached)
            self._label_key_to_idx[key] = idx
        return idx

    def _flatten_value(self, value):
        """Multi-column flat row [W]: ``value`` may be a dict {col: scalar or
        buckets}, or a bare bucket array (legacy histogram callers — sum is
        unknowable, count = top bucket)."""
        layout, width, hist_col = self._layout_cache
        row = np.full(width, np.nan)
        if not isinstance(value, dict):
            if hist_col is None:
                raise TypeError(
                    f"schema {self.schema.name} has several value columns "
                    f"and no histogram column: pass a dict {{col: value}}, "
                    f"got {type(value).__name__}")
            arr = np.asarray(value, np.float64)
            value = {hist_col: arr}
            if any(nm == "count" for nm, _o, _w, _ih in layout) and len(arr):
                value["count"] = float(arr[-1])
        for nm, off, w, _is_h in layout:
            v = value.get(nm)
            if v is None:
                continue
            if w == 1:
                row[off] = float(v)
            else:
                row[off:off + w] = np.asarray(v, np.float64)
        return row

    def _to_list_labels(self) -> None:
        """Materialize a lazy batch-label sequence so per-record appends can
        extend it (a container mixing batch + singles loses the shortcut)."""
        if not isinstance(self._labels, list):
            self._labels = list(self._labels)

    def add(self, labels: dict[str, str], ts_ms: int, value) -> None:
        self._batch_cols = None       # mixed container: no columnar shortcut
        self._to_list_labels()
        idx = self._intern(labels)
        self._ts.append(ts_ms)
        if self.schema.is_multi_column:
            value = self._flatten_value(value)
        self._vals.append(value)
        self._pidx.append(idx)

    def add_interned(self, key: tuple, labels: dict[str, str], ts_ms: int,
                     value) -> None:
        """``add`` with a caller-memoized canonical key (the sorted
        ``labels.items()`` tuple): long-lived per-line ingest paths (the
        gateway's route memo) skip the per-record sort + tuple build — the
        hot-loop cost drops to one dict probe + three list appends."""
        self._batch_cols = None       # mixed container: no columnar shortcut
        self._to_list_labels()
        idx = self._label_key_to_idx.get(key)
        if idx is None:
            idx = self._intern_key(key, list(key), labels)
        self._ts.append(ts_ms)
        if self.schema.is_multi_column:
            value = self._flatten_value(value)
        self._vals.append(value)
        self._pidx.append(idx)

    def _flatten_batch(self, values, n: int) -> np.ndarray:
        """Vectorized multi-column flat rows [n, W]: ``values`` may be a dict
        {col: [n] or [n, B]} or a bare [n, B] bucket matrix (legacy histogram
        callers — count column derives from the top bucket)."""
        layout, width, hist_col = self._layout_cache
        rows = np.full((n, width), np.nan)
        if not isinstance(values, dict):
            if hist_col is None:
                raise TypeError(
                    f"schema {self.schema.name} has several value columns "
                    f"and no histogram column: pass a dict {{col: values}}")
            arr = np.asarray(values, np.float64)
            values = {hist_col: arr}
            if any(nm == "count" for nm, _o, _w, _ih in layout) and arr.size:
                values["count"] = arr[:, -1]
        for nm, off, w, _is_h in layout:
            v = values.get(nm)
            if v is None:
                continue
            v = np.asarray(v, np.float64)
            if len(v) != n:
                raise ValueError(
                    f"add_batch length mismatch: column {nm!r} has {len(v)} "
                    f"values for {n} timestamps")
            if w == 1:
                rows[:, off] = v
            else:
                rows[:, off:off + w] = v
        return rows

    def add_series_batch(self, labels: dict, ts_ms: int, value: float) -> None:
        """Register MANY series in one call: ``labels`` maps each label name
        to either a shared string or a sequence of per-series values (all
        sequences the same length). Every series receives one sample at
        ``ts_ms`` — the registration / discovery shape (ref: jmh
        IngestionBenchmark building containers of distinct part keys;
        RecordBuilder.scala addFromReader batch path).

        The hot path is vectorized: canonical part/shard key bytes come from
        ONE format template applied per series (labels sorted once, not per
        record) and hashing stays batched in build(); per-series Python work
        is one string format + one dict literal."""
        seqs = {k: v for k, v in labels.items() if not isinstance(v, str)}
        if not seqs:
            self.add(dict(labels), ts_ms, value)
            return
        lens = {len(v) for v in seqs.values()}
        if len(lens) != 1:
            raise ValueError(f"varying-label lengths differ: "
                             f"{ {k: len(v) for k, v in seqs.items()} }")
        (n,) = lens
        if n == 0:
            return
        names = sorted(labels)
        opts = self.schema.options
        ignore = set(opts.ignore_shard_key_tags)
        vary = sorted(seqs)               # positional order for both templates
        pos = {k: i for i, k in enumerate(vary)}
        esc = lambda s: s.replace("{", "{{").replace("}", "}}")  # noqa: E731
        # part-key template over sorted labels: varying values drop in by
        # position, shared ones are literal (brace-escaped — a value
        # containing {} must not be parsed as a format field)
        pk_tmpl = "\x00".join(
            f"{esc(k)}\x01{{{pos[k]}}}" if k in seqs
            else f"{esc(k)}\x01{esc(labels[k])}"
            for k in names if k not in ignore)
        sk_vary = any(k in seqs for k in opts.shard_key_columns)
        sk_tmpl = "\x00".join(
            f"{esc(k)}\x01{{{pos[k]}}}" if k in seqs
            else f"{esc(k)}\x01{esc(labels.get(k, ''))}"
            for k in opts.shard_key_columns)
        cols = [list(seqs[k]) for k in vary]
        base_idx = len(self._labels)
        fixed = {k: v for k, v in labels.items() if isinstance(v, str)}
        fmt_pk, fmt_sk = pk_tmpl.format, sk_tmpl.format
        if base_idx == 0 and self._batch_cols is None:
            # pure-batch container: label dicts stay lazy (never built unless
            # someone reads them) and the index consumes the columns directly
            self._batch_cols = (fixed, vary, cols)
            self._labels = _LazyBatchLabels(fixed, vary, cols)
            if len(cols) == 1:
                self._part_keys.extend(
                    fmt_pk(v).encode() for v in cols[0])
                if sk_vary:
                    self._shard_keys.extend(
                        fmt_sk(v).encode() for v in cols[0])
            else:
                for row in zip(*cols):
                    self._part_keys.append(fmt_pk(*row).encode())
                    if sk_vary:
                        self._shard_keys.append(fmt_sk(*row).encode())
        else:
            self._batch_cols = None
            self._to_list_labels()
            for row in zip(*cols):
                d = dict(fixed)
                d.update(zip(vary, row))
                self._labels.append(d)
                self._part_keys.append(fmt_pk(*row).encode())
                if sk_vary:
                    self._shard_keys.append(fmt_sk(*row).encode())
        if not sk_vary:
            # .format() unescapes the {{ }} literals even with no fields
            self._shard_keys.extend([fmt_sk().encode()] * n)
        # hashes batch-computed at build(); the shared None sentinel marks
        # "no memo row" — build() special-cases the pure-batch container
        self._set_entries.extend([None] * n)
        self._ts.extend([int(ts_ms)] * n)
        if self.schema.is_multi_column:
            value = self._flatten_value(value)
            self._vals.extend([value] * n)
        else:
            self._vals.extend([float(value)] * n)
        self._pidx.extend(range(base_idx, base_idx + n))

    def add_batch(self, labels: dict[str, str], ts_ms, values) -> None:
        """Bulk samples for ONE series: hashing/label interning happens once
        and the arrays ride through build() without per-sample Python work —
        the path for backfills, CSV imports, and synthetic generators."""
        self._batch_cols = None       # mixed container: no columnar shortcut
        self._to_list_labels()
        idx = self._intern(labels)
        ts_ms = np.asarray(ts_ms, np.int64)
        n = len(ts_ms)
        if self.schema.is_multi_column:
            values = self._flatten_batch(values, n)
        else:
            values = np.asarray(values)
        if len(values) != n:
            raise ValueError(
                f"add_batch length mismatch: {n} timestamps vs "
                f"{len(values)} values for {labels}")
        self._batches.append((ts_ms, values, np.full(n, idx, np.int32)))

    @staticmethod
    def _hash_keys(keys: list[bytes]) -> np.ndarray:
        from .native import available as _native_ok, fnv1a64_batch
        if keys and _native_ok():
            return fnv1a64_batch(keys)
        return np.fromiter((fnv1a64(k) for k in keys), np.uint64,
                           count=len(keys))

    def build(self) -> RecordContainer:
        ts = np.asarray(self._ts, dtype=np.int64)
        vals = np.asarray(self._vals, dtype=np.float64)
        pidx = np.asarray(self._pidx, dtype=np.int32)
        if self._batches:
            # a 1-D empty scalar head cannot concatenate with 2-D histogram
            # batch values: include the per-sample parts only when present
            vhead = [vals] if len(self._vals) else []
            head = [ts] if len(self._ts) else []
            ts = np.concatenate(head + [b[0] for b in self._batches])
            vals = np.concatenate(vhead + [np.asarray(b[1], np.float64)
                                           for b in self._batches])
            pidx = np.concatenate(([pidx] if len(self._pidx) else [])
                                  + [b[2] for b in self._batches])
        # hash only sets whose memo rows lack hashes (first sighting); stable
        # series across builds reuse their memoized hashes. A pure batch
        # container (every entry the None sentinel) hashes in one pass with
        # no per-set bookkeeping at all — the registration hot path
        entries = self._set_entries
        if self._batch_cols is not None or all(e is None for e in entries):
            set_hashes = self._hash_keys(self._part_keys)
            set_shard = (self._hash_keys(self._shard_keys)
                         & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        else:
            need = [i for i, e in enumerate(entries)
                    if e is None or e[2] is None]
            if need:
                phs = self._hash_keys([self._part_keys[i] for i in need])
                shs = (self._hash_keys([self._shard_keys[i] for i in need])
                       & np.uint64(0xFFFFFFFF)).astype(np.uint32)
                for j, i in enumerate(need):
                    e = entries[i]
                    if e is None:
                        entries[i] = [None, None, int(phs[j]), int(shs[j])]
                    else:
                        e[2] = int(phs[j])
                        e[3] = int(shs[j])
            set_hashes = np.fromiter((e[2] for e in entries), np.uint64,
                                     count=len(entries))
            set_shard = np.fromiter((e[3] for e in entries), np.uint32,
                                    count=len(entries))
        ph = set_hashes[pidx] if len(pidx) else np.zeros(0, np.uint64)
        sh = set_shard[pidx] if len(pidx) else np.zeros(0, np.uint32)
        rc = RecordContainer(self.schema, ts, vals, ph, sh, pidx,
                             self._labels, self.bucket_les,
                             self._part_keys, set_hashes,
                             label_columns=self._batch_cols)
        self.reset()
        return rc
