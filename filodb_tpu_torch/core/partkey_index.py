"""Part-key tag index: label filters -> partition ids (the Lucene equivalent).

Reference: core/.../memstore/PartKeyLuceneIndex.scala:34,68 — an MMap Lucene index
of part-key tags with startTime/endTime per partition, regex/prefix filters, top-k
label values, and partIdsEndedBefore for purge.

TPU-native design: the index is host-side (tag matching has no device analog) and
must not bottleneck 1M-series workloads (ref bar: PartKeyIndexBenchmark). The
postings plane is the columnar engine of ``index_columnar.py``: per label, a
sorted term dictionary with CSR postings over u64 ``(vid << 32) | pid`` keys,
staged appends batch-folded on first read (the Lucene NRT-refresh analog —
the ingest hot path never pays a rebuild), dense u64-word bitmaps for
multi-matcher set algebra, and a trigram pre-filter so regex matchers compile
once and confirm only the terms that carry the pattern's mandatory literals.

Label storage is dictionary-encoded (ref: DictUTF8Vector/UTF8Vector,
memory/.../format/vectors/DictUTF8Vector.scala): each distinct label name and
value string is stored once in a pool, and a partition's labels are (name_id,
value_id) u32 pairs in a shared arena — ~16 bytes per label versus a per-series
Python dict, the difference between ~40MB and >400MB of index at 1M series.
Start/end times live in growable int64 numpy arrays so time-range masking in
queries is a zero-copy slice, not a 1M-element list conversion.
"""

from __future__ import annotations

from array import array
from collections import Counter

import numpy as np

from .filters import Equals, EqualsRegex, Filter, In, NotEquals, NotEqualsRegex
from .index_columnar import LabelPostings, SelectionBitmap, TrigramIndex

_EMPTY = np.empty(0, dtype=np.int32)


def _intersect_sorted(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Intersection of two SORTED-unique id arrays. Large pairs run the
    native galloping merge (numpy's searchsorted costs ~250us for 10k x 10k —
    the whole regex-lookup budget); small pairs stay in numpy."""
    if len(a) > len(b):
        a, b = b, a
    if len(a) == 0:
        return a
    if len(a) + len(b) >= 2048:
        from . import native
        r = native.sorted_intersect(a, b)
        if r is not None:
            return r
    pos = np.searchsorted(b, a)
    ok = pos < len(b)
    ok[ok] = b[pos[ok]] == a[ok]
    return a[ok]


class _I64Vec:
    """Growable int64 column with zero-copy numpy views."""

    __slots__ = ("_buf", "n")

    def __init__(self):
        self._buf = np.empty(64, np.int64)
        self.n = 0

    def append(self, v: int) -> None:
        if self.n == len(self._buf):
            grown = np.empty(2 * len(self._buf), np.int64)
            grown[: self.n] = self._buf
            self._buf = grown
        self._buf[self.n] = v
        self.n += 1

    def extend(self, arr: np.ndarray) -> None:
        need = self.n + len(arr)
        if need > len(self._buf):
            cap = len(self._buf)
            while cap < need:
                cap *= 2
            grown = np.empty(cap, np.int64)
            grown[: self.n] = self._buf[: self.n]
            self._buf = grown
        self._buf[self.n:need] = arr
        self.n = need

    def view(self) -> np.ndarray:
        return self._buf[: self.n]

    def __getitem__(self, i: int) -> int:
        return int(self._buf[i])

    def __setitem__(self, i: int, v: int) -> None:
        self._buf[i] = v


class PartKeyIndex:
    """Inverted index over one shard's partitions."""

    # bitmap algebra engages when the smallest positive union is DENSE —
    # at least this many ids AND at least 1/8 of the pid space. Sparse
    # selections stay on the galloping searchsorted intersect (measured:
    # at 100k series a 10k x 100k galloping AND runs ~4x faster than the
    # scatter/packbits round-trip, while word-parallel AND/ANDNOT wins
    # once every operand covers most of the space)
    BITMAP_MIN_UNION = 4096

    def __init__(self):
        # dictionary encoding pools (ref: DictUTF8Vector)
        self._name_id: dict[str, int] = {}
        self._name_pool: list[str] = []
        self._val_pool: list[list[str]] = []   # name_id -> vid -> value str
        # value -> vid survives postings removal so churned values re-intern
        # under their original vid (no duplicate pool entries under churn)
        self._vid_of: list[dict[str, int]] = []
        # the columnar postings plane: name_id -> LabelPostings (CSR over
        # (vid << 32) | pid keys with staged batch-fold; index_columnar.py)
        self._cols: list[LabelPostings] = []
        self._tri: list[TrigramIndex | None] = []   # lazy regex pre-filters
        self._dead_pairs = 0                   # arena pairs orphaned by purge
        # per-partition label pairs in one shared arena of u32
        self._arena = array("I")
        self._off: array = array("Q")          # part_id -> arena offset (pairs)
        self._cnt: array = array("I")          # part_id -> number of labels
        self._start = _I64Vec()                # part_id -> first sample ts (ms)
        self._end = _I64Vec()                  # part_id -> last ts / MAX while live
        # scalar aggregates for the wide-query fast path: when no entry has
        # ever ended and max(start) <= query end, the per-entry time filter
        # (two O(S) gathers per query) is provably a no-op
        self._max_start = -(1 << 62)
        self._num_ended = 0
        # regex fast path (ref: PartKeyLuceneIndex automata over TERMS, :34):
        # matchers evaluate against each label's DISTINCT value pool, never
        # per series. The trigram pre-filter narrows to terms carrying the
        # pattern's mandatory literals; patterns with no extractable literal
        # scan the pool as one newline-joined blob with a single compiled
        # (?m)^(...)$ pass (C-speed). Matches are cached per (label,
        # pattern) keyed by the pool version — pools only grow on NEW
        # distinct values, so dashboards re-running the same matcher hit
        # the cache even while postings churn.
        self._pool_version: list[int] = []     # name_id -> bumped per new value
        self._pool_blob: dict[int, tuple[int, str, np.ndarray, bool]] = {}
        self._regex_cache: dict[tuple[str, str], tuple[int, np.ndarray]] = {}
        # name_id -> bumped whenever any posting of that label changes; keys
        # the cached regex UNION (the matcher's expanded pid set)
        self._postings_epoch: list[int] = []
        self._regex_union_cache: dict[tuple[str, str],
                                      tuple[int, int, np.ndarray]] = {}
        # whole-filter-set result cache (the Lucene QueryCache analog:
        # dashboards re-issue identical filter sets every refresh). Keyed by
        # the filter tuple, validated against a global index epoch that bumps
        # on ANY postings mutation; the cached array is the PRE-time-filter
        # intersection, so changing query windows still hit
        self._epoch = 0
        self._filter_cache: dict[tuple, tuple[int, np.ndarray]] = {}
        # registration hot path: raw pair bytes (b"name\x01value") -> its
        # (nid, vid) identity, so the bulk add does ONE dict probe per label
        # pair instead of two nested gets + string decodes. (nid, vid) stays
        # a valid identity across removal — vids survive churn — and the
        # cache only clears wholesale when compaction renumbers vids.
        self._pair_cache: dict[bytes, tuple[int, int]] = {}

    LIVE_END = np.iinfo(np.int64).max

    def __len__(self) -> int:
        return len(self._off)

    def _intern_name(self, name: str) -> int:
        nid = self._name_id.get(name)
        if nid is None:
            nid = self._name_id[name] = len(self._name_pool)
            self._name_pool.append(name)
            self._val_pool.append([])
            self._vid_of.append({})
            self._cols.append(LabelPostings())
            self._tri.append(None)
            self._pool_version.append(0)
            self._postings_epoch.append(0)
        return nid

    def _intern(self, name: str, value: str) -> tuple[int, int]:
        nid = self._intern_name(name)
        vid = self._vid_of[nid].get(value)
        if vid is None:
            pool = self._val_pool[nid]
            vid = self._vid_of[nid][value] = len(pool)
            pool.append(value)
            self._pool_version[nid] += 1
        return nid, vid

    def _bulk_preamble(self, part_ids: np.ndarray, n: int,
                       start_time: int) -> np.ndarray | None:
        """Shared dense-append validation for the bulk add paths; returns the
        pid array (None => caller must fall back to per-key adds). Bumps the
        epoch/max-start bookkeeping on success."""
        pids = np.asarray(part_ids, np.int64)
        if (int(pids[0]) != len(self._off)
                or (n > 1 and not (np.diff(pids) == 1).all())):
            return None
        self._epoch += 1
        if start_time > self._max_start:
            self._max_start = start_time
        return pids

    def _bulk_columns_commit(self, n: int, L: int, nid_row, vid_mat,
                             start_time, starts: np.ndarray | None) -> None:
        """Append arena/offset/time columns for ``n`` keys of ``L`` labels
        each, from per-label nid/vid columns — pure numpy, no per-key work.
        ``starts`` (per-key first-sample times) overrides the scalar
        ``start_time`` — the columnar recovery path carries real ones."""
        base_off = len(self._arena) // 2
        arena_mat = np.empty((n, L, 2), np.uint32)
        arena_mat[:, :, 0] = nid_row
        arena_mat[:, :, 1] = vid_mat
        self._arena.frombytes(arena_mat.tobytes())
        offs = base_off + L * np.arange(n, dtype=np.uint64)
        self._off.frombytes(offs.tobytes())
        self._cnt.frombytes(np.full(n, L, np.uint32).tobytes())
        self._start.extend(starts if starts is not None
                           else np.full(n, start_time, np.int64))
        self._end.extend(np.full(n, self.LIVE_END, np.int64))

    def add_part_keys_columnar(self, part_ids: np.ndarray, fixed: dict,
                               vary: list[str], cols: list,
                               start_time: int) -> bool:
        """Columnar bulk add: label values arrive as per-name COLUMNS (the
        builder's add_series_batch shape), so interning needs one dict probe
        per value — no pair-bytes building or parsing at all — the label
        arena assembles as one [n, L, 2] numpy write, and postings stage as
        whole array segments (one ``add_bulk`` per column) folded into the
        columnar structure on first read. The fastest registration path
        (ref: PartKeyLuceneIndex.addPartKey bulk ingest, jmh
        PartKeyIndexBenchmark is the bar); per-key equivalent to
        add_part_key. Dense pid appends only — returns False untouched
        otherwise."""
        n = len(part_ids)
        if n == 0:
            return True
        L = len(fixed) + len(vary)
        if L == 0 or any(len(c) != n for c in cols):
            return False
        pids = self._bulk_preamble(part_ids, n, start_time)
        if pids is None:
            return False
        pid_arr = pids
        nid_row = np.empty(L, np.uint32)
        vid_mat = np.empty((n, L), np.uint32)
        touched: list[int] = []
        ci = 0
        for name, value in fixed.items():
            nid, vid = self._intern(name, value)
            self._cols[nid].add_run(vid, pid_arr)
            nid_row[ci] = nid
            vid_mat[:, ci] = vid
            touched.append(nid)
            ci += 1
        for name, col in zip(vary, cols):
            nid = self._intern_name(name)
            vd = self._vid_of[nid]
            pool = self._val_pool[nid]
            # all-new-distinct subpath (the registration shape: every series
            # brings a fresh value): dedup + overlap checks are C-speed set
            # ops, pools/vid maps extend in bulk, and the postings stage as
            # ONE contiguous (vids, pids) segment
            dedup = dict.fromkeys(col)
            if len(dedup) == n and not (dedup.keys() & vd.keys()):
                base_vid = len(pool)
                pool.extend(col)
                vd.update(zip(col, range(base_vid, base_vid + n)))
                self._pool_version[nid] += n
                vids_col = np.arange(base_vid, base_vid + n, dtype=np.uint32)
                self._cols[nid].add_bulk(vids_col, pid_arr)
                vid_mat[:, ci] = vids_col
            else:
                get = vd.get
                vids: list[int] = []
                vap = vids.append
                new_pool = 0
                for v in col:
                    vid = get(v)
                    if vid is None:
                        vid = vd[v] = len(pool)
                        pool.append(v)
                        new_pool += 1
                    vap(vid)
                if new_pool:
                    self._pool_version[nid] += new_pool
                vids_col = np.asarray(vids, np.uint32)
                self._cols[nid].add_bulk(vids_col, pid_arr)
                vid_mat[:, ci] = vids_col
            nid_row[ci] = nid
            touched.append(nid)
            ci += 1
        for nid in touched:
            self._postings_epoch[nid] += 1
        self._bulk_columns_commit(n, L, nid_row, vid_mat, start_time, None)
        return True

    def add_part_keys_bulk(self, part_ids: np.ndarray, keys: list[bytes],
                           start_time: int,
                           counts_hint: np.ndarray | None = None,
                           start_times: np.ndarray | None = None) -> bool:
        """Vectorized add of many NEW part keys parsed straight from the
        canonical key bytes (``name\\x01value`` pairs joined by ``\\x00`` —
        schemas.part_key_bytes; the v3 container wire already carries them).

        The 1M-series registration hot path (ref: PartKeyLuceneIndex.addPartKey
        consuming BinaryRecord key regions, TimeSeriesShard.scala:1183): ONE
        C-speed split over the whole batch, one dict probe per label pair
        (keyed by the raw pair bytes — string decode and pool interning only
        per DISTINCT pair), arena/offset/time columns extended in bulk.

        Handles only densely appended part ids with non-empty keys; returns
        False (with NO state mutated) so the caller falls back to per-key
        ``add_part_key`` otherwise. ``counts_hint`` (labels per key, from the
        caller's label dicts) guards against values containing the separator
        byte — a mismatch rejects the batch before any mutation.
        ``start_times`` carries per-key first-sample times (the columnar
        recovery path); the scalar ``start_time`` covers registration."""
        n = len(keys)
        if n == 0:
            return True
        counts = np.fromiter((k.count(b"\x00") for k in keys), np.int64,
                             count=n) + 1
        if counts_hint is not None and not np.array_equal(counts, counts_hint):
            return False
        if min(len(k) for k in keys) == 0:
            return False                       # label-less key: per-key path
        eff_start = (int(start_times.max()) if start_times is not None
                     and len(start_times) else start_time)
        pids = self._bulk_preamble(part_ids, n, eff_start)
        if pids is None:
            return False
        pairs = b"\x00".join(keys).split(b"\x00")
        cache = self._pair_cache
        arena_ext = array("I")
        ap = arena_ext.append
        touched: dict[int, tuple[list, list]] = {}
        for pair, pid in zip(pairs, np.repeat(pids, counts).tolist()):
            ident = cache.get(pair)
            if ident is None:
                nm, _, val = pair.partition(b"\x01")
                ident = cache[pair] = self._intern(nm.decode(), val.decode())
            nid, vid = ident
            ap(nid)
            ap(vid)
            stage = touched.get(nid)
            if stage is None:
                stage = touched[nid] = ([], [])
            stage[0].append(vid)
            stage[1].append(pid)
        for nid, (svids, spids) in touched.items():
            self._cols[nid].add_bulk(np.asarray(svids, np.uint32),
                                     np.asarray(spids, np.int64))
            self._postings_epoch[nid] += 1
        if len(cache) > (1 << 22):
            # backstop: the cache re-warms from _intern; unbounded growth on
            # never-compacting all-distinct workloads must not
            self._pair_cache = {}
        base_off = len(self._arena) // 2
        self._arena.extend(arena_ext)
        offs = base_off + np.concatenate(([0], np.cumsum(counts[:-1])))
        self._off.frombytes(offs.astype(np.uint64).tobytes())
        self._cnt.frombytes(counts.astype(np.uint32).tobytes())
        self._start.extend(np.asarray(start_times, np.int64)
                           if start_times is not None
                           else np.full(n, start_time, np.int64))
        self._end.extend(np.full(n, self.LIVE_END, np.int64))
        return True

    def add_part_key(self, part_id: int, labels: dict[str, str], start_time: int,
                     end_time: int = LIVE_END) -> None:
        self._epoch += 1                 # invalidate cached filter results
        if start_time > self._max_start:
            self._max_start = start_time
        if part_id < len(self._off) and self._end[part_id] != self.LIVE_END:
            self._num_ended -= 1   # slot reuse: its tombstone leaves the count
        if end_time != self.LIVE_END:
            self._num_ended += 1
        if part_id == len(self._off):
            self._off.append(len(self._arena) // 2)
            self._cnt.append(len(labels))
            self._start.append(start_time)
            self._end.append(end_time)
        else:
            # reuse of a purged slot (ref: TimeSeriesShard partId free list);
            # new pairs append to the arena, the old region is dead space until
            # the dead ratio triggers compaction (see maybe_compact_arena)
            assert part_id < len(self._off) and self._cnt[part_id] == 0, \
                "part ids must be assigned densely or reuse a purged slot"
            self._off[part_id] = len(self._arena) // 2
            self._cnt[part_id] = len(labels)
            self._start[part_id] = start_time
            self._end[part_id] = end_time
        # hot loop (1M-series registration is bound here): the common case is
        # two dict hits resolving (nid, vid) and three O(1) appends per label
        # — the staged postings fold in batch on the first read
        # (ref bar: PartKeyIndexBenchmark add rate)
        arena = self._arena
        pe = self._postings_epoch
        name_id = self._name_id
        for name, value in labels.items():
            nid = name_id.get(name)
            vid = self._vid_of[nid].get(value) if nid is not None else None
            if vid is None:
                nid, vid = self._intern(name, value)
            arena.append(nid)
            arena.append(vid)
            self._cols[nid].add(vid, part_id)
            pe[nid] += 1

    def update_end_time(self, part_id: int, end_time: int) -> None:
        was_live = self._end[part_id] == self.LIVE_END
        if was_live != (end_time == self.LIVE_END):
            self._num_ended += 1 if was_live else -1
        self._end[part_id] = end_time

    def start_time(self, part_id: int) -> int:
        return self._start[part_id]

    def end_time(self, part_id: int) -> int:
        return self._end[part_id]

    def is_live(self, part_id: int) -> bool:
        """O(1) liveness check (a purged slot has no labels)."""
        return self._cnt[part_id] > 0

    def labels_of(self, part_id: int) -> dict[str, str]:
        o = self._off[part_id] * 2
        out = {}
        arena = self._arena
        for i in range(o, o + 2 * self._cnt[part_id], 2):
            nid = arena[i]
            out[self._name_pool[nid]] = self._val_pool[nid][arena[i + 1]]
        return out

    def arena_bytes(self) -> int:
        """Approximate index label-storage footprint (for stats/benchmarks)."""
        pools = sum(len(s) for s in self._name_pool)
        pools += sum(len(v) for pool in self._val_pool for v in pool)
        return (self._arena.itemsize * len(self._arena)
                + self._off.itemsize * len(self._off)
                + self._cnt.itemsize * len(self._cnt)
                + 16 * self._start.n + pools)

    def postings_bytes(self) -> int:
        """Columnar postings footprint (CSR keys + staged overlays)."""
        return sum(c.nbytes() for c in self._cols)

    # ---- queries ----------------------------------------------------------

    def _filter_union(self, f: Filter) -> np.ndarray:
        """SORTED-unique pids whose label value satisfies the (positive)
        filter — slices/gathers off the columnar structure, never a
        per-value dict walk."""
        nid = self._name_id.get(f.label)
        if nid is None:
            return _EMPTY
        col = self._cols[nid]
        if isinstance(f, Equals):
            vid = self._vid_of[nid].get(f.value)
            return col.ids_of(vid) if vid is not None else _EMPTY
        if isinstance(f, In):
            vd = self._vid_of[nid]
            # dedup: a repeated In value must not duplicate its postings
            # (downstream set algebra assumes unique ids)
            vids = list(dict.fromkeys(vd[v] for v in f.values if v in vd))
            if not vids:
                return _EMPTY
            u = col.gather(col.term_indices(np.asarray(vids, np.int64)))
            return np.sort(u)
        if isinstance(f, (EqualsRegex, NotEqualsRegex)):
            # applied per distinct value; NotEqualsRegex handled by caller
            # via complement. The expanded union is cached until the label's
            # pool or postings change (stable between series churn events)
            ckey = (f.label, f.pattern)
            cur = (self._pool_version[nid], self._postings_epoch[nid])
            hit = self._regex_union_cache.get(ckey)
            if hit is not None and hit[:2] == cur:
                return hit[2]
            vids = self._regex_vids(f.label, f.pattern)
            u = np.sort(col.gather(col.term_indices(vids)))
            if len(self._regex_union_cache) > 1024:
                self._regex_union_cache.clear()
            self._regex_union_cache[ckey] = cur + (u,)
            return u
        if isinstance(f, NotEquals):
            # every pid carrying the label, minus the one excluded term
            vid = self._vid_of[nid].get(f.value)
            everyone = col.all_ids()
            if vid is None:
                return everyone
            return np.setdiff1d(everyone, col.ids_of(vid), assume_unique=True)
        raise TypeError(f)  # pragma: no cover

    def _regex_vids(self, label: str, pattern: str) -> np.ndarray:
        """Distinct pool vids whose value fullmatches ``pattern``: trigram
        pre-filter (mandatory literals -> candidate terms) then ONE compiled
        confirm over the survivors; patterns with no extractable literal
        scan the whole pool via the multiline blob. Cached per (label,
        pattern) until a NEW distinct value extends the pool."""
        import re
        nid = self._name_id.get(label)
        if nid is None:
            return _EMPTY
        version = self._pool_version[nid]
        key = (label, pattern)
        hit = self._regex_cache.get(key)
        if hit is not None and hit[0] == version:
            return hit[1]
        pool = self._val_pool[nid]
        tri = self._tri[nid]
        if tri is None:
            tri = self._tri[nid] = TrigramIndex()
        cand = tri.candidates(pattern, pool)
        if cand is not None:
            try:
                pat = re.compile(pattern)
            except re.error:
                matched = _EMPTY
            else:
                fm = pat.fullmatch
                matched = np.asarray(
                    [int(v) for v in cand.tolist() if fm(pool[int(v)])],
                    np.int64)
        else:
            values = self._regex_values_scan(nid, pattern)
            vd = self._vid_of[nid]
            matched = np.asarray([vd[v] for v in values], np.int64)
        if len(self._regex_cache) > 4096:
            self._regex_cache.clear()
        self._regex_cache[key] = (version, matched)
        return matched

    def _regex_values_scan(self, nid: int, pattern: str) -> list[str]:
        """Full-pool regex scan (no usable trigrams): one compiled multiline
        pass over the newline-joined pool blob, falling back to per-value
        fullmatch for newline-y pools or cross-line-capable patterns."""
        import re
        pool = self._val_pool[nid]
        version = self._pool_version[nid]
        blob = self._pool_blob.get(nid)
        if blob is None or blob[0] != version:
            text = "\n".join(pool)
            starts = np.zeros(len(pool), np.int64)
            lens = np.fromiter((len(v) for v in pool), np.int64,
                               count=len(pool))
            if len(pool) > 1:
                np.cumsum(lens[:-1] + 1, out=starts[1:])
            multiline_safe = not any("\n" in v for v in pool)
            blob = (version, text, starts, multiline_safe)
            self._pool_blob[nid] = blob
        _v, text, starts, safe = blob
        matched = None
        if safe:
            try:
                pat = re.compile(r"(?m)^(?:%s)$" % pattern)
            except re.error:
                # e.g. a global inline flag "(?i)..." cannot be embedded
                # mid-expression: per-value fullmatch still supports it
                pat = None
                safe = False
        if safe:
            out: list[str] | None = []
            for m in pat.finditer(text):
                i = int(np.searchsorted(starts, m.start()))
                # a pattern atom that can consume '\n' (e.g. \s*) could span
                # pool lines — any span that isn't exactly one whole value
                # disqualifies the scan for this pattern
                if (i >= len(pool) or starts[i] != m.start()
                        or m.end() - m.start() != len(pool[i])):
                    out = None
                    break
                out.append(pool[i])
            matched = out
        if matched is None:   # newline-y pool or cross-line-capable pattern
            pat = re.compile(pattern)
            matched = [v for v in pool if pat.fullmatch(v)]
        return matched

    def part_ids_from_filters(self, filters: list[Filter], start_time: int,
                              end_time: int, limit: int | None = None) -> np.ndarray:
        """Part ids matching all filters and alive in [start_time, end_time]."""
        ckey = tuple(filters)
        hit = self._filter_cache.get(ckey)
        if hit is not None and hit[0] == self._epoch:
            result = hit[1]
        else:
            result = self._eval_filters(filters)
            if len(self._filter_cache) > 512:
                self._filter_cache.clear()
            self._filter_cache[ckey] = (self._epoch, result)
        if len(result) and not (self._num_ended == 0
                                and self._max_start <= end_time):
            starts = self._start.view()[result]
            ends = self._end.view()[result]
            result = result[(starts <= end_time) & (ends >= start_time)]
        if limit is not None:
            result = result[:limit]
        return result.astype(np.int32)

    def _eval_filters(self, filters: list[Filter]) -> np.ndarray:
        """Postings set algebra for a filter set (no time masking — results
        are cached across query windows by part_ids_from_filters). Small
        equals-chains intersect by galloping binary search; anything with
        large unions runs dense u64 bitmap AND/ANDNOT over the pid space —
        the columnar multi-matcher plane."""
        negations: list[Filter] = []
        pos: list[np.ndarray] = []
        for f in filters:
            if isinstance(f, (NotEquals, NotEqualsRegex)):
                negations.append(f)
                continue
            p = self._filter_union(f)
            if len(p) == 0:
                return _EMPTY
            pos.append(p)
        neg_unions = [self._filter_union(
            Equals(f.label, f.value) if isinstance(f, NotEquals)
            else EqualsRegex(f.label, f.pattern)) for f in negations]
        S = len(self._off)
        if pos:
            pos.sort(key=len)
            if len(pos) > 1 and \
                    len(pos[0]) >= max(S >> 3, self.BITMAP_MIN_UNION):
                bm = SelectionBitmap.from_ids(pos[0], S)
                for p in pos[1:]:
                    bm.iand_ids(p)
                for neg in neg_unions:
                    if len(neg):
                        bm.iandnot_ids(neg)
                return bm.to_ids()
            result = pos[0]
            for p in pos[1:]:
                result = _intersect_sorted(result, p)
                if len(result) == 0:
                    return _EMPTY
        else:
            result = np.arange(S, dtype=np.int32)
        for neg in neg_unions:
            # series *lacking* the label entirely also match a negative filter
            result = np.setdiff1d(result, neg, assume_unique=True)
        return result

    def part_ids_ended_before(self, ts: int) -> np.ndarray:
        """For purge (ref: PartKeyLuceneIndex.partIdsEndedBefore)."""
        ends = self._end.view()
        live = np.frombuffer(self._cnt, np.uint32, count=len(self._cnt)) > 0 \
            if len(self._cnt) else np.empty(0, bool)
        return np.nonzero((ends < ts) & live)[0].astype(np.int32)

    def remove_part_keys(self, part_ids: np.ndarray) -> None:
        """Tombstone purged partitions and drop them from every posting list
        (ref: PartKeyLuceneIndex.removePartKeys). Slots become reusable via
        ``add_part_key`` with the same id."""
        if len(part_ids) == 0:
            return
        self._epoch += 1                 # invalidate cached filter results
        removed = np.asarray(part_ids, np.int32)
        arena = self._arena
        touched: set[int] = set()
        for pid in removed.tolist():
            o = self._off[pid] * 2
            for i in range(o, o + 2 * self._cnt[pid], 2):
                touched.add(arena[i])
            self._dead_pairs += self._cnt[pid]
            self._cnt[pid] = 0
            self._start[pid] = 0
            if self._end[pid] == self.LIVE_END:
                self._num_ended += 1     # disables the all-live fast path
            self._end[pid] = -1          # matches no [start, end] overlap query
        for nid in touched:
            self._cols[nid].remove(removed)
            self._postings_epoch[nid] += 1   # invalidate cached unions
        self.maybe_compact_arena()

    def maybe_compact_arena(self, min_dead_ratio: float = 0.5) -> bool:
        """Rebuild the label arena AND the value pools from live partitions when
        purge churn has orphaned more than ``min_dead_ratio`` of the arena (the
        Lucene analog is segment merging reclaiming deleted docs). Value strings
        with no live postings are dropped from the pools, so unique-value churn
        (e.g. a new pod name per deploy) stays bounded by *live* cardinality.
        Offsets and vids both move. Returns True if a compaction ran."""
        total = len(self._arena) // 2
        if self._dead_pairs == 0 or self._dead_pairs <= total * min_dead_ratio:
            return False
        # re-pool: keep only values that still have live postings (the term
        # index prunes emptied terms on remove, so a column's term vids ARE
        # the live set); vids renumber densely
        vid_maps: list[np.ndarray] = []
        for nid in range(len(self._name_pool)):
            col = self._cols[nid]
            live_vids = col.term_vids().astype(np.int64)
            vid_map = np.full(len(self._val_pool[nid]), -1, np.int64)
            vid_map[live_vids] = np.arange(len(live_vids))
            old_pool = self._val_pool[nid]
            new_pool = [old_pool[int(v)] for v in live_vids]
            self._val_pool[nid] = new_pool
            self._vid_of[nid] = {v: i for i, v in enumerate(new_pool)}
            col.remap_vids(vid_map)
            vid_maps.append(vid_map)
        fresh = array("I")
        arena = self._arena
        for pid in range(len(self._off)):
            c = self._cnt[pid]
            if c == 0:
                continue
            o = self._off[pid] * 2
            self._off[pid] = len(fresh) // 2
            for i in range(o, o + 2 * c, 2):
                fresh.append(arena[i])
                fresh.append(int(vid_maps[arena[i]][arena[i + 1]]))
        self._arena = fresh
        self._dead_pairs = 0
        # vids renumbered: every cached identity/blob/match/union is stale
        # (decoding a stale blob's line offsets against the new pool would
        # return the WRONG values' postings)
        self._pair_cache = {}
        for nid in range(len(self._pool_version)):
            self._pool_version[nid] += 1
            self._postings_epoch[nid] += 1
            self._tri[nid] = None       # rebuilt lazily over the new pool
        self._pool_blob.clear()
        self._regex_cache.clear()
        self._regex_union_cache.clear()
        return True

    def _label_value_counter(self, label: str, filters, start_time,
                             end_time) -> Counter:
        nid = self._name_id.get(label)
        if nid is None:
            return Counter()
        col = self._cols[nid]
        term_vids, counts = col.counts()
        if not len(term_vids):
            return Counter()
        if filters:
            matching = self.part_ids_from_filters(filters, start_time,
                                                  end_time)
            counts = col.counts_within(matching, len(self._off))
        pool = self._val_pool[nid]
        live = counts > 0
        return Counter({pool[int(v)]: int(c)
                        for v, c in zip(term_vids[live].tolist(),
                                        counts[live].tolist())})

    def label_values(self, label: str, filters: list[Filter] | None = None,
                     start_time: int = 0, end_time: int = 1 << 62,
                     top_k: int | None = None) -> list[str]:
        """Distinct values of ``label``; top-k by series count when requested
        (ref: PartKeyLuceneIndex indexValues top-k terms). Counts read
        straight off the columnar structure — CSR offset diffs unfiltered,
        posting-bitmap popcounts / one membership pass filtered — never a
        per-value series scan."""
        counts = self._label_value_counter(label, filters, start_time, end_time)
        if top_k is not None:
            return [v for v, _ in counts.most_common(top_k)]
        return sorted(counts)

    def label_value_counts(self, label: str,
                           filters: list[Filter] | None = None,
                           start_time: int = 0, end_time: int = 1 << 62,
                           top_k: int | None = None) -> list[tuple[str, int]]:
        """(value, series_count) pairs — the cross-node top-k merge needs the
        counts, not just each node's ranked list (a value barely in one
        node's local top-k can dominate cluster-wide)."""
        counts = self._label_value_counter(label, filters, start_time, end_time)
        if top_k is not None:
            return counts.most_common(top_k)
        return sorted(counts.items())

    def label_names(self, filters: list[Filter] | None = None,
                    start_time: int = 0, end_time: int = 1 << 62) -> list[str]:
        if not filters:
            return sorted(n for n, nid in self._name_id.items()
                          if self._cols[nid].n_postings > 0)
        matching = self.part_ids_from_filters(filters, start_time, end_time)
        names: set[str] = set()
        for pid in matching.tolist():
            names.update(self.labels_of(pid))
        return sorted(names)
