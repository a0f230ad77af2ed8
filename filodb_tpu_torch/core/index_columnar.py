"""Columnar postings engine for the part-key index (the vectorized plane).

Reference: core/.../memstore/PartKeyLuceneIndex.scala — Lucene keeps, per
label, a sorted term dictionary with per-term posting lists, answers
multi-matcher selects with bitmap set algebra over those postings, and
pre-filters regex matchers with an automaton over TERMS, never per series.
This module is the numpy equivalent, sized for the 1M-series-per-shard bar
(PartKeyIndexBenchmark, SURVEY §6):

  * ``LabelPostings`` — ONE label's postings as a sorted column of u64 keys
    ``(vid << 32) | pid`` with a derived CSR term index (sorted term vids +
    offsets). Appends stage into O(1) host buffers and ``fold()`` merges them
    with ONE vectorized two-way merge — the ingest hot path never pays a
    full rebuild, readers fold on first access (the Lucene NRT-refresh
    analog).
  * ``SelectionBitmap`` — dense u64-word bitmaps over the pid space with
    AND/OR/ANDNOT word algebra and popcounts, the multi-matcher intersection
    plane (125 KB per live bitmap at 1M series; one AND is a ~16k-word op).
  * ``TrigramIndex`` — regex pre-filtering: mandatory literal substrings are
    extracted from the pattern, their byte trigrams intersected over a
    trigram -> term postings structure (a ``LabelPostings`` keyed by trigram
    code), and ONLY the surviving terms are confirmed with the compiled
    regex. A 1M-distinct-value label answers ``=~"checkout-.*"`` by looking
    at the handful of terms containing ``che``/``hec``/... instead of
    running the regex a million times.

CONTRACT (enforced by filolint's ``index-pure-python-postings`` rule over
``core/index*.py`` modules): posting arrays are only ever touched by
vectorized numpy ops — a per-element Python loop over postings in this
module is a tier-1 failure, not a code-review nit.
"""

from __future__ import annotations

import re

import numpy as np

_EMPTY_I32 = np.empty(0, np.int32)
_EMPTY_U32 = np.empty(0, np.uint32)
_EMPTY_U64 = np.empty(0, np.uint64)
_EMPTY_I64 = np.empty(0, np.int64)

_PID_MASK = np.uint64(0xFFFFFFFF)
_SHIFT = np.uint64(32)

# numpy >= 2.0 has a native vectorized popcount; older builds fall back to
# an unpackbits sum (same result, more memory traffic)
_HAS_BITWISE_COUNT = hasattr(np, "bitwise_count")


def popcount(words: np.ndarray) -> int:
    """Total set bits of a u64 word array."""
    if _HAS_BITWISE_COUNT:
        return int(np.bitwise_count(words).sum())
    return int(np.unpackbits(words.view(np.uint8)).sum())


def popcount_rows(mat: np.ndarray) -> np.ndarray:
    """Per-row set-bit counts of a [T, W] u64 matrix (the top-k counting
    path: term-bitmap AND selection-bitmap, counted without expansion)."""
    if _HAS_BITWISE_COUNT:
        return np.bitwise_count(mat).sum(axis=1).astype(np.int64)
    rows = np.unpackbits(mat.view(np.uint8).reshape(mat.shape[0], -1), axis=1)
    return rows.sum(axis=1).astype(np.int64)


class SelectionBitmap:
    """Dense bitmap over ``[0, nbits)`` stored as little-endian u64 words."""

    __slots__ = ("words", "nbits")

    def __init__(self, words: np.ndarray, nbits: int):
        self.words = words
        self.nbits = int(nbits)

    @classmethod
    def from_ids(cls, ids: np.ndarray, nbits: int) -> "SelectionBitmap":
        nw = (int(nbits) + 63) // 64
        bits = np.zeros(int(nbits), bool)
        if len(ids):
            bits[ids] = True
        packed = np.packbits(bits, bitorder="little")
        buf = np.zeros(nw * 8, np.uint8)
        buf[: len(packed)] = packed
        return cls(buf.view(np.uint64), nbits)

    def iand_ids(self, ids: np.ndarray) -> "SelectionBitmap":
        self.words &= SelectionBitmap.from_ids(ids, self.nbits).words
        return self

    def iandnot_ids(self, ids: np.ndarray) -> "SelectionBitmap":
        self.words &= ~SelectionBitmap.from_ids(ids, self.nbits).words
        return self

    def ior_ids(self, ids: np.ndarray) -> "SelectionBitmap":
        self.words |= SelectionBitmap.from_ids(ids, self.nbits).words
        return self

    def to_ids(self) -> np.ndarray:
        """Sorted int32 member ids."""
        bits = np.unpackbits(self.words.view(np.uint8),
                             bitorder="little")[: self.nbits]
        return np.flatnonzero(bits).astype(np.int32)

    def count(self) -> int:
        return popcount(self.words)


def _merge_sorted_u64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """One-pass vectorized merge of two SORTED u64 arrays, deduped."""
    if not len(a):
        merged = b
    elif not len(b):
        merged = a
    else:
        at = np.searchsorted(a, b, side="left")
        out = np.empty(len(a) + len(b), np.uint64)
        b_pos = at + np.arange(len(b), dtype=np.int64)
        keep_a = np.ones(len(out), bool)
        keep_a[b_pos] = False
        out[b_pos] = b
        out[keep_a] = a
        merged = out
    if len(merged) > 1:
        distinct = np.empty(len(merged), bool)
        distinct[0] = True
        np.not_equal(merged[1:], merged[:-1], out=distinct[1:])
        if not distinct.all():
            merged = merged[distinct]
    return merged


class LabelPostings:
    """One label's postings: committed sorted u64 keys + a staged overlay."""

    __slots__ = ("_postings", "_pid_col", "_term_vids", "_term_offs",
                 "_seg_v", "_seg_p", "_cur_v", "_cur_p", "_staged_n")

    def __init__(self):
        self._postings = _EMPTY_U64          # sorted (vid << 32) | pid
        self._pid_col = _EMPTY_I32           # pid column (zero-copy slices)
        self._term_vids = _EMPTY_U32         # sorted distinct vids
        self._term_offs = np.zeros(1, np.int64)
        self._seg_v: list = []               # staged bulk segments (arrays)
        self._seg_p: list = []
        self._cur_v: list = []               # staged per-key appends (O(1))
        self._cur_p: list = []
        self._staged_n = 0

    # -- appends (the ingest hot path: O(1) per pair, no numpy) --------------

    def add(self, vid: int, pid: int) -> None:
        self._cur_v.append(vid)
        self._cur_p.append(pid)
        self._staged_n += 1

    def add_bulk(self, vids: np.ndarray, pids: np.ndarray) -> None:
        self._seg_v.append(vids)
        self._seg_p.append(pids)
        self._staged_n += len(pids)

    def add_run(self, vid: int, pids: np.ndarray) -> None:
        """One term, many members (the fixed-label columnar add shape)."""
        self._seg_v.append(np.full(len(pids), vid, np.uint32))
        self._seg_p.append(pids)
        self._staged_n += len(pids)

    @property
    def n_postings(self) -> int:
        return len(self._postings) + self._staged_n

    def nbytes(self) -> int:
        return (self._postings.nbytes + self._pid_col.nbytes
                + self._term_vids.nbytes
                + self._term_offs.nbytes + 16 * self._staged_n)

    # -- fold (batch merge of the staged overlay) ----------------------------

    def fold(self) -> bool:
        """Merge staged appends into the committed column: ONE vectorized
        two-way merge, never a per-element rebuild. Returns True if anything
        folded (readers call this before every access; a quiesced label is a
        no-op flag check)."""
        if not self._staged_n:
            return False
        segs = self._seg_v
        segs_p = self._seg_p
        if self._cur_v:
            segs = segs + [np.asarray(self._cur_v, np.uint32)]
            segs_p = segs_p + [np.asarray(self._cur_p, np.int64)]
        sv = (segs[0].astype(np.uint64) if len(segs) == 1
              else np.concatenate([s.astype(np.uint64) for s in segs]))
        sp = (segs_p[0].astype(np.uint64) if len(segs_p) == 1
              else np.concatenate([s.astype(np.uint64) for s in segs_p]))
        staged = (sv << _SHIFT) | sp
        if len(staged) > 1 and not (staged[1:] > staged[:-1]).all():
            # registration appends are presorted by construction (ascending
            # vids x ascending pids); slot reuse / interleaved tenants sort
            staged = np.unique(staged)
        self._seg_v, self._seg_p = [], []
        self._cur_v, self._cur_p = [], []
        self._staged_n = 0
        self._postings = _merge_sorted_u64(self._postings, staged)
        self._reindex()
        return True

    def _reindex(self) -> None:
        # the pid column is derived ONCE per structural change so every
        # per-term read is a zero-copy slice (equals selects at 1M series
        # must not pay an O(total) mask-and-cast per query)
        self._pid_col = (self._postings & _PID_MASK).astype(np.int32)
        vids = (self._postings >> _SHIFT).astype(np.uint32)
        if not len(vids):
            self._term_vids = _EMPTY_U32
            self._term_offs = np.zeros(1, np.int64)
            return
        starts = np.concatenate(
            ([0], np.flatnonzero(vids[1:] != vids[:-1]) + 1))
        self._term_vids = vids[starts]
        self._term_offs = np.concatenate(
            (starts, [len(vids)])).astype(np.int64)

    # -- queries (all vectorized — see the module contract) ------------------

    def term_index(self, vid: int) -> int:
        """Committed term position of ``vid`` or -1 (caller folds)."""
        i = int(np.searchsorted(self._term_vids, np.uint32(vid)))
        if i < len(self._term_vids) and int(self._term_vids[i]) == int(vid):
            return i
        return -1

    def term_indices(self, vids: np.ndarray) -> np.ndarray:
        """Term positions of the vids PRESENT in the term index — one
        batched searchsorted, absent vids dropped (caller folds via this)."""
        self.fold()
        v = np.asarray(vids, np.uint32)
        if not len(v) or not len(self._term_vids):
            return _EMPTY_I64
        pos = np.searchsorted(self._term_vids, v)
        ok = pos < len(self._term_vids)
        ok[ok] = self._term_vids[pos[ok]] == v[ok]
        return pos[ok].astype(np.int64)

    def ids_of(self, vid: int) -> np.ndarray:
        """Sorted int32 pids of one term (a zero-copy VIEW — callers read,
        never mutate)."""
        self.fold()
        i = self.term_index(vid)
        if i < 0:
            return _EMPTY_I32
        return self._pid_col[self._term_offs[i]:self._term_offs[i + 1]]

    def term_vids(self) -> np.ndarray:
        self.fold()
        return self._term_vids

    def counts(self) -> tuple[np.ndarray, np.ndarray]:
        """(sorted term vids, per-term posting counts) — O(terms), read
        straight off the CSR offsets (the sub-linear top-k substrate)."""
        self.fold()
        return self._term_vids, np.diff(self._term_offs)

    def gather(self, term_idx: np.ndarray) -> np.ndarray:
        """Union of several terms' pids as int32 (terms of ONE label are
        disjoint, so concatenation IS the union; unsorted across terms).
        The multi-slice gather is one fancy-index — no per-term loop."""
        self.fold()
        ti = np.asarray(term_idx, np.int64)
        if not len(ti):
            return _EMPTY_I32
        offs = self._term_offs
        starts = offs[ti]
        lens = offs[ti + 1] - starts
        total = int(lens.sum())
        if total == 0:
            return _EMPTY_I32
        base = np.cumsum(lens) - lens
        pos = (np.arange(total, dtype=np.int64)
               - np.repeat(base, lens) + np.repeat(starts, lens))
        return self._pid_col[pos]

    def all_ids(self) -> np.ndarray:
        """Sorted int32 pids carrying this label at all (terms disjoint =>
        the pid column is already a set; one sort makes it ordered)."""
        self.fold()
        return np.sort(self._pid_col)

    # budget for the broadcast popcount counting path: [T, W] u64 words
    _POPCOUNT_BYTES = 4 << 20

    def counts_within(self, ids: np.ndarray, nbits: int) -> np.ndarray:
        """Per-term counts restricted to the ``ids`` selection, aligned with
        ``term_vids()``. Low-cardinality labels count via posting-bitmap
        popcounts (term words AND selection words -> ``np.bitwise_count``);
        high-cardinality labels take one membership gather + a cumulative
        sum over the CSR — both O(postings), never O(terms x series)."""
        self.fold()
        n_terms = len(self._term_vids)
        if n_terms == 0:
            return _EMPTY_I64
        pid_col = self._pid_col.astype(np.int64)
        offs = self._term_offs
        n_words = (int(nbits) + 63) // 64
        if n_terms * n_words * 8 <= self._POPCOUNT_BYTES:
            term_rows = np.repeat(np.arange(n_terms, dtype=np.int64),
                                  np.diff(offs))
            words = np.zeros((n_terms, n_words), np.uint64)
            np.bitwise_or.at(
                words, (term_rows, pid_col >> 6),
                np.left_shift(np.uint64(1), (pid_col & 63).astype(np.uint64)))
            sel = SelectionBitmap.from_ids(ids, nbits)
            return popcount_rows(words & sel.words[None, :])
        member = np.zeros(int(nbits), bool)
        if len(ids):
            member[ids] = True
        hit = member[pid_col].astype(np.int64)
        cum = np.concatenate(([0], np.cumsum(hit)))
        return cum[offs[1:]] - cum[offs[:-1]]

    # -- mutation ------------------------------------------------------------

    def remove(self, pids: np.ndarray) -> None:
        """Drop every posting whose pid is in ``pids`` (purge/eviction);
        emptied terms vanish from the term index automatically."""
        self.fold()
        if not len(self._postings):
            return
        keep = ~np.isin(self._pid_col, pids)
        if keep.all():
            return
        self._postings = self._postings[keep]
        self._reindex()

    def remap_vids(self, vid_map: np.ndarray) -> None:
        """Renumber term vids through ``vid_map`` (old vid -> new vid, -1
        drops) — the arena-compaction hook; one gather + one sort."""
        self.fold()
        if not len(self._postings):
            return
        old = (self._postings >> _SHIFT).astype(np.int64)
        new = vid_map[old]
        keys = ((new.astype(np.uint64) << _SHIFT)
                | (self._postings & _PID_MASK))
        keys = np.sort(keys[new >= 0])
        self._postings = keys
        self._reindex()


# ---------------------------------------------------------------------------
# Regex pre-filtering: mandatory-literal trigrams over the term dictionary.
# ---------------------------------------------------------------------------

def _skip_quantifier(pattern: str, i: int) -> int:
    """Index past a quantifier at ``pattern[i]`` (one of ``*?{``), including
    a trailing lazy ``?``; -1 on a malformed ``{...}``."""
    if pattern[i] == "{":
        j = pattern.find("}", i)
        if j < 0:
            return -1
        i = j + 1
    else:
        i += 1
    if i < len(pattern) and pattern[i] == "?":
        i += 1
    return i


def _match_bracket(pattern: str, i: int) -> int:
    """Index of the ``]`` closing the class opened at ``pattern[i]``."""
    j = i + 1
    if j < len(pattern) and pattern[j] == "^":
        j += 1
    if j < len(pattern) and pattern[j] == "]":
        j += 1                       # leading ] is literal
    while j < len(pattern):
        if pattern[j] == "\\":
            j += 2
            continue
        if pattern[j] == "]":
            return j
        j += 1
    return -1


def _match_paren(pattern: str, i: int) -> int:
    """Index of the ``)`` closing the group opened at ``pattern[i]``."""
    depth = 0
    j = i
    while j < len(pattern):
        c = pattern[j]
        if c == "\\":
            j += 2
            continue
        if c == "[":
            j = _match_bracket(pattern, j)
            if j < 0:
                return -1
            j += 1
            continue
        if c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
            if depth == 0:
                return j
        j += 1
    return -1


def mandatory_literals(pattern: str) -> list[str]:
    """Literal substrings EVERY match of ``pattern`` must contain, in a
    conservative dialect: groups, classes, wildcards and quantified atoms
    contribute nothing; top-level alternation, inline flags, lookaround and
    backreferences bail to ``[]`` (no pre-filter — correctness first).
    The extraction must never return a literal some match could lack: the
    trigram pre-filter DROPS terms, and the confirming regex only sees
    survivors."""
    # any "(?..." except plain non-capturing "(?:" may change matching
    # semantics outside its own span (inline flags) — bail outright
    k = pattern.find("(?")
    while k >= 0:
        if not pattern.startswith("(?:", k):
            return []
        k = pattern.find("(?", k + 2)
    out: list[str] = []
    run: list[str] = []

    def flush(drop_last: bool = False) -> None:
        if drop_last and run:
            run.pop()
        if run:
            out.append("".join(run))
        run.clear()

    i, n = 0, len(pattern)
    while i < n:
        c = pattern[i]
        if c == "\\":
            if i + 1 >= n:
                return []
            nxt = pattern[i + 1]
            if nxt.isdigit():
                return []            # backreference: not modeled
            if nxt in "xuUN":
                return []            # numeric/named char escape: the digits
                                     # after it are NOT literal text — bail
            if nxt.isalpha():
                flush()              # class escape (\d \w \s \b ...)
                i += 2
                continue
            run.append(nxt)          # escaped punctuation is a literal
            i += 2
            if i < n and pattern[i] in "*?{":
                flush(drop_last=True)
                i = _skip_quantifier(pattern, i)
                if i < 0:
                    return []
            elif i < n and pattern[i] == "+":
                flush()              # kept: x+ matches at least one x
                i += 1
            continue
        if c == "|":
            return []                # top-level alternation: either side
        if c == ")":
            return []                # unbalanced: bail
        if c == "(":
            j = _match_paren(pattern, i)
            if j < 0:
                return []
            flush()
            i = j + 1
            if i < n and pattern[i] in "*?{":
                i = _skip_quantifier(pattern, i)
                if i < 0:
                    return []
            elif i < n and pattern[i] == "+":
                i += 1
            continue
        if c == "[":
            j = _match_bracket(pattern, i)
            if j < 0:
                return []
            flush()
            i = j + 1
            if i < n and pattern[i] in "*?{":
                i = _skip_quantifier(pattern, i)
                if i < 0:
                    return []
            elif i < n and pattern[i] == "+":
                i += 1
            continue
        if c in "^$":
            flush()
            i += 1
            continue
        if c == ".":
            flush()
            i += 1
            if i < n and pattern[i] in "*?{":
                i = _skip_quantifier(pattern, i)
                if i < 0:
                    return []
            elif i < n and pattern[i] == "+":
                i += 1
            continue
        if c in "*?{":
            flush(drop_last=True)    # the previous atom may repeat or vanish
            i = _skip_quantifier(pattern, i)
            if i < 0:
                return []
            continue
        if c == "+":
            flush()                  # previous atom mandatory, adjacency ends
            i += 1
            continue
        run.append(c)
        i += 1
    flush()
    return [s for s in out if s]


def required_trigram_codes(pattern: str) -> np.ndarray | None:
    """u32 byte-trigram codes every match must contain, or None when the
    pattern yields no usable literals (callers fall back to a full term
    scan)."""
    lits = mandatory_literals(pattern)
    if not lits:
        return None
    codes: set[int] = set()
    for lit in lits:
        b = lit.encode("utf-8")
        for i in range(len(b) - 2):
            codes.add((b[i] << 16) | (b[i + 1] << 8) | b[i + 2])
    if not codes:
        return None
    return np.asarray(sorted(codes), np.uint32)


class TrigramIndex:
    """trigram code -> term vids over one label's value pool, extended
    incrementally as the pool grows (pools only grow; compaction rebuilds
    from scratch via a fresh instance)."""

    __slots__ = ("_post", "_n_indexed", "_unindexed")

    def __init__(self):
        self._post = LabelPostings()         # key = (code << 32) | vid
        self._n_indexed = 0
        # vids whose value could not be trigram-indexed (NUL bytes): always
        # candidates — a pre-filter may only ever DROP non-matches
        self._unindexed: list[int] = []

    def extend(self, pool: list[str]) -> None:
        n0 = self._n_indexed
        if len(pool) <= n0:
            return
        fresh = pool[n0:]
        enc = [v.encode("utf-8", "surrogatepass") for v in fresh]
        clean_vids = []
        clean_bytes = []
        for off, b in enumerate(enc):        # per NEW value, never per posting
            if b"\x00" in b:
                self._unindexed.append(n0 + off)
            else:
                clean_vids.append(n0 + off)
                clean_bytes.append(b)
        self._n_indexed = len(pool)
        if not clean_bytes:
            return
        blob = b"\x00" + b"\x00".join(clean_bytes) + b"\x00"
        u8 = np.frombuffer(blob, np.uint8)
        if len(u8) < 3:
            return
        win = np.lib.stride_tricks.sliding_window_view(u8, 3)
        valid = (win != 0).all(axis=1)
        if not valid.any():
            return
        win = win[valid]
        codes = ((win[:, 0].astype(np.uint32) << 16)
                 | (win[:, 1].astype(np.uint32) << 8)
                 | win[:, 2].astype(np.uint32))
        # window at blob position p lies inside the value whose span starts
        # at starts[j]: sentinel NULs guarantee in-value windows only
        lens = np.fromiter((len(b) for b in clean_bytes), np.int64,
                           count=len(clean_bytes))
        starts = np.concatenate(([1], 1 + np.cumsum(lens[:-1] + 1)))
        w_pos = np.flatnonzero(valid)
        val_ix = np.searchsorted(starts, w_pos, side="right") - 1
        vid_arr = np.asarray(clean_vids, np.int64)[val_ix]
        pairs = np.unique((codes.astype(np.uint64) << _SHIFT)
                          | vid_arr.astype(np.uint64))
        self._post.add_bulk((pairs >> _SHIFT).astype(np.uint32),
                            (pairs & _PID_MASK).astype(np.int64))

    def candidates(self, pattern: str, pool: list[str]) -> np.ndarray | None:
        """Sorted candidate vids for ``pattern``, or None when the pattern
        has no required trigrams (caller scans the full pool)."""
        codes = required_trigram_codes(pattern)
        if codes is None:
            return None
        self.extend(pool)
        cand = None
        for code in codes.tolist():          # a handful of codes, not terms
            vids = self._post.ids_of(int(code))
            cand = vids if cand is None else \
                cand[np.isin(cand, vids, assume_unique=True)]
            if not len(cand):
                break
        if self._unindexed:
            cand = np.union1d(cand, np.asarray(self._unindexed, np.int32))
        return cand.astype(np.int32)
