"""Device-resident columnar series store: preallocated tensors per shard.

Port of ``filodb_tpu/core/chunkstore.py`` (ref: memory/.../BlockManager.scala,
TimeSeriesPartition.scala write buffers -> frozen chunks). Layout per
(shard, schema): ``ts[S, C] int64`` (pad = +sentinel), ``val[S, C]`` (f32
by default; f64 for parity stores) or ``val[S, C, B]`` cumulative bucket
counts for a histogram column, ``n[S] int32`` valid counts, and for
multi-column schemas one named [S, C] tensor per extra scalar column
(``extra``). Query kernels read these tensors directly.

Where the reference appends through a jitted scatter that DONATES its input
buffers (XLA's in-place update of an immutable array), the port writes into
the preallocated tensors in place (``index_put_``, masked gathers written
back with ``copy_``): same single resident copy, no reallocation. The shard
lock therefore guards the same thing it guards in the reference — a query
captures the tensors and launches its kernels under it, a flush mutates
them under it.

Compressed residency: after a flush the value block compresses to its
narrowest exact form (ops/narrow.py) plus a raw-f32 cohort pool for the
rows that do not round-trip, and the f32 block is released. A scalar [S, C]
store takes the first of delta8, quant16 and delta16 (ops/decodereg.py)
whose pool stays under the cohort gate; a histogram [S, C, B] store an
i8/i16 2D-delta block. On a grid-contiguous store the i64 timestamp block
is released too (derived from first_ts, n and the interval). Appends
rehydrate; the next flush re-compresses. A raw store may instead keep a
quant16 mirror beside its f32 block (``SeriesStore.narrow``,
ops/narrow.NarrowMirror).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..ops import decodereg
from ..ops.narrow import NarrowMirror
from ..utils import diagnostics

TS_PAD = np.int64(1) << np.int64(62)   # sentinel > any real timestamp

# the fraction of live rows allowed to fail the bit-exactness contract (kept
# raw in the cohort pool) before a store declines compression
COHORT_GATE = 0.25

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           torch.float32: torch.float32, torch.float64: torch.float64,
           np.float32: torch.float32, np.float64: torch.float64}

# rows per block of whole-store passes (decode, ts verification): bounded
# temporaries whatever the store's size
_BLOCK_ROWS = 1 << 14


def _pad_size(m: int) -> int:
    """Bucket flush sizes to powers of two, as the reference does (there to
    bound recompilations; kept so both stores see the same batches)."""
    size = 1024
    while size < m:
        size *= 2
    return size


def _decode_scalar(kind: str, ops, pool, pool_rows, S: int):
    """The f32 [S, C] value block from the scalar narrow-resident state:
    ``ops = (block, *row_operands)`` decoded in row blocks through the
    registry's decode of ``kind`` (quant16: vmin + (q + 32768) * scale;
    delta16/delta8: anchor + cumsum(dv)), bit-exact for rows the encoder
    marked ok; pool rows overlay their exact f32 rows (pad entries carry row
    S and are dropped). Delta rows extend their last value beyond the valid
    count (the raw store holds zeros there) — every consumer masks by
    ``n``."""
    decode = decodereg.variant(kind).decode
    blk, rows = ops[0], ops[1:]
    v = torch.empty(blk.shape, dtype=torch.float32, device=blk.device)
    for i in range(0, blk.shape[0], _BLOCK_ROWS):
        j = min(i + _BLOCK_ROWS, blk.shape[0])
        v[i:j] = decode(blk[i:j], *(r[i:j, None] for r in rows))
    keep = pool_rows < S
    v[pool_rows[keep].long()] = pool[keep]
    return v


def _decode_scalar_rows(kind: str, ops, pool, pool_slot, rid):
    """Decode ONLY the given store rows ([P] ids) of a scalar narrow block
    — a pool or minority fix must not materialize the full [S, C] block.
    Pooled rows copy their raw f32 pool row and are not decoded."""
    rid = rid.long()
    slot = pool_slot[rid].long()
    pooled = slot >= 0
    blk = ops[0]
    out = torch.empty((rid.shape[0], blk.shape[1]), dtype=torch.float32,
                      device=blk.device)
    out[pooled] = pool[slot[pooled]]
    r = rid[~pooled]
    out[~pooled] = decodereg.variant(kind).decode(
        blk[r], *(o[r][:, None] for o in ops[1:]))
    return out


def _decode_hist(dd, first_d, pool, pool_rows, S: int):
    """The f32 [S, C, B] bucket block from the hist-resident state, v =
    cumsum_b(first_d + cumsum_c dd) decoded in row blocks (bit-exact for
    rows the encoder marked ok); pool rows overlay their exact f32 blocks
    (pad entries carry row S and are dropped, as the reference's scatter
    does). Cells beyond a row's valid count extend the last frame
    constantly (the raw store holds zeros there) — every consumer masks by
    ``n``."""
    v = torch.empty(dd.shape, dtype=torch.float32, device=dd.device)
    for i in range(0, dd.shape[0], _BLOCK_ROWS):
        j = min(i + _BLOCK_ROWS, dd.shape[0])
        d = first_d[i:j, None, :] + torch.cumsum(dd[i:j].float(), dim=1)
        v[i:j] = torch.cumsum(d, dim=2)
    keep = pool_rows < S
    v[pool_rows[keep].long()] = pool[keep]
    return v


def _decode_hist_rows(dd, first_d, pool, pool_slot, rid):
    """Decode ONLY the given store rows ([P] ids) of a hist-resident block —
    minority/pool fixes must not materialize the full [S, C, B] block.
    Pooled rows copy their raw f32 pool block and are not decoded."""
    rid = rid.long()
    slot = pool_slot[rid].long()
    pooled = slot >= 0
    out = torch.empty((rid.shape[0],) + tuple(dd.shape[1:]),
                      dtype=torch.float32, device=dd.device)
    out[pooled] = pool[slot[pooled]]
    r = rid[~pooled]
    d = first_d[r][:, None, :] + torch.cumsum(dd[r].float(), dim=1)
    out[~pooled] = torch.cumsum(d, dim=2)
    return out


def _derive_ts(first, n, interval: int, C: int):
    """The i64 timestamp block of a grid-contiguous store from per-row first
    timestamps: ts[r, k] = first[r] + k * interval for k < n[r] (TS_PAD
    beyond, and everywhere for empty rows)."""
    col = torch.arange(C, dtype=torch.int64, device=first.device)[None, :]
    live = (col < n[:, None]) & (first[:, None] >= 0)
    return torch.where(live, first[:, None] + col * interval, int(TS_PAD))


def _verify_ts(ts, first, n, interval: int, C: int) -> bool:
    """ts == the derived block, compared in row blocks: a whole-store
    comparison would hold multi-GB i64 temporaries exactly when device
    memory is tight."""
    for i in range(0, ts.shape[0], _BLOCK_ROWS):
        j = min(i + _BLOCK_ROWS, ts.shape[0])
        if not bool(torch.equal(ts[i:j], _derive_ts(first[i:j], n[i:j],
                                                    interval, C))):
            return False
    return True


class _Deferred:
    """Base for lazy views of elided store blocks: shape metadata for
    planning; ``materialize()`` reconstructs. The fused/grid paths plan
    from the metadata and never materialize."""

    __slots__ = ("_store", "_arr")
    ndim = 2

    def __init__(self, store: "SeriesStore"):
        self._store = store
        self._arr = None

    @property
    def shape(self):
        return (self._store.S, self._store.C)

    @property
    def device(self):
        return self._store.device

    def dim(self) -> int:
        return self.ndim

    def materialize(self):
        if self._arr is None:
            self._arr = self._build()
        return self._arr

    def __getitem__(self, idx):
        return self.materialize()[idx]


class DeferredDecode(_Deferred):
    """Lazy f32 view of a scalar narrow-resident store's [S, C] value
    block."""

    dtype = torch.float32

    def _build(self):
        return self._store.value_block()

    def gather_rows(self, rid):
        """[P, C] f32 of the given rows only (row-wise decode; falls back to
        the materialized block if one exists or the store changed residency
        since this view was handed out)."""
        st = self._store
        if self._arr is None and st._narrow is not None:
            kind, ops, pool, _pp, slot, _ok = st._narrow
            return _decode_scalar_rows(kind, ops, pool, slot, rid)
        return self.materialize()[rid.long()]


class DeferredDecodeHist(_Deferred):
    """Lazy f32 view of a hist-resident store's [S, C, B] bucket block."""

    dtype = torch.float32
    ndim = 3

    @property
    def shape(self):
        return (self._store.S, self._store.C, self._store.nbuckets)

    def _build(self):
        return self._store.value_block()

    def gather_rows(self, rid):
        """[P, C, B] f32 of the given rows only (row-wise decode + pool
        overlay; falls back to a materialized block if one exists or the
        store changed residency since this view was handed out)."""
        st = self._store
        if self._arr is None and st._nhist is not None:
            dd, first_d, pool, _pp, slot, _ok = st._nhist
            return _decode_hist_rows(dd, first_d, pool, slot, rid)
        return self.materialize()[rid.long()]


class DeferredTs(_Deferred):
    """Lazy i64 view of an elided (grid-derived) timestamp block."""

    dtype = torch.int64

    def _build(self):
        return self._store.ts_block()

    def gather_rows(self, rid):
        """[P, C] i64 of the given rows only (row-wise derivation)."""
        st = self._store
        rid = rid.long()
        if self._arr is None and st._ts_elided:
            return _derive_ts(st._first_ts_dev()[rid], st.n[rid],
                              st.grid_interval, st.C)
        return self.materialize()[rid]


@dataclass
class SeriesStoreStats:
    samples_appended: int = 0
    out_of_order_dropped: int = 0
    capacity_dropped: int = 0
    compactions: int = 0
    frees: int = 0


class SeriesStore:
    """One shard's device store for one schema's value columns."""

    def __init__(self, max_series: int, capacity: int, dtype="float32",
                 device=None, nbuckets: int = 0, layout=None,
                 default_col: str | None = None):
        """``nbuckets`` > 0 makes the default column a [S, C, B] histogram
        block. ``layout`` (Schema.col_layout) declares multi-column storage:
        the schema's default column lives in ``val`` and every other data
        column gets its own named [S, C] tensor in ``extra``, all sharing
        one ts/n pair."""
        # round the row dimension up to a fused-kernel-friendly shape
        # (multiple of 8 up to 512, of 512 beyond), as the reference does
        m = 8 if max_series <= 512 else 512
        self.S = (max_series + m - 1) // m * m
        self.C = capacity
        self.dtype = _DTYPES[dtype]
        self.device = resolve_device(device)
        self.nbuckets = nbuckets
        self.layout = layout
        self.default_col = None
        S = self.S
        vshape = (S, capacity) if not nbuckets else (S, capacity, nbuckets)
        self.ts = torch.full((S, capacity), int(TS_PAD), dtype=torch.int64,
                             device=self.device)
        self.val = torch.zeros(vshape, dtype=self.dtype, device=self.device)
        self.extra: dict[str, torch.Tensor] = {}
        if layout is not None:
            hist = [nm for nm, _o, _w, ih in layout if ih]
            names = [nm for nm, _o, _w, _ih in layout]
            self.default_col = (default_col if default_col in names
                                else hist[0] if hist else layout[-1][0])
            for nm, _off, _w, is_h in layout:
                if nm != self.default_col:
                    assert not is_h, "only one histogram column per schema"
                    self.extra[nm] = torch.zeros((S, capacity),
                                                 dtype=self.dtype,
                                                 device=self.device)
        self.n = torch.zeros(S, dtype=torch.int32, device=self.device)
        # host mirrors: ingest bookkeeping without device->host syncs
        self.n_host = np.zeros(S, np.int32)
        self.last_ts = np.full(S, -(1 << 62), np.int64)
        self.first_ts = np.full(S, -1, np.int64)
        # scrape-grid tracking: while every series stays on a common
        # (base, interval) grid with contiguous samples, queries take the
        # band-product / fused-kernel path instead of per-row searches
        self.grid_base: int | None = None
        self.grid_interval: int | None = None
        self.grid_ok = True
        self._cohorts = None
        # the shard attaches its lock so mutations can assert the discipline
        self.owner_lock = None
        self.stats = SeriesStoreStats()
        # quant16 mirror of the default value column beside the raw block
        # (StoreConfig.narrow_mirror): rebuilt at flush, consulted by the
        # query leaf
        self.narrow = NarrowMirror()
        # scalar narrow-resident state (compressed_residency "gauge"/"all"):
        # (kind, ops, pool f32 [Rp, C], pp i32 [Rp] (pads = S), slot i32 [S]
        # (-1 = not pooled), ok_host bool [S]); ``kind`` names the decode
        # variant (ops/decodereg.py: "delta8" | "quant16" | "delta16") and
        # ``ops`` its tensors ((q, vmin, scale) or (dv, anchor)). When set it
        # IS the only resident value copy and ``val`` is None
        self._narrow = None
        # hist-resident state (compressed_residency="all"): (dd i8/i16
        # [S,C,B], first_d f32 [S,B], pool f32 [Rp,C,B], pp i32 [Rp] (pads
        # = S), slot i32 [S] (-1 = not pooled), ok_host bool [S]). When set
        # it IS the only resident value copy and ``val`` is None
        self._nhist = None
        # timestamps elided: ``ts`` is None and derived on demand
        self._ts_elided = False
        # why the last compression attempt declined ("resets" |
        # "non-integer" | "range"), for the fallback counter
        self.residency_decline: str | None = None

    @classmethod
    def from_reference_arrays(cls, ts, val, n, grid_base, grid_interval,
                              grid_ok: bool = True, n_host=None,
                              first_ts=None, last_ts=None,
                              device=None) -> "SeriesStore":
        """A store on ``device`` holding the given state: the arrays a
        reference ``SeriesStore`` exposes as numpy (``snapshot_arrays``,
        ``n``/``n_host``, the grid fields). ``ts``/``val`` are [S, C] with S
        already padded; the host mirrors are derived when not given."""
        ts = np.asarray(ts, np.int64)
        val = np.asarray(val)
        S, C = ts.shape
        st = cls(S, C, dtype=val.dtype.type, device=device)
        assert st.S == S, f"row count {S} is not a store shape (wants {st.S})"
        n = np.asarray(n, np.int32)
        st.ts.copy_(torch.tensor(ts))
        st.val.copy_(torch.tensor(val))
        st.n.copy_(torch.tensor(n))
        st.n_host = (np.asarray(n_host, np.int32).copy() if n_host is not None
                     else n.copy())
        live = st.n_host > 0
        rows = np.arange(S)
        st.first_ts = (np.asarray(first_ts, np.int64).copy()
                       if first_ts is not None
                       else np.where(live, ts[:, 0], -1))
        st.last_ts = (np.asarray(last_ts, np.int64).copy()
                      if last_ts is not None
                      else np.where(live, ts[rows, np.maximum(st.n_host - 1, 0)],
                                    -(1 << 62)))
        st.grid_base = None if grid_base is None else int(grid_base)
        st.grid_interval = None if grid_interval is None else int(grid_interval)
        st.grid_ok = bool(grid_ok)
        return st

    def _pre_mutate(self, what: str) -> None:
        if self.owner_lock is not None:
            diagnostics.assert_owned(self.owner_lock, what)

    def _first_ts_dev(self):
        return torch.from_numpy(self.first_ts).to(self.device)

    # -- compressed-resident lifecycle ----------------------------------------
    #
    # Reference role: the reference keeps in-memory values ONLY in
    # compressed form and decompresses on access (doc/compression.md) —
    # bytes per sample is the capacity lever. After a flush the value block
    # compresses to the narrowest form that carries it bit-exactly (a scalar
    # decode variant, or a 2D-delta dtype for histograms) and the f32 block
    # is released; rows that do not round-trip keep their raw f32 in a
    # small cohort pool. Appends rehydrate (write buffers stay raw in the
    # reference too); the next flush re-compresses. Queries stream the
    # narrow state (K1's decode variants, K2), or decode a transient f32
    # for general paths.

    def mutation_epoch(self) -> tuple:
        """Changes whenever a mutation ran (append/compact/free) — the
        two-phase compression's staleness check."""
        s = self.stats
        return (s.samples_appended, s.compactions, s.frees)

    def _cohort_pool(self, bad: np.ndarray):
        """(pool, pp, slot) for the rows that don't round-trip bit-exactly:
        their raw f32 rows, the padded row-id vector (pads carry row S and
        drop on decode), and the per-row pool slot (-1 = not pooled) so
        row-wise decodes overlay pool values without the full block."""
        Rp = 1
        while Rp < len(bad):
            Rp *= 2
        pp = np.full(Rp, self.S, np.int32)
        pp[:len(bad)] = bad
        idx = torch.from_numpy(np.minimum(pp, self.S - 1).astype(np.int64))
        pool = self.val[idx.to(self.device)]
        slot = np.full(self.S, -1, np.int32)
        slot[bad] = np.arange(len(bad), dtype=np.int32)
        return (pool, torch.from_numpy(pp).to(self.device),
                torch.from_numpy(slot).to(self.device))

    def _bad_rows(self, ok_host: np.ndarray):
        """Live rows failing the bit-exactness contract, or None when they
        exceed the cohort gate (COHORT_GATE of live rows — raw f32 is then
        the cheaper residency)."""
        live = self.n_host > 0
        bad = np.nonzero(live & ~ok_host)[0].astype(np.int32)
        if len(bad) > COHORT_GATE * max(int(live.sum()), 1):
            return None
        return bad

    @staticmethod
    def _majority_reason(live_bad: np.ndarray,
                         reasons: list[tuple[str, np.ndarray]]) -> str:
        """Classify a residency decline: the first reason (in precedence
        order) that explains at least as many failing rows as any later
        one. ``reasons`` maps tag -> per-row failure mask."""
        counts = [(tag, int((live_bad & mask).sum())) for tag, mask in reasons]
        best = max(counts, key=lambda kv: kv[1])
        return best[0] if best[1] else counts[-1][0]

    def _prepare_scalar(self):
        """Scalar narrow residency, narrowest first: delta8 (1 B/sample),
        then quant16 (2 B, keeps active-column slicing: ops/decodereg.py
        full_columns), then delta16 (2 B, full columns). Counter-shaped rows
        (large anchor, small integer increments) fail the quantized
        contract but carry exactly in the delta form."""
        from ..ops.narrow import (build_narrow, build_narrow_delta,
                                  cast_narrow_delta_i8)
        dv16, anchor, okd16, okd8, integral = build_narrow_delta(self.val,
                                                                 self.n)
        okd8_host = okd8.cpu().numpy()
        bad = self._bad_rows(okd8_host)
        if bad is not None:
            dv8 = cast_narrow_delta_i8(dv16)
            del dv16
            return ("delta8", (dv8, anchor), *self._cohort_pool(bad),
                    okd8_host)
        q, vmin, scale, okq = build_narrow(self.val, self.n)
        okq_host = okq.cpu().numpy()
        bad = self._bad_rows(okq_host)
        if bad is not None:
            return ("quant16", (q, vmin, scale), *self._cohort_pool(bad),
                    okq_host)
        del q
        okd16_host = okd16.cpu().numpy()
        bad = self._bad_rows(okd16_host)
        if bad is not None:
            return ("delta16", (dv16, anchor), *self._cohort_pool(bad),
                    okd16_host)
        # every encoding breached the cohort gate: say why (non-integer
        # deltas vs integral but out of range) — mostly continuous floats
        # keep raw f32
        live_bad = (self.n_host > 0) & ~okq_host & ~okd16_host
        integral_host = integral.cpu().numpy()
        self.residency_decline = self._majority_reason(
            live_bad, [("non-integer", ~integral_host),
                       ("range", integral_host)])
        return None

    def _prepare_hist(self):
        """2D-delta residency for the [S, C, B] bucket block: the narrowest
        signed dtype (i8, then i16) whose bit-exact rows keep the cohort
        pool under the gate wins — quiet histograms' delta-of-deltas are
        near zero, so i8 usually carries them at a quarter of the raw f32
        bytes."""
        from ..ops.narrow import build_narrow_hist, cast_narrow_hist_i8
        dd16, first_d, ok16, ok8, mono, exact = build_narrow_hist(
            self.val, self.n)
        ok8_host, ok16_host = ok8.cpu().numpy(), ok16.cpu().numpy()
        bad8 = self._bad_rows(ok8_host)
        if bad8 is not None:
            dd, bad, ok_host = cast_narrow_hist_i8(dd16), bad8, ok8_host
            del dd16
        else:
            bad16 = self._bad_rows(ok16_host)
            if bad16 is None:
                # mostly inexact/bursty rows: keep raw f32, but say why —
                # counter resets (mono fail) vs non-integer round trips vs
                # integral-but-out-of-range deltas
                mono_host, exact_host = mono.cpu().numpy(), exact.cpu().numpy()
                live_bad = (self.n_host > 0) & ~ok16_host
                self.residency_decline = self._majority_reason(
                    live_bad, [("resets", ~mono_host),
                               ("non-integer", mono_host & ~exact_host),
                               ("range", mono_host & exact_host)])
                return None
            dd, bad, ok_host = dd16, bad16, ok16_host
        pool, pp, slot = self._cohort_pool(bad)
        return (dd, first_d, pool, pp, slot, ok_host)

    def compress_prepare(self):
        """Phase 1 (no lock needed): stream the store into the compressed
        form — a scalar narrow block or a 2D-delta bucket block, + cohort
        pool, and the ts-derivability verdict. Pure reads + host fetches; a
        concurrent mutation is caught by the caller's mutation_epoch() check
        before the commit. Returns None when the store or its data doesn't
        qualify (f64, multi-column scalar, mostly non-exact rows);
        ``residency_decline`` then carries the reason when the data itself
        refused."""
        prep_val = None
        self.residency_decline = None
        if not self._val_compressed:
            if self.dtype != torch.float32 or self.val is None:
                return None
            if self.nbuckets:
                # histogram stores compress their DEFAULT [S, C, B] bucket
                # block — the dominant bytes; a multi-column store's named
                # scalar columns (prom-histogram's sum/count) stay raw
                prep_val = self._prepare_hist()
            elif self.layout is None:
                prep_val = self._prepare_scalar()
            else:
                return None   # multi-column scalar stores stay raw
            if prep_val is None:
                return None
        ts_ok = False
        if not self._ts_elided and self.ts is not None \
                and self.grid_info() is not None:
            # the grid invariant guarantees derivability; verify anyway — a
            # silently wrong timestamp block must be impossible
            ts_ok = _verify_ts(self.ts, self._first_ts_dev(), self.n,
                               self.grid_interval, self.C)
        return (prep_val, ts_ok)

    def compress_commit(self, prep) -> None:
        """Phase 2 (under the shard lock): swap the compressed state in and
        release the raw blocks. The caller verified mutation_epoch() is
        unchanged since the prepare."""
        prep_val, ts_ok = prep
        self._pre_mutate("SeriesStore.compress_commit")
        if prep_val is not None:
            if self.nbuckets:
                self._nhist = prep_val
            else:
                self._narrow = prep_val
            self.val = None    # the f32 block's device memory is released
        if ts_ok and not self._ts_elided:
            self.ts = None     # the 8 B/sample block's memory is released
            self._ts_elided = True

    @property
    def _val_compressed(self) -> bool:
        return self._narrow is not None or self._nhist is not None

    def _rehydrate(self) -> None:
        """Restore the resident f32/i64 blocks (mutations write raw); the
        next flush re-adopts the compressed state."""
        if not self._val_compressed and not self._ts_elided:
            return
        self._pre_mutate("SeriesStore.rehydrate")
        if self._narrow is not None:
            kind, ops, pool, pp, _slot, _ok = self._narrow
            self._narrow = None
            self.val = _decode_scalar(kind, ops, pool, pp, self.S)
        if self._nhist is not None:
            dd, first_d, pool, pp, _slot, _ok = self._nhist
            self._nhist = None
            self.val = _decode_hist(dd, first_d, pool, pp, self.S)
        if self._ts_elided:
            self.ts = _derive_ts(self._first_ts_dev(), self.n,
                                 self.grid_interval, self.C)
            self._ts_elided = False

    def value_block(self):
        """f32 value block: the resident tensor, or a TRANSIENT decode of
        the narrow state (not retained — capacity stays at the compressed
        form + pool)."""
        if self._narrow is not None:
            kind, ops, pool, pp, _slot, _ok = self._narrow
            return _decode_scalar(kind, ops, pool, pp, self.S)
        if self._nhist is not None:
            dd, first_d, pool, pp, _slot, _ok = self._nhist
            return _decode_hist(dd, first_d, pool, pp, self.S)
        return self.val

    def ts_block(self):
        """i64 timestamp block: resident, or a TRANSIENT grid derivation."""
        if not self._ts_elided:
            return self.ts
        return _derive_ts(self._first_ts_dev(), self.n, self.grid_interval,
                          self.C)

    def narrow_operands(self):
        """(kind, ops, ok_host) when scalar narrow-resident, else None — K1's
        direct-stream operands: ``kind`` names the decode variant
        (ops/decodereg.py), ``ops = (block, *row_operands)``."""
        if self._narrow is None:
            return None
        kind, ops, _pool, _pp, _slot, ok = self._narrow
        return kind, ops, ok

    def hist_operands(self):
        """(dd, first_d, ok_host) when hist-resident, else None — the narrow
        hist kernels' direct-stream operands."""
        if self._nhist is None:
            return None
        dd, first_d, _pool, _pp, _slot, ok = self._nhist
        return dd, first_d, ok

    @property
    def is_narrow_resident(self) -> bool:
        return self._val_compressed or self._ts_elided

    def resident_value_bytes(self) -> int:
        """Resident device bytes of the default value column's state."""
        if self._narrow is not None:
            _kind, ops, pool, _pp, _slot, _ok = self._narrow
            return (sum(o.numel() * o.element_size() for o in ops)
                    + pool.numel() * 4)
        if self._nhist is not None:
            dd, first_d, pool, _pp, _slot, _ok = self._nhist
            return (dd.numel() * dd.element_size() + first_d.numel() * 4
                    + pool.numel() * 4)
        v = self.val
        return 0 if v is None else v.numel() * v.element_size()

    def resident_sample_bytes(self) -> int:
        """Resident device bytes of the (ts + value) sample state — the
        retention-per-byte accounting."""
        t = 0 if self._ts_elided or self.ts is None \
            else self.ts.numel() * self.ts.element_size()
        return t + self.resident_value_bytes()

    # -- ingest -------------------------------------------------------------

    def append(self, part_ids: np.ndarray, ts: np.ndarray, values: np.ndarray) -> int:
        """Batched append of samples (one flush group), presented in ingest
        order; per-series out-of-order or over-capacity samples drop
        (reference behaviour: TimeSeriesPartition drops out-of-order rows).
        Returns the number of samples written."""
        if len(part_ids) == 0:
            return 0
        part_ids = np.asarray(part_ids, np.int32)
        ts = np.asarray(ts, np.int64)
        # stable sort by series; position within the batch = running offset
        order = np.argsort(part_ids, kind="stable")
        r = part_ids[order]
        t = ts[order]
        v = np.asarray(values)[order]
        # a sample must exceed the stored last_ts and every earlier in-batch
        # sample of its series (fast path when nothing violates)
        prev_t = np.concatenate([[0], t[:-1]])
        same_series = np.concatenate([[False], np.diff(r) == 0])
        viol = (t <= self.last_ts[r]) | (same_series & (t <= prev_t))
        keep = ~viol
        if viol.any():
            # exact per-series running-max filter, only for violators
            for s in np.unique(r[viol]):
                mask = r == s
                tt = t[mask]
                run = self.last_ts[s]
                kk = np.empty(len(tt), bool)
                for i, x in enumerate(tt):
                    kk[i] = x > run
                    if kk[i]:
                        run = x
                keep[mask] = kk
            self.stats.out_of_order_dropped += int((~keep).sum())
            r, t, v = r[keep], t[keep], v[keep]
        # running occurrence index within the sorted batch -> dense columns
        boundaries = np.concatenate([[0], np.nonzero(np.diff(r))[0] + 1])
        occ = np.arange(len(r)) - np.repeat(
            boundaries, np.diff(np.concatenate([boundaries, [len(r)]])))
        cols = self.n_host[r] + occ
        over = cols >= self.C
        if over.any():
            self.stats.capacity_dropped += int(over.sum())
            r, t, v, cols = r[~over], t[~over], v[~over], cols[~over]
        m = len(r)
        if m == 0:
            return 0
        self._rehydrate()      # mutations write the raw blocks
        self._pre_mutate("SeriesStore.append")
        uniq, first_pos = np.unique(r, return_index=True)
        newly = uniq[self.n_host[uniq] == 0]
        self.first_ts[newly] = t[first_pos[self.n_host[uniq] == 0]]
        if len(newly):
            self._cohorts = None   # new starts can change the cohort summary
        self._track_grid(r, t, uniq, first_pos)
        np.maximum.at(self.last_ts, r, t)
        counts = np.bincount(r, minlength=self.S).astype(np.int32)
        self.n_host += counts
        # the flat [m, W] rows of a multi-column schema split by its layout:
        # the default column (scalar or histogram span) + named scalars
        extra_vals = {}
        if self.layout is not None:
            for nm, off, w, _is_h in self.layout:
                colv = v[:, off] if w == 1 else v[:, off:off + w]
                if nm == self.default_col:
                    dv = colv
                else:
                    extra_vals[nm] = colv
            v = dv
        # padded to the bucketed size like the reference; pad entries carry
        # row index S, which the reference's scatter drops (mode="drop") —
        # index_put_ would not, so they are masked out before the write
        P = _pad_size(m)
        rp = np.full(P, self.S, np.int32); rp[:m] = r
        cp = np.zeros(P, np.int32); cp[:m] = cols
        tp = np.zeros(P, np.int64); tp[:m] = t
        keep_d = (rp >= 0) & (rp < self.S) & (cp >= 0) & (cp < self.C)
        dev = self.device
        rows = torch.from_numpy(rp[keep_d].astype(np.int64)).to(dev)
        colt = torch.from_numpy(cp[keep_d].astype(np.int64)).to(dev)

        def padded(a):
            ap = np.zeros((P,) + a.shape[1:], a.dtype)
            ap[:m] = a
            return torch.from_numpy(ap[keep_d]).to(dev, self.dtype)

        self.ts.index_put_((rows, colt), torch.from_numpy(tp[keep_d]).to(dev))
        self.val.index_put_((rows, colt), padded(np.asarray(v)))
        for nm, a in extra_vals.items():
            self.extra[nm].index_put_((rows, colt), padded(np.asarray(a)))
        self.n.add_(torch.from_numpy(counts).to(dev))
        self.stats.samples_appended += m
        return m

    def _track_grid(self, r, t, uniq, first_pos) -> None:
        """Maintain the shard scrape-grid invariant on each append batch:
        common (base, interval), per-series contiguity, on-grid starts."""
        if not self.grid_ok:
            return
        if self.grid_base is None:
            self.grid_base = int(t[0])
        if self.grid_interval is None:
            same = np.concatenate([[False], np.diff(r) == 0])
            if same.any():
                i = int(np.argmax(same))
                self.grid_interval = int(t[i] - t[i - 1])
            else:
                existing = self.n_host[r] > 0
                if existing.any():
                    i = int(np.argmax(existing))
                    self.grid_interval = int(t[i] - self.last_ts[r[i]])
            if self.grid_interval is not None and self.grid_interval <= 0:
                self.grid_ok = False
            if self.grid_interval is None:
                return
            # starts recorded before the interval was known must land on it
            live = self.n_host > 0
            if self.grid_ok and live.any():
                starts = self.first_ts[live]
                if (((starts - self.grid_base) % self.grid_interval) != 0).any():
                    self.grid_ok = False
                    return
        iv = self.grid_interval
        ok = ((t - self.grid_base) % iv == 0).all()
        same = np.concatenate([[False], np.diff(r) == 0])
        if ok and same.any():
            ok = (np.diff(t)[same[1:]] == iv).all()
        if ok:
            existing = self.n_host[uniq] > 0
            if existing.any():
                heads = t[first_pos[existing]]
                ok = (heads == self.last_ts[uniq[existing]] + iv).all()
        if not ok:
            self.grid_ok = False

    def grid_info(self):
        """(base_ts, interval_ms) while the shard stays on a common scrape
        grid, else None. Series may START at different cells (churn): see
        :meth:`grid_cohorts`."""
        if not self.grid_ok or not self.grid_interval:
            return None
        if not (self.n_host > 0).any():
            return None
        return int(self.grid_base), int(self.grid_interval)

    def grid_offsets(self, rows: np.ndarray) -> np.ndarray:
        """Start cell of each given row relative to ``grid_base``; 0 for
        empty rows."""
        first = self.first_ts[rows]
        return np.where(first >= 0,
                        (first - self.grid_base) // self.grid_interval,
                        0).astype(np.int64)

    def grid_cohorts(self):
        """Cached start-cohort summary over live rows: ``("uniform", off)``
        when every live series starts at one grid cell, else
        ``("mixed", offsets[S])``."""
        if self._cohorts is None:
            live = self.n_host > 0
            if not live.any():
                self._cohorts = ("uniform", 0)
            else:
                offs = self.grid_offsets(np.arange(self.S))
                lv = offs[live]
                if (lv == lv[0]).all():
                    self._cohorts = ("uniform", int(lv[0]))
                else:
                    self._cohorts = ("mixed", offs)
        return self._cohorts

    def compact(self, cutoff_ts: int) -> None:
        """Evict samples older than ``cutoff_ts`` by shifting each row left
        (ref: block reclaim by time bucket); one gather per column, shared
        shift indices, written back in place."""
        self._rehydrate()      # the shift gathers the raw blocks
        self._pre_mutate("SeriesStore.compact")
        S, C = self.ts.shape
        cutoff = torch.full((S, 1), int(cutoff_ts), dtype=torch.int64,
                            device=self.device)
        k = torch.searchsorted(self.ts, cutoff, side="left")       # [S, 1]
        idx = torch.arange(C, device=self.device)[None, :] + k
        valid = idx < C
        idx = torch.where(valid, idx, C - 1)
        new_ts = torch.where(valid, torch.gather(self.ts, 1, idx), int(TS_PAD))

        def shift(a):
            if a.dim() == 3:
                g = torch.gather(a, 1, idx[:, :, None].expand(-1, -1, a.shape[2]))
                return torch.where(valid[:, :, None], g, 0.0)
            return torch.where(valid, torch.gather(a, 1, idx), 0.0)

        new_val = shift(self.val)
        new_extra = {nm: shift(a) for nm, a in self.extra.items()}
        new_n = torch.clamp(self.n - k[:, 0].to(torch.int32), min=0)
        pos = torch.arange(C, device=self.device)[None, :]
        new_ts = torch.where(pos < new_n[:, None], new_ts, int(TS_PAD))
        self.ts.copy_(new_ts)
        self.val.copy_(new_val)
        for nm, a in new_extra.items():
            self.extra[nm].copy_(a)
        self.n.copy_(new_n)
        self.n_host = self.n.cpu().numpy().copy()
        new_first = self.ts[:, 0].cpu().numpy()
        self.first_ts = np.where(self.n_host > 0, new_first, -1)
        self._cohorts = None
        self.stats.compactions += 1

    def free_rows(self, part_ids: np.ndarray) -> None:
        """Release the rows of purged partitions so their slots can be
        reused. Stale val cells stay but are masked by n = 0; ts rows reset
        to padding so grid and first-ts scans never see them."""
        if len(part_ids) == 0:
            return
        self._rehydrate()      # the reset writes the raw ts block
        self.stats.frees += 1
        self._pre_mutate("SeriesStore.free_rows")
        pids = np.asarray(part_ids, np.int64)
        pids = pids[(pids >= 0) & (pids < self.S)]
        rows = torch.from_numpy(pids).to(self.device)
        self.ts[rows] = int(TS_PAD)
        self.n[rows] = 0
        self.n_host[pids] = 0
        self.first_ts[pids] = -1
        self.last_ts[pids] = -(1 << 62)
        self._cohorts = None

    # -- query access -------------------------------------------------------

    def arrays(self, column: str | None = None):
        """(ts[S,C], val, n[S]) for query kernels; ``column`` selects a named
        value column of a multi-column store (None = the default column).
        Compressed-resident stores return deferred views: the fused paths
        plan from shape metadata and never materialize."""
        ts = DeferredTs(self) if self._ts_elided else self.ts
        return ts, self.column_array(column), self.n

    def column_array(self, column: str | None = None):
        if column is None or column == self.default_col:
            if self._narrow is not None:
                return DeferredDecode(self)
            if self._nhist is not None:
                return DeferredDecodeHist(self)
            return self.val
        if column in self.extra:
            return self.extra[column]
        raise KeyError(f"unknown value column {column!r}")

    def snapshot_arrays(self, column: str | None = None):
        """(ts, val) blocks materialized once, for per-series loops."""
        v = self.column_array(column)
        if isinstance(v, _Deferred):
            v = v.materialize()
        return self.ts_block(), v

    def series_snapshot(self, part_id: int, column: str | None = None):
        """Host copy of one series (tests and debugging; loops use
        snapshot_arrays)."""
        cnt = int(self.n_host[part_id])
        t, v = self.snapshot_arrays(column)
        return (t[part_id, :cnt].cpu().numpy(),
                v[part_id, :cnt].cpu().numpy())
