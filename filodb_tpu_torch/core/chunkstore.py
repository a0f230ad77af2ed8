"""Device-resident columnar series store: preallocated tensors per shard.

Port of the raw path of ``filodb_tpu/core/chunkstore.py`` (ref:
memory/.../BlockManager.scala, TimeSeriesPartition.scala write buffers ->
frozen chunks). Layout per (shard, schema): ``ts[S, C] int64`` (pad =
+sentinel), ``val[S, C]`` (f32 by default; f64 for parity stores),
``n[S] int32`` valid counts. Query kernels read these tensors directly.

Where the reference appends through a jitted scatter that DONATES its input
buffers (XLA's in-place update of an immutable array), the port writes into
the preallocated tensors in place (``index_put_``, masked gathers written
back with ``copy_``): same single resident copy, no reallocation. The shard
lock therefore guards the same thing it guards in the reference — a query
captures the tensors and launches its kernels under it, a flush mutates
them under it.

Compressed residency (narrow values, elided timestamps) arrives with a later
slice of the port.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..utils import diagnostics

TS_PAD = np.int64(1) << np.int64(62)   # sentinel > any real timestamp

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           torch.float32: torch.float32, torch.float64: torch.float64,
           np.float32: torch.float32, np.float64: torch.float64}


def _pad_size(m: int) -> int:
    """Bucket flush sizes to powers of two, as the reference does (there to
    bound recompilations; kept so both stores see the same batches)."""
    size = 1024
    while size < m:
        size *= 2
    return size


@dataclass
class SeriesStoreStats:
    samples_appended: int = 0
    out_of_order_dropped: int = 0
    capacity_dropped: int = 0
    compactions: int = 0
    frees: int = 0


class SeriesStore:
    """One shard's device store for a non-histogram schema value column."""

    def __init__(self, max_series: int, capacity: int, dtype="float32",
                 device=None):
        # round the row dimension up to a fused-kernel-friendly shape
        # (multiple of 8 up to 512, of 512 beyond), as the reference does
        m = 8 if max_series <= 512 else 512
        self.S = (max_series + m - 1) // m * m
        self.C = capacity
        self.dtype = _DTYPES[dtype]
        self.device = resolve_device(device)
        S = self.S
        self.ts = torch.full((S, capacity), int(TS_PAD), dtype=torch.int64,
                             device=self.device)
        self.val = torch.zeros((S, capacity), dtype=self.dtype,
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
        # padded to the bucketed size like the reference; pad entries carry
        # row index S, which the reference's scatter drops (mode="drop") —
        # index_put_ would not, so they are masked out before the write
        P = _pad_size(m)
        rp = np.full(P, self.S, np.int32); rp[:m] = r
        cp = np.zeros(P, np.int32); cp[:m] = cols
        tp = np.zeros(P, np.int64); tp[:m] = t
        vp = np.zeros(P, np.asarray(v).dtype); vp[:m] = v
        keep_d = (rp >= 0) & (rp < self.S) & (cp >= 0) & (cp < self.C)
        dev = self.device
        rows = torch.from_numpy(rp[keep_d].astype(np.int64)).to(dev)
        colt = torch.from_numpy(cp[keep_d].astype(np.int64)).to(dev)
        self.ts.index_put_((rows, colt), torch.from_numpy(tp[keep_d]).to(dev))
        self.val.index_put_((rows, colt),
                            torch.from_numpy(vp[keep_d]).to(dev, self.dtype))
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
        (ref: block reclaim by time bucket); one gather, written back in
        place."""
        self._pre_mutate("SeriesStore.compact")
        S, C = self.ts.shape
        cutoff = torch.full((S, 1), int(cutoff_ts), dtype=torch.int64,
                            device=self.device)
        k = torch.searchsorted(self.ts, cutoff, side="left")       # [S, 1]
        idx = torch.arange(C, device=self.device)[None, :] + k
        valid = idx < C
        idx = torch.where(valid, idx, C - 1)
        new_ts = torch.where(valid, torch.gather(self.ts, 1, idx), int(TS_PAD))
        new_val = torch.where(valid, torch.gather(self.val, 1, idx),
                              torch.zeros((), dtype=self.dtype,
                                          device=self.device))
        new_n = torch.clamp(self.n - k[:, 0].to(torch.int32), min=0)
        pos = torch.arange(C, device=self.device)[None, :]
        new_ts = torch.where(pos < new_n[:, None], new_ts, int(TS_PAD))
        self.ts.copy_(new_ts)
        self.val.copy_(new_val)
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

    def arrays(self):
        """(ts[S,C], val, n[S]) device tensors for query kernels."""
        return self.ts, self.val, self.n

    def snapshot_arrays(self):
        """(ts, val) blocks for per-series slicing loops."""
        return self.ts, self.val
