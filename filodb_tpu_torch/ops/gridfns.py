"""Grid fast path: range functions as band products over a grid-aligned store.

Port of ``filodb_tpu/ops/gridfns.py``. When every live series has sample k
at timestamp base + k * interval, window edges are closed-form grid cells
and window reductions are [S, C] x [C, T] products with static 0/1 band
matrices (the host builders below). Scalar stores: the reference's grid
functions, rate/increase/delta, sum/avg/count_over_time, last_over_time
and the instant selector's last_sample; ``periodic_samples_grid`` is what
an un-aggregated ``rate(m[5m])``, an instant selector ``m`` (or a group
count above the fused cap) materializes through. Histogram stores:
the per-bucket range functions (``periodic_samples_grid_hist[_narrow]``,
[S, T, B] in row chunks), the one-program
``histogram_quantile(q, sum(fn(h[w])))`` routes over the raw [S, C, B]
block and over the i8/i16 2D-delta block, and ``histogram_quantile``
itself in f64. The products run through
``torch.matmul`` in full f32, as the JAX package left them to XLA.

Reference behaviour: query/.../exec/rangefn/ + RateFunctions.scala.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import rangefns

GRID_FNS = {"rate", "increase", "delta", "sum_over_time", "count_over_time",
            "avg_over_time", "last_sample", "last_over_time"}


def grid_edges(out_ts: np.ndarray, window_ms: int, base_ts: int, interval_ms: int):
    """Host-side closed-form window edges in grid cells: cells with timestamps
    in [t - window, t] are [lo_t, hi_t] inclusive (empty when hi < lo)."""
    lo = np.ceil((out_ts - window_ms - base_ts) / interval_ms).astype(np.int64)
    hi = np.floor((out_ts - base_ts) / interval_ms).astype(np.int64)
    return lo, hi


def band_matrix(C: int, lo: np.ndarray, hi: np.ndarray, open_left: bool,
                dtype=np.float32) -> np.ndarray:
    """Static [C, T] 0/1 band: cell c contributes to step t iff
    lo_t < c <= hi_t (open_left) or lo_t <= c <= hi_t."""
    c = np.arange(C)[:, None]
    lo_ = lo[None, :] + (1 if open_left else 0)
    return ((c >= lo_) & (c <= hi[None, :])).astype(dtype)


def onehot_matrix(C: int, pos: np.ndarray, dtype=np.float32) -> np.ndarray:
    """[C, T] one-hot of clipped positions per step."""
    m = np.zeros((C, len(pos)), dtype)
    m[np.clip(pos, 0, C - 1), np.arange(len(pos))] = 1
    return m


def _grid_kernel(fn, val, n, ops, stale_ms: int):
    """val [S, C]: sample k of each series at column k == grid cell k.

    Time arithmetic is int32 grid-relative milliseconds (rel_out = out_ts -
    base_ts), exactly as the reference: the caller guarantees the relative
    range fits i32."""
    S, C = val.shape
    acc = val.dtype
    dev = val.device
    lo, hi, rel_out = ops["lo"], ops["hi"], ops["rel_out"]
    window_ms, interval_ms = ops["window_ms"], ops["interval_ms"]
    n = n.to(torch.int32)
    valid = torch.arange(C, dtype=torch.int32, device=dev)[None, :] < n[:, None]
    v = torch.where(valid, val, torch.zeros((), dtype=val.dtype, device=dev)).to(acc)

    last_cell = n[:, None] - 1                                    # [S, 1] i32
    f_idx = torch.clamp(lo, min=0)[None, :]                       # [1, T] i32
    l_idx = torch.minimum(hi[None, :], last_cell)
    cnt = torch.clamp(l_idx - f_idx + 1, min=0)
    cnt_f = cnt.to(acc)
    nan = float("nan")

    if fn == "count_over_time":
        return torch.where(cnt >= 1, cnt_f, nan)

    if fn in ("sum_over_time", "avg_over_time"):
        s = v @ ops["band"]
        if fn == "avg_over_time":
            s = s / cnt_f
        return torch.where(cnt >= 1, s, nan)

    if fn in ("last_sample", "last_over_time"):
        static_v = v @ ops["onehot_hi"]                           # value at cell hi_t
        row_last = torch.gather(
            v, 1, torch.clamp(last_cell, 0, C - 1).long())        # [S, 1]
        l_v = torch.where(hi[None, :] <= last_cell, static_v, row_last)
        ok = cnt >= 1
        if fn == "last_sample":
            l_rel = l_idx * interval_ms                           # i32 [S, T]
            ok = ok & ((rel_out[None, :] - l_rel) <= stale_ms)
        return torch.where(ok, l_v, nan)

    if fn in ("rate", "increase", "delta"):
        is_counter = fn != "delta"
        prev = torch.cat([v[:, :1], v[:, :-1]], dim=1)
        pair = valid & torch.cat([torch.zeros_like(valid[:, :1]),
                                  valid[:, :-1]], dim=1)
        raw_inc = torch.where(pair, v - prev, 0.0)
        # counter: corrected increment = relu(diff); a reset cell adds 0
        inc = torch.clamp(raw_inc, min=0.0) if is_counter else raw_inc
        delta = inc @ ops["band_open"]                            # (lo_t, hi_t]
        f_v = v @ ops["onehot_lo"]                                # raw first value
        f_rel = f_idx * interval_ms                               # [1, T] i32
        l_rel = l_idx * interval_ms                               # [S, T] i32
        win_start = rel_out[None, :] - window_ms
        win_end = rel_out[None, :]
        dur_start = (f_rel - win_start).to(acc) / 1000.0
        dur_end = (win_end - l_rel).to(acc) / 1000.0
        sampled = (l_rel - f_rel).to(acc) / 1000.0
        avg_dur = sampled / (cnt_f - 1.0)
        if is_counter:
            dur_zero = torch.where(delta > 0, sampled * (f_v / delta),
                                   float("inf"))
            dur_start = torch.where((delta > 0) & (f_v >= 0)
                                    & (dur_zero < dur_start),
                                    dur_zero, dur_start)
        thresh = avg_dur * 1.1
        extrap = sampled
        extrap = extrap + torch.where(dur_start < thresh, dur_start, avg_dur / 2)
        extrap = extrap + torch.where(dur_end < thresh, dur_end, avg_dur / 2)
        scaled = delta * (extrap / sampled)
        if fn == "rate":
            # the reference divides in the accumulator dtype here
            scaled = scaled * (torch.tensor(1000.0, dtype=acc, device=dev)
                               / torch.tensor(window_ms, dtype=acc, device=dev))
        return torch.where(cnt >= 2, scaled, nan)

    raise ValueError(f"range function {fn} is not on the ported grid path")


def grid_operands(C: int, out_ts: np.ndarray, window_ms: int, base_ts: int,
                  interval_ms: int, dtype: torch.dtype, device) -> dict:
    """Static operands for the grid kernels on ``device``, cached per query
    shape (same size bound as the reference: the four [C, T] matrices stay
    cached up to 16 MB, larger ones are built per query)."""
    key = np.ascontiguousarray(np.asarray(out_ts, np.int64)).tobytes()
    args = (C, key, int(window_ms), int(base_ts), int(interval_ms), dtype,
            torch.device(device))
    if 4 * C * len(out_ts) * dtype.itemsize > 16 << 20:
        return _grid_operands_build(*args)
    return _grid_operands_cached(*args)


@functools.lru_cache(maxsize=32)
def _grid_operands_cached(*args):
    return _grid_operands_build(*args)


def _grid_operands_build(C, out_ts_key, window_ms, base_ts, interval_ms,
                         dtype, device):
    out_ts = np.frombuffer(out_ts_key, np.int64)
    npdt = np.float64 if dtype == torch.float64 else np.float32
    lo, hi = grid_edges(out_ts, window_ms, base_ts, interval_ms)
    rel = out_ts - base_ts
    assert abs(rel).max() < 2**31 and window_ms < 2**31, "grid range exceeds i32"

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return dict(
        band=dev(band_matrix(C, lo, hi, False, npdt)),
        band_open=dev(band_matrix(C, lo, hi, True, npdt)),
        onehot_lo=dev(onehot_matrix(C, np.maximum(lo, 0), npdt)),
        onehot_hi=dev(onehot_matrix(C, hi, npdt)),
        lo=dev(lo.astype(np.int32)), hi=dev(hi.astype(np.int32)),
        rel_out=dev(rel.astype(np.int32)),
        window_ms=window_ms, interval_ms=interval_ms,
    )


def periodic_samples_grid(val, n, out_ts: np.ndarray, window_ms: int, fn: str,
                          base_ts: int, interval_ms: int,
                          stale_ms: int = 300_000):
    """Grid-path periodic samples over a uniform-start shard: [S, T] output
    in the store's dtype, NaN where the function is undefined."""
    C = val.shape[1]
    ops = grid_operands(C, out_ts, window_ms, base_ts, interval_ms,
                        val.dtype, val.device)
    return _grid_kernel(fn, val, n, ops, min(stale_ms, 2**31 - 1))


# ---- histograms -------------------------------------------------------------

HIST_GRID_FNS = {"rate", "increase", "delta", "sum_over_time", "last_sample",
                 "last_over_time"}


def _grid_hist_kernel(fn, val, n, ops, stale_ms: int):
    """Histogram variant of :func:`_grid_kernel`: val [S, C, B] cumulative
    bucket counts; outputs [S, T, B]. Buckets share the series' sample
    times, so window edges and the extrapolation factor are computed once
    and broadcast over B; the per-bucket delta rides one product (ref:
    ChunkedRateFunction on HistogramVector — rate/increase per bucket)."""
    S, C, B = val.shape
    acc = val.dtype
    dev = val.device
    lo, hi, rel_out = ops["lo"], ops["hi"], ops["rel_out"]
    window_ms, interval_ms = ops["window_ms"], ops["interval_ms"]
    n = n.to(torch.int32)
    valid = torch.arange(C, dtype=torch.int32, device=dev)[None, :] < n[:, None]
    v = torch.where(valid[:, :, None], val,
                    torch.zeros((), dtype=val.dtype, device=dev)).to(acc)

    last_cell = n[:, None] - 1
    f_idx = torch.clamp(lo, min=0)[None, :]
    l_idx = torch.minimum(hi[None, :], last_cell)
    cnt = torch.clamp(l_idx - f_idx + 1, min=0)                  # [S, T]
    cnt_f = cnt.to(acc)
    nan = float("nan")

    if fn == "sum_over_time":
        s = torch.einsum("scb,ct->stb", v, ops["band"])
        return torch.where((cnt >= 1)[:, :, None], s, nan)

    if fn in ("last_sample", "last_over_time"):
        static_v = torch.einsum("scb,ct->stb", v, ops["onehot_hi"])
        row_last = torch.gather(
            v, 1, torch.clamp(last_cell, 0, C - 1).long()[:, :, None]
            .expand(-1, -1, B))                                  # [S, 1, B]
        l_v = torch.where((hi[None, :] <= last_cell)[:, :, None], static_v,
                          row_last)
        ok = cnt >= 1
        if fn == "last_sample":
            l_rel = l_idx * interval_ms
            ok = ok & ((rel_out[None, :] - l_rel) <= stale_ms)
        return torch.where(ok[:, :, None], l_v, nan)

    if fn in ("rate", "increase", "delta"):
        is_counter = fn != "delta"
        prev = torch.cat([v[:, :1], v[:, :-1]], dim=1)
        pair = valid & torch.cat([torch.zeros_like(valid[:, :1]),
                                  valid[:, :-1]], dim=1)
        raw_inc = torch.where(pair[:, :, None], v - prev, 0.0)
        inc = torch.clamp(raw_inc, min=0.0) if is_counter else raw_inc
        delta = torch.einsum("scb,ct->stb", inc, ops["band_open"])  # [S, T, B]
        f_v = torch.einsum("scb,ct->stb", v, ops["onehot_lo"])
        f_rel = f_idx * interval_ms
        l_rel = l_idx * interval_ms
        win_end = rel_out[None, :]
        dur_start = (f_rel - (win_end - window_ms)).to(acc) / 1000.0
        dur_end = (win_end - l_rel).to(acc) / 1000.0
        sampled = (l_rel - f_rel).to(acc) / 1000.0
        avg_dur = sampled / (cnt_f - 1.0)
        thresh = avg_dur * 1.1
        extrap = sampled
        extrap = extrap + torch.where(dur_start < thresh, dur_start, avg_dur / 2)
        extrap = extrap + torch.where(dur_end < thresh, dur_end, avg_dur / 2)
        factor = (extrap / sampled)[:, :, None]                  # [S, T, 1]
        if is_counter:
            factor = _bucket_clamp_factor(delta, f_v, sampled, dur_start,
                                          dur_end, avg_dur, thresh)
        scaled = delta * factor
        if fn == "rate":
            scaled = scaled * (torch.tensor(1000.0, dtype=acc, device=dev)
                               / torch.tensor(window_ms, dtype=acc, device=dev))
        return torch.where((cnt >= 2)[:, :, None], scaled, nan)

    raise ValueError(f"range function {fn} is not on the histogram grid path")


def _bucket_clamp_factor(delta, f_v, sampled, dur_start, dur_end, avg_dur,
                         thresh):
    """Per-bucket counter zero clamp of the extrapolation (matches the
    per-bucket extrapolatedRate): [S, T, B] factor."""
    dur_zero = torch.where(delta > 0, sampled[:, :, None] * (f_v / delta),
                           float("inf"))
    ds = torch.broadcast_to(dur_start[:, :, None], delta.shape)
    ds = torch.where((delta > 0) & (f_v >= 0) & (dur_zero < ds), dur_zero, ds)
    extrap_b = (sampled[:, :, None]
                + torch.where(ds < thresh[:, :, None], ds,
                              avg_dur[:, :, None] / 2)
                + torch.where(dur_end[:, :, None] < thresh[:, :, None],
                              dur_end[:, :, None], avg_dur[:, :, None] / 2))
    return extrap_b / sampled[:, :, None]


# ---- narrow (2D-delta resident) histograms ----------------------------------
#
# The hist-resident store keeps dd[s,c,b] = (bucket-delta of frame c) minus
# (bucket-delta of frame c-1) as i8/i16 plus first_d[s,b] f32 (ops/narrow.py
# build_narrow_hist). Every time-axis reduction the grid kernels need is
# LINEAR in the frames, so it commutes with the bucket cumsum:
#
#   inc[s,c,:]   = v[s,c,:] - v[s,c-1,:]        = cumsum_b dd[s,c,:]
#   window delta = einsum(inc, band)            = cumsum_b einsum(dd, band)
#   v_ext[s,c,:] = F[s,:] + sum_{c'<=c} inc     (F = cumsum_b first_d,
#                                                constant past the last frame)
#
# so the kernels below multiply the NARROW dd block and run one [S, T, B]
# bucket cumsum on the output — the whole-store f32 block never exists.

def grid_operands_hist_narrow(C: int, out_ts: np.ndarray, window_ms: int,
                              base_ts: int, interval_ms: int, device) -> dict:
    """Static operands for the narrow hist kernel, cached per query shape
    and device: the open band for window deltas, prefix bands selecting
    v_ext at the lo/hi cells, the weighted band W[c, t] = #{window-t cells
    >= c} for sum_over_time, and the static per-step cell count."""
    key = np.ascontiguousarray(np.asarray(out_ts, np.int64)).tobytes()
    args = (C, key, int(window_ms), int(base_ts), int(interval_ms),
            torch.device(device))
    if 4 * C * len(out_ts) * 4 > 16 << 20:
        return _hist_narrow_operands_build(*args)
    return _hist_narrow_operands_cached(*args)


@functools.lru_cache(maxsize=32)
def _hist_narrow_operands_cached(*args):
    return _hist_narrow_operands_build(*args)


def _hist_narrow_operands_build(C, out_ts_key, window_ms, base_ts,
                                interval_ms, device):
    out_ts = np.frombuffer(out_ts_key, np.int64)
    lo, hi = grid_edges(out_ts, window_ms, base_ts, interval_ms)
    rel = out_ts - base_ts
    assert abs(rel).max() < 2**31 and window_ms < 2**31, "grid range exceeds i32"
    T = len(out_ts)
    zeros = np.zeros(T, np.int64)
    l0 = np.maximum(lo, 0)
    h0 = np.minimum(hi, C - 1)
    # W[c, t] = #{cells in [l0_t, h0_t] >= c}; rows past h0 (and empty
    # windows) are 0. Cell 0's weight multiplies a zero dd frame — harmless
    c = np.arange(C)[:, None]
    wband = np.maximum(h0[None, :] - np.maximum(c, l0[None, :]) + 1, 0) \
        .astype(np.float32)
    wband[:, h0 < l0] = 0.0

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return dict(
        band_open=dev(band_matrix(C, lo, hi, True, np.float32)),
        prefix_lo=dev(band_matrix(C, zeros, np.minimum(l0, C - 1), True,
                                  np.float32)),
        prefix_hi=dev(band_matrix(C, zeros, np.clip(hi, 0, C - 1), True,
                                  np.float32)),
        wband=dev(wband),
        cnt_static=dev(np.maximum(h0 - l0 + 1, 0).astype(np.int32)),
        lo=dev(lo.astype(np.int32)), hi=dev(hi.astype(np.int32)),
        rel_out=dev(rel.astype(np.int32)),
        window_ms=window_ms, interval_ms=interval_ms,
    )


def _grid_hist_kernel_narrow(fn, dd, first_d, n, ops, stale_ms: int):
    """Narrow variant of :func:`_grid_hist_kernel`: streams the i8/i16 dd
    block through the static products and finishes with one bucket cumsum
    on the [S, T, B] output (same masks, same extrapolation algebra as the
    raw kernel on rows the encoder verified)."""
    f32 = torch.float32
    dev = dd.device
    lo, hi, rel_out = ops["lo"], ops["hi"], ops["rel_out"]
    window_ms, interval_ms = ops["window_ms"], ops["interval_ms"]
    cnt_static = ops["cnt_static"]
    # bucket-major [S, B, C]: each product lands as [S, B, T], so the
    # bucket cumsum walks an outer dimension (a scan over a 32-long
    # innermost dimension of a permuted product costs ~10x more on the
    # card); every term is an integer, so the sums are exact in any order
    ddt = dd.transpose(1, 2).contiguous().to(f32)

    def bucket_cumsum(band):
        """cumsum_b(dd @ band) as an [S, T, B] view."""
        return torch.cumsum(ddt @ band, dim=1).transpose(1, 2)
    F = torch.cumsum(first_d, dim=1)                              # [S, B]
    n = n.to(torch.int32)
    last_cell = n[:, None] - 1
    f_idx = torch.clamp(lo, min=0)[None, :]
    l_idx = torch.minimum(hi[None, :], last_cell)
    cnt = torch.clamp(l_idx - f_idx + 1, min=0)                  # [S, T]
    cnt_f = cnt.to(f32)
    nan = float("nan")

    if fn == "sum_over_time":
        ext = bucket_cumsum(ops["wband"]) \
            + cnt_static[None, :, None].to(f32) * F[:, None, :]
        # v_ext extends the last frame past each row's valid count: subtract
        # the overhang cells' worth of it to match the raw masked sum
        v_last = F + torch.cumsum(torch.sum(ddt, dim=2), dim=1)  # [S, B]
        over = (cnt_static[None, :] - cnt).to(f32)
        s = ext - over[:, :, None] * v_last[:, None, :]
        return torch.where((cnt >= 1)[:, :, None], s, nan)

    if fn in ("last_sample", "last_over_time"):
        l_v = F[:, None, :] + bucket_cumsum(ops["prefix_hi"])
        # v_ext at cell clip(hi): v[hi] when hi is valid, the row's last
        # frame beyond it — exactly the raw kernel's static/row_last select
        ok = cnt >= 1
        if fn == "last_sample":
            l_rel = l_idx * interval_ms
            ok = ok & ((rel_out[None, :] - l_rel) <= stale_ms)
        return torch.where(ok[:, :, None], l_v, nan)

    if fn in ("rate", "increase", "delta"):
        is_counter = fn != "delta"
        delta = bucket_cumsum(ops["band_open"])
        f_v = F[:, None, :] + bucket_cumsum(ops["prefix_lo"])
        f_rel = f_idx * interval_ms
        l_rel = l_idx * interval_ms
        win_end = rel_out[None, :]
        dur_start = (f_rel - (win_end - window_ms)).to(f32) / 1000.0
        dur_end = (win_end - l_rel).to(f32) / 1000.0
        sampled = (l_rel - f_rel).to(f32) / 1000.0
        avg_dur = sampled / (cnt_f - 1.0)
        thresh = avg_dur * 1.1
        extrap = sampled
        extrap = extrap + torch.where(dur_start < thresh, dur_start, avg_dur / 2)
        extrap = extrap + torch.where(dur_end < thresh, dur_end, avg_dur / 2)
        factor = (extrap / sampled)[:, :, None]
        if is_counter:
            factor = _bucket_clamp_factor(delta, f_v, sampled, dur_start,
                                          dur_end, avg_dur, thresh)
        scaled = delta * factor
        if fn == "rate":
            scaled = scaled * (torch.tensor(1000.0, dtype=f32, device=dev)
                               / torch.tensor(window_ms, dtype=f32, device=dev))
        return torch.where((cnt >= 2)[:, :, None], scaled, nan)

    raise ValueError(f"range function {fn} is not on the histogram grid path")


def _hist_row_chunk(C: int, T: int, B: int, in_bytes: int) -> int:
    """Rows a chunk of the histogram grid path may hold within
    ``rangefns.CHUNK_BYTES`` of transients: the row's block in its stored
    and f32 form, and about 24 [T, B] f32 copies (window deltas, first
    samples, their bucket cumsums, the clamp factor's terms, the output)."""
    per_row = B * (C * (in_bytes + 4) + 24 * T * 4)
    return max(1, rangefns.CHUNK_BYTES // per_row)


def _by_row_chunks(kernel, S: int, T: int, B: int, chunk: int, dtype,
                   device):
    """``kernel(rows)`` over row slices of at most ``chunk`` rows into one
    [S, T, B] output. Every grid function is row-wise, and its products
    only ever sum integer-valued terms for the stored integer counts, so
    the chunks give one chunk's bits."""
    if S <= chunk:
        return kernel(slice(None))
    out = torch.empty((S, T, B), dtype=dtype, device=device)
    for r0 in range(0, S, chunk):
        out[r0:r0 + chunk] = kernel(slice(r0, r0 + chunk))
    return out


def periodic_samples_grid_hist(val, n, out_ts: np.ndarray, window_ms: int,
                               fn: str, base_ts: int, interval_ms: int,
                               stale_ms: int = 300_000):
    """Histogram grid path over a raw [S, C, B] block: [S, T, B] output in
    the block's dtype, NaN where the function is undefined; rows in chunks
    of at most ``rangefns.CHUNK_BYTES`` of transients."""
    S, C, B = val.shape
    ops = grid_operands(C, out_ts, window_ms, base_ts, interval_ms,
                        val.dtype, val.device)
    stale = min(stale_ms, 2**31 - 1)
    T = len(out_ts)
    return _by_row_chunks(
        lambda sl: _grid_hist_kernel(fn, val[sl], n[sl], ops, stale),
        S, T, B, _hist_row_chunk(C, T, B, val.element_size()), val.dtype,
        val.device)


def periodic_samples_grid_hist_narrow(dd, first_d, n, out_ts: np.ndarray,
                                      window_ms: int, fn: str, base_ts: int,
                                      interval_ms: int,
                                      stale_ms: int = 300_000):
    """Narrow hist grid path: [S, T, B] f32 streamed off the i8/i16 dd
    block (the whole-store f32 block never exists); rows in chunks of at
    most ``rangefns.CHUNK_BYTES`` of transients."""
    S, C, B = dd.shape
    ops = grid_operands_hist_narrow(C, out_ts, window_ms, base_ts,
                                    interval_ms, dd.device)
    stale = min(stale_ms, 2**31 - 1)
    T = len(out_ts)
    return _by_row_chunks(
        lambda sl: _grid_hist_kernel_narrow(fn, dd[sl], first_d[sl], n[sl],
                                            ops, stale),
        S, T, B, _hist_row_chunk(C, T, B, dd.element_size()), torch.float32,
        dd.device)


def _quantile_of_groups(q, les, psum, pcnt, num_groups: int, T: int, B: int):
    """Groups with no present sample are NaN, then the f64 quantile."""
    summed = torch.where(pcnt == 0, float("nan"), psum)
    return histogram_quantile(q, les, summed.reshape(num_groups, T, B))


def fused_hist_quantile_grid_narrow(q: float, les, dd, first_d, n, gids,
                                    num_groups: int, out_ts: np.ndarray,
                                    window_ms: int, fn: str, base_ts: int,
                                    interval_ms: int, stale_ms: int = 300_000,
                                    corr=None):
    """histogram_quantile(q, sum by(...) (fn(h[w]))) off a hist-resident
    store's dd block: per-bucket range function, bucket-wise group sum and
    quantile — the route for fns and shapes outside K2's gate. ``corr =
    (sum, cnt)`` carries the cohort-pool rows' partial state ([num_groups,
    T*B]; those rows' gids are excluded here). Returns [G, T] f64."""
    from . import aggregators
    C = dd.shape[1]
    ops = grid_operands_hist_narrow(C, out_ts, window_ms, base_ts,
                                    interval_ms, dd.device)
    hist = _grid_hist_kernel_narrow(fn, dd, first_d, n, ops,
                                    min(stale_ms, 2**31 - 1))
    S, T, B = hist.shape
    parts = aggregators.partial_aggregate("sum", hist.reshape(S, T * B),
                                          gids, num_groups)
    psum, pcnt = parts["sum"], parts["count"]
    if corr is not None:
        psum = psum + corr[0]
        pcnt = pcnt + corr[1]
    return _quantile_of_groups(q, les, psum, pcnt, num_groups, T, B)


def fused_hist_quantile_grid(q: float, les, val, n, gids, num_groups: int,
                             out_ts: np.ndarray, window_ms: int, fn: str,
                             base_ts: int, interval_ms: int,
                             stale_ms: int = 300_000):
    """histogram_quantile(q, sum by(...) (fn(h[w]))) on a grid-aligned raw
    [S, C, B] histogram block: per-bucket range function, bucket-wise group
    sum and the Prometheus quantile as one call. Plain torch ops: it is
    plain ``jnp`` in the JAX package. Returns [G, T] f64."""
    from . import aggregators
    C = val.shape[1]
    ops = grid_operands(C, out_ts, window_ms, base_ts, interval_ms,
                        val.dtype, val.device)
    hist = _grid_hist_kernel(fn, val, n, ops, min(stale_ms, 2**31 - 1))
    S, T, B = hist.shape
    parts = aggregators.partial_aggregate("sum", hist.reshape(S, T * B),
                                          gids, num_groups)
    return _quantile_of_groups(q, les, parts["sum"], parts["count"],
                               num_groups, T, B)


def histogram_quantile(q: float, les, counts):
    """Prometheus histogram_quantile, vectorized: les [B] f64 bucket tops,
    counts [..., B] cumulative -> [...] f64 (ref: Histogram.scala quantile
    :288). The rank and interpolation run in f64 with the bucket counts in
    their own dtype, as in the JAX package under x64: only the count
    difference hi_cnt - lo_cnt is taken in the counts' dtype."""
    f64 = torch.float64
    les = torch.as_tensor(les, dtype=f64, device=counts.device)
    B = les.shape[0]
    total = counts[..., -1]
    rank = total.to(f64) * float(q)
    b = (counts.to(f64) < rank[..., None]).sum(dim=-1)
    b = torch.clamp(b, 0, B - 1)
    bm1 = torch.clamp(b - 1, min=0)
    lo_le = torch.where(b > 0, les[bm1], 0.0)
    hi_le = les[b]
    lo_cnt = torch.where(b > 0, torch.gather(counts, -1, bm1[..., None])[..., 0],
                         0.0)
    hi_cnt = torch.gather(counts, -1, b[..., None])[..., 0]
    frac = torch.where(hi_cnt > lo_cnt,
                       (rank - lo_cnt.to(f64)) / (hi_cnt - lo_cnt).to(f64),
                       1.0)
    res = lo_le + (hi_le - lo_le) * frac
    # +Inf top bucket: clamp to the highest finite bound
    res = torch.where(torch.isinf(hi_le),
                      torch.where(b > 0, les[bm1], float("nan")), res)
    res = torch.where((total > 0) & ~torch.isnan(total), res, float("nan"))
    if q < 0:
        res = torch.full_like(res, float("-inf"))
    elif q > 1:
        res = torch.full_like(res, float("inf"))
    return res
