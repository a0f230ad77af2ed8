"""Grid fast path: range functions as band products over a grid-aligned store.

Port of the scalar half of ``filodb_tpu/ops/gridfns.py``. When every live
series has sample k at timestamp base + k * interval, window edges are
closed-form grid cells and window reductions are [S, C] x [C, T] products
with static 0/1 band matrices (the host builders below). The slice ports the
functions of the fused tier: rate/increase/delta and sum/avg/count_over_time;
``periodic_samples_grid`` is what an un-aggregated ``rate(m[5m])`` (or a
group count above the fused cap) materializes through. The products run
through ``torch.matmul`` in full f32, as the JAX package left them to XLA.

Reference behaviour: query/.../exec/rangefn/ + RateFunctions.scala.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# the reference's grid functions this slice ports (last_sample and
# last_over_time come with the instant-selector slice)
GRID_FNS = {"rate", "increase", "delta", "sum_over_time", "count_over_time",
            "avg_over_time"}


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


def _grid_kernel(fn, val, n, ops):
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
    """Static operands for :func:`_grid_kernel` on ``device``, cached per
    query shape (same size bound as the reference: three [C, T] matrices of
    up to 16 MB stay cached, larger ones are built per query)."""
    key = np.ascontiguousarray(np.asarray(out_ts, np.int64)).tobytes()
    args = (C, key, int(window_ms), int(base_ts), int(interval_ms), dtype,
            torch.device(device))
    if 3 * C * len(out_ts) * dtype.itemsize > 16 << 20:
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
        lo=dev(lo.astype(np.int32)), hi=dev(hi.astype(np.int32)),
        rel_out=dev(rel.astype(np.int32)),
        window_ms=window_ms, interval_ms=interval_ms,
    )


def periodic_samples_grid(val, n, out_ts: np.ndarray, window_ms: int, fn: str,
                          base_ts: int, interval_ms: int):
    """Grid-path periodic samples over a uniform-start shard: [S, T] output
    in the store's dtype, NaN where the function is undefined."""
    C = val.shape[1]
    ops = grid_operands(C, out_ts, window_ms, base_ts, interval_ms,
                        val.dtype, val.device)
    return _grid_kernel(fn, val, n, ops)
