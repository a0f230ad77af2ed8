"""Range functions (PeriodicSamplesMapper kernels): all series x all output
steps at once.

Port of ``filodb_tpu/ops/rangefns.py`` (reference semantics:
query/.../exec/rangefn/RateFunctions.scala, Prometheus extrapolatedRate;
AggrOverTimeFunctions.scala, the *_over_time functions incl. accurate
stddev/stdvar; RangeFunction.scala:38-226). A window for output step t
covers sample timestamps in [t - window, t]. Output is [P, T] f64 with NaN
where the function is undefined; presenters drop NaN points.

The general path takes any timestamp layout; the engine uses it for
off-grid stores, for the churned minority rows of a grid-aligned one and
for the functions the grid path does not have. It evaluates rows in chunks
of at most ``CHUNK_BYTES`` of transients: every function is row-wise, so
the answer does not depend on the chunking, and a whole-store query (2^20
rows) never holds more than a chunk's [rows, T, w] window gathers at once.
"""

from __future__ import annotations

import numpy as np
import torch

from . import windows as W

RANGE_FNS = [
    "rate", "increase", "delta", "irate", "idelta",
    "sum_over_time", "count_over_time", "avg_over_time", "min_over_time",
    "max_over_time", "stddev_over_time", "stdvar_over_time", "last_over_time",
    "changes", "resets", "deriv", "predict_linear", "quantile_over_time",
    "holt_winters", "last_sample",
]

# functions that gather up to w_cap window samples per (row, step)
_GATHER_FNS = {"quantile_over_time", "holt_winters"}

# transient bytes one row chunk of the general path may take
CHUNK_BYTES = 1 << 31


def _extrapolated(out_ts, window_ms, first_t, first_v, last_t, last_v, cnt,
                  is_counter: bool, is_rate: bool, acc=torch.float64):
    """Prometheus extrapolatedRate, vectorized. ``first_t``/``last_t`` are
    int64 epoch ms: time arithmetic stays integer and only the small
    differences are cast to ``acc``."""
    win_start = out_ts[None, :] - window_ms
    win_end = out_ts[None, :]
    dur_start = (first_t - win_start).to(acc) / 1000.0
    dur_end = (win_end - last_t).to(acc) / 1000.0
    sampled = (last_t - first_t).to(acc) / 1000.0
    avg_dur = sampled / (cnt - 1.0)
    delta = last_v - first_v
    if is_counter:
        dur_zero = torch.where(delta > 0, sampled * (first_v / delta),
                               float("inf"))
        dur_start = torch.where((delta > 0) & (first_v >= 0)
                                & (dur_zero < dur_start), dur_zero, dur_start)
    thresh = avg_dur * 1.1
    extrap = sampled
    extrap = extrap + torch.where(dur_start < thresh, dur_start, avg_dur / 2)
    extrap = extrap + torch.where(dur_end < thresh, dur_end, avg_dur / 2)
    scaled = delta * (extrap / sampled)
    if is_rate:
        scaled = scaled / ((win_end - win_start).to(acc) / 1000.0)
    return torch.where(cnt >= 2, scaled, float("nan"))


def _linreg_sums(ts, fval, valid, left, right, t0):
    """Window sums for the least-squares line v = a + b * t_rel over
    (t_rel seconds since ``t0``, value): (count, slope, intercept)."""
    f64 = torch.float64
    t_rel = torch.where(valid, (ts - t0).to(f64) / 1000.0, 0.0)
    s_t = W.window_sum(W.prefix_sum(t_rel, valid), left, right)
    s_t2 = W.window_sum(W.prefix_sum(t_rel * t_rel, valid), left, right)
    s_v = W.window_sum(W.prefix_sum(fval, valid), left, right)
    s_tv = W.window_sum(W.prefix_sum(t_rel * fval, valid), left, right)
    cnt = (right - left).to(f64)
    denom = cnt * s_t2 - s_t * s_t
    slope = torch.where(denom != 0, (cnt * s_tv - s_t * s_v) / denom,
                        float("nan"))
    intercept = (s_v - slope * s_t) / cnt
    return cnt, slope, intercept


def _periodic(fn, ts, val, valid, left, right, out_ts, window_ms: int,
              arg0: float = 0.0, arg1: float = 0.0, w_cap: int = 256):
    """One range function over [P, C] rows with precomputed window edges."""
    acc = torch.float64
    nan = float("nan")
    cnt_i = right - left
    cnt = cnt_i.to(acc)
    fval = torch.where(valid, val, 0).to(acc)

    if fn in ("rate", "increase", "delta"):
        if fn != "delta":
            # window-relative correction: the first sample stays raw; the
            # last carries only the resets inside the window
            corr = W.counter_correct(val, valid, dtype=acc) - fval
            f_v = W.take(fval, left)
            l_v = (W.take(fval, right - 1)
                   + (W.take(corr, right - 1) - W.take(corr, left)))
        else:
            f_v = W.take(fval, left)
            l_v = W.take(fval, right - 1)
        f_t = W.take(ts, left)
        l_t = W.take(ts, right - 1)
        return _extrapolated(out_ts, window_ms, f_t, f_v, l_t, l_v, cnt,
                             fn != "delta", fn == "rate", acc)

    if fn in ("irate", "idelta"):
        i2, i1 = right - 1, right - 2
        v2, v1 = W.take(fval, i2), W.take(fval, i1)
        if fn == "irate":
            dt = (W.take(ts, i2) - W.take(ts, i1)).to(acc)
            # a reset between the last two samples: the counter restarted
            res = torch.where(v2 >= v1, v2 - v1, v2) / (dt / 1000.0)
        else:
            res = v2 - v1
        return torch.where(cnt_i >= 2, res, nan)

    if fn == "count_over_time":
        return torch.where(cnt_i >= 1, cnt, nan)

    if fn in ("sum_over_time", "avg_over_time"):
        s = W.window_sum(W.prefix_sum(fval, valid, dtype=acc), left, right)
        if fn == "avg_over_time":
            s = s / cnt
        return torch.where(cnt_i >= 1, s, nan)

    if fn in ("min_over_time", "max_over_time"):
        r = W.window_minmax(fval, valid, left, right,
                            "min" if fn == "min_over_time" else "max")
        return torch.where(cnt_i >= 1, r, nan)

    if fn in ("stddev_over_time", "stdvar_over_time"):
        # centre each row first: variance is shift-invariant, and centring
        # removes the E[x^2] - E[x]^2 cancellation (constant windows give 0)
        nvalid = torch.clamp(valid.sum(dim=1), min=1)
        row_mean = (torch.where(valid, fval, 0.0).sum(dim=1) / nvalid)[:, None]
        cv = torch.where(valid, fval - row_mean, 0.0)
        s = W.window_sum(W.prefix_sum(cv, valid, dtype=acc), left, right)
        s2 = W.window_sum(W.prefix_sum(cv * cv, valid, dtype=acc), left,
                          right)
        mean = s / cnt
        var = torch.clamp(s2 / cnt - mean * mean, min=0.0)
        var = torch.where(cnt_i <= 1, 0.0, var)   # one sample: no spread
        r = var if fn == "stdvar_over_time" else torch.sqrt(var)
        return torch.where(cnt_i >= 1, r, nan)

    if fn in ("last_over_time", "last_sample"):
        l_v = W.take(fval, right - 1)
        ok = cnt_i >= 1
        if fn == "last_sample":
            # staleness: the last sample must lie within arg0 ms of the step
            age = (out_ts[None, :] - W.take(ts, right - 1)).to(acc)
            ok = ok & (age <= arg0)
        return torch.where(ok, l_v, nan)

    if fn in ("changes", "resets"):
        prev = torch.cat([fval[:, :1], fval[:, :-1]], dim=1)
        pair_ok = valid & torch.cat([torch.zeros_like(valid[:, :1]),
                                     valid[:, :-1]], dim=1)
        ind = pair_ok & ((fval != prev) if fn == "changes" else (fval < prev))
        pfx = W.prefix_sum(ind.to(acc), torch.ones_like(valid), dtype=acc)
        c = W.take(pfx, right) - W.take(pfx, torch.minimum(left + 1, right))
        return torch.where(cnt_i >= 1, c, nan)

    if fn in ("deriv", "predict_linear"):
        t0 = out_ts[0] - window_ms
        cnt_r, slope, intercept = _linreg_sums(ts, fval, valid, left, right,
                                               t0)
        if fn == "deriv":
            return torch.where(cnt_r >= 2, slope, nan)
        # the intercept is at t_rel = 0 (t0); predict at out_ts + arg0 s
        t_pred = (out_ts[None, :] - t0).to(acc) / 1000.0 + arg0
        return torch.where(cnt_r >= 2, intercept + slope * t_pred, nan)

    if fn == "quantile_over_time":
        vals, mask = W.gather_windows(ts, fval, valid, left, right, w_cap)
        svals = torch.sort(vals, dim=2).values        # NaN fill sorts last
        k = mask.sum(dim=2).to(acc)
        rank = arg0 * (k - 1.0)
        lo = torch.clamp(torch.floor(rank).to(torch.int64), 0, w_cap - 1)
        hi = torch.clamp(lo + 1, 0, w_cap - 1)
        frac = rank - lo
        v_lo = torch.gather(svals, 2, lo[:, :, None])[:, :, 0]
        v_hi = torch.gather(svals, 2, hi[:, :, None])[:, :, 0]
        v_hi = torch.where(hi.to(acc) > (k - 1), v_lo, v_hi)
        r = v_lo + (v_hi - v_lo) * frac
        return torch.where(cnt_i >= 1, r, nan)

    if fn == "holt_winters":
        # double exponential smoothing (ref HoltWinters in RangeFunction.scala;
        # Prometheus holt_winters): s = x0, b = x1 - x0, then a level/trend
        # step over window slots 1 .. w_cap-1, masked past the window
        vals, mask = W.gather_windows(ts, fval, valid, left, right, w_cap,
                                      fill=0.0)
        sf, tf = arg0, arg1
        v0 = vals[:, :, 0]
        v1 = torch.where(mask[:, :, 1], vals[:, :, 1], v0)
        s, b = v0, v1 - v0
        for j in range(1, w_cap):
            x, m = vals[:, :, j], mask[:, :, j]
            s_new = sf * x + (1 - sf) * (s + b)
            b_new = tf * (s_new - s) + (1 - tf) * b
            s = torch.where(m, s_new, s)
            b = torch.where(m, b_new, b)
        return torch.where(cnt_i >= 2, s, nan)

    raise ValueError(f"unknown range function {fn}")


def _row_chunk(fn: str, C: int, T: int, w_cap: int) -> int:
    """Rows a chunk of the general path may hold within CHUNK_BYTES: about
    16 f64 copies of a row, plus the window gathers' [T, w] f64 and index
    copies (w = w_cap for the gather functions, 32 for min/max)."""
    width = (w_cap if fn in _GATHER_FNS
             else 32 if fn in ("min_over_time", "max_over_time") else 1)
    per_row = 8 * (16 * C + 6 * T * width)
    return max(1, CHUNK_BYTES // per_row)


def periodic_samples(ts, val, n, out_ts, window_ms, fn: str,
                     arg0: float = 0.0, arg1: float = 0.0, w_cap: int = 256):
    """Evaluate range function ``fn`` for every series row at every output
    step. ts/val/n: store tensors already gathered to the selected rows
    (see windows.py); out_ts: int64 [T]; ``window_ms``: the range window
    (for ``last_sample`` the staleness lookback, also passed as ``arg0``).
    Returns f64 [P, T], NaN where the function is undefined."""
    if fn not in RANGE_FNS:
        raise ValueError(f"unknown range function {fn}")
    dev = val.device
    ts = torch.as_tensor(ts, device=dev)
    n = torch.as_tensor(n, device=dev)
    out_ts = torch.as_tensor(np.asarray(out_ts, np.int64), device=dev)
    window_ms, arg0, arg1 = int(window_ms), float(arg0), float(arg1)

    def rows(sl):
        t, v = ts[sl], val[sl]
        valid = W.valid_mask(t, n[sl])
        left, right = W.window_edges(t, out_ts, window_ms)
        return _periodic(fn, t, v, valid, left, right, out_ts, window_ms,
                         arg0, arg1, w_cap)

    P, C = val.shape
    chunk = _row_chunk(fn, C, len(out_ts), w_cap)
    if P <= chunk:
        return rows(slice(None))
    out = torch.empty((P, len(out_ts)), dtype=torch.float64, device=dev)
    for r0 in range(0, P, chunk):
        out[r0:r0 + chunk] = rows(slice(r0, r0 + chunk))
    return out


HIST_FNS = ("rate", "increase", "delta", "sum_over_time", "last_sample",
            "last_over_time")


def periodic_samples_hist(ts, val, n, out_ts, window_ms, fn: str,
                          arg0: float = 0.0):
    """General (off-grid) histogram range functions: val [P, C, B]
    cumulative bucket counts -> [P, T, B] f64, any timestamp layout.

    Buckets share their series' timestamps, so the window edges are
    computed once; the scalar function then runs over all buckets at once
    as [P*B, C] rows, each bucket a row of its own (the reference vmaps it
    over the bucket axis). ``arg0`` is ``last_sample``'s staleness bound,
    as in the reference."""
    if fn not in HIST_FNS:
        raise ValueError(f"{fn} not supported on histograms")
    dev = val.device
    P, C, B = val.shape
    ts = torch.as_tensor(ts, device=dev)
    n = torch.as_tensor(n, device=dev)
    out_ts = torch.as_tensor(np.asarray(out_ts, np.int64), device=dev)
    valid = W.valid_mask(ts, n)
    left, right = W.window_edges(ts, out_ts, int(window_ms))

    def per_bucket(x):
        return x.repeat_interleave(B, dim=0)
    out = _periodic(fn, per_bucket(ts), val.permute(0, 2, 1).reshape(P * B, C),
                    per_bucket(valid), per_bucket(left), per_bucket(right),
                    out_ts, int(window_ms), float(arg0))
    return out.reshape(P, B, -1).permute(0, 2, 1)
