"""Range functions of the general path: all series x all output steps at once.

Port of ``filodb_tpu/ops/rangefns.py`` for the functions this slice
serves: rate, increase, delta (Prometheus extrapolatedRate, ref
RateFunctions.scala:37-80) and sum/avg/count_over_time. The general path
takes any timestamp layout; the engine uses it for off-grid stores and for
the churned minority rows of a grid-aligned one. Accumulation is f64, and
results are [P, T] f64 with NaN where the function is undefined.
"""

from __future__ import annotations

import numpy as np
import torch

from . import windows as W

PORTED_FNS = ("rate", "increase", "delta", "sum_over_time",
              "count_over_time", "avg_over_time")


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


def periodic_samples(ts, val, n, out_ts, window_ms, fn: str):
    """Evaluate range function ``fn`` for every series row at every output
    step. ts/val/n: store tensors already gathered to the selected rows
    (see windows.py); out_ts: int64 [T]. Returns f64 [P, T], NaN where the
    function is undefined."""
    if fn not in PORTED_FNS:
        raise ValueError(f"range function {fn} is not on the ported path")
    acc = torch.float64
    dev = val.device
    ts = torch.as_tensor(ts, device=dev)
    n = torch.as_tensor(n, device=dev)
    out_ts = torch.as_tensor(np.asarray(out_ts, np.int64), device=dev)
    valid = W.valid_mask(ts, n)
    left, right = W.window_edges(ts, out_ts, int(window_ms))
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
        return _extrapolated(out_ts, int(window_ms), f_t, f_v, l_t, l_v, cnt,
                             fn != "delta", fn == "rate", acc)

    if fn == "count_over_time":
        return torch.where(cnt_i >= 1, cnt, float("nan"))

    s = W.window_sum(W.prefix_sum(fval, valid, dtype=acc), left, right)
    if fn == "avg_over_time":
        s = s / cnt
    return torch.where(cnt_i >= 1, s, float("nan"))
