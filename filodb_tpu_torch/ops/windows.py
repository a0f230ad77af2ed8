"""Window-edge machinery of the general (off-grid) range functions.

Port of ``filodb_tpu/ops/windows.py``. For P series and T output steps all
P*T window edges come from one batched binary search; window sums come from
exclusive prefix sums, min/max from two-level block aggregates, and the
order-statistic functions from a gather of up to ``w_cap`` window samples —
no per-sample iteration.

Conventions:
  - ``ts``  int64 [P, C] sorted per row, padded with TS_PAD
  - ``val`` float [P, C]; entries beyond a row's count are masked via ``valid``
  - a window for output step t covers sample timestamps in [t - window_ms, t]
  - ``left``/``right`` [P, T] index the half-open sample range [left, right)
"""

from __future__ import annotations

import torch


def valid_mask(ts, n):
    """[P, C] bool: which sample slots hold real data."""
    C = ts.shape[1]
    return torch.arange(C, device=ts.device)[None, :] < n[:, None]


def window_edges(ts, out_ts, window_ms):
    """(left, right) [P, T] half-open sample index ranges per output step."""
    P = ts.shape[0]
    ts = ts.contiguous()
    hi = out_ts[None, :].expand(P, -1).contiguous()
    right = torch.searchsorted(ts, hi, side="right")
    left = torch.searchsorted(ts, hi - window_ms, side="left")
    return left, right


def take(arr, idx):
    """Gather arr[p, idx[p, t]] -> [P, T] (idx clipped to the valid range)."""
    return torch.gather(arr, 1, torch.clamp(idx, 0, arr.shape[1] - 1))


def prefix_sum(x, valid, dtype=torch.float64):
    """Exclusive prefix sums: out[:, j] = sum(x[:, :j]); shape [P, C+1]."""
    xz = torch.where(valid, x, 0).to(dtype)
    cs = torch.cumsum(xz, dim=1)
    zero = torch.zeros((x.shape[0], 1), dtype=dtype, device=x.device)
    return torch.cat([zero, cs], dim=1)


def window_sum(pfx, left, right):
    """Sum over [left, right) from an exclusive prefix-sum table."""
    return take(pfx, right) - take(pfx, left)


def counter_correct(val, valid, dtype=torch.float64):
    """Cumulative counter-reset correction along the time axis:
    corr[j] = sum of drops (prev - cur when cur < prev) up to j, so the
    corrected values are monotonic and window deltas exact."""
    v = torch.where(valid, val, 0).to(dtype)
    prev = torch.cat([v[:, :1], v[:, :-1]], dim=1)
    pair_valid = valid & torch.cat([torch.zeros_like(valid[:, :1]),
                                    valid[:, :-1]], dim=1)
    drop = torch.where(pair_valid, torch.clamp(prev - v, min=0), 0)
    return v + torch.cumsum(drop, dim=1)


# ---- two-level block aggregates for min/max ---------------------------------

def block_agg(val, valid, block: int, op: str):
    """Per-block aggregates [P, C // block] (C must be a multiple of block)."""
    P, C = val.shape
    neutral = float("inf") if op == "min" else float("-inf")
    v = torch.where(valid, val, neutral).reshape(P, C // block, block)
    return v.amin(dim=2) if op == "min" else v.amax(dim=2)


def window_minmax(val, valid, left, right, op: str, block: int = 32):
    """Min/max over [left, right) via edge gathers + full-block reduce:
    work per output step is 2 * block + C / block elements instead of the
    window's length."""
    P, C = val.shape
    if C % block:
        # pad to a block multiple with invalid cells (neutral under the
        # reduce); windows never index past right <= C
        pad = (-C) % block
        val = torch.cat([val, val.new_zeros((P, pad))], dim=1)
        valid = torch.cat([valid, valid.new_zeros((P, pad))], dim=1)
        C += pad
    nb = C // block
    neutral = float("inf") if op == "min" else float("-inf")

    def red(x, dim):
        return x.amin(dim=dim) if op == "min" else x.amax(dim=dim)
    both = torch.minimum if op == "min" else torch.maximum
    blocks = block_agg(val, valid, block, op)                     # [P, NB]

    lb = -torch.div(-left, block, rounding_mode="floor")  # first full block
    rb = torch.div(right, block, rounding_mode="floor")   # end of full blocks

    # full blocks in [lb, rb)
    bidx = torch.arange(nb, device=val.device)[None, None, :]
    bmask = (bidx >= lb[:, :, None]) & (bidx < rb[:, :, None])
    acc = red(torch.where(bmask, blocks[:, None, :], neutral), 2)  # [P, T]

    vv = torch.where(valid, val, neutral)
    off = torch.arange(block, device=val.device)[None, None, :]

    # left partial edge: [l, min(lb * B, r))
    le_end = torch.minimum(lb * block, right)
    li = left[:, :, None] + off
    lpart = red(torch.where(li < le_end[:, :, None], _gather3(vv, li, C),
                            neutral), 2)

    # right partial edge: [max(rb * B, l), r)
    re_start = torch.maximum(rb * block, left)
    ri = re_start[:, :, None] + off
    rpart = red(torch.where(ri < right[:, :, None], _gather3(vv, ri, C),
                            neutral), 2)
    return both(both(acc, lpart), rpart)


def _gather3(vv, idx, C):
    """vv [P, C], idx [P, T, B] -> [P, T, B]."""
    P, T, B = idx.shape
    flat = torch.clamp(idx, 0, C - 1).reshape(P, T * B)
    return torch.gather(vv, 1, flat).reshape(P, T, B)


def gather_windows(ts, val, valid, left, right, w_cap: int,
                   fill=float("nan")):
    """Materialize up to ``w_cap`` window samples per step: values
    [P, T, W] with ``fill`` beyond the window. Used by the order-statistic
    and sequential functions (quantile_over_time, holt_winters), where no
    prefix structure applies."""
    P, C = val.shape
    off = torch.arange(w_cap, device=val.device)[None, None, :]
    idx = left[:, :, None] + off
    mask = idx < right[:, :, None]
    vals = _gather3(torch.where(valid, val, fill), idx, C)
    return torch.where(mask, vals, fill), mask
