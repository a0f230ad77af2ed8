"""Window-edge machinery of the general (off-grid) range functions.

Port of the parts of ``filodb_tpu/ops/windows.py`` the rate family and the
sum/avg/count_over_time functions use. For P series and T output steps all
P*T window edges come from one batched binary search; window sums come from
exclusive prefix sums — no per-sample iteration.

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
