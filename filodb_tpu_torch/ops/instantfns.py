"""Instant functions applied element-wise to [P, T] matrices.

Port of ``filodb_tpu/ops/instantfns.py`` (ref: query/.../exec/rangefn/
InstantFunction.scala, abs..year; the date functions read the sample value
as epoch *seconds*, as Prometheus does). NaN marks a missing sample and
propagates through every function.
"""

from __future__ import annotations

import torch

_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)


def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _civil_from_days(z):
    """days since epoch -> (year, month [1-12], day [1-31]); Howard
    Hinnant's civil_from_days in integer arithmetic."""
    z = z + 719468
    era = _floordiv(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097
    yoe = _floordiv(doe - _floordiv(doe, 1460) + _floordiv(doe, 36524)
                    - _floordiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _floordiv(yoe, 4) - _floordiv(yoe, 100))
    mp = _floordiv(5 * doy + 2, 153)
    d = doy - _floordiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y, m, d


def _to_int64(values):
    """Whole seconds, truncated toward zero, saturating at the int64 range
    as the reference's conversion does (+-Inf and out-of-range values map
    to the range's ends). The cast of a value outside the range is not
    defined the same way on every device, so those are set before it."""
    over = values >= 2.0 ** 63
    under = values < -(2.0 ** 63)
    safe = torch.where(over | under, 0.0, values)
    secs = safe.to(torch.int64)
    secs = torch.where(over, _I64_MAX, secs)
    return torch.where(under, _I64_MIN, secs)


def _ymd(values):
    secs = _to_int64(values)
    return _civil_from_days(_floordiv(secs, 86400)), secs


def days_in_month(y, m):
    feb = torch.where((torch.remainder(y, 4) == 0)
                      & ((torch.remainder(y, 100) != 0)
                         | (torch.remainder(y, 400) == 0)), 29, 28)
    lengths = torch.tensor([31, 0, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
                           dtype=torch.int64, device=m.device)
    return torch.where(m == 2, feb, lengths[m - 1])


def apply(fn: str, values, args: tuple[float, ...] = ()):
    """values: [P, T] float tensor (NaN = missing, propagates through every
    fn)."""
    nanmask = torch.isnan(values)

    def keep_nan(r):
        return torch.where(nanmask, float("nan"), r.to(torch.float64))

    if fn == "abs":
        return torch.abs(values)
    if fn == "ceil":
        return torch.ceil(values)
    if fn == "floor":
        return torch.floor(values)
    if fn == "exp":
        return torch.exp(values)
    if fn == "ln":
        return torch.log(values)
    if fn == "log10":
        return torch.log10(values)
    if fn == "log2":
        return torch.log2(values)
    if fn == "sqrt":
        return torch.sqrt(values)
    if fn == "round":
        nearest = args[0] if args else 1.0
        # Prometheus: floor(v / nearest + 0.5) * nearest (round half up)
        return torch.floor(values / nearest + 0.5) * nearest
    if fn == "clamp_max":
        return torch.clamp(values, max=args[0])
    if fn == "clamp_min":
        return torch.clamp(values, min=args[0])
    if fn in ("days_in_month", "day_of_month", "day_of_week", "hour", "minute",
              "month", "year"):
        vals = torch.where(nanmask, 0.0, values.to(torch.float64))
        (y, m, d), secs = _ymd(vals)
        if fn == "year":
            return keep_nan(y)
        if fn == "month":
            return keep_nan(m)
        if fn == "day_of_month":
            return keep_nan(d)
        if fn == "day_of_week":
            # 1970-01-01 was a Thursday
            return keep_nan(torch.remainder(_floordiv(secs, 86400) + 4, 7))
        if fn == "hour":
            return keep_nan(_floordiv(torch.remainder(secs, 86400), 3600))
        if fn == "minute":
            return keep_nan(_floordiv(torch.remainder(secs, 3600), 60))
        return keep_nan(days_in_month(y, m))
    raise ValueError(f"unknown instant function {fn}")
