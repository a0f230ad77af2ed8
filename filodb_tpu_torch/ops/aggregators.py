"""Cross-series aggregation: the map/reduce over [P, T] result matrices.

Port of ``filodb_tpu/ops/aggregators.py`` (ref: query/.../exec/
AggrOverRangeVectors.scala, RowAggregator map -> reduce -> present).
Grouping labels resolve host-side to dense group ids [P]; the map phase is
one group-sum per partial over the series axis. Partial state is combinable
across shards. The order statistics: a mergeable log-bucket quantile sketch
(counted on the device, presented on the host), and the full-matrix
top-k mask and exact group quantile over a (group, value) stable sort.

NaN convention: NaN marks a missing sample; aggregates exclude NaN and emit
NaN for groups with no present samples at a step.
"""

from __future__ import annotations

import numpy as np
import torch

BASIC_OPS = ("sum", "min", "max", "avg", "count", "stddev", "stdvar", "group")

MATMUL_GROUP_LIMIT = 64   # one-hot [G, S] product reduce up to this many groups


def partial_aggregate(op: str, values, group_ids, num_groups: int,
                      stable: bool = False):
    """Map phase: per-group partial state tensors, each [G, T].

    Small group counts ride a one-hot [G, S] product; ``stable=True`` (and
    large G) folds rows with ``index_add_`` instead — the reference's
    segment_sum, which the composed two-step path uses so its result does
    not depend on the padded step bucket. That fold sums in f64 and rounds
    once to the values' dtype: on the card it has no fixed row order."""
    present = ~torch.isnan(values)
    zeroed = torch.where(present, values, 0.0)
    acc = (values.dtype if values.dtype in (torch.float32, torch.float64)
           else torch.float64)
    gids = group_ids.to(device=values.device, dtype=torch.int64)
    # rows whose group id lies outside [0, G) contribute nothing (the
    # reference's segment ops drop them; a one-hot column of zeros does the
    # same): the scatters send them to a spare group G that is cut off
    gids_in = torch.where((gids >= 0) & (gids < num_groups), gids,
                          num_groups)

    if not stable and num_groups <= MATMUL_GROUP_LIMIT:
        onehot = (gids[None, :] == torch.arange(
            num_groups, device=values.device)[:, None]).to(acc)   # [G, S]

        def gsum(x, wide=True):
            return onehot @ x.to(acc)
    else:
        # index_add_ folds the rows in no fixed order on the card: value
        # sums run in f64 and round once to ``acc``, so an f32 group of
        # 10^5 rows keeps f32's precision whatever the order (an f32 fold
        # of 2^17 rates is off by ~1e-4 of the sum); counts are integers,
        # exact in ``acc``
        def gsum(x, wide=True):
            dt = torch.float64 if wide else acc
            out = torch.zeros((num_groups + 1,) + tuple(x.shape[1:]),
                              dtype=dt, device=x.device)
            return out.index_add_(0, gids_in, x.to(dt))[:num_groups].to(acc)

    def gext(x, fill, reduce):
        idx = gids_in[:, None].expand_as(x)
        out = torch.full((num_groups + 1,) + tuple(x.shape[1:]), fill,
                         dtype=acc, device=x.device)
        return out.scatter_reduce_(0, idx, x.to(acc), reduce=reduce,
                                   include_self=True)[:num_groups]

    cnt = gsum(present.to(acc), wide=False)
    if op in ("count", "group"):
        return {"count": cnt}
    if op in ("sum", "avg"):
        return {"sum": gsum(zeroed), "count": cnt}
    if op == "min":
        v = torch.where(present, values, float("inf"))
        return {"min": gext(v, float("inf"), "amin"), "count": cnt}
    if op == "max":
        v = torch.where(present, values, float("-inf"))
        return {"max": gext(v, float("-inf"), "amax"), "count": cnt}
    if op in ("stddev", "stdvar"):
        return {"sum": gsum(zeroed), "sumsq": gsum(zeroed * zeroed),
                "count": cnt}
    raise ValueError(f"not a basic segment op: {op}")


def resolve_partials(parts):
    """Normalize a partials carrier: a lazily-fetched device bundle (e.g.
    fusedgrid.PaddedPartials) resolves to its host dict here — at present/
    merge time, outside any shard lock."""
    return parts.resolve() if hasattr(parts, "resolve") else parts


def host_partials(d: dict) -> dict:
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in d.items()}


def combine_partials(op: str, a, b) -> dict:
    """Reduce phase across shards or row batches. Device partials stay on
    the device; a mix of host and device partials finishes on the host."""
    a, b = resolve_partials(a), resolve_partials(b)
    on_device = all(isinstance(v, torch.Tensor)
                    for d in (a, b) for v in d.values())
    if not on_device:
        a, b = host_partials(a), host_partials(b)
    lib = torch if on_device else np
    out = {}
    for k in a:
        if k == "min":
            out[k] = lib.minimum(a[k], b[k])
        elif k == "max":
            out[k] = lib.maximum(a[k], b[k])
        else:
            out[k] = a[k] + b[k]
    return out


def present_partials(op: str, parts):
    """Present phase: partial state -> final [G, T] values (NaN where empty).
    Works on host (numpy) and device (torch) partials alike."""
    parts = resolve_partials(parts)
    cnt = parts["count"]
    nan = float("nan")
    if isinstance(cnt, torch.Tensor):
        where, sqrt, ones = torch.where, torch.sqrt, torch.ones_like

        def relu(x):
            return torch.clamp(x, min=0.0)
    else:
        where, sqrt, ones = np.where, np.sqrt, np.ones_like

        def relu(x):
            return np.maximum(x, 0.0)
    empty = cnt == 0
    cnt = where(empty, 1.0, cnt)   # avoid 0/0 noise; result masked below
    if op == "count":
        return where(empty, nan, cnt)
    if op == "group":
        return where(empty, nan, ones(cnt))
    if op == "sum":
        return where(empty, nan, parts["sum"])
    if op == "min":
        return where(empty, nan, parts["min"])
    if op == "max":
        return where(empty, nan, parts["max"])
    if op == "avg":
        return where(empty, nan, parts["sum"] / cnt)
    if op in ("stddev", "stdvar"):
        mean = parts["sum"] / cnt
        with np.errstate(invalid="ignore", divide="ignore"):
            var = relu(parts["sumsq"] / cnt - mean * mean)
            r = var if op == "stdvar" else sqrt(var)
        return where(empty, nan, r)
    raise ValueError(op)


# ---- mergeable quantile sketch (ref: AggrOverRangeVectors quantile uses a
# t-digest; this shape is a DDSketch-style log-bucketed histogram: fixed
# [G, W, T] count tensors that merge exactly by addition and bound the
# RELATIVE error of the presented quantile by (gamma-1)/(gamma+1)) ---------

SKETCH_GAMMA = 1.04            # rel. error (gamma-1)/(gamma+1) ~ 1.96%
SKETCH_MIN = 1e-12             # values below collapse into the zero bucket
SKETCH_BUCKETS = 2048          # per sign: covers 1e-12 .. ~7e22 at gamma=1.04
# layout: [0..B) negative buckets (mirrored, descending magnitude),
#         [B] zero, (B..2B] positive buckets
SKETCH_WIDTH = 2 * SKETCH_BUCKETS + 1


def quantile_sketch(values, group_ids, num_groups: int):
    """Map phase: [P, T] values -> [G, W, T] f32 log-bucket counts on the
    values' device. Mergeable across shards by addition; NaN values are
    absent. The bucket index is computed in f64; the counts are integers
    below 2^24 (one per present value), so they are exact whatever order
    the device adds them in."""
    P, T = values.shape
    dev = values.device
    vals = values.to(torch.float64)
    B = SKETCH_BUCKETS
    lg = float(np.log(SKETCH_GAMMA))
    mag = torch.abs(vals)
    bi = torch.ceil(torch.log(mag / SKETCH_MIN) / lg)
    bi = torch.nan_to_num(bi, nan=1.0, posinf=B - 1, neginf=1.0)
    # the outermost slot of each sign is kept for true +/-Inf samples
    bi = torch.clamp(bi, 1, B - 1).to(torch.int64)
    idx = torch.where(mag <= SKETCH_MIN, B,
                      torch.where(vals > 0, B + bi, B - bi))
    idx = torch.where(torch.isposinf(vals), 2 * B, idx)
    idx = torch.where(torch.isneginf(vals), 0, idx)
    present = ~torch.isnan(vals)
    gids = torch.as_tensor(group_ids, device=dev).to(torch.int64)
    flat = ((gids[:, None] * SKETCH_WIDTH + idx) * T
            + torch.arange(T, device=dev)[None, :])
    counts = torch.bincount(flat[present],
                            minlength=num_groups * SKETCH_WIDTH * T)
    return counts.to(torch.float32).reshape(num_groups, SKETCH_WIDTH, T)


def present_quantile_sketch(counts, q: float):
    """[G, W, T] host counts -> [G, T] phi-quantile estimates (host numpy).

    PromQL semantics: rank = q*(n-1) with linear interpolation between the
    two straddling order statistics; each order statistic is located in the
    sketch and represented by its bucket's geometric midpoint, so the
    per-value relative error stays bounded by (gamma-1)/(gamma+1)."""
    counts = np.asarray(counts)
    G, W, T = counts.shape
    B = SKETCH_BUCKETS
    total = counts.sum(axis=1)                               # [G, T]
    rank = np.maximum(q, 0.0) * np.maximum(total - 1, 0)     # PromQL phi rank
    lo_r = np.floor(rank)
    frac = rank - lo_r
    cum = np.cumsum(counts, axis=1)
    # the order statistic at 0-indexed rank r sits in the first bucket whose
    # cumulative count reaches r+1
    sel_lo = (cum < lo_r[:, None, :] + 1 - 1e-9).sum(axis=1)
    sel_hi = (cum < np.minimum(lo_r + 2, np.maximum(total, 1))[:, None, :]
              - 1e-9).sum(axis=1)
    sel_lo = np.clip(sel_lo, 0, W - 1)
    sel_hi = np.clip(sel_hi, 0, W - 1)
    # bucket -> representative value; the outermost slots are true +/-Inf
    k = np.arange(W, dtype=np.float64)
    pos = k - B
    mags = SKETCH_MIN * np.power(SKETCH_GAMMA, np.abs(pos)) * 2 / (1 + SKETCH_GAMMA)
    rep = np.sign(pos) * mags
    rep[B] = 0.0
    rep[0] = -np.inf
    rep[W - 1] = np.inf
    lo_v, hi_v = rep[sel_lo], rep[sel_hi]
    with np.errstate(invalid="ignore"):
        interp = lo_v * (1 - frac) + hi_v * frac
    # integral ranks and equal straddles take the value directly — the
    # interpolation form would produce inf*0 = NaN for +/-Inf samples
    out = np.where((frac == 0) | (lo_v == hi_v), lo_v, interp)
    out = np.where(total > 0, out, np.nan)
    if q < 0:
        out = np.where(total > 0, -np.inf, np.nan)
    if q > 1:
        out = np.where(total > 0, np.inf, np.nan)
    return out


def _group_value_order(keyval, group_ids):
    """Per column, the row order of a sort by (group, keyval, row): the
    reference's ``lexsort((keyval, group))``, stable on every device."""
    P, T = keyval.shape
    gcol = group_ids.to(torch.int64)[:, None].expand(P, T)
    by_val = torch.sort(keyval, dim=0, stable=True).indices
    by_group = torch.sort(torch.gather(gcol, 0, by_val), dim=0,
                          stable=True).indices
    order = torch.gather(by_val, 0, by_group)
    return order, torch.gather(gcol, 0, order)


def topk_mask(values, group_ids, num_groups: int, k: int, bottom: bool = False):
    """Per-step top-k filter: True where values[p, t] is among the k largest
    (smallest for bottomk) present values of its group at step t; among
    equal values the lower row ranks first.

    Rank within a group comes from a sort by (group, -value): a row's rank
    is its position since its group's first row in the sorted column."""
    P, T = values.shape
    dev = values.device
    neg = torch.where(torch.isnan(values),
                      float("inf") if bottom else float("-inf"), values)
    sortval = neg if bottom else -neg
    order, g_sorted = _group_value_order(sortval, group_ids)
    idx = torch.arange(P, device=dev)[:, None].expand(P, T)
    is_first = torch.cat([torch.ones((1, T), dtype=torch.bool, device=dev),
                          g_sorted[1:] != g_sorted[:-1]], dim=0)
    first_pos = torch.cummax(torch.where(is_first, idx, 0), dim=0).values
    rank = torch.empty((P, T), dtype=torch.int64, device=dev).scatter_(
        0, order, idx - first_pos)
    return (rank < k) & ~torch.isnan(values)


def group_quantile(values, group_ids, num_groups: int, q: float):
    """Cross-series quantile per group per step (ref: QuantileRowAggregator
    uses a t-digest; this is the exact quantile, affordable because the
    whole matrix is resident): sort rows by (group, value) per column, then
    interpolate linearly at rank q*(k-1) inside each group's run."""
    P, T = values.shape
    dev = values.device
    gids = group_ids.to(device=dev, dtype=torch.int64)
    big = torch.where(torch.isnan(values), float("inf"), values)
    order, _ = _group_value_order(big, gids)
    v_sorted = torch.gather(big, 0, order)
    present = ~torch.isnan(values)
    cnt = torch.zeros((num_groups, T), dtype=torch.int64, device=dev
                      ).index_add_(0, gids, present.to(torch.int64))
    # each group's run starts after all rows of the groups before it
    # (missing values sort to +inf inside their group's run)
    gsize = torch.bincount(gids, minlength=num_groups)[:num_groups]
    gstart = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                        torch.cumsum(gsize, 0)[:-1]])
    rank = q * torch.clamp(cnt.to(torch.float64) - 1.0, min=0.0)
    lo = torch.floor(rank).to(torch.int64)
    hi = torch.minimum(lo + 1, torch.clamp(cnt - 1, min=0))
    frac = rank - lo

    def take_rank(r):
        pos = torch.clamp(gstart[:, None] + r, 0, P - 1)
        return torch.gather(v_sorted, 0, pos)

    v_lo, v_hi = take_rank(lo), take_rank(hi)
    res = v_lo + (v_hi - v_lo) * frac
    return torch.where(cnt == 0, float("nan"), res)
