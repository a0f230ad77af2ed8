"""Cross-series aggregation: the map/reduce over [P, T] result matrices.

Port of the basic-operator half of ``filodb_tpu/ops/aggregators.py``
(ref: query/.../exec/AggrOverRangeVectors.scala, RowAggregator map ->
reduce -> present). Grouping labels resolve host-side to dense group ids
[P]; the map phase is one group-sum per partial over the series axis.
Partial state is combinable across shards; order statistics (topk, quantile,
count_values) come with a later slice.

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
    not depend on the padded step bucket."""
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

        def gsum(x):
            return onehot @ x.to(acc)
    else:
        def gsum(x):
            out = torch.zeros((num_groups + 1,) + tuple(x.shape[1:]),
                              dtype=acc, device=x.device)
            return out.index_add_(0, gids_in, x.to(acc))[:num_groups]

    def gext(x, fill, reduce):
        idx = gids_in[:, None].expand_as(x)
        out = torch.full((num_groups + 1,) + tuple(x.shape[1:]), fill,
                         dtype=acc, device=x.device)
        return out.scatter_reduce_(0, idx, x.to(acc), reduce=reduce,
                                   include_self=True)[:num_groups]

    cnt = gsum(present.to(acc))
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
