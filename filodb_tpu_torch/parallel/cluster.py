"""Cluster-level result helpers.

Port of the part of ``filodb_tpu/parallel/cluster.py`` the single-node
serving path needs: ``stitch_matrices``, which the engine's fragment cache
uses to join a cached result with its newly computed steps. The
``ShardManager`` (shard-to-node assignment) and the high-availability
engine arrive with the port's cluster plane (ROADMAP queue 1 item 7).
"""

from __future__ import annotations

import numpy as np

from ..query.rangevector import ResultMatrix


def stitch_matrices(parts) -> ResultMatrix:
    """Stitch sub-range results over disjoint time splits into one matrix
    (ref: query/.../exec/StitchRvsExec.scala). Values are host arrays."""
    parts = [p for p in parts if p.num_series or len(p.out_ts)]
    if not parts:
        return ResultMatrix(np.zeros(0, np.int64), np.zeros((0, 0)), [])
    out_ts = np.concatenate([p.out_ts for p in parts])
    order = np.argsort(out_ts, kind="stable")
    out_ts = out_ts[order]
    all_keys: dict = {}
    for p in parts:
        for k in p.keys:
            all_keys.setdefault(k, len(all_keys))
    vals = np.full((len(all_keys), len(out_ts)), np.nan)
    for p in parts:
        pv = np.asarray(p.values)
        cols = np.searchsorted(out_ts, p.out_ts)
        for i, k in enumerate(p.keys):
            vals[all_keys[k], cols] = pv[i]
    return ResultMatrix(out_ts, vals, list(all_keys))
