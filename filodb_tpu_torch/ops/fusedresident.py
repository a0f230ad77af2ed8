"""Fused execution tier: the registry of single-pass query shapes.

Port of the scalar half of ``filodb_tpu/ops/fusedresident.py``. The
reference selects a backend per ``query.fused_kernels`` mode (Pallas, its
XLA twin, or the composed ``off`` chain). The port has no mode: the tensor's
device picks the implementation inside ``fusedgrid.fused_grid_aggregate``
(K1 on the card, the plain twin on the CPU), so no switch can put the plain
version on a card's serving path. The composed ``off`` chain and the
``hist_quantile`` shape arrive with later slices.
"""

from __future__ import annotations

import numpy as np

from ..utils.metrics import (FILODB_QUERY_FUSED_FALLBACK,
                             FILODB_QUERY_FUSED_SERVED, registry)
from . import fusedgrid

# shape name -> (window fns, reduce ops) it serves; exec.py consults it for
# plan-time eligibility. The reference's third shape, hist_quantile, comes
# with the histogram slice (its kernel, K2, is still to port).
FUSED_SHAPES = {
    "rate_sum": (frozenset(fusedgrid.FUSED_FNS),
                 frozenset(fusedgrid.FUSED_OPS)),
    "window_reduce": (frozenset(fusedgrid.FUSED_WINDOW_FNS),
                      frozenset(fusedgrid.FUSED_OPS)),
}


def scalar_shape_of(fn: str) -> str | None:
    """Registry shape serving a scalar window fn, or None."""
    for shape, (fns, _ops) in FUSED_SHAPES.items():
        if fn in fns:
            return shape
    return None


def _backend(val) -> str:
    return "cuda" if val.is_cuda else "plain"


def count_served(shape: str, backend: str) -> None:
    registry.counter(FILODB_QUERY_FUSED_SERVED,
                     {"shape": shape, "mode": backend}).increment()


def count_fallback(shape: str) -> None:
    """A query matched a fused shape but took the composed path (shape
    gate, group cap, off-grid store, ...)."""
    registry.counter(FILODB_QUERY_FUSED_FALLBACK, {"shape": shape}).increment()


def scalar_aggregate(op: str, fn: str, val, n, gids, num_groups: int,
                     out_ts: np.ndarray, window_ms: int, base_ts: int,
                     interval_ms: int, fetch: bool = True):
    """One-pass ``op(fn(metric[w]))`` partials (operand contracts: see
    fusedgrid.fused_grid_aggregate). The caller checked eligibility."""
    out = fusedgrid.fused_grid_aggregate(
        op, fn, val, n, gids, num_groups, out_ts, window_ms, base_ts,
        interval_ms, fetch=fetch)
    count_served(scalar_shape_of(fn) or "rate_sum", _backend(val))
    return out
