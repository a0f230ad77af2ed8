"""Bytes K1 (``ops/csrc/fusedgrid.cu``: ``fused_grid_map``, its fold of
block partials) needs for one query: each input byte read once, each output
byte written once, for what these inputs need.

The block's columns that the query's windows cover, once; each row's ``n``
and group id; the steps' three operands; the ``[nout, G, Tp]`` partials.
At 2^20 rows x 768 f32 columns and 128 padded steps this is the 3.230 GB
of K1 raw's bound in PERF.md (0.964 ms at 3.35 TB/s).
"""

from __future__ import annotations

import numpy as np

STEP_TILE = 128      # K1 pads the steps to a multiple of this
MIN_GROUPS = 8       # and the groups to a multiple of this, at least 8


def roundup(x: int, m: int) -> int:
    return -(-x // m) * m


def bytes_needed(series: int, cols: int, steps: int, groups: int = 1,
                 nout: int = 2, itemsize: int = 4) -> int:
    Tp = roundup(max(steps, 1), STEP_TILE)
    G = roundup(max(groups, MIN_GROUPS), MIN_GROUPS)
    return (series * cols * itemsize + 2 * series * 4 + 3 * Tp * 4
            + nout * G * Tp * 4)


def cols_needed(cfg: dict, steps: np.ndarray, window_ms: int) -> int:
    """Sample columns from the first step's window to the last step's."""
    base, iv = cfg["base_ts_ms"], cfg["interval_ms"]
    lo = max(-(-(int(steps[0]) - window_ms - base) // iv), 0)
    hi = min((int(steps[-1]) - base) // iv, cfg["samples_per_series"] - 1)
    return max(hi - lo + 1, 0)


def query_bytes(cfg: dict, steps: np.ndarray, launch: dict) -> int:
    """One K1 launch of a query over every series of ``cfg``."""
    return bytes_needed(cfg["series"],
                        cols_needed(cfg, steps, launch["window_ms"]),
                        len(steps), launch.get("groups", 1),
                        3 if launch.get("sumsq") else 2)
