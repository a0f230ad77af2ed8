"""Bytes K2 (``ops/csrc/fusedhist.cu``: ``fused_hist_map``, its step fold)
needs for one query: each input byte read once, each output byte written
once, for what these inputs need.

The 2D-delta block decodes from its first column, so a row the kernel
reads costs its columns up to the last one a step needs, every bucket,
plus the row's first deltas; every row's ``n`` and group id; the
``[2, G, Tp * B]`` partials. Rows the lossless gate kept raw are the pool
correction's, not the kernel's. At 122,880 rows of 289 i8 columns x 32
buckets (2^17 rows, one in 16 pooled) and 128 padded steps this is the
1.153 GB of K2's bound in PERF.md (0.3443 ms at 3.35 TB/s).
"""

from __future__ import annotations

import numpy as np

from .k1 import MIN_GROUPS, STEP_TILE, roundup


def bytes_needed(rows: int, series: int, last_col: int, buckets: int,
                 steps: int, groups: int = 1, itemsize: int = 1) -> int:
    Tp = roundup(max(steps, 1), STEP_TILE)
    G = roundup(max(groups, MIN_GROUPS), MIN_GROUPS)
    return (rows * ((last_col + 1) * buckets * itemsize + buckets * 4)
            + series * 8 + 2 * G * Tp * buckets * 4)


def kernel_rows(cfg: dict) -> int:
    """Rows the narrow block holds exactly: all but the pooled ones (one
    in ``pool_every``, where the configuration pools any)."""
    S, every = cfg["series"], cfg.get("pool_every")
    return S if not every else S - len(range(every - 1, S, every))

def query_bytes(cfg: dict, steps: np.ndarray, launch: dict) -> int:
    """One K2 launch of a query over every series of ``cfg``."""
    base, iv = cfg["base_ts_ms"], cfg["interval_ms"]
    last = min((int(steps[-1]) - base) // iv, cfg["samples_per_series"] - 1)
    return bytes_needed(kernel_rows(cfg), cfg["series"], last,
                        cfg["buckets"], len(steps), launch.get("groups", 1))
