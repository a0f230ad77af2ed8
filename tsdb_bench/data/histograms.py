"""Seeded inputs of a Prometheus histogram deployment: ``series``
histograms of ``buckets`` cumulative buckets (``le`` = 2^k, then +Inf),
``samples_per_series`` samples each, every ``interval_ms``.

Every bucket takes Poisson(``poisson_rate``) new observations a sample;
the counts are cumulated over time and then over the buckets, so every
count is a whole number, as an exporter's bucket counts are. The schema's
``count`` column is the +Inf bucket and its ``sum`` column prices each
bucket's observations at the bucket's midpoint; every column of every row
only grows (no counter resets). One
``torch.Generator`` seeded with the run's seed makes everything on
``device``, ``data_batch`` rows at a time, in row order; the install and
the plain reference both read :func:`blocks`.

Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from .counters import generator, labels, timestamps  # noqa: F401


def les(cfg: dict) -> np.ndarray:
    """Bucket tops: 2^0 .. 2^(B-2), then +Inf."""
    B = cfg["buckets"]
    return np.concatenate([2.0 ** np.arange(B - 1), [np.inf]])


def mids(cfg: dict, device) -> torch.Tensor:
    """The price of one observation in each bucket, f32 [B]."""
    top = les(cfg)
    m = np.concatenate([[0.5], 0.75 * top[1:-1], [1.5 * top[-2]]])
    return torch.tensor(m, dtype=torch.float32, device=device)


def blocks(cfg: dict, seed: int, device):
    """Yield ``(r0, counts, count_col, sum_col)`` for rows ``r0 ..`` in
    row order: cumulative bucket counts f32 ``[rows, samples, B]`` and the
    two scalar columns f32 ``[rows, samples]``."""
    g = generator(seed, device)
    S, N, B = cfg["series"], cfg["samples_per_series"], cfg["buckets"]
    batch = cfg["data_batch"]
    price = mids(cfg, device).double()
    for r0 in range(0, S, batch):
        rows = min(batch, S - r0)
        lam = torch.full((rows, N, B), float(cfg["poisson_rate"]),
                         device=device)
        c = torch.cumsum(torch.cumsum(torch.poisson(lam, generator=g), 1), 2)
        # the sum column in f64, then rounded once: every term and so every
        # rounded sum grows with time, so it is a counter that never
        # decreases, as an exporter's sum never does
        per_bucket = torch.diff(c, dim=2, prepend=torch.zeros_like(c[..., :1]))
        total = (per_bucket.double() * price).sum(-1).float()
        yield r0, c, c[..., -1].contiguous(), total

def columns(cfg: dict, seed: int, device):
    """Yield ``(r0, {column: samples})`` in row order: the histogram as
    ``value`` and its ``sum`` and ``count`` columns."""
    for r0, c, count, total in blocks(cfg, seed, device):
        yield r0, {"value": c, "sum": total, "count": count}
