"""Seeded inputs of a counter deployment: ``series`` monotonic counters of
``samples_per_series`` samples each, every ``interval_ms`` from
``base_ts_ms``.

Each counter is the running sum of exponential increments of mean
``increment_mean``, made on ``device`` in f32 by one ``torch.Generator``
seeded with the run's seed, ``data_batch`` rows at a time, in row order.
The install into the program and the plain reference both read the
inputs from :func:`blocks`, so both see the same values bit for bit.

Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch


def generator(seed: int, device) -> torch.Generator:
    """The one generator of a run's inputs (any seed up to 2**64 - 1)."""
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 64))


def blocks(cfg: dict, seed: int, device):
    """Yield ``(r0, vals)``: rows ``r0 .. r0 + len(vals)`` of the counters,
    f32 ``[rows, samples_per_series]`` on ``device``, in row order."""
    g = generator(seed, device)
    S, N = cfg["series"], cfg["samples_per_series"]
    batch = cfg["data_batch"]
    for r0 in range(0, S, batch):
        rows = min(batch, S - r0)
        inc = torch.empty((rows, N), dtype=torch.float32, device=device)
        inc.exponential_(generator=g)
        # a parallel scan's rounding may step a prefix below the one before
        # it; a counter never decreases, so the running maximum holds it
        vals = torch.cumsum(inc * float(cfg["increment_mean"]), 1)
        yield r0, torch.cummax(vals, 1).values


def labels(cfg: dict) -> list[str]:
    """The ``label`` value of each series, in row order."""
    return [cfg["label_format"].format(i) for i in range(cfg["series"])]


def timestamps(cfg: dict) -> np.ndarray:
    """The sample timestamps every series shares, int64 ms."""
    return cfg["base_ts_ms"] + np.arange(
        cfg["samples_per_series"], dtype=np.int64) * cfg["interval_ms"]


def columns(cfg: dict, seed: int, device):
    """Yield ``(r0, {column: samples})`` in row order: the counters' one
    ``value`` column."""
    for r0, vals in blocks(cfg, seed, device):
        yield r0, {"value": vals}
