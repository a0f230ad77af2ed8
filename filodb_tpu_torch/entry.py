"""The flagship step as one function on tensors.

Port of ``__graft_entry__.entry()``: ``sum(rate(m[5m]))`` over a 512 x 128
example store through the fused map phase (K1 on the card, its plain twin
on the CPU) and the ``sum`` present, the same kernel the bench measures.

    from filodb_tpu_torch.entry import entry
    fn, args = entry()              # device="cpu" to run on the CPU
    out = fn(*args)                 # [1, 17] f32 on args' device
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .ops import aggregators, fusedgrid

S, C, N_SAMPLES = 512, 128, 100
BASE_TS = 1_700_000_000_000
WINDOW_MS, INTERVAL_MS = 300_000, 10_000
# 17 steps, 400 s to 900 s into the store's data
OUT_TS = BASE_TS + np.arange(400_000, 900_001, 30_000, dtype=np.int64)


def example_store(device, seed: int = 0):
    """(val [S, C] f32, n [S] i32) on ``device``: counters of exponential
    increments, ``N_SAMPLES`` cells filled per row, made with numpy exactly
    as the reference's ``_example_store``."""
    rng = np.random.default_rng(seed)
    vals = np.cumsum(rng.exponential(5.0, (S, N_SAMPLES)), axis=1)
    val = np.zeros((S, C), np.float32)
    val[:, :N_SAMPLES] = vals
    n = np.full(S, N_SAMPLES, np.int32)
    return torch.from_numpy(val).to(device), torch.from_numpy(n).to(device)


def entry(device=None):
    """Return ``(fn, example_args)``: ``fn(*example_args)`` is the
    ``sum(rate(m[5m]))`` step over the example store on ``device`` (default
    ``cuda``; raises ``DeviceUnavailable`` without a card unless the CPU is
    asked for), a [1, 17] f32 tensor. The arguments are the store (val, n),
    the group ids and the window operands (band, ohlo, lo, hi, rel) of the
    reference's entry, in its order; the window operands are copies of the
    query engine's cached ones, so a caller may change them in place."""
    dev = resolve_device(device)
    T = len(OUT_TS)
    Tp = -(-T // 128) * 128
    val, n = example_store(dev)
    gids = torch.zeros(S, dtype=torch.int32, device=dev)
    *ops, c0, Ca = fusedgrid.device_operands(
        C, Tp, OUT_TS.tobytes(), WINDOW_MS, BASE_TS, INTERVAL_MS, "rate",
        False, dev)

    def sum_rate_query(val, n, gids, band, ohlo, lo, hi, rel):
        outs = fusedgrid.fused_grid_partials(
            "rate", False, WINDOW_MS, INTERVAL_MS, val, n, gids, band, ohlo,
            lo, hi, rel, 8, c0, Ca)
        parts = {"sum": outs[0], "count": outs[1]}
        return aggregators.present_partials("sum", parts)[:1, :T]

    return sum_rate_query, (val, n, gids, *(o.clone() for o in ops))
