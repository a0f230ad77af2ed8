"""The port's SeriesStore against the JAX SeriesStore on the same appends.

Both stores take the same seeded batches — in order, out of order, past
capacity, late-starting series, off-grid timestamps — then compaction and
row frees; after every step the device arrays, the host mirrors, the grid
fields and the cohort summary must be identical. ``from_reference_arrays``
rebuilds the port's store from what the JAX store exposes and must answer
the fused aggregate like the store it came from.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from filodb_tpu.core.chunkstore import SeriesStore as JSeriesStore
from filodb_tpu_torch.core.chunkstore import TS_PAD, SeriesStore
from filodb_tpu_torch.ops import fusedgrid

BASE = 1_700_000_000_000
IV = 10_000
S, C = 32, 64


def assert_same(t: SeriesStore, j: JSeriesStore, stats: bool = True):
    np.testing.assert_array_equal(t.ts.numpy(), np.asarray(j.ts))
    np.testing.assert_array_equal(t.val.numpy(), np.asarray(j.val))
    np.testing.assert_array_equal(t.n.numpy(), np.asarray(j.n))
    np.testing.assert_array_equal(t.n_host, j.n_host)
    np.testing.assert_array_equal(t.first_ts, j.first_ts)
    np.testing.assert_array_equal(t.last_ts, j.last_ts)
    assert t.grid_info() == j.grid_info()
    assert t.grid_ok == j.grid_ok
    tk, to = t.grid_cohorts()
    jk, jo = j.grid_cohorts()
    assert tk == jk
    np.testing.assert_array_equal(np.asarray(to), np.asarray(jo))
    if stats:
        assert t.stats == type(t.stats)(**vars(j.stats))


def batch(rows, k0, k1, rng, jitter=False):
    """Samples k0..k1-1 (grid cells) of the given rows, interleaved."""
    pids, ts, vals = [], [], []
    for k in range(k0, k1):
        for r in rows:
            pids.append(r)
            ts.append(BASE + k * IV + (int(rng.integers(1, 9)) if jitter else 0))
            vals.append(float(rng.integers(0, 1000)))
    return (np.asarray(pids, np.int32), np.asarray(ts, np.int64),
            np.asarray(vals, np.float64))


def stores():
    return (SeriesStore(S, C, dtype="float32", device="cpu"),
            JSeriesStore(S, C, dtype=jnp.float32))


def apply_both(t, j, fn, *args):
    a = getattr(t, fn)(*args)
    b = getattr(j, fn)(*args)
    assert a == b
    assert_same(t, j)


def test_append_sequence_matches_jax():
    rng = np.random.default_rng(1)
    t, j = stores()
    apply_both(t, j, "append", *batch(range(10), 0, 20, rng))
    # a late-starting cohort (churn): grid stays, cohorts go mixed
    apply_both(t, j, "append", *batch(range(10, 14), 5, 20, rng))
    # out-of-order and duplicate timestamps drop
    p, ts, v = batch(range(4), 10, 25, rng)
    apply_both(t, j, "append", p[::-1].copy(), ts[::-1].copy(), v)
    # past capacity: columns >= C drop (the reference's scatter mode="drop")
    apply_both(t, j, "append", *batch(range(3), 25, 25 + C, rng))
    assert t.stats.capacity_dropped > 0 and t.stats.out_of_order_dropped > 0


def test_off_grid_timestamps_break_the_grid_alike():
    rng = np.random.default_rng(2)
    t, j = stores()
    apply_both(t, j, "append", *batch(range(6), 0, 10, rng))
    apply_both(t, j, "append", *batch(range(6), 10, 12, rng, jitter=True))
    assert t.grid_info() is None


def test_compact_and_free_rows_match_jax():
    rng = np.random.default_rng(3)
    t, j = stores()
    apply_both(t, j, "append", *batch(range(12), 0, 40, rng))
    apply_both(t, j, "append", *batch(range(12, 16), 10, 40, rng))
    apply_both(t, j, "compact", BASE + 15 * IV)
    apply_both(t, j, "free_rows", np.array([2, 13, 5], np.int32))
    apply_both(t, j, "append", *batch([2, 5], 41, 45, rng))
    assert (t.ts.numpy()[13] == TS_PAD).all()


def test_from_reference_arrays_round_trip():
    rng = np.random.default_rng(4)
    j = JSeriesStore(S, C, dtype=jnp.float32)
    j.append(*batch(range(24), 0, 50, rng))
    j.append(*batch(range(24, 30), 20, 50, rng))
    ts, val = (np.asarray(a) for a in j.snapshot_arrays())
    t = SeriesStore.from_reference_arrays(
        ts, val, np.asarray(j.n), j.grid_base, j.grid_interval,
        device="cpu")
    assert_same(t, j, stats=False)
    # the rebuilt store answers like a port store fed the same appends
    base = j.grid_base
    out_ts = np.arange(base + 300_000, base + 49 * IV + 1, 30_000, dtype=np.int64)
    gids = torch.from_numpy((np.arange(S) % 4).astype(np.int32))
    a = fusedgrid.fused_grid_aggregate("sum", "rate", t.val, t.n, gids, 4,
                                       out_ts, 300_000, base, IV)
    rng2 = np.random.default_rng(4)
    t2 = SeriesStore(S, C, dtype="float32", device="cpu")
    t2.append(*batch(range(24), 0, 50, rng2))
    t2.append(*batch(range(24, 30), 20, 50, rng2))
    b = fusedgrid.fused_grid_aggregate("sum", "rate", t2.val, t2.n, gids, 4,
                                       out_ts, 300_000, base, IV)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("dtype", ("float32", "float64"))
def test_store_dtype_follows_config(dtype):
    t = SeriesStore(8, 16, dtype=dtype, device="cpu")
    assert t.val.dtype == getattr(torch, dtype)
    assert t.ts.dtype == torch.int64 and t.n.dtype == torch.int32
