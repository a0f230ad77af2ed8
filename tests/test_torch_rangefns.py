"""The port's window functions against the JAX ones and the Prometheus model.

``periodic_samples`` (the general path: off-grid stores, churned minority
rows and the functions the grid path does not have) for all 20 of the
reference's functions, on irregular timestamps with counter resets and
short rows, against ``filodb_tpu.ops.rangefns`` (same f64 algorithm:
1e-12) and ``tests/prom_reference.eval_range_fn`` (the naive model: 1e-9;
it has no ``last_sample``). ``periodic_samples_grid`` (what an
un-aggregated ``rate(m[5m])`` or an instant selector materializes through)
against the JAX grid kernel in f32 (1e-5: the band products sum in
different orders) and f64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from filodb_tpu.core.chunkstore import TS_PAD
from filodb_tpu.ops import gridfns as jgrid
from filodb_tpu.ops import rangefns as jrange
from filodb_tpu_torch.ops import gridfns as tgrid
from filodb_tpu_torch.ops import rangefns as trange

from .prom_reference import eval_range_fn

WINDOW = 60_000


def irregular(P=12, C=48, seed=0):
    rng = np.random.default_rng(seed)
    ts = np.full((P, C), TS_PAD, np.int64)
    val = np.zeros((P, C))
    n = rng.integers(0, C + 1, P).astype(np.int32)
    n[0] = C
    for p in range(P):
        k = int(n[p])
        ts[p, :k] = 1_000_000 + np.cumsum(rng.integers(5_000, 20_000, k))
        v = np.cumsum(rng.exponential(3.0, k))
        if p % 3 == 1 and k > 4:
            v[k // 2:] -= v[k // 2] - 0.5              # counter reset
        val[p, :k] = v
    out_ts = np.arange(1_000_000, int(ts[0, C - 1]) + 30_000, 15_000,
                       dtype=np.int64)
    return ts, val, n, out_ts


# (arg0, arg1) of the functions that take arguments; last_sample's arg0 is
# its staleness bound
ARGS = {"predict_linear": (120.0, 0.0), "quantile_over_time": (0.3, 0.0),
        "holt_winters": (0.5, 0.3), "last_sample": (40_000.0, 0.0)}
# functions that subtract near-equal window sums: the two packages' prefix
# sums add in different orders (XLA's cumsum is not a sequential scan), so
# their bar is a share of the array's largest magnitude instead of
# elementwise: 1e-12 for the variances, 1e-11 for least squares, whose
# normal equations difference prefix sums of squared seconds far larger
# than a window's own spread
CANCELLING = {"stddev_over_time": 1e-12, "stdvar_over_time": 1e-12,
              "deriv": 1e-11, "predict_linear": 1e-11}


@pytest.mark.parametrize("fn", trange.RANGE_FNS)
def test_periodic_samples_matches_jax_and_prometheus(fn):
    assert trange.RANGE_FNS == jrange.RANGE_FNS
    ts, val, n, out_ts = irregular()
    a0, a1 = ARGS.get(fn, (0.0, 0.0))
    ref = np.asarray(jrange.periodic_samples(
        jnp.asarray(ts), jnp.asarray(val), jnp.asarray(n), out_ts, WINDOW, fn,
        a0, a1))
    got = trange.periodic_samples(torch.from_numpy(ts), torch.from_numpy(val),
                                  torch.from_numpy(n), out_ts, WINDOW, fn,
                                  a0, a1)
    assert got.dtype == torch.float64
    got = got.numpy()
    atol = CANCELLING.get(fn, 0.0) * float(np.nanmax(np.abs(ref)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=atol,
                               equal_nan=True)
    if fn == "last_sample":
        return
    for p in range(len(n)):
        k = int(n[p])
        want = eval_range_fn(fn, ts[p, :k], val[p, :k], out_ts, WINDOW, a0, a1)
        np.testing.assert_allclose(got[p], want, rtol=1e-9, equal_nan=True)


@pytest.mark.parametrize("fn", ("max_over_time", "stddev_over_time",
                                "quantile_over_time", "rate"))
def test_row_chunks_do_not_change_the_answer(fn, monkeypatch):
    """The general path evaluates rows in chunks bounded by CHUNK_BYTES:
    a chunk of one or a few rows gives the same bits as one chunk."""
    ts, val, n, out_ts = irregular(P=11)
    a0, a1 = ARGS.get(fn, (0.0, 0.0))
    args = (torch.from_numpy(ts), torch.from_numpy(val), torch.from_numpy(n),
            out_ts, WINDOW, fn, a0, a1)
    whole = trange.periodic_samples(*args).numpy()
    for rows in (1, 4):
        monkeypatch.setattr(trange, "CHUNK_BYTES",
                            rows * 8 * (16 * ts.shape[1] + 6 * len(out_ts)
                                        * (256 if fn == "quantile_over_time"
                                           else 32 if fn == "max_over_time"
                                           else 1)))
        assert trange._row_chunk(fn, ts.shape[1], len(out_ts), 256) == rows
        np.testing.assert_array_equal(trange.periodic_samples(*args).numpy(),
                                      whole)


def grid_store(S=16, C=64, seed=1, dtype=np.float32):
    rng = np.random.default_rng(seed)
    val = np.cumsum(rng.exponential(4.0, (S, C)), axis=1)
    val[5, 30:] -= val[5, 30]                          # counter reset
    n = np.full(S, C, np.int32)
    n[3] = 20
    n[7] = 0
    return val.astype(dtype), n


@pytest.mark.parametrize("dtype", (np.float32, np.float64))
@pytest.mark.parametrize("fn", sorted(tgrid.GRID_FNS))
def test_periodic_samples_grid_matches_jax(fn, dtype):
    val, n = grid_store(dtype=dtype)
    out_ts = np.arange(300_000, 640_000, 30_000, dtype=np.int64)
    ref = np.asarray(jgrid.periodic_samples_grid(
        jnp.asarray(val), jnp.asarray(n), out_ts, 300_000, fn, 0, 10_000))
    got = tgrid.periodic_samples_grid(torch.from_numpy(val),
                                      torch.from_numpy(n), out_ts, 300_000,
                                      fn, 0, 10_000)
    assert got.dtype == torch.from_numpy(val).dtype
    rtol = 1e-5 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(got.numpy(), ref, rtol=rtol, equal_nan=True)


def test_unknown_function_raises():
    ts, val, n, out_ts = irregular(P=2, C=8)
    with pytest.raises(ValueError, match="unknown range function"):
        trange.periodic_samples(torch.from_numpy(ts), torch.from_numpy(val),
                                torch.from_numpy(n), out_ts, WINDOW,
                                "rate_of_change")
