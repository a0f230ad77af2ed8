"""The port's window functions against the JAX ones and the Prometheus model.

``periodic_samples`` (the general path: off-grid stores and churned minority
rows) for every ported function, on irregular timestamps with counter
resets and short rows, against ``filodb_tpu.ops.rangefns`` (same f64
algorithm: 1e-12) and ``tests/prom_reference.eval_range_fn`` (the naive
model: 1e-9). ``periodic_samples_grid`` (what an un-aggregated
``rate(m[5m])`` materializes through) against the JAX grid kernel in f32
(1e-5: the band products sum in different orders) and f64.
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


@pytest.mark.parametrize("fn", trange.PORTED_FNS)
def test_periodic_samples_matches_jax_and_prometheus(fn):
    ts, val, n, out_ts = irregular()
    ref = np.asarray(jrange.periodic_samples(
        jnp.asarray(ts), jnp.asarray(val), jnp.asarray(n), out_ts, WINDOW, fn))
    got = trange.periodic_samples(torch.from_numpy(ts), torch.from_numpy(val),
                                  torch.from_numpy(n), out_ts, WINDOW, fn)
    assert got.dtype == torch.float64
    got = got.numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, equal_nan=True)
    for p in range(len(n)):
        k = int(n[p])
        want = eval_range_fn(fn, ts[p, :k], val[p, :k], out_ts, WINDOW)
        np.testing.assert_allclose(got[p], want, rtol=1e-9, equal_nan=True)


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


def test_unported_functions_raise():
    ts, val, n, out_ts = irregular(P=2, C=8)
    with pytest.raises(ValueError, match="not on the ported path"):
        trange.periodic_samples(torch.from_numpy(ts), torch.from_numpy(val),
                                torch.from_numpy(n), out_ts, WINDOW, "irate")
