"""The port's aggregation map/combine/present phases against the JAX ones.

Same seeded [P, T] matrices (NaN = missing sample) and group ids through
``filodb_tpu.ops.aggregators`` and ``filodb_tpu_torch.ops.aggregators``:
partial state, combined partials and presented values must agree. Integer
data makes every partial exact in f64, so the comparison is bit for bit;
the presented avg/stddev/stdvar divide and take roots, compared at 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from filodb_tpu.ops import aggregators as jagg
from filodb_tpu_torch.ops import aggregators as tagg


def matrix(P=40, T=12, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.integers(-50, 50, (P, T)).astype(np.float64)
    v[rng.random((P, T)) < 0.2] = np.nan
    v[3] = np.nan                                  # a series with no samples
    return v


@pytest.mark.parametrize("stable", (False, True))
@pytest.mark.parametrize("op", tagg.BASIC_OPS)
def test_partials_and_present_match_jax(op, stable):
    v = matrix()
    gids = (np.arange(40) % 5).astype(np.int32)
    gids[gids == 4] = 2                            # group 4 stays empty
    ref = jagg.partial_aggregate(op, jnp.asarray(v), jnp.asarray(gids), 8,
                                 stable=stable)
    got = tagg.partial_aggregate(op, torch.from_numpy(v),
                                 torch.from_numpy(gids), 8, stable=stable)
    assert set(ref) == set(got)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    pr = np.asarray(jagg.present_partials(op, ref))
    pg = tagg.present_partials(op, got).numpy()
    np.testing.assert_allclose(pg, pr, rtol=1e-12, equal_nan=True)
    # host partials present identically
    ph = tagg.present_partials(op, {k: t.numpy() for k, t in got.items()})
    np.testing.assert_allclose(ph, pr, rtol=1e-12, equal_nan=True)


@pytest.mark.parametrize("op", ("sum", "min", "max", "stddev", "count"))
@pytest.mark.parametrize("on_device", (True, False))
def test_combine_partials_matches_jax(op, on_device):
    a, b = matrix(seed=1), matrix(seed=2)
    gids = (np.arange(40) % 3).astype(np.int32)

    def parts(lib, v):
        if lib is jagg:
            return jagg.partial_aggregate(op, jnp.asarray(v), jnp.asarray(gids), 4)
        p = tagg.partial_aggregate(op, torch.from_numpy(v),
                                   torch.from_numpy(gids), 4)
        return p if on_device else {k: t.numpy() for k, t in p.items()}

    ref = jagg.combine_partials(op, parts(jagg, a), parts(jagg, b))
    got = tagg.combine_partials(op, parts(tagg, a), parts(tagg, b))
    for k in ref:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        assert isinstance(got[k], torch.Tensor) == on_device
        np.testing.assert_array_equal(g, np.asarray(ref[k]))


def test_resolve_partials_fetches_lazy_bundles():
    class Lazy:
        def resolve(self):
            return {"count": np.ones((2, 3))}

    assert tagg.resolve_partials(Lazy())["count"].shape == (2, 3)
    d = {"count": np.zeros(1)}
    assert tagg.resolve_partials(d) is d


def test_stable_fold_sums_in_f64_whatever_the_row_order():
    """The stable (index_add_) fold has no fixed row order on the card: it
    sums in f64 and rounds once to the values' dtype, so an f32 group of
    2^16 rows gives the correctly rounded sum in every row order (a
    sequential f32 fold drifts by ~1e-4 of the sum there)."""
    rng = np.random.default_rng(4)
    v = rng.uniform(0.5, 1.5, (1 << 16, 6)).astype(np.float32)
    gids = torch.zeros(1 << 16, dtype=torch.int32)
    want = v.astype(np.float64).sum(axis=0).astype(np.float32)
    for perm in (np.arange(1 << 16), rng.permutation(1 << 16)):
        got = tagg.partial_aggregate("sum", torch.from_numpy(v[perm]), gids,
                                     8, stable=True)
        assert got["sum"].dtype == torch.float32
        np.testing.assert_array_equal(got["sum"][0].numpy(), want)
        np.testing.assert_array_equal(got["count"][0].numpy(),
                                      np.full(6, 1 << 16, np.float32))
