"""K1's plain PyTorch twin against the JAX fused-grid aggregate.

The same seeded numpy inputs go through ``filodb_tpu.ops.fusedgrid.
fused_grid_aggregate`` (its XLA twin, the JAX package's own CPU path over the
same tile math; one case runs the Pallas kernel in interpret mode) and the
port's ``fused_grid_aggregate`` on CPU tensors, which takes the plain twin
of the CUDA kernel. The kernel itself runs only on the card: chip_smoke.py
holds it against this plain version there.

Tolerances: partials that are integer-valued by construction (counts, and
the sums of sum/count_over_time over integer data) must match bit for bit;
everything else within rtol 1e-5 of the array's largest magnitude — the two
folds sum rows in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from filodb_tpu.ops import fusedgrid as jfg
from filodb_tpu_torch.ops import fusedgrid as tfg

IV = 10_000
WINDOW = 300_000
FNS = ("rate", "increase", "delta", "sum_over_time", "avg_over_time",
       "count_over_time")
OPS = ("sum", "avg", "count", "group", "stddev", "stdvar")


def make_store(S, C, seed, integer=True):
    """[S, C] f32 rows with short counts; cells past a row's count hold
    garbage the kernels must mask. ``integer``: small integer gauges (every
    partial stays an integer below 2^24, so any summation order is exact);
    else counters with resets."""
    rng = np.random.default_rng(seed)
    if integer:
        val = rng.integers(0, 4, (S, C)).astype(np.float64)
    else:
        val = np.cumsum(rng.exponential(5.0, (S, C)), axis=1)
        for r in rng.choice(S, max(1, S // 8), replace=False):
            c = int(rng.integers(1, C))
            val[r, c:] -= val[r, c] - float(rng.integers(0, 3))   # reset
    n = np.full(S, C, np.int32)
    short = rng.choice(S, max(1, S // 4), replace=False)
    n[short] = rng.integers(0, C, len(short))
    val[np.arange(C)[None, :] >= n[:, None]] = 7.0e6          # past the count
    return val.astype(np.float32), n


def out_steps(C, sub_range):
    if sub_range:       # a "last few minutes" panel: active columns c0 > 0
        return np.arange((C - 56) * IV, (C - 1) * IV + 1, 30_000, dtype=np.int64)
    return np.arange(WINDOW, (C - 1) * IV + 1, 50_000, dtype=np.int64)


def run_both(op, fn, val, n, gids, num_groups, out_ts, variant="xla"):
    ref = jfg.fused_grid_aggregate(op, fn, jnp.asarray(val), jnp.asarray(n),
                                   jnp.asarray(gids), num_groups, out_ts,
                                   WINDOW, 0, IV, variant=variant)
    got = tfg.fused_grid_aggregate(op, fn, torch.from_numpy(val),
                                   torch.from_numpy(n), torch.from_numpy(gids),
                                   num_groups, out_ts, WINDOW, 0, IV)
    return {k: np.asarray(v) for k, v in ref.items()}, got


def assert_parts(ref, got, fn, integer):
    assert set(ref) == set(got)
    for k in ref:
        r, g = ref[k], got[k]
        assert r.shape == g.shape and g.dtype == np.float32, k
        exact = integer and (k == "count" or (
            k == "sum" and fn in ("sum_over_time", "count_over_time")))
        if exact:
            np.testing.assert_array_equal(g, r, err_msg=k)
        else:
            scale = float(np.abs(r).max(initial=0.0))
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5 * scale,
                                       err_msg=k)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("fn", FNS)
def test_fn_op_grid_matches_jax(fn, op):
    val, n = make_store(512, 128, seed=3)
    gids = np.random.default_rng(4).integers(0, 8, 512).astype(np.int32)
    ref, got = run_both(op, fn, val, n, gids, 8, out_steps(128, False))
    assert_parts(ref, got, fn, integer=True)


SHAPES = [(S, C, sub) for S in (8, 512, 4096) for C in (128, 256)
          for sub in (False, True)]


@pytest.mark.parametrize("S,C,sub", SHAPES)
def test_shapes_groups_and_subranges(S, C, sub):
    """Row counts across the tile rule (S <= 512 and S % 512 == 0), both
    capacities, full and sub-range queries (c0 > 0 on C = 256), G in
    {1, 8, 64}, float and integer data."""
    i = SHAPES.index((S, C, sub))
    num_groups = (1, 8, 64)[i % 3]
    integer = i % 2 == 0
    fn = ("rate", "sum_over_time", "increase", "avg_over_time")[i % 4]
    val, n = make_store(S, C, seed=10 + i, integer=integer)
    gids = np.random.default_rng(i).integers(0, num_groups, S).astype(np.int32)
    out_ts = out_steps(C, sub)
    c0, _ = tfg.host_operands(C, 128, out_ts, WINDOW, 0, IV)[-2:]
    assert (c0 > 0) == (sub and C == 256)
    ref, got = run_both("stddev", fn, val, n, gids, num_groups, out_ts)
    assert_parts(ref, got, fn, integer)


def test_plain_matches_pallas_interpret():
    """The Pallas kernel itself (interpret mode on the CPU)."""
    val, n = make_store(512, 128, seed=21)
    gids = np.random.default_rng(22).integers(0, 8, 512).astype(np.int32)
    ref, got = run_both("stddev", "rate", val, n, gids, 8,
                        out_steps(128, False), variant="pallas")
    assert_parts(ref, got, "rate", integer=True)


@pytest.mark.parametrize("fn", ("rate", "sum_over_time"))
def test_nonfinite_cells_poison_like_the_products(fn):
    """A NaN or inf cell times a 0 band entry is NaN: the band products
    spread a non-finite cell to every step of its row, and the one-hot fold
    to every other group."""
    val, n = make_store(512, 128, seed=31)
    val[5, 40] = np.nan
    val[77, 90] = np.inf
    n[5] = n[77] = 128
    gids = (np.arange(512) % 8).astype(np.int32)
    ref, got = run_both("sum", fn, val, n, gids, 8, out_steps(128, False))
    for k in ref:
        np.testing.assert_array_equal(np.isnan(got[k]), np.isnan(ref[k]))
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, equal_nan=True)


def test_active_columns_and_operands_match_jax():
    rng = np.random.default_rng(41)
    for _ in range(200):
        C = int(rng.choice([128, 256, 384, 640, 768, 1024, 100]))
        lo = rng.integers(-40, C, int(rng.integers(1, 20)))
        hi = lo + rng.integers(-1, 60, len(lo))
        assert tfg.active_columns(C, lo, hi) == jfg.active_columns(C, lo, hi)
    for C, sub in ((128, False), (256, True), (768, False)):
        out_ts = out_steps(C, sub)
        Tp = -(-len(out_ts) // 128) * 128
        for kind in ("rate", "window"):
            ours = tfg.host_operands(C, Tp, out_ts, WINDOW, 0, IV, kind)
            theirs = jfg.host_operands(C, Tp, out_ts, WINDOW, 0, IV, kind)
            for a, b in zip(ours, theirs):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_fusable_gate_matches_jax():
    for S in (8, 16, 24, 500, 512, 520, 1024, 4096):
        for C in (128, 1024, 1025):
            for T in (1, 384, 513):
                for G in (1, 64, 65):
                    assert tfg.fusable(S, C, T, G) == jfg.fusable(S, C, T, G)


def test_cpu_tensors_take_the_plain_twin_and_the_kernel_refuses_them():
    val, n = make_store(8, 128, seed=51)
    before = tfg.fused_grid_kernel.launches
    tfg.fused_grid_aggregate("sum", "rate", torch.from_numpy(val),
                             torch.from_numpy(n), torch.zeros(8, dtype=torch.int32),
                             1, out_steps(128, False), WINDOW, 0, IV)
    assert tfg.fused_grid_kernel.launches == before
    lo = torch.zeros(128, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tfg.fused_grid_kernel("rate", False, WINDOW, IV, torch.from_numpy(val),
                              torch.from_numpy(n), torch.zeros(8, dtype=torch.int32),
                              lo, lo, lo, 8)
    assert tfg.fused_grid_kernel.launches == before
