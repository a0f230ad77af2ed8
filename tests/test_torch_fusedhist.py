"""K2's plain PyTorch twin and the hist grid functions against the JAX package.

The same seeded numpy operands — i8/i16 2D-delta blocks made by the JAX
package's own encoder from integer cumulative histograms, with short rows,
rows of fewer than two samples, and excluded cohort-pool rows (gid
``1 << 30``) — go through the JAX hist map program (its XLA twin, and the
Pallas kernel in interpret mode) and through the port's
``fused_hist_map_plain``, the twin of the CUDA kernel K2. K2 itself runs
only on the card: chip_smoke.py holds it against this twin there.

Tolerances: counts are integers and must match bit for bit; sums within
rtol 1e-5 of the array's largest magnitude (the folds sum rows in different
orders, the reference's own bar). The f64 quantile within one f64 rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from filodb_tpu.ops import fusedresident as jfr
from filodb_tpu.ops import gridfns as jgf
from filodb_tpu.ops import narrow as jnarrow
from filodb_tpu.ops import rangefns as jrf
from filodb_tpu.utils import enable_x64
from filodb_tpu_torch.ops import fusedresident as tfr
from filodb_tpu_torch.ops import gridfns as tgf
from filodb_tpu_torch.ops import narrow as tnarrow
from filodb_tpu_torch.ops import rangefns as trf

IV = 10_000
WINDOW = 300_000
EXCLUDED = 1 << 30


def hist_block(S, C, B, wide, seed, n_short=True):
    """Integer cumulative bucket counts [S, C, B] f32 + valid counts: quiet
    rows (dd fits i8) or, with ``wide``, alternating bursts (dd needs
    i16). Every partial stays below 2^24."""
    rng = np.random.default_rng(seed)
    inc = rng.poisson(0.4 if not wide else 3.0, (S, C, B)).astype(np.float64)
    if wide:
        inc[:, ::2, :] += 150.0
    val = np.cumsum(np.cumsum(inc, axis=1), axis=2).astype(np.float32)
    n = np.full(S, C, np.int32)
    if n_short:
        n[rng.choice(S, S // 4, replace=False)] = rng.integers(2, C, S // 4)
        n[3], n[4] = 0, 1                        # fewer than two samples
    return val, n


def operands(S, C, B, dtype, G, seed):
    """(dd, first_d, n, gids) numpy from the JAX encoder; a sixteenth of the
    rows are excluded pool rows holding garbage dd and non-finite first_d."""
    val, n = hist_block(S, C, B, dtype == "i16", seed)
    dd16, first_d, ok16, ok8, _m, _e = (np.asarray(a) for a in
                                        jnarrow.build_narrow_hist(
                                            jnp.asarray(val), jnp.asarray(n)))
    ok = ok8 if dtype == "i8" else ok16
    assert ok[n > 0].all()
    dd = dd16.astype(np.int8) if dtype == "i8" else dd16.copy()
    rng = np.random.default_rng(seed + 1)
    gids = rng.integers(0, G, S).astype(np.int32)
    pool = rng.choice(np.arange(8, S), S // 16, replace=False)
    gids[pool] = EXCLUDED
    info = np.iinfo(dd.dtype)
    dd[pool] = rng.integers(info.min, info.max, (len(pool), C, B))
    first_d = first_d.copy()
    first_d[pool[0]] = np.nan
    first_d[pool[1], 2:] = np.inf
    first_d[pool[2]] = -np.inf
    return dd, first_d, n, gids


def out_steps(C):
    """Steps from before the data (hi < 0, lo < 0) to its end."""
    return np.arange(-50_000, (C - 1) * IV + 1, 30_000, dtype=np.int64)


def jax_map(variant, fn, dd, first_d, n, gids, G, out_ts, C):
    S, _, B = dd.shape
    T = len(out_ts)
    Tp = -(-T // 128) * 128
    band, plo, lo, hi, rel = jfr._hist_device_operands(
        C, Tp, out_ts.tobytes(), WINDOW, 0, IV)
    prog = jfr._hist_map_program(variant, fn, WINDOW, IV, S,
                                 512 if S % 512 == 0 else S, C, Tp, B, G,
                                 str(dd.dtype))
    with enable_x64(False):
        ps, pc = prog(jnp.asarray(dd), jnp.asarray(first_d), jnp.asarray(n),
                      jnp.asarray(gids), band, plo, lo, hi, rel)
    return np.asarray(ps), np.asarray(pc)


def port_map(fn, dd, first_d, n, gids, G, out_ts, C):
    T = len(out_ts)
    Tp = -(-T // 128) * 128
    ops = tfr.hist_device_operands(C, Tp, out_ts.tobytes(), WINDOW, 0, IV,
                                   torch.device("cpu"))
    ps, pc = tfr.fused_hist_map(fn, WINDOW, IV, torch.from_numpy(dd),
                                torch.from_numpy(first_d), torch.from_numpy(n),
                                torch.from_numpy(gids), ops, G)
    return ps.numpy(), pc.numpy()


def assert_partials(got, ref):
    (gs, gc), (rs, rc) = got, ref
    assert gs.shape == rs.shape and gs.dtype == np.float32
    np.testing.assert_array_equal(gc, rc)
    assert np.isfinite(gs).all()
    scale = float(np.abs(rs).max(initial=0.0))
    np.testing.assert_allclose(gs, rs, rtol=1e-5, atol=1e-5 * scale)


GRID = [(fn, dt, B, G) for fn in ("rate", "increase", "delta")
        for dt in ("i8", "i16") for B in (8, 32) for G in (8, 64)]


@pytest.mark.parametrize("variant", ("xla", "pallas"))
@pytest.mark.parametrize("fn,dtype,B,G", GRID)
def test_twin_matches_jax(fn, dtype, B, G, variant):
    """Against the XLA twin and the Pallas kernel itself (interpret mode on
    the CPU), over two row tiles (B = 8) or one (B = 32)."""
    C = 128
    S = 1024 if B == 8 else 512
    dd, first_d, n, gids = operands(S, C, B, dtype, G, seed=GRID.index(
        (fn, dtype, B, G)))
    out_ts = out_steps(C)
    ref = jax_map(variant, fn, dd, first_d, n, gids, G, out_ts, C)
    got = port_map(fn, dd, first_d, n, gids, G, out_ts, C)
    assert_partials(got, ref)
    assert ref[1].max() > 0


def test_excluded_rows_add_exactly_nothing():
    """An excluded row's contribution is always finite — an integer dd, and
    a non-finite first-sample value only feeds comparisons — so the one-hot
    product adds an exact 0 for it. Removing those rows therefore leaves
    the twin's output unchanged bit for bit, which is what lets K2 skip
    them. The pool rows here hold NaN and Inf first-frame deltas."""
    C, S, B, G = 128, 512, 8, 8
    dd, first_d, n, gids = operands(S, C, B, "i8", G, seed=61)
    out_ts = out_steps(C)
    for fn in ("rate", "increase", "delta"):
        full = port_map(fn, dd, first_d, n, gids, G, out_ts, C)
        keep = gids != EXCLUDED
        n0 = np.where(keep, n, 0).astype(np.int32)
        fd0 = np.where(keep[:, None], first_d, 0.0).astype(np.float32)
        dd0 = np.where(keep[:, None, None], dd, 0).astype(dd.dtype)
        g0 = np.where(keep, gids, 0).astype(np.int32)
        dropped = port_map(fn, dd0, fd0, n0, g0, G, out_ts, C)
        for a, b in zip(full, dropped):
            assert np.isfinite(a).all()
            np.testing.assert_array_equal(a, b)


def test_k2_cell_tables_reproduce_the_band_products():
    """K2 reads window deltas and first-sample prefixes as differences of a
    row's 2D integer prefix at the cells k2_cell_tables lists; over random
    integer dd (cell 0 included) and every kind of step — before the data,
    empty windows, hi past the last cell, padding — that equals
    cumsum_b(dd @ band_open) and cumsum_b(dd @ prefix_lo) exactly."""
    rng = np.random.default_rng(71)
    for C, B in ((64, 8), (128, 3), (100, 16)):
        dd = rng.integers(-40, 40, (16, C, B)).astype(np.float32)
        for iv, window, start in ((IV, WINDOW, -50_000), (IV, 5_000, 3_000),
                                  (7, 35, 0), (IV, 20 * IV, 400 * IV)):
            out_ts = np.arange(start, start + 90 * 13 * iv // 10 + 1,
                               13 * iv // 10, dtype=np.int64)[:90]
            T = len(out_ts)
            Tp = -(-T // 128) * 128
            band, plo, lo, hi, _rel = tfr.hist_operands(C, Tp, out_ts, window,
                                                        0, iv)
            cells, slots, t0, t1 = tfr.k2_cell_tables(C, lo, hi)
            assert cells[0] == 0 and (np.diff(cells) > 0).all()
            flat = torch.from_numpy(dd).permute(0, 2, 1)         # [S, B, C]
            want_d = torch.cumsum(flat @ torch.from_numpy(band), dim=1)
            want_f = torch.cumsum(flat @ torch.from_numpy(plo), dim=1)
            Q = np.cumsum(np.cumsum(dd.astype(np.int64), axis=1), axis=2)
            Qs = Q[:, cells, :]                                  # [S, K, B]
            lo1, hi1 = lo[0], hi[0]
            for t in range(Tp):
                got_d = np.zeros((16, B))
                got_f = np.zeros((16, B))
                if hi1[t] >= 0:
                    assert t0 <= t < t1
                    if hi1[t] > lo1[t]:
                        got_d = Qs[:, slots[0, t]] - (
                            Qs[:, slots[1, t]] if slots[1, t] >= 0 else 0)
                    if slots[2, t] >= 0:
                        got_f = Qs[:, slots[2, t]] - Qs[:, 0]
                np.testing.assert_array_equal(got_d, want_d[:, :, t].numpy())
                np.testing.assert_array_equal(got_f, want_f[:, :, t].numpy())


def test_hist_tile_contrib_matches_jax():
    C, S, B = 128, 64, 8
    dd, first_d, n, _ = operands(S, C, B, "i16", 8, seed=81)
    out_ts = out_steps(C)
    Tp = 128
    ops_j = jfr._hist_operands(C, Tp, out_ts, WINDOW, 0, IV)
    ops_t = tfr.hist_operands(C, Tp, out_ts, WINDOW, 0, IV)
    for a, b in zip(ops_j, ops_t):
        np.testing.assert_array_equal(np.asarray(a), b)
    for fn in ("rate", "increase", "delta"):
        with enable_x64(False):
            rc, rk = jfr.hist_tile_contrib(
                fn, WINDOW, IV, B, jnp.asarray(dd, jnp.float32),
                jnp.asarray(first_d), jnp.asarray(n.reshape(S, 1)),
                *(jnp.asarray(a) for a in ops_j))
        gc, gk = tfr.hist_tile_contrib(
            fn, WINDOW, IV, B, torch.from_numpy(dd).float(),
            torch.from_numpy(first_d), torch.from_numpy(n.reshape(S, 1)),
            *(torch.from_numpy(a) for a in ops_t))
        np.testing.assert_array_equal(gk.numpy(), np.asarray(rk))
        rc = np.asarray(rc)
        np.testing.assert_allclose(gc.numpy(), rc, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(rc).max()))


def test_gate_matches_jax():
    for S in (8, 16, 500, 512, 520, 1024, 1 << 17):
        for C in (128, 1024, 1025):
            for T in (1, 39, 128, 129, 512):
                for B in (0, 8, 32, 64, 65):
                    for G in (8, 64, 72):
                        assert (tfr.hist_fusable(S, C, T, B, G)
                                == jfr.hist_fusable(S, C, T, B, G))


def test_cpu_tensors_take_the_twin_and_the_kernel_refuses_them():
    C, S, B, G = 128, 64, 8, 8
    dd, first_d, n, gids = operands(S, C, B, "i8", G, seed=91)
    out_ts = out_steps(C)
    before = tfr.fused_hist_kernel.launches
    port_map("rate", dd, first_d, n, gids, G, out_ts, C)
    assert tfr.fused_hist_kernel.launches == before
    ops = tfr.hist_device_operands(C, 128, out_ts.tobytes(), WINDOW, 0, IV,
                                   torch.device("cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        tfr.fused_hist_kernel("rate", WINDOW, IV, torch.from_numpy(dd),
                              torch.from_numpy(first_d), torch.from_numpy(n),
                              torch.from_numpy(gids), ops, G)
    assert tfr.fused_hist_kernel.launches == before


@pytest.mark.parametrize("streamed", (False, True))
def test_build_narrow_hist_bit_exact_against_jax(streamed, monkeypatch):
    """On integer data the port's encoder returns the JAX encoder's dd,
    first_d and flags bit for bit — in one pass, and streamed in row
    blocks (forced small here)."""
    if streamed:
        monkeypatch.setattr(tnarrow, "BUILD_BLOCK_BYTES", 40 * 64 * 8 * 4 * 3)
    for wide, reset in ((False, False), (True, False), (False, True)):
        val, n = hist_block(100, 64, 8, wide, seed=101 + wide)
        if reset:
            val[::5, 30:] -= val[::5, 30:31]            # counter resets
        ref = [np.asarray(a) for a in jnarrow.build_narrow_hist(
            jnp.asarray(val), jnp.asarray(n))]
        got = [a.numpy() for a in tnarrow.build_narrow_hist(
            torch.from_numpy(val), torch.from_numpy(n))]
        for name, g, r in zip(("dd", "first_d", "ok16", "ok8", "mono",
                               "exact"), got, ref):
            assert g.dtype == r.dtype, name
            np.testing.assert_array_equal(g, r, err_msg=name)
        assert (~got[4]).any() == reset
        assert got[3].all() == (not wide and not reset)


def test_histogram_quantile_matches_jax_exactly():
    rng = np.random.default_rng(111)
    les = np.concatenate([2.0 ** np.arange(7), [np.inf]])
    counts = np.cumsum(rng.poisson(2.0, (6, 40, 8)), axis=2).astype(np.float32)
    counts[0, :5] = 0.0
    counts[1, 3] = np.nan
    counts[2, :, 5:] = counts[2, :, 4:5]        # mass in the +Inf bucket only
    counts[3] *= 0.37
    for q in (-0.5, 0.0, 0.25, 0.5, 0.9, 0.99, 1.0, 1.5):
        ref = np.asarray(jgf.histogram_quantile(jnp.float64(q),
                                                jnp.asarray(les),
                                                jnp.asarray(counts)))
        got = tgf.histogram_quantile(q, les, torch.from_numpy(counts)).numpy()
        assert got.dtype == np.float64 and ref.dtype == np.float64
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        # within one f64 rounding: XLA may fuse the interpolation's
        # lo + (hi - lo) * frac into a multiply-add
        np.testing.assert_allclose(got, ref, rtol=1e-14, atol=0,
                                   equal_nan=True)


HIST_FNS = ("rate", "increase", "delta", "sum_over_time", "last_over_time",
            "last_sample")


@pytest.mark.parametrize("fn", HIST_FNS)
def test_hist_grid_quantile_routes_match_jax(fn):
    """The raw route (fused_hist_quantile_grid) and the narrow route outside
    K2 (fused_hist_quantile_grid_narrow) against the JAX package's, with
    group ids including excluded rows and cohort-pool correction
    partials."""
    C, S, B, G = 64, 64, 8, 8
    val, n = hist_block(S, C, B, False, seed=121)
    les = np.concatenate([2.0 ** np.arange(B - 1), [np.inf]])
    gids = (np.arange(S) % 5).astype(np.int32)
    gids[7] = EXCLUDED
    out_ts = np.arange(150_000, (C - 1) * IV + 1, 30_000, dtype=np.int64)
    T = len(out_ts)
    ref = np.asarray(jgf.fused_hist_quantile_grid(
        0.9, les, jnp.asarray(val), n, gids, G, out_ts, WINDOW, fn, 0, IV))
    got = tgf.fused_hist_quantile_grid(
        0.9, les, torch.from_numpy(val), torch.from_numpy(n),
        torch.from_numpy(gids), G, out_ts, WINDOW, fn, 0, IV).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-9, equal_nan=True)
    dd16, first_d = (np.array(a) for a in jnarrow.build_narrow_hist(
        jnp.asarray(val), jnp.asarray(n))[:2])
    corr = np.random.default_rng(122).poisson(3.0, (2, G, T * B)).astype(
        np.float32)
    ref = np.asarray(jgf.fused_hist_quantile_grid_narrow(
        0.9, les, jnp.asarray(dd16), jnp.asarray(first_d), n, gids, G,
        out_ts, WINDOW, fn, 0, IV, corr=(jnp.asarray(corr[0]),
                                         jnp.asarray(corr[1]))))
    got = tgf.fused_hist_quantile_grid_narrow(
        0.9, les, torch.from_numpy(dd16), torch.from_numpy(first_d),
        torch.from_numpy(n), torch.from_numpy(gids), G, out_ts, WINDOW, fn,
        0, IV, corr=tuple(torch.from_numpy(c) for c in corr)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-9, equal_nan=True)


@pytest.mark.parametrize("fn", ("rate", "increase", "sum_over_time",
                                "last_over_time", "last_sample"))
def test_periodic_samples_hist_matches_jax(fn):
    """The general kernel the cohort-pool rows go through: jittered
    timestamps, a counter reset, short rows."""
    rng = np.random.default_rng(131)
    P, C, B = 8, 40, 4
    ts = (np.arange(C, dtype=np.int64)[None, :] * IV + 1_000_000
          + rng.integers(0, 900, (P, C)))
    val = np.cumsum(np.cumsum(rng.poisson(1.0, (P, C, B)), axis=1),
                    axis=2).astype(np.float32)
    val[2, 20:] -= val[2, 20]
    n = np.array([40, 40, 40, 10, 1, 0, 33, 40], np.int32)
    ts = np.where(np.arange(C)[None, :] < n[:, None], ts, 1 << 62)
    out_ts = np.arange(1_000_000, 1_000_000 + C * IV, 20_000, dtype=np.int64)
    ref = np.asarray(jrf.periodic_samples_hist(
        jnp.asarray(ts), jnp.asarray(val), jnp.asarray(n), out_ts, 60_000,
        fn, 30_000.0))
    got = trf.periodic_samples_hist(torch.from_numpy(ts), torch.from_numpy(val),
                                    torch.from_numpy(n), out_ts, 60_000, fn,
                                    30_000.0).numpy()
    assert got.shape == ref.shape == (P, len(out_ts), B)
    np.testing.assert_allclose(got, ref, rtol=1e-12, equal_nan=True)
