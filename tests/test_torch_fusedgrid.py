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


# -- the decode variants (quant16, delta16, delta8) ----------------------------

from filodb_tpu_torch.ops import decodereg  # noqa: E402
from filodb_tpu_torch.ops import narrow as tnarrow  # noqa: E402

KINDS = ("quant16", "delta16", "delta8")


def narrow_block(kind, S, C, seed):
    """(ops, n, dec): an [S, C] store of ``kind`` through the port's
    encoder — ``ops = (block, *row_operands)`` as torch tensors — with short
    rows, and one row in 8 excluded as a cohort-pool row is (n = 0, a
    garbage block, a NaN row operand); ``dec`` is the decoded f32 block."""
    rng = np.random.default_rng(seed)
    if kind == "delta8":               # counters: small integer increments
        val = (np.cumsum(rng.integers(0, 30, (S, C)), axis=1)
               + rng.integers(0, 1 << 20, (S, 1)))
    elif kind == "delta16":            # wider increments
        val = np.cumsum(rng.integers(200, 3000, (S, C)), axis=1)
    else:                              # half-integer gauges
        val = (1000.0 + 0.5 * np.cumsum(rng.integers(0, 3, (S, C)), axis=1)
               + rng.integers(0, 100, (S, 1)))
    val = val.astype(np.float32)
    n = np.full(S, C, np.int32)
    short = rng.choice(S, max(1, S // 4), replace=False)
    n[short] = rng.integers(0, C, len(short))
    t_val, t_n = torch.from_numpy(val), torch.from_numpy(n)
    if kind == "quant16":
        q, vmin, scale, ok = tnarrow.build_narrow(t_val, t_n)
        ops = [q, vmin, scale]
    else:
        dv, anchor, ok16, ok8, _ = tnarrow.build_narrow_delta(t_val, t_n)
        ok = ok8 if kind == "delta8" else ok16
        ops = [tnarrow.cast_narrow_delta_i8(dv) if kind == "delta8" else dv,
               anchor]
    assert bool(ok.all())
    pool = np.arange(S) % 8 == 3
    n[pool] = 0
    lim = 127 if kind == "delta8" else 32767
    ops[0][torch.from_numpy(pool)] = torch.from_numpy(
        rng.integers(-lim, lim, (int(pool.sum()), C))).to(ops[0].dtype)
    ops[1][torch.from_numpy(pool)] = float("nan")
    var = decodereg.variant(kind)
    dec = var.decode(ops[0], *(o[:, None] for o in ops[1:]))
    return tuple(ops), n, dec


def run_narrow(op, fn, kind, ops, n, gids, num_groups, out_ts,
               variant="xla"):
    jops = tuple(jnp.asarray(o.numpy()) for o in ops)
    ref = jfg.fused_grid_aggregate(op, fn, None, jnp.asarray(n),
                                   jnp.asarray(gids), num_groups, out_ts,
                                   WINDOW, 0, IV, narrow=(kind, jops),
                                   variant=variant)
    got = tfg.fused_grid_aggregate(op, fn, None, torch.from_numpy(n),
                                   torch.from_numpy(gids), num_groups, out_ts,
                                   WINDOW, 0, IV, narrow=(kind, ops))
    return {k: np.asarray(v) for k, v in ref.items()}, got


def assert_narrow_parts(ref, got, what):
    """Counts bit for bit; the rest within rtol 1e-5 of the largest
    magnitude (the folds sum rows in different orders)."""
    assert set(ref) == set(got), what
    for k in ref:
        r, g = ref[k], got[k]
        assert r.shape == g.shape and g.dtype == np.float32, (what, k)
        if k == "count":
            np.testing.assert_array_equal(g, r, err_msg=f"{what} {k}")
        else:
            scale = float(np.abs(r).max(initial=0.0))
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5 * scale,
                                       err_msg=f"{what} {k}")


@pytest.mark.parametrize("fn", FNS)
@pytest.mark.parametrize("kind", KINDS)
def test_narrow_fn_op_grid_matches_jax(kind, fn):
    ops, n, _ = narrow_block(kind, 512, 128, seed=61)
    gids = np.random.default_rng(62).integers(0, 8, 512).astype(np.int32)
    for op in OPS:
        ref, got = run_narrow(op, fn, kind, ops, n, gids, 8,
                              out_steps(128, False))
        assert_narrow_parts(ref, got, f"{kind} {fn} {op}")


@pytest.mark.parametrize("sub", (False, True))
@pytest.mark.parametrize("G", (8, 64))
@pytest.mark.parametrize("kind", KINDS)
def test_narrow_groups_and_subranges_match_jax(kind, G, sub):
    """G in {8, 64}; a sub-range query on C = 256, where quant16 reads only
    its active columns (c0 > 0) and the delta variants the whole row."""
    ops, n, _ = narrow_block(kind, 4096, 256, seed=70 + G + sub)
    gids = np.random.default_rng(G).integers(0, G, 4096).astype(np.int32)
    out_ts = out_steps(256, sub)
    for fn in ("rate", "delta", "avg_over_time"):
        ref, got = run_narrow("stddev", fn, kind, ops, n, gids, G, out_ts)
        assert_narrow_parts(ref, got, f"{kind} G={G} sub={sub} {fn}")


@pytest.mark.parametrize("kind", KINDS)
def test_narrow_plain_matches_pallas_interpret(kind):
    """The Pallas kernel with the variant's decode stage (interpret mode)."""
    ops, n, _ = narrow_block(kind, 512, 128, seed=81)
    gids = np.random.default_rng(82).integers(0, 8, 512).astype(np.int32)
    ref, got = run_narrow("stddev", "rate", kind, ops, n, gids, 8,
                          out_steps(128, False), variant="pallas")
    assert_narrow_parts(ref, got, f"{kind} pallas")


@pytest.mark.parametrize("sub", (False, True))
@pytest.mark.parametrize("kind", KINDS)
def test_narrow_plain_equals_plain_on_the_decoded_block(kind, sub):
    """Over the same columns the twin on a narrow block equals the twin on
    its decoded f32 block bit for bit: the decode is exact and the rest of
    the walk is the same. Through fused_grid_aggregate a sub-range query
    reads the delta variants' whole rows but the raw block's active columns
    only: a longer product, another rounding — the 1e-5 bar there alone."""
    C = 256
    ops, n, dec = narrow_block(kind, 4096, C, seed=90 + sub)
    gids = np.random.default_rng(91).integers(0, 8, 4096).astype(np.int32)
    t_n, t_g = torch.from_numpy(n), torch.from_numpy(gids)
    out_ts = out_steps(C, sub)
    Tp = -(-len(out_ts) // 128) * 128
    full = decodereg.variant(kind).full_columns
    for fn in ("rate", "sum_over_time"):
        fk = "window" if fn in tfg.FUSED_WINDOW_FNS else "rate"
        band, ohlo, lo, hi, rel, c0, Ca = (
            *(torch.from_numpy(a) for a in tfg.host_operands(
                C, Tp, out_ts, WINDOW, 0, IV, fk, full)[:5]),
            *tfg.host_operands(C, Tp, out_ts, WINDOW, 0, IV, fk, full)[5:])
        a = tfg.fused_grid_aggregate_plain(fn, True, WINDOW, IV, ops[0], t_n,
                                           t_g, band, ohlo, lo, hi, rel, 8,
                                           c0, Ca, kind, ops[1:])
        b = tfg.fused_grid_aggregate_plain(fn, True, WINDOW, IV, dec, t_n,
                                           t_g, band, ohlo, lo, hi, rel, 8,
                                           c0, Ca)
        for x, y in zip(a, b):
            assert torch.equal(x, y), (kind, sub, fn)
        narrow = tfg.fused_grid_aggregate("sum", fn, None, t_n, t_g, 8, out_ts,
                                          WINDOW, 0, IV, narrow=(kind, ops))
        raw = tfg.fused_grid_aggregate("sum", fn, dec, t_n, t_g, 8, out_ts,
                                       WINDOW, 0, IV)
        if sub and full:
            assert_narrow_parts(raw, narrow, f"{kind} {fn}")
        else:
            for k in raw:
                np.testing.assert_array_equal(narrow[k], raw[k])


def test_the_kernel_refuses_what_it_does_not_take():
    """Every refusal happens before a launch, whatever the tensors' device:
    a CPU block, a dtype that is not the variant's, a delta variant with
    c0 > 0, missing or mis-shaped row operands, an unknown variant."""
    ops, n, _ = narrow_block("delta8", 512, 128, seed=95)
    t_n = torch.from_numpy(n)
    g = torch.zeros(512, dtype=torch.int32)
    lo = torch.zeros(128, dtype=torch.int32)
    before = tfg.fused_grid_kernel.launches
    cases = [
        (ops[0], "delta8", ops[1:], 0, None, "CUDA"),
        (ops[0].to(torch.int16), "delta8", ops[1:], 0, None, "int8"),
        (ops[0], "delta8", ops[1:], 64, 64, "whole rows"),
        (ops[0], "delta8", (), 0, None, "row operands"),
        (ops[0], "delta8", (ops[1][:8],), 0, None, "row operands"),
        (ops[0], "delta4", ops[1:], 0, None, "unknown decode variant"),
    ]
    for blk, kind, rows, c0, Ca, what in cases:
        with pytest.raises(ValueError, match=what):
            tfg.fused_grid_kernel("rate", False, WINDOW, IV, blk, t_n, g, lo,
                                  lo, lo, 8, c0, Ca, kind, rows)
    assert tfg.fused_grid_kernel.launches == before
