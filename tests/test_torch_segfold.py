"""The port's segment fold against the reference's ``segment_sum``.

``filodb_tpu.ops.aggregators.partial_aggregate`` folds rows with
``jax.ops.segment_sum`` whenever ``stable=True`` or G > 64: each group's rows
in row order, each column on its own. The port's ``partial_aggregate`` takes
``ops/segfold.py`` there (its CUDA kernel on the card, the ``index_add_``
twin on the CPU). The same seeded non-integer f64 matrices, with NaN cells,
a series with no samples, an empty group and out-of-range group ids, go
through both packages, and every partial must agree bit for bit: no
tolerance, since both add the same f64 values in the same order. Padding
the steps to a bucket or adding rows of no group changes no bit. The twin
(``index_add_``), the dispatcher and a numpy loop in row order give the
same bits, f32 values included; an empty matrix folds to zeros. Through the engine, the
composed path's aggregates over an f64 store reach the fold and agree with
the JAX package's bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from filodb_tpu.core.memstore import StoreConfig as JStoreConfig
from filodb_tpu.core.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.core.record import RecordBuilder as JRecordBuilder
from filodb_tpu.core.schemas import GAUGE as JGAUGE
from filodb_tpu.ops import aggregators as jagg
from filodb_tpu.query.engine import QueryEngine as JQueryEngine
from filodb_tpu_torch.core.memstore import StoreConfig, TimeSeriesMemStore
from filodb_tpu_torch.core.record import RecordBuilder
from filodb_tpu_torch.core.schemas import GAUGE
from filodb_tpu_torch.ops import aggregators as tagg
from filodb_tpu_torch.ops import kernels
from filodb_tpu_torch.ops import segfold
from filodb_tpu_torch.query.engine import QueryEngine


def matrix(S, T, seed, dtype=np.float64):
    """Non-integer values spanning many magnitudes (every add rounds), one
    cell in five NaN, row 3 a series with no samples, a -0.0 cell."""
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal((S, T)) * 10.0 ** rng.integers(-3, 6, (S, T))
         ).astype(dtype)
    v[rng.random((S, T)) < 0.2] = np.nan
    v[3] = np.nan
    v[5, 0] = -0.0
    return v


def group_ids(S, G, seed):
    """Ids in [0, G) but for group 1, which stays empty, and one row in
    ten outside [0, G) (-1, G, G + 7)."""
    rng = np.random.default_rng(seed + 100)
    g = rng.integers(0, G, S)
    if G > 2:
        g[g == 1] = 0
    out = rng.random(S) < 0.1
    g[out] = rng.choice([-1, G, G + 7], int(out.sum()))
    return g.astype(np.int32)


def assert_bits(got: dict, ref: dict):
    assert set(got) == set(ref)
    for k in ref:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        r = np.asarray(ref[k])
        assert g.dtype == r.dtype and g.shape == r.shape, k
        # view as integers: -0.0 against +0.0 and NaN payloads count
        assert np.array_equal(g.view(np.int64 if g.itemsize == 8
                                     else np.int32),
                              r.view(np.int64 if r.itemsize == 8
                                     else np.int32)), k


def both(op, v, gids, G, stable):
    ref = jagg.partial_aggregate(op, jnp.asarray(v), jnp.asarray(gids), G,
                                 stable=stable)
    got = tagg.partial_aggregate(op, torch.from_numpy(v),
                                 torch.from_numpy(gids), G, stable=stable)
    return got, ref


@pytest.mark.parametrize("G, stable", [(1, True), (8, True), (64, True),
                                       (65, False), (4096, False)])
@pytest.mark.parametrize("op", tagg.BASIC_OPS)
def test_segment_fold_matches_jax_bit_for_bit(op, G, stable):
    S = 3 * G + 200
    v, gids = matrix(S, 13, G), group_ids(S, G, G)
    got, ref = both(op, v, gids, G, stable)
    assert_bits(got, ref)
    if "count" in got:
        assert float(got["count"][min(1, G - 1)].sum()) == 0 or G <= 2


@pytest.mark.parametrize("G, stable", [(8, True), (300, False)])
@pytest.mark.parametrize("op", ("sum", "stddev", "count"))
def test_step_bucket_padding_leaves_the_first_steps_alone(op, G, stable):
    """Padding T to its step bucket (the padded columns hold anything)
    leaves the first T columns' bits as they were."""
    T, Tp = 11, 32
    v = matrix(900, Tp, 7)
    gids = group_ids(900, G, 7)
    short = tagg.partial_aggregate(op, torch.from_numpy(
        np.ascontiguousarray(v[:, :T])), torch.from_numpy(gids), G,
        stable=stable)
    padded = tagg.partial_aggregate(op, torch.from_numpy(v),
                                    torch.from_numpy(gids), G, stable=stable)
    assert_bits({k: t[:, :T].contiguous() for k, t in padded.items()}, short)
    ref = jagg.partial_aggregate(op, jnp.asarray(v), jnp.asarray(gids), G,
                                 stable=stable)
    assert_bits(padded, ref)


@pytest.mark.parametrize("G, stable", [(8, True), (300, False)])
@pytest.mark.parametrize("op", ("sum", "stdvar", "count"))
def test_rows_of_no_group_change_no_bit(op, G, stable):
    """Rows with an out-of-range group id, appended at the end (row
    padding) or spread between the others, change no bit."""
    v = matrix(700, 9, 11)
    gids = group_ids(700, G, 11)
    base = tagg.partial_aggregate(op, torch.from_numpy(v),
                                  torch.from_numpy(gids), G, stable=stable)
    rng = np.random.default_rng(5)
    extra = matrix(300, 9, 12)
    pad_ids = rng.choice([-1, G, G + 3], 300).astype(np.int32)
    tail = tagg.partial_aggregate(
        op, torch.from_numpy(np.concatenate([v, extra])),
        torch.from_numpy(np.concatenate([gids, pad_ids])), G, stable=stable)
    assert_bits(tail, base)
    at = np.sort(rng.choice(1000, 300, replace=False))
    keep = np.setdiff1d(np.arange(1000), at)
    mixed_v = np.empty((1000, 9))
    mixed_g = np.empty(1000, np.int32)
    mixed_v[keep], mixed_g[keep] = v, gids
    mixed_v[at], mixed_g[at] = extra, pad_ids
    spread = tagg.partial_aggregate(op, torch.from_numpy(mixed_v),
                                    torch.from_numpy(mixed_g), G,
                                    stable=stable)
    assert_bits(spread, base)


def row_order_loop(v, gids, G):
    """The fold written out: per group, the rows in ascending order, each
    zeroed value widened to f64 and added to a +0.0 start; squares in the
    values' dtype."""
    S, T = v.shape
    out = {k: np.zeros((G, T)) for k in ("sum", "sumsq", "count")}
    for r in range(S):
        g = int(gids[r])
        if not 0 <= g < G:
            continue
        present = ~np.isnan(v[r])
        z = np.where(present, v[r], v.dtype.type(0))
        out["sum"][g] = out["sum"][g] + z.astype(np.float64)
        out["sumsq"][g] = out["sumsq"][g] + (z * z).astype(np.float64)
        out["count"][g] += present
    return out


@pytest.mark.parametrize("dtype", (np.float32, np.float64))
@pytest.mark.parametrize("G", (1, 5, 70))
def test_twins_fold_in_row_order(G, dtype):
    """index_add_ (the CPU twin), the dispatcher on a CPU tensor and a
    numpy loop in row order: the same bits."""
    v = matrix(1500, 7, G + 1, dtype)
    gids = group_ids(1500, G, G + 1)
    want = row_order_loop(v, gids, G)
    tv, tg = torch.from_numpy(v), torch.from_numpy(gids)
    for fold in (segfold.segment_fold_plain, segfold.segment_fold):
        got = fold(tv, tg, G, sumsq=True)
        assert_bits(got, want)
        assert_bits(fold(tv, tg, G), {k: want[k] for k in ("sum", "count")})


@pytest.mark.parametrize("dtype", (np.float32, np.float64))
@pytest.mark.parametrize("op", tagg.BASIC_OPS)
def test_partial_aggregate_is_the_twin_rounded_once(op, dtype):
    """Through ``partial_aggregate`` (stable) the partials are the twin's
    f64 folds rounded once to the values' dtype."""
    v = matrix(800, 6, 3, dtype)
    gids = group_ids(800, 90, 3)
    tv, tg = torch.from_numpy(v), torch.from_numpy(gids)
    got = tagg.partial_aggregate(op, tv, tg, 90, stable=True)
    twin = segfold.segment_fold_plain(tv, tg, 90, sumsq=True)
    for k in got:
        if k in twin:
            assert_bits({k: got[k]}, {k: twin[k].to(tv.dtype)})


def test_one_fold_per_partial_aggregate(monkeypatch):
    """The segment branch (stable, or G > 64) makes one fold call for the
    ops that sum values, which gives sum, sumsq and count together; count,
    group, min and max take the integer count instead, and the one-hot
    branch makes none."""
    calls = []
    real = segfold.segment_fold

    def counting(values, gids, num_groups, sumsq=False):
        calls.append((num_groups, sumsq))
        return real(values, gids, num_groups, sumsq)

    monkeypatch.setattr(segfold, "segment_fold", counting)
    v, tg = torch.from_numpy(matrix(300, 4, 1)), torch.zeros(300, dtype=torch.int32)
    for op in tagg.BASIC_OPS:
        tagg.partial_aggregate(op, v, tg, 8, stable=True)
        tagg.partial_aggregate(op, v, tg, 65)
        tagg.partial_aggregate(op, v, tg, 8)
    folded = [op in ("stddev", "stdvar") for op in tagg.BASIC_OPS
              if op in ("sum", "avg", "stddev", "stdvar")]
    assert calls == [(g, sq) for sq in folded for g in (8, 65)]


def test_group_rows_lists_each_group_in_row_order():
    rng = np.random.default_rng(2)
    G = 9
    gids = rng.integers(-2, G + 2, 500)
    order, offsets = segfold.group_rows(torch.from_numpy(gids), G)
    assert order.dtype == offsets.dtype == torch.int64
    assert offsets.shape == (G + 1,) and int(offsets[0]) == 0
    for g in range(G):
        rows = order[offsets[g]:offsets[g + 1]].numpy()
        np.testing.assert_array_equal(rows, np.flatnonzero(gids == g))
    assert int(offsets[G]) == int(((gids >= 0) & (gids < G)).sum())


def test_one_dimensional_and_integer_values():
    """[S] values give [G] partials; integer values fold as their float
    promotion, every row present."""
    v = matrix(200, 1, 4)[:, 0]
    gids = torch.from_numpy(group_ids(200, 70, 4))
    got = tagg.partial_aggregate("stddev", torch.from_numpy(v), gids, 70)
    ref = jagg.partial_aggregate("stddev", jnp.asarray(v),
                                 jnp.asarray(gids.numpy()), 70)
    assert_bits(got, ref)
    iv = torch.arange(200, dtype=torch.int64)[:, None]
    got = tagg.partial_aggregate("sum", iv, gids, 70)
    twin = segfold.segment_fold_plain(iv.to(torch.float64), gids, 70)
    assert_bits(got, twin)


@pytest.mark.parametrize("shape", [(0,), (0, 13)], ids=["1-D", "2-D"])
@pytest.mark.parametrize("sumsq", (False, True))
def test_empty_matrix_folds_to_zeros(shape, sumsq):
    """S = 0 (a set operator with no match feeds the map phase an empty
    matrix): every group's sums and counts are +0.0, as the reference's."""
    v = np.zeros(shape)
    gids = np.zeros(0, np.int32)
    got = segfold.segment_fold(torch.from_numpy(v), torch.from_numpy(gids),
                               8, sumsq)
    zeros = np.zeros((8,) + shape[1:])
    assert_bits(got, {k: zeros for k in (("sum", "count", "sumsq") if sumsq
                                         else ("sum", "count"))})
    for op in ("sum", "stddev", "count"):
        got, ref = both(op, v, gids, 8, True)
        assert_bits(got, ref)


S_OK, G_OK = 64, 4


def fold_args(**over):
    a = dict(values=torch.zeros(S_OK, 3), order=torch.zeros(S_OK, dtype=torch.int64),
             offsets=torch.zeros(G_OK + 1, dtype=torch.int64), num_groups=G_OK)
    a.update(over)
    return a


@pytest.mark.parametrize("over, why", [
    ({}, "CUDA tensor"),
    ({"values": torch.zeros(S_OK, 3, dtype=torch.float16)}, "float32 or float64"),
    ({"values": torch.zeros(S_OK * 3)}, r"contiguous \[S, T\]"),
    ({"values": torch.zeros(3, S_OK).T}, r"contiguous \[S, T\]"),
    ({"order": torch.zeros(S_OK, dtype=torch.int32)}, "order must be int64"),
    ({"order": torch.zeros(S_OK + 1, dtype=torch.int64)}, "order must be int64"),
    ({"offsets": torch.zeros(G_OK, dtype=torch.int64)}, "offsets must be int64"),
    ({"num_groups": -1}, "negative")],
    ids=["cpu", "float16", "one-dim", "column-stride", "order-int32",
         "order-long", "offsets-short", "negative-groups"])
def test_kernel_wrapper_refuses_before_any_build(over, why, monkeypatch):
    def no_build(name):
        raise AssertionError(f"built {name} for an input the fold refuses")
    monkeypatch.setattr(kernels, "load", no_build)
    before = segfold.segment_fold_kernel.launches
    with pytest.raises(ValueError, match=f"segment_fold_kernel: .*{why}"):
        segfold.segment_fold_kernel(**fold_args(**over))
    assert segfold.segment_fold_kernel.launches == before


def test_the_kernel_is_built_with_the_others():
    assert "segfold" in kernels.KERNELS
    assert kernels.lib_path("segfold").endswith(".so")


# -- the slice through the engine: the composed path over an f64 store ----

START, IV, N = 1_700_000_000_000, 10_000, 60
TS_END = START + (N - 1) * IV
RANGE = (START + 120_000, TS_END, 20_000)
N_SERIES = 150


def gauges():
    rng = np.random.default_rng(31)
    out = []
    for s in range(N_SERIES):
        v = rng.standard_normal(N) * 10.0 ** rng.integers(-2, 5)
        if s % 7 == 0:
            v[rng.random(N) < 0.3] = np.nan       # gaps: stale lookback
        out.append(v)
    return out


def f64_store(pkg: str):
    ts = START + np.arange(N, dtype=np.int64) * IV
    if pkg == "jax":
        ms, builder, schema = JMemStore(), JRecordBuilder, JGAUGE
        ms.setup("p", schema, 0, JStoreConfig(
            max_series_per_shard=256, samples_per_series=64,
            flush_batch_size=10**9, dtype="float64"))
    else:
        ms, builder, schema = TimeSeriesMemStore(device="cpu"), RecordBuilder, GAUGE
        ms.setup("p", schema, 0, StoreConfig(
            max_series_per_shard=256, samples_per_series=64,
            flush_batch_size=10**9, device="cpu", dtype="float64"))
    for s, v in enumerate(gauges()):
        keep = ~np.isnan(v)
        b = builder(schema)
        b.add_batch({"_metric_": "m", "job": f"J{s % 3}", "inst": f"i{s}"},
                    ts[keep], v[keep])
        ms.ingest("p", 0, b.build())
    ms.flush_all()
    return ms


@pytest.fixture(scope="module")
def engines():
    return (JQueryEngine(f64_store("jax"), "p"),
            QueryEngine(f64_store("torch"), "p", device="cpu"))


def series(res):
    return {k.labels: np.asarray(v, np.float64)
            for k, _t, v in res.matrix.iter_series()}


ENGINE_QUERIES = ("sum(m)", "avg by (job) (m)", "stddev(m)",
                  "count by (job) (m)", "sum by (inst) (m)",
                  "stdvar by (inst) (m)")


@pytest.mark.parametrize("instant", (True, False), ids=["instant", "range"])
@pytest.mark.parametrize("q", ENGINE_QUERIES)
def test_engine_aggregates_over_f64_match_jax_bit_for_bit(engines, q,
                                                         instant,
                                                         monkeypatch):
    jeng, teng = engines
    calls = []
    real = segfold.segment_fold

    def counting(*a, **k):
        calls.append(a[2])
        return real(*a, **k)

    monkeypatch.setattr(segfold, "segment_fold", counting)
    if instant:
        ref, got = jeng.query_instant(q, TS_END), teng.query_instant(q, TS_END)
    else:
        ref, got = jeng.query_range(q, *RANGE), teng.query_range(q, *RANGE)
    if q.startswith("count"):
        assert not calls, f"{q} folded values it does not need"
    else:
        assert calls, f"{q} did not reach the segment fold"
    r, g = series(ref), series(got)
    assert set(g) == set(r) and r
    for k in r:
        np.testing.assert_array_equal(g[k].view(np.int64),
                                      r[k].view(np.int64), err_msg=f"{q} {k}")


def test_variant_timer_needs_a_card(capsys):
    """The script that times segfold.cu against candidate sources exits 2,
    building nothing, where there is no card."""
    from filodb_tpu_torch.scripts import segfold_variants
    assert segfold_variants.main(["x=missing.cu"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
