"""The general histogram path end to end: ingest -> flush -> PromQL over
native histograms in both packages.

The same seeded cumulative bucket counts (with their ``sum`` and ``count``
columns) go through each package's RecordBuilder, ingest and flush; then
the JAX QueryEngine and the port's ``QueryEngine(device="cpu")`` answer
histogram queries off the fused-hist pattern: the range functions
``rate``/``increase``/``delta``/``sum_over_time``/``last_over_time`` and
the instant selector over [S, C, B] blocks, per-series
``histogram_quantile``/``histogram_max_quantile``, ``histogram_bucket``,
the bucket-wise ``sum``/``count``/``group``, ``__col__`` over the
schema's scalar columns, and the typed errors the reference raises.

Shards: grid-aligned; a churned late-start cohort; off the scrape grid;
an aligned shard whose rows include non-integer and reset series (the
hist-resident store's cohort pool); a dataset over two shards. Each in
residency "off" (raw f32) and "all" (i8/i16 2D-delta). The oracle for
integer-only data is the JAX engine in the same residency; for the pooled
shard in "all" the values come from the JAX engine in "off" (the JAX
package's encoder truncates non-integer dd: ROADMAP queue 3), the route
and ``QueryStats`` from the one in "all".

Tolerances: answers that are integer-valued (selected counts, their
window sums and last values, count/group, bucket picks of those) agree
bit for bit; the rest within rtol 1e-5 of the array's largest magnitude.
Keys (with their order), the bucket tops, NaN placement, ``exec_path``
(before its implementation bracket) and ``QueryStats`` agree exactly.
"""

import numpy as np
import pytest

from filodb_tpu.core.memstore import StoreConfig as JStoreConfig
from filodb_tpu.core.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.core.record import RecordBuilder as JRecordBuilder
from filodb_tpu.core.schemas import PROM_HISTOGRAM as JPROM_HISTOGRAM
from filodb_tpu.query.engine import QueryEngine as JQueryEngine
from filodb_tpu_torch.core.memstore import StoreConfig, TimeSeriesMemStore
from filodb_tpu_torch.core.record import RecordBuilder
from filodb_tpu_torch.core.schemas import PROM_HISTOGRAM
from filodb_tpu_torch.ops import gridfns, rangefns
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.query.rangevector import QueryError

START = 1_000_000
IV = 10_000
N = 96
B = 8
N_SERIES = 12
RANGE = (START + 300_000, START + 800_000, 30_000)
LAYOUTS = ("aligned", "churned", "offgrid", "pooled", "two_shard")

QUERIES = (
    "rate(h[2m])", "increase(h[3m])", "delta(h[2m])", "sum_over_time(h[2m])",
    "last_over_time(h[2m])", "h",
    "histogram_quantile(0.9, rate(h[2m]))",
    "histogram_max_quantile(0.75, increase(h[3m]))",
    "histogram_bucket(8, rate(h[2m]))", "histogram_bucket(4, h)",
    "sum by (host) (rate(h[2m]))", "sum(increase(h[3m]))",
    "count(rate(h[2m]))", "count by (host) (h)",
    "histogram_quantile(0.9, sum by (host) (rate(h[2m])))",
    "histogram_quantile(0.5, sum(last_over_time(h[2m])))",
    'rate(h{__col__="sum"}[2m]) / rate(h{__col__="count"}[2m])',
    'sum(rate(h{__col__="sum"}[2m])) / sum(rate(h{__col__="count"}[2m]))',
)
# integer-valued on integer data (the selected counts, their window sums
# and last values, series counts)
EXACT = {"sum_over_time(h[2m])", "last_over_time(h[2m])", "h",
         "histogram_bucket(4, h)", "count(rate(h[2m]))",
         "count by (host) (h)"}
# integer-valued whatever the rows hold
EXACT_ANY = {"last_over_time(h[2m])", "h", "histogram_bucket(4, h)",
             "count(rate(h[2m]))", "count by (host) (h)"}


def les_of(nb):
    return np.concatenate([2.0 ** np.arange(nb - 1), [np.inf]])


def ingest(ms, builder, schema, layout):
    """Integer cumulative counts with their sum and count columns, one
    container per series. ``churned``: a sixth of the series start 20
    cells late; ``offgrid``: timestamps a few ms off the grid; ``pooled``:
    one series scaled by 0.3 and one with a counter reset (the cohort
    pool of a hist-resident store); ``two_shard``: series
    alternate between shards 0 and 1."""
    rng = np.random.default_rng(11)
    les = les_of(B)
    mids = np.concatenate([[0.5], 0.75 * les[1:-1], [1.5 * les[-2]]])
    for s in range(N_SERIES):
        late = 20 if layout == "churned" and s % 6 == 5 else 0
        c = np.cumsum(np.cumsum(rng.poisson(0.5, (N, B)), axis=0),
                      axis=1).astype(np.float64)
        if layout == "pooled" and s == 1:
            c = c * 0.3
        elif layout == "pooled" and s == 4:
            c[50:] -= c[50]
        obs = np.diff(c, axis=1, prepend=0.0) @ mids
        b = builder(schema, bucket_les=les)
        for t in range(late, N):
            ts = START + t * IV + (int(rng.integers(1, 900))
                                   if layout == "offgrid" else 0)
            b.add({"_metric_": "h", "host": f"h{s % 4}", "inst": f"i{s}"},
                  ts, {"sum": float(obs[t]), "count": float(c[t, -1]),
                       "h": c[t]})
        ms.ingest("prometheus", s % 2 if layout == "two_shard" else 0,
                  b.build())


def build(mem_cls, cfg_cls, builder, schema, mode, layout, **dev):
    ms = mem_cls(**dev)
    for shard in range(2 if layout == "two_shard" else 1):
        ms.setup("prometheus", schema, shard, cfg_cls(
            max_series_per_shard=16, samples_per_series=128,
            flush_batch_size=10**9, compressed_residency=mode, **dev))
    ingest(ms, builder, schema, layout)
    ms.flush_all()
    return ms


def engines_for(mode, layout):
    """(values oracle, route oracle, port engine) for one shard layout."""
    def jax_engine(m):
        return JQueryEngine(build(JMemStore, JStoreConfig, JRecordBuilder,
                                  JPROM_HISTOGRAM, m, layout), "prometheus")
    ms = build(TimeSeriesMemStore, StoreConfig, RecordBuilder, PROM_HISTOGRAM,
               mode, layout, device="cpu")
    route = jax_engine(mode)
    values = (jax_engine("off") if layout == "pooled" and mode == "all"
              else route)
    return values, route, QueryEngine(ms, "prometheus", device="cpu")


@pytest.fixture(scope="module", params=[(m, lay) for m in ("off", "all")
                                        for lay in LAYOUTS],
                ids=lambda p: f"{p[0]}-{p[1]}")
def engines(request):
    mode, layout = request.param
    return engines_for(mode, layout) + (mode, layout)


def assert_same(got, ref, route, q, exact):
    """Keys in order, bucket tops, NaN placement, values, route, stats."""
    assert [k.labels for k in got.matrix.keys] == \
        [k.labels for k in ref.matrix.keys], q
    np.testing.assert_array_equal(got.matrix.out_ts, ref.matrix.out_ts)
    assert (got.matrix.bucket_les is None) == (ref.matrix.bucket_les is None)
    if ref.matrix.bucket_les is not None:
        np.testing.assert_array_equal(got.matrix.bucket_les,
                                      ref.matrix.bucket_les)
    r = np.asarray(ref.matrix.values, np.float64)
    g = np.asarray(got.matrix.values, np.float64)
    assert g.shape == r.shape, (q, g.shape, r.shape)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(r), err_msg=q)
    if exact:
        np.testing.assert_array_equal(g, r, err_msg=q)
    else:
        scale = float(np.nanmax(np.abs(np.where(np.isinf(r), np.nan, r)),
                                initial=0.0))
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5 * scale,
                                   equal_nan=True, err_msg=q)
    assert got.exec_path.split("[")[0] == route.exec_path.split("[")[0], \
        (q, got.exec_path, route.exec_path)
    for f in ("fused_kernels", "series_matched", "blocks_raw",
              "blocks_narrow"):
        assert getattr(got.stats, f) == getattr(route.stats, f), (q, f)


@pytest.mark.parametrize("q", QUERIES)
def test_query_range_matches_jax_engine(engines, q):
    jvals, jroute, teng, _mode, layout = engines
    ref = jvals.query_range(q, *RANGE)
    route = jroute.query_range(q, *RANGE) if jroute is not jvals else ref
    got = teng.query_range(q, *RANGE)
    assert got.matrix.num_series > 0, q
    assert_same(got, ref, route, q,
                q in (EXACT_ANY if layout == "pooled" else EXACT))


@pytest.mark.parametrize("q", ("group by (host) (h)", "group(rate(h[2m]))"))
def test_group_reduces_bucket_wise(engines, q):
    """``group`` has no PromQL spelling in either parser: the plan of
    ``count`` with its operator replaced runs through both engines."""
    import dataclasses

    from filodb_tpu.promql import parser as jparser
    from filodb_tpu_torch.promql import parser as tparser
    jvals, jroute, teng, _mode, _layout = engines
    text = q.replace("group", "count", 1)

    def plan(parser):
        p = parser.query_to_logical_plan(text, *RANGE)
        return dataclasses.replace(p, operator="group")
    ref = jvals.exec_logical(plan(jparser))
    route = jroute.exec_logical(plan(jparser)) if jroute is not jvals else ref
    got = teng.exec_logical(plan(tparser))
    assert_same(got, ref, route, q, True)
    assert np.nanmax(np.asarray(got.matrix.values)) == 1.0


@pytest.mark.parametrize("q", ("h", "histogram_quantile(0.9, rate(h[2m]))",
                               "sum by (host) (increase(h[3m]))"))
def test_query_instant_matches_jax_engine(engines, q):
    jvals, jroute, teng, _mode, layout = engines
    t = START + 700_000
    ref = jvals.query_instant(q, t)
    route = jroute.query_instant(q, t) if jroute is not jvals else ref
    got = teng.query_instant(q, t)
    assert got.result_type == ref.result_type == "vector"
    assert_same(got, ref, route, q, q == "h")


@pytest.mark.parametrize("q", ("rate(h[2m])", "sum by (host) (h)"))
def test_le_expansion_of_iter_series_matches_jax(engines, q):
    """A histogram result reads as one ``le``-labelled series per bucket,
    ``le`` rendered with the reference's round-trip formatting."""
    jvals, _jroute, teng, _mode, _layout = engines
    ref = list(jvals.query_range(q, *RANGE).matrix.iter_series())
    got = list(teng.query_range(q, *RANGE).matrix.iter_series())
    assert [k.labels for k, _t, _v in got] == [k.labels for k, _t, _v in ref]
    assert {dict(k.labels)["le"] for k, _t, _v in got} == \
        {"1", "2", "4", "8", "16", "32", "64", "+Inf"}
    for (_k, gt, gv), (_r, rt, rv) in zip(got, ref):
        np.testing.assert_array_equal(gt, rt)
        np.testing.assert_allclose(gv, rv, rtol=1e-5)


@pytest.mark.parametrize("q", ("max(rate(h[5m]))", "irate(h[5m])",
                               "topk(1, rate(h[5m]))",
                               "quantile(0.5, rate(h[5m]))",
                               "abs(rate(h[5m]))"))
def test_unsupported_histogram_queries_raise_like_the_reference(q):
    jeng, _route, teng = engines_for("all", "aligned")
    with pytest.raises(Exception) as ref:
        jeng.query_range(q, *RANGE)
    with pytest.raises(QueryError) as got:
        teng.query_range(q, *RANGE)
    assert str(got.value) == str(ref.value)


def test_empty_selection_keeps_the_bucket_tops():
    jeng, _route, teng = engines_for("all", "aligned")
    for q in ("rate(nope[2m])", "sum(rate(nope[2m]))"):
        ref = jeng.query_range(q, *RANGE)
        got = teng.query_range(q, *RANGE)
        assert got.matrix.num_series == ref.matrix.num_series == 0
        np.testing.assert_array_equal(got.matrix.bucket_les,
                                      ref.matrix.bucket_les)
        assert np.asarray(got.matrix.values).shape == \
            np.asarray(ref.matrix.values).shape


def test_resident_general_path_gathers_without_a_whole_block_decode():
    """On a hist-resident store the general path streams the 2D-delta
    block; only a narrow selection's rows are decoded, never the block."""
    _jeng, _route, teng = engines_for("all", "pooled")
    st = teng.memstore.shard("prometheus", 0).store
    assert st.is_narrow_resident
    calls = {"v": 0, "t": 0}
    orig_v, orig_t = st.value_block, st.ts_block
    st.value_block = lambda: calls.__setitem__("v", calls["v"] + 1) or orig_v()
    st.ts_block = lambda: calls.__setitem__("t", calls["t"] + 1) or orig_t()
    for q in ("rate(h[2m])", 'sum by (host) (rate(h{inst=~"i1|i2"}[2m]))',
              "histogram_quantile(0.9, rate(h[2m]))"):
        assert teng.query_range(q, *RANGE).matrix.num_series > 0
    assert calls == {"v": 0, "t": 0}, calls


@pytest.mark.parametrize("fn", sorted(gridfns.HIST_GRID_FNS))
@pytest.mark.parametrize("narrow", (False, True))
def test_hist_grid_row_chunks_do_not_change_the_answer(monkeypatch, fn,
                                                       narrow):
    """The histogram grid functions run rows in chunks of at most
    ``rangefns.CHUNK_BYTES`` of transients: bit for bit one chunk's."""
    import torch
    from filodb_tpu_torch.ops import narrow as nw
    rng = np.random.default_rng(3)
    S, C = 40, 64
    c = np.cumsum(np.cumsum(rng.poisson(0.5, (S, C, B)), axis=1),
                  axis=2).astype(np.float32)
    n = torch.from_numpy(rng.integers(0, C + 1, S).astype(np.int32))
    out_ts = START + np.arange(8, C, 3, dtype=np.int64) * IV
    args = (out_ts, 120_000, fn, START, IV)
    if narrow:
        dd, first_d = nw.build_narrow_hist(torch.from_numpy(c), n)[:2]
        dd = nw.cast_narrow_hist_i8(dd)
        whole = gridfns.periodic_samples_grid_hist_narrow(dd, first_d, n,
                                                          *args)
        monkeypatch.setattr(rangefns, "CHUNK_BYTES", 1)
        parts = gridfns.periodic_samples_grid_hist_narrow(dd, first_d, n,
                                                          *args)
    else:
        val = torch.from_numpy(c)
        whole = gridfns.periodic_samples_grid_hist(val, n, *args)
        monkeypatch.setattr(rangefns, "CHUNK_BYTES", 1)
        parts = gridfns.periodic_samples_grid_hist(val, n, *args)
    assert whole.shape == (S, len(out_ts), B)
    assert torch.isfinite(whole).any()
    torch.testing.assert_close(parts, whole, rtol=0, atol=0, equal_nan=True)


def test_rate_over_a_histogram_answers_on_the_small_engine():
    """Was a case of tests/test_torch_engine.py's unported-route test: a
    range function over a histogram dataset now answers as the reference
    does."""
    jeng, _route, teng = engines_for("off", "aligned")
    q = "rate(h[5m])"
    ref = jeng.query_range(q, *RANGE)
    got = teng.query_range(q, *RANGE)
    assert_same(got, ref, ref, q, False)
