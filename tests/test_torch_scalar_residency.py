"""Scalar narrow residency of the port against the JAX package's.

The same seeded gauge/counter samples go through each package's
RecordBuilder(GAUGE) -> TimeSeriesMemStore.ingest -> flush. The port's
store runs ``compressed_residency="gauge"`` (or "all"); the JAX oracle the
same mode (its ``narrow_resident=True`` is "gauge"). Both must pick the
same decode variant by the ladder delta8 -> quant16 -> delta16, store the
same encoder outputs bit for bit, pool the same rows, decline with the
same reason, and answer the slice's fused queries alike: values within
rtol 1e-5 of the result's largest magnitude (pooled rows fold back through
the general kernels in another order), the same keys and the same
``QueryStats`` counters.

The encoders themselves are held against the JAX ones bit for bit on the
reference test's row shapes, on NaN, Inf and empty rows, and at spans of
exactly 65535 * 2^k and one ulp either side (where quant16's scale turns
on how the quotient span / 65535 rounds). One divergence is pinned, not
hidden: XLA's exp2 on the CPU is exact only for a few integer exponents
(-14, -12..12 and some even ones above), so the reference's quant16
scale of a row whose span is below 65535 * 2^-12 (about 16) or above
65535 * 2^12 is not a power of two; the port's always is
(test_reference_quant16_scale_is_not_a_power_of_two_off_its_exact_range).
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from filodb_tpu.core.memstore import StoreConfig as JStoreConfig
from filodb_tpu.core.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.core.record import RecordBuilder as JRecordBuilder
from filodb_tpu.core.schemas import GAUGE as JGAUGE
from filodb_tpu.ops import fusedresident as jfusedresident
from filodb_tpu.ops import narrow as jnarrow
from filodb_tpu.query.engine import QueryEngine as JQueryEngine
from filodb_tpu_torch.core.chunkstore import DeferredDecode, DeferredTs
from filodb_tpu_torch.core.memstore import StoreConfig, TimeSeriesMemStore
from filodb_tpu_torch.core.record import RecordBuilder
from filodb_tpu_torch.core.schemas import GAUGE
from filodb_tpu_torch.ops import decodereg
from filodb_tpu_torch.ops import narrow as tnarrow
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.utils.metrics import (FILODB_STORE_RESIDENCY_FALLBACK,
                                            registry)

START = 1_000_000
IV = 10_000
N = 96
KINDS = ("delta8", "quant16", "delta16")
QUERIES = ("sum(rate(m[2m]))", "sum by (grp) (rate(m[2m]))",
           "stddev(rate(m[2m]))", "sum(increase(m[2m]))",
           "count(avg_over_time(m[2m]))")


def values(kind: str, n_series: int = 12, seed: int = 9, pool: bool = False):
    """Per-series value rows the ladder must land on ``kind`` (the
    reference test's shapes). ``pool``: rows 2 and 7 continuous floats,
    which no variant carries exactly — the cohort pool."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_series):
        if kind == "delta8":               # counter: small integer increments
            v = np.cumsum(rng.integers(1, 50, N)).astype(np.float64)
        elif kind == "delta16":            # odd increments, span >> u16 range
            v = np.cumsum(rng.integers(100, 3000, N) * 2 + 1).astype(np.float64)
        elif kind == "quant16":            # half-integer steps
            v = 1000.0 + 0.5 * np.arange(N) + 4.0 * i
        elif kind == "raw":                # continuous: declines everything
            v = np.cumsum(rng.exponential(5.0, N))
        elif kind == "range":              # integral but past every width
            v = np.cumsum(rng.integers(10**6, 11 * 10**5, N) * 2 + 1) \
                .astype(np.float64)
        else:
            raise AssertionError(kind)
        if pool and i in (2, 7):
            v = np.cumsum(rng.exponential(5.0, N))
        out.append(v)
    return out


def fill(ms, builder, schema, dataset, shard, rows, hosts=0):
    for i, v in enumerate(rows):
        b = builder(schema)
        for t in range(N):
            b.add({"_metric_": "m", "host": f"h{hosts + i}", "grp": f"g{i % 3}"},
                  START + t * IV, float(v[t]))
        ms.ingest(dataset, shard, b.build())


def build(pkg: str, mode: str, rows, series: int = 32):
    """(memstore, shard) of one package over ``rows``, flushed once."""
    if pkg == "jax":
        ms = JMemStore()
        sh = ms.setup("p", JGAUGE, 0, JStoreConfig(
            max_series_per_shard=series, samples_per_series=128,
            flush_batch_size=10**9, compressed_residency=mode))
        fill(ms, JRecordBuilder, JGAUGE, "p", 0, rows)
    else:
        ms = TimeSeriesMemStore(device="cpu")
        sh = ms.setup("p", GAUGE, 0, StoreConfig(
            max_series_per_shard=series, samples_per_series=128,
            flush_batch_size=10**9, compressed_residency=mode, device="cpu"))
        fill(ms, RecordBuilder, GAUGE, "p", 0, rows)
    sh.flush()
    return ms, sh


@contextlib.contextmanager
def jax_xla_mode():
    old = jfusedresident.mode()
    jfusedresident.set_mode("xla")
    try:
        yield
    finally:
        jfusedresident.set_mode(old)


# -- encoders ------------------------------------------------------------------

def encoder_rows(family: str) -> np.ndarray:
    """[R, 64] f32 rows of one family."""
    C = 64
    rng = np.random.default_rng(5)
    if family == "shapes":
        rows = [np.asarray(values(k, 2, seed=3)[j][:C])
                for k in ("delta8", "delta16", "quant16", "raw", "range")
                for j in range(2)]
    elif family == "nonfinite":
        rows = [np.full(C, np.nan), np.zeros(C)]
        for c, x in ((5, np.inf), (7, -np.inf), (0, np.nan), (63, np.nan)):
            r = np.cumsum(rng.integers(1, 9, C)).astype(np.float64)
            r[c] = x
            rows.append(r)
    else:                                  # spans at 65535 * 2^k, +-1 ulp
        rows = []
        for k in range(-4, 5):
            span = np.float32(65535.0 * 2.0 ** k)
            q = np.round(np.linspace(0.0, 1.0, C) * 65535.0)
            for s in (np.nextafter(span, np.float32(-np.inf)), span,
                      np.nextafter(span, np.float32(np.inf))):
                r = q * np.float32(2.0 ** k)   # on the 2^k grid: exact
                r[-1] = s
                rows.append(r)
    return np.stack(rows).astype(np.float32)


def exact_pow2(x: np.ndarray) -> np.ndarray:
    return np.frexp(x)[0] == 0.5


def same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


@pytest.mark.parametrize("family", ("shapes", "nonfinite", "pow2"))
@pytest.mark.parametrize("encoder", ("build_narrow", "build_narrow_delta"))
def test_encoders_match_jax_bit_for_bit(encoder, family):
    """Every output — block, row operands, ok flags, integral — equals the
    JAX encoder's bit for bit, pool and empty rows included; short rows
    (n < C) mask the rest."""
    val = encoder_rows(family)
    n = np.full(len(val), val.shape[1], np.int32)
    if family != "pow2":
        n[1::3] = 20 + np.arange(len(n[1::3])) % 40
        n[-1] = 0                          # an empty row
    ref = [np.asarray(r) for r in getattr(jnarrow, encoder)(
        jnp.asarray(val), jnp.asarray(n))]
    got = [g.numpy() for g in getattr(tnarrow, encoder)(
        torch.from_numpy(val), torch.from_numpy(n))]
    assert len(ref) == len(got)
    if encoder == "build_narrow":
        # the rows this covers all have a scale exponent XLA's exp2 gets
        # exactly (see the module docstring)
        assert (exact_pow2(ref[2]) | ~np.isfinite(ref[2])).all(), ref[2]
    for i, (r, g) in enumerate(zip(ref, got)):
        assert same_bits(g, r), (encoder, family, i)


def test_power_of_two_spans_scale_like_the_reference():
    """One ulp above span = 65535 * 2^k the reference's quotient rounds to
    exactly 2^k (XLA multiplies by the f32 reciprocal), so its scale is 2^k,
    the top cell clips and the row pools; the port's scale is the same."""
    val = encoder_rows("pow2")
    n = np.full(len(val), val.shape[1], np.int32)
    _q, _vmin, scale, ok = tnarrow.build_narrow(torch.from_numpy(val),
                                                torch.from_numpy(n))
    for k in range(-4, 5):
        i = 3 * (k + 4)
        assert scale[i:i + 3].tolist() == [2.0 ** k] * 3, k
        # only the span on the grid round-trips: the top cell of the others
        # clips to q = 65535 or rounds to it
        assert ok[i:i + 3].tolist() == [False, True, False], k


def test_reference_quant16_scale_is_not_a_power_of_two_off_its_exact_range():
    """The pinned divergence. Quarter steps over a span of 4 take scale
    2^ceil(log2(4 / 65535)) = 2^-13; exp2(-13) on XLA's CPU is
    1.2207025e-4, not 2^-13, so the reference's q * scale is inexact and its
    round trip fails where the port's holds. vmin is the same."""
    C = 64
    val = (np.arange(C) % 17 * 0.25).astype(np.float32)[None, :]  # span 4
    n = np.full(1, C, np.int32)
    jq, jvmin, jscale, jok = (np.asarray(a) for a in jnarrow.build_narrow(
        jnp.asarray(val), jnp.asarray(n)))
    q, vmin, scale, ok = (a.numpy() for a in tnarrow.build_narrow(
        torch.from_numpy(val), torch.from_numpy(n)))
    assert scale[0] == 2.0 ** -13 and jscale[0] != 2.0 ** -13
    assert abs(jscale[0] / 2.0 ** -13 - 1) < 1e-6
    assert same_bits(vmin, jvmin)
    assert bool(ok[0]) and not bool(jok[0])
    dec = decodereg.decode_quant16(torch.from_numpy(q), torch.from_numpy(vmin)[:, None],
                                   torch.from_numpy(scale)[:, None])
    assert same_bits(dec.numpy(), val)


def test_encoders_stream_in_row_blocks(monkeypatch):
    """The whole-store pass in row blocks gives the one-block result."""
    val = encoder_rows("shapes")
    n = np.full(len(val), val.shape[1], np.int32)
    n[3] = 10
    whole = [tnarrow.build_narrow(torch.from_numpy(val), torch.from_numpy(n)),
             tnarrow.build_narrow_delta(torch.from_numpy(val),
                                        torch.from_numpy(n))]
    monkeypatch.setattr(tnarrow, "BUILD_BLOCK_BYTES", val.shape[1] * 4 * 3)
    blocked = [tnarrow.build_narrow(torch.from_numpy(val),
                                    torch.from_numpy(n)),
               tnarrow.build_narrow_delta(torch.from_numpy(val),
                                          torch.from_numpy(n))]
    for w, b in zip(whole, blocked):
        for x, y in zip(w, b):
            assert same_bits(x.numpy(), y.numpy())


def test_i8_cast_wraps_like_jax():
    dv = np.array([[0, 5, -7, 127, -128, 200, -300, 32767]], np.int16)
    got = tnarrow.cast_narrow_delta_i8(torch.from_numpy(dv)).numpy()
    ref = np.asarray(jnarrow.cast_narrow_delta_i8(jnp.asarray(dv)))
    assert same_bits(got, ref)


def test_registry_matches_the_reference():
    from filodb_tpu.ops import decodereg as jdecodereg
    assert decodereg.SCALAR_VARIANTS == jdecodereg.SCALAR_VARIANTS
    for name in ("raw",) + decodereg.SCALAR_VARIANTS:
        t, j = decodereg.variant(name), jdecodereg.variant(name)
        assert (t.row_operands, t.full_columns, t.value_bytes) \
            == (j.row_operands, j.full_columns, j.value_bytes)
        assert str(t.block_dtype) == f"torch.{j.block_dtype}"


# -- the ladder ------------------------------------------------------------------

@pytest.mark.parametrize("mode", ("gauge", "all"))
@pytest.mark.parametrize("kind", KINDS + ("pooled",))
def test_flush_lands_where_jax_does(kind, mode):
    """Same kind, operands, ok rows and decoded values as the JAX store;
    the decoded block equals a raw store's values bit for bit (pooled
    rows are their pool rows); timestamps elided."""
    rows = values("delta8" if kind == "pooled" else kind, pool=kind == "pooled")
    _, jsh = build("jax", mode, rows)
    _, tsh = build("port", mode, rows)
    _, raw = build("port", "off", rows)
    t, j = tsh.store, jsh.store
    assert t.is_narrow_resident and j.is_narrow_resident
    assert t.val is None and t.ts is None
    assert isinstance(t.column_array(), DeferredDecode)
    got_kind, ops, ok = t.narrow_operands()
    jkind, jops, jok = j.narrow_operands()
    assert got_kind == jkind == ("delta8" if kind == "pooled" else kind)
    assert ops[0].dtype == decodereg.variant(got_kind).block_dtype
    for a, b in zip(ops, jops):
        assert same_bits(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(ok, jok)
    assert list(np.nonzero(~ok[:12])[0]) == ([2, 7] if kind == "pooled" else [])
    np.testing.assert_array_equal(t.value_block().numpy()[:12, :N],
                                  raw.store.val.numpy()[:12, :N])
    np.testing.assert_array_equal(t.value_block().numpy()[:12, :N],
                                  np.asarray(j.value_block())[:12, :N])
    np.testing.assert_array_equal(t.ts_block().numpy(),
                                  np.asarray(j.ts_block()))
    assert t.resident_sample_bytes() == j.resident_sample_bytes()


@pytest.mark.parametrize("kind,reason", (("raw", "non-integer"),
                                         ("range", "range")))
def test_a_store_that_declines_says_why_like_jax(kind, reason):
    ctr = registry.counter(FILODB_STORE_RESIDENCY_FALLBACK, {"reason": reason})
    before = ctr.value
    _, jsh = build("jax", "gauge", values(kind, 8))
    _, tsh = build("port", "gauge", values(kind, 8))
    assert not tsh.store.is_narrow_resident and not jsh.store.is_narrow_resident
    assert tsh.store.residency_decline == jsh.store.residency_decline == reason
    assert ctr.value == before + 1
    tsh.flush()                   # nothing mutated: no second attempt
    assert ctr.value == before + 1


def test_gauge_mode_leaves_histogram_stores_raw():
    from filodb_tpu_torch.core.schemas import PROM_HISTOGRAM
    ms = TimeSeriesMemStore(device="cpu")
    sh = ms.setup("h", PROM_HISTOGRAM, 0, StoreConfig(
        max_series_per_shard=8, samples_per_series=32,
        flush_batch_size=10**9, compressed_residency="gauge", device="cpu"))
    les = np.array([1.0, 2.0, np.inf])
    b = RecordBuilder(PROM_HISTOGRAM, bucket_les=les)
    for t in range(16):
        b.add({"_metric_": "h", "host": "a"}, START + t * IV,
              np.array([t, 2.0 * t, 3.0 * t]))
    sh.ingest(b.build())
    sh.flush()
    assert not sh.store.is_narrow_resident and sh.store.val is not None


def test_delta8_retention_beats_raw_by_3x():
    _, sh = build("port", "gauge", values("delta8"))
    st = sh.store
    assert st.narrow_operands()[0] == "delta8"
    assert st.resident_sample_bytes() * 3 <= st.S * st.C * 12


def test_append_rehydrates_and_the_next_flush_recompresses():
    rows = values("delta8", pool=True)
    tms, tsh = build("port", "gauge", rows)
    jms, jsh = build("jax", "gauge", rows)
    for ms, builder, schema in ((tms, RecordBuilder, GAUGE),
                                (jms, JRecordBuilder, JGAUGE)):
        b = builder(schema)
        for t in range(8):
            b.add({"_metric_": "m", "host": "h0", "grp": "g0"},
                  START + (N + t) * IV, float(rows[0][-1] + 3 * (t + 1)))
        ms.ingest("p", 0, b.build())
    st = tsh.store
    with tsh.lock:
        tsh._flush_staged_locked()          # lands: the store rehydrates
    assert not st.is_narrow_resident and st.val is not None
    np.testing.assert_array_equal(st.val.numpy()[0, N:N + 8],
                                  rows[0][-1] + 3.0 * np.arange(1, 9))
    tsh.flush()                             # ... and the flush re-adopts
    jsh.flush()
    assert st.is_narrow_resident
    kind, ops, ok = st.narrow_operands()
    jkind, jops, jok = jsh.store.narrow_operands()
    assert kind == jkind == "delta8"
    for a, b in zip(ops, jops):
        assert same_bits(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(ok, jok)
    np.testing.assert_array_equal(st.value_block().numpy(),
                                  np.asarray(jsh.store.value_block()))


def test_gather_rows_match_the_full_materialization():
    _, sh = build("port", "gauge", values("quant16", pool=True))
    st = sh.store
    rid = torch.tensor([0, 2, 7, 9, 30])
    rows = st.column_array().gather_rows(rid).numpy()
    np.testing.assert_array_equal(rows, st.value_block().numpy()[rid.numpy()])
    trows = DeferredTs(st).gather_rows(rid).numpy()
    np.testing.assert_array_equal(trows, st.ts_block().numpy()[rid.numpy()])


# -- the engine ------------------------------------------------------------------

@pytest.fixture(scope="module", params=[(k, p) for k in KINDS
                                        for p in (False, True)],
                ids=lambda kp: f"{kp[0]}{'-pool' if kp[1] else ''}")
def engines(request):
    kind, pool = request.param
    rows = values(kind, pool=pool)
    jms, _ = build("jax", "gauge", rows)
    tms, tsh = build("port", "gauge", rows)
    assert tsh.store.narrow_operands()[0] == kind
    return JQueryEngine(jms, "p"), QueryEngine(tms, "p", device="cpu"), pool


def assert_same_answer(got, ref, what):
    assert [k.labels for k in got.matrix.keys] == \
        [k.labels for k in ref.matrix.keys], what
    np.testing.assert_array_equal(got.matrix.out_ts, ref.matrix.out_ts)
    r = np.asarray(ref.matrix.values, np.float64)
    g = np.asarray(got.matrix.values, np.float64)
    assert g.shape == r.shape, what
    np.testing.assert_array_equal(np.isnan(g), np.isnan(r), err_msg=what)
    scale = float(np.nanmax(np.abs(r), initial=0.0))
    np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5 * scale,
                               equal_nan=True, err_msg=what)


@pytest.mark.parametrize("q", QUERIES)
def test_query_matches_jax_engine(engines, q):
    jeng, teng, pool = engines
    start, end, step = START + 300_000, START + 800_000, 30_000
    with jax_xla_mode():
        ref = jeng.query_range(q, start, end, step)
    got = teng.query_range(q, start, end, step)
    assert_same_answer(got, ref, q)
    assert got.stats.fused_kernels == ref.stats.fused_kernels == 1
    assert got.stats.blocks_narrow == ref.stats.blocks_narrow == 1
    assert got.stats.blocks_raw == ref.stats.blocks_raw == 0


def test_two_shards_of_different_residency_in_one_query():
    """A narrow shard (with pool rows) and a raw shard answer one query
    like the JAX engine over the same two shards."""
    rows = values("delta8", 16, pool=True)
    mss = []
    for pkg in ("jax", "port"):
        if pkg == "jax":
            ms = JMemStore()
            cfg, builder, schema = JStoreConfig, JRecordBuilder, JGAUGE
            kw = {}
        else:
            ms = TimeSeriesMemStore(device="cpu")
            cfg, builder, schema = StoreConfig, RecordBuilder, GAUGE
            kw = {"device": "cpu"}
        shards = [ms.setup("p", schema, s, cfg(
            max_series_per_shard=16, samples_per_series=128,
            flush_batch_size=10**9, compressed_residency=mode, **kw))
            for s, mode in enumerate(("gauge", "off"))]
        fill(ms, builder, schema, "p", 0, rows[:8])
        fill(ms, builder, schema, "p", 1, rows[8:], hosts=8)
        ms.flush_all()
        assert shards[0].store.is_narrow_resident
        assert not shards[1].store.is_narrow_resident
        mss.append(ms)
    jeng = JQueryEngine(mss[0], "p")
    teng = QueryEngine(mss[1], "p", device="cpu")
    start, end, step = START + 300_000, START + 800_000, 30_000
    for q in QUERIES:
        with jax_xla_mode():
            ref = jeng.query_range(q, start, end, step)
        got = teng.query_range(q, start, end, step)
        assert_same_answer(got, ref, q)
        assert got.stats.fused_kernels == ref.stats.fused_kernels == 2, q
        assert got.stats.blocks_narrow == ref.stats.blocks_narrow == 1, q


@pytest.mark.parametrize("q", ("rate(m[2m])", "sum by (host) (rate(m[2m]))"))
def test_general_paths_decode_a_transient(q):
    """Paths outside the fused pass (a per-series range function; a narrow
    selection that gathers rows) read the decoded block: the same answer
    as a raw store's, and the store stays narrow-resident."""
    rows = values("delta16", pool=True)
    tms, tsh = build("port", "gauge", rows)
    rms, _ = build("port", "off", rows)
    start, end, step = START + 300_000, START + 800_000, 30_000
    sel = q.replace("m[2m]", 'm{host="h3"}[2m]') if "by" in q else q
    got = QueryEngine(tms, "p", device="cpu").query_range(sel, start, end, step)
    ref = QueryEngine(rms, "p", device="cpu").query_range(sel, start, end, step)
    assert_same_answer(got, ref, sel)
    assert tsh.store.is_narrow_resident and tsh.store.val is None
