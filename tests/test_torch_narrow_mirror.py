"""The quant16 mirror beside a raw store (``StoreConfig.narrow_mirror``)
against the JAX package's.

The reference's three cases (``tests/test_narrow.py``), each through both
packages' RecordBuilder -> ingest -> flush into a 520-series shard (S =
1024) with the mirror on: integer counters take the mirror bit-exactly
(every row round-trips; the answer equals the raw store's bit for bit);
incompressible floats build a mirror that no row can use, and the query
streams the raw block; a mixed set streams the mirror and corrects its
inexact minority through the general kernels. The mirror's blocks equal
the reference's bit for bit, and both engines report the same blocks and
fused-kernel counts, with values within rtol 1e-5 of the largest
magnitude. Then the mirror's life cycle: stale (``get()`` None) after an
append until the next flush rebuilds it, and never built under compressed
residency (the narrow form is the store there).
"""

import contextlib

import numpy as np
import pytest

from filodb_tpu.core.memstore import StoreConfig as JStoreConfig
from filodb_tpu.core.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.core.record import RecordBuilder as JRecordBuilder
from filodb_tpu.core.schemas import GAUGE as JGAUGE
from filodb_tpu.ops import fusedresident as jfusedresident
from filodb_tpu.query.engine import QueryEngine as JQueryEngine
from filodb_tpu_torch.core.memstore import StoreConfig, TimeSeriesMemStore
from filodb_tpu_torch.core.record import RecordBuilder
from filodb_tpu_torch.core.schemas import GAUGE
from filodb_tpu_torch.ops import fusedgrid
from filodb_tpu_torch.query.engine import QueryEngine

BASE = 1_700_000_000_000
IV = 10_000
NSERIES = 520          # the store pads to S = 1024
NSAMP = 64
RANGE = (BASE + 200_000, BASE + (NSAMP - 1) * IV, 30_000)


def rows(case: str):
    rng = np.random.default_rng({"integer": 7, "float": 8, "mixed": 9}[case])
    out = []
    for s in range(NSERIES):
        if case == "float" or (case == "mixed" and s % 10 == 0):
            out.append(np.cumsum(rng.exponential(5.0, NSAMP)))
        else:
            out.append(np.cumsum(rng.integers(0, 50, NSAMP))
                       .astype(np.float64))
    return out


def build(pkg: str, case: str, mirror: bool = True,
          residency: str = "off"):
    """(memstore, shard) of one package over the case's rows, flushed."""
    kw = dict(max_series_per_shard=1024, samples_per_series=NSAMP + 8,
              flush_batch_size=10**9, dtype="float32", narrow_mirror=mirror,
              compressed_residency=residency)
    if pkg == "jax":
        ms, builder = JMemStore(), JRecordBuilder
        sh = ms.setup("prometheus", JGAUGE, 0, JStoreConfig(**kw))
        b = builder(JGAUGE)
    else:
        ms, builder = TimeSeriesMemStore(device="cpu"), RecordBuilder
        sh = ms.setup("prometheus", GAUGE, 0, StoreConfig(**kw, device="cpu"))
        b = builder(GAUGE)
    ts = BASE + np.arange(NSAMP, dtype=np.int64) * IV
    for s, v in enumerate(rows(case)):
        b.add_batch({"_metric_": "m", "host": f"h{s}", "grp": f"g{s % 4}"},
                    ts, v)
    sh.ingest(b.build())
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


def answer(res):
    return {k.labels: np.asarray(v, np.float64)
            for k, _t, v in res.matrix.iter_series()}


def query(ms, q, jax: bool = False):
    if jax:
        with jax_xla_mode():
            return JQueryEngine(ms, "prometheus").query_range(q, *RANGE)
    return QueryEngine(ms, "prometheus", device="cpu").query_range(q, *RANGE)


def assert_close(got, ref):
    g, r = answer(got), answer(ref)
    assert set(g) == set(r)
    scale = max(float(np.nanmax(np.abs(v), initial=0.0)) for v in r.values())
    for k in r:
        np.testing.assert_array_equal(np.isnan(g[k]), np.isnan(r[k]))
        np.testing.assert_allclose(g[k], r[k], rtol=0, atol=1e-5 * scale)


def assert_same_stats(got, ref):
    for f in ("series_matched", "blocks_raw", "blocks_narrow",
              "fused_kernels"):
        assert getattr(got.stats, f) == getattr(ref.stats, f), f


def assert_mirror_matches_reference(tsh, jsh):
    q, vmin, scale, ok = tsh.store.narrow._data
    jq, jvmin, jscale, jok = jsh.store.narrow._data
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(vmin.numpy(), np.asarray(jvmin))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    np.testing.assert_array_equal(ok, np.asarray(jok))
    return ok


@pytest.fixture
def k1_quant16_launches(monkeypatch):
    """Counts the fused passes that stream a quant16 block (the CPU takes
    K1's plain twin, which the wrapper routes to)."""
    box = {"n": 0}
    orig = fusedgrid.fused_grid_partials

    def counting(*a, **kw):
        kind = a[15] if len(a) > 15 else kw.get("kind", "raw")
        box["n"] += kind == "quant16"
        return orig(*a, **kw)

    monkeypatch.setattr(fusedgrid, "fused_grid_partials", counting)
    return box


def test_integer_counters_use_the_mirror_bit_exactly(k1_quant16_launches):
    tms, tsh = build("torch", "integer")
    jms, jsh = build("jax", "integer")
    ok = assert_mirror_matches_reference(tsh, jsh)
    assert ok[:NSERIES].all(), "integer counters must encode exactly"
    q = "sum(rate(m[2m]))"
    got, ref = query(tms, q), query(jms, q, jax=True)
    assert got.stats.blocks_narrow == 1 and k1_quant16_launches["n"] == 1
    assert_same_stats(got, ref)
    assert_close(got, ref)
    raw = query(build("torch", "integer", mirror=False)[0], q)
    assert raw.stats.blocks_raw == 1
    for k, v in answer(raw).items():
        np.testing.assert_array_equal(answer(got)[k], v)


def test_incompressible_floats_fall_back_to_raw(k1_quant16_launches):
    tms, tsh = build("torch", "float")
    jms, jsh = build("jax", "float")
    ok = assert_mirror_matches_reference(tsh, jsh)
    assert not ok[:NSERIES].any()
    q = "sum(rate(m[2m]))"
    got, ref = query(tms, q), query(jms, q, jax=True)
    assert got.stats.blocks_raw == 1 and k1_quant16_launches["n"] == 0
    assert_same_stats(got, ref)
    assert_close(got, ref)
    (v,) = answer(got).values()
    assert np.isfinite(v).all()


def test_mixed_rows_correct_the_inexact_minority(k1_quant16_launches):
    tms, tsh = build("torch", "mixed")
    jms, jsh = build("jax", "mixed")
    ok = assert_mirror_matches_reference(tsh, jsh)[:NSERIES]
    assert 0 < (~ok).sum() <= NSERIES // 8
    q = "sum by (grp) (rate(m[2m]))"
    got, ref = query(tms, q), query(jms, q, jax=True)
    assert got.stats.blocks_narrow == 1 and k1_quant16_launches["n"] == 1
    assert_same_stats(got, ref)
    assert_close(got, ref)
    # inexact rows ride the general kernels: the bar, not bit equality
    assert_close(got, query(build("torch", "mixed", mirror=False)[0], q))


def test_an_append_stales_the_mirror_until_the_next_flush():
    tms, tsh = build("torch", "integer")
    st = tsh.store
    assert st.narrow.get(st) is not None
    b = RecordBuilder(GAUGE)
    b.add({"_metric_": "m", "host": "h0", "grp": "g0"},
          BASE + NSAMP * IV, 1e9)
    tsh.ingest(b.build())
    with tsh.lock:
        tsh._flush_staged_locked()     # lands the sample, no mirror refresh
    assert st.narrow.get(st) is None
    got = query(tms, "sum(rate(m[2m]))")
    assert got.stats.blocks_raw == 1   # a stale mirror is never consulted
    tsh.flush()
    assert st.narrow.get(st) is None   # nothing staged: no refresh
    b = RecordBuilder(GAUGE)
    b.add({"_metric_": "m", "host": "h1", "grp": "g1"},
          BASE + NSAMP * IV, 1e9)
    tsh.ingest(b.build())
    tsh.flush()
    assert st.narrow.get(st) is not None


def test_compressed_residency_skips_the_refresh():
    _tms, tsh = build("torch", "integer", residency="gauge")
    assert tsh.store.narrow_operands()[0] == "delta8"
    assert tsh.store.narrow._data is None
    _jms, jsh = build("jax", "integer", residency="gauge")
    assert jsh.store.narrow._data is None
