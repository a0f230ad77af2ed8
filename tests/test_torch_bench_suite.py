"""The port's benchmark suite (``filodb_tpu_torch/scripts/bench_suite.py``)
against the JAX package's (``scripts/bench_suite.py``).

- The twin's ``SUITES`` keys are the reference's (its module is loaded by
  path: its module level imports only the standard library and numpy).
- Every metric the reference emits — read off its ``emit(...)`` calls by an
  AST walk, string and f-string names turned into patterns — is in the
  twin's declared table under its own name or under its ``RENAMED`` name,
  or in ``NO_PORT``; every declared name answers one of the reference's
  patterns; and each metric keeps the reference's unit (``session/backend``
  says ``is_cuda`` where the reference says ``is_tpu``).
- The numpy-seeded fixtures (``_gauge_containers``, query_hicard's,
  serving's, hist_query's and fused_resident's records) are byte for byte
  the containers the reference's generation code builds at a small size,
  and the same records through both packages' engines on the CPU give the
  same ``sum(rate)`` / ``histogram_quantile`` answers: integer-valued
  answers exactly, the rest within rtol 1e-5 of the largest magnitude.
- Each suite runs on ``device="cpu"`` at a tiny size (its size keyword
  arguments) and prints exactly its declared metric names, in order. The
  ``elastic`` suite (two FiloServers joining a cluster, a kill, a takeover
  and a rebalance: over ~9 s here) is checked on the card by
  chip_smoke.py's phase 19 only.
- The entry point raises ``DeviceUnavailable`` without a card unless
  ``--device cpu`` is given.
"""

import ast
import contextlib
import importlib.util
import io
import json
import os
import re

import numpy as np
import pytest
import torch

from filodb_tpu.core.memstore import StoreConfig as JStoreConfig
from filodb_tpu.core.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.core.record import RecordBuilder as JRecordBuilder
from filodb_tpu.core.schemas import PROM_COUNTER as JPROM_COUNTER
from filodb_tpu.core.schemas import PROM_HISTOGRAM as JPROM_HISTOGRAM
from filodb_tpu.ops import fusedresident as jfr
from filodb_tpu.query.engine import QueryEngine as JQueryEngine
from filodb_tpu_torch.core.memstore import StoreConfig, TimeSeriesMemStore
from filodb_tpu_torch.core.schemas import PROM_COUNTER, PROM_HISTOGRAM
from filodb_tpu_torch.device import DeviceUnavailable
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.scripts import bench_suite as bs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_PATH = os.path.join(ROOT, "scripts", "bench_suite.py")
TWIN_PATH = bs.__file__
BASE, IV = 1_700_000_000_000, 10_000

# each suite's size keyword arguments for a run of a few seconds here
TINY = {
    "ingestion": dict(n_series=20, n_samples=10),
    "encoding": dict(n=2000),
    "partkey_index": dict(sizes=[3000], governed_series=200),
    "hist_ingest": dict(n_series=4, n_samples=20),
    "hist_query": dict(n_series=4, n_samples=100),
    "query_hicard": dict(n_series=40),
    "query_ingest": dict(n_series=40, n_samples=40),
    "ingest": dict(n_lines=2000),
    "ingest_soak": dict(n_lines=1500),
    "gateway": dict(n=500),
    "narrow_resident": dict(S=512),
    "scalar_residency": dict(S=512),
    "hist_retention": dict(n_series=8),
    "odp": dict(n_series=20, n_samples=60),
    "retention": dict(days=12, n_series=2),
    "count_values": dict(n_series=64),
    "observability": dict(n_series=40),
    "serving": dict(n_series=40),
    "fused_resident": dict(n_series=512, n_hist=256, scatter_rows=1024),
    "rules": dict(n_series=32, n_ticks=8),
    "dashboard_soak": dict(n_series=16, refreshes=4),
    "mesh_query": dict(per_shard=16),
}
# checked on the card only (chip_smoke.py phase 19)
CHIP_ONLY = ("elastic",)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suites at these sizes are a few small ops each, some from many
    Python threads at once (thread pools, servers): one intra-op thread
    keeps torch's CPU pool from oversubscribing the cores under them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load_reference():
    spec = importlib.util.spec_from_file_location("ref_bench_suite", REF_PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def name_patterns(node):
    """Regexes for an emit call's metric argument: a string, an f-string
    (each interpolation any text), either branch of a conditional; None
    for a bare variable (any name)."""
    if isinstance(node, ast.Constant):
        return [re.escape(node.value)]
    if isinstance(node, ast.JoinedStr):
        return ["".join(re.escape(v.value) if isinstance(v, ast.Constant)
                        else "(.+)" for v in node.values)]
    if isinstance(node, ast.IfExp):
        return name_patterns(node.body) + name_patterns(node.orelse)
    return [None]


def emits(path):
    """{suite: [(pattern or None, unit)]} over a script's emit(...) calls."""
    out = {}
    for node in ast.walk(ast.parse(open(path).read())):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "emit"):
            suite = node.args[0].value
            unit = node.args[3].value
            for p in name_patterns(node.args[1]):
                out.setdefault(suite, []).append((p, unit))
    return out


def match(pats, name):
    return [u for p, u in pats if p is None or re.fullmatch(p, name)]


def test_suites_are_the_references(ref):
    assert set(bs.SUITES) == set(ref.SUITES)
    assert len(bs.SUITES) == 23
    assert (bs.BASE, bs.IV) == (ref.BASE, ref.IV)


def test_declared_metrics_cover_the_references_emits():
    jax = emits(REF_PATH)
    twin = emits(TWIN_PATH)
    assert set(jax) == set(bs.SUITES) | {"session"}
    inverse = {(s, new): old for (s, old), (new, _why) in bs.RENAMED.items()}
    for suite in jax:
        declared = (bs.SESSION_METRICS if suite == "session"
                    else bs.declared_metrics(suite, full=True))
        assert len(set(declared)) == len(declared), suite
        names = {inverse.get((suite, n), n) for n in declared}
        gone = {m for (s, m) in bs.NO_PORT if s == suite}
        assert not names & gone, suite
        for (s, m) in bs.RENAMED:
            if s == suite:
                assert m not in declared, (s, m)
        # every declared (or refused) name is one the reference emits ...
        for n in names | gone:
            assert match(jax[suite], n), (suite, n)
        # ... and every name the reference spells out is declared or refused
        for p, _unit in jax[suite]:
            if p is not None:
                assert any(re.fullmatch(p, n) for n in names | gone), \
                    (suite, p)
        # units: the twin's emit for each declared name keeps the
        # reference's unit
        for n in declared:
            tu = set(match(twin[suite], n))
            ju = set(match(jax[suite], inverse.get((suite, n), n)))
            assert tu, (suite, n)
            if (suite, n) == ("session", "backend"):
                assert tu == {"is_cuda"} and ju == {"is_tpu"}
            else:
                assert tu <= ju, (suite, n, tu, ju)
    for table in (bs.NO_PORT, bs.RENAMED):
        for (s, _m), why in table.items():
            assert s in bs.SUITES and why, s


def test_full_adds_only_the_1m_index_rows():
    for s in bs.SUITES:
        extra = set(bs.declared_metrics(s, True)) - set(bs.declared_metrics(s))
        assert all(n.endswith("_1m") for n in extra), s
        assert bool(extra) == (s == "partkey_index")


# -- fixtures: the reference's generation code, byte for byte ---------------

def jax_hicard(n_series, seed, n_samples=90):
    """scripts/bench_suite.py's query_hicard / serving loop."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(n_series):
        b = JRecordBuilder(JPROM_COUNTER)
        vals = np.cumsum(rng.exponential(5.0, n_samples))
        for t in range(n_samples):
            b.add({"_metric_": "request_total", "job": f"J{s % 4}",
                   "instance": f"i{s}"}, BASE + t * IV, float(vals[t]))
        out.append(b.build())
    return out


def jax_hist_query(n_series, n_samples, B):
    """scripts/bench_suite.py's hist_query loop."""
    rng = np.random.default_rng(4)
    les = np.concatenate([2.0 ** np.arange(B - 1), [np.inf]])
    out = []
    for s in range(n_series):
        b = JRecordBuilder(JPROM_HISTOGRAM, bucket_les=les)
        c = np.cumsum(np.cumsum(rng.poisson(0.3, (n_samples, B)), axis=0),
                      axis=1).astype(np.float64)
        for t in range(n_samples):
            b.add({"_metric_": "req_latency", "host": f"h{s}"},
                  BASE + t * IV, c[t])
        out.append(b.build())
    return out


def jax_fused_scalar(n_series, n_samp=48, siv=30_000):
    """scripts/bench_suite.py's fused_resident scalar_store loop."""
    rng = np.random.default_rng(3)
    out = []
    for s0 in range(0, n_series, 512):
        b = JRecordBuilder(JPROM_COUNTER)
        vals = np.cumsum(rng.exponential(5.0, (512, n_samp)), axis=1)
        for t in range(n_samp):
            for s in range(s0, s0 + 512):
                b.add({"_metric_": "rt", "job": f"J{s % 8}",
                       "inst": f"i{s}"}, BASE + t * siv,
                      float(vals[s - s0, t]))
        out.append(b.build())
    return out


def jax_fused_hist(n_hist, nh_samp=32, nb=32):
    """scripts/bench_suite.py's fused_resident hist_store loop."""
    les = np.concatenate([2.0 ** np.arange(nb - 1), [np.inf]])
    rng = np.random.default_rng(5)
    out = []
    for s0 in range(0, n_hist, 256):
        b = JRecordBuilder(JPROM_HISTOGRAM, bucket_les=les)
        c = np.cumsum(np.cumsum(
            rng.poisson(0.4, (256, nh_samp, nb)), axis=1),
            axis=2).astype(np.float64)
        for t in range(nh_samp):
            for s in range(256):
                b.add({"_metric_": "h", "host": f"x{s0 + s}"},
                      BASE + t * IV, c[s, t])
        out.append(b.build())
    return out


def same_bytes(port, jax):
    assert len(port) == len(jax)
    assert [c.to_bytes() for c in port] == [c.to_bytes() for c in jax]


def test_gauge_containers_are_the_references(ref):
    same_bytes(bs._gauge_containers(30, 7, per_container=40),
               ref._gauge_containers(30, 7, per_container=40))


@pytest.mark.parametrize("seed", [11, 13])
def test_hicard_and_serving_records_are_the_references(seed):
    same_bytes(bs.hicard_containers(24, seed=seed), jax_hicard(24, seed))


def test_hist_query_records_are_the_references():
    same_bytes(bs.hist_query_containers(3, 40, 64), jax_hist_query(3, 40, 64))


def test_fused_resident_records_are_the_references():
    same_bytes(bs.fused_scalar_containers(512), jax_fused_scalar(512))
    same_bytes(bs.fused_hist_containers(256), jax_fused_hist(256))


@contextlib.contextmanager
def jax_xla_mode():
    """The JAX package's CPU serving variant (its Pallas kernels would run
    in interpret mode)."""
    old = jfr.mode()
    jfr.set_mode("xla")
    try:
        yield
    finally:
        jfr.set_mode(old)


def engines_over(port_records, jax_records, ds, schema, jschema, n_series,
                 capacity, dtype, residency="off"):
    tms = TimeSeriesMemStore(device="cpu")
    tsh = tms.setup(ds, schema, 0, StoreConfig(
        max_series_per_shard=n_series, samples_per_series=capacity,
        flush_batch_size=10**9, dtype=dtype, compressed_residency=residency,
        device="cpu"))
    jms = JMemStore()
    jsh = jms.setup(ds, jschema, 0, JStoreConfig(
        max_series_per_shard=n_series, samples_per_series=capacity,
        flush_batch_size=10**9, dtype=dtype, compressed_residency=residency))
    for c in port_records:
        tms.ingest(ds, 0, c)
    for c in jax_records:
        jms.ingest(ds, 0, c)
    tsh.flush()
    jsh.flush()
    return QueryEngine(tms, ds, device="cpu"), JQueryEngine(jms, ds)


def assert_same_answer(got, ref_res):
    def series(r):
        return {k.labels: np.asarray(v, np.float64)
                for k, _t, v in r.matrix.iter_series()}
    g, r = series(got), series(ref_res)
    assert set(g) == set(r) and r
    scale = max(float(np.nanmax(np.abs(v), initial=0.0)) for v in r.values())
    for k, rv in r.items():
        np.testing.assert_array_equal(np.isnan(g[k]), np.isnan(rv))
        fin = rv[~np.isnan(rv)]
        # integer-valued below 2^24: every f32 fold order gives the same bits
        if np.all((fin == np.round(fin)) & (np.abs(fin) < 2**24)):
            np.testing.assert_array_equal(g[k], rv)
        else:
            np.testing.assert_allclose(g[k], rv, rtol=0,
                                       atol=1e-5 * max(scale, 1e-30))


def test_hicard_records_answer_alike_in_both_packages():
    teng, jeng = engines_over(bs.hicard_containers(64, seed=11),
                              jax_hicard(64, 11), "bench", PROM_COUNTER,
                              JPROM_COUNTER, 64, 128, "float32")
    q = 'sum(rate(request_total{job="J0"}[1m]))'
    start, end = BASE + 300_000, BASE + 89 * IV
    with jax_xla_mode():
        want = jeng.query_range(q, start, end, 60_000)
    assert_same_answer(teng.query_range(q, start, end, 60_000), want)


def test_hist_query_records_answer_alike_in_both_packages():
    n_samples = 100
    teng, jeng = engines_over(bs.hist_query_containers(6, n_samples, 64),
                              jax_hist_query(6, n_samples, 64), "bench",
                              PROM_HISTOGRAM, JPROM_HISTOGRAM, 6,
                              n_samples + 8, "float64")
    q = 'histogram_quantile(0.9, sum(rate(req_latency[5m])))'
    start, end = BASE + 600_000, BASE + (n_samples - 10) * IV
    with jax_xla_mode():
        want = jeng.query_range(q, start, end, 60_000)
    got = teng.query_range(q, start, end, 60_000)
    assert got.exec_path.split("[")[0] == want.exec_path.split("[")[0]
    assert_same_answer(got, want)


def test_fused_resident_records_answer_alike_in_both_packages():
    teng, jeng = engines_over(bs.fused_scalar_containers(512),
                              jax_fused_scalar(512), "fr", PROM_COUNTER,
                              JPROM_COUNTER, 512, 48, "float32")
    q = "sum(rate(rt[2m]))"
    rng = (BASE + 240_000, BASE + 46 * 30_000, 2_500)
    with jax_xla_mode():
        want = jeng.query_range(q, *rng)
    assert_same_answer(teng.query_range(q, *rng), want)
    teng, jeng = engines_over(bs.fused_hist_containers(256),
                              jax_fused_hist(256), "frh", PROM_HISTOGRAM,
                              JPROM_HISTOGRAM, 256, 32, "float32", "all")
    q = "histogram_quantile(0.9, sum(rate(h[1m])))"
    rng = (BASE + 120_000, BASE + 30 * IV, 2_500)
    with jax_xla_mode():
        want = jeng.query_range(q, *rng)
    got = teng.query_range(q, *rng)
    assert got.exec_path.split("[")[0] == want.exec_path.split("[")[0]
    assert_same_answer(got, want)


# -- every suite on the CPU at a tiny size -----------------------------------

def run_suite(name, **size):
    """(the suite's JSON lines, what it returned)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rec = bs.SUITES[name](False, "cpu", **size)
    return [json.loads(ln) for ln in buf.getvalue().splitlines()], rec


def test_tiny_sizes_cover_every_suite():
    assert set(TINY) | set(CHIP_ONLY) == set(bs.SUITES)
    assert not set(TINY) & set(CHIP_ONLY)


@pytest.mark.parametrize("name", sorted(TINY))
def test_suite_prints_exactly_its_declared_metrics(name):
    lines, _rec = run_suite(name, **TINY[name])
    assert all(ln["suite"] == name for ln in lines)
    got = [ln["metric"] for ln in lines]
    optional = {m for s, m in bs.OPTIONAL if s == name}
    assert got == [m for m in bs.declared_metrics(name)
                   if m in got or m not in optional], got
    assert all(np.isfinite(ln["value"]) for ln in lines), lines
    for ln in lines:
        # every bool a parity or audit, but whether the fused answer is bit
        # for bit the composed one (an f32 fold order: not promised)
        if ln["unit"] == "bool" and not ln["metric"].endswith("oracle_exact"):
            assert ln["value"] == 1.0, ln


def test_fused_resident_records_its_legs():
    _lines, rec = run_suite("fused_resident", **TINY["fused_resident"])
    assert set(rec["legs"]) == set(bs.FUSED_SHAPES)
    # no kernel on the CPU, so nothing to leave out of a launch count
    assert rec["compare_launches"] == {"k1": 0, "k2": 0}
    for shape, legs in rec["legs"].items():
        # no kernel on the CPU; the composed chain routes "local"
        assert legs["off"]["k1"] == legs["off"]["k2"] == 0
        assert legs["off"]["route"] == "local", shape
        # the suite's own bar against the composed oracle (the reference's
        # 2e-5 a cell: the fused f32 fold sums in another order, and a
        # quantile interpolates between the bucket rates)
        o, f = legs["off"]["values"], legs["fused"]["values"]
        np.testing.assert_array_equal(np.isnan(f), np.isnan(o))
        np.testing.assert_allclose(f, o, rtol=2e-5, atol=0)
    assert rec["legs"]["hist_quantile"]["fused"]["route"] \
        == "fused-hist-narrow[plain]"


def test_entry_point_needs_a_card_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailable):
        bs.main([])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert bs.main(["--device", "cpu", "--suite", "gateway"]) == 0
    out = buf.getvalue().splitlines()
    assert out[0] == "cpu"
    lines = [json.loads(ln) for ln in out[1:]]
    assert [(ln["suite"], ln["metric"]) for ln in lines] == [
        ("session", m) for m in bs.SESSION_METRICS] + [
        ("gateway", "influx_parse")]
    assert lines[2]["unit"] == "is_cuda" and lines[2]["value"] == 0.0
