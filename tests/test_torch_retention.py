"""Retention routing in the port against the JAX package: the policy's
decisions, routed and stitched queries over downsample families, the
``resolution=`` override and its validation, the fallback to raw when a
family is missing, window widening, the routing span and counter, and the
``min_window_ms`` slot of the cache keys.

Both packages build the same tiers from the same integer counters (a raw
shard persisted to a sink, 1m and 1h families from the batch job, loaded
into their own engines, the router on the raw engine), mirroring
``tests/test_retention.py``.

Tolerance: the same decisions, ``exec_path`` (with each implementation's
bracket, ``[plain]`` / ``[xla]``, removed), ``QueryStats`` resolution and
counters, and answers bit for bit except a rate over the f32 family stores,
held to rtol 1e-5 (the ROADMAP bar: its partials are not integers).
"""

import re

import numpy as np
import pytest

from filodb_tpu.config import parse_duration_ms as j_parse_duration_ms
from filodb_tpu.core.memstore import StoreConfig as JStoreConfig
from filodb_tpu.core.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.core.record import RecordBuilder as JRecordBuilder
from filodb_tpu.core.schemas import GAUGE as JGAUGE
from filodb_tpu.core.store import FileColumnStore as JFileColumnStore
from filodb_tpu.jobs import batch_downsampler as jjobs
from filodb_tpu.ops import fusedresident as jfusedresident
from filodb_tpu.query import retention as jret
from filodb_tpu.query.engine import QueryConfig as JQueryConfig
from filodb_tpu.query.engine import QueryEngine as JQueryEngine
from filodb_tpu.query.rangevector import QueryError as JQueryError
from filodb_tpu_torch.core.downsample import ds_family
from filodb_tpu_torch.core.memstore import StoreConfig, TimeSeriesMemStore
from filodb_tpu_torch.core.record import RecordBuilder
from filodb_tpu_torch.core.schemas import GAUGE
from filodb_tpu_torch.core.store import FileColumnStore
from filodb_tpu_torch.jobs import batch_downsampler as tjobs
from filodb_tpu_torch.query import retention as tret
from filodb_tpu_torch.query.engine import QueryConfig, QueryEngine
from filodb_tpu_torch.query.rangevector import QueryError, QueryStats
from filodb_tpu_torch.utils.metrics import (FILODB_QUERY_WINDOWS_WIDENED,
                                            FILODB_RETENTION_ROUTED_QUERIES,
                                            registry)
from filodb_tpu_torch.utils.tracing import SPAN_QUERY_RETENTION, tracer

BASE = 1_700_000_000_000
IV = 30_000                      # 30 s raw scrape interval
M1, H1 = 60_000, 3_600_000
N_SAMPLES = 24 * 120             # 24 h at 30 s
N_SERIES = 4
LEAD = BASE + (N_SAMPLES - 1) * IV


@pytest.fixture(autouse=True)
def jax_xla_mode():
    old = jfusedresident.mode()
    jfusedresident.set_mode("xla")
    try:
        yield
    finally:
        jfusedresident.set_mode(old)


# ------------------------------------------------------------------ policy

def test_policy_decisions_match_the_reference():
    cases = []
    for lead in (BASE + 20 * H1, BASE + 3 * H1, 0):
        for start, end in ((BASE, lead), (lead - H1, lead),
                           (BASE, lead - 3 * H1), (BASE, BASE + M1),
                           (BASE + 7, lead - 5)):
            for step in (IV, M1, 5 * M1, H1, 2 * H1):
                cases.append((start, end, step, lead))
    for start, end, step, lead in cases:
        decided = []
        for mod in (tret, jret):
            pol = mod.RetentionPolicy([M1, H1], raw_window_ms=2 * H1)
            d = pol.decide(start, end, step, lead)
            decided.append((d.resolution_ms, d.seam_ms, d.label))
        assert decided[0] == decided[1], (start, end, step, lead)
    pol = tret.RetentionPolicy([M1, H1], raw_window_ms=2 * H1)
    lead = BASE + 20 * H1
    d = pol.decide(BASE, lead, M1, lead)
    assert d.resolution_ms == M1 and d.label == "1m+raw"
    assert lead - 2 * H1 <= d.seam_ms < lead - 2 * H1 + M1
    assert (d.seam_ms - BASE) % M1 == 0
    assert pol.decide(BASE, BASE + M1, M1, lead).resolution_ms == tret.RAW
    assert pol.decide(BASE, lead, M1, lead, override=H1).resolution_ms == H1


def test_policy_override_and_config_validation():
    for mod, err in ((tret, QueryError), (jret, JQueryError)):
        pol = mod.RetentionPolicy([M1, H1], raw_window_ms=2 * H1)
        assert [pol.parse_override(v) for v in ("raw", "1m", "1h", "60s")] \
            == [mod.RAW, M1, H1, M1]
        for bad in ("5m", "bogus"):
            with pytest.raises(err) as ei:
                pol.parse_override(bad)
            assert "available: raw, 1m, 1h" in str(ei.value)
        assert mod.RetentionPolicy.from_config(
            ["raw", "1m"], [M1, H1], 2 * H1).resolutions_ms == [M1]
        assert mod.RetentionPolicy.from_config(
            [], [M1, H1], 2 * H1).labels() == ["raw", "1m", "1h"]
        with pytest.raises(ValueError, match="names no downsample family"):
            mod.RetentionPolicy.from_config(["raw", "5m"], [M1, H1], 2 * H1)
        with pytest.raises(ValueError, match="downsample.enabled"):
            mod.RetentionPolicy.from_config(["raw", "1m"], [], 2 * H1)
        with pytest.raises(ValueError, match="duplicate"):
            mod.RetentionPolicy([M1, M1], raw_window_ms=H1)
    for v in (0, 90_000, M1, H1, 2 * H1, 5_000):
        assert tret.resolution_label(v) == jret.resolution_label(v)
    for v in ("90s", "1.5h", "250ms", "2d", 1234):
        assert tret.parse_duration_ms(v) == j_parse_duration_ms(v)
    with pytest.raises(ValueError):
        tret.parse_duration_ms("7 minutes")


# ------------------------------------------------------------------- tiers

class Jax:
    MS, Cfg, RB, G, Sink, jobs, Eng, EngCfg, ret = (
        JMemStore, JStoreConfig, JRecordBuilder, JGAUGE, JFileColumnStore,
        jjobs, JQueryEngine, JQueryConfig, jret)
    kw = {}


class Torch:
    MS, Cfg, RB, G, Sink, jobs, Eng, EngCfg, ret = (
        TimeSeriesMemStore, StoreConfig, RecordBuilder, GAUGE,
        FileColumnStore, tjobs, QueryEngine, QueryConfig, tret)
    kw = {"device": "cpu"}


def build_tiers(pkg, root, cache=0):
    """Raw shard + persisted chunks + 1m/1h families, each in its own
    engine; the router on the raw engine. Returns (raw, fams, shard)."""
    sink = pkg.Sink(root)
    cfg = pkg.Cfg(max_series_per_shard=N_SERIES, samples_per_series=4096,
                  flush_batch_size=10**9, groups_per_shard=2,
                  dtype="float64", **pkg.kw)
    ms = pkg.MS(**pkg.kw)
    shard = ms.setup("prometheus", pkg.G, 0, cfg, sink=sink)
    ts_arr = BASE + np.arange(N_SAMPLES, dtype=np.int64) * IV
    b = pkg.RB(pkg.G)
    for s in range(N_SERIES):
        b.add_batch({"_metric_": "m", "host": f"h{s}"}, ts_arr,
                    np.cumsum(np.full(N_SAMPLES, 1.0 + s)))
    shard.ingest(b.build(), offset=0)
    shard.flush_all_groups()
    fams = {}
    ecfg = pkg.EngCfg(result_cache_size=cache)
    for res in (M1, H1):
        pkg.jobs.run_batch_downsample(sink, "prometheus", 0, res)
        fms = pkg.MS(**pkg.kw)
        pkg.jobs.load_downsampled(sink, "prometheus", 0, res, "dAvg", fms)
        fams[res] = pkg.Eng(fms, ds_family("prometheus", res), config=ecfg,
                            **pkg.kw)
    raw = pkg.Eng(ms, "prometheus", config=ecfg, **pkg.kw)
    raw.retention = pkg.ret.RetentionRouter(
        pkg.ret.RetentionPolicy([M1, H1], raw_window_ms=2 * H1),
        lambda r: fams.get(r), dataset="prometheus")
    return raw, fams, shard


@pytest.fixture(scope="module")
def tiers(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiers")
    return (build_tiers(Jax, str(root / "j")),
            build_tiers(Torch, str(root / "t")))


_IMPL = re.compile(r"\[(plain|xla|pallas|cuda)\]")


def route(res) -> str:
    return _IMPL.sub("", res.exec_path)


def counters(res) -> dict:
    d = res.stats.to_dict()
    return {f: d[f] for f in QueryStats.FIELDS}


def assert_same(jr, tr, what):
    assert route(tr) == route(jr), (what, tr.exec_path, jr.exec_path)
    assert tr.stats.resolution == jr.stats.resolution, what
    assert counters(tr) == counters(jr), what
    assert tr.warnings == jr.warnings, what
    j, t = jr.matrix.to_host(), tr.matrix.to_host()
    assert [k.labels for k in t.keys] == [k.labels for k in j.keys], what
    np.testing.assert_array_equal(t.out_ts, j.out_ts, err_msg=what)
    tv = np.asarray(t.values, np.float64)[:len(t.keys)]
    jv = np.asarray(j.values, np.float64)[:len(j.keys)]
    if "rate(" in what:
        np.testing.assert_allclose(tv, jv, rtol=1e-5, err_msg=what)
    else:
        np.testing.assert_array_equal(tv, jv, err_msg=what)


ROUTED = (
    # entirely behind the horizon: the whole range from one family
    ("sum(avg_over_time(m[1h]))", BASE + H1, LEAD - 4 * H1, H1, None),
    ("sum(avg_over_time(m[5m]))", BASE + H1, LEAD - 4 * H1, 5 * M1, None),
    ("max(max_over_time(m::dMax[1h]))", BASE + H1, LEAD - 4 * H1, H1, None),
    # a window narrower than the family's resolution widens
    ("sum(rate(m::dSum[1m]))", BASE + H1, LEAD - 4 * H1, M1, None),
    # straddling: family body stitched to the raw tail at the seam
    ("sum(avg_over_time(m[5m]))", BASE + H1, LEAD, M1, None),
    ("sum by (host) (avg_over_time(m[5m]))", LEAD - 6 * H1, LEAD, 5 * M1,
     None),
    # recent or fine-step ranges stay raw
    ("sum(avg_over_time(m[5m]))", LEAD - H1, LEAD, M1, None),
    ("sum(rate(m[5m]))", BASE + H1, LEAD, IV, None),
    # overrides
    ("sum(avg_over_time(m[1h]))", BASE + H1, LEAD - 4 * H1, H1, "raw"),
    ("sum(avg_over_time(m[1h]))", BASE + H1, LEAD - 4 * H1, H1, "1m"),
    ("sum(avg_over_time(m[5m]))", BASE + H1, LEAD, M1, "1h"),
)


@pytest.mark.parametrize("case", ROUTED, ids=lambda c: f"{c[0]}@{c[3]}/{c[4]}")
def test_routed_queries_match_the_reference(case, tiers):
    (jraw, _jf, _js), (traw, _tf, _ts) = tiers
    q, start, end, step, resolution = case
    jr = jraw.query_range(q, start, end, step, resolution=resolution)
    tr = traw.query_range(q, start, end, step, resolution=resolution)
    assert_same(jr, tr, q)


def test_routed_legs_equal_their_engines(tiers):
    """A stitched answer is the family's over the body and the raw
    engine's over the tail; a routed one the family engine's own answer."""
    _j, (raw, fams, _sh) = tiers
    q, start, end, step = "sum(avg_over_time(m[5m]))", BASE + H1, LEAD, M1
    res = raw.query_range(q, start, end, step)
    assert res.stats.resolution == "1m+raw"
    assert res.exec_path.startswith("retention[1m+raw]:stitch(")
    grid = np.arange(start, end + 1, step, dtype=np.int64)
    np.testing.assert_array_equal(res.matrix.out_ts, grid)
    seam = raw.retention.policy.decide(start, end, step,
                                       raw.retention._now_ms(raw)).seam_ms
    tail = raw.query_range(q, seam, end, step, _skip_routing=True)
    body = fams[M1].query_range(q, start, seam - step, step, min_window_ms=M1)
    vals = np.asarray(res.matrix.values)
    np.testing.assert_array_equal(vals[:, grid >= seam],
                                  np.asarray(tail.matrix.to_host().values))
    np.testing.assert_array_equal(vals[:, grid < seam],
                                  np.asarray(body.matrix.to_host().values))
    routed = raw.query_range("sum(avg_over_time(m[1h]))", BASE + H1,
                             LEAD - 4 * H1, H1)
    assert routed.stats.to_dict()["resolution"] == "1h"
    oracle = fams[H1].query_range("sum(avg_over_time(m[1h]))", BASE + H1,
                                  LEAD - 4 * H1, H1)
    np.testing.assert_array_equal(np.asarray(routed.matrix.values),
                                  np.asarray(oracle.matrix.to_host().values))


def test_validation_and_missing_family_fallback(tiers):
    (jraw, _jf, _js), (traw, _tf, _ts) = tiers
    q = "sum(avg_over_time(m[1h]))"
    for raw, err in ((jraw, JQueryError), (traw, QueryError)):
        with pytest.raises(err, match="available: raw, 1m, 1h"):
            raw.query_range(q, BASE, LEAD, H1, resolution="7m")
        bare = type(raw)(raw.memstore, "prometheus",
                         **({"device": "cpu"} if raw is traw else {}))
        with pytest.raises(err, match="requires retention routing"):
            bare.query_range(q, BASE, LEAD, H1, resolution="1m")
        with pytest.raises(err, match="requires retention routing"):
            bare.query_instant(q, LEAD, resolution="1m")
    saved = (jraw.retention.family_engine, traw.retention.family_engine)
    try:
        for raw, err in ((jraw, JQueryError), (traw, QueryError)):
            raw.retention.family_engine = lambda r: None
            with pytest.raises(err, match="no published downsample data"):
                raw.query_range(q, BASE + H1, LEAD - 4 * H1, H1,
                                resolution="1m")
            with pytest.raises(err, match="no published downsample data"):
                raw.query_instant(q, LEAD - 5 * H1, resolution="1h")
        jr = jraw.query_range(q, BASE + H1, LEAD - 4 * H1, H1)
        tr = traw.query_range(q, BASE + H1, LEAD - 4 * H1, H1)
        assert tr.stats.resolution == "raw"
        assert_same(jr, tr, "fallback")
    finally:
        jraw.retention.family_engine, traw.retention.family_engine = saved


def test_instant_queries_route_only_when_overridden(tiers):
    (jraw, _jf, _js), (traw, _tf, _ts) = tiers
    for q, t, resolution in (("sum(avg_over_time(m[1h]))", LEAD - 5 * H1,
                              "1h"),
                             ("sum(avg_over_time(m[5m]))", LEAD - 5 * H1,
                              None),
                             ("sum(avg_over_time(m[5m]))", LEAD - 5 * H1,
                              "raw")):
        jr = jraw.query_instant(q, t, resolution=resolution)
        tr = traw.query_instant(q, t, resolution=resolution)
        assert tr.result_type == jr.result_type == "vector"
        assert_same(jr, tr, f"instant {q} {resolution}")


def test_routing_span_counters_and_widening(tiers):
    _j, (raw, _fams, _sh) = tiers
    c = registry.counter(FILODB_RETENTION_ROUTED_QUERIES,
                         {"dataset": "prometheus", "resolution": "1h"})
    w = registry.counter(FILODB_QUERY_WINDOWS_WIDENED,
                         {"dataset": "prometheus:ds_1m", "resolution": "1m"})
    c0, w0 = c.value, w.value
    tracer.spans.clear()
    raw.query_range("sum(avg_over_time(m[1h]))", BASE + H1, LEAD - 4 * H1, H1)
    assert c.value == c0 + 1
    spans = [s for s in tracer.spans if s.name == SPAN_QUERY_RETENTION]
    assert len(spans) == 1 and spans[0].tags["resolution"] == "1h"
    assert spans[0].tags["stitched"] is False
    r = raw.query_range("sum(rate(m::dSum[1m]))", BASE + H1, LEAD - 4 * H1,
                        M1)
    assert r.stats.windows_widened == 1 and w.value == w0 + 1
    assert r.warnings == ["1 window(s) narrower than the 1m serving "
                          "resolution were widened to cover it"]


def test_min_window_rides_the_cache_keys(tmp_path):
    """A family engine's direct answer and the router's widened one share
    their text, not their semantics: a routed query never hits the direct
    query's entry (and the reverse), in either package."""
    seqs = {}
    for pkg, tag in ((Jax, "j"), (Torch, "t")):
        raw, fams, _sh = build_tiers(pkg, str(tmp_path / tag), cache=8)
        fam = fams[M1]
        q, rng_ = "sum(rate(m::dSum[1m]))", (BASE + H1, LEAD - 4 * H1, M1)
        steps = [fam.query_range(q, *rng_),            # direct: no floor
                 raw.query_range(q, *rng_),            # routed: miss
                 raw.query_range(q, *rng_),            # routed: hit
                 fam.query_range(q, *rng_)]            # direct: hit
        keys = sorted(k[-1] or 0 for k in fam.result_cache._entries)
        seqs[tag] = ([route(s) for s in steps],
                     [s.stats.windows_widened for s in steps],
                     [s.stats.result_cache_hits for s in steps],
                     [np.asarray(s.matrix.to_host().values).tolist()
                      for s in steps], keys)
    t, j = seqs["t"], seqs["j"]
    assert t[:3] == j[:3]
    assert t[4] == j[4] == [0, M1]
    assert t[0][1] == "retention[1m]:local"
    assert t[0][2] == "retention[1m]:result-cache[local]"
    assert t[2] == [0, 0, 1, 1]
    assert t[3][1] != t[3][0]             # the widened answer differs
    for a, b in zip(t[3], j[3]):
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), rtol=1e-5)
