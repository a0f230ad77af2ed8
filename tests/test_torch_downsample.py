"""Downsampling in the port against the JAX package: ``grid_downsample`` on
the device (torch on the CPU here) against the reference's
``lax.reduce_window`` program, the host record aggregators, the streaming
inline downsampler at flush, the batch and cascade jobs, the loaded
families, and ``__col__`` over a family's per-aggregate datasets.

Inputs are seeded numpy arrays and integer counters, mirroring
``tests/test_downsample.py`` and ``tests/test_hist.py``'s
``test_hist_batch_downsample_and_query``.

Tolerance: ``grid_downsample`` — min, max, last, count and tTime bit for
bit; sum and avg of normal f32 data rtol 1e-6 (both fold a bucket's k
cells in f32; XLA's window reduction may order them otherwise), bit for
bit on integer data. Everything host-side (records, cascade, the family
files the jobs write, the loaded stores) bit for bit and byte for byte;
query answers bit for bit, except a rate over the f32 family store, whose
partials are not integers: rtol 1e-5, the ROADMAP bar.
"""

import os

import numpy as np
import pytest
import torch

from filodb_tpu.core.downsample import InlineDownsampler as JInline
from filodb_tpu.core import downsample as jds
from filodb_tpu.core.memstore import StoreConfig as JStoreConfig
from filodb_tpu.core.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.core.record import RecordBuilder as JRecordBuilder
from filodb_tpu.core.schemas import GAUGE as JGAUGE
from filodb_tpu.core.schemas import PROM_HISTOGRAM as JPROM_HISTOGRAM
from filodb_tpu.core.store import ChunkSetRecord as JChunkSetRecord
from filodb_tpu.core.store import FileColumnStore as JFileColumnStore
from filodb_tpu.jobs import batch_downsampler as jjobs
from filodb_tpu.ops import fusedresident as jfusedresident
from filodb_tpu.query.engine import QueryEngine as JQueryEngine
from filodb_tpu.query.rangevector import QueryError as JQueryError
from filodb_tpu_torch.core import downsample as tds
from filodb_tpu_torch.core.downsample import InlineDownsampler
from filodb_tpu_torch.core.memstore import StoreConfig, TimeSeriesMemStore
from filodb_tpu_torch.core.record import RecordBuilder
from filodb_tpu_torch.core.schemas import GAUGE, PROM_HISTOGRAM
from filodb_tpu_torch.core.store import ChunkSetRecord, FileColumnStore
from filodb_tpu_torch.jobs import batch_downsampler as tjobs
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.query.rangevector import QueryError

BASE = 1_700_000_000_000
IV = 10_000
RES = 60_000      # 1m buckets = 6 samples
HOUR = 3_600_000
DS = "prometheus"


@pytest.fixture(autouse=True)
def jax_xla_mode():
    old = jfusedresident.mode()
    jfusedresident.set_mode("xla")
    try:
        yield
    finally:
        jfusedresident.set_mode(old)


EXACT = ("dMin", "dMax", "dLast", "dCount", "tTime")


@pytest.mark.parametrize("integer", [False, True])
def test_grid_downsample_matches_the_reference(integer, rng):
    S, C = 5, 64            # 64 cells, k = 6: 10 buckets and a ragged tail
    if integer:
        val = np.cumsum(rng.integers(0, 50, (S, C)), axis=1).astype(np.float32)
    else:
        val = rng.normal(100, 20, (S, C)).astype(np.float32)
    n = np.array([64, 33, 5, 0, 60], np.int32)
    want = {b.agg: b for b in jds.grid_downsample(val, n, BASE, IV, RES)}
    got = {b.agg: b for b in tds.grid_downsample(
        torch.from_numpy(val), torch.from_numpy(n), BASE, IV, RES)}
    assert list(got) == list(want) == [a for a in tds.DOWNSAMPLERS
                                       if a in got]
    for agg, w in want.items():
        g = got[agg]
        np.testing.assert_array_equal(g.out_ts, w.out_ts)
        assert g.values.dtype == np.float64 and g.values.shape == (S, 10)
        np.testing.assert_array_equal(np.isnan(g.values), np.isnan(w.values))
        if integer or agg in EXACT:
            np.testing.assert_array_equal(g.values, w.values, err_msg=agg)
        else:
            np.testing.assert_allclose(g.values, w.values, rtol=1e-6,
                                       err_msg=agg)
    # the bucket-end convention
    np.testing.assert_array_equal(got["dSum"].out_ts[:2],
                                  [BASE + 5 * IV, BASE + 11 * IV])


def test_record_aggregators_equal_the_reference(rng):
    pids = rng.integers(0, 7, 400).astype(np.int32)
    ts = BASE + rng.integers(0, 3600, 400).astype(np.int64) * 1000
    vals = rng.normal(10, 3, 400)
    cnt = rng.integers(1, 9, 400).astype(np.float64)
    hv = rng.integers(0, 20, (400, 4)).astype(np.float64)
    pairs = (
        (tds.downsample_records(pids, ts, vals, RES),
         jds.downsample_records(pids, ts, vals, RES)),
        (tds.downsample_records_hist(pids, ts, hv, RES),
         jds.downsample_records_hist(pids, ts, hv, RES)),
        (tds.downsample_avg_ac(pids, ts, vals, cnt, HOUR),
         jds.downsample_avg_ac(pids, ts, vals, cnt, HOUR)),
        (tds.downsample_avg_sc(pids, ts, vals, cnt, HOUR),
         jds.downsample_avg_sc(pids, ts, vals, cnt, HOUR)))
    for got, want in pairs:
        assert list(got) == list(want)
        for agg in want:
            for g, w in zip(got[agg], want[agg]):
                np.testing.assert_array_equal(g, w, err_msg=agg)
    assert tds.ds_family(DS, RES) == jds.ds_family(DS, RES) == \
        "prometheus:ds_1m"
    assert tds.ds_family(DS, 90_000) == "prometheus:ds_90s"
    assert tds.ds_schema().value_column == jds.ds_schema().value_column \
        == "dAvg"


class Jax:
    name = "jax"
    MS, Cfg, RB, G, H, Sink, Rec, Inline, jobs, Eng = (
        JMemStore, JStoreConfig, JRecordBuilder, JGAUGE, JPROM_HISTOGRAM,
        JFileColumnStore, JChunkSetRecord, JInline, jjobs, JQueryEngine)
    QE = JQueryError
    kw = {}


class Torch:
    name = "torch"
    MS, Cfg, RB, G, H, Sink, Rec, Inline, jobs, Eng = (
        TimeSeriesMemStore, StoreConfig, RecordBuilder, GAUGE,
        PROM_HISTOGRAM, FileColumnStore, ChunkSetRecord, InlineDownsampler,
        tjobs, QueryEngine)
    QE = QueryError
    kw = {"device": "cpu"}


PKGS = (Jax, Torch)


def raw_shard(pkg, sink, n_series=3, n_samples=60, batches=1,
              inline_res=None):
    """A raw shard of integer series; with ``inline_res``, a streaming
    downsampler publishing to ``sink`` is attached before any flush, and
    each of ``batches`` ingests flushes durably."""
    ms = pkg.MS(**pkg.kw)
    cfg = pkg.Cfg(max_series_per_shard=8, samples_per_series=256,
                  flush_batch_size=10**9, groups_per_shard=2,
                  dtype="float64", **pkg.kw)
    sh = ms.setup(DS, pkg.G, 0, cfg, sink=sink)
    if inline_res is not None:
        sh.downsample = (inline_res, pkg.Inline(
            inline_res, pkg.jobs.make_inline_publisher(sink, DS, inline_res)))
    per = n_samples // batches
    for k in range(batches):
        b = pkg.RB(pkg.G)
        for t in range(k * per, (k + 1) * per):
            for s in range(n_series):
                b.add({"_metric_": "m", "host": f"h{s}"}, BASE + t * IV,
                      float(s * 100 + t * (s + 1)))
        sh.ingest(b.build(), offset=k)
        if batches > 1:
            sh.flush_all_groups()
    return ms, sh


def family_files(root, family):
    d = os.path.join(root, family, "shard0")
    out = {}
    for f in sorted(os.listdir(d)):
        with open(os.path.join(d, f), "rb") as fh:
            out[f] = fh.read()
    return out


def test_inline_downsampler_at_flush_writes_the_reference_family(tmp_path):
    """The streaming downsampler, fed by each durable flush (two flushes
    split mid-bucket), publishes the same family files in both packages;
    a plain callback sees the reference's records."""
    for pkg in PKGS:
        root = str(tmp_path / pkg.name)
        _ms, sh = raw_shard(pkg, pkg.Sink(root), inline_res=RES)
        sh.flush_all_groups()
        assert sh.downsample[1].publish.published_max[0] > 0
        raw_shard(pkg, pkg.Sink(root + "b"), n_samples=63, batches=3,
                  inline_res=RES)
    for suffix in ("", "b"):
        t = family_files(str(tmp_path / "torch") + suffix, "prometheus:ds_1m")
        j = family_files(str(tmp_path / "jax") + suffix, "prometheus:ds_1m")
        assert t == j
    seen = {}
    for pkg in PKGS:
        _ms, sh = raw_shard(pkg, pkg.Sink(str(tmp_path / ("cb" + pkg.name))))
        got = {}
        sh.downsample = (RES, lambda _sh, rec, got=got: got.update(rec))
        sh.flush_all_groups()
        seen[pkg.name] = got
    assert list(seen["torch"]) == list(seen["jax"])
    for agg in seen["jax"]:
        for g, w in zip(seen["torch"][agg], seen["jax"][agg]):
            np.testing.assert_array_equal(g, w)


def test_inline_downsampler_releases_and_recovery_seed(tmp_path):
    """drop_pids on release keeps a dead series' open buckets out; after a
    restart, seed_from_store rebuilds the open buckets from the loaded
    chunks (the same accumulators and per-slot floors as the reference's)
    so a bucket straddling the restart publishes whole."""
    out = {}
    for pkg in PKGS:
        root = str(tmp_path / pkg.name)
        _ms, sh = raw_shard(pkg, pkg.Sink(root), n_samples=63, inline_res=RES)
        sh.flush_all_groups()
        pub = sh.downsample[1].publish
        ms2 = pkg.MS(**pkg.kw)
        sh2 = ms2.setup(DS, pkg.G, 0, sh.config, sink=pkg.Sink(root))
        inline = pkg.Inline(RES, pkg.jobs.make_inline_publisher(
            sh2.sink, DS, RES), floor_ms=pub.published_max[0])
        sh2.downsample = (RES, inline)
        sh2.recover(on_chunks_loaded=lambda sh2=sh2, i=inline:
                    i.seed_from_store(sh2))
        seeded = ({k: [float(x) for x in a] for k, a in inline._acc.items()},
                  inline._seeded_last[:8].tolist())
        assert seeded[0]           # the bucket open at the restart
        b = pkg.RB(pkg.G)
        for t in range(63, 72):
            for s in range(3):
                b.add({"_metric_": "m", "host": f"h{s}"}, BASE + t * IV,
                      float(s * 100 + t * (s + 1)))
        sh2.ingest(b.build(), offset=1)
        with sh2.lock:
            sh2._release_partitions_locked(np.array([2], np.int32))
        sh2.flush_all_groups()
        out[pkg.name] = (family_files(root, "prometheus:ds_1m"), seeded)
    assert out["torch"] == out["jax"]


def test_batch_and_cascade_jobs_write_the_reference_families(tmp_path):
    """Raw -> 1m batch job, 1m -> 1h cascade (sum/count path) and the
    (avg, count) fallback: byte-identical family files, from one raw sink
    the JAX package wrote; the cascade equals a direct raw -> 1h pass."""
    rng = np.random.default_rng(4)
    ts = BASE + np.arange(720, dtype=np.int64) * IV
    vals = rng.normal(50, 10, 720)
    for pkg in PKGS:
        for sub, aggs in (("sc", tds.DOWNSAMPLERS), ("ac", ("dAvg", "dCount"))):
            root = str(tmp_path / pkg.name / sub)
            raw = JFileColumnStore(root)
            raw.write_chunkset("ds", 0, 0, [JChunkSetRecord(0, ts, vals)])
            raw.write_part_keys("ds", 0, [(0, {"_metric_": "m"}, int(ts[0]))])
            sink = pkg.Sink(root)
            pkg.jobs.run_batch_downsample(sink, "ds", 0, RES, aggs=aggs)
            written = pkg.jobs.run_cascade_downsample(sink, "ds", 0, RES, HOUR)
            assert "dAvg" in written
    for sub in ("sc", "ac"):
        for fam in ("ds:ds_1m", "ds:ds_60m"):
            assert family_files(str(tmp_path / "torch" / sub), fam) == \
                family_files(str(tmp_path / "jax" / sub), fam), (sub, fam)
    sink = FileColumnStore(str(tmp_path / "torch" / "sc"))
    cols = sink.read_meta("ds:ds_60m", 0)["columns"]
    recs = [r for _g, rs in sink.read_chunksets("ds:ds_60m", 0) for r in rs]
    direct = tds.downsample_records(np.zeros(720, np.int32), ts, vals, HOUR)
    for agg in ("dMin", "dMax", "dSum", "dCount", "dAvg"):
        got = np.concatenate([np.asarray(r.values)[:, cols.index(agg)]
                              for r in recs])
        np.testing.assert_allclose(got, direct[agg][2], rtol=1e-12,
                                   err_msg=agg)


def test_loaded_family_answers_as_the_reference(tmp_path):
    """load_downsampled builds the same multi-column store; ``::dAvg``,
    ``__col__`` and an aggregate over the family (the fused route when the
    family store is on the grid) answer as the JAX engine does."""
    res = {}
    for pkg in PKGS:
        sink = pkg.Sink(str(tmp_path / pkg.name))
        _ms, sh = raw_shard(pkg, sink, n_samples=120)
        sh.flush_all_groups()
        assert pkg.jobs.run_batch_downsample(sink, DS, 0, RES)["dAvg"] == 3
        ms2 = pkg.MS(**pkg.kw)
        fam = pkg.jobs.load_downsampled(sink, DS, 0, RES, "dAvg", ms2)
        assert fam.dataset == "prometheus:ds_1m"
        assert pkg.jobs.load_downsampled(sink, DS, 0, RES, "dMax", ms2) \
            is fam
        eng = pkg.Eng(ms2, "prometheus:ds_1m", **pkg.kw)
        rows = [tuple(np.asarray(a).tolist() for a in
                      fam.store.series_snapshot(p, col))
                for p in range(3) for col in ("dAvg", "dMax", "tTime")]
        out = [rows, fam.store.grid_info()]
        for q, step in (('m::dAvg{host="h1"}', RES),
                        ('m{host="h1",__col__="dMax"}', RES),
                        ("sum(avg_over_time(m[5m]))", 5 * RES),
                        ("sum(rate(m::dSum[3m]))", RES),
                        ("max(max_over_time(m::dMax[2m]))", RES)):
            r = eng.query_range(q, BASE + RES, BASE + 19 * RES, step)
            m = r.matrix.to_host()
            out.append((q, r.exec_path.split("[")[0], r.stats.fused_kernels,
                        [k.labels for k in m.keys], np.asarray(m.values,
                                                               np.float64)
                        [:len(m.keys)].tolist()))
        with pytest.raises(pkg.QE, match="unknown column"):
            eng.query_range('m{__col__="nope"}', BASE + RES, BASE + 2 * RES,
                            RES)
        res[pkg.name] = out
    assert res["torch"][0] == res["jax"][0]
    assert res["torch"][1] == res["jax"][1] is not None
    for t, j in zip(res["torch"][2:], res["jax"][2:]):
        assert t[:4] == j[:4], t[0]
        if "rate" in t[0]:
            # a rate's partials are not integers: the f32 family store's
            # fused pass is held to the ROADMAP bar
            np.testing.assert_allclose(np.asarray(t[4]), np.asarray(j[4]),
                                       rtol=1e-5, err_msg=t[0])
        else:
            np.testing.assert_array_equal(np.asarray(t[4]), np.asarray(j[4]),
                                          err_msg=t[0])
    assert res["torch"][4][1] == "local" and res["torch"][4][2] == 1


def test_col_selects_a_per_aggregate_family_dataset(tmp_path):
    """``__col__`` naming no column of the dataset's schema selects the
    per-aggregate dataset ``{family}:{agg}``: a legacy gauge aggregate
    and a histogram family's ``hSum``."""
    les = np.array([1.0, 2.0, np.inf])
    rng = np.random.default_rng(9)
    counts = np.cumsum(np.cumsum(rng.integers(0, 3, (30, 3)), axis=1),
                       axis=0).astype(np.float64)
    ts = BASE + np.arange(30, dtype=np.int64) * IV
    out = {}
    for pkg in PKGS:
        root = str(tmp_path / pkg.name)
        sink = pkg.Sink(root)
        # legacy per-aggregate layout: one gauge dataset per aggregate
        for agg, v in (("dMax", np.arange(5.0) * 3), ("dMin", np.arange(5.0))):
            sink.write_chunkset(f"{DS}:ds_1m:{agg}", 0, 0, [pkg.Rec(
                0, BASE + RES * (1 + np.arange(5, dtype=np.int64)) - 1, v)])
            sink.write_part_keys(f"{DS}:ds_1m:{agg}", 0,
                                 [(0, {"_metric_": "m", "host": "h0"}, BASE)])
        hs = pkg.MS(**pkg.kw).setup("histds", pkg.H, 0, pkg.Cfg(
            max_series_per_shard=4, samples_per_series=128,
            flush_batch_size=10**9, groups_per_shard=1, dtype="float64",
            **pkg.kw), sink=sink)
        b = pkg.RB(pkg.H, bucket_les=les)
        for t in range(30):
            b.add({"_metric_": "lat", "pod": "p0"}, int(ts[t]), counts[t])
        hs.ingest(b.build(), offset=0)
        hs.flush_all_groups()
        assert pkg.jobs.run_batch_downsample(sink, "histds", 0, RES) \
            == {"hSum": 1}
        ms2 = pkg.MS(**pkg.kw)
        for agg in ("dMax", "dMin"):
            pkg.jobs.load_downsampled(sink, DS, 0, RES, agg, ms2)
        hfam = pkg.jobs.load_downsampled(sink, "histds", 0, RES, "hSum", ms2)
        np.testing.assert_array_equal(hfam.bucket_les, les)
        got = []
        for ds, q in ((f"{DS}:ds_1m", 'm{__col__="dMax"}'),
                      (f"{DS}:ds_1m", 'm{__col__="dMin"}'),
                      ("histds:ds_1m",
                       'histogram_quantile(0.5, lat{__col__="hSum"})')):
            eng = pkg.Eng(ms2, ds, **pkg.kw)
            r = eng.query_range(q, BASE + RES, BASE + 4 * RES, RES)
            m = r.matrix.to_host()
            got.append((q, [k.labels for k in m.keys],
                        np.asarray(m.values, np.float64)[:len(m.keys)]
                        .tolist()))
        with pytest.raises(pkg.QE, match="unknown column dSum of dataset"):
            pkg.Eng(ms2, f"{DS}:ds_1m", **pkg.kw).query_range(
                'm{__col__="dSum"}', BASE + RES, BASE + 2 * RES, RES)
        out[pkg.name] = got
    for t, j in zip(out["torch"], out["jax"]):
        assert t[:2] == j[:2]
        np.testing.assert_array_equal(np.asarray(t[2]), np.asarray(j[2]),
                                      err_msg=t[0])
        assert np.isfinite(np.asarray(t[2])).any()
