"""The port's durable tier against the JAX package's: flush groups and
checkpoints, crash recovery from the sink and the bus, the index.log fast
path and its partkeys.log fallback, slot reuse, purge and the durable
age-out, sinks written by one package and recovered by the other.

Every scenario runs the same seeded integer data through both packages
(``RecordBuilder`` containers with bus offsets, ``FileColumnStore`` sinks
in ``tmp_path``), mirroring ``tests/test_persistence.py``,
``tests/test_index_persistence.py`` and ``tests/test_purge_eviction.py``.

Tolerance: bit for bit for the index (pids, labels, start times), the
store rows, the epoch logs and every answer of the two packages' engines
on the same recovered data (f64 stores, integer samples); against the
pre-crash answer, rtol 1e-12, the reference's own bar
(``test_crash_recovery_query_parity``).
"""

import numpy as np
import pytest

from filodb_tpu.core import filters as JF
from filodb_tpu.core.memstore import EPOCH_AFFECTS_ALL as J_AFFECTS_ALL
from filodb_tpu.core.memstore import StoreConfig as JStoreConfig
from filodb_tpu.core.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.core.record import RecordBuilder as JRecordBuilder
from filodb_tpu.core.schemas import GAUGE as JGAUGE
from filodb_tpu.core.schemas import PROM_HISTOGRAM as JPROM_HISTOGRAM
from filodb_tpu.core.schemas import Schemas as JSchemas
from filodb_tpu.core.store import ChunkSetRecord as JChunkSetRecord
from filodb_tpu.core.store import FileColumnStore as JFileColumnStore
from filodb_tpu.ingest.bus import FileBus as JFileBus
from filodb_tpu.ops import fusedresident as jfusedresident
from filodb_tpu.query.engine import QueryConfig as JQueryConfig
from filodb_tpu.query.engine import QueryEngine as JQueryEngine
from filodb_tpu_torch.core import filters as TF
from filodb_tpu_torch.core.memstore import (EPOCH_AFFECTS_ALL, EPOCH_SPEC,
                                            StoreConfig, TimeSeriesMemStore)
from filodb_tpu_torch.core.record import RecordBuilder
from filodb_tpu_torch.core.schemas import GAUGE, PROM_HISTOGRAM, Schemas
from filodb_tpu_torch.core.store import ChunkSetRecord, FileColumnStore
from filodb_tpu_torch.ingest.bus import FileBus
from filodb_tpu_torch.query.engine import QueryConfig, QueryEngine
from filodb_tpu_torch.utils.metrics import (FILODB_INDEX_RECOVER_MS,
                                            FILODB_RETENTION_AGED_OUT_ROWS,
                                            registry)

START = 1_000_000
INTERVAL = 10_000
BASE = 1_700_000_000_000
DS = "prometheus"


@pytest.fixture(autouse=True)
def jax_xla_mode():
    """The JAX engine's fused tier through its XLA twin on the CPU."""
    old = jfusedresident.mode()
    jfusedresident.set_mode("xla")
    try:
        yield
    finally:
        jfusedresident.set_mode(old)


class Jax:
    """The JAX package's side of a scenario."""
    name = "jax"
    RecordBuilder, GAUGE, HIST = JRecordBuilder, JGAUGE, JPROM_HISTOGRAM
    FileColumnStore, FileBus, ChunkSetRecord = (JFileColumnStore, JFileBus,
                                                JChunkSetRecord)
    F = JF
    AFFECTS_ALL = J_AFFECTS_ALL

    @staticmethod
    def memstore():
        return JMemStore()

    @staticmethod
    def cfg(**kw):
        return JStoreConfig(**kw)

    @staticmethod
    def engine(ms, ds=DS, **cfg):
        return JQueryEngine(ms, ds, config=JQueryConfig(**cfg))

    @staticmethod
    def schemas():
        return JSchemas()


class Torch:
    """The port's side of a scenario (on the CPU)."""
    name = "torch"
    RecordBuilder, GAUGE, HIST = RecordBuilder, GAUGE, PROM_HISTOGRAM
    FileColumnStore, FileBus, ChunkSetRecord = (FileColumnStore, FileBus,
                                                ChunkSetRecord)
    F = TF
    AFFECTS_ALL = EPOCH_AFFECTS_ALL

    @staticmethod
    def memstore():
        return TimeSeriesMemStore(device="cpu")

    @staticmethod
    def cfg(**kw):
        return StoreConfig(**kw, device="cpu")

    @staticmethod
    def engine(ms, ds=DS, **cfg):
        return QueryEngine(ms, ds, config=QueryConfig(**cfg), device="cpu")

    @staticmethod
    def schemas():
        return Schemas()


PKGS = (Jax, Torch)


def make_container(pkg, i_batch, n_series=4, n_samples=10):
    """Batch ``i_batch``: integer samples, one a series and step."""
    b = pkg.RecordBuilder(pkg.GAUGE)
    start = START + i_batch * n_samples * INTERVAL
    for t in range(n_samples):
        for s in range(n_series):
            b.add({"_metric_": "m", "host": f"h{s}"}, start + t * INTERVAL,
                  float(s * 1000 + (i_batch * n_samples + t) * (s + 1)))
    return b.build()


def recovery_cfg(pkg, **kw):
    base = dict(max_series_per_shard=16, samples_per_series=128,
                flush_batch_size=10**9, groups_per_shard=4, dtype="float64")
    base.update(kw)
    return pkg.cfg(**base)


def write_crashed_node(pkg, tmp_path, n_batches=8, persist_at=4):
    """Ingest ``n_batches`` with bus offsets, persist through
    ``persist_at``, flush the rest to the device only: the state a crash
    leaves. Returns the node's memstore."""
    bus = pkg.FileBus(str(tmp_path / "bus.log"))
    sink = pkg.FileColumnStore(str(tmp_path / "chunks"))
    ms = pkg.memstore()
    sh = ms.setup(DS, pkg.GAUGE, 0, recovery_cfg(pkg), sink=sink)
    for i in range(n_batches):
        c = make_container(pkg, i)
        sh.ingest(c, bus.publish(c))
        if i == persist_at:
            sh.flush_all_groups()
    sh.flush()
    return ms


def recover_node(pkg, tmp_path, **cfg):
    bus = pkg.FileBus(str(tmp_path / "bus.log"))
    sink = pkg.FileColumnStore(str(tmp_path / "chunks"))
    ms = pkg.memstore()
    sh = ms.setup(DS, pkg.GAUGE, 0, recovery_cfg(pkg, **cfg), sink=sink)
    replayed = sh.recover(bus, pkg.schemas())
    return ms, sh, replayed


def index_state(sh):
    """(pid, labels, start, end) of every index entry, live or not."""
    return [(p, sh.index.labels_of(p), sh.index.start_time(p),
             sh.index.end_time(p)) for p in range(len(sh.index))]


def store_rows(sh):
    return [tuple(np.asarray(a).tolist() for a in sh.store.series_snapshot(p))
            for p in range(len(sh.index))]


def answers(pkg, ms, queries, rng_=None):
    eng = pkg.engine(ms)
    end = START + 8 * 10 * INTERVAL
    rng_ = rng_ or (START + 300_000, end, 60_000)
    out = {}
    for q in queries:
        m = eng.query_range(q, *rng_).matrix.to_host()
        out[q] = ([k.labels for k in m.keys], np.asarray(m.out_ts),
                  np.asarray(m.values, np.float64)[:len(m.keys)])
    return out


QUERIES = ("sum(sum_over_time(m[2m]))", "sum(rate(m[2m]))",
           "max_over_time(m[1m])")


@pytest.mark.parametrize("writer", PKGS, ids=lambda p: p.name)
def test_crash_recovery_across_packages(writer, tmp_path):
    """A sink and bus written by ``writer`` recover in both packages to the
    same index, rows and answers, equal to the pre-crash ones."""
    ms1 = write_crashed_node(writer, tmp_path)
    want = answers(writer, ms1, QUERIES)
    got = {}
    for reader in PKGS:
        ms2, sh2, replayed = recover_node(reader, tmp_path)
        assert replayed == 3 * 40          # offsets 5..7 came from the bus
        assert sh2.num_series == 4
        np.testing.assert_array_equal(sh2.group_watermarks, 4)
        assert sh2.recovering is False
        got[reader.name] = (index_state(sh2), store_rows(sh2),
                            answers(reader, ms2, QUERIES),
                            sh2.epoch_state(), sh2.visible_lead_ms)
    jg, tg = got["jax"], got["torch"]
    assert tg[0] == jg[0]                  # index
    assert tg[1] == jg[1]                  # rows
    assert tg[3:] == jg[3:]                # epoch logs, visible lead
    for q in QUERIES:
        for side in (tg[2][q], jg[2][q]):
            assert side[0] == want[q][0], q
            np.testing.assert_array_equal(side[1], want[q][1])
            np.testing.assert_allclose(side[2], want[q][2], rtol=1e-12,
                                       err_msg=q)
        np.testing.assert_array_equal(tg[2][q][2], jg[2][q][2], err_msg=q)


def test_recovery_no_duplicates(tmp_path):
    """Rows persisted and still on the bus must not ingest twice."""
    for pkg in PKGS:
        d = tmp_path / pkg.name
        cfg = pkg.cfg(max_series_per_shard=8, samples_per_series=64,
                      flush_batch_size=10**9, groups_per_shard=2,
                      dtype="float64")
        bus = pkg.FileBus(str(d / "bus.log"))
        sink = pkg.FileColumnStore(str(d / "chunks"))
        s1 = pkg.memstore().setup(DS, pkg.GAUGE, 0, cfg, sink=sink)
        for i in range(3):
            c = make_container(pkg, i, n_series=2, n_samples=5)
            s1.ingest(c, bus.publish(c))
        s1.flush_all_groups()
        s2 = pkg.memstore().setup(DS, pkg.GAUGE, 0, cfg, sink=sink)
        assert s2.recover(bus, pkg.schemas()) == 0   # all skipped
        t0, v0 = s2.store.series_snapshot(0)
        assert len(t0) == 15
    jt = JMemStore()  # the two packages' recovered rows agree
    js = jt.setup(DS, JGAUGE, 0, JStoreConfig(
        max_series_per_shard=8, samples_per_series=64,
        flush_batch_size=10**9, groups_per_shard=2, dtype="float64"),
        sink=JFileColumnStore(str(tmp_path / "torch" / "chunks")))
    js.recover(JFileBus(str(tmp_path / "torch" / "bus.log")), JSchemas())
    assert store_rows(js) == store_rows(s2)


def ingest_series(pkg, sh, n, ts=BASE, prefix="h"):
    b = pkg.RecordBuilder(pkg.GAUGE)
    b.add_series_batch({"_metric_": "m", "_ws_": "demo", "_ns_": "app",
                        "host": [f"{prefix}{i}" for i in range(n)]}, ts, 1.0)
    sh.ingest(b.build())


def index_cfg(pkg, n=1024):
    return pkg.cfg(max_series_per_shard=n, samples_per_series=64,
                   flush_batch_size=10**9, dtype="float64")


@pytest.mark.parametrize("mode", ["frames", "fallback", "corrupt"])
def test_index_recovery_paths_match_the_reference(mode, tmp_path):
    """index.log's columnar fast path (bulk loads past RECOVER_BULK_MIN),
    the partkeys.log fallback (persistence off) and a corrupt index.log:
    each recovers the same index in both packages, from a sink written by
    the port."""
    sink = FileColumnStore(str(tmp_path))
    sh = TimeSeriesMemStore(device="cpu").setup(DS, GAUGE, 0,
                                                index_cfg(Torch), sink=sink)
    if mode == "fallback":
        sh.index_bucket_ms = 0
    ingest_series(Torch, sh, 600)
    sh.flush_all_groups()
    path = tmp_path / DS / "shard0" / "index.log"
    assert path.exists() == (mode != "fallback")
    if mode == "corrupt":
        path.write_bytes(b"\x00garbage" * 10)
    states = {}
    for pkg in PKGS:
        sh2 = pkg.memstore().setup(DS, pkg.GAUGE, 0, index_cfg(pkg),
                                   sink=pkg.FileColumnStore(str(tmp_path)))
        sh2.recover()
        assert sh2.num_series == 600
        filt = [pkg.F.EqualsRegex("host", "h1[0-3].")]
        states[pkg.name] = (index_state(sh2),
                            np.sort(sh2.part_ids_from_filters(
                                filt, 0, 1 << 62)).tolist(),
                            sh2._index_log_seeded)
    assert states["torch"] == states["jax"]
    assert states["torch"][0] == index_state(sh)
    assert registry.gauge(FILODB_INDEX_RECOVER_MS,
                          {"dataset": DS, "shard": "0"}).value > 0.0
    # resolved ids stay stable: re-ingesting existing series adds none
    ingest_series(Torch, sh, 10, ts=BASE + 10_000)
    assert sh.num_series == 600


def test_upgraded_and_toggled_shards_fall_back(tmp_path):
    """A genesis-less index.log and a RETIRE-marked one are not trusted;
    the fallback re-anchors a genesis (the reference's upgrade and
    persistence-off cases), in both packages, from port-written sinks."""
    up = tmp_path / "up"
    sh = TimeSeriesMemStore(device="cpu").setup(
        DS, GAUGE, 0, index_cfg(Torch), sink=FileColumnStore(str(up)))
    sh.index_bucket_ms = 0
    ingest_series(Torch, sh, 50, prefix="old")
    sh.flush_all_groups()
    sh.index_bucket_ms = 6 * 3600 * 1000
    sh._index_log_seeded = True          # suppress the genesis snapshot
    ingest_series(Torch, sh, 10, ts=BASE + 60_000, prefix="new")
    sh.flush_all_groups()
    toggled = tmp_path / "toggled"
    a = TimeSeriesMemStore(device="cpu").setup(
        DS, GAUGE, 0, index_cfg(Torch), sink=FileColumnStore(str(toggled)))
    ingest_series(Torch, a, 20, prefix="a")
    a.flush_all_groups()
    b = TimeSeriesMemStore(device="cpu").setup(
        DS, GAUGE, 0, index_cfg(Torch), sink=FileColumnStore(str(toggled)))
    b.index_bucket_ms = 0
    b.recover()                          # appends the RETIRE marker
    ingest_series(Torch, b, 10, ts=BASE + 60_000, prefix="b")
    b.flush_all_groups()
    for root, n in ((up, 60), (toggled, 30)):
        states = []
        for pkg in PKGS:
            s2 = pkg.memstore().setup(DS, pkg.GAUGE, 0, index_cfg(pkg),
                                      sink=pkg.FileColumnStore(str(root)))
            s2.recover()
            assert s2.num_series == n
            states.append(index_state(s2))
        assert states[0] == states[1]
    # the port's fallback re-anchored a genesis: the next restart trusts it
    s3 = TimeSeriesMemStore(device="cpu").setup(
        DS, GAUGE, 0, index_cfg(Torch), sink=FileColumnStore(str(up)))
    s3.recover()
    assert s3.num_series == 60 and s3._index_log_seeded


def test_separator_labels_survive_persistence(tmp_path):
    weird = "a\x00b"
    for pkg in PKGS:
        d = tmp_path / pkg.name
        sh = pkg.memstore().setup(DS, pkg.GAUGE, 0, index_cfg(pkg, 64),
                                  sink=pkg.FileColumnStore(str(d)))
        b = pkg.RecordBuilder(pkg.GAUGE)
        b.add({"_metric_": "m", "host": weird}, BASE, 1.0)
        b.add({"_metric_": "m", "host": "plain"}, BASE, 2.0)
        sh.ingest(b.build())
        sh.flush_all_groups()
        s2 = pkg.memstore().setup(DS, pkg.GAUGE, 0, index_cfg(pkg, 64),
                                  sink=pkg.FileColumnStore(str(d)))
        s2.recover()
        got = s2.part_ids_from_filters([pkg.F.Equals("host", weird)], 0,
                                       1 << 62)
        assert len(got) == 1
        assert s2.index.labels_of(int(got[0]))["host"] == weird
    assert (tmp_path / "jax" / DS / "shard0" / "index.log").read_bytes() == \
        (tmp_path / "torch" / DS / "shard0" / "index.log").read_bytes()


def ingest_hosts(pkg, sh, names, t0, nsamples=5, step=10_000):
    b = pkg.RecordBuilder(pkg.GAUGE)
    for name in names:
        for k in range(nsamples):
            b.add({"_metric_": "m", "host": name}, t0 + k * step, float(k))
    sh.ingest(b.build())
    sh.flush()


def purge_cfg(pkg, **kw):
    return pkg.cfg(max_series_per_shard=32, samples_per_series=64,
                   flush_batch_size=10**9, groups_per_shard=4, **kw)


def test_slot_reuse_and_purge_across_recovery(tmp_path):
    """Purge with pending chunks is vetoed; a purge then a slot-reusing
    birth in the same drain recovers as the new owner, without the
    predecessor's chunks; a purged series stays dead. Both packages write
    and recover; their recovered states and part-key logs agree."""
    out = {}
    for pkg in PKGS:
        d = tmp_path / pkg.name
        sh = pkg.memstore().setup(DS, pkg.GAUGE, 0, purge_cfg(pkg),
                                  sink=pkg.FileColumnStore(str(d)))
        ingest_hosts(pkg, sh, ["old", "keeper"], BASE)
        ingest_hosts(pkg, sh, ["keeper"], BASE + 10_000_000, nsamples=1)
        e0 = sh.data_epoch
        assert sh.purge_expired_partitions(BASE + 5_000_000) == 0
        assert sh.data_epoch > e0            # the end-time marks bumped
        ep, floor = sh._epoch_log[-1]
        assert ep == sh.data_epoch and floor == BASE + 4 * 10_000
        assert floor != pkg.AFFECTS_ALL
        sh.flush_all_groups()
        assert sh.purge_expired_partitions(BASE + 5_000_000) == 1
        assert sh.stats.partitions_purged == 1
        ingest_hosts(pkg, sh, ["fresh"], BASE + 6_000_000)   # reuses pid 0
        sh.flush_all_groups()
        s2 = pkg.memstore().setup(DS, pkg.GAUGE, 0, sh.config,
                                  sink=pkg.FileColumnStore(str(d)))
        s2.recover()
        assert s2.index.labels_of(0).get("host") == "fresh"
        assert sorted(s2.label_values("host")) == ["fresh", "keeper"]
        ts, _ = s2.store.series_snapshot(0)
        assert len(ts) == 5 and (ts >= BASE + 6_000_000).all()
        ingest_hosts(pkg, s2, ["old"], BASE + 12_000_000)
        out[pkg.name] = (index_state(s2), store_rows(s2), sh.epoch_state(),
                         s2.stats.evicted_part_key_reingests,
                         (d / DS / "shard0" / "partkeys.log").read_bytes(),
                         (d / DS / "shard0" / "index.log").read_bytes())
    assert out["torch"] == out["jax"]


def test_eviction_scrubs_pending_chunks_and_requeues_on_failure(tmp_path):
    """An evicted partition's unpersisted chunks never reach the sink, and
    a failed sink write requeues its snapshot: in both packages."""
    for pkg in PKGS:
        d = tmp_path / pkg.name
        cfg = pkg.cfg(max_series_per_shard=2, samples_per_series=64,
                      flush_batch_size=10**9, groups_per_shard=1)
        sink = pkg.FileColumnStore(str(d))
        sh = pkg.memstore().setup(DS, pkg.GAUGE, 0, cfg, sink=sink)
        b = pkg.RecordBuilder(pkg.GAUGE)
        b.add({"_metric_": "m", "host": "A"}, BASE + 100_000, 1.0)
        b.add({"_metric_": "m", "host": "A"}, BASE + 200_000, 2.0)
        b.add({"_metric_": "m", "host": "B"}, BASE + 900_000, 3.0)
        sh.ingest(b.build())
        b = pkg.RecordBuilder(pkg.GAUGE)
        b.add({"_metric_": "m", "host": "C"}, BASE + 150_000, 5.0)
        b.add({"_metric_": "m", "host": "C"}, BASE + 950_000, 6.0)
        sh.ingest(b.build())
        assert sh.stats.partitions_evicted == 1
        orig, calls = sink.write_chunkset, []

        def flaky(*args, **kw):
            calls.append(1)
            if len(calls) == 1:
                raise OSError("sink down")
            return orig(*args, **kw)

        sink.write_chunkset = flaky
        with pytest.raises(OSError):
            sh.flush_group(0)
        assert sh.flush_group(0) > 0
        s2 = pkg.memstore().setup(DS, pkg.GAUGE, 0, cfg,
                                  sink=pkg.FileColumnStore(str(d)))
        s2.recover()
        assert sorted(s2.label_values("host")) == ["B", "C"]
        pid = int(s2.part_ids_from_filters([pkg.F.Equals("host", "C")], 0,
                                           1 << 60)[0])
        ts, vals = s2.store.series_snapshot(pid)
        assert ts.tolist() == [BASE + 150_000, BASE + 950_000]
        assert vals.tolist() == [5.0, 6.0]
    assert (tmp_path / "jax" / DS / "shard0" / "chunks.log").read_bytes() \
        == (tmp_path / "torch" / DS / "shard0" / "chunks.log").read_bytes()


def test_hist_shard_recovers_across_packages(tmp_path):
    """A histogram shard (meta.json carries the bucket scheme) written by
    the JAX package recovers in the port with the same rows."""
    les = np.array([1.0, 5.0, 25.0, np.inf])
    rng = np.random.default_rng(5)
    inc = rng.integers(0, 4, (40, 3, 4))
    counts = np.cumsum(np.cumsum(inc, axis=2), axis=0).astype(np.float64)
    cfgkw = dict(max_series_per_shard=8, samples_per_series=64,
                 flush_batch_size=10**9, groups_per_shard=2)
    sh = JMemStore().setup(DS, JPROM_HISTOGRAM, 0, JStoreConfig(**cfgkw),
                           sink=JFileColumnStore(str(tmp_path)))
    b = JRecordBuilder(JPROM_HISTOGRAM, bucket_les=les)
    for t in range(40):
        for s in range(3):
            b.add({"_metric_": "lat", "host": f"h{s}"}, BASE + t * 10_000,
                  {"sum": float(t * s), "count": counts[t, s, -1],
                   "h": counts[t, s]})
    sh.ingest(b.build(), offset=0)
    sh.flush_all_groups()
    rows = {}
    for pkg in PKGS:
        s2 = pkg.memstore().setup(DS, pkg.HIST, 0, pkg.cfg(**cfgkw),
                                  sink=pkg.FileColumnStore(str(tmp_path)))
        s2.recover()
        np.testing.assert_array_equal(s2.bucket_les, les)
        rows[pkg.name] = [[np.asarray(a).tolist() for a in
                           s2.store.series_snapshot(p, col)]
                          for p in range(3) for col in ("sum", "h")]
    assert rows["torch"] == rows["jax"]


def test_query_during_recovery_never_poisons_negative_cache(tmp_path):
    """A query admitted mid-recovery that sees an empty shard must not be
    cached as proof of emptiness; recover() clears the flag."""
    for pkg in PKGS:
        ms = pkg.memstore()
        sh = ms.setup(DS, pkg.GAUGE, 0, index_cfg(pkg))
        eng = pkg.engine(ms, negative_cache_size=8)
        sh.recovering = True
        r = eng.query_range("count(m)", BASE, BASE + 60_000, 15_000)
        assert r.matrix.num_series == 0
        assert r.stats.recovering_shards == 1
        assert len(eng.negative_cache) == 0
        sh.recovering = False
        eng.query_range("count(m)", BASE, BASE + 60_000, 15_000)
        assert len(eng.negative_cache) == 1
        s2 = pkg.memstore().setup(DS, pkg.GAUGE, 0, index_cfg(pkg),
                                  sink=pkg.FileColumnStore(
                                      str(tmp_path / pkg.name)))
        s2.recover()
        assert s2.recovering is False


def aged_node(pkg, d):
    """Four series of 2 h at 30 s, persisted in two groups."""
    sink = pkg.FileColumnStore(str(d))
    sh = pkg.memstore().setup(DS, pkg.GAUGE, 0, pkg.cfg(
        max_series_per_shard=4, samples_per_series=1024,
        flush_batch_size=10**9, groups_per_shard=2, dtype="float64"),
        sink=sink)
    ts = BASE + np.arange(240, dtype=np.int64) * 30_000
    b = pkg.RecordBuilder(pkg.GAUGE)
    for s in range(4):
        b.add_batch({"_metric_": "m", "host": f"h{s}"}, ts,
                    np.cumsum(np.full(240, 1.0 + s)))
    sh.ingest(b.build(), offset=0)
    sh.flush_all_groups()
    return sh, sink, int(ts[-1])


def test_durable_age_out_drops_and_bumps_the_epoch(tmp_path):
    out = {}
    for pkg in PKGS:
        sh, sink, lead = aged_node(pkg, tmp_path / pkg.name)
        cutoff = lead - 3_600_000
        e0 = sh.data_epoch
        dropped = sh.age_out_durable(cutoff)
        assert dropped == 4 * 119
        assert sh.data_epoch == e0 + 1
        assert sh._epoch_log[-1] == (sh.data_epoch, pkg.AFFECTS_ALL)
        for _g, recs in sink.read_chunksets(DS, 0):
            for r in recs:
                assert (r.ts >= cutoff).all()
        assert sh.age_out_durable(cutoff) == 0   # idempotent
        out[pkg.name] = (tmp_path / pkg.name / DS / "shard0" /
                         "chunks.log").read_bytes()
    assert out["torch"] == out["jax"]
    assert registry.counter(FILODB_RETENTION_AGED_OUT_ROWS,
                            {"dataset": DS, "shard": "0"}).value >= 4 * 119
    assert EPOCH_SPEC["sites"]["age_out"]["affects"] == "EPOCH_AFFECTS_ALL"
    assert EPOCH_SPEC["sites"]["recovery_chunk_load"]["affects"] \
        == EPOCH_SPEC["sites"]["purge_mark_ended"]["affects"] \
        == "batch_min_ts"


def test_age_out_commit_keeps_frames_appended_after_prepare(tmp_path):
    """A flush frame landing between the lock-free prepare and the commit
    survives the splice verbatim, in both packages, to the same bytes."""
    out = {}
    for pkg in PKGS:
        sh, sink, lead = aged_node(pkg, tmp_path / pkg.name)
        cutoff = lead - 3_600_000
        token = sink.age_out_prepare(DS, 0, cutoff)
        assert token is not None
        g0, recs0 = next(iter(sink.read_chunksets(DS, 0)))
        late_ts = lead + 30_000 * (1 + np.arange(8, dtype=np.int64))
        sink.write_chunkset(DS, 0, g0, [pkg.ChunkSetRecord(
            recs0[0].part_id, late_ts, np.full(8, 7.0))])
        assert sink.age_out_commit(token) > 0
        seen = [r for _g, rs in sink.read_chunksets(DS, 0) for r in rs
                if r.ts.min() > lead]
        assert len(seen) == 1 and np.array_equal(seen[0].ts, late_ts)
        out[pkg.name] = (tmp_path / pkg.name / DS / "shard0" /
                         "chunks.log").read_bytes()
    assert out["torch"] == out["jax"]
