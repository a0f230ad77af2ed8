"""Concurrent ``flush_group`` against the inline downsampler's publish, in
the port: exactly once and happens-after, and the same records as the
JAX package's.

Mirrors the reference's ``tests/test_downsample_race.py``: three threads
hammer ``flush_group(0)`` while the main thread ingests 1 h of 10 s data
for 4 series into a sink-backed shard and flushes after every container.
Every closed 1 m bucket is published exactly once, and a reader right
after the main thread's ``flush_group`` returns sees it. Then the same
containers go through the JAX package's shard under the same race, and
the published records (every aggregate column, every bucket) are equal.
"""

import threading
import time

import numpy as np

from filodb_tpu.core.downsample import InlineDownsampler as JInline
from filodb_tpu.core.memstore import StoreConfig as JStoreConfig
from filodb_tpu.core.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.core.record import RecordBuilder as JRecordBuilder
from filodb_tpu.core.schemas import GAUGE as JGAUGE
from filodb_tpu.core.store import FileColumnStore as JFileColumnStore
from filodb_tpu_torch.core.downsample import InlineDownsampler
from filodb_tpu_torch.core.memstore import StoreConfig, TimeSeriesMemStore
from filodb_tpu_torch.core.record import RecordBuilder
from filodb_tpu_torch.core.schemas import GAUGE
from filodb_tpu_torch.core.store import FileColumnStore

BASE = 1_700_000_000_000
IV = 10_000
RES = 60_000
NSERIES, NSAMP = 4, 360          # 1 h of 10 s data -> 60 one-minute buckets


def _race(tmp, jax: bool):
    """Run the race on one package; returns (count by (pid, bucket ts),
    records by (column, pid, bucket ts))."""
    if jax:
        ms = JMemStore()
        cfg = JStoreConfig(max_series_per_shard=8, samples_per_series=1024,
                           flush_batch_size=10**9, groups_per_shard=1)
        sink, inline, builder, schema = (JFileColumnStore(tmp), JInline,
                                         JRecordBuilder, JGAUGE)
    else:
        ms = TimeSeriesMemStore(device="cpu")
        cfg = StoreConfig(max_series_per_shard=8, samples_per_series=1024,
                          flush_batch_size=10**9, groups_per_shard=1,
                          device="cpu")
        sink, inline, builder, schema = (FileColumnStore(tmp),
                                         InlineDownsampler, RecordBuilder,
                                         GAUGE)
    shard = ms.setup("prometheus", schema, 0, cfg, sink=sink)

    published: dict[tuple[int, int], int] = {}   # (pid, bucket_ts) -> count
    records: dict[tuple[str, int, int], float] = {}
    pub_lock = threading.Lock()

    def publish(sh, recs):
        pids, bts, _vals = recs["dAvg"]
        time.sleep(0.002)   # widen the publish window the flake lived in
        with pub_lock:
            for p, t in zip(np.asarray(pids).tolist(),
                            np.asarray(bts).tolist()):
                published[(p, t)] = published.get((p, t), 0) + 1
            for col, (ps, ts, vs) in recs.items():
                for p, t, v in zip(np.asarray(ps).tolist(),
                                   np.asarray(ts).tolist(),
                                   np.asarray(vs, np.float64).tolist()):
                    records[(col, p, t)] = v

    shard.downsample = (RES, inline(RES, publish))

    stop = threading.Event()
    errors: list[BaseException] = []

    def hammer():
        while not stop.is_set():
            try:
                shard.flush_group(0)
            except BaseException as e:  # noqa: BLE001
                errors.append(e)
                return

    threads = [threading.Thread(target=hammer) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        for chunk in range(0, NSAMP, 30):
            b = builder(schema)
            for s in range(NSERIES):
                for k in range(chunk, min(chunk + 30, NSAMP)):
                    b.add({"_metric_": "m", "host": f"h{s}"},
                          BASE + k * IV, float(k))
            shard.ingest(b.build())
            shard.flush_group(0)
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert not errors, errors
    with pub_lock:
        return dict(published), dict(records)


def test_concurrent_flush_publish_exactly_once(tmp_path):
    published, records = _race(str(tmp_path / "torch"), jax=False)

    # happens-after: flush_group has returned on this thread, so every
    # closed bucket of everything ingested above is already published.
    # Buckets live on the absolute grid (ts // RES); bucket b is closed once
    # the series' last ingested ts reaches the next bucket's start
    last_ts = BASE + (NSAMP - 1) * IV
    closed = [b for b in range(BASE // RES, last_ts // RES + 1)
              if last_ts >= (b + 1) * RES]
    expect = {(pid, (b + 1) * RES - 1)
              for pid in range(NSERIES) for b in closed}
    got = set(published)
    missing = {e for e in expect if e not in got}
    assert not missing, f"{len(missing)} closed buckets never published"
    # exactly once: no bucket published twice despite 4 racing flushers
    dups = {k: c for k, c in published.items() if c != 1}
    assert not dups, f"buckets published more than once: {dups}"

    # the JAX package's shard under the same race publishes the same
    # records: every column of every bucket, bit for bit
    jpublished, jrecords = _race(str(tmp_path / "jax"), jax=True)
    assert set(jpublished) == got
    assert set(jrecords) == set(records)
    assert {c for c, _p, _t in records} >= {"dMin", "dMax", "dSum",
                                            "dCount", "dAvg"}
    for key, v in records.items():
        assert v == jrecords[key], (key, v, jrecords[key])
