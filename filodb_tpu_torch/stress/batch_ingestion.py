"""Batch ingestion stress: the bulk backfill shape — large containers through
ingest -> flush -> durable sink -> batch downsample, with recovery parity.

The port's counterpart of ``stress/batch_ingestion.py`` (after the
reference's BatchIngestion.scala: bulk ingest with verification). Blocks
of 50 timestamps x ``n_series`` series are ingested and every flush group
flushed to a ``FileColumnStore``; the batch downsampler runs over the
persisted chunks at 1 m; a fresh shard recovers from the sink and must
hold every sample, and answer one ``sum(rate)`` bit for bit as the shard
that ingested. The sink lives in a temporary directory removed at the end.

Run: python -m filodb_tpu_torch.stress.batch_ingestion [n_series]
[n_samples] [--device cpu]
"""

from __future__ import annotations

import tempfile
import time

import numpy as np

from ..core.memstore import StoreConfig, TimeSeriesMemStore
from ..core.record import RecordBuilder
from ..core.schemas import GAUGE
from ..core.store import FileColumnStore
from ..device import resolve_device
from ..jobs.batch_downsampler import run_batch_downsample
from ..query.engine import QueryEngine
from ._common import finish, run

BASE = 1_700_000_000_000
INTERVAL = 10_000
QUERY = "sum(rate(backfill[5m]))"


def config(dev) -> StoreConfig:
    return StoreConfig(max_series_per_shard=1 << 12, samples_per_series=512,
                       flush_batch_size=1 << 19, groups_per_shard=4,
                       device=str(dev))


def query_range(n_samples: int) -> tuple[int, int, int]:
    end = BASE + (n_samples - 1) * INTERVAL
    return max(BASE, end - 600_000), end, 60_000


def answer(ms, dev, n_samples):
    r = QueryEngine(ms, "batch", device=dev).query_range(
        QUERY, *query_range(n_samples))
    return np.asarray(r.matrix.values, np.float64)


def main(n_series=2_000, n_samples=300, device="cuda"):
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory(prefix="filodb-batch-") as root:
        ms = TimeSeriesMemStore(device=dev)
        shard = ms.setup("batch", GAUGE, 0, config(dev),
                         sink=FileColumnStore(root))
        t0 = time.perf_counter()
        total = 0
        for t_block in range(0, n_samples, 50):
            b = RecordBuilder(GAUGE)
            for t in range(t_block, min(t_block + 50, n_samples)):
                for i in range(n_series):
                    b.add({"_metric_": "backfill", "s": f"s{i}"},
                          BASE + t * INTERVAL, float(t + i))
                    total += 1
            shard.ingest(b.build(), offset=t_block)
            shard.flush_all_groups()
        dt = time.perf_counter() - t0
        t1 = time.perf_counter()
        written = run_batch_downsample(FileColumnStore(root), "batch", 0,
                                       60_000)
        ds_s = time.perf_counter() - t1
        before = answer(ms, dev, n_samples)
        # recovery parity: a fresh shard recovers the same samples
        t2 = time.perf_counter()
        ms2 = TimeSeriesMemStore(device=dev)
        shard2 = ms2.setup("batch", GAUGE, 0, config(dev),
                           sink=FileColumnStore(root))
        shard2.recover()
        rec_s = time.perf_counter() - t2
        recovered = int(np.asarray(
            shard2.store.n_host[:shard2.num_series]).sum())
        after = answer(ms2, dev, n_samples)
    report = {
        "soak": "batch_ingestion", "device": str(dev),
        "n_series": n_series, "n_samples": n_samples, "samples": total,
        "seconds": dt, "samples_per_s": total / dt,
        "flush_groups": shard.config.groups_per_shard,
        "batch_downsample": written, "downsample_s": ds_s,
        "recovery_s": rec_s, "series_created": shard.num_series,
        "recovered": recovered, "query": QUERY,
        "sum_rate": before.tolist()}
    return finish(report, {
        "recovery_parity": recovered == total,
        "recovered_answer_bit_equal": before.shape == after.shape
        and np.array_equal(before, after, equal_nan=True),
        "downsampled": bool(written) and all(v > 0 for v in written.values()),
        "answer_finite": before.size > 0 and bool(np.isfinite(before).all()),
    })


if __name__ == "__main__":
    run(main, __doc__)
