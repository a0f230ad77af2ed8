"""Ingestion stress: sustained record throughput into one shard.

The port's counterpart of ``stress/ingestion_stress.py`` (after the
reference's IngestionStress.scala and MemStoreStress). Containers of
``batch_ts`` timestamps x ``n_series`` series, prebuilt hashes, random
values from ``default_rng(0)``, flushed once at the end; then one
``sum(rate)`` over the whole run. The shard reserves the reference's
2^21 rows; ``max_series_per_shard`` sets another row capacity (a small
run on a host without a card).

Run: python -m filodb_tpu_torch.stress.ingestion_stress [n_series]
[n_samples] [batch_ts] [max_series_per_shard] [--device cpu]
"""

from __future__ import annotations

import time

import numpy as np

from ..core.memstore import StoreConfig, TimeSeriesMemStore
from ..core.record import RecordContainer, fnv1a64
from ..core.schemas import GAUGE, part_key_of, shard_key_of
from ..device import resolve_device
from ..query.engine import QueryEngine
from ._common import finish, run

BASE = 1_700_000_000_000
INTERVAL = 10_000
QUERY = "sum(rate(stress_metric[5m]))"


def labels_of(n_series: int) -> list[dict]:
    return [{"_metric_": "stress_metric", "_ws_": "w", "_ns_": "n",
             "host": f"h{i % 1000}", "instance": f"i{i}"}
            for i in range(n_series)]


def query_range(n_samples: int) -> tuple[int, int, int]:
    """The report query's range: the run's last 5 minutes at most, 60 s
    steps, ending at its last sample."""
    end = BASE + (n_samples - 1) * INTERVAL
    return max(BASE, end - 300_000), end, 60_000


def main(n_series=100_000, n_samples=100, batch_ts=10,
         max_series_per_shard=1 << 21, device="cuda"):
    dev = resolve_device(device)
    ms = TimeSeriesMemStore(device=dev)
    cfg = StoreConfig(max_series_per_shard=max_series_per_shard,
                      samples_per_series=256,
                      flush_batch_size=1 << 20, device=str(dev))
    shard = ms.setup("stress", GAUGE, 0, cfg)

    # label sets and hashes built once (the gateway does this incrementally)
    t_prep = time.perf_counter()
    labels = labels_of(n_series)
    ph = np.array([fnv1a64(part_key_of(lb)) for lb in labels], np.uint64)
    sh = np.array([fnv1a64(shard_key_of(lb)) & 0xFFFFFFFF for lb in labels],
                  np.uint32)
    pidx = np.arange(n_series, dtype=np.int32)
    prep_s = time.perf_counter() - t_prep

    t0 = time.perf_counter()
    total = 0
    rng = np.random.default_rng(0)
    for t_block in range(0, n_samples, batch_ts):
        k = min(batch_ts, n_samples - t_block)
        ts = np.repeat(BASE + (t_block + np.arange(k)) * INTERVAL, n_series)
        vals = rng.random(k * n_series)
        container = RecordContainer(
            GAUGE, ts.astype(np.int64), vals, np.tile(ph, k), np.tile(sh, k),
            np.tile(pidx, k), labels)
        shard.ingest(container)
        total += len(container)
    shard.flush()
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0

    eng = QueryEngine(ms, "stress", device=dev)
    r = eng.query_range(QUERY, *query_range(n_samples))
    answer = np.asarray(r.matrix.values, np.float64)
    samples = int(shard.store.stats.samples_appended)
    report = {
        "soak": "ingestion_stress", "device": str(dev),
        "n_series": n_series, "n_samples": n_samples, "batch_ts": batch_ts,
        "samples": total, "seconds": dt, "samples_per_s": total / dt,
        "prep_s": prep_s, "series_created": shard.num_series,
        "samples_stored": samples,
        "out_of_order_dropped": int(shard.store.stats.out_of_order_dropped),
        "query": QUERY, "exec_path": r.exec_path,
        "sum_rate": answer.tolist()}
    return finish(report, {
        "series_created": shard.num_series == n_series,
        "samples_stored": samples == total,
        "no_out_of_order": report["out_of_order_dropped"] == 0,
        "answer_finite": answer.size > 0 and bool(np.isfinite(answer).all()),
    })


if __name__ == "__main__":
    run(main, __doc__)
