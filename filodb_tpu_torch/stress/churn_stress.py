"""Partition churn stress: continuous series creation, purge, eviction and
slot reuse — the index arena, bloom filter, free list and eviction paths
under sustained pressure.

The port's counterpart of ``stress/churn_stress.py`` (after the
reference's MemStoreStress.scala and RowReplaceStress.scala; slot reuse
under churn is the matching hazard). Every round creates
``series_per_round`` new series of one sample each in a shard that holds
twice that many, so live eviction runs every few rounds; every fifth round
purges series quiet for more than 20 minutes of data time. Checks: the
live count never exceeds the capacity, every series was created, and the
index arena stays bounded by the live cardinality, not by the churn. Its
query is ``sum(pod_cpu)`` at the last round: each series holds one
sample, so a rate has nothing to answer.

Run: python -m filodb_tpu_torch.stress.churn_stress [rounds]
[series_per_round] [--device cpu]
"""

from __future__ import annotations

import time

import numpy as np

from ..core.memstore import StoreConfig, TimeSeriesMemStore
from ..core.record import RecordBuilder
from ..core.schemas import GAUGE
from ..device import resolve_device
from ..query.engine import QueryEngine
from ._common import finish, run

BASE = 1_700_000_000_000
ROUND_MS = 600_000
QUERY = "sum(pod_cpu)"


def main(rounds=50, series_per_round=2_000, device="cuda"):
    dev = resolve_device(device)
    ms = TimeSeriesMemStore(device=dev)
    cap = series_per_round * 2          # forces live eviction every few rounds
    cfg = StoreConfig(max_series_per_shard=cap, samples_per_series=64,
                      flush_batch_size=10**9, device=str(dev))
    shard = ms.setup("churn", GAUGE, 0, cfg)
    t0 = time.perf_counter()
    bounded = True
    peak_live = 0
    for r in range(rounds):
        b = RecordBuilder(GAUGE)
        for i in range(series_per_round):
            b.add({"_metric_": "pod_cpu", "pod": f"pod-{r}-{i}"},
                  BASE + r * ROUND_MS, float(i))
        shard.ingest(b.build())
        shard.flush()
        if r % 5 == 4:    # purge series quiet for > 20 minutes of data time
            shard.purge_expired_partitions(BASE + (r - 2) * ROUND_MS)
        peak_live = max(peak_live, shard.num_series)
        bounded = bounded and shard.num_series <= cap
        shard.index.maybe_compact_arena()
    dt = time.perf_counter() - t0
    last = BASE + (rounds - 1) * ROUND_MS
    r = QueryEngine(ms, "churn", device=dev).query_instant(QUERY, last)
    answer = np.asarray(r.matrix.values, np.float64)
    created = shard.stats.series_created
    arena = shard.index.arena_bytes()
    report = {
        "soak": "churn_stress", "device": str(dev), "rounds": rounds,
        "series_per_round": series_per_round, "seconds": dt,
        "series_per_s": created / dt, "series_created": created,
        "samples": int(shard.stats.rows_ingested),
        "evicted": shard.stats.partitions_evicted,
        "purged": shard.stats.partitions_purged,
        "live": shard.num_series, "peak_live": peak_live,
        "arena_bytes": arena, "query": QUERY, "sum": answer.tolist()}
    return finish(report, {
        "capacity_bounded": bounded,
        "all_created": created == rounds * series_per_round,
        # the arena stays bounded by live cardinality, not total churn
        "arena_bounded": arena < 200 * cap,
    })


if __name__ == "__main__":
    run(main, __doc__)
