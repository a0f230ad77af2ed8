"""Query stress: concurrent PromQL load against an in-memory dataset.

The port's counterpart of ``stress/query_stress.py`` (after the
reference's InMemoryQueryStress.scala). ``n_series`` synthetic counters,
720 samples at 10 s; each of the five query shapes runs once serially
(the warm-up), then ``concurrency`` workers share ``n_queries`` queries.
The data is fixed once ingested, so every concurrent answer must equal
the serial answer of its query text bit for bit: keys, timestamps and
values. The report carries queries/s, latency p50/p99 and K1 raw's
launches during the concurrent run.

Run: python -m filodb_tpu_torch.stress.query_stress [n_series]
[n_queries] [concurrency] [--device cpu]
"""

from __future__ import annotations

import threading
import time

import numpy as np

from ..core.memstore import StoreConfig, TimeSeriesMemStore
from ..device import resolve_device
from ..ingest.stream import SyntheticStream
from ..query.engine import QueryEngine
from ._common import finish, k1_raw_launches, percentiles, run

QUERIES = [
    'sum(rate(heap_usage0{{_ws_="demo"}}[5m]))',
    'avg_over_time(heap_usage0{{instance="Instance-{i}"}}[2m])',
    'topk(5, heap_usage0)',
    'quantile(0.9, heap_usage0)',
    'sum by (dc) (heap_usage0)',
]
START = 1_000_000
JOIN_S = 600.0          # a worker still running after this is wedged


def query_text(i: int, n_series: int) -> str:
    return QUERIES[i % len(QUERIES)].format(i=i % n_series)


def answer(r) -> tuple:
    """Keys in order, timestamps and f64 values: what bit for bit
    compares."""
    return ([k.labels for k in r.matrix.keys],
            np.asarray(r.matrix.out_ts).tolist(),
            np.asarray(r.matrix.values, np.float64))


def same(a, b) -> bool:
    return (a[0] == b[0] and a[1] == b[1] and a[2].shape == b[2].shape
            and np.array_equal(a[2], b[2], equal_nan=True))


def main(n_series=1000, n_queries=200, concurrency=4, device="cuda"):
    dev = resolve_device(device)
    ms = TimeSeriesMemStore(device=dev)
    cfg = StoreConfig(max_series_per_shard=1 << 14, samples_per_series=1024,
                      flush_batch_size=1 << 22, device=str(dev))
    ms.setup("stress", "gauge", 0, cfg)
    t0 = time.perf_counter()
    for off, c in SyntheticStream(n_series=n_series, n_batches=20,
                                  samples_per_batch=36, start_ms=START,
                                  kind="counter"):
        ms.ingest("stress", 0, c, off)
    ms.flush_all()
    ingest_s = time.perf_counter() - t0
    eng = QueryEngine(ms, "stress", device=dev)
    end = START + 720 * 10_000
    rng = (START + 600_000, end, 150_000)
    # the serial answer of every query text the run issues (its first
    # five are the reference's warm-up: each shape once)
    serial = {}
    for i in range(max(n_queries, len(QUERIES))):
        q = query_text(i, n_series)
        if q not in serial:
            serial[q] = answer(eng.query_range(q, *rng))
    lat: list[float] = []
    lock = threading.Lock()
    idx = [0]
    differ: list[str] = []
    errors: list[str] = []

    def worker():
        q = None
        try:
            while True:
                with lock:
                    i = idx[0]
                    if i >= n_queries:
                        return
                    idx[0] += 1
                q = query_text(i, n_series)
                t1 = time.perf_counter()
                got = answer(eng.query_range(q, *rng))
                with lock:
                    lat.append((time.perf_counter() - t1) * 1000)
                    if not same(got, serial[q]):
                        differ.append(q)
        except Exception as e:  # noqa: BLE001 - the report counts it
            with lock:
                errors.append(f"{q}: {e!r}")

    k1_before = k1_raw_launches()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    wedged = sum(t.is_alive() for t in threads)
    dt = time.perf_counter() - t0
    report = {
        "soak": "query_stress", "device": str(dev), "n_series": n_series,
        "n_queries": n_queries, "concurrency": concurrency,
        "ingest_s": ingest_s, "seconds": dt, "queries_per_s": n_queries / dt,
        **percentiles(lat), "answered": len(lat),
        "distinct_queries": len(serial), "differ": len(differ),
        "errors": len(errors), "first_error": errors[0] if errors else None,
        "wedged_workers": wedged,
        "k1_raw_launches": k1_raw_launches() - k1_before}
    return finish(report, {
        "no_errors": not errors and not wedged,
        "all_answered": len(lat) == n_queries,
        "answers_equal_serial": not differ,
    })


if __name__ == "__main__":
    run(main, __doc__)
