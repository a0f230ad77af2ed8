"""Streaming stress: sustained concurrent ingest and query against one live
shard — the ingest path races query dispatch on the same shard lock.

The port's counterpart of ``stress/streaming_stress.py`` (after the
reference's StreamingStress.scala: continuous ingest and queries with
correctness checking). One thread ingests and flushes a tick of
``n_series`` strictly increasing counters at a time; two threads query
``sum(rate(req[2m]))`` meanwhile. In the port the reference's donated
scatters are in-place updates of the store under the shard lock, so this
is the soak for that hazard. Checks: no query error (a query that meets a
released slot may ask to be retried, as in the reference), no negative
rate, and afterwards the soak's ``sum(rate)`` bit for bit that of a fresh
memstore fed the same containers in the same order.

Run: python -m filodb_tpu_torch.stress.streaming_stress [duration_s]
[n_series] [--device cpu]
"""

from __future__ import annotations

import threading
import time

import numpy as np

from ..core.memstore import StoreConfig, TimeSeriesMemStore
from ..core.record import RecordBuilder
from ..core.schemas import GAUGE
from ..device import resolve_device
from ..query.engine import QueryEngine
from ._common import finish, k1_raw_launches, percentiles, run

BASE = 1_700_000_000_000
QUERY = "sum(rate(req[2m]))"
RANGE = (BASE + 120_000, BASE + 600_000, 60_000)
RETRY_PAUSE_S = 0.01    # after a query that failed or asked for a retry
JOIN_GRACE_S = 600.0    # a thread still running this long after the end


def config(dev) -> StoreConfig:
    return StoreConfig(max_series_per_shard=1 << 14, samples_per_series=512,
                       flush_batch_size=1 << 18, device=str(dev))


def tick(t: int, n_series: int):
    b = RecordBuilder(GAUGE)
    for i in range(n_series):
        # strictly increasing counters: rate must always be >= 0
        b.add({"_metric_": "req", "inst": f"i{i}"},
              BASE + t * 10_000, float(t * (1 + i % 3)))
    return b.build()


def answer(eng) -> tuple:
    r = eng.query_range(QUERY, *RANGE)
    return ([k.labels for k in r.matrix.keys],
            np.asarray(r.matrix.values, np.float64))


def main(duration_s=20, n_series=5_000, device="cuda"):
    dev = resolve_device(device)
    ms = TimeSeriesMemStore(device=dev)
    shard = ms.setup("stream", GAUGE, 0, config(dev))
    eng = QueryEngine(ms, "stream", device=dev)
    stop = time.time() + duration_s
    errors: list[str] = []
    fed: list = []
    lat: list[float] = []
    counts = {"ingested": 0, "queries": 0, "negative": 0, "retried": 0}
    lock = threading.Lock()

    def ingester():
        t = 0
        try:
            while time.time() < stop:
                c = tick(t, n_series)
                shard.ingest(c)
                shard.flush()
                fed.append(c)
                counts["ingested"] += n_series
                t += 1
        except Exception as e:  # noqa: BLE001 - the report counts it
            with lock:
                errors.append(f"ingest: {e!r}")

    def querier():
        while time.time() < stop:
            t0 = time.perf_counter()
            try:
                r = eng.query_range(QUERY, *RANGE)
                neg = [v for _k, _t, v in r.matrix.iter_series()
                       if (np.asarray(v) < 0).any()]
                with lock:
                    lat.append((time.perf_counter() - t0) * 1000)
                    counts["queries"] += 1
                    if neg:
                        counts["negative"] += 1
                        errors.append(f"negative rate: {neg[0]}")
            except Exception as e:  # noqa: BLE001 - the report counts it
                with lock:
                    if "retry the query" in str(e):
                        counts["retried"] += 1
                    else:
                        errors.append(repr(e))
                time.sleep(RETRY_PAUSE_S)

    k1_before = k1_raw_launches()
    threads = [threading.Thread(target=ingester, daemon=True)] + \
        [threading.Thread(target=querier, daemon=True) for _ in range(2)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=duration_s + JOIN_GRACE_S)
    if any(t.is_alive() for t in threads):
        errors.append("a soak thread was still running after the run")
    dt = time.perf_counter() - t0
    k1 = k1_raw_launches() - k1_before

    # the same containers, in the same order, into a fresh memstore
    ms2 = TimeSeriesMemStore(device=dev)
    shard2 = ms2.setup("stream", GAUGE, 0, config(dev))
    for c in fed:
        shard2.ingest(c)
        shard2.flush()
    got, want = answer(eng), answer(QueryEngine(ms2, "stream", device=dev))
    report = {
        "soak": "streaming_stress", "device": str(dev),
        "duration_s": duration_s, "n_series": n_series, "seconds": dt,
        "ingested": counts["ingested"], "ticks": len(fed),
        "rows_per_s": counts["ingested"] / dt, "queries": counts["queries"],
        "queries_per_s": counts["queries"] / dt, **percentiles(lat),
        "retried": counts["retried"], "negative_rates": counts["negative"],
        "errors": len(errors), "first_error": errors[0] if errors else None,
        "lock_contentions": shard.lock.contentions, "k1_raw_launches": k1,
        "query": QUERY, "sum_rate": got[1].tolist()}
    return finish(report, {
        "no_errors": not errors,
        "queried": counts["queries"] > 0,
        "replay_bit_equal": got[0] == want[0]
        and got[1].shape == want[1].shape
        and np.array_equal(got[1], want[1], equal_nan=True),
    })


if __name__ == "__main__":
    run(main, __doc__)
