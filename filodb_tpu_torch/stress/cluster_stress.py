"""Cluster stress: a live two-node cluster under sustained ingest and
spanning queries, then a node killed and taken over, then continued
serving.

The port's counterpart of ``stress/cluster_stress.py`` (after the
reference's BatchIngestion and the multi-JVM ClusterRecoverySpec arc, run
as one soak). Two ``FiloServer``s share one broker and one registrar, in
this process, with their shards on one device. Producers push
``target_rps`` records a second into both partitions while a query thread
a node issues spanning ``sum(rate)``, ``count`` and ``topk`` over HTTP
(each node answers the peer's shard through cross-node dispatch). After
half the run node b dies; node a must take both shards over, and queries
must keep answering, with a bounded takeover gap.

Run: python -m filodb_tpu_torch.stress.cluster_stress [duration_s]
[target_rps] [--device cpu]
"""

from __future__ import annotations

import json
import tempfile
import threading
import time
import urllib.parse
import urllib.request

import numpy as np

from ..config import Config
from ..core.record import RecordBuilder, RecordContainer
from ..core.schemas import GAUGE
from ..device import resolve_device
from ..ingest.broker import BrokerBus, BrokerServer
from ..standalone import FiloServer
from ._common import finish, k1_raw_launches, percentiles, run

BASE = 1_700_000_000_000
N_SERIES = 256
NODES = ("node-a:1", "node-b:1")
SHAPES = ("sum(rate(cm[1m]))", "count(cm)", "topk(3, cm)")


def _query(port: int, q: str, start_ms: int, end_ms: int,
           timeout: float = 30.0) -> list:
    params = urllib.parse.urlencode({
        "query": q, "start": start_ms / 1000.0, "end": end_ms / 1000.0,
        "step": "30s"})
    url = (f"http://127.0.0.1:{port}/promql/prometheus/api/v1/query_range?"
           f"{params}")
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.load(r)["data"]["result"]


def _start_servers(broker_port: int, reg: str, dev) -> dict:
    def server(name):
        return FiloServer(Config({
            "num_shards": 2, "bus_addr": f"127.0.0.1:{broker_port}",
            "http": {"port": 0},
            "cluster": {"registrar": reg, "self_addr": name,
                        "heartbeat_interval": "250ms", "stale_after": "2s",
                        "min_members": 2, "join_timeout": "30s"},
            "store": {"max_series_per_shard": 1024,
                      "samples_per_series": 1024,
                      "flush_batch_size": 10**9},
        }), device=dev)

    servers, errors = {}, {}

    def starter(n):
        try:
            servers[n] = server(n).start()
        except Exception as e:  # noqa: BLE001 - raised below
            errors[n] = e

    ths = [threading.Thread(target=starter, args=(n,), daemon=True)
           for n in NODES]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=60)
    if errors or len(servers) != 2:
        for s in servers.values():
            s.shutdown()
        raise RuntimeError(f"cluster never formed: {sorted(servers)} "
                           f"{errors}")
    return servers


def _warm(broker_port: int, servers: dict) -> None:
    """Two ticks into both partitions, then every query shape through
    each node until all three answer (rate needs two samples)."""
    for shard in (0, 1):
        bus = BrokerBus(f"127.0.0.1:{broker_port}", shard)
        wb = RecordBuilder(GAUGE)
        for t in (0, 1):
            for i in range(N_SERIES):
                wb.add({"_metric_": "cm", "host": f"s{shard}h{i}"},
                       BASE + t * 10_000, float(t))
        bus.publish(wb.build())
        bus.close()
    # query only once each node holds its shard's series: an answer with
    # no series would sit in the negative cache for its TTL
    deadline = time.time() + 120
    while time.time() < deadline and not all(
            srv.memstore.shard("prometheus", s).num_series == N_SERIES
            for srv in servers.values() for s in list(srv._running)):
        time.sleep(0.05)
    for srv in servers.values():
        deadline = time.time() + 120
        while time.time() < deadline:
            try:
                if all(_query(srv.http.port, q, BASE + 10_000, BASE + 60_000,
                              timeout=120) for q in SHAPES):
                    break
            except OSError:      # still warming: not serving yet
                pass
            time.sleep(0.5)
        else:
            raise RuntimeError(f"warm-up query never succeeded on "
                               f"{srv.node}")


def main(duration_s=30, target_rps=5_000, device="cuda"):
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory(prefix="cluster_stress_") as tmp:
        broker = BrokerServer(f"{tmp}/broker", num_partitions=2).start()
        try:
            servers = _start_servers(broker.port, f"{tmp}/members", dev)
            try:
                return _soak(broker, servers, duration_s, target_rps, dev)
            finally:
                for srv in servers.values():
                    srv.shutdown()
        finally:
            broker.stop()


def _soak(broker, servers, duration_s, target_rps, dev) -> dict:
    a, b = servers[NODES[0]], servers[NODES[1]]
    _warm(broker.port, servers)

    stop = threading.Event()
    lock = threading.Lock()
    stats = {"ingested": 0, "queries": 0, "errors": 0, "gap_errors": 0,
             "producer_errors": 0}
    died: list[str] = []
    lat: list[float] = []
    phase = {"takeover": False}

    def producer(shard: int):
        try:
            produce(shard)
        except Exception as e:  # noqa: BLE001 - the report counts it
            with lock:
                died.append(f"producer {shard}: {e!r}")

    def produce(shard: int):
        bus = BrokerBus(f"127.0.0.1:{broker.port}", shard)
        b_ = RecordBuilder(GAUGE)
        for i in range(N_SERIES):
            b_.add({"_metric_": "cm", "host": f"s{shard}h{i}"}, 0, 0.0)
        tpl = b_.build()
        period = N_SERIES / (target_rps / 2)
        k = 0
        try:
            while not stop.is_set():
                t0 = time.perf_counter()
                # k + 2: the warm-up published ticks 0 and 1
                ts = np.full(len(tpl.ts), BASE + (k + 2) * 10_000, np.int64)
                vals = np.full(len(tpl.ts), float(k), np.float64)
                c = RecordContainer(tpl.schema, ts, vals, tpl.part_hash,
                                    tpl.shard_hash, tpl.part_idx,
                                    tpl.label_sets, tpl.bucket_les,
                                    tpl.part_keys, tpl.set_hashes)
                try:
                    bus.publish(c)
                except OSError:
                    with lock:
                        stats["producer_errors"] += 1
                    return
                with lock:
                    stats["ingested"] += N_SERIES
                k += 1
                wait = period - (time.perf_counter() - t0)
                if wait > 0:
                    stop.wait(wait)
        finally:
            bus.close()

    def querier(which: str):
        try:
            query_loop(which)
        except Exception as e:  # noqa: BLE001 - the report counts it
            with lock:
                died.append(f"querier {which}: {e!r}")

    def query_loop(which: str):
        k = 0
        while not stop.is_set():
            # after the kill, the dead node's querier turns to the survivor
            # (a real load balancer would stop routing to it)
            srv = a if which == NODES[1] and phase["takeover"] \
                else servers[which]
            # a rotation per thread: one failing shape must not stall the
            # others
            q = SHAPES[k % 3]
            k += 1
            lead = BASE + (stats["ingested"] // N_SERIES // 2) * 10_000
            t0 = time.perf_counter()
            try:
                _query(srv.http.port, q, max(BASE, lead - 300_000), lead)
                with lock:
                    stats["queries"] += 1
                    lat.append((time.perf_counter() - t0) * 1000)
            except (OSError, KeyError, ValueError):
                with lock:
                    stats["gap_errors" if phase["takeover"]
                          else "errors"] += 1
                stop.wait(0.2)

    threads = [threading.Thread(target=producer, args=(s,), daemon=True)
               for s in (0, 1)]
    threads += [threading.Thread(target=querier, args=(n,), daemon=True)
                for n in NODES]
    k1_before = k1_raw_launches()
    t_run = time.perf_counter()
    for t in threads:
        t.start()
    half = duration_s / 2
    time.sleep(half)
    with lock:
        steady_q, steady_err = stats["queries"], stats["errors"]
        steady_lat = list(lat)

    # kill node b: its shard must move to a and queries keep answering
    phase["takeover"] = True
    t_kill = time.perf_counter()
    b.shutdown()
    deadline = time.time() + 30
    took_over = False
    while time.time() < deadline:
        if all(a.manager.node_of("prometheus", s) == NODES[0]
               for s in (0, 1)) and len(a._running) == 2:
            took_over = True
            break
        time.sleep(0.05)
    takeover_s = time.perf_counter() - t_kill
    if took_over:
        time.sleep(half)
    stop.set()
    for t in threads:
        t.join(timeout=5)
    dt = time.perf_counter() - t_run
    post_q = stats["queries"] - steady_q
    report = {
        "soak": "cluster_stress", "device": str(dev),
        "duration_s": duration_s, "target_rps": target_rps, "seconds": dt,
        "ingested": stats["ingested"], "rows_per_s": stats["ingested"] / dt,
        "queries": stats["queries"], "queries_per_s": stats["queries"] / dt,
        **percentiles(lat),
        "steady": {"queries": steady_q, "errors": steady_err,
                   **percentiles(steady_lat)},
        "takeover_s": takeover_s, "queries_after": post_q,
        "gap_errors": stats["gap_errors"],
        "producer_errors": stats["producer_errors"],
        "threads_died": died,
        "k1_raw_launches": k1_raw_launches() - k1_before}
    return finish(report, {
        "steady_queries": steady_q > 0,
        "steady_error_rate": steady_err <= steady_q * 0.05,
        "took_over": took_over,
        "queries_after_takeover": post_q > 0,
        # the gap is bounded: after the reassignment window serving
        # recovers, not a trickle of successes amid steady failures
        "bounded_gap": stats["gap_errors"] <= post_q + 5,
        "producers_ran": stats["producer_errors"] == 0
        and stats["ingested"] > 0,
        "no_thread_died": not died,
    })


if __name__ == "__main__":
    run(main, __doc__)
