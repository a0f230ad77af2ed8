"""Metrics registry: counters, gauges and histograms, one process-global
registry.

Host copy of the parts of ``filodb_tpu/utils/metrics.py`` the port records:
the query latency histogram, the fused-tier and mesh-route served/fallback
counters, the residency-fallback counter, and the serving layer's metrics
(result, negative and fragment caches, slow queries, admission, the
per-tenant cardinality governor), and the durable and retention tiers
(index recovery, paged-in and aged-out samples, routed queries, widened
windows), and the cluster plane (cross-node dispatches, their latency and
circuit breakers, replica read failovers, the per-shard gauges a scrape
refreshes), and the ingest plane and the elastic cluster (rows the
consumers and the gateway ingested, decode and parse errors, the broker
clients' retries, failovers, sheds and publish latency, replication lag,
gossip rounds, peer states, epochs, fenced writes, rebalances, rejoin
truncations, the shard-status gauges). Metric names are the reference's, so dashboards read both;
``MetricsRegistry.expose_prometheus`` renders the reference's text format.
"""

from __future__ import annotations

import threading
from bisect import bisect_right
from collections import defaultdict

FILODB_QUERY_LATENCY_MS = "filodb_query_latency_ms"
FILODB_QUERY_FUSED_SERVED = "filodb_query_fused_served"
FILODB_QUERY_FUSED_FALLBACK = "filodb_query_fused_fallback"
# queries the mesh route served, tagged by route (fused / fused-narrow /
# twostep / sketch / topk) and program mode (the port runs eagerly: "eager")
FILODB_QUERY_MESH_SERVED = "filodb_query_mesh_served"
# mesh-eligible queries that took the host scatter-gather path after
# eligibility, tagged by reason (order_stat_caps / topk_caps)
FILODB_QUERY_MESH_FALLBACK = "filodb_query_mesh_fallback"
FILODB_TRACE_SPANS = "filodb_trace_spans"
FILODB_STORE_RESIDENCY_FALLBACK = "filodb_store_residency_fallback"
# errors dropped on purpose on a best-effort path, tagged by site
FILODB_SWALLOWED_ERRORS = "filodb_swallowed_errors"
FILODB_SCHEDULER_WORKER_ERRORS = "filodb_scheduler_worker_errors"
# queries at or over QueryConfig.slow_log_threshold_ms
FILODB_QUERY_SLOW = "filodb_query_slow"
FILODB_QUERY_RESULT_CACHE_HITS = "filodb_query_result_cache_hits"
FILODB_QUERY_RESULT_CACHE_MISSES = "filodb_query_result_cache_misses"
FILODB_QUERY_RESULT_CACHE_EVICTIONS = "filodb_query_result_cache_evictions"
FILODB_QUERY_RESULT_CACHE_INVALIDATIONS = \
    "filodb_query_result_cache_invalidations"
# cost-based admission: sheds (retryable), oversized (never admissible),
# and the cost admitted and executing now (a gauge)
FILODB_QUERY_ADMISSION_SHED = "filodb_query_admission_shed"
FILODB_QUERY_ADMISSION_OVERSIZED = "filodb_query_admission_oversized"
FILODB_QUERY_ADMISSION_COST = "filodb_query_admission_cost"
FILODB_QUERY_NEGATIVE_CACHE_HITS = "filodb_query_negative_cache_hits"
FILODB_QUERY_NEGATIVE_CACHE_EVICTIONS = \
    "filodb_query_negative_cache_evictions"
FILODB_QUERY_FRAGMENT_CACHE_HITS = "filodb_query_fragment_cache_hits"
FILODB_QUERY_FRAGMENT_CACHE_MISSES = "filodb_query_fragment_cache_misses"
FILODB_QUERY_FRAGMENT_CACHE_EXTENSIONS = \
    "filodb_query_fragment_cache_extensions"
FILODB_QUERY_FRAGMENT_CACHE_EVICTIONS = \
    "filodb_query_fragment_cache_evictions"
FILODB_QUERY_FRAGMENT_CACHE_INVALIDATIONS = \
    "filodb_query_fragment_cache_invalidations"
# resident bytes of the fragment cache's host value columns (a gauge)
FILODB_QUERY_FRAGMENT_CACHE_BYTES = "filodb_query_fragment_cache_bytes"
# per-tenant active series (a gauge) and births shed at the quota
FILODB_TENANT_ACTIVE_SERIES = "filodb_tenant_active_series"
FILODB_TENANT_SERIES_SHED = "filodb_tenant_series_shed"
# gauge: wall milliseconds the last shard restart spent recovering the
# part-key index (per dataset/shard): columnar load from persisted index.log
# time buckets when available, else the per-key partkeys.log rebuild
FILODB_INDEX_RECOVER_MS = "filodb_index_recover_ms"
# counter: index time-bucket frames persisted to the durable tier
# (CRC-verified appends to index.log)
FILODB_INDEX_PERSISTED_BUCKETS = "filodb_index_persisted_buckets"
# counter: samples paged in from the durable chunk tier by on-demand
# paging, tagged tier=local|remote
FILODB_RETENTION_ODP_ROWS = "filodb_retention_odp_rows"
# counter: raw samples aged out of the durable tier (each pass also bumps
# the shard's data_epoch so cached results invalidate)
FILODB_RETENTION_AGED_OUT_ROWS = "filodb_retention_aged_out_rows"
# counter: queries the retention router served from a downsample family
# (tagged dataset + resolution; stitched raw+ds queries count under the
# family's resolution)
FILODB_RETENTION_ROUTED_QUERIES = "filodb_retention_routed_queries"
# counter: windowed functions auto-widened on retention-routed queries
# because their window was narrower than the serving family's resolution
# (tagged dataset + resolution; also in per-query stats)
FILODB_QUERY_WINDOWS_WIDENED = "filodb_query_windows_widened"
# counter: cross-node /exec dispatches per endpoint
FILODB_PEER_EXEC_REQUESTS = "filodb_peer_exec_requests"
# gauge: the last cross-node /exec round-trip latency per endpoint
FILODB_PEER_EXEC_LATENCY_MS = "filodb_peer_exec_latency_ms"
# gauge: 1 while the per-peer circuit breaker is open (dispatches shed fast
# as 503)
FILODB_PEER_BREAKER_OPEN = "filodb_peer_breaker_open"
# counter: replicated-store reads that failed over past a failed or lagging
# replica (tagged op)
FILODB_RETENTION_REPLICA_FAILOVER = "filodb_retention_replica_failover"
# gauges a /metrics scrape refreshes per dataset and shard
FILODB_SHARD_NUM_SERIES = "filodb_shard_num_series"
# counter: increments a streaming subscription delivered
FILODB_QUERY_SUBSCRIBE_INCREMENTS = "filodb_query_subscribe_increments"
# the ingest plane: rows the bus consumers ingested (dataset/shard), samples
# the line-protocol gateway accepted and lines it dropped, decode faults of
# the consumers' decode-ahead thread
FILODB_INGESTED_ROWS = "filodb_ingested_rows"
FILODB_GATEWAY_INGESTED_ROWS = "filodb_gateway_ingested_rows"
FILODB_GATEWAY_PARSE_ERRORS = "filodb_gateway_parse_errors"
FILODB_INGEST_DECODE_ERRORS = "filodb_ingest_decode_errors"
# broker clients: re-sends after a RETRY shed or a reconnect, leader
# failovers, publishes shed by a broker (tagged reason), and the publish
# round-trip latency histogram (per partition)
FILODB_INGEST_RETRIES = "filodb_ingest_retries"
FILODB_INGEST_FAILOVERS = "filodb_ingest_failovers"
FILODB_INGEST_PUBLISH_SHED = "filodb_ingest_publish_shed"
FILODB_INGEST_PUBLISH_LATENCY_MS = "filodb_ingest_publish_latency_ms"
# gauge: frames a follower is behind its partition's leader
FILODB_INGEST_REPLICATION_LAG = "filodb_ingest_replication_lag"
# counter: gateway lines carrying the reserved rules label, refused
FILODB_RULES_SPOOF_REJECTS = "filodb_rules_spoof_rejects"
# the elastic cluster: gossip probe rounds, the peer state a node sees
# (gauge: 0 alive, 1 suspect, 2 dead), partition/shard epochs (gauge),
# writes refused below the current epoch, live shard moves, and the frames
# a rejoining broker truncated from its divergent tail
FILODB_CLUSTER_GOSSIP_ROUNDS = "filodb_cluster_gossip_rounds"
FILODB_CLUSTER_PEER_STATE = "filodb_cluster_peer_state"
FILODB_CLUSTER_EPOCH = "filodb_cluster_epoch"
FILODB_CLUSTER_FENCED_REJECTS = "filodb_cluster_fenced_rejects"
FILODB_CLUSTER_REBALANCES = "filodb_cluster_rebalances"
FILODB_CLUSTER_REJOIN_TRUNCATED = "filodb_cluster_rejoin_truncated"
# gauge: shards of a dataset in each status (Active, Recovery, ...)
FILODB_SHARD_STATUS = "filodb_shard_status"


class Counter:
    def __init__(self):
        self._v = 0.0
        self._lock = threading.Lock()

    def increment(self, by: float = 1.0):
        with self._lock:
            self._v += by

    @property
    def value(self) -> float:
        return self._v


class Gauge:
    """``update`` is a plain rebind (atomic under the interpreter lock);
    read-modify-write goes through ``increment``."""

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def update(self, v: float):
        self.value = float(v)

    def increment(self, by: float = 1.0):
        with self._lock:
            self.value += by


class Histogram:
    """Fixed-boundary histogram (ms-scale latencies by default); keeps the
    last observation's trace id as its exemplar."""

    DEFAULT_BOUNDS = (1, 2, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000,
                      10000)

    def __init__(self, bounds=DEFAULT_BOUNDS):
        self.bounds = list(bounds)
        self.buckets = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0
        self.last_trace_id: str | None = None
        self._lock = threading.Lock()

    def record(self, v: float, trace_id: str | None = None):
        with self._lock:
            self.buckets[bisect_right(self.bounds, v)] += 1
            self.sum += v
            self.count += 1
            if trace_id:
                self.last_trace_id = trace_id


class MetricsRegistry:
    def __init__(self):
        self._metrics: dict[tuple, object] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, tags: dict | None):
        key = (name, tuple(sorted((tags or {}).items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls()
            return m

    def counter(self, name: str, tags: dict | None = None) -> Counter:
        return self._get(Counter, name, tags)

    def gauge(self, name: str, tags: dict | None = None) -> Gauge:
        return self._get(Gauge, name, tags)

    def histogram(self, name: str, tags: dict | None = None) -> Histogram:
        return self._get(Histogram, name, tags)

    def expose_prometheus(self) -> str:
        """Prometheus text format 0.0.4, as the reference renders it."""
        lines = []
        with self._lock:
            items = sorted(self._metrics.items(), key=lambda kv: kv[0])
        for (name, tags), m in items:
            tag_s = ",".join(f'{k}="{v}"' for k, v in tags)
            tag_s = "{" + tag_s + "}" if tag_s else ""
            if isinstance(m, Counter):
                lines.append(f"{name}_total{tag_s} {m.value:g}")
            elif isinstance(m, Gauge):
                lines.append(f"{name}{tag_s} {m.value:g}")
            elif isinstance(m, Histogram):
                cum = 0
                for b, c in zip(m.bounds, m.buckets):
                    cum += c
                    lt = (tag_s[:-1] + "," if tag_s else "{") \
                        + f'le="{b}"' + "}"
                    lines.append(f"{name}_bucket{lt} {cum}")
                lt = (tag_s[:-1] + "," if tag_s else "{") + 'le="+Inf"}'
                lines.append(f"{name}_bucket{lt} {m.count}")
                lines.append(f"{name}_sum{tag_s} {m.sum:g}")
                lines.append(f"{name}_count{tag_s} {m.count}")
        return "\n".join(lines) + "\n"


registry = MetricsRegistry()


class ShardHealthStats:
    """Ref: coordinator/.../ShardHealthStats.scala — gauges per dataset for
    active/recovering/down shard counts fed from ShardManager snapshots."""

    def __init__(self, dataset: str, reg: MetricsRegistry = registry):
        self.dataset = dataset
        self.reg = reg

    def update(self, snapshot: dict) -> None:
        counts = defaultdict(int)
        for info in snapshot.values():
            counts[info["status"]] += 1
        for status in ("Active", "Assigned", "Recovery", "Down", "Unassigned"):
            self.reg.gauge(FILODB_SHARD_STATUS,
                           {"dataset": self.dataset, "status": status}
                           ).update(counts.get(status, 0))
