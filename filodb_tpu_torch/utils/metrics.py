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
# the rules subsystem (rules/):
# counter: rule evaluations completed, tagged group= and rule= (one per rule
# per scheduler tick)
FILODB_RULES_EVALUATIONS = "filodb_rules_evaluations"
# counter: rule evaluations that raised (bad data mid-flight, admission shed
# after retries, publish fault), tagged group= and rule=; the group keeps
# evaluating
FILODB_RULES_EVAL_FAILURES = "filodb_rules_eval_failures"
# histogram: wall time of one whole group evaluation (every rule in the
# group, sequentially, derived publish included), tagged group=
FILODB_RULES_EVAL_LATENCY_MS = "filodb_rules_eval_latency_ms"
# gauge: how far the group's completed evaluation trails its scheduled grid
# tick, per group — sustained growth means the interval is shorter than the
# evaluation costs
FILODB_RULES_EVAL_LAG_MS = "filodb_rules_eval_lag_ms"
# counter: derived samples published back through the ingest plane by
# recording rules, tagged group=
FILODB_RULES_DERIVED_ROWS = "filodb_rules_derived_rows"
# gauge: alert instances currently in the firing state, tagged rule=
FILODB_RULES_ALERTS_FIRING = "filodb_rules_alerts_firing"
# counter: alert state-machine transitions, tagged rule= and to=
# (pending/firing/inactive)
FILODB_RULES_ALERT_TRANSITIONS = "filodb_rules_alert_transitions"
# counter: webhook notifications attempted, tagged status=ok|failed (failed
# = retries exhausted)
FILODB_RULES_NOTIFICATIONS = "filodb_rules_notifications"
# counter: external writes rejected for carrying the reserved __rule__ label
# (tagged site=remote-write|gateway): derived-series provenance cannot be
# forged
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
# gauges a /metrics scrape refreshes per shard from its TimedRLock, and the
# lock hold-time histogram recorded under FILODB_LOCK_DEBUG=1
# (utils/diagnostics.py)
FILODB_SHARD_LOCK_CONTENTIONS = "filodb_shard_lock_contentions"
FILODB_SHARD_LOCK_LONG_HOLDS = "filodb_shard_lock_long_holds"
FILODB_LOCK_HOLD_MS = "filodb_lock_hold_ms"

# counter: key reads of a wide selection (query/exec.py::LazyKeys) that
# found partition releases since the leaf's capture and so checked the
# selected slots one by one (tagged dataset/shard)
FILODB_QUERY_SELECTION_RELEASE_RECHECKS = \
    "filodb_query_selection_release_rechecks"

# The port's metrics that the reference has no twin of.
PORT_ONLY = (FILODB_QUERY_SELECTION_RELEASE_RECHECKS,)

# The reference's METRICS_SPEC names these too; they belong to its
# compiled-plan cache (query/plancache.py), which has no port.
NOT_PORTED = ("filodb_query_compile_cache_hits",
              "filodb_query_compile_cache_misses",
              "filodb_query_compile_cache_evictions")

# The declared metric surface: every ``filodb_*`` series this process
# exports is named by one constant above and documented here (filolint's
# surface-check family enforces it; a ``*`` suffix declares a dynamic
# family). The reference's, less NOT_PORTED, plus PORT_ONLY.
METRICS_SPEC: dict[str, tuple[str, str]] = {
    FILODB_INGESTED_ROWS: (
        "counter", "Rows ingested per dataset/shard by the bus consumers."),
    FILODB_GATEWAY_INGESTED_ROWS: (
        "counter", "Samples accepted by the line-protocol gateway "
                   "(a line with F fields contributes F)."),
    FILODB_GATEWAY_PARSE_ERRORS: (
        "counter", "Malformed line-protocol lines dropped by the gateway "
                   "(latest offender sampled in last_parse_error)."),
    FILODB_INGEST_DECODE_ERRORS: (
        "counter", "Decode-ahead worker faults surfaced to the consumer "
                   "(the batch is re-fetched; a rising rate means a "
                   "corrupt bus segment)."),
    FILODB_INGEST_RETRIES: (
        "counter", "BrokerBus publish re-sends: reconnect replays of the "
                   "unacked window plus RETRY-shed backoffs (jittered "
                   "exponential, capped)."),
    FILODB_INGEST_FAILOVERS: (
        "counter", "BrokerBus leader re-resolutions: the client re-ranked "
                   "the replica set by watermark and switched brokers."),
    FILODB_INGEST_REPLICATION_LAG: (
        "gauge", "Frames the follower trails the leader, per partition and "
                 "peer (0 when fully replicated; grows while a follower "
                 "is down or out of the in-sync set)."),
    FILODB_INGEST_PUBLISH_SHED: (
        "counter", "Publishes the broker shed with RETRY: per-partition "
                   "queue-depth overload or a below-min_insync quorum "
                   "stall (clients back off and replay idempotently)."),
    FILODB_SWALLOWED_ERRORS: (
        "counter", "Errors intentionally dropped on non-critical paths, "
                   "tagged by site= — the observability replacement for "
                   "`except: pass` (filolint except-swallow)."),
    FILODB_SCHEDULER_WORKER_ERRORS: (
        "counter", "Query-scheduler worker-loop faults outside task "
                   "execution; the worker survives and the fault is "
                   "counted instead of killing the thread."),
    FILODB_PEER_EXEC_REQUESTS: (
        "counter", "Cross-node /exec dispatches per endpoint."),
    FILODB_PEER_EXEC_LATENCY_MS: (
        "gauge", "Last cross-node /exec round-trip latency per endpoint."),
    FILODB_PEER_BREAKER_OPEN: (
        "gauge", "1 while the per-peer circuit breaker is open (dispatches "
                 "shed fast as 503)."),
    FILODB_SHARD_STATUS: (
        "gauge", "Shard count per dataset and status "
                 "(Active/Assigned/Recovery/Down/Unassigned)."),
    FILODB_SHARD_NUM_SERIES: (
        "gauge", "Live series per shard."),
    FILODB_SHARD_LOCK_CONTENTIONS: (
        "gauge", "TimedRLock contention count per shard (diagnostics)."),
    FILODB_SHARD_LOCK_LONG_HOLDS: (
        "gauge", "TimedRLock long-hold count per shard (diagnostics)."),
    FILODB_LOCK_HOLD_MS: (
        "histogram", "TimedRLock hold time per lock class, recorded under "
                     "FILODB_LOCK_DEBUG=1 — the runtime twin of filolint's "
                     "live-block-under-lock rule; soak runs alert on "
                     "hold-time regressions the static pass cannot see."),
    FILODB_QUERY_LATENCY_MS: (
        "histogram", "End-to-end PromQL latency per dataset; the /metrics "
                     "rendering carries the last query's trace id as an "
                     "exemplar-style companion series."),
    FILODB_QUERY_SLOW: (
        "counter", "Queries that crossed query.slow_log_threshold_ms and "
                   "entered the slow-query ring "
                   "(/api/v1/debug/slow_queries)."),
    FILODB_QUERY_RESULT_CACHE_HITS: (
        "counter", "Result-cache hits: a repeated range query answered "
                   "from the step-aligned fragment cache after its ingest "
                   "watermark vector validated."),
    FILODB_QUERY_RESULT_CACHE_MISSES: (
        "counter", "Result-cache misses (no entry for the query key)."),
    FILODB_QUERY_RESULT_CACHE_EVICTIONS: (
        "counter", "Result-cache entries dropped by the LRU capacity bound "
                   "(query.result_cache_size)."),
    FILODB_QUERY_RESULT_CACHE_INVALIDATIONS: (
        "counter", "Result-cache entries discarded because a shard's ingest "
                   "watermark advanced past the entry's recorded vector "
                   "(data changed; a hit would no longer equal "
                   "re-execution)."),
    FILODB_QUERY_ADMISSION_SHED: (
        "counter", "Queries shed by cost-based admission control (tagged by "
                   "tenant): estimated cost did not fit the in-flight "
                   "budget, answered 503 + Retry-After."),
    FILODB_QUERY_ADMISSION_OVERSIZED: (
        "counter", "Queries rejected outright because their estimated cost "
                   "exceeds the absolute budget or tenant quota (answered "
                   "non-retryable 422; never admissible at any load — NOT "
                   "an overload signal)."),
    FILODB_QUERY_ADMISSION_COST: (
        "gauge", "Estimated cost units currently admitted and executing "
                 "(bounded by query.max_concurrent_cost)."),
    FILODB_QUERY_FUSED_SERVED: (
        "counter", "Queries served by a fused compressed-resident kernel, "
                   "tagged by registry shape (rate_sum / window_reduce / "
                   "hist_quantile) and backend (cuda on the card, plain "
                   "on the CPU)."),
    FILODB_QUERY_FUSED_FALLBACK: (
        "counter", "Queries that matched a fused shape but fell back to "
                   "the composed two-step path (shape gate, group cap, "
                   "off-grid store), tagged by shape."),
    FILODB_QUERY_MESH_SERVED: (
        "counter", "Queries served by a mesh dist_* collective, tagged by "
                   "route (fused / fused-narrow / twostep / sketch / topk) "
                   "and program mode (the port's mesh runs eagerly: "
                   "eager)."),
    FILODB_QUERY_MESH_FALLBACK: (
        "counter", "Mesh-eligible queries that fell back to the host "
                   "scatter-gather path after eligibility, tagged by reason "
                   "(paging / order_stat_caps / topk_caps)."),
    FILODB_QUERY_SELECTION_RELEASE_RECHECKS: (
        "counter", "Key reads of a wide selection that found partition "
                   "releases since the leaf captured it and checked the "
                   "selected slots one by one (0 while nothing is "
                   "evicted or purged)."),
    FILODB_QUERY_NEGATIVE_CACHE_HITS: (
        "counter", "Range queries answered from the TTL-bounded negative "
                   "result cache: a recent execution proved the selection "
                   "empty (typo'd metric), so plan+execute is skipped until "
                   "the TTL expires."),
    FILODB_QUERY_NEGATIVE_CACHE_EVICTIONS: (
        "counter", "Negative-cache entries dropped by TTL expiry or the "
                   "capacity bound (query.negative_cache_size)."),
    FILODB_QUERY_FRAGMENT_CACHE_HITS: (
        "counter", "Range queries that reused at least one provably-valid "
                   "cached per-step column from the incremental fragment "
                   "cache (query/incremental.py)."),
    FILODB_QUERY_FRAGMENT_CACHE_MISSES: (
        "counter", "Fragment-cache probes that reused nothing: no entry, "
                   "off-grid request, a coverage gap, or every cached step "
                   "past the stable-before bound."),
    FILODB_QUERY_FRAGMENT_CACHE_EXTENSIONS: (
        "counter", "Fragment entries extended by a delta evaluation: only "
                   "the new head/tail steps executed, the overlap served "
                   "from cache (the dashboard-refresh fast path)."),
    FILODB_QUERY_FRAGMENT_CACHE_EVICTIONS: (
        "counter", "Fragment entries dropped by the entry-count "
                   "(query.fragment_cache_size) or total-byte "
                   "(query.fragment_cache_bytes) bound."),
    FILODB_QUERY_FRAGMENT_CACHE_INVALIDATIONS: (
        "counter", "Fragment entries dropped because per-step validity "
                   "could not be proven: destructive mutation "
                   "(purge/eviction/age-out), an epoch-log gap, or a "
                   "topology change since the entry's vector."),
    FILODB_QUERY_FRAGMENT_CACHE_BYTES: (
        "gauge", "Resident bytes of the fragment cache's per-step value "
                 "columns (per-entry detail at "
                 "/api/v1/debug/fragment_cache)."),
    FILODB_QUERY_WINDOWS_WIDENED: (
        "counter", "Windowed functions auto-widened on retention-routed "
                   "queries because their window was narrower than the "
                   "serving family's resolution (tagged dataset + "
                   "resolution; also in per-query stats)."),
    FILODB_QUERY_SUBSCRIBE_INCREMENTS: (
        "counter", "Per-step increments served by the streaming "
                   "subscription surface (/api/v1/subscribe long-poll and "
                   "chunked modes), tagged by dataset."),
    FILODB_INGEST_PUBLISH_LATENCY_MS: (
        "histogram", "BrokerBus pipelined publish-group round trip per "
                     "partition, exemplar-tagged with the publish trace "
                     "id."),
    FILODB_TRACE_SPANS: (
        "counter", "Spans recorded into the tracer ring buffer (sampled-in "
                   "only; sampled-out spans cost no clock reads)."),
    FILODB_RETENTION_ROUTED_QUERIES: (
        "counter", "Queries the retention router served from a downsample "
                   "family (tagged dataset + resolution; stitched raw+ds "
                   "queries count under the family's resolution)."),
    FILODB_RETENTION_ODP_ROWS: (
        "counter", "Samples paged in from the durable chunk tier by "
                   "on-demand paging, tagged tier=local|remote (remote = "
                   "the replicated StoreServer ring)."),
    FILODB_RETENTION_REPLICA_FAILOVER: (
        "counter", "Replica reads that failed and fell over to the next "
                   "backend of the ReplicatedColumnStore ring (tagged by "
                   "op; a rising rate means a dead or flapping "
                   "StoreServer)."),
    FILODB_RETENTION_AGED_OUT_ROWS: (
        "counter", "Raw samples aged out of the durable tier past "
                   "retention.raw_ttl (each pass also bumps the shard's "
                   "data_epoch so cached results invalidate)."),
    FILODB_STORE_RESIDENCY_FALLBACK: (
        "counter", "Flushes where a store configured for compressed "
                   "residency tried to compress and the data refused the "
                   "ok-contract (cohort gate breached), tagged "
                   "reason=resets|non-integer|range — distinguishes "
                   "\"compressed\" from \"tried and fell back to raw\"."),
    FILODB_RULES_EVALUATIONS: (
        "counter", "Rule evaluations completed, tagged group= and rule= "
                   "(one per rule per scheduler tick)."),
    FILODB_RULES_EVAL_FAILURES: (
        "counter", "Rule evaluations that raised (bad data mid-flight, "
                   "admission shed after retries, publish fault), tagged "
                   "group= and rule=; the group keeps evaluating."),
    FILODB_RULES_EVAL_LATENCY_MS: (
        "histogram", "Wall time of one whole group evaluation (every rule "
                     "in the group, sequentially, derived publish "
                     "included), tagged group=."),
    FILODB_RULES_EVAL_LAG_MS: (
        "gauge", "How far the group's completed evaluation trails its "
                 "scheduled grid tick, per group — sustained growth means "
                 "the interval is shorter than the evaluation costs."),
    FILODB_RULES_DERIVED_ROWS: (
        "counter", "Derived samples published back through the ingest "
                   "plane by recording rules, tagged group=."),
    FILODB_RULES_ALERTS_FIRING: (
        "gauge", "Alert instances currently in the firing state, tagged "
                 "rule=."),
    FILODB_RULES_ALERT_TRANSITIONS: (
        "counter", "Alert state-machine transitions, tagged rule= and to= "
                   "(pending/firing/inactive)."),
    FILODB_RULES_NOTIFICATIONS: (
        "counter", "Webhook notifications attempted, tagged status=ok| "
                   "failed (failed = retries exhausted)."),
    FILODB_RULES_SPOOF_REJECTS: (
        "counter", "External writes rejected for carrying the reserved "
                   "__rule__ label (tagged site=remote-write|gateway): "
                   "derived-series provenance cannot be forged."),
    FILODB_INDEX_RECOVER_MS: (
        "gauge", "Wall milliseconds the last shard restart spent recovering "
                 "the part-key index (per dataset/shard): columnar load "
                 "from persisted index.log time buckets when available, "
                 "else the per-key partkeys.log rebuild."),
    FILODB_INDEX_PERSISTED_BUCKETS: (
        "counter", "Index time-bucket frames persisted to the durable tier "
                   "(CRC-verified appends to index.log; recovery loads "
                   "these columnar instead of rebuilding per key)."),
    FILODB_TENANT_ACTIVE_SERIES: (
        "gauge", "Active (resident) series per dataset and tenant — the "
                 "quantity index.max_series_per_tenant bounds; births "
                 "increment, purge/eviction/release decrement."),
    FILODB_TENANT_SERIES_SHED: (
        "counter", "NEW series births shed by the per-tenant cardinality "
                   "limiter, tagged site=shard|gateway|remote-write — "
                   "samples for existing series are never counted here "
                   "(they always land)."),
    FILODB_CLUSTER_GOSSIP_ROUNDS: (
        "counter", "Gossip probe rounds run by this node's membership agent "
                   "(the deterministic round counter suspicion is counted "
                   "in — no wall clock)."),
    FILODB_CLUSTER_PEER_STATE: (
        "gauge", "Membership state per peer: 0=alive, 1=suspect, 2=dead "
                 "(counted-not-timed transitions at cluster.suspect_after / "
                 "cluster.dead_after probe rounds)."),
    FILODB_CLUSTER_EPOCH: (
        "gauge", "Current leadership epoch per fenced scope (scope="
                 "partition|shard, id=): bumps on every claim/adoption — a "
                 "step means a failover or rebalance cutover happened."),
    FILODB_CLUSTER_FENCED_REJECTS: (
        "counter", "Writes refused by epoch fencing (tagged site=publish|"
                   "replicate|store): a deposed leader tried to ack a "
                   "publish, stream a replication batch, or flush/checkpoint "
                   "after deposition."),
    FILODB_CLUSTER_REBALANCES: (
        "counter", "Operator-triggered live shard rebalances completed by "
                   "this node (flush→handoff→catch-up→cutover, tagged "
                   "dataset=)."),
    FILODB_CLUSTER_REJOIN_TRUNCATED: (
        "counter", "Divergent log frames a restarted deposed leader "
                   "truncated on REJOIN before catching up from the current "
                   "leader (tagged partition=)."),
    "filodb_shard_*": (
        "gauge", "Per-shard ingest/eviction stats exported from the shard's "
                 "IngestStats dataclass fields on each /metrics scrape."),
}


def metrics_markdown_table() -> str:
    """The README 'Metrics' table, generated from METRICS_SPEC (verified
    against the checked-in README by tests/test_torch_static_analysis.py)."""
    lines = ["| metric | kind | meaning |", "|---|---|---|"]
    for name, (kind, doc) in sorted(METRICS_SPEC.items()):
        lines.append(f"| `{name}` | {kind} | {doc} |")
    return "\n".join(lines)

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
    last traced observation's trace id and value as its exemplar, which
    /metrics renders as a companion ``<name>_exemplar{trace_id="..."}``
    series, as the reference does (the 0.0.4 text format has no native
    exemplar syntax)."""

    DEFAULT_BOUNDS = (1, 2, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000,
                      10000)

    def __init__(self, bounds=DEFAULT_BOUNDS):
        self.bounds = list(bounds)
        self.buckets = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0
        self.last_trace_id: str | None = None
        self.last_value = 0.0
        self._lock = threading.Lock()

    def record(self, v: float, trace_id: str | None = None):
        with self._lock:
            self.buckets[bisect_right(self.bounds, v)] += 1
            self.sum += v
            self.count += 1
            if trace_id:
                self.last_trace_id = trace_id
                self.last_value = v


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
                if m.last_trace_id:
                    et = (tag_s[:-1] + "," if tag_s else "{") \
                        + f'trace_id="{m.last_trace_id}"' + "}"
                    lines.append(f"{name}_exemplar{et} {m.last_value:g}")
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
