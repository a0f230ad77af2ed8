"""Layered configuration system.

Host copy of ``filodb_tpu/config.py``: the same keys, defaults, layering
and duration parser, so the reference's config files load unchanged.
``store_config()`` / ``query_config()`` build the port's ``StoreConfig`` /
``QueryConfig``. The keys that drive XLA program machinery
(``query.plan_cache_size``, ``query.warmup_shapes``,
``query.mesh_programs``, ``query.mesh_donation``) are kept and do nothing
in the port, which runs eagerly (ROADMAP ground rules: "XLA program
machinery has no port"). ``query.fused_kernels`` is checked at server
start by :func:`fused_kernels_mode` and applied as the process-global
fused mode (``ops/fusedresident.set_mode``).

Reference: Typesafe HOCON layering — core/src/main/resources/filodb-defaults.conf
(367 lines of defaults incl. schema definitions :17-106, store-factory FQCN :273,
spread :128-133) <- server conf <- per-dataset source configs
(conf/timeseries-dev-source.conf, parsed by core/.../store/IngestionConfig.scala).

Here: JSON (a strict HOCON subset) with deep-merge layering:
defaults <- config file <- programmatic overrides. Duration strings ("5m",
"2h", "90s") are accepted anywhere a *_ms value is expected.
"""

from __future__ import annotations

import copy
import json
import re
from typing import Any

# ---------------------------------------------------------------------------
# Declared config surface.
#
# Every dotted key this process reads is declared HERE, once, with its type,
# default and a one-line doc — DEFAULTS below is DERIVED from this spec, so
# a key cannot exist without documentation and a documented key cannot have
# a divergent default.  filolint's surface-check family enforces the read
# side (an undeclared ``cfg[...]`` / ``cfg.get(...)`` key and an unread
# declared key both fail tier-1), and the README "Configuration" table is
# generated from this dict (tests/test_static_analysis.py keeps them equal).
# Reference: Typesafe filodb-defaults.conf — 367 lines of documented
# defaults the reference treats as the deployment contract.
# ---------------------------------------------------------------------------

CONFIG_SPEC: dict[str, tuple[str, Any, str]] = {
    "dataset": ("str", "prometheus",
                "Dataset created, ingested and served at startup."),
    "schema": ("str", "gauge",
               "Ingest schema of the dataset (gauge / prom-counter / "
               "histogram / ...)."),
    "num_shards": ("int", 1,
                   "Shard count; rounded UP to a power of two so hash "
                   "routing covers the id space."),
    "spread": ("int", 0,
               "Shard-key spread bits (2^spread shards per shard key)."),
    "store.max_series_per_shard": ("int", 1 << 20,
                                   "Series capacity per shard store."),
    "store.samples_per_series": ("int", 1024,
                                 "In-memory sample window per series."),
    "store.flush_batch_size": ("int", 65536,
                               "Rows per chunk-flush batch to the sink."),
    "store.groups_per_shard": ("int", 16,
                               "Flush groups per shard (checkpoint "
                               "granularity; ref: GroupFlush)."),
    "store.retention": ("duration", "3h",
                        "In-memory retention, measured in data time."),
    "store.dtype": ("str", "float32", "Value dtype of the shard store."),
    "store.purge_interval": (
        "duration", "10m",
        "Cadence of the expired-series purge; data-time based so "
        "backfilled workloads behave like live ones."),
    "store.compressed_residency": (
        "str", "off",
        "Compressed-resident store shape: off (raw f32/i64), gauge "
        "(narrowest scalar decode variant: delta8/quant16/delta16), all "
        "(+ i8/i16 2D-delta histogram blocks)."),
    "store.narrow_cohort_gate": (
        "float", 0.25,
        "Max fraction of live rows allowed in the raw cohort pool before "
        "a store declines compressed residency (and counts a "
        "residency-fallback)."),
    "store.narrow_mirror": (
        "bool", False,
        "Keep an i16 mirror ALONGSIDE raw f32 (bandwidth, not capacity); "
        "ignored when compressed_residency is active."),
    "index.persist": (
        "bool", True,
        "Persist the part-key index as columnar time-bucket frames "
        "(index.log, CRC-verified) beside the JSON part-key log, so a "
        "restarted shard recovers the index with bulk array loads instead "
        "of a per-key rebuild."),
    "index.time_bucket": (
        "duration", "6h",
        "Granularity of persisted index time buckets (creations group by "
        "series start time; tombstones ride a dedicated bucket)."),
    "index.max_series_per_tenant": (
        "int|null", None,
        "Per-tenant ACTIVE-series quota: a tenant at the limit cannot "
        "birth new part keys — the shard sheds the new series (typed "
        "RETRY at the gateway, 429 + Retry-After at remote-write) while "
        "samples for existing series always land (null = unlimited)."),
    "index.tenant_label": (
        "str", "_ws_",
        "Label whose value is the tenant identity for cardinality "
        "governance (the workspace label by default)."),
    "index.quota_retry_after": (
        "duration", "30s",
        "Retry-After hint returned with a cardinality-quota 429 (series "
        "churn out on purge/eviction, so retries eventually land)."),
    "query.stale_sample_after": ("duration", "5m",
                                 "Prometheus staleness window."),
    "query.sample_limit": ("int", 1_000_000,
                           "Max samples one query may touch."),
    "query.num_threads": ("int", 4,
                          "Query-scheduler worker threads (ref: QueryActor "
                          "dedicated scheduler)."),
    "query.queue_size": ("int", 64,
                         "Bounded query queue; overflow sheds as 503."),
    "query.timeout": ("duration", "60s",
                      "Per-query timeout (maps to HTTP 504)."),
    "query.slow_log_threshold_ms": (
        "int|null", 1000,
        "Queries at or over this wall duration (ms) enter the slow-query "
        "ring served at /api/v1/debug/slow_queries (with plan summary, "
        "per-query stats, and trace id); null disables the log."),
    "query.slow_log_size": (
        "int", 128, "Capacity of the slow-query ring buffer."),
    # accepted so a reference config loads; the port compiles no plans
    "query.plan_cache_size": (  # filolint: ignore[surface-config-unused]
        "int", 256,
        "Compiled-plan cache capacity in the reference (an LRU of XLA "
        "programs). Does nothing in the port: it runs eagerly and "
        "compiles no per-shape programs."),
    # accepted so a reference config loads; the port has no trace to warm
    "query.warmup_shapes": (  # filolint: ignore[surface-config-unused]
        "list[dict]", [],
        "Query shapes the reference pre-traces at startup. Does nothing "
        "in the port: there is no XLA compile to absorb (the hand kernels "
        "build once at first use)."),
    "query.result_cache_size": (
        "int", 256,
        "Step-aligned result-cache entries per engine, keyed on (promql, "
        "start, end, step, tenant) and invalidated by per-shard ingest "
        "watermark (0 disables)."),
    "query.negative_cache_size": (
        "int", 256,
        "TTL-bounded negative result cache entries per engine: a query "
        "whose selection matched ZERO series cluster-wide short-circuits "
        "(no parse/plan/execute) until its TTL expires (0 disables)."),
    "query.negative_cache_ttl": (
        "duration", "30s",
        "Lifetime of a negative-cache entry — the bound on how long a "
        "newly-appearing series can be masked by a cached empty result."),
    "query.fragment_cache_size": (
        "int", 256,
        "Incremental-serving fragment cache entries per engine, keyed on "
        "(promql, step, tenant): a shifted dashboard window reuses the "
        "cached per-step columns still provably valid under the shard "
        "epoch logs and computes only the new head/tail steps "
        "(0 disables)."),
    "query.fragment_cache_bytes": (
        "int", 67108864,
        "Total resident bytes admitted to the fragment cache (fragments "
        "vary wildly in size, so the entry bound alone would not bound "
        "memory); LRU-evicted with eviction accounting."),
    "query.fragment_max_steps": (
        "int", 4096,
        "Steps kept per fragment entry — older (head) steps trim first, "
        "exactly the ones a sliding dashboard window evicts; bounds "
        "per-entry growth under streaming subscriptions."),
    "query.subscribe_poll": (
        "duration", "100ms",
        "Watermark poll cadence between /api/v1/subscribe increments "
        "(long-poll wait granularity and chunked-stream tick)."),
    "query.fused_kernels": (
        "str", "pallas",
        "Fused kernel tier: off | xla | pallas. xla and pallas both mean "
        "the hand-written kernels on the card (their plain torch twins on "
        "the CPU); off routes every query through the composed two-step "
        "chain (range function, then the aggregators), the fused tier's "
        "A/B baseline."),
    # accepted so a reference config loads; the port's mesh has one mode
    "query.mesh_programs": (  # filolint: ignore[surface-config-unused]
        "str", "auto",
        "Mesh program mode in the reference (pjit / shard_map / auto). "
        "Does nothing in the port: its mesh has one eager mode."),
    # accepted so a reference config loads; no XLA program to donate into
    "query.mesh_donation": (  # filolint: ignore[surface-config-unused]
        "bool", True,
        "Operand donation of the reference's pjit mesh programs. Does "
        "nothing in the port (no XLA programs to donate into)."),
    "query.max_concurrent_cost": (
        "int|null", None,
        "Aggregate estimated query cost (series x steps x window-steps) "
        "admitted to execute concurrently; transient overload sheds 503 + "
        "Retry-After before execution, while a query whose own cost "
        "exceeds the budget outright fails non-retryable 422 (null leaves "
        "the global budget unbounded — tenant_quotas still apply)."),
    "query.tenant_quotas": (
        "dict", {},
        "Per-tenant max concurrent cost (tenant name -> cost units; "
        "tenants arrive via the X-Filo-Tenant header or tenant= query "
        "param). Tenants absent from the map share only the global "
        "budget; a query over its tenant's quota outright fails 422."),
    "query.shed_retry_after": (
        "duration", "1s",
        "Retry-After hint returned with an admission-shed 503."),
    "downsample.enabled": ("bool", False,
                           "Inline downsampling at flush into durable "
                           "per-aggregate datasets ({ds}:ds_{res})."),
    "downsample.resolutions": (
        "list[duration]", ["1m"],
        "Ascending resolutions; the first publishes inline at flush, "
        "coarser ones cascade from the previous."),
    "downsample.cascade_interval": (
        "duration", "6h",
        "Cadence of the coarse-resolution cascade job (ref: "
        "DownsamplerMain 6h cron)."),
    "downsample.serve_interval": (
        "duration", "30s",
        "Refresh cadence of the downsample serving views "
        "(/promql/{ds}:ds_1m/...)."),
    "retention.routing": (
        "bool", False,
        "Downsample-aware query routing: long-range/coarse-step queries "
        "serve from the ds_family resolution that best covers "
        "[start,end,step], stitching the recent raw tail at the in-memory "
        "horizon (off = raw-only serving; &resolution= overrides per "
        "query)."),
    "retention.resolutions": (
        "list[str]", [],
        "Serving resolution set for routing: 'raw' plus durations that "
        "name inline-downsample families (empty = 'raw' + every "
        "downsample.resolutions entry)."),
    "retention.raw_ttl": (
        "duration|null", None,
        "Durable raw retention: a background job ages raw chunks older "
        "than this out of the (replicated) sink and bumps data_epoch so "
        "cached results invalidate (null = keep raw forever)."),
    "retention.compact_interval": (
        "duration", "1h",
        "Cadence of the durable raw age-out job (retention.raw_ttl)."),
    "retention.store_timeout": (
        "duration", "10s",
        "Connect/read timeout of RemoteStore links to StoreServer nodes; "
        "a dead backend times out and fails over to the next replica "
        "instead of stalling the read."),
    "rules.groups": (
        "list[dict]", [],
        "Recording/alerting rule groups (Prometheus rule-file shape: "
        "name/interval/rules with record|alert, expr, labels, for). "
        "Validated at startup; expressions with @ are rejected."),
    "rules.default_interval": (
        "duration", "30s",
        "Evaluation interval for groups that do not set their own."),
    "rules.max_concurrent": (
        "int", 2,
        "Group evaluations admitted to run at once (an AdmissionController "
        "gate; a group over the bound waits and its lag gauge grows)."),
    "rules.max_catchup": (
        "int", 2,
        "Missed grid ticks re-evaluated after a restart or stall, newest "
        "last; the re-publish dedupes via deterministic (rule, eval_ts) "
        "pub-ids, so catch-up is exactly-once."),
    "rules.streaming": (
        "bool", True,
        "Evaluate rules as streaming-query subscribers (query/"
        "incremental.py): each tick takes its grid step from a per-rule "
        "subscription and catch-up spans evaluate as ONE range query "
        "instead of one full-window evaluation per missed tick (off = "
        "instant evaluation per tick)."),
    "rules.webhook_url": (
        "str|null", None,
        "Alert notification webhook (POST JSON on firing/resolved "
        "transitions); null disables notifications."),
    "rules.webhook_retries": (
        "int", 3,
        "Webhook delivery attempts before the notification is dropped and "
        "counted failed."),
    "rules.webhook_backoff": (
        "duration", "1s",
        "Base backoff between webhook retries (doubles per attempt)."),
    "ingest.publish_window": (
        "int", 64,
        "Frames per broker PUBLISH_BATCH round trip — the in-flight "
        "window of the pipelined publisher."),
    "ingest.partitions": (
        "int|null", None,
        "Broker partition count; shard s publishes to and consumes "
        "partition s mod partitions (null = one partition per shard)."),
    "ingest.replication": (
        "int", 1,
        "Replicas per partition across the bus_addrs broker nodes "
        "(1 = unreplicated; replica set of partition p = peers "
        "p..p+R-1 mod N, leader first)."),
    "ingest.min_insync": (
        "int", 1,
        "In-sync replicas (leader included) required to ack a publish; "
        "below it the broker sheds with RETRY (quorum-stall "
        "backpressure)."),
    "ingest.max_partition_queue": (
        "int", 256,
        "Concurrent in-flight publishes admitted per partition; overload "
        "sheds with RETRY (and 429 + Retry-After at the HTTP write "
        "path)."),
    "ingest.retry_backoff": (
        "duration", "50ms",
        "Base client backoff after a RETRY shed or reconnect "
        "(exponential with jitter, capped at 32x)."),
    "ingest.publish_retries": (
        "int", 8,
        "Max client re-sends of an unacked publish window before the "
        "typed BrokerRetry/transport error surfaces."),
    "ingest.faults": (
        "list[dict]", [],
        "Deterministic FaultPlan rules for the broker (site/action/nth/"
        "partition/at_offset...; fault-injection tests and soak runs "
        "only)."),
    "ingest.epoch_fencing": (
        "bool", False,
        "Monotonic leadership epochs on the replicated broker tier: "
        "publishes and replication batches are refused below the "
        "partition's current epoch, closing the spurious-failover "
        "split-brain window (clients claim a new epoch on failover; a "
        "restarted deposed leader truncates its divergent tail and "
        "catches up on REJOIN)."),
    "ingest.decode_ahead": (
        "int", 2,
        "Containers decoded ahead of the device scatter "
        "(IngestionConsumer double buffering; 0 = serial)."),
    "ingest.gateway_port": (
        "int|null", None,
        "Enables the Influx line-protocol TCP gateway on the standalone "
        "server (null = off; 0 = any free port)."),
    "ingest.gateway_flush_lines": (
        "int", 1000, "Size bound per (connection, shard) gateway batch."),
    "ingest.gateway_flush_interval": (
        "duration", "500ms",
        "Time bound so low-rate shards still land promptly (0 disables "
        "the timed flusher)."),
    "http.host": ("str", "127.0.0.1", "HTTP bind address."),
    "http.port": ("int", 8080, "HTTP port (0 = any free port)."),
    "http.advertise": (
        "str|null", None,
        "Endpoint advertised to peers for /exec dispatch (overrides the "
        "bind host for NAT/multi-homed nodes)."),
    "data_dir": ("str|null", None,
                 "Enables the durable FileColumnStore when set."),
    "bus_dir": ("str|null", None,
                "Enables FileBus ingestion consumers when set."),
    "bus_addr": ("str|null", None,
                 "host:port of a BrokerServer (overrides bus_dir); shard N "
                 "consumes broker partition N mod ingest.partitions."),
    "bus_addrs": ("list[str]", [],
                  "Broker replica addresses (host:port, the shared peers "
                  "list of every broker node); overrides bus_addr — "
                  "clients fail over across them by watermark rank."),
    "profiler.enabled": ("bool", False,
                         "Always-on sampling profiler (ref: "
                         "SimpleProfiler)."),
    "profiler.interval": ("duration", "100ms", "Profiler sample cadence."),
    "tracing.log_spans": ("bool", False, "Log tracer spans."),
    "trace.enabled": (
        "bool", True,
        "Distributed tracing: spans on the query and ingest hot paths, "
        "context propagated across /exec, remote-write/read, and broker "
        "wires (off = trace roots pay a single flag check)."),
    "trace.sample_rate": (
        "float", 1.0,
        "Fraction of trace ROOTS recorded; the decision rides the trace "
        "context, so a trace is recorded on every node or none."),
    "trace.zipkin_endpoint": (
        "str|null", None,
        "Zipkin v2 collector URL (e.g. http://host:9411/api/v2/spans); "
        "when set a background reporter drains the span ring to it."),
    "diagnostics.enabled": (
        "bool", False,
        "Runtime concurrency assertions: donation provenance, lock "
        "discipline, long-hold warnings (ref: "
        "scheduler.enable-assertions)."),
    "store_nodes": ("list[str]", [],
                    "Remote StoreServer host:port list — the "
                    "Cassandra-layer deployment shape; data_dir is the "
                    "single-node form."),
    "store_replication": ("int", 2,
                          "Replication factor across store_nodes."),
    "cluster.registrar": ("str|null", None,
                          "Shared registrar directory enabling multi-host "
                          "membership (ref: akka-bootstrapper)."),
    "cluster.self_addr": ("str|null", None,
                          "This node's cluster identity; defaults to the "
                          "HTTP address."),
    "cluster.heartbeat_interval": ("duration", "5s",
                                   "Registrar heartbeat cadence."),
    "cluster.stale_after": ("duration", "30s",
                            "Heartbeat age after which a peer is declared "
                            "down (and we self-quarantine)."),
    "cluster.min_members": (
        "int", 1,
        "Members to wait for before assigning shards, so every node "
        "computes the identical assignment."),
    "cluster.join_timeout": ("duration", "30s",
                             "Max wait for min_members at startup."),
    "cluster.gossip_port": (
        "int|null", None,
        "Enables the membership gossip agent on this TCP port (0 = any "
        "free port; null = registrar-heartbeat liveness only). Peers "
        "learn the bound address from registrar heartbeats."),
    "cluster.gossip_interval": (
        "duration", "1s",
        "Cadence of the gossip agent's probe rounds (suspicion itself is "
        "counted in rounds, not wall time)."),
    "cluster.suspect_after": (
        "int", 3,
        "Probe rounds without a heartbeat-counter advance before a peer "
        "turns SUSPECT (counted, not timed)."),
    "cluster.dead_after": (
        "int", 8,
        "Probe rounds without an advance before a SUSPECT peer is "
        "declared DEAD and its shards reassign to survivors."),
    "cluster.shard_fencing": (
        "bool", False,
        "Epoch-fence store-ring writers: each owned shard's leadership "
        "epoch persists in the durable ring and flush/checkpoint writes "
        "from a deposed owner are refused (requires a durable sink)."),
    "cluster.buddy_endpoint": (
        "str|null", None,
        "Buddy cluster base URL for failure-aware query routing: time "
        "ranges overlapping a known-bad window (dead node, warming "
        "shard) steer sub-queries there over the Prometheus HTTP API "
        "and stitch with local results (null = local-only serving)."),
}


def _nest(flat: dict[str, Any]) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for dotted, v in flat.items():
        cur = out
        parts = dotted.split(".")
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return out


# the runtime default tree is DERIVED from the spec — one source of truth
DEFAULTS: dict[str, Any] = _nest({k: v[1] for k, v in CONFIG_SPEC.items()})


def config_markdown_table() -> str:
    """The README 'Configuration' table, generated from CONFIG_SPEC
    (verified against the checked-in README by
    tests/test_static_analysis.py)."""
    lines = ["| key | type | default | meaning |", "|---|---|---|---|"]
    for key, (typ, default, doc) in sorted(CONFIG_SPEC.items()):
        shown = "null" if default is None else repr(default)
        lines.append(f"| `{key}` | {typ} | `{shown}` | {doc} |")
    return "\n".join(lines)

_DUR = {"ms": 1, "s": 1000, "m": 60_000, "h": 3_600_000, "d": 86_400_000}


def parse_duration_ms(v) -> int:
    if isinstance(v, (int, float)):
        return int(v)
    m = re.fullmatch(r"(\d+(?:\.\d+)?)(ms|[smhd])", str(v))
    if not m:
        raise ValueError(f"bad duration {v!r}")
    return int(float(m.group(1)) * _DUR[m.group(2)])


def _deep_merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


class Config:
    def __init__(self, *layers: dict):
        merged = DEFAULTS
        for layer in layers:
            if layer:
                merged = _deep_merge(merged, layer)
        self.data = merged

    @classmethod
    def load(cls, path: str | None = None, overrides: dict | None = None) -> "Config":
        layers = []
        if path:
            with open(path) as f:
                layers.append(json.load(f))
        if overrides:
            layers.append(overrides)
        return cls(*layers)

    def __getitem__(self, dotted: str):
        cur = self.data
        for part in dotted.split("."):
            cur = cur[part]
        return cur

    def get(self, dotted: str, default=None):
        try:
            return self[dotted]
        except KeyError:
            return default

    def store_config(self):
        """The port's ``StoreConfig`` (its shards take the device their
        memstore or ``setup`` gives them). The cohort gate is a constant of
        the port (``core/chunkstore.COHORT_GATE``): a config that sets
        another value is refused, never ignored."""
        from .core.chunkstore import COHORT_GATE
        from .core.memstore import StoreConfig
        s = self.data["store"]
        gate = float(s.get("narrow_cohort_gate", COHORT_GATE))
        if gate != COHORT_GATE:
            raise ValueError(
                f"store.narrow_cohort_gate={gate!r}: the port's cohort gate "
                f"is fixed at {COHORT_GATE}")
        return StoreConfig(
            max_series_per_shard=s["max_series_per_shard"],
            samples_per_series=s["samples_per_series"],
            flush_batch_size=s["flush_batch_size"],
            groups_per_shard=s["groups_per_shard"],
            retention_ms=parse_duration_ms(s["retention"]),
            dtype=s["dtype"],
            compressed_residency=s.get("compressed_residency", "off"),
            narrow_mirror=bool(s.get("narrow_mirror", False)),
        )

    def query_config(self):
        from .query.engine import QueryConfig
        q = self.data["query"]
        thr = q["slow_log_threshold_ms"]
        max_cost = q["max_concurrent_cost"]
        return QueryConfig(
            stale_sample_after_ms=parse_duration_ms(q["stale_sample_after"]),
            sample_limit=q["sample_limit"],
            slow_log_threshold_ms=None if thr is None else float(thr),
            result_cache_size=int(q["result_cache_size"]),
            max_concurrent_cost=(None if max_cost is None
                                 else float(max_cost)),
            tenant_quotas=dict(q["tenant_quotas"] or {}),
            shed_retry_after_s=parse_duration_ms(
                q["shed_retry_after"]) / 1000.0,
            negative_cache_size=int(q["negative_cache_size"]),
            negative_cache_ttl_s=parse_duration_ms(
                q["negative_cache_ttl"]) / 1000.0,
            fragment_cache_size=int(q["fragment_cache_size"]),
            fragment_cache_bytes=int(q["fragment_cache_bytes"]),
            fragment_max_steps=int(q["fragment_max_steps"]),
        )


def fused_kernels_mode(cfg: Config) -> str:
    """Validate ``query.fused_kernels`` for the port. ``"xla"`` and
    ``"pallas"`` both select the hand-written kernels (K1/K2) on the card
    and their plain twins on the CPU. ``"off"`` selects the composed
    two-step chain, as the reference's does (``ops/fusedresident.py``).
    Any other name is refused before the server starts anything."""
    mode = str(cfg["query.fused_kernels"])
    if mode not in ("off", "xla", "pallas"):
        raise ValueError(
            f"query.fused_kernels must be off|xla|pallas, got {mode!r}")
    return mode
