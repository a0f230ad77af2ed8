"""QueryEngine facade: PromQL text -> LogicalPlan -> ExecPlan -> QueryResult.

Port of the local path of ``filodb_tpu/query/engine.py`` (ref:
coordinator/.../QueryActor.scala + queryengine2/QueryEngine.materialize):
parse, plan, execute on this node's shards, present. One root span per
query and the end-to-end latency histogram, as in the reference. Before the
planner, ``histogram_quantile(q, sum by (...) (rate|increase|delta|...(h[w])))``
on a single grid-aligned histogram shard takes the fused-hist route, as in
the reference; every other histogram query takes the general ExecPlan
path. When the engine has a device mesh (``mesh=``, an ordered list of
devices, ``parallel/distributed.make_mesh``), every aggregate of a range
function over all the dataset's shards is tried on the mesh first, as in
the reference (ref: queryengine2/QueryEngine.scala:59-67): K1 launched once
per shard for the fusable aggregates, per-shard range functions and
partials for the rest, sketch counts for ``quantile``, candidate blocks for
``topk``/``bottomk``, folded on the host in shard order.

The serving fast path sits in front of execution, each piece off unless its
``QueryConfig`` field turns it on (as in the reference): a TTL-bounded
negative cache for provably empty selections, a step-aligned result cache
validated against the shards' data epochs, the per-step fragment cache that
extends a shifted range by executing only its new steps
(``query/incremental.py``), and cost-based admission
(``query/scheduler.py``). The metadata API (label values and names,
series, raw samples) reads the local shards; raw samples older than the
resident rows page in from a shard's durable sink.

Retention routing, as in the reference: with a ``RetentionRouter``
installed (``engine.retention``, ``query/retention.py``), a range query
whose step fits a downsample family and whose range lies behind the raw
window goes to that family's engine, whole or stitched onto the raw tail
at the horizon; ``resolution=`` forces a tier. A family engine runs the
query with ``min_window_ms``: windows narrower than the family's resolution
widen to cover it, and the floor rides every cache key.

The cluster plane, as in the reference: with a ``cluster`` (a
``parallel/cluster.ShardManager``) and this engine's ``node``, a leaf for a
shard another node owns ships to that node's ``/exec`` endpoint
(``query/wire.py``): the peer runs the map phase on its own card (K1 for
the fused aggregates) and only partials come back, merged here in the
single node's order. A peer that dies mid-query re-plans once against the
updated shard map. The serving caches validate against the peers' data
epochs (``/api/v1/epochs``); the metadata API fans out to the peers with
``local=1``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import re
import threading
import time
from collections import Counter, OrderedDict, deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core import filters as F
from ..core.memstore import TimeSeriesMemStore
from ..device import resolve_device
from ..ops import aggregators, fusedresident, gridfns, rangefns
from ..parallel import distributed
from ..parallel.cluster import stitch_matrices
from ..parallel.shardmapper import ShardMapper
from ..promql import parser as promql
from ..utils.metrics import (FILODB_QUERY_LATENCY_MS,
                             FILODB_QUERY_WINDOWS_WIDENED,
                             FILODB_QUERY_NEGATIVE_CACHE_EVICTIONS,
                             FILODB_QUERY_NEGATIVE_CACHE_HITS,
                             FILODB_QUERY_RESULT_CACHE_EVICTIONS,
                             FILODB_QUERY_RESULT_CACHE_HITS,
                             FILODB_QUERY_RESULT_CACHE_INVALIDATIONS,
                             FILODB_QUERY_RESULT_CACHE_MISSES,
                             FILODB_QUERY_SLOW, registry)
from ..utils.tracing import (SPAN_QUERY, SPAN_QUERY_ADMIT, SPAN_QUERY_EXECUTE,
                             SPAN_QUERY_FETCH, SPAN_QUERY_FRAGMENT,
                             SPAN_QUERY_LEAF, SPAN_QUERY_PARSE,
                             SPAN_QUERY_PLAN, span, tracer)
from . import logical as L
from .exec import (_SKETCH_BYTES_CAP, AggregateMapReduce, QueryContext,
                   SelectRawPartitionsExec, TopKPartial, _gather_rows_padded,
                   _group_ids_for, _pad_steps, _pow2, _present_topk,
                   _segment_partial, check_sample_limit, group_keys_of,
                   timed_hold)
from .incremental import FragmentCache, plan_cacheable
from .planner import QueryPlanner
from .rangevector import (QueryError, QueryResult, QueryStats, RangeVectorKey,
                          ResultMatrix)
from .retention import resolution_label, widen_windows
from .scheduler import AdmissionController, AdmissionRejected
from .wire import RemoteLeafExec, RemotePeerError, _plan_shards

# aggregation operators whose partial state crosses the mesh (the
# ops/aggregators partial layout)
MESH_OPS = frozenset({"sum", "avg", "count", "group", "stddev", "stdvar",
                      "min", "max"})
# order statistics on the mesh: topk/bottomk gather fixed-size candidate
# blocks (parallel/distributed.dist_topk), quantile sums sketch counts.
# count_values stays on the host merge: its partial state is keyed by
# rendered value strings, with no fixed-size layout to gather
MESH_ORDER_OPS = frozenset({"topk", "bottomk", "quantile"})
# the candidate search loops per group: cap G as the reference does
MESH_TOPK_MAX_GROUPS = 16
# rows outside the selection: a group id no kernel's one-hot or scatter
# ever matches (scatters drop it; one-hot comparisons never equal it)
_EXCLUDED_GID = 1 << 30


def _walk_plans(plan):
    """Yield every node of an ExecPlan tree (children/lhs/rhs/inner/members
    links)."""
    stack = [plan]
    while stack:
        p = stack.pop()
        yield p
        for attr in ("children", "lhs", "rhs", "inner", "child", "members"):
            v = getattr(p, attr, None)
            if isinstance(v, list):
                stack.extend(v)
            elif v is not None and hasattr(v, "transformers"):
                stack.append(v)
    return


def _sel_quote(v: str) -> str:
    """PromQL double-quoted string: backslashes and quotes escape, so label
    values containing either round-trip through the peer's parser instead of
    silently failing the whole fan-out."""
    return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'


def _filters_to_selector(filters) -> str:
    """Render column filters back into a PromQL selector string for peer
    metadata fan-out (the inverse of http/api._selector_to_filters)."""
    parts = []
    for f in filters:
        label = "__name__" if f.label == "_metric_" else f.label
        if isinstance(f, F.Equals):
            parts.append(f'{label}={_sel_quote(f.value)}')
        elif isinstance(f, F.NotEquals):
            parts.append(f'{label}!={_sel_quote(f.value)}')
        elif isinstance(f, F.EqualsRegex):
            parts.append(f'{label}=~{_sel_quote(f.pattern)}')
        elif isinstance(f, F.NotEqualsRegex):
            parts.append(f'{label}!~{_sel_quote(f.pattern)}')
        elif isinstance(f, F.In):
            # literal alternation: each member regex-escaped (an In value
            # like "1.5" must not match "125")
            alt = "|".join(re.escape(v) for v in f.values)
            parts.append(f'{label}=~{_sel_quote(alt)}')
    return "{" + ",".join(parts) + "}"


def pool_correction(data, gids: np.ndarray, bad: np.ndarray, Gp: int,
                    fn: str, out_eval: np.ndarray, window: int):
    """Cohort-pool rows of a hist-resident selection: (gids with those rows
    excluded, their [Gp, T*B] f32 group partials (sum, count) or None). The
    rows decode row-wise from their raw f32 pool blocks and go through the
    general histogram range function."""
    if not len(bad):
        return gids, None
    dev = data.n.device
    bad_gids = gids[bad].copy()
    gids = gids.copy()
    gids[bad] = _EXCLUDED_GID
    sub_ts, sub_val, sub_n, P = _gather_rows_padded(data.ts, data.val,
                                                    data.n, bad)
    hc = rangefns.periodic_samples_hist(sub_ts, sub_val, sub_n, out_eval,
                                        window, fn, 0.0)
    Tq, B = hc.shape[1], hc.shape[2]
    cg = np.full(P, _EXCLUDED_GID, np.int32)
    cg[:len(bad)] = bad_gids
    parts = _segment_partial("sum", hc.reshape(P, Tq * B),
                             torch.from_numpy(cg).to(dev), Gp)
    return gids, (parts["sum"].float(), parts["count"].float())


@dataclass
class QueryConfig:
    """Ref: query/.../QueryConfig.scala (stale-sample-after, sample limits),
    plus the serving fast path's knobs: every cache and the admission gate
    are off by default, as in the reference."""
    stale_sample_after_ms: int = 5 * 60 * 1000
    sample_limit: int = 1_000_000
    # queries at or over this wall duration enter the slow-query ring;
    # None disables the log
    slow_log_threshold_ms: float | None = 1000.0
    # step-aligned result cache entries per engine (0 disables)
    result_cache_size: int = 0
    # aggregate estimated cost admitted to execute concurrently; None
    # leaves the global budget unbounded (admission still runs when
    # tenant_quotas is set, and is off only when both are unset)
    max_concurrent_cost: float | None = None
    # tenant -> max concurrent cost (admission only)
    tenant_quotas: dict = field(default_factory=dict)
    # Retry-After hint on an admission shed
    shed_retry_after_s: float = 1.0
    # TTL- and size-bounded negative cache of provably empty selections
    # (0 disables)
    negative_cache_size: int = 0
    negative_cache_ttl_s: float = 30.0
    # incremental serving: per-step fragment cache entries per engine (0
    # disables), with a total byte bound and a per-entry step bound
    fragment_cache_size: int = 0
    fragment_cache_bytes: int = 64 << 20
    fragment_max_steps: int = 4096


class QueryResultCache:
    """Step-aligned range-result cache, invalidated by ingest watermark
    (ref: the reference's repeated-dashboard serving posture — QueryEngine2
    materializes once, serves many).

    Entries are keyed on ``(promql, start, end, step, tenant, min
    window)`` and record the EPOCH VECTOR — every shard's ``data_epoch``
    mutation counter — captured BEFORE the query executed. A hit requires
    the current vector to EQUAL the recorded one, so any flush, release,
    compaction or topology change since makes the entry unreachable
    (counted as an invalidation): a served hit is provably identical to
    re-execution, because the data it would re-read cannot have changed.
    Capacity-bounded LRU (``QueryConfig.result_cache_size``) with an
    evictions metric.

    The payload is the result as execution returned it: its matrix values
    may be a device tensor (a per-series answer on the card) or a host
    array (a presented aggregate), never a lazy object (a fused pass's
    ``PaddedPartials`` resolves when the result is presented, before the
    put). Every hit hands out the same matrix, which nothing mutates; keys
    that are a ``LazyKeys`` build a fresh list under the shard lock on each
    read. So concurrent hits on one entry share nothing that resolves."""

    def __init__(self, capacity: int = 256, tags: dict | None = None):
        self.capacity = max(1, int(capacity))
        # per-cache metric identity (e.g. {"dataset": ...}): untagged,
        # every engine's cache would share one process-global counter set
        # and stats() would report the sum as if it were this cache's
        self.tags = dict(tags or {})
        # key -> (epoch vector, payload) where payload =
        # (matrix, result_type, warnings, stats_dict, exec_path)
        self._entries: OrderedDict[tuple, tuple] = OrderedDict()
        self._lock = threading.Lock()
        self._hits = registry.counter(FILODB_QUERY_RESULT_CACHE_HITS,
                                      self.tags)
        self._misses = registry.counter(FILODB_QUERY_RESULT_CACHE_MISSES,
                                        self.tags)
        self._evictions = registry.counter(
            FILODB_QUERY_RESULT_CACHE_EVICTIONS, self.tags)
        self._invalidations = registry.counter(
            FILODB_QUERY_RESULT_CACHE_INVALIDATIONS, self.tags)

    def get(self, key: tuple, current_epochs):
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                self._misses.increment()
                return None
            epochs, payload = e
            if current_epochs is None:
                # unverifiable vector: never serve what cannot be proven,
                # but an unreadable watermark is not evidence the data
                # changed — keep the entry
                self._misses.increment()
                return None
            if epochs != current_epochs:
                # the watermark moved: serving the entry could diverge
                # from re-execution — drop it
                del self._entries[key]
                self._invalidations.increment()
                self._misses.increment()
                return None
            self._entries.move_to_end(key)
            self._hits.increment()
            return payload

    def put(self, key: tuple, payload, epochs) -> None:
        if epochs is None:
            return                      # unverifiable vector: never cache
        with self._lock:
            self._entries[key] = (epochs, payload)
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self._evictions.increment()

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {"size": len(self._entries), "capacity": self.capacity,
                    "hits": self._hits.value, "misses": self._misses.value,
                    "evictions": self._evictions.value,
                    "invalidations": self._invalidations.value}


class NegativeResultCache:
    """TTL- and size-bounded cache of query texts whose selection came back
    EMPTY (0 series): a typo'd metric name on a dashboard refresh loop stops
    costing a full parse+plan+execute per tick.

    Unlike QueryResultCache this is deliberately NOT watermark-validated:
    an empty selection usually stays empty (the metric does not exist), and
    the TTL bounds how long a newly-appearing series can be masked — the
    documented freshness trade of negative caching. Keys are
    ``(promql, tenant)`` only, so a sliding dashboard window keeps hitting —
    but emptiness is only PROVEN for the executed time range (leaf
    selection is time-bounded: an existing series queried over a pre-ingest
    range matches zero series THERE, not everywhere). Each entry therefore
    records its proven ``[start, end]``, and a hit requires the requested
    range to stay inside it, extended forward by the wall time elapsed
    since the proof — exactly the window the TTL trade already concedes to
    newly-appearing data, enough for a sliding dashboard to keep hitting,
    while a query over a DIFFERENT (e.g. live vs historical) range misses
    and re-executes. Capacity-bounded LRU with TTL expiry, both counted as
    evictions."""

    def __init__(self, capacity: int = 256, ttl_s: float = 30.0,
                 tags: dict | None = None):
        self.capacity = max(1, int(capacity))
        self.ttl_s = float(ttl_s)
        self.tags = dict(tags or {})
        # key -> (expiry, proven start ms, proven end ms, proof monotonic s)
        self._entries: OrderedDict[tuple, tuple] = OrderedDict()
        self._lock = threading.Lock()
        self._hits = registry.counter(FILODB_QUERY_NEGATIVE_CACHE_HITS,
                                      self.tags)
        self._evictions = registry.counter(
            FILODB_QUERY_NEGATIVE_CACHE_EVICTIONS, self.tags)

    def hit(self, key: tuple, range_key: tuple,
            now: float | None = None) -> bool:
        """True when a recent execution proved this query empty over a
        range covering the requested ``(start, end, step)`` (see class
        docstring for the forward-extension rule; expired entries evict
        here). A non-covering range is a miss but keeps the entry — the
        proof still stands for ITS range."""
        now = time.monotonic() if now is None else now
        start, end, step = range_key
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                return False
            exp, p_start, p_end, t_proof = ent
            if now >= exp:
                del self._entries[key]
                self._evictions.increment()
                return False
            # the proven-empty range, slid forward by elapsed wall time
            # (+ one step of grid slack): the only unproven data a hit can
            # mask is data newer than the proof — the documented TTL trade
            if start < p_start \
                    or end > p_end + (now - t_proof) * 1000.0 + step:
                return False
            self._entries.move_to_end(key)
            self._hits.increment()
            return True

    def put(self, key: tuple, range_key: tuple,
            now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        start, end, _step = range_key
        with self._lock:
            self._entries[key] = (now + self.ttl_s, start, end, now)
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self._evictions.increment()

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {"size": len(self._entries), "capacity": self.capacity,
                    "ttl_s": self.ttl_s, "hits": self._hits.value,
                    "evictions": self._evictions.value}


class SlowQueryLog:
    """Bounded ring of slow-query records: promql text, duration, plan
    summary (the engine's exec path), per-query stats, and the trace id —
    the pivot from "this dashboard is slow" to the exact trace in the
    tracer's ring. One process-global ring, like the tracer and the metrics
    registry."""

    def __init__(self, capacity: int = 128):
        self._ring: deque[dict] = deque(maxlen=capacity)
        self._lock = threading.Lock()

    def record(self, entry: dict) -> None:
        with self._lock:
            self._ring.append(entry)

    def entries(self, limit: int | None = None) -> list[dict]:
        """Newest first."""
        with self._lock:
            out = list(self._ring)
        out.reverse()
        return out[:limit] if limit else out

    def resize(self, capacity: int) -> None:
        with self._lock:
            self._ring = deque(self._ring, maxlen=max(1, int(capacity)))

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


slow_query_log = SlowQueryLog()


class QueryEngine:
    def __init__(self, memstore: TimeSeriesMemStore, dataset: str,
                 shard_mapper: ShardMapper | None = None,
                 config: QueryConfig | None = None, device=None,
                 mesh=None, cluster=None, node: str | None = None,
                 endpoint_resolver=None, route_dataset: str | None = None):
        """``device`` is where this engine's shards live and its kernels
        run: ``"cuda"`` by default; raises when there is no card and the
        CPU was not asked for. A shard on another device fails its query.
        ``mesh`` (a list of devices, ``distributed.make_mesh``) routes the
        aggregates the mesh can run across all shards at once, shard ``i``
        on ``mesh[i % len(mesh)]``; anything else takes the host path.

        ``cluster``/``node``: the ShardManager's shard -> node view and
        this node's name; leaves for peer-owned shards dispatch remotely
        (ref: PlanDispatcher.scala). ``endpoint_resolver(node) ->
        "host:port" | None`` maps a node to its HTTP endpoint; None falls
        back to the node name itself. ``route_dataset`` names the dataset
        whose assignment routes this one (a downsample family's engine
        routes by its raw dataset)."""
        self.memstore = memstore
        self.dataset = dataset
        self.device = resolve_device(device)
        self.mesh = (distributed.make_mesh(mesh) if mesh is not None
                     else None)
        num_shards = max(len(memstore.shards_of(dataset)), 1)
        pow2 = 1
        while pow2 < num_shards:
            pow2 *= 2
        self.mapper = shard_mapper or ShardMapper(pow2)
        self.config = config if config is not None else QueryConfig()
        self.cluster = cluster
        self.node = node
        self.endpoint_resolver = endpoint_resolver
        self.route_dataset = route_dataset or dataset
        # a failed peer epoch probe arms this cooldown: until it passes the
        # epoch state is unreadable without a scatter (every cache misses),
        # so a blackholed peer stalls at most one query a window
        self._epoch_probe_cooldown_s = 10.0
        self._epoch_probe_down_until = 0.0
        # serving fast path (each off unless configured): the step-aligned
        # result cache, cost-based admission, the negative cache of empty
        # selections, the per-step fragment cache
        cfg = self.config
        tags = {"dataset": dataset}
        self.result_cache = (QueryResultCache(cfg.result_cache_size,
                                              tags=tags)
                             if cfg.result_cache_size else None)
        self.admission = (AdmissionController(
            cfg.max_concurrent_cost, cfg.tenant_quotas,
            cfg.shed_retry_after_s, tags=tags)
            if (cfg.max_concurrent_cost is not None or cfg.tenant_quotas)
            else None)
        self.negative_cache = (NegativeResultCache(
            cfg.negative_cache_size, cfg.negative_cache_ttl_s, tags=tags)
            if cfg.negative_cache_size else None)
        self.fragment_cache = (FragmentCache(
            cfg.fragment_cache_size, cfg.fragment_cache_bytes,
            cfg.fragment_max_steps, tags=tags)
            if cfg.fragment_cache_size else None)
        # downsample-aware routing (query/retention.py RetentionRouter),
        # installed on the RAW engine; family serving engines never carry
        # one (no re-routing)
        self.retention = None
        schema = memstore._dataset_schema.get(dataset)
        opts = schema.options if schema else None
        route = self._route_endpoint if cluster is not None else None
        kw = dict(route_fn=route, dataset=dataset)
        self.planner = (QueryPlanner(self.mapper, opts, **kw) if opts
                        else QueryPlanner(self.mapper, **kw))

    def _route_endpoint(self, shard: int) -> str | None:
        """HTTP endpoint of the peer owning ``shard``, or None when this
        node serves it (ref: queryengine2/QueryEngine.scala:506: co-locate
        each leaf with its shard's node)."""
        if self.cluster is None or self.node is None:
            return None
        try:
            owner = self.cluster.node_of(self.route_dataset, shard)
        except KeyError:
            return None
        if owner is None or owner == self.node:
            return None
        if self.endpoint_resolver is not None:
            ep = self.endpoint_resolver(owner)
            if ep:
                return ep
        return owner

    def _ctx(self) -> QueryContext:
        return QueryContext(self.memstore, self.dataset, self.device,
                            sample_limit=self.config.sample_limit,
                            stale_ms=self.config.stale_sample_after_ms)

    def query_range(self, promql_text: str, start_ms: int, end_ms: int,
                    step_ms: int, tenant: str | None = None,
                    resolution: str | None = None,
                    _skip_routing: bool = False,
                    min_window_ms: int | None = None) -> QueryResult:
        """``tenant`` keys the caches and the admission quota.
        ``resolution`` overrides the retention router's decision for the
        whole range; it requires a router (unknown values fail with the
        configured list). ``_skip_routing`` is the router's own raw-tail
        leg. ``min_window_ms`` (the serving family's resolution) widens
        windowed functions narrower than it, which would otherwise return
        empty or wrong data on downsampled buckets."""
        if self.retention is not None and not _skip_routing:
            routed = self.retention.route_range(
                self, promql_text, int(start_ms), int(end_ms), int(step_ms),
                tenant, resolution)
            if routed is not None:
                return routed
        elif resolution is not None and not _skip_routing:
            raise QueryError(
                "resolution override requires retention routing "
                "(retention.routing + downsample.enabled); none configured")
        res = self._query_traced(
            promql_text,
            lambda: promql.query_to_logical_plan(promql_text, start_ms,
                                                 end_ms, step_ms),
            range_key=(int(start_ms), int(end_ms), int(step_ms)),
            tenant=tenant, min_window_ms=min_window_ms)
        if self.retention is not None and res.stats is not None \
                and res.stats.resolution is None:
            res.stats.resolution = "raw"   # routing ran and chose raw
        return res

    def query_instant(self, promql_text: str, time_ms: int,
                      tenant: str | None = None,
                      resolution: str | None = None,
                      min_window_ms: int | None = None) -> QueryResult:
        """Instant queries bypass the caches (they key on a range) and
        route only when ``resolution`` names a tier."""
        if self.retention is not None:
            routed = self.retention.route_instant(self, promql_text,
                                                  int(time_ms), tenant,
                                                  resolution)
            if routed is not None:
                routed.result_type = "vector"
                return routed
        elif resolution is not None:
            raise QueryError(
                "resolution override requires retention routing "
                "(retention.routing + downsample.enabled); none configured")
        res = self._query_traced(
            promql_text,
            lambda: promql.query_to_logical_plan(promql_text, time_ms,
                                                 time_ms, 1),
            tenant=tenant, min_window_ms=min_window_ms)
        res.result_type = "vector"
        return res

    def _query_traced(self, promql_text: str, to_plan,
                      range_key: tuple | None = None,
                      tenant: str | None = None,
                      min_window_ms: int | None = None) -> QueryResult:
        """One root span per query, the end-to-end latency histogram and
        the slow-query ring, recorded in a finally (a query that raises
        still counts).

        The serving fast path, in the reference's order: the negative cache
        first (no epoch read, no parse); then the epoch state; the result
        cache; the fragment cache, which serves a shifted range from its
        valid per-step columns and executes only the missing steps; then
        admitted execution, which stores into every cache against the
        epoch vector read BEFORE it ran, so a concurrent flush invalidates
        the entry instead of racing it. ``min_window_ms`` rides every cache
        key: a routed family query's widened plan and a direct query of the
        same text share text, not semantics."""
        ctx = self._ctx()
        t0 = time.perf_counter_ns()
        tctx = None
        err: BaseException | None = None
        try:
            with span(SPAN_QUERY, dataset=self.dataset,
                      promql=promql_text[:200]):
                tctx = tracer.current_context()
                neg_key = None
                if range_key is not None and self.negative_cache is not None:
                    neg_key = (promql_text, tenant)
                    if self.negative_cache.hit(neg_key, range_key):
                        return self._negative_hit(range_key, ctx)
                cache_key = epochs = elogs = frag_key = None
                frag = (self.fragment_cache if range_key is not None
                        else None)
                if range_key is not None and (self.result_cache is not None
                                              or frag is not None):
                    epochs, elogs = self._epoch_state(
                        with_logs=frag is not None)
                if range_key is not None and self.result_cache is not None:
                    cache_key = (promql_text, *range_key, tenant,
                                 min_window_ms)
                    hit = self._result_cache_probe(cache_key, epochs, ctx)
                    if hit is not None:
                        return hit
                if frag is not None and epochs is not None:
                    frag_key = (promql_text, range_key[2], tenant,
                                min_window_ms)
                    served = self._fragment_serve(
                        frag_key, promql_text, range_key, tenant,
                        min_window_ms, epochs, elogs, ctx)
                    if served is not None:
                        if cache_key is not None:
                            self.result_cache.put(
                                cache_key,
                                (served.matrix, served.result_type,
                                 list(served.warnings), ctx.stats.to_dict(),
                                 ctx.exec_path), epochs)
                        return served
                with span(SPAN_QUERY_PARSE), ctx.stats.stage("parse"):
                    plan = to_plan()
                plan, widen_warn = self._widen_plan(plan, min_window_ms, ctx)
                res = self._exec_admitted(plan, ctx, tenant)
                if widen_warn is not None and widen_warn not in res.warnings:
                    res.warnings.append(widen_warn)
                if cache_key is not None:
                    self.result_cache.put(
                        cache_key,
                        (res.matrix, res.result_type, list(res.warnings),
                         ctx.stats.to_dict(), ctx.exec_path), epochs)
                if frag_key is not None:
                    self._fragment_store(frag_key, plan, res, range_key,
                                         epochs)
                if (neg_key is not None and ctx.stats.series_matched == 0
                        and res.matrix.num_series == 0
                        and ctx.stats.recovering_shards == 0
                        and not self._any_recovering()):
                    # the selection was provably empty: the next refresh
                    # skips the pipeline until the TTL admits new series.
                    # An empty seen while a shard recovers proves nothing
                    self.negative_cache.put(neg_key, range_key)
                return res
        except BaseException as e:
            err = e                     # noted below, then re-raised
            raise
        finally:
            self._note_query_done(promql_text, ctx,
                                  (time.perf_counter_ns() - t0) / 1e6,
                                  tctx, err)

    def _negative_hit(self, range_key: tuple,
                      ctx: QueryContext) -> QueryResult:
        """The synthesized empty result of a negative-cache hit: this
        request's step grid, zero series."""
        start, end, step = range_key
        out_ts = np.arange(start, end + 1, max(step, 1), dtype=np.int64)
        ctx.stats.add("negative_cache_hits")
        ctx.exec_path = "negative-cache"
        res = QueryResult(ResultMatrix(out_ts, np.zeros((0, len(out_ts))),
                                       []))
        res.stats = ctx.stats
        res.exec_path = ctx.exec_path
        return res

    def _result_cache_probe(self, cache_key: tuple, epochs,
                            ctx: QueryContext) -> QueryResult | None:
        """A validated cache entry as a fresh QueryResult, else None. The
        response carries the original execution's stats plus a
        result_cache_hits marker."""
        payload = self.result_cache.get(cache_key, epochs)
        if payload is None:
            return None
        matrix, result_type, warnings, stats_dict, exec_path = payload
        ctx.stats.merge(stats_dict)
        ctx.stats.add("result_cache_hits")
        ctx.exec_path = f"result-cache[{exec_path}]"
        res = QueryResult(matrix, result_type, list(warnings))
        res.stats = ctx.stats
        res.exec_path = ctx.exec_path
        return res

    def _widen_plan(self, plan: L.LogicalPlan, min_window_ms: int | None,
                    ctx: QueryContext):
        """Widen windowed functions narrower than the serving resolution
        (retention-routed family queries: ``min_window_ms`` is the family's
        resolution): a window that cannot cover one downsample bucket
        returns empty or wrong data. Returns ``(plan, warning | None)``;
        the count lands in QueryStats and the per-dataset metric."""
        if not min_window_ms:
            return plan, None
        plan, n = widen_windows(plan, int(min_window_ms))
        if not n:
            return plan, None
        label = resolution_label(int(min_window_ms))
        ctx.stats.add("windows_widened", n)
        registry.counter(FILODB_QUERY_WINDOWS_WIDENED,
                         {"dataset": self.dataset,
                          "resolution": label}).increment(n)
        return plan, (f"{n} window(s) narrower than the {label} serving "
                      "resolution were widened to cover it")

    def _build_range_plan(self, promql_text: str, start_ms: int, end_ms: int,
                          step_ms: int, min_window_ms: int | None,
                          ctx: QueryContext):
        """Parse and widen one (sub-)range: the fragment path's delta legs
        build their plans as the full execution does."""
        with span(SPAN_QUERY_PARSE), ctx.stats.stage("parse"):
            plan = promql.query_to_logical_plan(promql_text, start_ms,
                                                end_ms, step_ms)
        return self._widen_plan(plan, min_window_ms, ctx)

    def _fragment_serve(self, frag_key: tuple, promql_text: str,
                        range_key: tuple, tenant: str | None,
                        min_window_ms: int | None, epochs, elogs,
                        ctx: QueryContext) -> QueryResult | None:
        """Incremental (delta) evaluation off the fragment cache: reuse the
        entry's provably valid per-step columns, execute only the missing
        head/tail sub-ranges (each through the normal exec route: on the
        card, K1 over just those steps), stitch, and store the merged
        fragment back against the pre-execution epoch vector. None => no
        usable fragment; the caller executes the full range."""
        start, end, step = range_key
        hit = self.fragment_cache.probe(frag_key, start, end, step,
                                        epochs, elogs)
        if hit is None:
            return None
        with span(SPAN_QUERY_FRAGMENT, dataset=self.dataset,
                  reused=hit.reused_steps) as tags:
            parts = [ResultMatrix(hit.keep_ts, hit.keep_vals, hit.keys)]
            warnings = list(hit.warnings)
            n_new = 0
            for lo, hi in hit.missing:
                plan, widen_warn = self._build_range_plan(
                    promql_text, lo, hi, step, min_window_ms, ctx)
                sub = self._exec_admitted(plan, ctx, tenant)
                if widen_warn is not None and widen_warn not in warnings:
                    warnings.append(widen_warn)
                for w in sub.warnings:
                    if w not in warnings:
                        warnings.append(w)
                m = sub.matrix.to_host()
                parts.append(ResultMatrix(
                    np.asarray(m.out_ts, np.int64),
                    np.asarray(m.values, np.float64), list(m.keys)))
                n_new += len(m.out_ts)
            tags["computed"] = n_new
            merged = stitch_matrices(parts) if len(parts) > 1 else parts[0]
            m_ts = np.asarray(merged.out_ts)
            mask = (m_ts >= start) & (m_ts <= end)
            served_m = ResultMatrix(m_ts[mask],
                                    np.asarray(merged.values)[:, mask],
                                    list(merged.keys))
            check_sample_limit(served_m.num_series, len(served_m.out_ts),
                               self.config.sample_limit)
            ctx.stats.add("fragment_steps_reused", hit.reused_steps)
            ctx.exec_path = (
                f"incremental[reused={hit.reused_steps},computed={n_new}]"
                if hit.missing else "fragment-cache[full]")
            self.fragment_cache.store(
                frag_key, merged.out_ts, np.asarray(merged.values),
                merged.keys, warnings, epochs, step,
                extended=bool(hit.missing) and hit.reused_steps > 0)
        res = QueryResult(served_m, "matrix", warnings)
        res.stats = ctx.stats
        res.exec_path = ctx.exec_path
        return res

    def _fragment_store(self, frag_key: tuple, plan: L.LogicalPlan,
                        res: QueryResult, range_key: tuple, epochs) -> None:
        """Seed the fragment cache from a full execution: only plans whose
        steps are provably time-local (``incremental.plan_cacheable``) and
        scalar columnar results (no histogram matrix). The columns go to
        the host as f64, as the reference stores them."""
        if res.result_type != "matrix" or res.matrix.bucket_les is not None:
            return
        if not plan_cacheable(plan):
            return
        host = res.matrix.to_host()
        vals = np.asarray(host.values)
        if vals.ndim != 2:
            return
        if vals.shape[0] > len(host.keys):
            vals = vals[:len(host.keys)]   # padded leaf rows carry no series
        elif vals.shape[0] < len(host.keys):
            return
        self.fragment_cache.store(frag_key,
                                  np.asarray(host.out_ts, np.int64),
                                  np.asarray(vals, np.float64),
                                  list(host.keys), res.warnings, epochs,
                                  range_key[2])

    def _exec_admitted(self, plan: L.LogicalPlan, ctx: QueryContext,
                       tenant: str | None) -> QueryResult:
        """Execute under the admission gate when one is configured: the
        decision (cost estimate + reserve) runs under its own span; a shed
        raises AdmissionRejected and lands in QueryStats and the slow-query
        ring before anything executes. A cost that could never fit the
        budget or the tenant's quota raises a plain QueryError."""
        if self.admission is None:
            return self.exec_logical(plan, ctx)
        with span(SPAN_QUERY_ADMIT, tenant=tenant or "") as tags:
            cost = self.estimate_cost(plan)
            tags["cost"] = round(cost, 1)
            try:
                got = self.admission.acquire(cost, tenant)
            except AdmissionRejected:
                tags["shed"] = True
                ctx.stats.add("admission_shed")
                raise
        try:
            return self.exec_logical(plan, ctx)
        finally:
            self.admission.release(got, tenant)

    def estimate_cost(self, plan: L.LogicalPlan) -> float:
        """Admission-control cost estimate: the planner walks the logical
        tree; this engine supplies the index probe (local series counts,
        scaled up by the owned-shard fraction when peers hold shards: the
        admission path pays no cluster round trip; a narrow-resident store
        discounts its rows). The probe reads host state only (index
        postings, the store's residency fields): no device sync under the
        shard lock."""
        def series_of(filters, from_ms, to_ms):
            total = narrow = 0
            shards = self.memstore.shards_of(self.dataset)
            for sh in shards:
                with sh.lock:
                    pids = sh.part_ids_from_filters(list(filters), from_ms,
                                                    to_ms)
                total += len(pids)
                if sh.store is not None and sh.store._val_compressed:
                    # compressed residency (scalar or hist) halves the
                    # streamed bytes, and the fused tier reads it in place
                    narrow += len(pids)
            if shards and self._has_remote_shards():
                scale = len(self.mapper.all_shards()) / len(shards)
                total, narrow = total * scale, narrow * scale
            return total, (narrow / total if total else 0.0)

        return self.planner.estimate_cost(
            plan, series_of, self.config.stale_sample_after_ms)

    def _any_recovering(self) -> bool:
        """True while any local shard is mid-recovery (partial data)."""
        return any(sh.recovering
                   for sh in self.memstore.shards_of(self.dataset))

    def _epoch_vector(self) -> tuple | None:
        """The cluster's data-epoch vector (see :meth:`_epoch_state`)."""
        return self._epoch_state()[0]

    def _epoch_state(self, with_logs: bool = False):
        """``(vector, logs)``: the vector is every shard's ``data_epoch``
        mutation counter, local shards read directly, peer-owned ones
        probed over ``/api/v1/epochs?local=1`` in one concurrent scatter;
        with ``with_logs`` each shard's recent (epoch, min affected ts)
        bump log rides along (``&log=1`` on the probe), the substrate of
        per-step fragment validity (``incremental.stable_before``).
        ``(None, None)`` when any peer fails to answer: every cache then
        misses and nothing is stored; the failure arms a cooldown during
        which the scatter is skipped."""
        vec = []
        logs: dict = {}
        for sh in self.memstore.shards_of(self.dataset):
            if with_logs:
                ep, lg = sh.epoch_state()
                logs[("local", str(sh.shard_num))] = lg
            else:
                ep = sh.data_epoch
            vec.append(("local", sh.shard_num, ep))
        if self._has_remote_shards():
            if time.monotonic() < self._epoch_probe_down_until:
                return None, None
            import urllib.request
            sfx = "&log=1" if with_logs else ""

            def fetch(ep: str) -> dict:
                url = (f"http://{ep}/promql/{self.dataset}/api/v1/epochs"
                       f"?local=1{sfx}")
                with urllib.request.urlopen(url, timeout=2.0) as r:
                    return json.load(r).get("data") or {}

            for ep, res in self.peer_scatter_join(
                    self.peer_scatter_begin(fetch)):
                if isinstance(res, Exception):
                    self._epoch_probe_down_until = (
                        time.monotonic() + self._epoch_probe_cooldown_s)
                    return None, None
                for k, v in sorted(res.items()):
                    if isinstance(v, (list, tuple)):
                        # log form: [epoch, [[epoch_i, min_ts_i], ...]]
                        vec.append((ep, str(k), int(v[0])))
                        logs[(ep, str(k))] = [(int(a), int(b))
                                              for a, b in v[1]]
                    else:
                        vec.append((ep, str(k), int(v)))
        return tuple(sorted(vec, key=str)), logs

    def _note_query_done(self, promql_text: str, ctx: QueryContext,
                         dur_ms: float, tctx: dict | None,
                         error: BaseException | None) -> None:
        trace_id = (tctx.get("trace_id")
                    if tctx and tctx.get("sampled") else None)
        registry.histogram(FILODB_QUERY_LATENCY_MS,
                           {"dataset": self.dataset}) \
            .record(dur_ms, trace_id=trace_id)
        thr = self.config.slow_log_threshold_ms
        shed = isinstance(error, AdmissionRejected)
        slow = thr is not None and dur_ms >= thr
        if slow and not shed:
            registry.counter(FILODB_QUERY_SLOW,
                             {"dataset": self.dataset}).increment()
        if slow or shed:
            # admission sheds enter the ring whatever their duration: the
            # operator diagnosing sheds needs their text, cost and tenant
            # beside the slow queries
            entry = {
                "promql": promql_text, "dataset": self.dataset,
                "duration_ms": round(dur_ms, 3),
                "plan": ctx.exec_path, "trace_id": trace_id,
                "stats": ctx.stats.to_dict(),
                # wall timestamp for display only; durations come from the
                # monotonic clock
                "ts": time.time(),
            }
            if shed:
                entry["shed"] = True
                entry["cost"] = round(error.cost, 1)
                if error.tenant is not None:
                    entry["tenant"] = error.tenant
            if error is not None:
                entry["error"] = f"{type(error).__name__}: {error}"
            slow_query_log.record(entry)

    def exec_logical(self, plan: L.LogicalPlan,
                     ctx: QueryContext | None = None) -> QueryResult:
        ctx = ctx if ctx is not None else self._ctx()
        with span(SPAN_QUERY_EXECUTE, dataset=self.dataset), \
                ctx.stats.stage("execute"):
            res = (self._try_mesh(plan, ctx) if self.mesh is not None
                   else None)
            if res is None:
                res = self._try_fused_hist(plan, ctx)
            if res is None:
                res = self._exec_planned(plan, ctx)
        m = res.matrix
        ctx.stats.add("result_cells", m.num_series * len(m.out_ts))
        res.stats = ctx.stats
        res.exec_path = ctx.exec_path
        return res

    def _exec_planned(self, plan: L.LogicalPlan,
                      ctx: QueryContext) -> QueryResult:
        """The general path: materialize and run the ExecPlan tree. A peer
        that dies mid-query raises RemotePeerError; the plan is
        re-materialized (the ShardManager may have reassigned its shards
        to a survivor) and retried once, but only if every failed shard
        now routes elsewhere: re-sending to the same dead endpoint would
        only double the timeout."""
        ctx.exec_path = "local"
        with span(SPAN_QUERY_PLAN), ctx.stats.stage("plan"):
            exec_plan = self.planner.materialize(plan)
        try:
            return exec_plan.run(ctx)
        except RemotePeerError as e:
            if self.cluster is None:
                raise
            failed = set(e.shards)
            retry = self.planner.materialize(plan)
            for node in _walk_plans(retry):
                if (isinstance(node, RemoteLeafExec)
                        and node.endpoint == e.endpoint
                        and failed & set(_plan_shards(node.inner))):
                    raise
            ctx.exec_path = "local-replanned"
            # the retry re-executes every leg, the successful ones whose
            # peer stats already merged included: start the counts over
            ctx.stats.reset_counters()
            try:
                return retry.run(ctx)
            except QueryError as e2:
                raise QueryError(
                    f"retry after peer failure also failed: {e2} "
                    f"(first failure: {e})") from e2

    def _try_fused_hist(self, plan: L.LogicalPlan,
                        ctx: QueryContext) -> QueryResult | None:
        """histogram_quantile(q, sum by(...) (fn(h[w]))) on a single
        grid-aligned histogram shard, as one call (ref:
        HistogramQueryBenchmark.scala is the latency bar): per-bucket range
        function, bucket-wise group sums and the f64 quantile. A raw-f32
        store takes ``gridfns.fused_hist_quantile_grid`` ("fused-hist"); a
        hist-resident one streams its 2D-delta block — through K2 for the
        rate family inside the shape gate ("fused-hist-narrow[cuda]" on the
        card, "[plain]" through the twin on the CPU), else through
        ``gridfns.fused_hist_quantile_grid_narrow``. Everything off that
        pattern returns None and takes the general ExecPlan path, exactly
        where the reference's route does: another aggregation or a
        parametrized one, an inner that is not a windowed range function
        over raw series, ``__col__`` columns, several shards, an off-grid
        store, churned or empty selections. The leaf's stats commit only
        when this route answers (the probe re-runs on the general path)."""
        if not (isinstance(plan, L.ApplyInstantFunction)
                and plan.function == "histogram_quantile"
                and isinstance(plan.vectors, L.Aggregate)):
            return None
        if fusedresident.mode() == "off":
            # query.fused_kernels=off: the composed ExecPlan chain (range
            # function -> bucket-wise reduce -> quantile) is the configured
            # path, the fused tier's A/B baseline
            return None
        agg = plan.vectors
        if agg.operator != "sum" or agg.params:
            return None
        inner = agg.vectors
        if not isinstance(inner, L.PeriodicSeriesWithWindowing):
            return None
        fn, raw = inner.function, inner.series
        if fn not in gridfns.HIST_GRID_FNS or raw.columns:
            return None
        shards = self.memstore.shards_of(self.dataset)
        if len(shards) != 1 or self._has_remote_shards():
            return None
        sh = shards[0]
        if sh.store is None or sh.bucket_les is None:
            return None
        if sh.store.grid_info() is None:
            return None              # off-grid store: general path outright
        out_ts = np.arange(inner.start_ms, inner.end_ms + 1,
                           max(inner.step_ms, 1), dtype=np.int64)
        if len(out_ts) == 0:
            return None
        q = float(plan.function_args[0])
        leaf = SelectRawPartitionsExec(
            shard=sh.shard_num, filters=tuple(raw.filters),
            start_ms=raw.range_selector.from_ms,
            end_ms=raw.range_selector.to_ms)
        pctx = dataclasses.replace(ctx, stats=QueryStats())
        # the leaf as the general path records it: the lock's wait, the
        # selection, the launches that read the store and the hold
        with span(SPAN_QUERY_LEAF, shard=sh.shard_num) as leaf_tags, \
                sh.lock, timed_hold(leaf_tags):
            got = self._fused_hist_locked(q, agg, inner, fn, leaf, out_ts,
                                          pctx, ctx)
        if got is None:
            return None              # cold, empty or churned: general path
        out, path, G, T, uniq = got
        ctx.exec_path = path
        ctx.stats.merge(pctx.stats)
        # the blocking host copy runs outside the shard lock
        with span(SPAN_QUERY_FETCH, site="fused_hist"):
            host = out[:G, :T].cpu().numpy()
        m = ResultMatrix(out_ts, host, list(uniq))
        check_sample_limit(m.num_series, T, ctx.sample_limit)
        return QueryResult(m)

    def _fused_hist_locked(self, q, agg, inner, fn, leaf, out_ts, pctx, ctx):
        """The fused-hist route's selection and launches, under the shard
        lock: (out [G', T'] on the device, exec path, G, T, group keys), or
        None for a cold, empty or churned selection."""
        data = leaf.select(pctx)
        window = inner.window_ms
        if (data.grid is None or data.bucket_les is None
                or (data.grid_minority is not None
                    and len(data.grid_minority))
                or max(abs(int(out_ts[0]) - data.grid[0]),
                       abs(int(out_ts[-1]) - data.grid[0]))
                + window >= 2**31):
            return None
        out_eval, T = _pad_steps(out_ts)
        R = data.n.shape[0]
        gids, uniq, G = _group_ids_for(data.keys, data.rows, R,
                                       agg.by, agg.without)
        base_ts, interval_ms = data.grid
        les = np.asarray(data.bucket_les, np.float64)
        dev = data.n.device
        path = "fused-hist"
        if data.hist_narrow is not None:
            out, path = self._hist_narrow(q, les, data, gids, G, fn,
                                          out_eval, window, base_ts,
                                          interval_ms, ctx)
        else:
            out = gridfns.fused_hist_quantile_grid(
                q, les, data.val, data.n, torch.from_numpy(gids).to(dev),
                _pow2(G), out_eval, window, fn, base_ts, interval_ms,
                stale_ms=ctx.stale_ms)
        return out, path, G, T, uniq

    @staticmethod
    def _hist_narrow(q, les, data, gids, G, fn, out_eval, window, base_ts,
                     interval_ms, ctx):
        """The hist-resident leg of the fused-hist route: the 2D-delta
        block streams through K2 (or the narrow grid kernel outside K2's
        gate); cohort-pool rows are excluded there and folded back in as
        group partials from a row-wise decode. Returns ([G', T'] f64, the
        exec path)."""
        dd, first_d, bad = data.hist_narrow
        Gp = _pow2(G)
        gids, corr = pool_correction(data, gids, bad, Gp, fn, out_eval,
                                     window)
        gids_t = torch.from_numpy(gids).to(data.n.device)
        S, C, B = dd.shape
        if (fn in fusedresident.HIST_FUSED_FNS
                and fusedresident.hist_fusable(S, C, len(out_eval), B,
                                               max(Gp, 8))):
            backend = fusedresident.backend_of(dd)
            out = fusedresident.fused_hist_quantile_resident(
                q, les, dd, first_d, data.n, gids_t, Gp, out_eval, window,
                fn, base_ts, interval_ms, corr=corr)
            ctx.stats.add("fused_kernels")
            fusedresident.count_served("hist_quantile", backend)
            return out, f"fused-hist-narrow[{backend}]"
        fusedresident.count_fallback("hist_quantile")
        out = gridfns.fused_hist_quantile_grid_narrow(
            q, les, dd, first_d, data.n, gids_t, Gp, out_eval, window, fn,
            base_ts, interval_ms, stale_ms=ctx.stale_ms, corr=corr)
        return out, "fused-hist"

    # -- mesh dispatch (ref: queryengine2/QueryEngine.scala:59-67 — the
    # planner routes every query through per-shard dispatchers; here the
    # per-shard dispatch is K1's launch per shard and the reduce the host
    # fold in shard order) ---------------------------------------------------

    def _mesh_executor(self, shards):
        """A MeshQueryExecutor when every shard's store lives on its
        round-robin mesh device (shard i on ``mesh[i % ndev]``; shards per
        device >= 1) with one common [S, C] scalar layout, else None (host
        path). Narrow-resident stores qualify: the fused route streams their
        narrow blocks, the others decode a transient. Call under the shard
        locks: a flush's compress_commit between this check and the launch
        would otherwise swap ``val`` out from under the capture."""
        ndev = len(self.mesh)
        if len(shards) < ndev or len(shards) % ndev:
            return None
        s0 = shards[0].store
        if s0 is None:
            return None
        for i, sh in enumerate(shards):
            st = sh.store
            if (st is None or sh.bucket_les is not None
                    or st.nbuckets or st.layout is not None
                    or (st.val is not None and st.val.dim() != 2)
                    or (st.val is None and st._narrow is None)
                    or (st.S, st.C) != (s0.S, s0.C)
                    # n is resident under every residency state
                    or st.n.device != self.mesh[i % ndev]):
                return None
        return distributed.MeshQueryExecutor(
            distributed.DistributedStore(self.mesh, shards))

    def _try_mesh(self, plan: L.LogicalPlan,
                  ctx: QueryContext) -> QueryResult | None:
        """Execute ``op(fn(selector[w]))`` on the mesh when the plan shape,
        the operator and the stores allow; None => the caller takes the host
        path. Basic aggregates fold partials, topk/bottomk gather candidate
        blocks, quantile sums sketch counts (ref:
        AggrOverRangeVectors.scala:244 — every aggregation's map phase runs
        at the data)."""
        if not isinstance(plan, L.Aggregate):
            return None
        op = plan.operator
        if op in MESH_OPS:
            if plan.params:
                return None
        elif op in MESH_ORDER_OPS:
            if len(plan.params) != 1:
                return None
        else:
            return None
        inner = plan.vectors
        if isinstance(inner, L.PeriodicSeriesWithWindowing):
            raw, fn, window = inner.series, inner.function, inner.window_ms
            args = tuple(float(a) for a in (inner.function_args or ()))
        elif isinstance(inner, L.PeriodicSeries):
            raw, fn = inner.raw_series, "last_sample"
            window = self.config.stale_sample_after_ms
            args = (float(window),)
        else:
            return None
        if raw.columns or fn is None:
            return None
        shards = self.memstore.shards_of(self.dataset)
        if len(shards) < 2 or len(shards) % len(self.mesh):
            return None          # cheap pre-checks before taking any locks
        step = max(inner.step_ms, 1)
        out_ts = np.arange(inner.start_ms, inner.end_ms + 1, step,
                           dtype=np.int64)
        if len(out_ts) == 0:
            return None
        filters = list(raw.filters)
        from_ms = raw.range_selector.from_ms
        to_ms = raw.range_selector.to_ms
        uniq: dict[RangeVectorKey, int] = {}
        gids_list: list[np.ndarray] = []
        stale_ms = self.config.stale_sample_after_ms
        # every shard lock held across eligibility, group ids AND the
        # launches: a concurrent flush mutates the store tensors in place
        # (or swaps the raw block for its compressed form) otherwise
        with contextlib.ExitStack() as stack:
            for sh in shards:
                stack.enter_context(sh.lock)
            ex = self._mesh_executor(shards)
            if ex is None:
                return None      # residency or shape changed: host path
            matched_total = 0    # committed to ctx.stats only when the mesh
            for sh in shards:    # serves (the host path counts its own)
                pids = sh.part_ids_from_filters(filters, from_ms, to_ms)
                if sh.needs_paging(pids, from_ms):
                    # cold data: the host path's on-demand paging serves it
                    distributed.count_mesh_fallback("paging")
                    return None
                matched_total += len(pids)
                g = np.full(sh.store.S, _EXCLUDED_GID, np.int32)
                if len(pids):
                    if not plan.by and not plan.without:
                        g[pids] = 0
                        uniq.setdefault(RangeVectorKey(()), 0)
                    else:
                        keys = [sh.rv_key_of(int(p)) for p in pids]
                        for p, gk in zip(pids, group_keys_of(keys, plan.by,
                                                             plan.without)):
                            g[p] = uniq.setdefault(gk, len(uniq))
                gids_list.append(g)
            if not uniq:
                ctx.exec_path = "mesh-empty"
                return QueryResult(ResultMatrix(
                    out_ts, np.zeros((0, len(out_ts))), []))
            G = len(uniq)
            a0 = args[0] if len(args) > 0 else 0.0
            a1 = args[1] if len(args) > 1 else 0.0
            # a partition release re-assigns rows: capture the release
            # epochs before any launch, validated when topk maps its
            # (shard, row) winners back to keys after the fetch
            epochs = [sh._release_epoch for sh in shards]
            # launch under the locks; the blocking host copy happens after
            # they release, so a slow pass never stalls ingest on every shard
            if op == "quantile":
                # the host order-stat map's gates: group cap and the dense
                # sketch's memory cap
                if (G > AggregateMapReduce.ORDER_STAT_MAX_GROUPS
                        or _pow2(G) * aggregators.SKETCH_WIDTH
                        * (len(out_ts) + 31) * 4 > _SKETCH_BYTES_CAP):
                    distributed.count_mesh_fallback("order_stat_caps")
                    return None
                lazy = ex.quantile(fn, out_ts, window, gids_list, G,
                                   float(plan.params[0]), args=(a0, a1),
                                   stale_ms=stale_ms)
            elif op in ("topk", "bottomk"):
                k = max(int(plan.params[0]), 0)
                if k == 0 or G > MESH_TOPK_MAX_GROUPS:
                    distributed.count_mesh_fallback("topk_caps")
                    return None
                lazy = ex.topk(fn, out_ts, window, gids_list, G, k,
                               op == "bottomk", args=(a0, a1),
                               stale_ms=stale_ms)
            else:
                lazy = ex.aggregate(fn, op, out_ts, window, gids_list, G,
                                    args=(a0, a1), fetch=False,
                                    stale_ms=stale_ms)
            # committed: the mesh serves this query
            ctx.stats.add("series_matched", matched_total)
            if ex.last_path.startswith("fused"):
                # one fused execution per query, as the host route counts
                ctx.stats.add("fused_kernels")
        # the reference tags pjit programs "mesh[pjit]-"; the port runs
        # eagerly and always gives the bare form
        ctx.exec_path = f"mesh-{ex.last_path}"
        distributed.count_mesh_served(ex.last_path, ex.last_mode)
        if op in ("topk", "bottomk"):
            m = self._present_mesh_topk(lazy, shards, epochs, out_ts,
                                        list(uniq))
        else:
            m = ResultMatrix(out_ts, lazy.resolve(), list(uniq))
        check_sample_limit(m.num_series, len(out_ts), self.config.sample_limit)
        return QueryResult(m)

    @staticmethod
    def _present_mesh_topk(lazy, shards, epochs, out_ts,
                           group_keys) -> ResultMatrix:
        """Map the mesh topk's (shard, row) winners back to series keys and
        present them as the host path does (the union of selected series,
        each valued at the steps where it made the cut). Key resolution
        re-takes each winner shard's lock and checks its release epoch: a
        purge or eviction since the launch may have given the row to
        another series."""
        vals, shard_ids, rows, ok = lazy.resolve()
        G, k, T = vals.shape
        flat_ok = ok.ravel()
        pairs = ((shard_ids.ravel()[flat_ok].astype(np.int64) << 32)
                 | rows.ravel()[flat_ok].astype(np.int64))
        upairs = np.unique(pairs)
        key_table = []
        pair_slot = {}
        for pr in upairs.tolist():
            si, row = pr >> 32, pr & 0xFFFFFFFF
            sh = shards[si]
            with sh.lock:
                if sh._release_epoch != epochs[si]:
                    raise QueryError(
                        "selection invalidated by concurrent partition "
                        "release (eviction/purge); retry the query")
                key_table.append(sh.rv_key_of(int(row)))
            pair_slot[pr] = len(key_table) - 1
        key_ref = np.full(G * k * T, -1, np.int64)
        if len(upairs):
            idx = np.nonzero(flat_ok)[0]
            key_ref[idx] = [pair_slot[int(p)] for p in pairs.tolist()]
        return _present_topk(TopKPartial(
            k, False, out_ts, group_keys, vals,
            key_ref.reshape(G, k, T), key_table))

    # -- cross-node helpers ---------------------------------------------------

    def _has_remote_shards(self) -> bool:
        if self.cluster is None or self.node is None:
            return False
        return any(self._route_endpoint(s) is not None
                   for s in self.mapper.all_shards())

    def _peer_endpoints(self) -> list[str]:
        """Distinct HTTP endpoints of peers owning shards of this dataset."""
        eps: dict[str, None] = {}
        for s in self.mapper.all_shards():
            ep = self._route_endpoint(s)
            if ep is not None:
                eps.setdefault(ep)
        return list(eps)

    def peer_scatter_begin(self, fetch):
        """Start ``fetch(ep)`` for every peer endpoint concurrently; returns
        an opaque handle for :meth:`peer_scatter_join` (None when no peers).
        Begin/join are split so callers can overlap their LOCAL work with the
        peer round-trips (the shared scatter scaffold for metadata and
        remote-read fan-outs)."""
        from concurrent.futures import ThreadPoolExecutor
        eps = self._peer_endpoints()
        if not eps:
            return None
        # scatter legs run on pool threads: adopt the caller's trace context
        # so their spans (and anything the peer records) join its trace
        run = tracer.wrap(fetch)
        pool = ThreadPoolExecutor(max_workers=min(len(eps), 16))
        futs = [(ep, pool.submit(run, ep)) for ep in eps]
        return (pool, futs)

    @staticmethod
    def peer_scatter_join(handle) -> list:
        """[(endpoint, result-or-Exception)] for a begun scatter."""
        if handle is None:
            return []
        pool, futs = handle
        out = []
        for ep, f in futs:
            try:
                out.append((ep, f.result()))
            except Exception as e:  # noqa: BLE001 — caller decides severity
                out.append((ep, e))
        pool.shutdown(wait=False)
        return out

    def _peer_metadata(self, path: str) -> list:
        """Fan a metadata request out to all peers concurrently (local=1
        stops recursion); an unreachable peer is skipped — its shards are
        mid-reassignment and metadata is best-effort (ref: the coordinator's
        metadata scatter). Raw DATA reads are NOT best-effort — they use the
        same scatter but raise on peer failure (promql/remote.py)."""
        import urllib.request

        def fetch(ep: str) -> list:
            sep = "&" if "?" in path else "?"
            url = f"http://{ep}/promql/{self.dataset}{path}{sep}local=1"
            with urllib.request.urlopen(url, timeout=10.0) as r:
                return json.load(r).get("data") or []

        out: list = []
        for ep, res in self.peer_scatter_join(self.peer_scatter_begin(fetch)):
            if isinstance(res, Exception):
                logging.getLogger("filodb_tpu_torch.query").warning(
                    "metadata fan-out to peer %s failed; partial result", ep)
            else:
                out.extend(res)
        return out

    # -- metadata queries (ref: QueryActor label-values / series paths) -------

    @staticmethod
    def _match_suffix(filters) -> str:
        if not filters:
            return ""
        from urllib.parse import quote
        return "?match[]=" + quote(_filters_to_selector(filters))

    def label_value_counts(self, label: str, filters=None, top_k=None,
                           local_only: bool = False):
        """value -> series count across local shards and (unless local_only)
        peers — the substrate for cluster-wide top-k ranking. The peer leg
        forwards ``top_k`` (each node prunes to its local top-k candidates)
        and asks for counted pairs (``counts=1``), so the merge re-ranks by
        SUMMED count instead of trusting any one node's ordering."""
        counts: Counter = Counter()
        # local shards contribute FULL counts — pruning per shard here would
        # reintroduce the dominance bug this method fixes cross-node (a value
        # ranked k+1 in every shard can be #1 by summed count); only the
        # remote leg prunes, per NODE, where exact merge is not free
        for shard in self.memstore.shards_of(self.dataset):
            for v, c in shard.label_value_counts(label, filters):
                counts[v] += c
        if not local_only:
            sfx = self._match_suffix(filters)
            sep = "&" if sfx else "?"
            path = f"/api/v1/label/{label}/values{sfx}{sep}counts=1"
            if top_k is not None:
                path += f"&top_k={int(top_k)}"
            for row in self._peer_metadata(path):
                if isinstance(row, (list, tuple)) and len(row) == 2:
                    counts[str(row[0])] += int(row[1])
                elif isinstance(row, str):   # uncounted peer: presence only
                    counts[row] += 1
        return counts

    def label_values(self, label: str, filters=None, top_k=None,
                     local_only: bool = False) -> list[str]:
        if top_k is not None:
            # the k limit re-applies AFTER the cross-node merge: per-node
            # top-k lists are candidates, the summed counts decide
            counts = self.label_value_counts(label, filters, top_k=top_k,
                                             local_only=local_only)
            return [v for v, _ in counts.most_common(top_k)]
        vals: dict[str, None] = {}
        for shard in self.memstore.shards_of(self.dataset):
            for v in shard.label_values(label, filters):
                vals[v] = None
        if not local_only:
            for v in self._peer_metadata(
                    f"/api/v1/label/{label}/values"
                    + self._match_suffix(filters)):
                vals[v] = None
        return sorted(vals)

    def label_names(self, filters=None, local_only: bool = False) -> list[str]:
        names: set[str] = set()
        for shard in self.memstore.shards_of(self.dataset):
            names.update(shard.label_names(filters))
        if not local_only:
            # peers answer on the Prometheus surface (__name__); fold back
            # to the internal metric label so the merge stays canonical
            names.update("_metric_" if n == "__name__" else n
                         for n in self._peer_metadata(
                             "/api/v1/labels" + self._match_suffix(filters)))
        return sorted(names)

    def series(self, filters, start_ms: int, end_ms: int,
               local_only: bool = False) -> list[dict[str, str]]:
        out = []
        for shard in self.memstore.shards_of(self.dataset):
            # ids and labels under one lock: a concurrent purge reuses slots
            with shard.lock:
                pids = shard.part_ids_from_filters(list(filters), start_ms, end_ms)
                out.extend(shard.index.labels_of(int(p)) for p in pids)
        if not local_only and self._has_remote_shards():
            sfx = self._match_suffix(
                filters or [F.EqualsRegex("_metric_", ".*")])
            path = (f"/api/v1/series{sfx}"
                    f"&start={start_ms / 1000.0}&end={end_ms / 1000.0}")
            for d in self._peer_metadata(path):
                if "__name__" in d:
                    d = dict(d)
                    d["_metric_"] = d.pop("__name__")
                out.append(d)
        return out

    def raw_series(self, filters, start_ms: int, end_ms: int):
        """Yield (labels, ts int64, vals f64) of the raw samples in range,
        the remote-read path (ref: PrometheusModel's remote-read conversion
        reads raw chunks, not periodic samples). Scalar schemas only.

        Under the shard lock: the ids, their labels, and one gather of
        their rows on the store's device (a compressed-resident store
        decodes its block once for the whole selection). The copy to the
        host waits until the lock is released: the gathered rows are a
        copy, ordered on the stream before any later in-place write. A
        selection older than its resident rows merges its cold chunks from
        the durable sink (on-demand paging)."""
        for shard in self.memstore.shards_of(self.dataset):
            if shard.schema.is_histogram:
                continue   # remote read carries scalar samples
            with shard.lock:
                pids = shard.part_ids_from_filters(list(filters), start_ms,
                                                   end_ms)
                if len(pids) == 0 or shard.store is None:
                    continue
                labels = [shard.index.labels_of(int(p)) for p in pids]
                paged = (shard.gather_resident_locked(pids)
                         if shard.needs_paging(pids, start_ms) else None)
                if paged is None:
                    tsrc, vsrc = shard.store.snapshot_arrays()
                    rows = torch.from_numpy(pids.astype(np.int64)).to(
                        tsrc.device)
                    ts_sel = tsrc.index_select(0, rows)
                    v_sel = vsrc.index_select(0, rows)
                    nh = shard.store.n_host[pids].copy()
            if paged is not None:
                cold = shard.read_cold_for(pids, start_ms, end_ms)
                ts_h, v_h, nh = shard.merge_paged(pids, paged, cold)
            else:
                ts_h, v_h = ts_sel.cpu().numpy(), v_sel.cpu().numpy()
            for i, lbl in enumerate(labels):
                t, v = ts_h[i, :nh[i]], v_h[i, :nh[i]]
                keep = (t >= start_ms) & (t <= end_ms)
                if keep.any():
                    yield lbl, t[keep], np.asarray(v[keep], np.float64)
