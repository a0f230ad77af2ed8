"""Cluster control plane: membership, shard assignment, status events,
failure-aware routing — host logic, no device involvement.

Host copy of ``filodb_tpu/parallel/cluster.py`` (ref: coordinator/.../
NodeClusterActor.scala:187, ShardManager.scala:28,
ShardAssignmentStrategy.scala, ShardStatus.scala, and
queryengine2/FailureProvider.scala:11-47 + RoutingPlanner.scala). A "node"
owns a set of shards; each node's engine serves its own shards on its own
card and ships the peers' leaves over HTTP (``query/wire.py``). The
assignment and event model are the reference's, so operators see the same
lifecycle; ``stitch_matrices`` also joins the fragment cache's cached and
new steps.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable

import numpy as np

from ..query.rangevector import QueryResult, RangeVectorKey, ResultMatrix


class ShardStatus(Enum):
    UNASSIGNED = "Unassigned"
    ASSIGNED = "Assigned"
    RECOVERY = "Recovery"
    ACTIVE = "Active"
    ERROR = "Error"
    DOWN = "Down"
    STOPPED = "Stopped"


@dataclass(frozen=True)
class ShardEvent:
    """Ref: ShardEvent ADT (AssignmentStarted/IngestionStarted/RecoveryInProgress/
    IngestionError/ShardDown/...)."""
    kind: str
    dataset: str
    shard: int
    node: str | None
    at: float = field(default_factory=time.time)


class ShardAssignmentStrategy:
    """Even spread, filling least-loaded nodes first (ref:
    DefaultShardAssignmentStrategy.scala:1-113)."""

    def assign(self, shards: list[int], nodes: list[str],
               load: dict[str, int]) -> dict[int, str]:
        if not nodes:
            return {}
        out = {}
        counts = {n: load.get(n, 0) for n in nodes}
        for s in shards:
            target = min(counts, key=lambda n: (counts[n], n))
            out[s] = target
            counts[target] += 1
        return out


class ShardManager:
    """Owns assignment state for all datasets (ref: ShardManager.scala:28)."""

    def __init__(self, strategy: ShardAssignmentStrategy | None = None,
                 min_reassignment_interval_s: float = 0.0):
        self.strategy = strategy or ShardAssignmentStrategy()
        self.nodes: list[str] = []
        # dataset -> shard -> (node | None, ShardStatus)
        self.map: dict[str, dict[int, tuple[str | None, ShardStatus]]] = {}
        self.events: list[ShardEvent] = []
        self._subscribers: list[Callable[[ShardEvent], None]] = []
        self._last_reassign: dict[str, float] = defaultdict(float)
        self.min_reassign_s = min_reassignment_interval_s

    # -- membership ----------------------------------------------------------

    def add_node(self, node: str) -> None:
        if node in self.nodes:
            return
        self.nodes.append(node)
        for ds in self.map:
            self._assign_unassigned(ds)

    def remove_node(self, node: str) -> None:
        """Node failure/departure: mark its shards Down, then auto-reassign
        (ref: doc/sharding.md 'Automatic Reassignment')."""
        if node not in self.nodes:
            return
        self.nodes.remove(node)
        for ds, shards in self.map.items():
            for s, (n, st) in list(shards.items()):
                if n == node:
                    shards[s] = (None, ShardStatus.DOWN)
                    self._emit(ShardEvent("ShardDown", ds, s, node))
            now = time.time()
            if now - self._last_reassign[ds] >= self.min_reassign_s:
                self._last_reassign[ds] = now
                self._assign_unassigned(ds)

    # -- datasets ------------------------------------------------------------

    def add_dataset(self, dataset: str, num_shards: int,
                    claimed: dict[int, str] | None = None) -> None:
        """Ref: NodeClusterActor SetupDataset -> ShardManager.addDataset.

        ``claimed`` seeds incumbent ownership (shard -> node) learned from
        peers' registrar heartbeats: a (re)joining node adopts the cluster's
        existing assignment — including post-takeover state — instead of
        computing a fresh full assignment that would double-own shards."""
        if dataset in self.map:
            return
        self.map[dataset] = {s: (None, ShardStatus.UNASSIGNED)
                             for s in range(num_shards)}
        for s, node in (claimed or {}).items():
            if 0 <= s < num_shards and node in self.nodes:
                self.map[dataset][s] = (node, ShardStatus.ASSIGNED)
        self._assign_unassigned(dataset)

    def _assign_unassigned(self, dataset: str) -> None:
        shards = self.map[dataset]
        todo = [s for s, (n, st) in shards.items()
                if n is None or st in (ShardStatus.UNASSIGNED, ShardStatus.DOWN)]
        load: dict[str, int] = defaultdict(int)
        for ds in self.map.values():
            for n, _ in ds.values():
                if n is not None:
                    load[n] += 1
        for s, node in self.strategy.assign(todo, self.nodes, load).items():
            shards[s] = (node, ShardStatus.ASSIGNED)
            self._emit(ShardEvent("AssignmentStarted", dataset, s, node))

    # -- status/events -------------------------------------------------------

    def set_status(self, dataset: str, shard: int, status: ShardStatus) -> None:
        node, _ = self.map[dataset][shard]
        self.map[dataset][shard] = (node, status)
        kind = {ShardStatus.ACTIVE: "IngestionStarted",
                ShardStatus.RECOVERY: "RecoveryInProgress",
                ShardStatus.ERROR: "IngestionError",
                ShardStatus.STOPPED: "IngestionStopped"}.get(status, status.value)
        self._emit(ShardEvent(kind, dataset, shard, node))

    def subscribe(self, fn: Callable[[ShardEvent], None]) -> None:
        self._subscribers.append(fn)

    def _emit(self, ev: ShardEvent) -> None:
        self.events.append(ev)
        for fn in self._subscribers:
            fn(ev)

    def reassign(self, dataset: str, shard: int, node: str) -> None:
        """Directly move ONE shard's ownership (live rebalance cutover /
        peer-claims reconciliation — vs. remove_node's bulk failure path).
        Fires AssignmentStarted for the new owner, so the owning server's
        resync starts the shard."""
        if node not in self.nodes:
            self.nodes.append(node)
        self.map[dataset][shard] = (node, ShardStatus.ASSIGNED)
        self._emit(ShardEvent("AssignmentStarted", dataset, shard, node))

    def node_of(self, dataset: str, shard: int) -> str | None:
        return self.map[dataset][shard][0]

    def shards_of_node(self, dataset: str, node: str) -> list[int]:
        return [s for s, (n, _) in self.map[dataset].items() if n == node]

    def snapshot(self, dataset: str) -> dict:
        """CurrentShardSnapshot equivalent for subscribers/HTTP."""
        return {s: {"node": n, "status": st.value}
                for s, (n, st) in self.map[dataset].items()}

    def status(self) -> dict:
        return {"nodes": list(self.nodes),
                "datasets": {ds: self.snapshot(ds) for ds in self.map}}


# ---------------------------------------------------------------------------
# Failure-aware query routing (ref: FailureProvider + QueryRoutingPlanner +
# PromQlExec HTTP federation — the dual-datacenter no-SPOF story)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FailureTimeRange:
    """A time range where local data is known bad/missing (ref:
    FailureProvider.scala FailureTimeRange)."""
    start_ms: int
    end_ms: int
    legacy: bool = False      # failure of the *remote* cluster instead


class FailureProvider:
    def __init__(self):
        self._failures: list[FailureTimeRange] = []
        # keyed OPEN windows (node dead, shard warming): end unknown until
        # recovery closes them — queries treat an open window as extending
        # through their whole range
        self._open: dict[str, int] = {}

    def record(self, f: FailureTimeRange) -> None:
        self._failures.append(f)

    def open_window(self, key: str, start_ms: int) -> None:
        """Start a keyed known-bad window (membership on_down / shard
        takeover): local data from ``start_ms`` on is suspect until
        ``close_window`` seals it."""
        self._open.setdefault(key, int(start_ms))

    def close_window(self, key: str, end_ms: int) -> None:
        """Seal a keyed window (node recovered / shard warmed): the closed
        range stays routable-around; later data is trusted again."""
        start = self._open.pop(key, None)
        if start is not None and end_ms >= start:
            self._failures.append(FailureTimeRange(start, int(end_ms)))

    def open_windows(self) -> dict[str, int]:
        return dict(self._open)

    def failures_in(self, start_ms: int, end_ms: int) -> list[FailureTimeRange]:
        out = [f for f in self._failures
               if f.end_ms >= start_ms and f.start_ms <= end_ms]
        out += [FailureTimeRange(s, 1 << 62)
                for s in self._open.values() if s <= end_ms]
        return out


@dataclass
class TimeSplit:
    start_ms: int
    end_ms: int
    remote: bool


def plan_time_splits(start_ms: int, end_ms: int, step_ms: int,
                     failures: list[FailureTimeRange],
                     lookback_ms: int = 300_000) -> list[TimeSplit]:
    """Split [start, end] into local/remote sub-ranges around local failures
    (ref: QueryRoutingPlanner.plan — remote route covers failure windows plus
    the lookback needed to re-prime range functions after the failure)."""
    local_failures = [f for f in failures if not f.legacy]
    if not local_failures:
        return [TimeSplit(start_ms, end_ms, remote=False)]
    splits: list[TimeSplit] = []
    cur = start_ms
    for f in sorted(local_failures, key=lambda f: f.start_ms):
        # remote must cover [f.start, f.end + lookback] rounded to steps
        r_start = max(cur, f.start_ms)
        r_end = min(end_ms, f.end_ms + lookback_ms)
        if r_start > end_ms or r_end < cur:
            continue
        # align to the step grid so sub-results stitch exactly
        r_start = start_ms + ((r_start - start_ms + step_ms - 1) // step_ms) * step_ms
        r_end = min(end_ms, start_ms + ((r_end - start_ms) // step_ms + 1) * step_ms)
        if r_start > cur:
            splits.append(TimeSplit(cur, r_start - step_ms, remote=False))
        splits.append(TimeSplit(r_start, r_end, remote=True))
        cur = r_end + step_ms
    if cur <= end_ms:
        splits.append(TimeSplit(cur, end_ms, remote=False))
    return [s for s in splits if s.start_ms <= s.end_ms]


class RemotePromExec:
    """Federated sub-query against a buddy cluster's Prometheus HTTP API
    (ref: query/.../exec/PromQlExec.scala)."""

    def __init__(self, endpoint: str, dataset: str, timeout_s: float = 30.0):
        self.endpoint = endpoint.rstrip("/")
        self.dataset = dataset
        self.timeout_s = timeout_s

    def query_range(self, promql: str, start_ms: int, end_ms: int, step_ms: int):
        import json as _json
        import urllib.parse
        import urllib.request

        params = urllib.parse.urlencode({
            "query": promql, "start": start_ms / 1000.0, "end": end_ms / 1000.0,
            "step": f"{step_ms}ms"})
        url = f"{self.endpoint}/promql/{self.dataset}/api/v1/query_range?{params}"
        with urllib.request.urlopen(url, timeout=self.timeout_s) as r:
            payload = _json.load(r)
        out_ts = np.arange(start_ms, end_ms + 1, step_ms, dtype=np.int64)
        keys, rows = [], []
        for series in payload["data"]["result"]:
            metric = dict(series["metric"])
            if "__name__" in metric:
                metric["_metric_"] = metric.pop("__name__")
            keys.append(RangeVectorKey.of(metric))
            row = np.full(len(out_ts), np.nan)
            for t, v in series["values"]:
                idx = round((t * 1000 - start_ms) / step_ms)
                if 0 <= idx < len(out_ts):
                    row[idx] = float(v)
            rows.append(row)
        vals = np.stack(rows) if rows else np.zeros((0, len(out_ts)))
        return ResultMatrix(out_ts, vals, keys)


def stitch_matrices(parts) -> ResultMatrix:
    """Stitch sub-range results over disjoint time splits into one matrix
    (ref: query/.../exec/StitchRvsExec.scala). Values are host arrays."""
    parts = [p for p in parts if p.num_series or len(p.out_ts)]
    if not parts:
        return ResultMatrix(np.zeros(0, np.int64), np.zeros((0, 0)), [])
    out_ts = np.concatenate([p.out_ts for p in parts])
    order = np.argsort(out_ts, kind="stable")
    out_ts = out_ts[order]
    all_keys: dict = {}
    for p in parts:
        for k in p.keys:
            all_keys.setdefault(k, len(all_keys))
    vals = np.full((len(all_keys), len(out_ts)), np.nan)
    for p in parts:
        pv = np.asarray(p.values)
        cols = np.searchsorted(out_ts, p.out_ts)
        for i, k in enumerate(p.keys):
            vals[all_keys[k], cols] = pv[i]
    return ResultMatrix(out_ts, vals, list(all_keys))


class HighAvailabilityEngine:
    """Query engine wrapper: routes failure time ranges to a buddy cluster and
    stitches results (the reference's dual-cluster HA query path).

    Drop-in for a QueryEngine: every attribute/method other than
    ``query_range`` (metadata, instant queries, memstore, caches) passes
    through to the wrapped engine, so the HTTP layer, rules evaluator and
    stats scrapers serve through it unchanged."""

    def __init__(self, engine, failure_provider: FailureProvider,
                 remote: RemotePromExec | None):
        self.engine = engine
        self.failures = failure_provider
        self.remote = remote

    def __getattr__(self, name):
        # only missing attrs land here: the wrapper is transparent for
        # everything it does not explicitly override
        return getattr(self.engine, name)

    def query_range(self, promql: str, start_ms: int, end_ms: int,
                    step_ms: int, **kw):
        fails = self.failures.failures_in(start_ms, end_ms)
        splits = plan_time_splits(start_ms, end_ms, step_ms, fails)
        if len(splits) == 1 and not splits[0].remote:
            return self.engine.query_range(promql, start_ms, end_ms, step_ms,
                                           **kw)
        parts = []
        for sp in splits:
            if sp.remote:
                if self.remote is None:
                    continue
                parts.append(self.remote.query_range(promql, sp.start_ms,
                                                     sp.end_ms, step_ms))
            else:
                r = self.engine.query_range(promql, sp.start_ms, sp.end_ms,
                                            step_ms, **kw)
                parts.append(r.matrix.to_host())
        res = QueryResult(stitch_matrices(parts))
        res.exec_path = "ha-stitched"
        return res
