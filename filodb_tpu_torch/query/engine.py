"""QueryEngine facade: PromQL text -> LogicalPlan -> ExecPlan -> QueryResult.

Port of the local path of ``filodb_tpu/query/engine.py`` (ref:
coordinator/.../QueryActor.scala + queryengine2/QueryEngine.materialize):
parse, plan, execute on this node's shards, present. One root span per
query and the end-to-end latency histogram, as in the reference. The
result, fragment and negative caches, retention routing, admission, the
device mesh and remote legs come with later slices.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from ..core.memstore import TimeSeriesMemStore
from ..device import resolve_device
from ..parallel.shardmapper import ShardMapper
from ..promql import parser as promql
from ..utils.metrics import FILODB_QUERY_LATENCY_MS, registry
from ..utils.tracing import (SPAN_QUERY, SPAN_QUERY_EXECUTE, SPAN_QUERY_PARSE,
                             SPAN_QUERY_PLAN, span, tracer)
from . import logical as L
from .exec import QueryContext
from .planner import QueryPlanner
from .rangevector import QueryResult


@dataclass
class QueryConfig:
    """Ref: query/.../QueryConfig.scala (sample limits)."""
    sample_limit: int = 1_000_000


class QueryEngine:
    def __init__(self, memstore: TimeSeriesMemStore, dataset: str,
                 shard_mapper: ShardMapper | None = None,
                 config: QueryConfig | None = None, device=None):
        """``device`` is where this engine's shards live and its kernels
        run: ``"cuda"`` by default; raises when there is no card and the
        CPU was not asked for. A shard on another device fails its query."""
        self.memstore = memstore
        self.dataset = dataset
        self.device = resolve_device(device)
        num_shards = max(len(memstore.shards_of(dataset)), 1)
        pow2 = 1
        while pow2 < num_shards:
            pow2 *= 2
        self.mapper = shard_mapper or ShardMapper(pow2)
        self.config = config if config is not None else QueryConfig()
        schema = memstore._dataset_schema.get(dataset)
        opts = schema.options if schema else None
        self.planner = (QueryPlanner(self.mapper, opts) if opts
                        else QueryPlanner(self.mapper))

    def _ctx(self) -> QueryContext:
        return QueryContext(self.memstore, self.dataset, self.device,
                            sample_limit=self.config.sample_limit)

    def query_range(self, promql_text: str, start_ms: int, end_ms: int,
                    step_ms: int) -> QueryResult:
        return self._query_traced(
            promql_text,
            lambda: promql.query_to_logical_plan(promql_text, start_ms,
                                                 end_ms, step_ms))

    def query_instant(self, promql_text: str, time_ms: int) -> QueryResult:
        res = self._query_traced(
            promql_text,
            lambda: promql.query_to_logical_plan(promql_text, time_ms,
                                                 time_ms, 1))
        res.result_type = "vector"
        return res

    def _query_traced(self, promql_text: str, to_plan) -> QueryResult:
        """One root span per query and the end-to-end latency histogram
        (recorded in a finally: a query that raises still counts)."""
        ctx = self._ctx()
        t0 = time.perf_counter_ns()
        trace_id = None
        try:
            with span(SPAN_QUERY, dataset=self.dataset,
                      promql=promql_text[:200]):
                trace_id = (tracer.current_context() or {}).get("trace_id")
                with span(SPAN_QUERY_PARSE), ctx.stats.stage("parse"):
                    plan = to_plan()
                return self.exec_logical(plan, ctx)
        finally:
            registry.histogram(FILODB_QUERY_LATENCY_MS,
                               {"dataset": self.dataset}).record(
                (time.perf_counter_ns() - t0) / 1e6, trace_id=trace_id)

    def exec_logical(self, plan: L.LogicalPlan,
                     ctx: QueryContext | None = None) -> QueryResult:
        ctx = ctx if ctx is not None else self._ctx()
        with span(SPAN_QUERY_EXECUTE, dataset=self.dataset), \
                ctx.stats.stage("execute"):
            ctx.exec_path = "local"
            with span(SPAN_QUERY_PLAN), ctx.stats.stage("plan"):
                exec_plan = self.planner.materialize(plan)
            res = exec_plan.run(ctx)
        m = res.matrix
        ctx.stats.add("result_cells", m.num_series * len(m.out_ts))
        res.stats = ctx.stats
        res.exec_path = ctx.exec_path
        return res
