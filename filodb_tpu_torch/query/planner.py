"""LogicalPlan -> ExecPlan materializer, single node.

Port of the local half of ``filodb_tpu/query/planner.py`` (ref:
coordinator/.../queryengine2/QueryEngine.scala:106-375): picks target shards
from shard-key filters, pushes the map phase down to the shard leaves and
wires the reduce on top. Plans this slice does not port raise
``QueryError(... not yet ported)``.
"""

from __future__ import annotations

from ..core.filters import Equals
from ..core.record import fnv1a64
from ..core.schemas import DatasetOptions
from ..ops.aggregators import BASIC_OPS
from ..parallel.shardmapper import ShardMapper
from . import logical as L
from .exec import (AggregateMapReduce, AggregatePresenter, DistConcatExec,
                   ExecPlan, PeriodicSamplesMapper, ReduceAggregateExec,
                   SelectRawPartitionsExec)
from .rangevector import QueryError


class QueryPlanner:
    def __init__(self, shard_mapper: ShardMapper | None = None,
                 options: DatasetOptions = DatasetOptions()):
        self.mapper = shard_mapper or ShardMapper(1)
        self.options = options

    # -- shard selection (ref: QueryEngine.shardsFromFilters :181-222) -------

    def shards_for_filters(self, filters) -> list[int]:
        eq = {f.label: f.value for f in filters if isinstance(f, Equals)}
        if all(c in eq for c in self.options.shard_key_columns):
            from ..core.schemas import shard_key_of
            sk = shard_key_of(eq, self.options)
            return self.mapper.shards_for_shard_key(fnv1a64(sk) & 0xFFFFFFFF)
        return self.mapper.all_shards()

    # -- materialization ------------------------------------------------------

    def materialize(self, plan: L.LogicalPlan) -> ExecPlan:
        return self._walk(plan)

    def _leaves(self, raw: L.RawSeries, psm: PeriodicSamplesMapper) -> list[ExecPlan]:
        return [
            SelectRawPartitionsExec(
                transformers=[psm], shard=s, filters=tuple(raw.filters),
                start_ms=raw.range_selector.from_ms,
                end_ms=raw.range_selector.to_ms,
                column=raw.columns[0] if raw.columns else "")
            for s in self.shards_for_filters(raw.filters)
        ]

    def _fan_in(self, children: list[ExecPlan]) -> ExecPlan:
        if len(children) == 1:
            return children[0]
        return DistConcatExec(children=children)

    def _walk(self, p: L.LogicalPlan) -> ExecPlan:
        if isinstance(p, (L.PeriodicSeries, L.PeriodicSeriesWithWindowing)):
            return self._fan_in(self._walk_shard_children(p))
        if isinstance(p, L.Aggregate):
            return self._materialize_aggregate(p)
        raise QueryError(f"{type(p).__name__} not yet ported")

    def _materialize_aggregate(self, p: L.Aggregate) -> ExecPlan:
        if p.operator not in BASIC_OPS:
            raise QueryError(f"aggregation {p.operator} not yet ported")
        inner = p.vectors
        mr = AggregateMapReduce(p.operator, p.by, p.without)
        presenter = AggregatePresenter(p.operator)
        if isinstance(inner, (L.PeriodicSeries, L.PeriodicSeriesWithWindowing)):
            # push the map phase down to each shard leaf (ref: QueryEngine
            # pushes AggregateMapReduce onto child plans)
            children = self._walk_shard_children(inner)
            for c in children:
                c.transformers = c.transformers + [mr]
        else:
            # complex inner plan: aggregate on top of the materialized child
            child = self._walk(inner)
            child.transformers = child.transformers + [mr]
            children = [child]
        return ReduceAggregateExec(transformers=[presenter],
                                   operator=p.operator, children=children)

    def _walk_shard_children(self, p) -> list[ExecPlan]:
        if isinstance(p, L.PeriodicSeries):
            psm = PeriodicSamplesMapper(p.start_ms, p.step_ms, p.end_ms, None, None)
            return self._leaves(p.raw_series, psm)
        psm = PeriodicSamplesMapper(p.start_ms, p.step_ms, p.end_ms,
                                    p.window_ms, p.function)
        return self._leaves(p.series, psm)
