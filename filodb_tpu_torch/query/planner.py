"""LogicalPlan -> ExecPlan materializer.

Port of ``filodb_tpu/query/planner.py`` (ref:
coordinator/.../queryengine2/QueryEngine.scala:106-375): picks target shards
from shard-key filters, pushes the map phase down to the shard leaves and
wires scatter-gather, joins, subqueries, ``@``, chunk-metadata leaves and
the instant, sort, misc and scalar mappers on top; and the admission gate's
cost estimate over the logical tree.

With a ``route_fn`` (the engine's shard -> peer endpoint map), a leaf for a
shard another node owns materializes as ``wire.RemoteLeafExec``, and the
tree's cross-node fan-out collapses from per-shard to per-peer: a fan-in
whose children all live on one peer ships whole (the co-located reduce),
other same-peer siblings batch into one ``RemoteBatchExec``.
"""

from __future__ import annotations

from dataclasses import replace

from ..core.filters import Equals
from ..core.record import fnv1a64
from ..core.schemas import DatasetOptions
from ..parallel.shardmapper import ShardMapper
from . import logical as L
from .exec import (AggregateMapReduce, AggregatePresenter, BinaryJoinExec,
                   DistConcatExec, ExecPlan, InstantVectorFunctionMapper,
                   MiscellaneousFunctionMapper, PeriodicSamplesMapper,
                   ReduceAggregateExec, RepeatAtExec, ScalarExec,
                   ScalarOfVectorExec, ScalarOperationMapper,
                   SelectChunkInfosExec, SelectRawPartitionsExec,
                   SetOperatorExec, SortFunctionMapper, SubqueryWindowExec,
                   TimeScalarExec)
from .rangevector import QueryError

_SET_OPS = {"and", "or", "unless"}


class QueryPlanner:
    def __init__(self, shard_mapper: ShardMapper | None = None,
                 options: DatasetOptions = DatasetOptions(),
                 route_fn=None, dataset: str = "",
                 remote_timeout_s: float = 30.0):
        """``route_fn(shard) -> "host:port" | None``: the HTTP endpoint of
        the peer owning a shard, None for a shard served here (ref:
        queryengine2/QueryEngine.scala:506 picks the shard-owning node's
        dispatcher for every leaf)."""
        self.mapper = shard_mapper or ShardMapper(1)
        self.options = options
        self.route_fn = route_fn
        self.dataset = dataset
        self.remote_timeout_s = remote_timeout_s

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
        root = self._walk(plan)
        if self.route_fn is not None:
            root = self._collapse_remote(root)
        return root

    # -- per-peer dispatch shaping --------------------------------------------

    def _collapse_remote(self, node: ExecPlan) -> ExecPlan:
        """Collapse cross-node fan-out from per-shard to per-peer (ref:
        ExecPlan.scala ``dispatchRemotePlan`` + the data-node reduce placement
        in queryengine2/QueryEngine.scala:506). Two rewrites, applied bottom-
        up over the materialized tree:

        1. co-located reduce: when EVERY child of a ReduceAggregate/DistConcat
           lives on one peer and the whole subtree is wire-able, the node
           itself ships — the peer runs its own reduce (fused kernels and all)
           and only the reduced partial/presented matrix returns.
        2. batched dispatch: remaining same-endpoint sibling leaves group into
           one RemoteBatchExec — a query spanning a peer's K shards costs one
           ``/exec`` round-trip instead of K."""
        from .wire import (NotWireable, RemoteBatchExec, RemoteLeafExec,
                           serialize_plan)

        # step-varying scalar operands hold their own materialized subplans
        # (executed locally before dispatch): shape their fan-out too
        for t in getattr(node, "transformers", ()):
            if isinstance(getattr(t, "scalar", None), ExecPlan):
                t.scalar = self._collapse_remote(t.scalar)
        for attr in ("lhs", "rhs", "child"):
            v = getattr(node, attr, None)
            if isinstance(v, ExecPlan):
                setattr(node, attr, self._collapse_remote(v))
        if not isinstance(node, (DistConcatExec, ReduceAggregateExec)):
            return node
        node.children = [self._collapse_remote(c) for c in node.children]
        ch = node.children
        remotes = [c for c in ch if isinstance(c, RemoteLeafExec)]
        endpoints = {c.endpoint for c in remotes}
        if remotes and len(remotes) == len(ch) and len(endpoints) == 1:
            # co-located reduce: fold each wrapper's transformer chain into
            # its shipped subplan and ship the fan-in node itself; the node's
            # own transformers (presenter etc.) ride on the new wrapper and
            # ship as its wire-able prefix
            inner = replace(
                node,
                transformers=[],
                children=[replace(c.inner,
                                  transformers=list(c.inner.transformers)
                                  + list(c.transformers))
                          for c in remotes])
            try:
                serialize_plan(inner)
            except NotWireable:
                pass          # e.g. a scalar-operand subplan: batch instead
            else:
                return RemoteLeafExec(
                    transformers=list(node.transformers),
                    endpoint=remotes[0].endpoint, dataset=self.dataset,
                    inner=inner, timeout_s=self.remote_timeout_s)
        # transport batching: one RemoteBatchExec per endpoint with >= 2
        # leaves (a single leaf already costs exactly one round-trip)
        groups: dict[str, list[int]] = {}
        for i, c in enumerate(ch):
            if isinstance(c, RemoteLeafExec):
                groups.setdefault(c.endpoint, []).append(i)
        batch_at: dict[int, ExecPlan] = {}
        consumed: set[int] = set()
        for ep, idxs in groups.items():
            if len(idxs) < 2:
                continue
            batch_at[idxs[0]] = RemoteBatchExec(
                endpoint=ep, dataset=self.dataset,
                members=[ch[i] for i in idxs],
                timeout_s=self.remote_timeout_s, slots=list(idxs))
            consumed.update(idxs[1:])
        if batch_at:
            node.children = [batch_at.get(i, c) for i, c in enumerate(ch)
                             if i not in consumed]
        return node

    def _route(self, leaf: ExecPlan) -> ExecPlan:
        """Wrap a leaf for a peer-owned shard in a RemoteLeafExec; later
        transformer push-downs land on the wrapper and ship as the plan's
        wire prefix (query/wire.py)."""
        ep = self.route_fn(leaf.shard) if self.route_fn else None
        if ep is None:
            return leaf
        from .wire import RemoteLeafExec
        return RemoteLeafExec(endpoint=ep, dataset=self.dataset, inner=leaf,
                              timeout_s=self.remote_timeout_s)

    def _leaves(self, raw: L.RawSeries, psm: PeriodicSamplesMapper) -> list[ExecPlan]:
        return [
            self._route(SelectRawPartitionsExec(
                transformers=[psm], shard=s, filters=tuple(raw.filters),
                start_ms=raw.range_selector.from_ms,
                end_ms=raw.range_selector.to_ms,
                column=raw.columns[0] if raw.columns else ""))
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
        if isinstance(p, L.BinaryJoin):
            op = p.operator.removesuffix("_bool")
            lhs = self._walk(p.lhs)
            rhs = self._walk(p.rhs)
            if op in _SET_OPS:
                return SetOperatorExec(lhs=lhs, rhs=rhs, operator=op,
                                       on=p.on, ignoring=p.ignoring)
            return BinaryJoinExec(lhs=lhs, rhs=rhs, operator=p.operator,
                                  cardinality=p.cardinality, on=p.on,
                                  ignoring=p.ignoring, include=p.include)
        if isinstance(p, L.ScalarVectorBinaryOperation):
            scalar = p.scalar
            if isinstance(scalar, L.LogicalPlan):
                # step-varying scalar (time(), scalar(v)): materialize its
                # plan; the mapper evaluates it to a [T] array at query time
                scalar = self._walk(scalar)
            return _wrap(self._walk(p.vector), ScalarOperationMapper(
                p.operator, scalar, p.scalar_is_lhs))
        if isinstance(p, L.ApplyInstantFunction):
            return _wrap(self._walk(p.vectors), InstantVectorFunctionMapper(
                p.function, p.function_args))
        if isinstance(p, L.ApplyMiscellaneousFunction):
            return _wrap(self._walk(p.vectors), MiscellaneousFunctionMapper(
                p.function, p.string_args))
        if isinstance(p, L.ApplySortFunction):
            return _wrap(self._walk(p.vectors), SortFunctionMapper(p.function))
        if isinstance(p, L.ScalarPlan):
            return ScalarExec(value=p.value, start_ms=p.start_ms,
                              step_ms=p.step_ms, end_ms=p.end_ms)
        if isinstance(p, L.TimeScalarPlan):
            return TimeScalarExec(start_ms=p.start_ms, step_ms=p.step_ms,
                                  end_ms=p.end_ms)
        if isinstance(p, L.ScalarOfVector):
            return ScalarOfVectorExec(child=self._walk(p.vectors))
        if isinstance(p, L.VectorOfScalar):
            # a scalar plan already yields a one-series matrix
            return self._walk(p.scalar)
        if isinstance(p, L.SubqueryWithWindowing):
            return SubqueryWindowExec(
                child=self._walk(p.inner), start_ms=p.start_ms,
                step_ms=p.step_ms, end_ms=p.end_ms, window_ms=p.window_ms,
                function=p.function, args=p.function_args)
        if isinstance(p, L.ApplyAtTimestamp):
            return RepeatAtExec(child=self._walk(p.vectors),
                                start_ms=p.start_ms, step_ms=p.step_ms,
                                end_ms=p.end_ms)
        if isinstance(p, L.RawChunkMeta):
            return self._fan_in([
                self._route(SelectChunkInfosExec(
                    shard=s, filters=tuple(p.filters),
                    start_ms=p.range_selector.from_ms,
                    end_ms=p.range_selector.to_ms, column=p.column))
                for s in self.shards_for_filters(list(p.filters))])
        raise QueryError(f"cannot materialize {type(p).__name__}")

    def _materialize_aggregate(self, p: L.Aggregate) -> ExecPlan:
        inner = p.vectors
        mr = AggregateMapReduce(p.operator, p.params, p.by, p.without)
        presenter = AggregatePresenter(p.operator, p.params, p.by, p.without)
        if isinstance(inner, (L.PeriodicSeries, L.PeriodicSeriesWithWindowing)):
            # push the map phase down to each shard leaf (ref: QueryEngine
            # pushes AggregateMapReduce onto child plans)
            children = [_wrap(c, mr) for c in self._walk_shard_children(inner)]
        else:
            # complex inner plan: aggregate on top of the materialized child
            children = [_wrap(self._walk(inner), mr)]
        return ReduceAggregateExec(
            transformers=[presenter], operator=p.operator, params=p.params,
            by=p.by, without=p.without, children=children)

    # -- cost estimation (feeds admission control) ----------------------------

    # window factor cap: beyond this many window-steps the kernels' work per
    # step stops growing meaningfully (band matmuls stream the store once)
    COST_WINDOW_STEPS_CAP = 256.0

    def estimate_cost(self, plan: L.LogicalPlan, series_of,
                      stale_ms: int = 300_000) -> float:
        """Planner-side cost estimate for admission control: roughly the
        samples a query touches — ``series x steps x window-steps`` summed
        over data-reading leaves, with a narrow-residency discount (a
        compressed-resident block streams half the device-memory bytes of raw f32).

        ``series_of(filters, from_ms, to_ms) -> (series, narrow_fraction)``
        is the engine's index probe (the planner stays storage-agnostic).
        An ESTIMATE, not a meter: admission compares concurrent magnitudes,
        so relative ordering is what matters (ref: the reference's
        query-limits config bounds the same axis by fiat)."""
        def leaf(raw, start_ms, end_ms, step_ms, window_ms) -> float:
            step = max(int(step_ms), 1)
            steps = max((int(end_ms) - int(start_ms)) // step + 1, 1)
            series, narrow_frac = series_of(
                list(raw.filters), raw.range_selector.from_ms,
                raw.range_selector.to_ms)
            wsteps = min(max(float(window_ms) / step, 1.0),
                         self.COST_WINDOW_STEPS_CAP)
            discount = 1.0 - 0.5 * min(max(float(narrow_frac), 0.0), 1.0)
            return float(series) * steps * wsteps * discount

        def walk(p) -> float:
            if isinstance(p, L.PeriodicSeriesWithWindowing):
                return leaf(p.series, p.start_ms, p.end_ms, p.step_ms,
                            p.window_ms)
            if isinstance(p, L.PeriodicSeries):
                return leaf(p.raw_series, p.start_ms, p.end_ms, p.step_ms,
                            stale_ms)
            if isinstance(p, L.Aggregate):
                return walk(p.vectors)
            if isinstance(p, L.BinaryJoin):
                return walk(p.lhs) + walk(p.rhs)
            if isinstance(p, L.ScalarVectorBinaryOperation):
                cost = walk(p.vector)
                if isinstance(p.scalar, L.LogicalPlan):
                    cost += walk(p.scalar)
                return cost
            if isinstance(p, (L.ApplyInstantFunction,
                              L.ApplyMiscellaneousFunction,
                              L.ApplySortFunction)):
                return walk(p.vectors)
            if isinstance(p, L.ScalarOfVector):
                return walk(p.vectors)
            if isinstance(p, L.VectorOfScalar):
                return walk(p.scalar)
            if isinstance(p, L.SubqueryWithWindowing):
                # the inner plan already carries its own (denser) grid; the
                # outer window slide is host-side and cheap in comparison
                return walk(p.inner)
            if isinstance(p, L.ApplyAtTimestamp):
                return walk(p.vectors)
            return 0.0        # scalar literals / time() / chunk-meta probes

        return walk(plan)

    def _walk_shard_children(self, p) -> list[ExecPlan]:
        if isinstance(p, L.PeriodicSeries):
            psm = PeriodicSamplesMapper(p.start_ms, p.step_ms, p.end_ms, None, None)
            return self._leaves(p.raw_series, psm)
        psm = PeriodicSamplesMapper(p.start_ms, p.step_ms, p.end_ms,
                                    p.window_ms, p.function, p.function_args)
        return self._leaves(p.series, psm)


def _wrap(child: ExecPlan, transformer) -> ExecPlan:
    child.transformers = child.transformers + [transformer]
    return child
