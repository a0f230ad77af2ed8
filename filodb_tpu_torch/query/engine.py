"""QueryEngine facade: PromQL text -> LogicalPlan -> ExecPlan -> QueryResult.

Port of the local path of ``filodb_tpu/query/engine.py`` (ref:
coordinator/.../QueryActor.scala + queryengine2/QueryEngine.materialize):
parse, plan, execute on this node's shards, present. One root span per
query and the end-to-end latency histogram, as in the reference. Before the
planner, ``histogram_quantile(q, sum by (...) (rate|increase|delta|...(h[w])))``
on a single grid-aligned histogram shard takes the fused-hist route, as in
the reference; every other histogram query takes the general ExecPlan
path. The result, fragment and negative caches, retention routing,
admission, the device mesh and remote legs come with later slices.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core.memstore import TimeSeriesMemStore
from ..device import resolve_device
from ..ops import fusedresident, gridfns, rangefns
from ..parallel.shardmapper import ShardMapper
from ..promql import parser as promql
from ..utils.metrics import FILODB_QUERY_LATENCY_MS, registry
from ..utils.tracing import (SPAN_QUERY, SPAN_QUERY_EXECUTE, SPAN_QUERY_PARSE,
                             SPAN_QUERY_PLAN, span, tracer)
from . import logical as L
from .exec import (QueryContext, SelectRawPartitionsExec, _gather_rows_padded,
                   _group_ids_for, _pad_steps, _pow2, _segment_partial,
                   check_sample_limit)
from .planner import QueryPlanner
from .rangevector import QueryResult, QueryStats, ResultMatrix

# rows outside the selection: a group id no kernel's one-hot or scatter
# ever matches (scatters drop it; one-hot comparisons never equal it)
_EXCLUDED_GID = 1 << 30


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
    """Ref: query/.../QueryConfig.scala (stale-sample-after, sample limits)."""
    stale_sample_after_ms: int = 5 * 60 * 1000
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
                            sample_limit=self.config.sample_limit,
                            stale_ms=self.config.stale_sample_after_ms)

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
            res = self._try_fused_hist(plan, ctx)
            if res is None:
                ctx.exec_path = "local"
                with span(SPAN_QUERY_PLAN), ctx.stats.stage("plan"):
                    exec_plan = self.planner.materialize(plan)
                res = exec_plan.run(ctx)
        m = res.matrix
        ctx.stats.add("result_cells", m.num_series * len(m.out_ts))
        res.stats = ctx.stats
        res.exec_path = ctx.exec_path
        return res

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
        if len(shards) != 1:
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
        with sh.lock:
            data = leaf.do_execute(pctx)
            window = inner.window_ms
            if (data.grid is None or data.bucket_les is None
                    or (data.grid_minority is not None
                        and len(data.grid_minority))
                    or max(abs(int(out_ts[0]) - data.grid[0]),
                           abs(int(out_ts[-1]) - data.grid[0]))
                    + window >= 2**31):
                return None          # cold, empty or churned: general path
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
        ctx.exec_path = path
        ctx.stats.merge(pctx.stats)
        # the blocking host copy runs outside the shard lock
        m = ResultMatrix(out_ts, out[:G, :T].cpu().numpy(), list(uniq))
        check_sample_limit(m.num_series, T, ctx.sample_limit)
        return QueryResult(m)

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
