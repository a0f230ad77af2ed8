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
``topk``/``bottomk``, folded on the host in shard order. The result,
fragment and negative caches, retention routing, admission and remote legs
come with later slices.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core.memstore import TimeSeriesMemStore
from ..device import resolve_device
from ..ops import aggregators, fusedresident, gridfns, rangefns
from ..parallel import distributed
from ..parallel.shardmapper import ShardMapper
from ..promql import parser as promql
from ..utils.metrics import FILODB_QUERY_LATENCY_MS, registry
from ..utils.tracing import (SPAN_QUERY, SPAN_QUERY_EXECUTE, SPAN_QUERY_PARSE,
                             SPAN_QUERY_PLAN, span, tracer)
from . import logical as L
from .exec import (_SKETCH_BYTES_CAP, AggregateMapReduce, QueryContext,
                   SelectRawPartitionsExec, TopKPartial, _gather_rows_padded,
                   _group_ids_for, _pad_steps, _pow2, _present_topk,
                   _segment_partial, check_sample_limit, group_keys_of)
from .planner import QueryPlanner
from .rangevector import (QueryError, QueryResult, QueryStats, RangeVectorKey,
                          ResultMatrix)

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
                 config: QueryConfig | None = None, device=None,
                 mesh=None):
        """``device`` is where this engine's shards live and its kernels
        run: ``"cuda"`` by default; raises when there is no card and the
        CPU was not asked for. A shard on another device fails its query.
        ``mesh`` (a list of devices, ``distributed.make_mesh``) routes the
        aggregates the mesh can run across all shards at once, shard ``i``
        on ``mesh[i % len(mesh)]``; anything else takes the host path."""
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
            res = (self._try_mesh(plan, ctx) if self.mesh is not None
                   else None)
            if res is None:
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
                # the reference routes a selection that needs cold data to
                # the host path here (needs_paging); the port's shards have
                # no sink to page from until item 11, so none does
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
