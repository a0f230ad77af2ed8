"""ExecPlan tree + RangeVectorTransformers: the physical query execution layer.

Port of the local path of ``filodb_tpu/query/exec.py`` (ref:
query/.../exec/ExecPlan.scala, SelectRawPartitionsExec.scala,
ReduceAggregateExec, PeriodicSamplesMapper.scala, AggregateMapReduce /
AggregatePresenter).

Execution shape, as in the reference: the leaf resolves part ids host-side
(index), then hands the store's device tensors to the kernel chain. Narrow
selections gather rows; wide selections (the 1M-series aggregation) skip
the gather — rows outside the selection are disabled through a zeroed
sample count. On a grid-aligned f32 store, a window function followed by a
basic aggregation runs as ONE fused pass (ops/fusedgrid.py: K1 on the card).
Aggregation is host-computed dense group ids + one group reduce on device.

Routes this slice does not port (instant functions, binary operators, order
statistics, subqueries, histograms, __col__ selectors, on-demand paging,
remote legs) raise ``QueryError(... not yet ported)`` — never another path.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.chunkstore import TS_PAD
from ..ops import aggregators, fusedgrid, fusedresident, gridfns, rangefns
from ..utils.tracing import SPAN_QUERY_LEAF, SPAN_QUERY_REDUCE, span
from .rangevector import (QueryError, QueryResult, QueryStats,
                          RangeVectorKey, ResultMatrix)

DEFAULT_SAMPLE_LIMIT = 1_000_000
GATHER_THRESHOLD = 8192      # selections narrower than this gather rows up front


@dataclass
class QueryContext:
    memstore: object
    dataset: str
    device: torch.device
    sample_limit: int = DEFAULT_SAMPLE_LIMIT
    stats: QueryStats = field(default_factory=QueryStats)
    exec_path: str | None = None


@dataclass
class SeriesSelection:
    """Leaf output: the store's device tensors + which rows are selected.

    - ``rows is None``: tensors are exactly the selection.
    - ``rows`` = identity map [0..P): tensors are the gathered selection
      padded to R = pow2(P) rows; pad rows have n = 0 and carry no key.
    - ``rows`` = store-row ids: tensors cover the full store [S, C];
      ``rows[i]`` is the row of key i and ``n`` is zeroed outside the
      selection.
    """
    ts: torch.Tensor          # [R, C] int64
    val: torch.Tensor         # [R, C] float
    n: torch.Tensor           # [R] int32 (0 => row disabled)
    keys: list
    rows: np.ndarray | None
    grid: tuple | None = None  # (base_ts, interval_ms) => band-product path
    # array rows of live selected series whose start cell differs from the
    # majority cohort the grid base was shifted to (churn): recomputed
    # through the general kernels
    grid_minority: np.ndarray | None = None


@dataclass
class MatrixView:
    """Post-kernel matrix that may still be un-compacted (R >= P rows)."""
    out_ts: np.ndarray
    values: torch.Tensor      # [R, T]
    keys: list
    rows: np.ndarray | None

    def compact(self) -> ResultMatrix:
        vals = self.values
        if self.rows is not None:
            rid = torch.from_numpy(np.asarray(self.rows, np.int64))
            vals = vals[rid.to(vals.device)]
        return ResultMatrix(self.out_ts, vals, self.keys)


def _pow2(n: int, floor: int = 8) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


def _gather_rows_padded(ts, val, n, rows: np.ndarray):
    """Gather the given rows padded to a pow2 row count. Pad rows are fully
    disabled: n = 0 AND timestamps forced to the pad sentinel (the general
    kernels derive windows from timestamps)."""
    M = len(rows)
    P = _pow2(M)
    pad = np.zeros(P, np.int64)
    pad[:M] = rows
    dev = val.device
    rid = torch.from_numpy(pad).to(dev)
    real = torch.arange(P, device=dev) < M
    n_g = torch.where(real, n[rid], 0).to(torch.int32)
    ts_g = torch.where(real[:, None], ts[rid], int(TS_PAD))
    return ts_g, val[rid], n_g, P


def check_sample_limit(num_series: int, steps: int, limit: int) -> None:
    """Result-size guard (ref: QueryConfig sample limits)."""
    if num_series * steps > limit:
        raise QueryError(
            f"result too large: {num_series} series x {steps} steps "
            f"> sample limit {limit}")


def _pad_steps(out_ts: np.ndarray) -> tuple[np.ndarray, int]:
    """(out_ts padded to a multiple of 32 by repeating the last step, true
    T): the reference buckets its compile space this way; the port keeps
    the same evaluation grid so both compute the same cells."""
    T = len(out_ts)
    Tpad = -(-T // 32) * 32 if T else 0
    if Tpad == T:
        return out_ts, T
    return np.concatenate([out_ts, np.full(Tpad - T, out_ts[-1], np.int64)]), T


@dataclass
class FusedWindowData:
    """Lazy PeriodicSamplesMapper output on a grid-aligned f32 selection:
    the window function has NOT run yet. AggregateMapReduce fuses window +
    aggregation into one pass (ops/fusedgrid.py); any other consumer
    materializes through the grid kernel first."""
    sel: SeriesSelection
    out_ts: np.ndarray
    window: int
    fn: str

    def materialize(self) -> MatrixView:
        base_ts, interval_ms = self.sel.grid
        out_eval, T = _pad_steps(self.out_ts)
        vals = gridfns.periodic_samples_grid(
            self.sel.val, self.sel.n, out_eval, self.window, self.fn,
            base_ts, interval_ms)
        minority = self.sel.grid_minority
        if minority is not None and len(minority):
            vals = _correct_minority_cohort(self.sel, vals, out_eval,
                                            self.window, self.fn)
        if vals.shape[1] != T:
            vals = vals[:, :T]
        return MatrixView(self.out_ts, vals, self.sel.keys, self.sel.rows)


def _correct_minority_cohort(data, vals, out_ts, window, fn):
    """Patch grid-kernel output for churned rows: series whose start cell
    differs from the majority cohort are recomputed through the general
    kernels (an [M, C] row gather) and written back into the [R, T]
    result."""
    rows = np.asarray(data.grid_minority, np.int64)
    M = len(rows)
    sub_ts, sub_val, sub_n, _ = _gather_rows_padded(data.ts, data.val,
                                                    data.n, rows)
    corr = rangefns.periodic_samples(sub_ts, sub_val, sub_n, out_ts, window,
                                     fn)
    vals[torch.from_numpy(rows).to(vals.device)] = corr[:M].to(vals.dtype)
    return vals


# ---------------------------------------------------------------------------
# Transformers (ref: RangeVectorTransformer)
# ---------------------------------------------------------------------------

class Transformer:
    def apply(self, data, ctx: QueryContext):  # pragma: no cover - interface
        raise NotImplementedError


@dataclass
class PeriodicSamplesMapper(Transformer):
    """Range function evaluation (ref: PeriodicSamplesMapper.scala:23)."""
    start_ms: int
    step_ms: int
    end_ms: int
    window_ms: int | None     # None => instant selector (staleness lookback)
    function: str | None      # None => last_sample

    def out_ts(self) -> np.ndarray:
        step = max(self.step_ms, 1)
        return np.arange(self.start_ms, self.end_ms + 1, step, dtype=np.int64)

    def apply(self, data, ctx: QueryContext):
        assert isinstance(data, SeriesSelection), "PSM must sit directly on a leaf"
        fn = self.function or "last_sample"
        if fn not in rangefns.PORTED_FNS:
            raise QueryError(f"range function {fn} not yet ported")
        out_ts = self.out_ts()
        if len(out_ts) == 0:
            return MatrixView(out_ts, torch.zeros((len(data.keys), 0)),
                              data.keys, data.rows)
        out_eval, T = _pad_steps(out_ts)
        window = self.window_ms
        grid_usable = (
            data.grid is not None
            and max(abs(int(out_ts[0]) - data.grid[0]),
                    abs(int(out_ts[-1]) - data.grid[0])) + window < 2**31)
        minority = data.grid_minority
        if grid_usable and fn in gridfns.GRID_FNS:
            S, C = data.val.shape
            if (fusedresident.scalar_shape_of(fn) is not None
                    and data.val.dtype == torch.float32
                    and fusedgrid.fusable(S, C, len(out_ts), 1)):
                # defer: a following AggregateMapReduce fuses the window
                # function with the aggregation in one pass
                return FusedWindowData(data, out_ts, window, fn)
            base_ts, interval_ms = data.grid
            vals = gridfns.periodic_samples_grid(data.val, data.n, out_eval,
                                                 window, fn, base_ts,
                                                 interval_ms)
            if minority is not None and len(minority):
                vals = _correct_minority_cohort(data, vals, out_eval, window,
                                                fn)
        else:
            vals = rangefns.periodic_samples(data.ts, data.val, data.n,
                                             out_eval, window, fn)
        if len(out_eval) != T:
            vals = vals[:, :T]
        return MatrixView(out_ts, vals, data.keys, data.rows)


class LazyKeys:
    """Sequence of RangeVectorKeys materialized on first access: a 1M-series
    sum() must not pay a Python loop over every series at the leaf. Per-slot
    release epochs captured at leaf time detect a concurrent eviction
    reusing a selected slot and fail the query instead of mislabeling."""

    def __init__(self, shard, pids):
        self._shard = shard
        self._pids = pids
        self._epochs = shard.slot_epoch[pids].copy()

    def _check(self):
        if (self._shard.slot_epoch[self._pids] != self._epochs).any():
            raise QueryError("selection invalidated by concurrent partition "
                             "release (eviction/purge); retry the query")

    def __len__(self):
        return len(self._pids)

    def __getitem__(self, i):
        with self._shard.lock:
            self._check()
            if isinstance(i, slice):
                return [self._shard.rv_key_of(int(p)) for p in self._pids[i]]
            return self._shard.rv_key_of(int(self._pids[i]))

    def __iter__(self):
        with self._shard.lock:
            self._check()
            keys = [self._shard.rv_key_of(int(p)) for p in self._pids]
        return iter(keys)


def _group_ids_for(keys, rows, R, by, without):
    """Dense per-row group ids for aggregation: (gids [R], group key list,
    G). Rows outside the selection keep group 0 — their values are all-NaN
    or zero-count."""
    if len(keys) and not by and not without:
        return np.zeros(R, np.int32), [RangeVectorKey(())], 1
    gkeys = group_keys_of(keys, by, without)
    uniq: dict[RangeVectorKey, int] = {}
    gid_of_key = np.empty(len(gkeys), np.int32)
    for i, gk in enumerate(gkeys):
        gid_of_key[i] = uniq.setdefault(gk, len(uniq))
    G = max(len(uniq), 1)
    if not gkeys:
        gids = np.zeros(R, np.int32)
    elif rows is None:
        gids = gid_of_key
    else:
        gids = np.zeros(R, np.int32)
        gids[rows] = gid_of_key
    return gids, list(uniq), G


def group_keys_of(keys, by, without):
    """Aggregation group key per series (metric label always dropped)."""
    out = []
    for k in keys:
        k = k.without(("_metric_",))
        if by:
            out.append(k.only(by))
        elif without:
            out.append(k.without(without))
        else:
            out.append(RangeVectorKey(()))
    return out


@dataclass
class AggPartial:
    op: str
    out_ts: np.ndarray
    parts: object                   # dict name -> [Gpad, T], or PaddedPartials
    group_keys: list
    num_groups: int


def _segment_partial(op, values, gids, num_groups):
    """The composed path's map phase: the STABLE row-order group reduce, so
    the result does not depend on the padded step bucket."""
    return aggregators.partial_aggregate(op, values, gids, num_groups,
                                         stable=True)


@dataclass
class AggregateMapReduce(Transformer):
    """Map phase: matrix -> per-group partial state (ref: AggregateMapReduce)."""
    operator: str
    by: tuple = ()
    without: tuple = ()

    def apply(self, data, ctx):
        if isinstance(data, FusedWindowData):
            if self.operator in fusedgrid.FUSED_OPS:
                fused = self._apply_fused(data, ctx)
                if fused is not None:
                    return fused
            data = data.materialize()
        m = data if isinstance(data, MatrixView) else _as_mview(data)
        gids, uniq, G = _group_ids_for(m.keys, m.rows, m.values.shape[0],
                                       self.by, self.without)
        gid_t = torch.from_numpy(gids).to(m.values.device)
        parts = _segment_partial(self.operator, m.values, gid_t, _pow2(G))
        return AggPartial(self.operator, m.out_ts, parts, list(uniq), G)

    def _apply_fused(self, data: FusedWindowData, ctx) -> AggPartial | None:
        """Single-pass window + aggregation (ops/fusedgrid.py): partial
        state comes straight off the fused pass; churned minority rows are
        excluded there (n forced to 0) and folded in via the general path.
        None when the group count exceeds the fused cap."""
        sel = data.sel
        R = sel.val.shape[0]
        dev = sel.val.device
        gids, uniq, G = _group_ids_for(sel.keys, sel.rows, R, self.by,
                                       self.without)
        Gp = _pow2(G)
        if Gp > fusedgrid.MAX_GROUPS:
            fusedresident.count_fallback(
                fusedresident.scalar_shape_of(data.fn) or "rate_sum")
            return None
        base_ts, interval_ms = sel.grid
        n_eff = sel.n
        minority = sel.grid_minority
        has_minority = minority is not None and len(minority)
        if has_minority:
            n_eff = n_eff.clone()
            n_eff[torch.from_numpy(np.asarray(minority, np.int64)).to(dev)] = 0
        if G == 1 and not self.by and not self.without:
            gids_dev = fusedgrid.zero_gids(R, dev)   # cached: no per-query upload
        else:
            gids_dev = torch.from_numpy(gids).to(dev)
        # fetch=False: the leaf holds the shard lock through this launch —
        # the blocking host copy happens at present/merge time, outside it
        parts = fusedresident.scalar_aggregate(
            self.operator, data.fn, sel.val, n_eff, gids_dev, Gp,
            data.out_ts, data.window, base_ts, interval_ms, fetch=False)
        ctx.stats.add("fused_kernels")
        if has_minority:
            rows = np.asarray(minority, np.int64)
            sub_ts, sub_val, sub_n, P = _gather_rows_padded(sel.ts, sel.val,
                                                            sel.n, rows)
            corr = rangefns.periodic_samples(sub_ts, sub_val, sub_n,
                                             data.out_ts, data.window, data.fn)
            mgids = np.zeros(P, np.int32)
            mgids[:len(rows)] = gids[rows]
            mparts = _segment_partial(self.operator, corr,
                                      torch.from_numpy(mgids).to(dev), Gp)
            parts = aggregators.combine_partials(self.operator, parts, mparts)
        return AggPartial(self.operator, data.out_ts, parts, list(uniq), G)


def _as_mview(data) -> MatrixView:
    if isinstance(data, MatrixView):
        return data
    m = _as_matrix(data)
    return MatrixView(m.out_ts, m.values, m.keys, None)


@dataclass
class AggregatePresenter(Transformer):
    """Present phase (ref: AggregatePresenter in AggrOverRangeVectors.scala)."""
    operator: str

    def apply(self, data, ctx):
        if not isinstance(data, AggPartial):
            raise QueryError(f"{self.operator} over a full matrix not yet ported")
        vals = aggregators.present_partials(data.op, data.parts)[: data.num_groups]
        return ResultMatrix(data.out_ts, vals, data.group_keys)


def _as_matrix(data) -> ResultMatrix:
    if isinstance(data, ResultMatrix):
        return data
    if isinstance(data, FusedWindowData):
        return data.materialize().compact()
    if isinstance(data, MatrixView):
        return data.compact()
    if isinstance(data, AggPartial):
        raise QueryError("aggregate partial where matrix expected (missing presenter)")
    if isinstance(data, SeriesSelection):
        raise QueryError("raw series where matrix expected (missing periodic mapper)")
    raise TypeError(type(data))


# ---------------------------------------------------------------------------
# ExecPlans
# ---------------------------------------------------------------------------

@dataclass
class ExecPlan:
    transformers: list = field(default_factory=list)

    def execute(self, ctx: QueryContext):
        data = self.do_execute(ctx)
        for t in self.transformers:
            data = t.apply(data, ctx)
        return data

    def run(self, ctx: QueryContext) -> QueryResult:
        m = _as_matrix(self.execute(ctx)).to_host()
        check_sample_limit(m.num_series, len(m.out_ts), ctx.sample_limit)
        return QueryResult(m)

    def do_execute(self, ctx):  # pragma: no cover - interface
        raise NotImplementedError


def _shard_of_ctx(ctx, shard_num: int, column: str = ""):
    """The shard serving ``shard_num`` of the query's dataset, on the
    engine's device."""
    if column:
        raise QueryError("__col__ value-column selectors not yet ported")
    try:
        sh = ctx.memstore.shard(ctx.dataset, shard_num)
    except KeyError:
        raise QueryError(f"unknown dataset {ctx.dataset}") from None
    if sh.device != ctx.device:
        raise QueryError(f"shard {shard_num} of {ctx.dataset} lives on "
                         f"{sh.device}, the engine on {ctx.device}")
    return sh


@dataclass
class SelectRawPartitionsExec(ExecPlan):
    """The only data-reading leaf (ref: SelectRawPartitionsExec.scala)."""
    shard: int = 0
    filters: tuple = ()
    start_ms: int = 0
    end_ms: int = 0
    column: str = ""

    def execute(self, ctx: QueryContext):
        with span(SPAN_QUERY_LEAF, shard=self.shard):
            shard = _shard_of_ctx(ctx, self.shard, self.column)
            # hold the shard lock across tensor capture AND the transformer
            # chain's kernel launches: a concurrent flush mutates the store
            # tensors in place
            with shard.lock:
                result = super().execute(ctx)
                if isinstance(result, FusedWindowData):
                    # a lazy window view must not escape the lock
                    result = result.materialize()
            return result

    def do_execute(self, ctx) -> SeriesSelection:
        shard = _shard_of_ctx(ctx, self.shard, self.column)
        pids = shard.part_ids_from_filters(list(self.filters), self.start_ms,
                                           self.end_ms)
        ctx.stats.add("series_matched", len(pids))
        store = shard.store
        dev = store.device
        if len(pids) > GATHER_THRESHOLD:
            # wide selection: defer key materialization (global aggregates
            # never read them)
            keys = LazyKeys(shard, pids)
        else:
            keys = [shard.rv_key_of(int(p)) for p in pids]
        ts, val, n = store.arrays()
        total = len(shard.index)
        grid = store.grid_info()
        if len(pids) == 0:
            # synthetic pad selection: pad rows have n = 0, so every kernel
            # yields the empty result the real slice would
            return SeriesSelection(
                torch.full((8, 8), 1 << 62, dtype=torch.int64, device=dev),
                torch.zeros((8, 8), dtype=store.dtype, device=dev),
                torch.zeros(8, dtype=torch.int32, device=dev), [], None, None)
        # mixed start cohorts (churn): shift the grid base to the majority
        # cohort's start cell; the few minority rows are recorded so the
        # window step recomputes them generally. Too much churn => general
        # path outright.
        minority_sel = None
        if grid is not None:
            base, iv = grid
            kind, coh = store.grid_cohorts()
            if kind == "uniform":
                grid = (base + coh * iv, iv)
            else:
                goff = coh[pids]
                live = store.n_host[pids] > 0
                if live.any():
                    lv = goff[live]
                    u, cnts = np.unique(lv, return_counts=True)
                    o_maj = int(u[np.argmax(cnts)])
                    mins = live & (goff != o_maj)
                    m = int(mins.sum())
                    if m > 0.25 * int(live.sum()):
                        grid = None
                    else:
                        grid = (base + o_maj * iv, iv)
                        if m:
                            minority_sel = mins
        ctx.stats.add("blocks_raw")
        if len(pids) <= GATHER_THRESHOLD and len(pids) < 0.5 * max(total, 1):
            # narrow selection: gather rows once, padded to a power of two
            sel_ts, sel_val, sel_n, P = _gather_rows_padded(ts, val, n, pids)
            sel_rows = (None if P == len(pids)
                        else np.arange(len(pids), dtype=np.int32))
            g_min = (np.nonzero(minority_sel)[0].astype(np.int32)
                     if minority_sel is not None else None)
            return SeriesSelection(sel_ts, sel_val, sel_n, keys, sel_rows,
                                   grid, g_min)
        # wide selection: no gather — disable non-selected rows via n = 0
        if len(pids) == total:
            n_eff = n
        else:
            mask = np.zeros(store.S, bool)
            mask[pids] = True
            n_eff = torch.where(torch.from_numpy(mask).to(dev), n, 0)
        g_min = (pids[minority_sel].astype(np.int32)
                 if minority_sel is not None else None)
        return SeriesSelection(ts, val, n_eff, keys, pids.astype(np.int32),
                               grid, g_min)


@dataclass
class DistConcatExec(ExecPlan):
    """Concatenate child results (ref: DistConcatExec.scala — shard fan-in)."""
    children: list = field(default_factory=list)

    def do_execute(self, ctx):
        all_mats = [_as_matrix(c.execute(ctx)).to_host() for c in self.children]
        mats = [m for m in all_mats if m.num_series]
        if not mats:
            return all_mats[0]
        vals = np.concatenate([m.values for m in mats], axis=0)
        return ResultMatrix(mats[0].out_ts, vals,
                            [k for m in mats for k in m.keys])


@dataclass
class ReduceAggregateExec(ExecPlan):
    """Cross-shard reduce (ref: ReduceAggregateExec): children yield
    AggPartials; they merge group by group, then the presenter finishes."""
    operator: str = "sum"
    children: list = field(default_factory=list)

    def do_execute(self, ctx):
        results = [c.execute(ctx) for c in self.children]
        with span(SPAN_QUERY_REDUCE, op=self.operator,
                  children=len(self.children)), ctx.stats.stage("reduce"):
            if not all(isinstance(r, AggPartial) for r in results):
                raise QueryError(f"{self.operator} over full matrices not yet "
                                 "ported")
            return _merge_partials(self.operator, results)


def _merge_partials(op: str, partials: list[AggPartial]) -> AggPartial:
    """Align group keys across shards, then combine partial state on the
    host (partial state is [G, T], tiny)."""
    if len(partials) == 1:
        # single shard: stay lazy — the one host copy happens at present
        return partials[0]
    all_keys: dict[RangeVectorKey, int] = {}
    for p in partials:
        for k in p.group_keys:
            all_keys.setdefault(k, len(all_keys))
    G = max(len(all_keys), 1)
    Gpad = _pow2(G)
    out_ts = partials[0].out_ts
    T = len(out_ts)
    merged: dict[str, np.ndarray] = {}
    for p in partials:
        idx = np.array([all_keys[k] for k in p.group_keys], np.int32)
        rparts = aggregators.host_partials(aggregators.resolve_partials(p.parts))
        for name, arr in rparts.items():
            arr = np.asarray(arr)[: p.num_groups]
            fill = {"min": np.inf, "max": -np.inf}.get(name, 0.0)
            base = np.full((Gpad, T), fill)
            if len(idx):
                base[idx] = arr
            if name not in merged:
                merged[name] = base
            elif name == "min":
                merged[name] = np.minimum(merged[name], base)
            elif name == "max":
                merged[name] = np.maximum(merged[name], base)
            else:
                merged[name] = merged[name] + base
    return AggPartial(op, out_ts, merged, list(all_keys), G)
