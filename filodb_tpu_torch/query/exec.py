"""ExecPlan tree + RangeVectorTransformers: the physical query execution layer.

Port of the local path of ``filodb_tpu/query/exec.py`` (ref:
query/.../exec/ExecPlan.scala, SelectRawPartitionsExec.scala,
DistConcatExec / ReduceAggregateExec / BinaryJoinExec / SetOperatorExec,
RangeVectorTransformer.scala: PeriodicSamplesMapper, ScalarOperationMapper,
InstantVectorFunctionMapper, AggregateMapReduce / AggregatePresenter, the
sort and miscellaneous mappers).

Execution shape, as in the reference: the leaf resolves part ids host-side
(index), then hands the store's device tensors to the kernel chain. Narrow
selections gather rows; wide selections (the 1M-series aggregation) skip
the gather — rows outside the selection are disabled through a zeroed
sample count. On a grid-aligned f32 store, a window function followed by a
basic aggregation runs as ONE fused pass (ops/fusedgrid.py: K1 on the card);
on a scalar narrow-resident store that pass streams the narrow block
(delta8/quant16/delta16) and the cohort-pool rows fold back through the
general kernels. Other paths over a narrow-resident store decode a
transient f32 block (``_dval``).
Aggregation is host-computed dense group ids + one group reduce on device;
the order statistics (topk/bottomk, quantile, count_values) map to
per-shard partial state (candidates, a log-bucket sketch, value counts)
that merges at the reduce. Joins, set operators and the presenters work on
the children's host matrices, their element math on the query's device.
Histogram selections run the per-bucket range functions into [R, T, B]
matrices that carry their bucket tops (``bucket_les``) through the
bucket-wise sum/count/group reduce, ``histogram_quantile`` /
``histogram_max_quantile`` / ``histogram_bucket`` and the shard fan-in;
``histogram_quantile(q, sum(fn(h[w])))`` on one grid-aligned histogram
shard takes the engine's fused-hist route (query/engine.py) before the
planner. Subqueries, ``@`` and chunk-metadata plans are host reshapes
around the same kernels.

A selection that reaches behind a shard's resident rows pages its cold
chunks in from the durable sink (on-demand paging, as in the reference):
one batch when narrow, pid batches of ``ODP_BATCH`` when wide, each batch's
distributive transformers applied before the batches merge as shard
results do. A ``__col__`` that names no column of the dataset's schema
selects the per-aggregate dataset of a downsample family
(``ds:ds_1m:dAvg``).

A fan-in node's remote children (``query/wire.py``: a leaf or a
co-located reduce shipped to the peer that owns its shards, or a batch of
one peer's leaves) run concurrently on a pool of at most 16 threads, the
local ones on the calling thread; a batch's results splice back into its
members' original child positions, so the merge order, and with it the
bits, are the single node's.
"""

from __future__ import annotations

import contextlib
import re
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.chunkstore import COHORT_GATE, TS_PAD, _Deferred
from ..core.schemas import ColumnType
from ..ops import (aggregators, binop, fusedgrid, fusedresident, gridfns,
                   instantfns, rangefns)
from ..utils.metrics import FILODB_QUERY_SELECTION_RELEASE_RECHECKS, registry
from ..utils.tracing import (SPAN_QUERY_FETCH, SPAN_QUERY_LEAF,
                             SPAN_QUERY_ODP, SPAN_QUERY_REDUCE,
                             SPAN_QUERY_SELECT, span)
from .rangevector import (QueryError, QueryResult, QueryStats,
                          RangeVectorKey, ResultMatrix, fmt_value, to_numpy)

DEFAULT_SAMPLE_LIMIT = 1_000_000
GATHER_THRESHOLD = 8192      # selections narrower than this gather rows up front
ODP_BATCH = 4096             # wide on-demand paging proceeds in pid batches


@dataclass
class QueryContext:
    memstore: object
    dataset: str
    device: torch.device
    sample_limit: int = DEFAULT_SAMPLE_LIMIT
    stats: QueryStats = field(default_factory=QueryStats)
    exec_path: str | None = None
    stale_ms: int = 300_000        # instant-selector staleness lookback


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
    ts: object                # [R, C] int64 (or a deferred view)
    val: object               # [R, C] float, [R, C, B] buckets, or a view
    n: torch.Tensor           # [R] int32 (0 => row disabled)
    keys: list
    rows: np.ndarray | None
    grid: tuple | None = None  # (base_ts, interval_ms) => band-product path
    # array rows of live selected series whose start cell differs from the
    # majority cohort the grid base was shifted to (churn): recomputed
    # through the general kernels
    grid_minority: np.ndarray | None = None
    bucket_les: np.ndarray | None = None   # histogram bucket tops [B]
    # scalar narrow-resident store: (kind, ops, bad_rows) of the FULL [S, C]
    # value block (ops/decodereg.py variant, its tensors, the selected
    # cohort-pool rows) — the fused pass streams it; ``bad_rows`` recompute
    # through the general kernels. Wide selections only.
    narrow: tuple | None = None
    # hist-resident store: (dd, first_d, bad_rows) of the FULL [S, C, B]
    # bucket block (ops/narrow.py) — the fused-hist route streams it, so the
    # whole-store f32 block never materializes; ``bad_rows`` (cohort-pool
    # store rows) recompute via row-wise decode. Wide selections only.
    hist_narrow: tuple | None = None


@dataclass
class MatrixView:
    """Post-kernel matrix that may still be un-compacted (R >= P rows)."""
    out_ts: np.ndarray
    values: torch.Tensor      # [R, T] (or [R, T, B] for histogram results)
    keys: list
    rows: np.ndarray | None
    bucket_les: np.ndarray | None = None

    def compact(self) -> ResultMatrix:
        vals = self.values
        if self.rows is not None:
            rid = torch.from_numpy(np.asarray(self.rows, np.int64))
            vals = vals[rid.to(vals.device)]
        return ResultMatrix(self.out_ts, vals, self.keys, self.bucket_les)


def _pow2(n: int, floor: int = 8) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


def _dval(arr):
    """Materialize a compressed-resident store's deferred view (a transient
    f32 decode or i64 grid derivation); tensors pass through. The general
    paths funnel through here; the fused paths plan from shape metadata and
    never call it."""
    return arr.materialize() if isinstance(arr, _Deferred) else arr


def _gather_rows_padded(ts, val, n, rows: np.ndarray):
    """Gather the given rows padded to a pow2 row count. Pad rows are fully
    disabled: n = 0 AND timestamps forced to the pad sentinel (the general
    kernels derive windows from timestamps). Deferred (compressed-resident)
    blocks gather row-wise: a fix over a few rows must not materialize the
    full block."""
    M = len(rows)
    P = _pow2(M)
    pad = np.zeros(P, np.int64)
    pad[:M] = rows
    dev = val.device
    rid = torch.from_numpy(pad).to(dev)
    real = torch.arange(P, device=dev) < M
    n_g = torch.where(real, n[rid], 0).to(torch.int32)
    ts_rows = ts.gather_rows(rid) if isinstance(ts, _Deferred) else ts[rid]
    val_rows = val.gather_rows(rid) if isinstance(val, _Deferred) else val[rid]
    ts_g = torch.where(real[:, None], ts_rows, int(TS_PAD))
    return ts_g, val_rows, n_g, P


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
    stale_ms: int

    def materialize(self) -> MatrixView:
        base_ts, interval_ms = self.sel.grid
        out_eval, T = _pad_steps(self.out_ts)
        vals = gridfns.periodic_samples_grid(
            _dval(self.sel.val), self.sel.n, out_eval, self.window, self.fn,
            base_ts, interval_ms, stale_ms=self.stale_ms)
        minority = self.sel.grid_minority
        if minority is not None and len(minority):
            vals = _correct_minority_cohort(self.sel, vals, out_eval,
                                            self.window, self.fn, 0.0, 0.0)
        if vals.shape[1] != T:
            vals = vals[:, :T]
        return MatrixView(self.out_ts, vals, self.sel.keys, self.sel.rows)


def _correct_minority_cohort(data, vals, out_ts, window, fn, a0, a1,
                             hist: bool = False, rows=None):
    """Patch grid-kernel output for churned rows: series whose start cell
    differs from the majority cohort are recomputed through the general
    kernels (an [M, C] row gather) and written back into the [R, T]
    ([R, T, B]) result. ``rows`` overrides the row set (the churned
    minority merged with a hist-resident store's cohort-pool rows)."""
    rows = np.asarray(data.grid_minority if rows is None else rows, np.int64)
    M = len(rows)
    sub_ts, sub_val, sub_n, _ = _gather_rows_padded(data.ts, data.val,
                                                    data.n, rows)
    if hist:
        corr = rangefns.periodic_samples_hist(sub_ts, sub_val, sub_n, out_ts,
                                              window, fn, a0)
    else:
        corr = rangefns.periodic_samples(sub_ts, sub_val, sub_n, out_ts,
                                         window, fn, a0, a1)
    vals[torch.from_numpy(rows).to(vals.device)] = corr[:M].to(vals.dtype)
    return vals


# ---------------------------------------------------------------------------
# Transformers (ref: RangeVectorTransformer)
# ---------------------------------------------------------------------------

class Transformer:
    def apply(self, data, ctx: QueryContext):  # pragma: no cover - interface
        raise NotImplementedError


def _tensor(values, device) -> torch.Tensor:
    """A matrix block as a tensor on ``device``: device blocks pass
    through, host blocks (children already copied back) are copied up."""
    if isinstance(values, torch.Tensor):
        return values
    return torch.from_numpy(np.ascontiguousarray(values)).to(device)


@contextlib.contextmanager
def timed_hold(tags: dict):
    """Tag ``lock_held_us`` with how long the block runs. Entered first
    thing inside a leaf's outer ``with shard.lock``, it times that hold
    (the re-entrant acquisitions inside it are not timed apart)."""
    t0 = time.perf_counter_ns()
    try:
        yield
    finally:
        tags["lock_held_us"] = (time.perf_counter_ns() - t0) // 1000


def _fetch(site: str, values) -> np.ndarray:
    """``to_numpy(values)``; a tensor's blocking copy to the host runs
    under a ``query.exec.fetch`` span: there the host waits for every
    kernel queued ahead of it on the card."""
    if not isinstance(values, torch.Tensor):
        return np.asarray(values)
    with span(SPAN_QUERY_FETCH, site=site):
        return to_numpy(values)


@dataclass
class PeriodicSamplesMapper(Transformer):
    """Range/instant function evaluation (ref: PeriodicSamplesMapper.scala:23)."""
    start_ms: int
    step_ms: int
    end_ms: int
    window_ms: int | None     # None => instant selector (staleness lookback)
    function: str | None      # None => last_sample
    args: tuple = ()

    def out_ts(self) -> np.ndarray:
        step = max(self.step_ms, 1)
        return np.arange(self.start_ms, self.end_ms + 1, step, dtype=np.int64)

    def apply(self, data, ctx: QueryContext):
        assert isinstance(data, SeriesSelection), "PSM must sit directly on a leaf"
        out_ts = self.out_ts()
        if len(out_ts) == 0:
            return MatrixView(out_ts, torch.zeros((len(data.keys), 0)),
                              data.keys, data.rows, data.bucket_les)
        out_eval, T = _pad_steps(out_ts)
        fn = self.function or "last_sample"
        if fn == "last_sample":
            # instant selector: the window is the staleness lookback, which
            # is also the function's bound on the last sample's age
            window = ctx.stale_ms
            args = (float(ctx.stale_ms),)
        else:
            window = self.window_ms
            args = tuple(float(a) for a in self.args)
        a0 = args[0] if len(args) > 0 else 0.0
        a1 = args[1] if len(args) > 1 else 0.0
        grid_usable = (
            data.grid is not None
            and max(abs(int(out_ts[0]) - data.grid[0]),
                    abs(int(out_ts[-1]) - data.grid[0])) + window < 2**31)
        minority = data.grid_minority
        if data.bucket_les is not None:
            vals = self._apply_hist(data, ctx, out_eval, window, fn, a0,
                                    grid_usable)
            if len(out_eval) != T:
                vals = vals[:, :T]
            return MatrixView(out_ts, vals, data.keys, data.rows,
                              data.bucket_les)
        if grid_usable and fn in gridfns.GRID_FNS:
            S, C = data.val.shape
            if (fusedresident.mode() != "off"
                    and fusedresident.scalar_shape_of(fn) is not None
                    and data.val.dtype == torch.float32
                    and fusedgrid.fusable(S, C, len(out_ts), 1)):
                # defer: a following AggregateMapReduce fuses the window
                # function with the aggregation in one pass
                return FusedWindowData(data, out_ts, window, fn, ctx.stale_ms)
            base_ts, interval_ms = data.grid
            vals = gridfns.periodic_samples_grid(_dval(data.val), data.n,
                                                 out_eval, window, fn,
                                                 base_ts, interval_ms,
                                                 stale_ms=ctx.stale_ms)
            if minority is not None and len(minority):
                vals = _correct_minority_cohort(data, vals, out_eval, window,
                                                fn, a0, a1)
        else:
            vals = rangefns.periodic_samples(_dval(data.ts), _dval(data.val),
                                             data.n, out_eval, window, fn,
                                             a0, a1)
        if len(out_eval) != T:
            vals = vals[:, :T]
        return MatrixView(out_ts, vals, data.keys, data.rows)

    @staticmethod
    def _apply_hist(data, ctx, out_eval, window, fn, a0, grid_usable):
        """Per-bucket range function over a histogram selection: [R, T', B]
        (ref: PeriodicSamplesMapper's histogram branch). A grid-aligned
        store takes the grid kernels — off the i8/i16 2D-delta block on a
        hist-resident store, whose cohort-pool rows join the churned
        minority and recompute through the general kernels from a row-wise
        decode; an off-grid store takes the general kernels."""
        if fn not in rangefns.HIST_FNS:
            raise QueryError(f"function {fn} not supported on histogram series")
        if not (grid_usable and fn in gridfns.HIST_GRID_FNS):
            return rangefns.periodic_samples_hist(
                _dval(data.ts), _dval(data.val), data.n, out_eval, window,
                fn, a0)
        base_ts, interval_ms = data.grid
        minority = data.grid_minority
        if data.hist_narrow is not None:
            dd, first_d, bad = data.hist_narrow
            if len(bad):
                minority = (bad if minority is None or not len(minority)
                            else np.union1d(np.asarray(minority), bad))
            vals = gridfns.periodic_samples_grid_hist_narrow(
                dd, first_d, data.n, out_eval, window, fn, base_ts,
                interval_ms, stale_ms=ctx.stale_ms)
        else:
            vals = gridfns.periodic_samples_grid_hist(
                _dval(data.val), data.n, out_eval, window, fn, base_ts,
                interval_ms, stale_ms=ctx.stale_ms)
        if minority is not None and len(minority):
            vals = _correct_minority_cohort(data, vals, out_eval, window, fn,
                                            a0, 0.0, hist=True, rows=minority)
        return vals


@dataclass
class InstantVectorFunctionMapper(Transformer):
    function: str
    args: tuple = ()

    def apply(self, data, ctx):
        m = _as_matrix(data)
        if self.function in ("histogram_quantile", "histogram_bucket",
                             "histogram_max_quantile"):
            if m.bucket_les is None:
                if self.function == "histogram_quantile":
                    # classic le-labeled bucket series (what remote-write
                    # and the Influx gateway ingest): group by labels minus
                    # le, sort buckets, fix monotonicity, the same quantile
                    # algebra (ref: HistogramQuantileMapper.scala:23-90)
                    return _classic_le_quantile(m, float(self.args[0]))
                raise QueryError(
                    f"{self.function} requires native histogram series")
            les = np.asarray(m.bucket_les, np.float64)
            if self.function == "histogram_bucket":
                # the bucket whose top is nearest the argument (+Inf picks
                # the +Inf bucket: numpy's argmin stops at the NaN there)
                b = int(np.argmin(np.abs(les - self.args[0])))
                return ResultMatrix(m.out_ts, m.values[:, :, b], m.keys)
            vals = gridfns.histogram_quantile(float(self.args[0]), les,
                                              _tensor(m.values, ctx.device))
            return ResultMatrix(m.out_ts, vals, m.keys)
        if m.bucket_les is not None:
            raise QueryError(
                f"{self.function} not supported on histogram series")
        if self.function == "absent":
            vals = to_numpy(m.values)
            empty = (np.isnan(vals).all(axis=0) if len(m.keys)
                     else np.ones(len(m.out_ts), bool))
            out = np.where(empty, 1.0, np.nan)[None, :]
            return ResultMatrix(m.out_ts, out, [RangeVectorKey(())])
        vals = _tensor(m.values, ctx.device)
        return ResultMatrix(m.out_ts,
                            instantfns.apply(self.function, vals, self.args),
                            m.keys)


def _classic_le_quantile(m, q: float) -> ResultMatrix:
    """histogram_quantile over classic ``le``-labeled scalar bucket series
    (ref: HistogramQuantileMapper.scala:23-90 + Histogram.scala:288).

    Groups input series by labels minus ``le``, sorts each group's buckets
    by ascending le, repairs monotonicity (NaN or decreasing bucket rates
    take the running max — scrapes are not atomic across buckets), and
    computes the Prometheus quantile with the SAME algebra as the
    native-histogram path (ops/gridfns.histogram_quantile), on the host:
    group counts are dashboard-sized and the ragged per-group bucket
    layouts do not batch."""
    if not len(m.keys):
        return ResultMatrix(m.out_ts, np.zeros((0, len(m.out_ts))), [])
    vals = to_numpy(m.values).astype(np.float64)            # [R, T]
    groups: dict[RangeVectorKey, list[tuple[float, int]]] = {}
    for i, k in enumerate(m.keys):
        d = k.as_dict()
        le_s = d.get("le")
        if le_s is None:
            raise QueryError(
                "cannot calculate histogram quantile: 'le' tag is absent in "
                f"time series {d}")
        try:
            le = np.inf if le_s == "+Inf" else float(le_s)
        except ValueError:
            raise QueryError(
                f"cannot calculate histogram quantile: unparseable le tag "
                f"{le_s!r} in time series {d}") from None
        groups.setdefault(k.without(("le",)), []).append((le, i))
    T = len(m.out_ts)
    out = np.full((len(groups), T), np.nan)
    keys = list(groups)
    for g, gk in enumerate(keys):
        buckets = sorted(groups[gk], key=lambda p: p[0])
        les = np.array([b[0] for b in buckets])
        if not np.isinf(les[-1]):
            continue              # no +Inf bucket: quantile undefined (NaN)
        counts = vals[[b[1] for b in buckets]].T            # [T, B] cumulative
        # makeMonotonic: running max along the bucket axis, floor 0 — NaN
        # and regressions (bucket churn, non-atomic scrapes) take the prior max
        counts = np.maximum.accumulate(
            np.where(np.isnan(counts), -np.inf, counts), axis=1)
        counts = np.maximum(counts, 0.0)
        out[g] = gridfns.histogram_quantile(
            q, les, torch.from_numpy(counts)).numpy()
    return ResultMatrix(m.out_ts, out, keys)


@dataclass
class ScalarOperationMapper(Transformer):
    operator: str
    scalar: object            # a float, or the ExecPlan of a step-varying scalar
    scalar_is_lhs: bool = False

    _resolved = None

    def prepare(self, ctx) -> None:
        """Resolve a step-varying scalar subplan (time(), scalar(v)) ONCE
        per query. The leaf calls this BEFORE it takes its shard lock:
        running the subplan inside it would nest shard locks across queries
        (ABBA deadlock)."""
        if isinstance(self.scalar, ExecPlan) and self._resolved is None:
            sm = _as_matrix(self.scalar.execute(ctx)).to_host()
            self._resolved = np.asarray(sm.values, np.float64)[0]

    def apply(self, data, ctx):
        m = _as_matrix(data)
        s = self.scalar
        vals = _tensor(m.values, ctx.device)
        if isinstance(s, ExecPlan):
            self.prepare(ctx)     # non-leaf chains have no lock to avoid
            s = torch.from_numpy(self._resolved).to(ctx.device)  # [T]
            # the step-varying scalar is f64 and so is the answer: it must
            # not depend on whether the operand matrix crossed the wire
            # (f64) or came off a local store (its dtype)
            vals = vals.to(torch.float64)
        vals = binop.apply_scalar_op(self.operator, s, vals,
                                     self.scalar_is_lhs)
        keys = m.keys
        op = self.operator.removesuffix("_bool")
        if op in binop.MATH_OPS or self.operator.endswith("_bool"):
            keys = [k.without(("_metric_",)) for k in keys]
        return ResultMatrix(m.out_ts, vals, keys)


class LazyKeys:
    """Sequence of RangeVectorKeys materialized on first access: a 1M-series
    sum() must not pay a Python loop over every series at the leaf. The
    shard's release epoch captured at leaf time detects a concurrent
    eviction reusing a selected slot and fails the query instead of
    mislabeling; the capture is O(1), and a key read looks at the selected
    slots only when some release came after it."""

    def __init__(self, shard, pids):
        self._shard = shard
        self._pids = pids
        self._e0 = shard._release_epoch

    def _check(self):
        shard = self._shard
        if shard._release_epoch == self._e0:
            return
        registry.counter(FILODB_QUERY_SELECTION_RELEASE_RECHECKS,
                         {"dataset": shard.dataset,
                          "shard": str(shard.shard_num)}).increment()
        if (shard.slot_released_at[self._pids] > self._e0).any():
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

    def take(self, idx) -> list:
        """The keys at positions ``idx``: one lock and one release check
        for all of them."""
        with self._shard.lock:
            self._check()
            return [self._shard.rv_key_of(int(self._pids[i])) for i in idx]


def _keys_at(keys, idx) -> list:
    """``[keys[i] for i in idx]``; a wide selection's LazyKeys takes its
    lock and its release check once, not once a key."""
    if isinstance(keys, LazyKeys):
        return keys.take(idx)
    return [keys[i] for i in idx]


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
    parts: object                   # dict name -> [Gpad, T] ([Gpad, T*B]
                                    # for histograms), or PaddedPartials
    group_keys: list
    num_groups: int
    bucket_les: np.ndarray | None = None


def _segment_partial(op, values, gids, num_groups):
    """The composed path's map phase: the STABLE row-order group reduce, so
    the result does not depend on the padded step bucket."""
    return aggregators.partial_aggregate(op, values, gids, num_groups,
                                         stable=True)


@dataclass
class AggregateMapReduce(Transformer):
    """Map phase: matrix -> per-group partial state (ref: AggregateMapReduce)."""
    operator: str
    params: tuple = ()
    by: tuple = ()
    without: tuple = ()

    # order-statistic aggregators with more groups fall back to full
    # matrices; G is small in practice (topk is usually global)
    ORDER_STAT_MAX_GROUPS = 64

    def apply(self, data, ctx):
        if self.operator in ("topk", "bottomk", "quantile", "count_values"):
            return self._map_order_stat(data, ctx)
        if isinstance(data, FusedWindowData):
            if self.operator in fusedgrid.FUSED_OPS:
                fused = self._apply_fused(data, ctx)
                if fused is not None:
                    return fused
            data = data.materialize()
        m = _as_mview(data)
        gids, uniq, G = _group_ids_for(m.keys, m.rows, m.values.shape[0],
                                       self.by, self.without)
        vals = _tensor(m.values, ctx.device)
        les = m.bucket_les
        if les is not None:
            if self.operator not in ("sum", "count", "group"):
                raise QueryError(
                    f"{self.operator} not supported on histograms")
            R, T, B = vals.shape
            vals = vals.reshape(R, T * B)      # bucket-wise reduce (hSum)
        gid_t = torch.from_numpy(gids).to(vals.device)
        parts = _segment_partial(self.operator, vals, gid_t, _pow2(G))
        return AggPartial(self.operator, m.out_ts, parts, list(uniq), G, les)

    def _apply_fused(self, data: FusedWindowData, ctx) -> AggPartial | None:
        """Single-pass window + aggregation (ops/fusedgrid.py): partial
        state comes straight off the fused pass; churned minority rows and a
        narrow store's cohort-pool rows are excluded there (n forced to 0)
        and folded in via the general path. None when the group count
        exceeds the fused cap."""
        sel = data.sel
        R = sel.val.shape[0]
        dev = sel.n.device
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
        narrow = None
        if sel.narrow is not None:
            # rows that don't round-trip bit-exactly join the minority set:
            # excluded from the kernel, recomputed by the general path below
            kind, nops, bad = sel.narrow
            narrow = (kind, nops)
            if len(bad):
                minority = (bad if minority is None or not len(minority)
                            else np.union1d(np.asarray(minority), bad))
        has_minority = minority is not None and len(minority)
        if has_minority:
            n_eff = n_eff.clone()
            n_eff[torch.from_numpy(np.asarray(minority, np.int64)).to(dev)] = 0
        if G == 1 and not self.by and not self.without:
            gids_dev = fusedgrid.zero_gids(R, dev)   # cached: no per-query upload
        else:
            gids_dev = torch.from_numpy(gids).to(dev)
        # fetch=False: the leaf holds the shard lock through this launch —
        # the blocking host copy happens at present/merge time, outside it.
        # With narrow operands the kernel streams the narrow block and
        # sel.val stays a deferred view (shape metadata only)
        parts = fusedresident.scalar_aggregate(
            self.operator, data.fn,
            sel.val if narrow is not None else _dval(sel.val),
            n_eff, gids_dev, Gp, data.out_ts, data.window, base_ts,
            interval_ms, fetch=False, narrow=narrow)
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

    def _map_order_stat(self, data, ctx):
        """Map phase for topk/bottomk/quantile/count_values: per-shard
        partial state instead of shipping the full [P, T] matrix to the
        reduce (ref: RowAggregator partial state incl. t-digest,
        AggrOverRangeVectors.scala:244-)."""
        if isinstance(data, FusedWindowData):
            data = data.materialize()
        return _order_stat_map(_as_mview(data), self.operator, self.params,
                               self.by, self.without, ctx.device,
                               cap=self.ORDER_STAT_MAX_GROUPS)


# quantile partial memory gate: fall back to the exact full matrix when the
# dense sketch would dwarf what it replaces
_SKETCH_BYTES_CAP = 64 << 20


def _order_stat_map(m: MatrixView, op, params, by, without, device,
                    cap=None):
    """Shared map phase; with ``cap`` set, large group counts (or oversized
    sketches) fall back to the exact full matrix. The reduce calls this
    WITHOUT a cap to normalize a fallen-back shard into partial form when
    its siblings produced partials."""
    if m.bucket_les is not None:
        raise QueryError(f"{op} not supported on histograms")
    R = m.values.shape[0]
    gids, uniq, G = _group_ids_for(m.keys, m.rows, R, by, without)
    T = len(m.out_ts)
    if cap is not None and G > cap:
        return m.compact()               # exact full-matrix fallback
    if op in ("topk", "bottomk"):
        k = max(int(params[0]), 0)       # topk(0, ...) selects nothing
        return _map_topk(m, gids, uniq, G, k, op == "bottomk", device)
    if op == "quantile":
        # the bytes gate holds even for reduce-side normalization (cap=None):
        # a dense sketch for a huge group count must never be allocated
        if G * aggregators.SKETCH_WIDTH * T * 4 > _SKETCH_BYTES_CAP:
            return m.compact()
        vals = _tensor(m.values, device)
        counts = aggregators.quantile_sketch(
            vals, torch.from_numpy(gids).to(vals.device), G)
        return SketchPartial(float(params[0]), m.out_ts, list(uniq), counts)
    # count_values: vectorized host histogram of distinct values
    vals_h = to_numpy(m.values)
    label = str(params[0])
    present = ~np.isnan(vals_h)
    p_idx, t_idx = np.nonzero(present)
    v = vals_h[p_idx, t_idx]
    g = gids[p_idx] if len(gids) else np.zeros(0, np.int32)
    uvals, vinv = np.unique(v, return_inverse=True)
    pair = g.astype(np.int64) * max(len(uvals), 1) + vinv
    upairs, pinv = np.unique(pair, return_inverse=True)
    counts = np.zeros((len(upairs), T))
    np.add.at(counts, (pinv, t_idx), 1.0)
    entries: dict = {}
    for i, pr in enumerate(upairs):
        gi, vi = divmod(int(pr), max(len(uvals), 1))
        key = (gi, fmt_value(uvals[vi]))
        # distinct floats could share a rendering: counts accumulate
        if key in entries:
            entries[key] = entries[key] + counts[i]
        else:
            entries[key] = counts[i]
    return CountValuesPartial(label, m.out_ts, list(uniq), entries)


def _map_topk(m: MatrixView, gids, uniq, G: int, k: int, bottom: bool,
              device):
    """Per-shard top-k candidates per (group, step): [G, k, T] values + key
    refs — only k series' worth of data crosses the reduce. Presence is an
    exact per-slot mask (selected row AND non-NaN), so real +/-Inf samples
    survive and un-selected pad rows never leak in. Among equal values the
    lower row ranks first (a stable sort, as the reference's top_k)."""
    T0 = len(m.out_ts)
    R = m.values.shape[0]
    if k == 0 or not len(m.keys):
        return TopKPartial(k, bottom, m.out_ts, list(uniq),
                           np.full((G, 0, T0), np.nan),
                           np.full((G, 0, T0), -1, np.int64), [])
    # array row -> key index (rows may be a non-identity store-row mapping)
    valid_rows = np.zeros(R, bool)
    if m.rows is None:
        valid_rows[:len(m.keys)] = True
        row_to_key = None
    else:
        valid_rows[m.rows] = True
        row_to_key = np.full(R, -1, np.int64)
        row_to_key[m.rows] = np.arange(len(m.rows))
    vals = _tensor(m.values, device).to(torch.float64)
    dev = vals.device
    nanmask = torch.isnan(vals)
    vmask = torch.from_numpy(valid_rows).to(dev)
    garr = torch.from_numpy(np.asarray(gids)).to(dev)
    fill = float("inf") if bottom else float("-inf")
    fmax = float(np.finfo(np.float64).max)
    # real +/-Inf samples must outrank fill rows at equal sort value: clamp
    # them to +/-DBL_MAX in the SORT domain only (reported values come from
    # the original matrix via the selected indices)
    sortable = torch.clamp(vals, -fmax, fmax)
    out_vals = np.full((G, k, T0), np.nan)
    out_ref = np.full((G, k, T0), -1, np.int64)
    key_rows: list[int] = []
    row_slot: dict[int, int] = {}
    kk = min(k, R)
    for g in range(G):
        presence = (vmask & (garr == g))[:, None] & ~nanmask     # [R, T]
        gv = torch.where(presence, sortable, fill)
        sv = -gv if bottom else gv
        top_i = torch.sort(sv.T, dim=1, descending=True,
                           stable=True).indices[:, :kk]          # [T, kk]
        top_ok = torch.gather(presence.T, 1, top_i)              # exact mask
        # ONE host copy for the three small arrays
        host = _fetch("order_stats",
                      torch.stack([torch.gather(vals.T, 1, top_i),
                                   top_i.to(torch.float64),
                                   top_ok.to(torch.float64)]))
        top_v, top_r, ok = host[0], host[1].astype(np.int64), host[2] > 0
        for t, s in zip(*np.nonzero(ok)):
            row = int(top_r[t, s])
            slot = row_slot.get(row)
            if slot is None:
                slot = row_slot[row] = len(key_rows)
                key_rows.append(row)
            out_vals[g, s, t] = top_v[t, s]
            out_ref[g, s, t] = slot
    ki = (key_rows if row_to_key is None
          else row_to_key[np.asarray(key_rows, np.int64)].tolist())
    key_table = _keys_at(m.keys, ki)
    return TopKPartial(k, bottom, m.out_ts, list(uniq), out_vals, out_ref,
                       key_table)


@dataclass
class TopKPartial:
    """topk/bottomk partial state: per (group, slot, step) candidate values
    and their source-series keys."""
    k: int
    bottom: bool
    out_ts: np.ndarray
    group_keys: list
    values: np.ndarray            # [G, k, T] f64, NaN = empty slot
    key_ref: np.ndarray           # [G, k, T] int64 into key_table, -1 = empty
    key_table: list


@dataclass
class SketchPartial:
    """quantile partial state: log-bucket counts [G, W, T] (a device tensor
    off the map phase, a host array once merged)."""
    q: float
    out_ts: np.ndarray
    group_keys: list
    counts: object


@dataclass
class CountValuesPartial:
    """count_values partial state: (group, value-string) -> [T] counts."""
    label: str
    out_ts: np.ndarray
    group_keys: list
    entries: dict                  # (gid, vstr) -> np[T]


@dataclass
class _WideODP:
    """do_execute marker: the selection needs wide on-demand paging. The
    leaf's execute() pages it in batches outside the long-held shard
    lock."""
    pids: np.ndarray


@dataclass
class _NarrowODP:
    """do_execute marker: a narrow selection that needs paging, with its
    keys and the resident rows gathered under the shard lock
    (``TimeSeriesShard.gather_resident_locked``). execute() reads the cold
    chunks and makes the host copy after the lock is released."""
    pids: np.ndarray
    keys: list
    gathered: tuple


def _merge_heterogeneous(results, op, params, by, without, device):
    """Merge a mixed list of aggregation partials (normalizing any member
    that fell back to a full matrix). Returns None when no partials are
    present — the caller concatenates matrices instead."""
    if results and all(isinstance(r, AggPartial) for r in results):
        return _merge_partials(op, results)
    kinds = {TopKPartial: _merge_topk, SketchPartial: _merge_sketch,
             CountValuesPartial: _merge_count_values}
    for kind, merge in kinds.items():
        if not any(isinstance(r, kind) for r in results):
            continue
        norm = [r if isinstance(r, kind)
                else _order_stat_map(_as_mview(r), op, params, by, without,
                                     device)
                for r in results]
        if not all(isinstance(r, kind) for r in norm):
            # normalization refused (a quantile sketch over the memory
            # gate): partial state cannot be turned back into a matrix, so
            # fail loudly rather than merge wrong
            raise QueryError(f"{op} grouping too wide to merge across shards; "
                             "narrow the by() clause")
        return merge(norm)
    return None


def _as_mview(data) -> MatrixView:
    if isinstance(data, MatrixView):
        return data
    m = _as_matrix(data)
    return MatrixView(m.out_ts, m.values, m.keys, None, m.bucket_les)


def _align_groups(parts):
    """Union group-key space across shard partials: (mapping, G)."""
    all_groups: dict[RangeVectorKey, int] = {}
    for p in parts:
        for gk in p.group_keys:
            all_groups.setdefault(gk, len(all_groups))
    return all_groups, max(len(all_groups), 1)


def _merge_sketch(parts: list[SketchPartial]) -> SketchPartial:
    first = parts[0]
    all_groups, G = _align_groups(parts)
    counts = [to_numpy(p.counts) for p in parts]
    W, T = counts[0].shape[1], counts[0].shape[2]
    merged = np.zeros((G, W, T), np.float32)
    for p, c in zip(parts, counts):
        for gi, gk in enumerate(p.group_keys):
            merged[all_groups[gk]] += c[gi]
    return SketchPartial(first.q, first.out_ts, list(all_groups), merged)


def _merge_count_values(parts: list[CountValuesPartial]) -> CountValuesPartial:
    first = parts[0]
    all_groups, _G = _align_groups(parts)
    entries: dict = {}
    for p in parts:
        remap = [all_groups[gk] for gk in p.group_keys]
        for (gi, vstr), row in p.entries.items():
            key = (remap[gi] if remap else 0, vstr)
            if key in entries:
                entries[key] = entries[key] + row
            else:
                entries[key] = row
    return CountValuesPartial(first.label, first.out_ts, list(all_groups),
                              entries)


def _merge_topk(parts: list[TopKPartial]) -> TopKPartial:
    first = parts[0]
    all_groups, G = _align_groups(parts)
    T = len(first.out_ts)
    k = first.k
    key_table: list = []
    cand_v = np.full((G, 0, T), np.nan)
    cand_r = np.full((G, 0, T), -1, np.int64)
    for p in parts:
        off = len(key_table)
        key_table.extend(p.key_table)
        pv = np.full((G, p.values.shape[1], T), np.nan)
        pr = np.full((G, p.values.shape[1], T), -1, np.int64)
        for gi, gk in enumerate(p.group_keys):
            gg = all_groups[gk]
            pv[gg] = p.values[gi]
            pr[gg] = np.where(p.key_ref[gi] >= 0, p.key_ref[gi] + off, -1)
        cand_v = np.concatenate([cand_v, pv], axis=1)
        cand_r = np.concatenate([cand_r, pr], axis=1)
    # re-select the top k among the candidates per (group, step); real
    # +/-Inf candidates clamp to +/-DBL_MAX in the sort domain so empty
    # (fill) slots never displace them on ties
    fill = np.inf if first.bottom else -np.inf
    fmax = np.finfo(np.float64).max
    sv = np.where(np.isnan(cand_v), fill, np.clip(cand_v, -fmax, fmax))
    sv = sv if first.bottom else -sv                    # ascending sort picks
    order = np.argsort(sv, axis=1, kind="stable")[:, :k, :]
    out_v = np.take_along_axis(cand_v, order, axis=1)
    out_r = np.take_along_axis(cand_r, order, axis=1)
    return TopKPartial(k, first.bottom, first.out_ts, list(all_groups),
                       out_v, out_r, key_table)


def _present_topk(p: TopKPartial) -> ResultMatrix:
    """Emit the union of selected source series, each with its value at
    steps where it made the top k (Prometheus topk keeps original labels)."""
    T = len(p.out_ts)
    rows: dict[RangeVectorKey, int] = {}
    out: list[np.ndarray] = []
    G, k, _ = p.values.shape
    for g in range(G):
        for s in range(k):
            for t in range(T):
                ref = p.key_ref[g, s, t]
                if ref < 0 or np.isnan(p.values[g, s, t]):
                    continue
                key = p.key_table[ref]
                r = rows.get(key)
                if r is None:
                    r = rows[key] = len(out)
                    out.append(np.full(T, np.nan))
                out[r][t] = p.values[g, s, t]
    if not out:
        return ResultMatrix(p.out_ts, np.zeros((0, T)), [])
    return ResultMatrix(p.out_ts, np.stack(out), list(rows))


@dataclass
class AggregatePresenter(Transformer):
    """Present phase (ref: AggregatePresenter in AggrOverRangeVectors.scala)."""
    operator: str
    params: tuple = ()
    by: tuple = ()
    without: tuple = ()

    def apply(self, data, ctx):
        if isinstance(data, AggPartial):
            vals = aggregators.present_partials(data.op, data.parts)[: data.num_groups]
            if data.bucket_les is not None:
                vals = vals.reshape(vals.shape[0], -1, len(data.bucket_les))
            return ResultMatrix(data.out_ts, vals, data.group_keys,
                                data.bucket_les)
        if isinstance(data, TopKPartial):
            return _present_topk(data)
        if isinstance(data, SketchPartial):
            vals = aggregators.present_quantile_sketch(
                _fetch("sketch", data.counts), data.q)
            return ResultMatrix(data.out_ts, vals, data.group_keys)
        if isinstance(data, CountValuesPartial):
            T = len(data.out_ts)
            keys, rows = [], []
            for (gi, vstr), row in data.entries.items():
                gk = (data.group_keys[gi] if data.group_keys
                      else RangeVectorKey(()))
                keys.append(RangeVectorKey(tuple(sorted(
                    dict(gk.labels, **{data.label: vstr}).items()))))
                rows.append(np.where(row > 0, row, np.nan))
            if not keys:
                return ResultMatrix(data.out_ts, np.zeros((0, T)), [])
            return ResultMatrix(data.out_ts, np.stack(rows), keys)
        # full-matrix aggregators (the map phase fell back past its caps)
        m = _as_matrix(data)
        gkeys = group_keys_of(m.keys, self.by, self.without)
        uniq: dict[RangeVectorKey, int] = {}
        gids = np.empty(len(gkeys), np.int32)
        for i, gk in enumerate(gkeys):
            gids[i] = uniq.setdefault(gk, len(uniq))
        G = max(len(uniq), 1)
        if self.operator in ("topk", "bottomk", "quantile"):
            vals = _tensor(m.values, ctx.device)
            gid_t = torch.from_numpy(gids).to(vals.device)
        if self.operator in ("topk", "bottomk"):
            mask = aggregators.topk_mask(vals, gid_t, _pow2(G),
                                         int(self.params[0]),
                                         bottom=self.operator == "bottomk")
            return ResultMatrix(m.out_ts,
                                torch.where(mask, vals, float("nan")), m.keys)
        if self.operator == "quantile":
            vals = aggregators.group_quantile(vals, gid_t, _pow2(G),
                                              float(self.params[0]))
            return ResultMatrix(m.out_ts, vals[:G], list(uniq))
        if self.operator == "count_values":
            return _count_values(m, gkeys, str(self.params[0]))
        raise QueryError(f"unknown aggregator {self.operator}")


def _count_values(m: ResultMatrix, gkeys, label: str) -> ResultMatrix:
    """count_values over a full matrix (host: the output cardinality is
    data-dependent)."""
    vals = to_numpy(m.values)
    T = len(m.out_ts)
    out: dict[RangeVectorKey, np.ndarray] = {}
    for p, gk in enumerate(gkeys):
        for t in range(T):
            v = vals[p, t]
            if np.isnan(v):
                continue
            vstr = fmt_value(v)
            key = RangeVectorKey(tuple(sorted(dict(gk.labels, **{label: vstr}).items())))
            row = out.setdefault(key, np.full(T, np.nan))
            row[t] = (0 if np.isnan(row[t]) else row[t]) + 1
    if not out:
        return ResultMatrix(m.out_ts, np.zeros((0, T)), [])
    return ResultMatrix(m.out_ts, np.stack(list(out.values())), list(out))


@dataclass
class SortFunctionMapper(Transformer):
    function: str                  # sort / sort_desc

    def apply(self, data, ctx):
        m = _as_matrix(data).to_host()
        if not m.keys:
            return m
        with np.errstate(all="ignore"):
            sortkey = np.nanmean(m.values, axis=1)
        sortkey = np.where(np.isnan(sortkey), -np.inf, sortkey)
        order = np.argsort(sortkey, kind="stable")
        if self.function == "sort_desc":
            order = order[::-1]
        return ResultMatrix(m.out_ts, m.values[order], [m.keys[i] for i in order])


@dataclass
class MiscellaneousFunctionMapper(Transformer):
    function: str
    str_args: tuple = ()

    def apply(self, data, ctx):
        m = _as_matrix(data)
        if self.function == "timestamp":
            vals = to_numpy(m.values)
            out = np.where(np.isnan(vals), np.nan,
                           (m.out_ts[None, :] / 1000.0))
            return ResultMatrix(m.out_ts, out,
                                [k.without(("_metric_",)) for k in m.keys])
        if self.function == "label_replace":
            dst, repl, src, regex = self.str_args
            pat = re.compile(regex)
            keys = []
            for k in m.keys:
                d = k.as_dict()
                mo = pat.fullmatch(d.get(src, ""))
                if mo:
                    newval = mo.expand(_go_to_py_template(repl))
                    if newval:
                        d[dst] = newval
                    else:
                        d.pop(dst, None)
                keys.append(RangeVectorKey.of(d))
            return ResultMatrix(m.out_ts, m.values, keys)
        if self.function == "label_join":
            dst, sep, *srcs = self.str_args
            keys = []
            for k in m.keys:
                d = k.as_dict()
                d[dst] = sep.join(d.get(s, "") for s in srcs)
                keys.append(RangeVectorKey.of(d))
            return ResultMatrix(m.out_ts, m.values, keys)
        raise QueryError(f"unknown misc function {self.function}")


def _go_to_py_template(s: str) -> str:
    """Convert a Go regexp replacement ($1, ${name}) to Python (\\1, \\g<name>)."""
    return re.sub(r"\$(\d+)", r"\\\1", re.sub(r"\$\{(\w+)\}", r"\\g<\1>", s))


def _as_matrix(data) -> ResultMatrix:
    if isinstance(data, ResultMatrix):
        return data
    if isinstance(data, FusedWindowData):
        return data.materialize().compact()
    if isinstance(data, MatrixView):
        return data.compact()
    if isinstance(data, (AggPartial, TopKPartial, SketchPartial,
                         CountValuesPartial)):
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
        m = _as_matrix(self.execute(ctx))
        m = ResultMatrix(m.out_ts, _fetch("result", m.values), m.keys,
                         m.bucket_les)
        check_sample_limit(m.num_series, len(m.out_ts), ctx.sample_limit)
        return QueryResult(m)

    def do_execute(self, ctx):  # pragma: no cover - interface
        raise NotImplementedError


def _shard_of_ctx(ctx, shard_num: int, column: str = ""):
    """(shard, store column) serving ``shard_num`` of the query's dataset,
    on the engine's device. A ``__col__`` naming a column of the dataset's
    own schema selects that column of its store (``{__col__="sum"}`` on
    prom-histogram); naming the one value column of a single-column schema
    is the default selection (None). Any other column targets the
    per-aggregate dataset of a downsample family (``ds:ds_1m:dAvg``, the
    layout before multi-column families)."""
    sh = col = None
    if column:
        try:
            own = ctx.memstore.shard(ctx.dataset, shard_num)
        except KeyError:
            own = None
        if own is not None and own.schema.column_named(column) is not None:
            sh = own
            if own.schema.is_multi_column:
                col = column
    if sh is None:
        ds = f"{ctx.dataset}:{column}" if column else ctx.dataset
        try:
            sh = ctx.memstore.shard(ds, shard_num)
        except KeyError:
            raise QueryError(
                f"unknown {'column ' + column + ' of ' if column else ''}"
                f"dataset {ds}") from None
    if sh.device != ctx.device:
        raise QueryError(f"shard {shard_num} of {ctx.dataset} lives on "
                         f"{sh.device}, the engine on {ctx.device}")
    return sh, col


def _store_prefix(transformers) -> int:
    """How many leading transformers of a leaf read the store's tensors:
    the periodic mapper, and a basic aggregation right after it (its fused
    pass streams the store). They run under the shard lock; the rest work
    on the fresh matrices those produce, after it — so their host copies
    (order-statistic candidates, sort keys) never stall the shard."""
    if not transformers or not isinstance(transformers[0],
                                          PeriodicSamplesMapper):
        return len(transformers)
    if (len(transformers) > 1
            and isinstance(transformers[1], AggregateMapReduce)
            and transformers[1].operator in aggregators.BASIC_OPS):
        return 2
    return 1


@dataclass
class SelectRawPartitionsExec(ExecPlan):
    """The only data-reading leaf (ref: SelectRawPartitionsExec.scala)."""
    shard: int = 0
    filters: tuple = ()
    start_ms: int = 0
    end_ms: int = 0
    column: str = ""

    def execute(self, ctx: QueryContext):
        with span(SPAN_QUERY_LEAF, shard=self.shard) as leaf_tags:
            shard, _col = _shard_of_ctx(ctx, self.shard, self.column)
            if shard.recovering:
                # partial data: the root's negative cache must know an
                # empty selection proves nothing
                ctx.stats.add("recovering_shards")
            # step-varying scalar operands resolve BEFORE the lock: their
            # subplans take other shards' locks (nested acquisition would
            # ABBA-deadlock two concurrent mirror-image queries)
            for t in self.transformers:
                if isinstance(t, ScalarOperationMapper):
                    t.prepare(ctx)
            n_store = _store_prefix(self.transformers)
            # hold the shard lock across tensor capture AND the launches
            # that read the store: a concurrent flush mutates the store
            # tensors in place
            with shard.lock, timed_hold(leaf_tags):
                data = self.select(ctx)
                if isinstance(data, (_WideODP, _NarrowODP)):
                    n_store = 0       # paged data is the leaf's own copy
                else:
                    for t in self.transformers[:n_store]:
                        data = t.apply(data, ctx)
                    if isinstance(data, FusedWindowData):
                        # a lazy window view must not escape the lock
                        data = data.materialize()
            if isinstance(data, _WideODP):
                # batched paging runs outside the long-held lock: each batch
                # re-locks only around its resident gather
                return self._paged_batches(ctx, shard, data.pids, _col)
            if isinstance(data, _NarrowODP):
                data = self._paged_selection(shard, data.pids, data.keys,
                                             data.gathered, column=_col)
            for t in self.transformers[n_store:]:
                data = t.apply(data, ctx)
            return data

    def _paged_selection(self, shard, pids, keys, gathered, cold=None,
                         column=None) -> SeriesSelection:
        """The paged selection of ``pids``: cold chunks from the sink (read
        here unless given) merged with the rows gathered under the lock,
        one host copy, back on the shard's device in f64. Call without the
        shard lock."""
        tier = ("remote" if getattr(shard.sink, "remote_tier", False)
                else "local")
        with span(SPAN_QUERY_ODP, shard=self.shard, series=len(pids),
                  tier=tier):
            if cold is None:
                cold = shard.read_cold_for(pids, self.start_ms, self.end_ms)
            ts_h, val_h, n_h = shard.merge_paged(pids, gathered, cold, column)
        dev = shard.device
        return SeriesSelection(torch.from_numpy(ts_h).to(dev),
                               torch.from_numpy(val_h).to(dev),
                               torch.from_numpy(n_h).to(dev), keys, None,
                               None)

    @staticmethod
    def _batch_distributive(t) -> bool:
        """True when applying ``t`` per pid batch then merging equals
        applying it to the whole selection (row-wise transforms and the
        aggregation map phase are; absent() and sort need the whole)."""
        if isinstance(t, (PeriodicSamplesMapper, AggregateMapReduce,
                          ScalarOperationMapper)):
            return True
        if isinstance(t, InstantVectorFunctionMapper):
            return t.function != "absent"
        return False

    def _paged_batches(self, ctx, shard, pids, column=None):
        """Wide on-demand paging in bounded memory: each pid batch pages
        its cold chunks, runs the distributive prefix of the transformer
        chain, and the batch results merge as shard results do at a reduce;
        the rest of the chain applies to the merged whole (ref:
        OnDemandPagingShard.scala:58 pages any width)."""
        n_dist = 0
        while (n_dist < len(self.transformers)
               and self._batch_distributive(self.transformers[n_dist])):
            n_dist += 1
        prefix, suffix = self.transformers[:n_dist], self.transformers[n_dist:]
        agg = next((t for t in prefix if isinstance(t, AggregateMapReduce)),
                   None)
        outs = []
        for i in range(0, len(pids), ODP_BATCH):
            sub = pids[i:i + ODP_BATCH]
            ctx.stats.add("rows_paged_in", len(sub))
            # the sink scan runs lock-free (append-only logs); only the keys
            # and the resident gather need the lock, the host copy follows
            # its release
            cold = shard.read_cold_for(sub, self.start_ms, self.end_ms)
            with shard.lock:
                keys = [shard.rv_key_of(int(p)) for p in sub]
                gathered = shard.gather_resident_locked(sub, column)
            data = self._paged_selection(shard, sub, keys, gathered,
                                         cold=cold, column=column)
            for t in prefix:
                data = t.apply(data, ctx)
            if isinstance(data, FusedWindowData):
                data = data.materialize()
            outs.append(data)
        merged = None
        if agg is not None:
            merged = _merge_heterogeneous(outs, agg.operator, agg.params,
                                          agg.by, agg.without, ctx.device)
        if merged is None:
            mats = [_as_matrix(o).to_host() for o in outs]
            nonempty = [m for m in mats if m.num_series]
            if nonempty:
                vals = np.concatenate([np.asarray(m.values)
                                       for m in nonempty], axis=0)
                keys = [k for m in nonempty for k in m.keys]
                merged = ResultMatrix(nonempty[0].out_ts, vals, keys,
                                      nonempty[0].bucket_les)
            else:
                merged = mats[0]
        for t in suffix:
            merged = t.apply(merged, ctx)
        return merged

    @staticmethod
    def _paged_gather(shard, pids, col) -> _NarrowODP:
        """A narrow selection that needs paging: its keys and the resident
        rows, gathered under the shard lock. Every caller already holds it
        (``execute``, the engine's fused-hist route); the hold here is a
        re-entry that keeps the gather correct for any caller. execute()
        reads the cold chunks and makes the host copy after the lock is
        released."""
        with shard.lock:
            return _NarrowODP(pids, [shard.rv_key_of(int(p)) for p in pids],
                              shard.gather_resident_locked(pids, col))

    def select(self, ctx):
        """:meth:`do_execute` under a ``query.exec.select`` span: the index
        lookup, the keys and the capture of the store's tensors. The
        caller holds the shard lock."""
        with span(SPAN_QUERY_SELECT, shard=self.shard) as tags:
            data = self.do_execute(ctx)
            tags["series"] = len(data.pids if isinstance(
                data, (_WideODP, _NarrowODP)) else data.keys)
            return data

    def do_execute(self, ctx) -> SeriesSelection:
        shard, col = _shard_of_ctx(ctx, self.shard, self.column)
        if shard.store is None:     # histogram shard with no data yet
            return _pad_selection(shard.device, torch.float32, None)
        pids = shard.part_ids_from_filters(list(self.filters), self.start_ms,
                                           self.end_ms)
        ctx.stats.add("series_matched", len(pids))
        store = shard.store
        # bucket boundaries ride only when the SELECTED column is the
        # histogram one (``{__col__="sum"}`` on prom-histogram is scalar)
        les = shard.bucket_les
        if (col is not None
                and shard.schema.column_named(col).ctype != ColumnType.HISTOGRAM):
            les = None
        # on-demand paging: the query reaches behind the resident rows ->
        # merge cold chunks from the sink (ref:
        # OnDemandPagingShard.scanPartitions)
        if les is None and shard.needs_paging(pids, self.start_ms):
            if len(pids) > ODP_BATCH:
                return _WideODP(pids)
            ctx.stats.add("rows_paged_in", len(pids))
            return self._paged_gather(shard, pids, col)
        if len(pids) > GATHER_THRESHOLD:
            # wide selection: defer key materialization (global aggregates
            # never read them)
            keys = LazyKeys(shard, pids)
        else:
            keys = [shard.rv_key_of(int(p)) for p in pids]
        ts, val, n = store.arrays(col)
        total = len(shard.index)
        grid = store.grid_info()
        if len(pids) == 0:
            # synthetic pad selection: pad rows have n = 0, so every kernel
            # yields the empty result the real slice would. Slicing a
            # compressed-resident store's deferred view here would decode
            # the FULL block for an empty answer
            return _pad_selection(store.device, store.dtype,
                                  store.nbuckets if val.dim() == 3 else None,
                                  les)
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
        if len(pids) <= GATHER_THRESHOLD and len(pids) < 0.5 * max(total, 1):
            # narrow selection: gather rows once, padded to a power of two
            ctx.stats.add("blocks_raw")
            sel_ts, sel_val, sel_n, P = _gather_rows_padded(ts, val, n, pids)
            sel_rows = (None if P == len(pids)
                        else np.arange(len(pids), dtype=np.int32))
            g_min = (np.nonzero(minority_sel)[0].astype(np.int32)
                     if minority_sel is not None else None)
            return SeriesSelection(sel_ts, sel_val, sel_n, keys, sel_rows,
                                   grid, g_min, bucket_les=les)
        # wide selection: no gather — disable non-selected rows via n = 0
        if len(pids) == total:
            n_eff = n
        else:
            mask = np.zeros(store.S, bool)
            mask[pids] = True
            n_eff = torch.where(torch.from_numpy(mask).to(store.device), n, 0)
        g_min = (pids[minority_sel].astype(np.int32)
                 if minority_sel is not None else None)
        narrow = None
        # the reference's row-count condition is kept so both packages pick
        # the same route; K1 takes any S, and a store's row rounding (a
        # multiple of 8 up to 512, of 512 beyond) always meets it
        if (grid is not None and col is None and les is None
                and (store.S % 512 == 0 or store.S <= 512)
                and val.dim() == 2):
            # scalar narrow-resident store first (the narrow form IS the
            # store), then the optional quant16 mirror beside a raw one: ship
            # the narrow operands so the fused pass streams them, unless the
            # selection's inexact rows pass the cohort gate (correcting that
            # many costs more than streaming the f32 block)
            nd = store.narrow_operands()
            if nd is None and shard.config.narrow_mirror:
                md = store.narrow.get(store)
                if md is not None:
                    q, vmin, scale, ok_host = md
                    nd = ("quant16", (q, vmin, scale), ok_host)
            if nd is not None:
                kind, nops, ok_host = nd
                bad = pids[~ok_host[pids]].astype(np.int32)
                if len(bad) <= COHORT_GATE * max(len(pids), 1):
                    narrow = (kind, nops, bad)
        hist_narrow = None
        if grid is not None and les is not None and val.dim() == 3:
            # hist-resident store: ship the 2D-delta operands so the fused
            # route streams them; cohort-pool rows recompute row-wise
            hd = store.hist_operands()
            if hd is not None:
                dd, first_d, ok_host = hd
                hist_narrow = (dd, first_d,
                               pids[~ok_host[pids]].astype(np.int32))
        ctx.stats.add("blocks_narrow"
                      if narrow is not None or hist_narrow is not None
                      else "blocks_raw")
        return SeriesSelection(ts, val, n_eff, keys,
                               pids.astype(np.int32, copy=False), grid,
                               g_min, bucket_les=les, narrow=narrow,
                               hist_narrow=hist_narrow)


def _pad_selection(dev, dtype, nbuckets, les=None) -> SeriesSelection:
    """An empty selection of 8 pad rows (n = 0): every kernel yields the
    empty result a real slice would."""
    vshape = (8, 8) if nbuckets is None else (8, 8, nbuckets)
    return SeriesSelection(
        torch.full((8, 8), 1 << 62, dtype=torch.int64, device=dev),
        torch.zeros(vshape, dtype=dtype, device=dev),
        torch.zeros(8, dtype=torch.int32, device=dev), [], None, None,
        bucket_les=les)


def _execute_children(children, ctx):
    """Execute child plans, remote legs concurrently: peer round trips
    overlap each other and the local shards' device work (ref:
    NonLeafExecPlan dispatches children as parallel Observables). Local
    children stay on the calling thread, which already serializes their
    launches under the shard locks. A RemoteBatchExec child (one POST for a
    peer's K leaves) returns a result list that splices back into its
    members' original positions, so parents see one result per leaf in the
    single node's order."""
    remote = [c for c in children if getattr(c, "IS_REMOTE", False)]
    if not remote or len(children) == 1:
        results = [c.execute(ctx) for c in children]
    else:
        from concurrent.futures import ThreadPoolExecutor

        from ..utils.tracing import tracer

        # remote legs run on pool threads with the query's trace context,
        # so their dispatch spans join its trace
        run_remote = tracer.wrap(lambda c: c.execute(ctx))
        with ThreadPoolExecutor(max_workers=min(len(remote), 16)) as pool:
            futs = {id(c): pool.submit(run_remote, c) for c in remote}
            results = [futs[id(c)].result() if id(c) in futs
                       else c.execute(ctx) for c in children]
    batches = [c for c in children if getattr(c, "IS_BATCH", False)]
    if not batches:
        return results
    n_total = (len(children) - len(batches)
               + sum(len(b.members) for b in batches))
    taken = {s for b in batches for s in b.slots}
    free = (i for i in range(n_total) if i not in taken)
    out = [None] * n_total
    for c, r in zip(children, results):
        if getattr(c, "IS_BATCH", False):
            for slot, res in zip(c.slots, r):
                out[slot] = res
        else:
            out[next(free)] = r
    return out


@dataclass
class DistConcatExec(ExecPlan):
    """Concatenate child results (ref: DistConcatExec.scala — shard fan-in)."""
    children: list = field(default_factory=list)

    def do_execute(self, ctx):
        all_mats = [_as_matrix(r).to_host()
                    for r in _execute_children(self.children, ctx)]
        mats = [m for m in all_mats if m.num_series]
        if not mats:
            return all_mats[0]
        # the host fan-in's dtype is f64, as the wire's matrices and the
        # partial merges are: a child's dtype must not depend on whether
        # it ran here or on a peer
        vals = np.concatenate([np.asarray(m.values, np.float64)
                               for m in mats], axis=0)
        return ResultMatrix(mats[0].out_ts, vals,
                            [k for m in mats for k in m.keys],
                            mats[0].bucket_les)


@dataclass
class SubqueryWindowExec(ExecPlan):
    """Range function over a subquery's synthetic sample stream
    (``fn(expr[window:sub_step])``, ref: SubqueryWindowExec): the child
    evaluates the inner expression on the absolute sub-step grid, each
    series' finite steps become its (ts, val) sample row, and the general
    range functions slide over the rows. The reference builds the rows in
    a loop over series; here one stable sort of the rows' finiteness masks
    puts each row's samples first, in step order — the same rows, built in
    one pass on the query's device (an inner selection can hold 10^5
    series)."""
    child: ExecPlan | None = None
    start_ms: int = 0
    step_ms: int = 1
    end_ms: int = 0
    window_ms: int = 0
    function: str = "last_over_time"
    args: tuple = ()

    def do_execute(self, ctx):
        inner = _as_matrix(self.child.execute(ctx))
        out_ts = _steps(self.start_ms, self.step_ms, self.end_ms)
        S = inner.num_series
        if len(out_ts) == 0 or S == 0:
            return ResultMatrix(out_ts, np.zeros((S, len(out_ts))),
                                inner.keys)
        if inner.bucket_les is not None:
            raise QueryError("subqueries over histogram series are not "
                             "supported")
        vals = _tensor(inner.values, ctx.device).to(torch.float64)
        dev = vals.device
        sub_ts = torch.from_numpy(np.asarray(inner.out_ts, np.int64)).to(dev)
        if vals.shape[1] == 0:          # an inner grid with no step
            vals = torch.full((S, 1), float("nan"), dtype=torch.float64,
                              device=dev)
            sub_ts = torch.full((1,), int(TS_PAD), device=dev)
        finite = torch.isfinite(vals)
        n = finite.sum(dim=1, dtype=torch.int32)
        C = max(int(n.max()), 1)
        order = torch.sort((~finite).to(torch.int8), dim=1,
                           stable=True).indices[:, :C]
        live = torch.arange(C, device=dev)[None, :] < n[:, None]
        ts2d = torch.where(live, sub_ts[order], int(TS_PAD))
        val2d = torch.where(live, torch.gather(vals, 1, order), 0.0)
        ctx.stats.add("subquery_inner_cells", S * len(inner.out_ts))
        out_eval, T = _pad_steps(out_ts)
        a0 = float(self.args[0]) if len(self.args) > 0 else 0.0
        a1 = float(self.args[1]) if len(self.args) > 1 else 0.0
        out = rangefns.periodic_samples(ts2d, val2d, n, out_eval,
                                        self.window_ms, self.function, a0, a1)
        return ResultMatrix(out_ts, out[:, :T], inner.keys)


@dataclass
class RepeatAtExec(ExecPlan):
    """Broadcast an ``@``-pinned evaluation across the query grid (ref:
    RepeatAtExec): the child runs on its own single-step grid at the
    pinned instant; its step-invariant result tiles to [start, end]."""
    child: ExecPlan | None = None
    start_ms: int = 0
    step_ms: int = 1
    end_ms: int = 0

    def do_execute(self, ctx):
        inner = _as_matrix(self.child.execute(ctx))
        out_ts = _steps(self.start_ms, self.step_ms, self.end_ms)
        T = len(out_ts)
        if inner.values.shape[1] == 0:
            out = np.full((inner.num_series, T), np.nan)
        else:
            vals = _tensor(inner.values, ctx.device).to(torch.float64)
            out = vals[:, -1:].expand(vals.shape[0], T,
                                      *vals.shape[2:]).contiguous()
        return ResultMatrix(out_ts, out, inner.keys, inner.bucket_les)


@dataclass
class ReduceAggregateExec(ExecPlan):
    """Cross-shard reduce (ref: ReduceAggregateExec): children yield
    AggPartials (basic ops), order-statistic partials, or full matrices
    where a shard's map phase fell back past its caps; partials merge
    group by group, then the presenter finishes."""
    operator: str = "sum"
    params: tuple = ()
    by: tuple = ()
    without: tuple = ()
    children: list = field(default_factory=list)

    def do_execute(self, ctx):
        results = _execute_children(self.children, ctx)
        with span(SPAN_QUERY_REDUCE, op=self.operator,
                  children=len(self.children)), ctx.stats.stage("reduce"):
            # the per-shard group cap is data-dependent, so a sibling may
            # have fallen back to a full matrix: normalization happens
            # inside (the matrix has full information; the reverse is
            # impossible)
            merged = _merge_heterogeneous(results, self.operator, self.params,
                                          self.by, self.without, ctx.device)
            if merged is not None:
                return merged
            mats = [_as_matrix(r).to_host() for r in results]
            mats = [m for m in mats if m.num_series]
            if not mats:
                return ResultMatrix(np.zeros(0, np.int64), np.zeros((0, 0)),
                                    [])
            vals = np.concatenate([np.asarray(m.values, np.float64)
                                   for m in mats], axis=0)
            return ResultMatrix(mats[0].out_ts, vals,
                                [k for m in mats for k in m.keys])


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
    les = partials[0].bucket_les
    T = len(out_ts) * (len(les) if les is not None else 1)
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
    return AggPartial(op, out_ts, merged, list(all_keys), G, les)


# ---------------------------------------------------------------------------
# Binary joins and set operators
# ---------------------------------------------------------------------------

def _join_key(k: RangeVectorKey, on, ignoring,
              memo: dict | None = None) -> RangeVectorKey:
    """Join key of a series under on/ignoring. ``memo`` is a per-execution
    dict (both sides of a join share on/ignoring)."""
    if memo is not None:
        jk = memo.get(k)
        if jk is not None:
            return jk
    out = k.without(("_metric_",))
    if on:
        out = out.only(on)
    elif ignoring:
        out = out.without(ignoring)
    if memo is not None:
        memo[k] = out
    return out


@dataclass
class BinaryJoinExec(ExecPlan):
    """Vector-vector binary operation (ref: BinaryJoinExec.scala: one-to-one
    and many-to-one/one-to-many with on/ignoring + group_left/right
    include). The children run one after the other, each under its own
    shard lock only; the aligned element math runs on the query's device."""
    lhs: ExecPlan = None
    rhs: ExecPlan = None
    operator: str = "+"
    cardinality: str = "OneToOne"
    on: tuple = ()
    ignoring: tuple = ()
    include: tuple = ()

    def do_execute(self, ctx):
        lm = _as_matrix(self.lhs.execute(ctx)).to_host()
        rm = _as_matrix(self.rhs.execute(ctx)).to_host()
        swap = self.cardinality == "OneToMany"   # ManyToOne with sides swapped
        many, one = (rm, lm) if swap else (lm, rm)
        memo: dict = {}           # per-query join-key cache (both sides)
        one_by_key: dict[RangeVectorKey, int] = {}
        for i, k in enumerate(one.keys):
            jk = _join_key(k, self.on, self.ignoring, memo)
            if jk in one_by_key:
                raise QueryError(f"duplicate series on 'one' side of join for {jk}")
            one_by_key[jk] = i
        rows_many, rows_one, keys = [], [], []
        is_filter = (self.operator.removesuffix("_bool") in binop.COMPARISON_OPS
                     and not self.operator.endswith("_bool"))
        seen: set[RangeVectorKey] = set()
        for i, k in enumerate(many.keys):
            jk = _join_key(k, self.on, self.ignoring, memo)
            j = one_by_key.get(jk)
            if j is None:
                continue
            if self.cardinality == "OneToOne":
                if jk in seen:
                    raise QueryError(f"duplicate series on 'many' side of join for {jk}")
                seen.add(jk)
            rows_many.append(i)
            rows_one.append(j)
            if is_filter:
                keys.append(k)           # a comparison filter keeps labels
            else:
                out = k.without(("_metric_",))
                if self.include:
                    d = out.as_dict()
                    od = one.keys[j].as_dict()
                    for lbl in self.include:
                        if od.get(lbl):
                            d[lbl] = od[lbl]
                        else:
                            d.pop(lbl, None)
                    out = RangeVectorKey.of(d)
                elif self.on and self.cardinality == "OneToOne":
                    out = _join_key(k, self.on, self.ignoring, memo)
                keys.append(out)
        if not rows_many:
            return ResultMatrix(lm.out_ts, np.zeros((0, len(lm.out_ts))), [])
        mv = _tensor(np.asarray(many.values)[rows_many], ctx.device)
        ov = _tensor(np.asarray(one.values)[rows_one], ctx.device)
        l_vals, r_vals = (ov, mv) if swap else (mv, ov)
        vals = binop.apply_vector_op(self.operator, l_vals, r_vals)
        return ResultMatrix(lm.out_ts, vals, keys)


@dataclass
class SetOperatorExec(ExecPlan):
    """and/or/unless with per-step presence semantics (ref:
    SetOperatorExec.scala); host numpy, as in the reference."""
    lhs: ExecPlan = None
    rhs: ExecPlan = None
    operator: str = "and"
    on: tuple = ()
    ignoring: tuple = ()

    def do_execute(self, ctx):
        lm = _as_matrix(self.lhs.execute(ctx)).to_host()
        rm = _as_matrix(self.rhs.execute(ctx)).to_host()
        lvals, rvals = np.asarray(lm.values), np.asarray(rm.values)
        memo: dict = {}           # per-query join-key cache (both sides)
        T = len(lm.out_ts)

        def presence(mat, keys):
            """Presence of each join key at each step."""
            pres: dict[RangeVectorKey, np.ndarray] = {}
            for i, k in enumerate(keys):
                jk = _join_key(k, self.on, self.ignoring, memo)
                cur = pres.get(jk)
                here = ~np.isnan(mat[i])
                pres[jk] = here if cur is None else (cur | here)
            return pres
        if self.operator in ("and", "unless"):
            rp = presence(rvals, rm.keys)
            out = []
            for i, k in enumerate(lm.keys):
                jk = _join_key(k, self.on, self.ignoring, memo)
                mask = rp.get(jk, np.zeros(T, bool))
                if self.operator == "unless":
                    mask = ~mask
                out.append(np.where(mask, lvals[i], np.nan))
            vals = np.stack(out) if out else np.zeros((0, T))
            return ResultMatrix(lm.out_ts, vals, list(lm.keys))
        if self.operator == "or":
            lp = presence(lvals, lm.keys)
            rows = [lvals[i] for i in range(len(lm.keys))]
            keys = list(lm.keys)
            for i, k in enumerate(rm.keys):
                jk = _join_key(k, self.on, self.ignoring, memo)
                lmask = lp.get(jk, np.zeros(T, bool))
                rows.append(np.where(lmask, np.nan, rvals[i]))
                keys.append(k)
            vals = np.stack(rows) if rows else np.zeros((0, T))
            return ResultMatrix(lm.out_ts, vals, keys)
        raise QueryError(f"unknown set operator {self.operator}")


def _steps(start_ms: int, step_ms: int, end_ms: int) -> np.ndarray:
    return np.arange(start_ms, end_ms + 1, max(step_ms, 1), dtype=np.int64)


@dataclass
class ScalarExec(ExecPlan):
    """Literal scalar evaluated at each step."""
    value: float = 0.0
    start_ms: int = 0
    step_ms: int = 1
    end_ms: int = 0

    def do_execute(self, ctx):
        out_ts = _steps(self.start_ms, self.step_ms, self.end_ms)
        return ResultMatrix(out_ts, np.full((1, len(out_ts)), self.value),
                            [RangeVectorKey(())])


@dataclass
class TimeScalarExec(ExecPlan):
    """PromQL ``time()``: the evaluation timestamp in seconds per step."""
    start_ms: int = 0
    step_ms: int = 1
    end_ms: int = 0

    def do_execute(self, ctx):
        out_ts = _steps(self.start_ms, self.step_ms, self.end_ms)
        return ResultMatrix(out_ts, (out_ts / 1000.0)[None, :],
                            [RangeVectorKey(())])


@dataclass
class SelectChunkInfosExec(ExecPlan):
    """Chunk-metadata debug leaf (ref: SelectChunkInfosExec.scala — id,
    numRows, startTime, endTime, numBytes, readerKlazz per chunk). The
    store keeps ONE resident row per series (no chunk lists), so each row's
    stats come back as labels on a synthetic series, with the count of a
    durable sink's persisted chunk frames (``_sinkChunks_``)."""
    shard: int = 0
    filters: tuple = ()
    start_ms: int = 0
    end_ms: int = 0
    column: str = ""

    MAX_PARTS = 1000    # debug surface: bound the output

    def do_execute(self, ctx):
        shard, _col = _shard_of_ctx(ctx, self.shard, self.column)
        out_ts = np.array([self.end_ms], np.int64)
        if shard.store is None:
            return ResultMatrix(out_ts, np.zeros((0, 1)), [])
        pids = shard.part_ids_from_filters(list(self.filters), self.start_ms,
                                           self.end_ms, limit=self.MAX_PARTS)
        sink_chunks: dict[int, int] = {}
        if shard.sink is not None and hasattr(shard.sink, "read_chunksets"):
            for _g, recs in shard.sink.read_chunksets(
                    shard.dataset, self.shard, self.start_ms,
                    self.end_ms) or ():
                for r in recs:
                    sink_chunks[r.part_id] = sink_chunks.get(r.part_id, 0) + 1
        st = shard.store
        keys, vals = [], []
        per_sample = 8 + st.column_array().dtype.itemsize * max(st.nbuckets, 1)
        with shard.lock:
            for p in pids:
                p = int(p)
                labels = dict(shard.index.labels_of(p))
                n = int(st.n_host[p])
                labels.update({
                    "_id_": str(p),
                    "_numRows_": str(n),
                    "_startTime_": str(int(st.first_ts[p])),
                    "_endTime_": str(int(st.last_ts[p])) if n else "-1",
                    "_numBytes_": str(n * per_sample),
                    "_readerKlazz_": "SeriesStoreRow",
                    "_sinkChunks_": str(sink_chunks.get(p, 0)),
                })
                keys.append(RangeVectorKey.of(labels))
                vals.append([float(n)])
        if not keys:
            return ResultMatrix(out_ts, np.zeros((0, 1)), [])
        return ResultMatrix(out_ts, np.asarray(vals), keys)


@dataclass
class ScalarOfVectorExec(ExecPlan):
    """PromQL ``scalar(v)``: the single series' values, NaN at steps where
    the vector doesn't have exactly one sample."""
    child: ExecPlan = None

    def do_execute(self, ctx):
        m = _as_matrix(self.child.execute(ctx)).to_host()
        T = len(m.out_ts)
        vals = np.asarray(m.values, np.float64).reshape(-1, T)
        present = (~np.isnan(vals)).sum(axis=0)
        with np.errstate(invalid="ignore"):
            col = np.where(present == 1, np.nansum(vals, axis=0), np.nan)
        return ResultMatrix(m.out_ts, col[None, :], [RangeVectorKey(())])
