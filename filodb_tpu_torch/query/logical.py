"""LogicalPlan ADT — the language-independent query tree.

Reference: query/src/main/scala/filodb/query/LogicalPlan.scala:5-169 (RawSeries,
PeriodicSeries(WithWindowing), Aggregate, BinaryJoin, ScalarVectorBinaryOperation,
ApplyInstantFunction, ApplyMiscellaneousFunction, ApplySortFunction, metadata plans).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

from ..core.filters import Filter


@dataclass(frozen=True)
class LogicalPlan:
    pass


@dataclass(frozen=True)
class RawSeriesLikePlan(LogicalPlan):
    pass


@dataclass(frozen=True)
class PeriodicSeriesPlan(LogicalPlan):
    """Plans that result in a time series with regular steps."""
    pass


@dataclass(frozen=True)
class IntervalSelector:
    """[from, to] in epoch ms (ref: LogicalPlan.scala RangeSelector)."""
    from_ms: int
    to_ms: int


@dataclass(frozen=True)
class RawSeries(RawSeriesLikePlan):
    range_selector: IntervalSelector
    filters: tuple[Filter, ...]
    columns: tuple[str, ...] = ()


@dataclass(frozen=True)
class RawChunkMeta(PeriodicSeriesPlan):
    """Chunk metadata debug plan (ref: LogicalPlan.scala RawChunkMeta)."""
    range_selector: IntervalSelector
    filters: tuple[Filter, ...]
    column: str = ""


@dataclass(frozen=True)
class PeriodicSeries(PeriodicSeriesPlan):
    """Instant selector evaluated at regular steps (last sample per step)."""
    raw_series: RawSeries
    start_ms: int
    step_ms: int
    end_ms: int


@dataclass(frozen=True)
class PeriodicSeriesWithWindowing(PeriodicSeriesPlan):
    """Range function over a window at regular steps."""
    series: RawSeries
    start_ms: int
    step_ms: int
    end_ms: int
    window_ms: int
    function: str                      # range function name
    function_args: tuple[float, ...] = ()


@dataclass(frozen=True)
class SubqueryWithWindowing(PeriodicSeriesPlan):
    """Range function over a SUBQUERY ``inner[window:sub_step]`` — the inner
    periodic plan re-evaluates on the ``sub_step`` grid covering
    ``[start - window, end]`` and the outer range function slides over that
    synthetic sample stream (ref: upstream PromQL subqueries; the reference
    parser stops short of them)."""
    inner: PeriodicSeriesPlan
    start_ms: int
    step_ms: int
    end_ms: int
    window_ms: int
    function: str
    function_args: tuple[float, ...] = ()
    sub_step_ms: int = 60_000


@dataclass(frozen=True)
class ApplyAtTimestamp(PeriodicSeriesPlan):
    """``selector @ t``: the inner plan evaluates on its own pinned
    single-step grid at ``t`` and the (step-invariant) result broadcasts
    across the query grid ``[start_ms, end_ms]``."""
    vectors: PeriodicSeriesPlan
    start_ms: int
    step_ms: int
    end_ms: int


@dataclass(frozen=True)
class Aggregate(PeriodicSeriesPlan):
    operator: str                      # sum/min/max/avg/count/stddev/stdvar/topk/bottomk/count_values/quantile
    vectors: PeriodicSeriesPlan
    params: tuple = ()
    by: tuple[str, ...] = ()
    without: tuple[str, ...] = ()


@dataclass(frozen=True)
class BinaryJoin(PeriodicSeriesPlan):
    lhs: PeriodicSeriesPlan
    operator: str
    cardinality: str                   # OneToOne/OneToMany/ManyToOne/ManyToMany
    rhs: PeriodicSeriesPlan
    on: tuple[str, ...] = ()
    ignoring: tuple[str, ...] = ()
    include: tuple[str, ...] = ()


@dataclass(frozen=True)
class ScalarVectorBinaryOperation(PeriodicSeriesPlan):
    operator: str
    scalar: float
    vector: PeriodicSeriesPlan
    scalar_is_lhs: bool = False


@dataclass(frozen=True)
class ApplyInstantFunction(PeriodicSeriesPlan):
    vectors: PeriodicSeriesPlan
    function: str
    function_args: tuple[float, ...] = ()


@dataclass(frozen=True)
class ApplyMiscellaneousFunction(PeriodicSeriesPlan):
    vectors: PeriodicSeriesPlan
    function: str                      # label_replace/label_join/timestamp
    string_args: tuple[str, ...] = ()


@dataclass(frozen=True)
class ApplySortFunction(PeriodicSeriesPlan):
    vectors: PeriodicSeriesPlan
    function: str                      # sort/sort_desc


@dataclass(frozen=True)
class ScalarPlan(PeriodicSeriesPlan):
    """A literal scalar expression evaluated at each step."""
    value: float
    start_ms: int = 0
    step_ms: int = 1
    end_ms: int = 0


@dataclass(frozen=True)
class TimeScalarPlan(PeriodicSeriesPlan):
    """PromQL ``time()``: the evaluation timestamp (seconds) at each step."""
    start_ms: int = 0
    step_ms: int = 1
    end_ms: int = 0


@dataclass(frozen=True)
class ScalarOfVector(PeriodicSeriesPlan):
    """PromQL ``scalar(v)``: the single series' value per step, NaN unless
    the vector has exactly one series."""
    vectors: LogicalPlan = None


@dataclass(frozen=True)
class VectorOfScalar(PeriodicSeriesPlan):
    """PromQL ``vector(s)``: a one-series instant vector from a scalar."""
    scalar: LogicalPlan = None


def child_plans(node):
    """Yield ``(field_name, child_plan)`` for every LogicalPlan held by a
    direct dataclass field of ``node`` — including members of tuple/list
    fields. THE one child traversal the plan walkers share
    (query/retention.widen_windows, query/incremental.plan_cacheable): a
    future node type that nests children differently is covered here once
    instead of in every hand-rolled walk."""
    import dataclasses
    if not dataclasses.is_dataclass(node):
        return
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, LogicalPlan):
            yield f.name, v
        elif isinstance(v, (list, tuple)):
            for x in v:
                if isinstance(x, LogicalPlan):
                    yield f.name, x


# ---- metadata plans ---------------------------------------------------------

@dataclass(frozen=True)
class LabelValues(LogicalPlan):
    label_names: tuple[str, ...]
    label_constraints: tuple[tuple[str, str], ...] = ()
    lookback_ms: int = 0


@dataclass(frozen=True)
class SeriesKeysByFilters(LogicalPlan):
    filters: tuple[Filter, ...]
    start_ms: int = 0
    end_ms: int = 1 << 62
