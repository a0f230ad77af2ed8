"""Retention subsystem: downsample-aware query routing over the tiered store.

Host copy of ``filodb_tpu/query/retention.py``; durations parse through
the configuration's ``parse_duration_ms``. No device code.

Reference: the reference FiloDB serves long-term data from a separate
downsample cluster reading the multi-resolution downsample datasets the
Spark job maintains (SURVEY §1 layers 3 & 9; filodb-defaults.conf downsample
schemas), while the raw cluster serves the recent window — queries pick the
dataset by time range. Here the same split is one process: the raw engine
owns the recent in-memory window (plus durable-raw ODP), the per-resolution
``ds_family`` serving engines own the downsampled history, and the
``RetentionRouter`` decides per query which tier answers — stitching the
recent raw tail onto the downsampled body at the in-memory horizon (the
StitchRvsExec seam shape, reused from parallel/cluster.stitch_matrices).

Decision rule (``RetentionPolicy.decide``):
  * the candidate resolution is the COARSEST configured family at or below
    the query step (each output step then covers >= 1 downsample bucket);
    a step finer than every family keeps the query on raw,
  * the horizon is ``data lead - raw window`` (data time, like the purge
    loop — backfilled workloads behave like live ones): ranges entirely
    newer stay raw, entirely older route whole, and straddling ranges
    stitch at the first step-grid point past the horizon,
  * ``&resolution=`` (or filo-cli ``--resolution``) overrides the decision
    for the WHOLE range; an unknown value fails with the configured list.
"""

from __future__ import annotations

import logging

from ..config import parse_duration_ms
from ..utils.metrics import FILODB_RETENTION_ROUTED_QUERIES, registry
from ..utils.tracing import SPAN_QUERY_RETENTION, span
from .rangevector import QueryError, QueryResult, QueryStats

log = logging.getLogger(__name__)

RAW = 0     # the sentinel resolution of the raw tier

# range functions that need >= 2 samples in the window (the kernels' cnt>=2
# presence rule): their widened floor is TWO downsample buckets; the
# *_over_time family needs one, so its floor is the resolution itself
TWO_SAMPLE_FNS = frozenset({"rate", "increase", "delta", "irate", "idelta",
                            "deriv", "predict_linear"})


def widen_windows(plan, resolution_ms: int):
    """``(plan', n_widened)``: windowed functions whose window is narrower
    than the serving ``resolution_ms`` widen to cover it — without this, a
    ``rate(m[1m])`` routed to a 5m downsample family finds < 2 samples per
    window and silently returns empty/wrong data. The inner raw selector's lookback range widens by the same delta
    (the parser derived it as ``start - window``), so the leaf actually
    reads the extra cells. Widening changes the window semantics — callers
    surface it as a response warning + QueryStats.windows_widened."""
    import dataclasses

    from . import logical as L

    def walk(node):
        if not dataclasses.is_dataclass(node):
            return node, 0
        n = 0
        changes = {}
        # the shared child traversal (logical.child_plans) defines what a
        # "child" is; replacement here handles both direct plan fields and
        # tuple/list container fields member-wise
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            if isinstance(v, L.LogicalPlan):
                nv, k = walk(v)
                if k:
                    changes[f.name] = nv
                    n += k
            elif isinstance(v, (list, tuple)) \
                    and any(isinstance(x, L.LogicalPlan) for x in v):
                new_members = []
                k_sum = 0
                for x in v:
                    if isinstance(x, L.LogicalPlan):
                        nx, k = walk(x)
                        new_members.append(nx)
                        k_sum += k
                    else:
                        new_members.append(x)
                if k_sum:
                    changes[f.name] = type(v)(new_members)
                    n += k_sum
        if isinstance(node, L.PeriodicSeriesWithWindowing):
            floor = resolution_ms * (2 if node.function in TWO_SAMPLE_FNS
                                     else 1)
            if node.window_ms < floor:
                delta = floor - node.window_ms
                raw = changes.get("series", node.series)
                sel = raw.range_selector
                changes["series"] = dataclasses.replace(
                    raw, range_selector=L.IntervalSelector(
                        sel.from_ms - delta, sel.to_ms))
                changes["window_ms"] = floor
                n += 1
        if changes:
            node = dataclasses.replace(node, **changes)
        return node, n

    return walk(plan)


def resolution_label(res_ms: int) -> str:
    """Canonical spelling of a resolution ("raw", "90s", "1m", "1h")."""
    if res_ms == RAW:
        return "raw"
    if res_ms % 3_600_000 == 0:
        return f"{res_ms // 3_600_000}h"
    if res_ms % 60_000 == 0:
        return f"{res_ms // 60_000}m"
    return f"{res_ms // 1000}s"


class RouteDecision:
    """Outcome of one routing decision. ``resolution_ms == RAW`` serves raw
    only; otherwise the family serves ``[start, seam)`` and raw serves
    ``[seam, end]`` (``seam_ms is None`` = the family serves everything)."""

    __slots__ = ("resolution_ms", "seam_ms")

    def __init__(self, resolution_ms: int, seam_ms: int | None = None):
        self.resolution_ms = resolution_ms
        self.seam_ms = seam_ms

    @property
    def label(self) -> str:
        lbl = resolution_label(self.resolution_ms)
        return f"{lbl}+raw" if self.seam_ms is not None else lbl


class RetentionPolicy:
    """The configured resolution set + the rule picking one per query."""

    def __init__(self, resolutions_ms: list[int], raw_window_ms: int,
                 min_range_steps: int = 2):
        """``resolutions_ms``: ascending downsample resolutions (raw is
        always implicitly available). ``raw_window_ms``: the raw tier's
        preferred serving window, normally the in-memory retention — data
        older than ``lead - raw_window`` routes to a family when one fits
        the step. ``min_range_steps``: ranges shorter than this many steps
        never route (a 1-point probe is cheaper on raw)."""
        rs = sorted(int(r) for r in resolutions_ms if int(r) > RAW)
        if any(a == b for a, b in zip(rs, rs[1:])):
            raise ValueError(f"duplicate retention resolutions: {rs}")
        self.resolutions_ms = rs
        self.raw_window_ms = int(raw_window_ms)
        self.min_range_steps = int(min_range_steps)

    @classmethod
    def from_config(cls, spec: list, downsample_res_ms: list[int],
                    raw_window_ms: int) -> "RetentionPolicy":
        """Build from ``retention.resolutions`` (["raw", "1m", ...]; empty =
        raw + every configured downsample resolution). Durations that name
        no downsample family are refused — they could never serve."""
        if not spec:
            return cls(list(downsample_res_ms), raw_window_ms)
        out = []
        for s in spec:
            if str(s).strip().lower() == "raw":
                continue
            ms = parse_duration_ms(s)
            if ms not in downsample_res_ms:
                have = ([resolution_label(r) for r in downsample_res_ms]
                        or "none — is downsample.enabled on?")
                raise ValueError(
                    f"retention resolution {s!r} names no downsample family "
                    f"(downsample.resolutions covers {have})")
            out.append(ms)
        return cls(out, raw_window_ms)

    def labels(self) -> list[str]:
        return ["raw"] + [resolution_label(r) for r in self.resolutions_ms]

    def parse_override(self, value: str) -> int:
        """``&resolution=`` value -> resolution_ms (RAW for "raw"); unknown
        values fail WITH the configured list — the silent-empty-result bug
        this replaces served a nonexistent ds_family dataset."""
        v = str(value).strip().lower()
        if v == "raw":
            return RAW
        try:
            ms = parse_duration_ms(v)
        except ValueError:
            ms = -1
        if ms not in self.resolutions_ms:
            raise QueryError(
                f"unknown resolution {value!r}; available: "
                f"{', '.join(self.labels())}")
        return ms

    def _fit(self, step_ms: int) -> int:
        """The coarsest configured resolution at or below the step (RAW when
        the step is finer than every family — downsampled buckets could not
        land one per output step)."""
        fit = RAW
        for r in self.resolutions_ms:
            if r <= step_ms:
                fit = r
        return fit

    def decide(self, start_ms: int, end_ms: int, step_ms: int,
               now_ms: int, override: int | None = None) -> RouteDecision:
        if override is not None:
            return RouteDecision(override)
        step = max(int(step_ms), 1)
        res = self._fit(step)
        if res == RAW or now_ms <= 0:
            return RouteDecision(RAW)
        if (end_ms - start_ms) < self.min_range_steps * step:
            return RouteDecision(RAW)
        horizon = now_ms - self.raw_window_ms
        if start_ms >= horizon:
            return RouteDecision(RAW)
        if end_ms <= horizon:
            return RouteDecision(res)
        # straddling range: family body [start, seam), raw tail [seam, end]
        # — the seam lands on the query's step grid so the stitched matrix
        # is exactly the grid the raw-only execution would produce
        k = -(-(horizon - start_ms) // step)      # ceil division
        seam = start_ms + k * step
        if seam > end_ms:
            return RouteDecision(res)
        return RouteDecision(res, seam_ms=seam)


class RetentionRouter:
    """Per-dataset router installed on the RAW engine (engine.retention).

    ``family_engine(resolution_ms) -> QueryEngine | None`` resolves the
    serving engine of a downsample family (FiloServer: the refreshed
    ``engines[ds_family(...)]`` view); None — the family has not published
    yet — falls back to raw, never to an error: routing is an optimization,
    raw correctness is the floor."""

    def __init__(self, policy: RetentionPolicy, family_engine,
                 dataset: str = "", now_fn=None):
        self.policy = policy
        self.family_engine = family_engine
        self.dataset = dataset
        # data-time "now": the raw engine's ingest lead (wall clock would
        # route every backfilled test/bench workload to the families)
        self.now_fn = now_fn

    def _now_ms(self, engine) -> int:
        if self.now_fn is not None:
            return int(self.now_fn())
        # O(shards): each shard maintains its lead watermark at stage time —
        # scanning last_ts here would cost O(max_series) per query
        lead = 0
        for sh in engine.memstore.shards_of(engine.dataset):
            lead = max(lead, int(getattr(sh, "lead_ms", 0)))
        return lead

    def _decide(self, engine, start_ms, end_ms, step_ms,
                resolution: str | None) -> RouteDecision:
        override = (self.policy.parse_override(resolution)
                    if resolution is not None else None)
        return self.policy.decide(start_ms, end_ms, step_ms,
                                  self._now_ms(engine), override)

    @staticmethod
    def _tag(res: QueryResult, label: str) -> QueryResult:
        if res.stats is None:
            res.stats = QueryStats()
        res.stats.resolution = label
        res.exec_path = f"retention[{label}]:{res.exec_path}"
        return res

    def _count(self, label: str) -> None:
        registry.counter(FILODB_RETENTION_ROUTED_QUERIES,
                         {"dataset": self.dataset or "",
                          "resolution": label}).increment()

    def route_range(self, engine, promql: str, start_ms: int, end_ms: int,
                    step_ms: int, tenant: str | None,
                    resolution: str | None) -> QueryResult | None:
        """A routed/stitched QueryResult, or None to serve raw (the caller
        then runs its normal path and tags resolution="raw")."""
        dec = self._decide(engine, start_ms, end_ms, step_ms, resolution)
        if dec.resolution_ms == RAW:
            return None
        fam = self.family_engine(dec.resolution_ms)
        if fam is None:
            if resolution is not None:
                # an EXPLICIT override must not be silently substituted —
                # the caller asked for a specific tier (the same loud-fail
                # contract as route_instant and the old dataset-swap fix)
                raise QueryError(
                    f"resolution {resolution_label(dec.resolution_ms)!r} "
                    "has no published downsample data yet")
            # auto decision, family not published/loaded yet: raw still
            # holds the truth — routing is an optimization, not a tier
            log.debug("retention: no serving engine for %s; raw fallback",
                      resolution_label(dec.resolution_ms))
            return None
        label = dec.label
        with span(SPAN_QUERY_RETENTION, dataset=self.dataset,
                  resolution=label, stitched=dec.seam_ms is not None):
            self._count(label)
            if dec.seam_ms is None:
                out = fam.query_range(promql, start_ms, end_ms, step_ms,
                                      tenant=tenant,
                                      min_window_ms=dec.resolution_ms)
                return self._tag(out, label)
            # stitched: downsampled body up to the seam, raw tail from it —
            # the raw leg bypasses routing (it IS the raw tier's share)
            body = fam.query_range(promql, start_ms, dec.seam_ms - step_ms,
                                   step_ms, tenant=tenant,
                                   min_window_ms=dec.resolution_ms)
            tail = engine.query_range(promql, dec.seam_ms, end_ms, step_ms,
                                      tenant=tenant, _skip_routing=True)
            from ..parallel.cluster import stitch_matrices
            stitched = QueryResult(
                stitch_matrices([body.matrix.to_host(),
                                 tail.matrix.to_host()]),
                warnings=list(body.warnings) + list(tail.warnings))
            stats = QueryStats()
            for leg in (body, tail):
                if leg.stats is not None:
                    stats.merge(leg.stats)
            stitched.stats = stats
            stitched.exec_path = (f"retention[{label}]:"
                                  f"stitch({body.exec_path} | "
                                  f"{tail.exec_path})")
            stats.resolution = label
            return stitched

    def route_instant(self, engine, promql: str, time_ms: int,
                      tenant: str | None,
                      resolution: str | None) -> QueryResult | None:
        """Instant queries route only when overridden (auto-routing keys on
        the step, which an instant query does not have)."""
        if resolution is None:
            return None
        override = self.policy.parse_override(resolution)
        if override == RAW:
            return None
        fam = self.family_engine(override)
        label = resolution_label(override)
        if fam is None:
            raise QueryError(
                f"resolution {label!r} has no published downsample data yet")
        with span(SPAN_QUERY_RETENTION, dataset=self.dataset,
                  resolution=label, stitched=False):
            self._count(label)
            out = fam.query_instant(promql, time_ms, tenant=tenant,
                                    min_window_ms=override)
            return self._tag(out, label)
