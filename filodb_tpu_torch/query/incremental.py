"""Incremental serving: delta evaluation of cached per-step results.

Reference: the reference FiloDB's time-split routing + StitchRvsExec treat
the time axis as the long axis — results over a range are concatenations of
per-step columns, so a shifted dashboard window should EXTEND a cached
result, not recompute it (SURVEY §5: the single biggest lever at
dashboard traffic). This module is that materialization layer:

  * :class:`FragmentCache` — per-(promql, step, tenant) entries holding the
    per-step output columns of one range query (the presented form of the
    fused kernels' ``[G, Tp]`` accumulators: column t IS the step-t partial
    aggregate, which is why per-step reuse composes bit-identically). A
    probe against a shifted window ``[t0+Δ, t1+Δ)`` returns the reusable
    overlap plus the head/tail sub-ranges still to compute.

  * per-step validity instead of the result cache's all-or-nothing
    watermark equality: every shard's ``data_epoch`` bump logs the minimum
    data timestamp it can have affected (core/memstore.py
    ``_bump_epoch_locked``). :func:`stable_before` folds the logs between
    an entry's recorded epoch vector and the current one into ONE
    timestamp bound: a cached step t remains provably
    identical to re-execution iff ``t < bound``, because PromQL evaluation
    at step t reads only data at timestamps <= t (windows, offsets and
    staleness lookback reach strictly backward; plans that break the rule
    — ``@`` pins, render-order sorts — are never stored, see
    :func:`plan_cacheable`). An uncovered gap in a log reads as
    full invalidation, never a stale serve.

  * :func:`poll_increment` / :class:`QuerySubscription` — the same
    machinery as a streaming surface: increments are the steps newly
    covered by the shard ``data_epoch``/lead watermarks since the caller's
    ``since``, evaluated as a normal (fragment-cached) range query. The
    HTTP long-poll/chunked endpoint is the stateless form; the rules
    evaluator is the degenerate subscriber (one buffered step per tick,
    catch-up batched into one range query).

Host copy of ``filodb_tpu/query/incremental.py`` (pure Python over host
numpy columns; imports re-pointed at the port's modules). The cached
columns are host f64, whichever device computed them. The port has no
peers yet, so every epoch log is a local shard's; the HTTP endpoint and the
rules evaluator arrive with the port's serving layer.
"""

from __future__ import annotations

import threading

from collections import OrderedDict

import numpy as np

from ..core.memstore import EPOCH_AFFECTS_ALL
from ..utils.metrics import (FILODB_QUERY_FRAGMENT_CACHE_BYTES,
                             FILODB_QUERY_FRAGMENT_CACHE_EVICTIONS,
                             FILODB_QUERY_FRAGMENT_CACHE_EXTENSIONS,
                             FILODB_QUERY_FRAGMENT_CACHE_HITS,
                             FILODB_QUERY_FRAGMENT_CACHE_INVALIDATIONS,
                             FILODB_QUERY_FRAGMENT_CACHE_MISSES, registry)
from ..utils.tracing import SPAN_QUERY_SUBSCRIBE, span

# "every cached step stays valid" — nothing mutated since the entry's vector
STABLE_FOREVER = 1 << 62


def stable_before(recorded, current, logs) -> int | None:
    """The timestamp bound under which cached per-step results recorded at
    epoch vector ``recorded`` remain provably identical to re-execution at
    ``current``: the minimum "min affected data timestamp" over every
    visibility bump between the two vectors, across every shard.

    ``logs`` maps ``(origin, shard)`` -> [(epoch, min_affected_ms), ...]
    (each shard's recent bump provenance). Returns ``STABLE_FOREVER`` when
    the vectors are equal, ``None`` when nothing is provable — a shard
    went backward or vanished (restart/topology change), a log gap hides
    bumps, or a destructive bump (EPOCH_AFFECTS_ALL) landed."""
    if recorded == current:
        return STABLE_FOREVER
    rec = {(o, str(s)): int(e) for o, s, e in recorded}
    cur = {(o, str(s)): int(e) for o, s, e in current}
    if rec.keys() != cur.keys():
        return None
    bound = STABLE_FOREVER
    for k, c in cur.items():
        r = rec[k]
        if c == r:
            continue
        if c < r:
            return None           # epoch went backward: different store
        covered = [m for e, m in (logs.get(k) or ()) if r < e <= c]
        if len(covered) != c - r:
            return None           # log gap: bumps we cannot account for
        m = min(covered)
        if m <= EPOCH_AFFECTS_ALL:
            return None           # destructive mutation: nothing provable
        bound = min(bound, m)
    return bound


class FragmentHit:
    """One reusable probe outcome: the entry's still-valid columns plus the
    sub-ranges the caller must compute to answer ``[start, end]``."""

    __slots__ = ("keep_ts", "keep_vals", "keys", "warnings", "missing",
                 "reused_steps")

    def __init__(self, keep_ts, keep_vals, keys, warnings, missing,
                 reused_steps):
        self.keep_ts = keep_ts          # int64 [Tk] — contiguous step grid
        self.keep_vals = keep_vals      # f64 [P, Tk]
        self.keys = keys                # list[RangeVectorKey]
        self.warnings = warnings        # list[str] recorded with the entry
        self.missing = missing          # [(lo_ms, hi_ms)] head/tail ranges
        self.reused_steps = reused_steps  # request steps served from cache


class _Fragment:
    __slots__ = ("start", "end", "step", "out_ts", "vals", "keys",
                 "warnings", "epochs", "nbytes")

    def __init__(self, out_ts, vals, keys, warnings, epochs, step):
        self.out_ts = out_ts
        self.vals = vals
        self.keys = keys
        self.warnings = warnings
        self.epochs = epochs
        self.step = step
        self.start = int(out_ts[0])
        self.end = int(out_ts[-1])
        # conservative per-entry footprint: value block + grid + key labels
        self.nbytes = int(vals.nbytes + out_ts.nbytes
                          + sum(sum(len(k) + len(v) + 16 for k, v in key.labels)
                                + 32 for key in keys))


class FragmentCache:
    """Per-step fragment cache behind the incremental serving path.

    Entries are keyed on ``(promql, step, tenant, min_window)`` — NOT on
    start/end, because the time range is exactly what a sliding dashboard
    changes per tick. Each entry holds one contiguous step-grid fragment
    (host f64 columns), the warnings of its producing execution, and the
    epoch VECTOR captured before that execution; validity at probe time is
    per step via :func:`stable_before`, so one ingest bump at the lead
    invalidates only the steps it can influence instead of the whole entry.

    Bounded twice, with eviction accounting for both: LRU over ``capacity``
    entries AND over ``max_bytes`` total value bytes (fragments have wildly
    variable sizes — an entry bound alone would not bound memory); a single
    fragment over the byte bound is simply not cached."""

    def __init__(self, capacity: int = 256, max_bytes: int = 64 << 20,
                 max_steps: int = 4096, tags: dict | None = None):
        self.capacity = max(1, int(capacity))
        self.max_bytes = max(1, int(max_bytes))
        # per-entry step bound: subscriptions extend one step per tick and
        # would otherwise grow an entry without limit; trimming drops the
        # oldest (head) steps — the ones a sliding window evicts anyway
        self.max_steps = max(2, int(max_steps))
        self.tags = dict(tags or {})
        self._entries: OrderedDict[tuple, _Fragment] = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self._hits = registry.counter(FILODB_QUERY_FRAGMENT_CACHE_HITS,
                                      self.tags)
        self._misses = registry.counter(FILODB_QUERY_FRAGMENT_CACHE_MISSES,
                                        self.tags)
        self._extensions = registry.counter(
            FILODB_QUERY_FRAGMENT_CACHE_EXTENSIONS, self.tags)
        self._evictions = registry.counter(
            FILODB_QUERY_FRAGMENT_CACHE_EVICTIONS, self.tags)
        self._invalidations = registry.counter(
            FILODB_QUERY_FRAGMENT_CACHE_INVALIDATIONS, self.tags)
        self._bytes_gauge = registry.gauge(
            FILODB_QUERY_FRAGMENT_CACHE_BYTES, self.tags)

    # -- probe ----------------------------------------------------------------

    def probe(self, key: tuple, start: int, end: int, step: int,
              current_epochs, logs) -> FragmentHit | None:
        """A :class:`FragmentHit` when the entry under ``key`` can
        contribute to (or contiguously extend into) ``[start, end]`` at
        ``step``, else None. Steps at or past the :func:`stable_before`
        bound are treated as missing; an entry with NO provably-valid step
        left is dropped (counted as an invalidation)."""
        step = max(int(step), 1)
        with self._lock:
            e = self._entries.get(key)
            if e is None or current_epochs is None:
                self._misses.increment()
                return None
            if e.step != step or (start - e.start) % step != 0:
                self._misses.increment()
                return None           # off-grid request: full execution
            bound = stable_before(e.epochs, current_epochs, logs or {})
            if bound is None:
                self._drop_locked(key, e)
                self._invalidations.increment()
                self._misses.increment()
                return None
            # last entry step still provably valid (t < bound)
            ve = min(e.end, e.start + ((bound - 1 - e.start) // step) * step) \
                if bound <= e.end else e.end
            if ve < e.start:
                self._drop_locked(key, e)
                self._invalidations.increment()
                self._misses.increment()
                return None
            if start > ve + step or end < e.start - step:
                # a gap between the request and the valid fragment would
                # leave a hole in the merged grid — full execution
                self._misses.increment()
                return None
            missing = []
            if start < e.start:
                missing.append((start, e.start - step))
            tail_lo = max(ve + step, start)
            if tail_lo <= end:
                missing.append((tail_lo, end))
            r_lo, r_hi = max(start, e.start), min(end, ve)
            reused = (r_hi - r_lo) // step + 1 if r_lo <= r_hi else 0
            k1 = (ve - e.start) // step + 1
            keep_ts = e.out_ts[:k1]
            keep_vals = e.vals[:, :k1]
            self._entries.move_to_end(key)
            (self._hits if reused else self._misses).increment()
            return FragmentHit(keep_ts, keep_vals, list(e.keys),
                               list(e.warnings), missing, reused)

    # -- store ----------------------------------------------------------------

    def store(self, key: tuple, out_ts, vals, keys, warnings, epochs,
              step: int, extended: bool = False) -> None:
        """Replace the entry under ``key`` with a (merged) fragment: a
        contiguous host grid ``out_ts`` + f64 columns ``vals``. Trims the
        oldest steps past ``max_steps`` (the sliding window's evicted
        head), refuses unverifiable vectors, and enforces both bounds."""
        if epochs is None or len(out_ts) == 0:
            return                    # unverifiable / empty: never cache
        step = max(int(step), 1)
        out_ts = np.asarray(out_ts, np.int64)
        vals = np.asarray(vals, np.float64)
        if vals.ndim != 2 or vals.shape[1] != len(out_ts):
            return                    # non-columnar payload: not cacheable
        if len(out_ts) > 1 and (int(out_ts[-1]) - int(out_ts[0])
                                != (len(out_ts) - 1) * step):
            return                    # non-contiguous grid: not cacheable
        if len(out_ts) > self.max_steps:
            out_ts = out_ts[-self.max_steps:]
            vals = vals[:, -self.max_steps:]
        frag = _Fragment(out_ts, np.ascontiguousarray(vals), list(keys),
                         list(warnings or ()), epochs, step)
        with self._lock:
            if frag.nbytes > self.max_bytes:
                return                # one oversized fragment: skip, keep old
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._entries[key] = frag
            self._bytes += frag.nbytes
            while len(self._entries) > self.capacity \
                    or self._bytes > self.max_bytes:
                _, victim = self._entries.popitem(last=False)
                self._bytes -= victim.nbytes
                self._evictions.increment()
            self._bytes_gauge.update(float(self._bytes))
        if extended:
            self._extensions.increment()

    def _drop_locked(self, key: tuple, e: _Fragment) -> None:
        del self._entries[key]
        self._bytes -= e.nbytes
        self._bytes_gauge.update(float(self._bytes))

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0
            self._bytes_gauge.update(0.0)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {"size": len(self._entries), "capacity": self.capacity,
                    "bytes": self._bytes, "max_bytes": self.max_bytes,
                    "max_steps": self.max_steps,
                    "hits": self._hits.value, "misses": self._misses.value,
                    "extensions": self._extensions.value,
                    "evictions": self._evictions.value,
                    "invalidations": self._invalidations.value}

    def entries_debug(self) -> list[dict]:
        """Per-entry byte accounting for ``/api/v1/debug/fragment_cache``."""
        with self._lock:
            return [{"promql": key[0], "step_ms": key[1],
                     "tenant": key[2], "min_window_ms": key[3],
                     "start_ms": e.start, "end_ms": e.end,
                     "steps": len(e.out_ts), "series": len(e.keys),
                     "bytes": e.nbytes}
                    for key, e in self._entries.items()]


# ---------------------------------------------------------------------------
# plan gating: which plans may enter the fragment cache
# ---------------------------------------------------------------------------

def plan_cacheable(plan) -> bool:
    """True when every step of ``plan``'s output depends only on data at
    timestamps <= that step (the per-step validity rule's premise) AND the
    rendered output is step-local. ``@`` pins read a FIXED timestamp that
    may lie past any given step, and sort/sort_desc order series by values
    across the whole range — neither composes from per-step fragments."""
    from . import logical as L
    stack = [plan]
    while stack:
        node = stack.pop()
        if isinstance(node, (L.ApplyAtTimestamp, L.ApplySortFunction)):
            return False
        stack.extend(child for _, child in L.child_plans(node))
    return True


# ---------------------------------------------------------------------------
# streaming: per-step increments as the ingest watermarks advance
# ---------------------------------------------------------------------------

def data_lead_ms(engine) -> int:
    """The engine's local QUERY-VISIBLE data-time lead (max sample ts
    landed on the device store / loaded by recovery, across its shards) —
    the watermark streaming increments chase. Deliberately NOT the staged
    ``lead_ms``: an increment cut at a staged-but-unflushed lead would
    serve its step without the staged samples, and the forward-only
    cursor would never re-deliver it."""
    lead = 0
    for sh in engine.memstore.shards_of(engine.dataset):
        lead = max(lead, int(getattr(sh, "visible_lead_ms", 0)))
    return lead


# steps one increment may carry: bounds the range query a stale (or
# zero/default) cursor would otherwise trigger — the subscriber gets the
# NEWEST window and a next_since cursor that skips the uncoverable gap
POLL_MAX_STEPS = 256


def poll_increment(engine, promql: str, step_ms: int, since_ms: int,
                   tenant: str | None = None):
    """One stateless streaming increment: evaluate the steps on
    ``since_ms``'s grid newly covered by the data lead, as a normal range
    query (so the fragment cache makes each increment a pure tail
    extension). Returns ``(result | None, next_since_ms)`` — None when no
    new step is covered yet. An evaluated increment is one
    ``query.subscribe`` span (tags: dataset, steps)."""
    step = max(int(step_ms), 1)
    since = int(since_ms)
    lead = data_lead_ms(engine)
    if lead <= 0:
        return None, since            # nothing visible yet: keep waiting
    target = since + ((lead - since) // step) * step
    if target <= since:
        return None, since
    if (target - since) // step > POLL_MAX_STEPS:
        since = target - POLL_MAX_STEPS * step
    with span(SPAN_QUERY_SUBSCRIBE, dataset=engine.dataset) as tags:
        res = engine.query_range(promql, since + step, target, step,
                                 tenant=tenant)
        tags["steps"] = len(res.matrix.out_ts)
    return res, target


class QuerySubscription:
    """Stateful per-step subscriber over one range expression — the form
    the rules evaluator consumes (each scheduler tick takes exactly its
    grid step; catch-up after a stall prefetches the whole span as ONE
    range query instead of one full-window evaluation per missed tick).

    ``take(ts)`` returns the step-``ts`` instant vector as
    ``[(RangeVectorKey, value), ...]`` with absent (NaN) points dropped —
    bit-identical to ``query_instant`` at ``ts`` by per-step independence
    — or None when ``ts`` predates the buffer (caller falls back to the
    instant path). Delivered steps stay buffered (bounded ring) so a held
    watermark re-delivers identically."""

    def __init__(self, engine, promql: str, step_ms: int,
                 tenant: str | None = None, buffer_steps: int = 128):
        self.engine = engine
        self.promql = promql
        self.step_ms = max(int(step_ms), 1)
        self.tenant = tenant
        self.buffer_steps = max(4, int(buffer_steps))
        self._buf: OrderedDict[int, list] = OrderedDict()
        self._last: int | None = None
        self._lock = threading.Lock()

    def prefetch(self, from_ts: int, to_ts: int) -> None:
        """Buffer every step of ``[from_ts, to_ts]`` in one range query —
        the catch-up batcher (a failed evaluation is swallowed here: the
        per-tick take() falls back to the instant path, which reports)."""
        from ..utils.metrics import FILODB_SWALLOWED_ERRORS
        try:
            self._eval(int(from_ts), int(to_ts))
        except Exception:  # noqa: BLE001 — best-effort prefetch; the tick
            # itself falls back to the instant path, whose failure is the
            # one counted and surfaced per rule
            registry.counter(FILODB_SWALLOWED_ERRORS,
                             {"site": "subscription_prefetch"}).increment()

    def take(self, eval_ts: int):
        eval_ts = int(eval_ts)
        with self._lock:
            got = self._buf.get(eval_ts)
            if got is not None:
                return got
            last = self._last
        if last is not None and eval_ts <= last:
            return None               # evicted from the ring: fall back
        lo = eval_ts
        if last is not None and (eval_ts - last) % self.step_ms == 0:
            lo = min(eval_ts, last + self.step_ms)
        self._eval(lo, eval_ts)
        with self._lock:
            return self._buf.get(eval_ts)

    def _eval(self, lo: int, hi: int) -> None:
        res = self.engine.query_range(self.promql, lo, hi, self.step_ms,
                                      tenant=self.tenant)
        m = res.matrix.to_host()
        vals = np.asarray(m.values)
        with self._lock:
            for j, t in enumerate(np.asarray(m.out_ts).tolist()):
                col = vals[:, j]
                self._buf[int(t)] = [
                    (key, float(col[i])) for i, key in enumerate(m.keys)
                    if not np.isnan(col[i])]
            while len(self._buf) > self.buffer_steps:
                self._buf.popitem(last=False)
            self._last = max(self._last or hi, hi)
