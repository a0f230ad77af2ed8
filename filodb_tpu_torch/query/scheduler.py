"""Priority query scheduler — the QueryActor priority-mailbox equivalent.

Host copy of ``filodb_tpu/query/scheduler.py`` (pure Python; imports
re-pointed at the port's modules): the scheduler and the engine's
cost-based admission gate.

Reference: coordinator/.../QueryActor.scala:22-34 — a bounded priority mailbox
where admin/status commands jump ahead of query work, and queries execute on a
dedicated query scheduler so ingest threads are never blocked. Here: a fixed
worker pool draining a priority heap (FIFO within a class), with a queue bound
that sheds load as 503-style errors instead of queueing unboundedly.

Priorities (lower runs first, matching the reference's mailbox ordering where
ThrowException/status admin messages outrank LogicalPlan2Query):
  ADMIN (0)    — status/health probes injected into the query lane
  METADATA (1) — label values / series lookups (cheap, index-only)
  QUERY (2)    — PromQL execution
"""

from __future__ import annotations

import contextlib
import heapq
import itertools
import logging
import threading
from concurrent.futures import Future, InvalidStateError
from enum import IntEnum

from ..utils.metrics import (FILODB_QUERY_ADMISSION_COST,
                             FILODB_QUERY_ADMISSION_OVERSIZED,
                             FILODB_QUERY_ADMISSION_SHED,
                             FILODB_SCHEDULER_WORKER_ERRORS, registry)
from .rangevector import QueryError

log = logging.getLogger("filodb_tpu_torch.scheduler")


class Priority(IntEnum):
    ADMIN = 0
    METADATA = 1
    QUERY = 2


class SchedulerBusy(RuntimeError):
    """Raised when the bounded queue is full (maps to HTTP 503)."""


class AdmissionRejected(QueryError):
    """Cost-based admission shed: the query's estimated cost does not fit
    the configured in-flight budget (or its tenant's quota). Maps to HTTP
    503 + Retry-After — retryable load shedding, never a bad query (the
    same posture as the peer breaker's fast shed)."""

    def __init__(self, msg: str, retry_after_s: float = 1.0,
                 cost: float = 0.0, tenant: str | None = None):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)
        self.cost = float(cost)
        self.tenant = tenant


class AdmissionController:
    """Bounded concurrent-cost gate for query execution (ref: the
    reference's query-limits / per-dataset scheduling config in
    filodb-defaults.conf — here the unit is the planner's cost estimate,
    roughly samples touched: series x steps x window-steps with a
    narrow-residency discount).

    Unlike the scheduler's QUEUE bound (which counts queries), this bounds
    the aggregate WORK admitted to execute at once: one 1M-series monster
    and a thousand single-series panels are no longer the same load. Over
    budget => immediate AdmissionRejected (503 + Retry-After); nothing
    queues here — the caller owns backoff, exactly like the broker's
    RETRY shed."""

    def __init__(self, max_cost: float | None,
                 tenant_quotas: dict | None = None,
                 retry_after_s: float = 1.0, tags: dict | None = None):
        # None = unbounded global budget: a quota-only deployment (only
        # query.tenant_quotas set) still enforces its per-tenant caps
        self.max_cost = float(max_cost) if max_cost is not None else None
        self.tenant_quotas = {str(k): float(v)
                              for k, v in (tenant_quotas or {}).items()}
        self.retry_after_s = float(retry_after_s)
        # per-controller metric identity (e.g. {"dataset": ...}): untagged,
        # two engines' controllers would overwrite one process-shared gauge
        self.tags = dict(tags or {})
        self._lock = threading.Lock()
        self._in_use = 0.0
        self._tenant_use: dict[str, float] = {}
        self._gauge = registry.gauge(FILODB_QUERY_ADMISSION_COST, self.tags)

    def _count_shed(self, key: str | None) -> None:
        registry.counter(FILODB_QUERY_ADMISSION_SHED,
                         dict(self.tags, tenant=key or "none")).increment()

    def _count_oversized(self, key: str | None) -> None:
        # distinct from the shed counter: these never answered 503, so an
        # operator alerting on sheds as overload signal must not see them
        registry.counter(FILODB_QUERY_ADMISSION_OVERSIZED,
                         dict(self.tags, tenant=key or "none")).increment()

    def acquire(self, cost: float, tenant: str | None = None) -> float:
        """Reserve ``cost`` units or raise. Returns the (floored) cost
        actually reserved — pass it back to release().

        Two distinct rejections: a query that does not fit RIGHT NOW (other
        queries hold the budget) sheds retryable AdmissionRejected (503 +
        Retry-After — backoff will land it); a query whose own cost exceeds
        the absolute budget or its tenant's quota could NEVER be admitted,
        so it fails as a non-retryable QueryError (422) instead of
        livelocking an honored-backoff client forever."""
        cost = max(float(cost), 1.0)
        key = str(tenant) if tenant is not None else None
        with self._lock:
            quota = self.tenant_quotas.get(key) if key is not None else None
            over_global = self.max_cost is not None and cost > self.max_cost
            if over_global or (quota is not None and cost > quota):
                limit, which = ((quota, "tenant quota")
                                if quota is not None and cost > quota
                                else (self.max_cost, "cost budget"))
                self._count_oversized(key)
                raise QueryError(
                    f"query cost {cost:.0f} exceeds the configured {which} "
                    f"({limit:.0f}) outright and can never be admitted; "
                    "narrow the selector, range, or step")
            t_use = self._tenant_use.get(key, 0.0) if key is not None else 0.0
            if (self.max_cost is not None
                    and self._in_use + cost > self.max_cost) \
                    or (quota is not None and t_use + cost > quota):
                which = ("tenant quota" if quota is not None
                         and t_use + cost > quota else "cost budget")
                in_flight = (f"{self._in_use:.0f}/{self.max_cost:.0f}"
                             if which == "cost budget"
                             else f"{t_use:.0f}/{quota:.0f}")
                self._count_shed(key)
                raise AdmissionRejected(
                    f"query shed: estimated cost {cost:.0f} over the "
                    f"{which} ({in_flight} in flight); retry after backoff",
                    retry_after_s=self.retry_after_s, cost=cost,
                    tenant=tenant)
            self._in_use += cost
            if key is not None:
                self._tenant_use[key] = t_use + cost
            self._gauge.update(self._in_use)
        return cost

    def release(self, cost: float, tenant: str | None = None) -> None:
        key = str(tenant) if tenant is not None else None
        with self._lock:
            self._in_use = max(self._in_use - cost, 0.0)
            if key is not None:
                left = self._tenant_use.get(key, 0.0) - cost
                if left > 0:
                    self._tenant_use[key] = left
                else:
                    self._tenant_use.pop(key, None)
            self._gauge.update(self._in_use)

    @contextlib.contextmanager
    def admitted(self, cost: float, tenant: str | None = None):
        got = self.acquire(cost, tenant)
        try:
            yield got
        finally:
            self.release(got, tenant)

    def stats(self) -> dict:
        with self._lock:
            return {"in_use": self._in_use, "max_cost": self.max_cost,
                    "tenants": dict(self._tenant_use)}


class QueryScheduler:
    """Bounded priority-queue worker pool for query execution."""

    def __init__(self, num_threads: int = 4, max_queue: int = 64,
                 timeout_s: float = 60.0, name: str = "query-sched"):
        self.timeout_s = timeout_s
        self._heap: list[tuple[int, int, Future, object]] = []
        self._seq = itertools.count()      # FIFO tiebreak within a priority
        self._cv = threading.Condition()
        self._max_queue = max_queue
        self._shutdown = False
        self._queued = registry.gauge(f"{name}_queued")
        self._active = registry.gauge(f"{name}_active")
        self._rejected = registry.counter(f"{name}_rejected")
        self._completed = registry.counter(f"{name}_completed")
        self._n_active = 0
        self._threads = [
            threading.Thread(target=self._worker, name=f"{name}-{i}", daemon=True)
            for i in range(num_threads)
        ]
        for t in self._threads:
            t.start()

    def submit(self, fn, priority: Priority = Priority.QUERY) -> Future:
        """Enqueue ``fn`` for execution; raises SchedulerBusy over the bound.

        ADMIN work is never shed — the reference guarantees status probes get
        through even when the query mailbox is saturated.
        """
        fut: Future = Future()
        with self._cv:
            if self._shutdown:
                raise RuntimeError("scheduler is shut down")
            if priority != Priority.ADMIN and len(self._heap) >= self._max_queue:
                self._rejected.increment()
                raise SchedulerBusy(
                    f"query queue full ({self._max_queue} waiting); retry later")
            heapq.heappush(self._heap, (int(priority), next(self._seq), fut, fn))
            self._queued.update(len(self._heap))
            self._cv.notify()
        return fut

    def run(self, fn, priority: Priority = Priority.QUERY,
            timeout_s: float | None = None):
        """Submit and wait — the blocking path used by the HTTP handlers.
        Times out with concurrent.futures.TimeoutError (mapped to HTTP 504);
        the abandoned task still completes on its worker."""
        return self.submit(fn, priority).result(
            timeout=self.timeout_s if timeout_s is None else timeout_s)

    def _worker(self) -> None:
        # the outer guard surfaces faults in the LOOP MACHINERY itself
        # (heap/future/metrics bookkeeping): a silently-dead worker shrinks
        # the pool until the queue backs up with nothing in the logs, so any
        # such fault is logged + counted and the worker keeps serving
        # (filolint: resource-worker-silent-death)
        while True:
            fut = None
            claimed = released = False
            try:
                with self._cv:
                    while not self._heap and not self._shutdown:
                        # bounded park: a lost notify (or a shutdown racing
                        # the wait) re-checks the predicate within a second
                        # instead of stranding the worker forever
                        # (filolint: live-wait-no-timeout)
                        self._cv.wait(timeout=1.0)
                    if self._shutdown and not self._heap:
                        return
                    _, _, fut, fn = heapq.heappop(self._heap)
                    self._queued.update(len(self._heap))
                    self._n_active += 1
                    claimed = True
                    self._active.update(self._n_active)
                try:
                    if fut.set_running_or_notify_cancel():
                        try:
                            fut.set_result(fn())
                        except BaseException as e:  # noqa: BLE001 — delivered to caller
                            fut.set_exception(e)
                finally:
                    with self._cv:
                        self._n_active -= 1
                        released = True
                        self._active.update(self._n_active)
                    self._completed.increment()
            except Exception as e:  # noqa: BLE001 — worker survives, fault counted
                log.exception("query-scheduler worker-loop fault (worker "
                              "kept alive)")
                registry.counter(FILODB_SCHEDULER_WORKER_ERRORS).increment()
                # never strand the submitter on a bookkeeping fault: the
                # popped future must complete, and a claimed-but-unreleased
                # active slot must be returned or stats()/shedding skew
                if fut is not None and not fut.done():
                    try:
                        fut.set_exception(e)
                    except InvalidStateError:
                        pass    # racing completion: the caller has a result
                if claimed and not released:
                    with self._cv:
                        self._n_active -= 1

    def stats(self) -> dict:
        with self._cv:
            return {"queued": len(self._heap), "active": self._n_active,
                    "rejected": self._rejected.value,
                    "completed": self._completed.value}

    def shutdown(self, wait: bool = True) -> None:
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()
        if wait:
            for t in self._threads:
                t.join(timeout=5.0)
