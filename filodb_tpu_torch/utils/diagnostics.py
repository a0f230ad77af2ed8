"""Concurrency diagnostics — config-gated runtime checking of the port's
locking discipline.

Port of ``filodb_tpu/utils/diagnostics.py``. Reference analogs, re-shaped
for this design:
  - FiloSchedulers.assertThreadName (core/.../memstore/FiloSchedulers.scala:12-16,
    gated by ``scheduler.enable-assertions``): here the protected resource is
    the SHARD LOCK — store mutations and query tensor captures must hold it.
    ``assert_owned`` checks RLock ownership at the hot entry points.
  - ChunkMap's shared-lock deadlock warnings / leaked-lock counters
    (memory/.../data/ChunkMap.scala:22-45): ``TimedRLock`` warns when the
    shard lock is held longer than a threshold and counts contentions and
    long holds (exported per shard on every /metrics scrape); under
    ``FILODB_LOCK_DEBUG=1`` it asserts ``LOCK_ORDER``, times every hold
    into ``filodb_lock_hold_ms{class=...}`` and registers with a watchdog
    that flags a wedged holder while it still holds.

The reference's ``DonationDetective`` and ``explain_deleted_buffer`` have
no port: they name the site that donated (deleted) a jax buffer a query
still held, and the port updates its store tensors in place — no buffer is
ever donated or deleted, so there is nothing to explain. The shard lock's
job is the same: a query captures the store's tensors and launches its
kernels under the lock a flush takes to mutate them.

All checks are off by default (zero overhead beyond an ``if``); enable with
``filodb_tpu_torch.utils.diagnostics.enable()`` or config
``diagnostics.enabled``.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import traceback

log = logging.getLogger(__name__)

enabled = False

HOLD_WARN_S = 5.0      # ChunkMap-style "lock held too long" warning threshold

# Global lock acquisition order (rank increases left to right): a thread may
# only acquire a lock whose rank is STRICTLY greater than every ranked lock
# it already holds (reentrant re-acquisition of the same object excepted).
# Derived statically by filodb_tpu_torch/analysis/lockcheck.py from the
# nested-with graph (group_flush -> {sink, shard}, sink -> shard) and
# asserted at runtime here when FILODB_LOCK_DEBUG=1. The static checker and
# this constant must agree — tests/test_torch_static_analysis.py
# cross-checks them.
LOCK_ORDER = ("group_flush", "sink", "shard")

_LOCK_RANK = {c: i for i, c in enumerate(LOCK_ORDER)}

# Liveness contract surface, enforced by filodb_tpu_torch/analysis/livecheck.py
# (pure literal — the checker reads it from the AST like EPOCH_SPEC).
#   "locks"      — owner-attribute name -> lock class: the lock shapes the
#                  live-block-under-lock rule tracks (lexical `with`,
#                  enter_context over one or all of them, assert_owned,
#                  and the `_locked`-suffix caller-holds contract on
#                  classes that own one of these attributes).
#   "blocking"   — leaf callee name -> kind: the blocking-call taxonomy.
#                  A call with one of these leaves can park the calling
#                  thread on I/O, a peer, or the clock. The port adds the
#                  "device-sync" kind (``.cpu()``, ``.item()``,
#                  ``torch.cuda.synchronize``): a host copy or a stream
#                  wait blocks the host until every kernel queued ahead of
#                  it on the stream has run, so under the shard lock it
#                  stalls ingest and every other query for the card's
#                  backlog (the reference's jit-host-sync, as data).
#   "blocking_attr_calls" — the sink protocol's blocking surface:
#                  ``self.sink.*`` resolves to nothing in the call graph
#                  (duck-typed), so its file/network methods are declared
#                  here the way EPOCH_SPEC declares visible_calls.
#   "sites"      — sanctioned block-under-lock sites. Every entry carries
#                  a REQUIRED reason string saying what bounds the block
#                  and who guarantees progress; a reason-less entry is
#                  itself a finding. Sanction extends to helpers reachable
#                  ONLY from declared sites (reverse-call closure).
#   "wait_ok"    — declared shutdown-aware wait wrappers exempt from
#                  live-wait-no-timeout (same shape + reason rule).
#   "retry_ok"   — sanctioned serve loops exempt from live-unbounded-retry
#                  ONLY (same shape + reason rule): a loop whose "retry" is
#                  answering the next request, bounded by connection
#                  lifetime rather than an attempt counter. The sanction
#                  does NOT extend to blocking under locks.
#   "pacing_calls" — leaf callee names that pace a bounded retry loop the
#                  way a sleep would: waits on the device/kernel, not a
#                  hot spin (synchronize retires in-flight device work; a
#                  timed select parks in the kernel).
# Undeclared blocking under a lock, unbounded socket I/O, bound-less or
# backoff-less retry loops, and timeout-less waits are tier-1 failures —
# see ANALYSIS.md "Liveness & bounded-wait contracts".
LATENCY_SPEC = {
    "locks": {
        "lock": "shard",
        "owner_lock": "shard",
        "_sink_lock": "sink",
        "_group_flush_locks": "group_flush",
    },
    "blocking": {
        "sleep": "sleep", "_sleep": "sleep",
        "connect": "socket", "accept": "socket",
        "recv": "socket", "recv_into": "socket", "recvfrom": "socket",
        "send": "socket", "sendall": "socket",
        "create_connection": "socket",
        "urlopen": "http",
        "check_call": "subprocess", "check_output": "subprocess",
        "Popen": "subprocess", "communicate": "subprocess",
        "open": "file",
        "join": "thread-join",
        "cpu": "device-sync", "item": "device-sync",
        "synchronize": "device-sync",
    },
    "blocking_attr_calls": {
        "sink": ("age_out", "age_out_prepare", "age_out_commit",
                 "write_chunkset", "write_meta", "write_part_keys",
                 "write_index_bucket", "write_checkpoint",
                 "read_chunksets", "read_part_keys", "read_meta",
                 "read_checkpoints", "read_index_frames"),
    },
    "sites": {
        "partkey_drain": {
            "fn": "TimeSeriesShard._flush_partkey_log",
            "reason": "the sink lock exists to serialize exactly this "
                      "bounded batch write (part-key event order on disk); "
                      "ingest and query threads never take it, so the "
                      "write stalls only a concurrent drain"},
        "group_flush": {
            "fn": "TimeSeriesShard.flush_group",
            "reason": "one group's flush batch written under that group's "
                      "lock; the lock serializes same-group flushes only — "
                      "ingest staging and the query read path never "
                      "take it"},
        "age_out_commit": {
            "fn": "TimeSeriesShard.age_out_durable",
            "reason": "commit half only: the heavy log rewrite ran "
                      "lock-free on a snapshot; under the group locks the "
                      "sink splices the tail appended since (bounded by "
                      "one flush batch per group) and renames. Remote "
                      "sinks run one deadline-bounded RPC instead"},
        "kernel_first_load": {
            "fn": "filodb_tpu_torch/ops/kernels.py::load",
            "reason": "a kernel's first launch in a process compiles its "
                      "library with nvcc (once, seconds) and caches the "
                      "handle; every later call is a dict lookup under "
                      "kernels._lock. The first query to reach a kernel "
                      "pays it under its shard lock, once per process; a "
                      "deployment that must not stall builds every kernel "
                      "before it serves (kernels.build(), as chip_smoke.py "
                      "does)"},
    },
    "wait_ok": {
        "rules_stop_join": {
            "fn": "RuleGroupScheduler.stop",
            "reason": "shutdown join of the rule group loops: each loop "
                      "checks the stop flag before every tick and while "
                      "it waits for admission, so the join waits for at "
                      "most the one group evaluation in flight (its "
                      "rules' instant queries and the derived publish); "
                      "stop() must not return while a loop can still "
                      "publish into a server that is shutting down"},
    },
    "retry_ok": {
        "dist_serve_frame_loop": {
            "fn": "StoreServer.__init__.handle",
            "reason": "per-connection serve loop: one request frame per "
                      "iteration, errors are replied to the client and the "
                      "next frame served; bounded by connection lifetime — "
                      "recv raises when the peer closes, and stop() closes "
                      "every tracked connection to unblock it"},
    },
    "pacing_calls": ("synchronize", "select"),
}

# opt-in runtime lock-order assertions (cheap thread-local bookkeeping, but
# still off by default on hot ingest paths)
lock_debug = os.environ.get("FILODB_LOCK_DEBUG", "") == "1"

_tls = threading.local()


def enable(on: bool = True) -> None:
    global enabled
    enabled = on


def enable_lock_debug(on: bool = True) -> None:
    global lock_debug
    lock_debug = on


def _held_locks() -> list:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


class DiagnosticsError(AssertionError):
    """A violated concurrency invariant (only raised when diagnostics on)."""


def assert_owned(lock, what: str) -> None:
    """Assert the calling thread holds ``lock`` (an RLock). The donation
    discipline: store mutations (which donate device buffers) and query
    array captures must both happen under the shard lock."""
    if not enabled:
        return
    if not lock._is_owned():
        raise DiagnosticsError(
            f"{what} requires the shard lock: a concurrent flush would donate "
            "(delete) device buffers this thread is using — wrap the call in "
            "`with shard.lock:` (thread "
            f"{threading.current_thread().name})")


class _HoldWatchdog:
    """Background scan catching the long hold the release-time check cannot:
    a WEDGED holder whose release never comes (the exact failure
    live-block-under-lock exists to prevent — a blocking call under the
    lock that never returns). Locks register at first-depth acquire under
    FILODB_LOCK_DEBUG=1; a daemon thread scans the held set every
    HOLD_WARN_S/4 (re-read each cycle so tests can lower the threshold)
    and warns + counts a long hold for any lock still held past
    HOLD_WARN_S — while it is still held, not after the fact."""

    def __init__(self):
        self._lock = threading.Lock()
        self._held: dict[int, "TimedRLock"] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def register(self, lk: "TimedRLock") -> None:
        with self._lock:
            self._held[id(lk)] = lk
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._scan_loop, daemon=True,
                    name="lock-hold-watchdog")
                self._thread.start()

    def unregister(self, lk: "TimedRLock") -> None:
        with self._lock:
            self._held.pop(id(lk), None)

    def _scan_loop(self) -> None:
        while not self._stop.wait(max(0.05, HOLD_WARN_S / 4.0)):
            try:
                now = time.monotonic()
                with self._lock:
                    held = list(self._held.values())
                for lk in held:
                    lk._watchdog_check(now)
            except Exception:   # noqa: BLE001 — watchdog must outlive faults
                log.exception("lock-hold watchdog scan failed; retrying "
                              "next period")


_watchdog = _HoldWatchdog()


class TimedRLock:
    """RLock wrapper counting contentions and warning on long holds.

    Drop-in for ``threading.RLock()`` (context manager + acquire/release +
    _is_owned); stats are cheap enough to keep even when diagnostics are off,
    the long-hold stack capture only happens when on.

    ``order_class`` names the lock's class in the global acquisition order
    (LOCK_ORDER). Under FILODB_LOCK_DEBUG=1 every acquisition checks the
    calling thread's held-lock set: taking a lock whose class rank is below
    a held (different) lock's rank raises DiagnosticsError BEFORE blocking —
    the would-be deadlock surfaces as a stack trace naming both locks instead
    of a frozen process. WITHIN a class, ``order_index`` (the shard/group
    number) must strictly ascend — the engine's multi-shard ExitStack
    acquisition is deadlock-free precisely because it walks shards in
    ascending shard_num; two indexed same-class locks taken descending are
    the ABBA shape and raise too."""

    def __init__(self, name: str = "lock", order_class: str | None = None,
                 order_index: int | None = None):
        self._lock = threading.RLock()
        self.name = name
        self.order_class = order_class
        self.order_index = order_index
        self.contentions = 0
        self.long_holds = 0
        self._acquired_at = 0.0
        self._depth = 0
        self._registered = False        # in the hold watchdog's held set
        self._warned_hold = 0.0         # _acquired_at already flagged
        self._hold_hist = None          # lazy filodb_lock_hold_ms handle
        # serializes the contention/long-hold counter RMWs: contentions is
        # bumped precisely when the main lock is NOT held, so `+= 1` there
        # races every other contending thread (found by filolint's
        # lock-guard-inconsistent family; diagnostics must not lie)
        self._stats_lock = threading.Lock()

    def _check_order(self) -> None:
        held = _held_locks()
        if self in held:
            return                      # reentrant: always fine
        my_rank = _LOCK_RANK.get(self.order_class)
        if my_rank is None:
            return
        for lk in held:
            r = _LOCK_RANK.get(lk.order_class)
            if r is None:
                continue
            same_rank_ok = (r == my_rank
                            and (lk.order_index is None
                                 or self.order_index is None
                                 or lk.order_index < self.order_index))
            if r > my_rank or (r == my_rank and not same_rank_ok):
                raise DiagnosticsError(
                    f"lock-order violation: acquiring {self.name!r} "
                    f"(class {self.order_class!r}, rank {my_rank}, index "
                    f"{self.order_index}) while holding {lk.name!r} (class "
                    f"{lk.order_class!r}, rank {r}, index {lk.order_index}); "
                    f"the declared order is {LOCK_ORDER}, ascending index "
                    "within a class — see ANALYSIS.md (lock-order) and "
                    "analysis/lockcheck.py "
                    f"(thread {threading.current_thread().name})")

    def acquire(self, blocking: bool = True, timeout: float = -1):
        debug = lock_debug
        if debug:
            self._check_order()
        got = self._lock.acquire(False)
        if not got:
            with self._stats_lock:
                self.contentions += 1
            if not blocking:
                return False
            got = self._lock.acquire(True, timeout)
            if not got:
                return False
        self._depth += 1
        if self._depth == 1:
            self._acquired_at = time.monotonic()
            if debug:
                _watchdog.register(self)
                self._registered = True
        if debug:
            _held_locks().append(self)
        return True

    def _watchdog_check(self, now: float) -> None:
        """Called by the hold watchdog's scan thread. Reads are racy by
        design (no lock shared with the hot path); the worst outcome of a
        torn read is one spurious or missed warning."""
        at = self._acquired_at
        if self._depth <= 0 or at == 0.0 or self._warned_hold == at:
            return
        held = now - at
        if held > HOLD_WARN_S:
            self._warned_hold = at
            with self._stats_lock:
                self.long_holds += 1
            log.warning("%s STILL held after %.1fs (> %.1fs) — wedged "
                        "holder? (watchdog; the release-time check cannot "
                        "see a hold that never releases)",
                        self.name, held, HOLD_WARN_S)

    def release(self):
        if self._depth == 1:
            held = time.monotonic() - self._acquired_at
            if self._registered:
                _watchdog.unregister(self)
                self._registered = False
            if lock_debug:
                hist = self._hold_hist
                if hist is None:
                    # deferred import: metrics is a leaf module but the
                    # lock is constructed on paths that must not pay for
                    # registry wiring unless debug is on
                    from .metrics import FILODB_LOCK_HOLD_MS, registry
                    hist = self._hold_hist = registry.histogram(
                        FILODB_LOCK_HOLD_MS,
                        {"class": self.order_class or "other"})
                hist.record(held * 1000.0)
            if held > HOLD_WARN_S and self._warned_hold != self._acquired_at:
                with self._stats_lock:
                    self.long_holds += 1
                if enabled:
                    log.warning("%s held %.1fs (> %.1fs) — possible lock leak:\n%s",
                                self.name, held, HOLD_WARN_S,
                                "".join(traceback.format_stack(limit=8)))
        self._depth -= 1
        self._lock.release()
        held_list = _held_locks()
        for i in range(len(held_list) - 1, -1, -1):
            if held_list[i] is self:
                del held_list[i]
                break

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def _is_owned(self):
        return self._lock._is_owned()
