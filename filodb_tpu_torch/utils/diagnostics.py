"""Concurrency diagnostics: the shard lock and its ownership assertion.

Host copy of the parts of ``filodb_tpu/utils/diagnostics.py`` the port's
ingest and query paths use. ``TimedRLock`` asserts the global acquisition
order (``LOCK_ORDER``) under ``FILODB_LOCK_DEBUG=1``; ``assert_owned``
checks the caller-holds-lock contract at the store's mutation entry points
when ``enabled`` is set.

The store's in-place tensor updates replace the reference's donated
buffers, so the lock's job is the same: a query must capture the store's
tensors and launch its kernels under the lock a flush takes to mutate them.
"""

from __future__ import annotations

import os
import threading

enabled = False

# ranks increase left to right; a thread may only take a lock ranked above
# every ranked lock it holds (reentry excepted)
LOCK_ORDER = ("group_flush", "sink", "shard")
_LOCK_RANK = {c: i for i, c in enumerate(LOCK_ORDER)}

lock_debug = os.environ.get("FILODB_LOCK_DEBUG", "") == "1"

_tls = threading.local()


def enable(on: bool = True) -> None:
    """Turn the caller-holds-lock assertions on or off (the server's
    ``diagnostics.enabled``; process-global, so a later server in the same
    process can turn it back off)."""
    global enabled
    enabled = on


def _held_locks() -> list:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


class DiagnosticsError(AssertionError):
    """A violated concurrency invariant (only raised when diagnostics on)."""


def assert_owned(lock, what: str) -> None:
    """Assert the calling thread holds ``lock`` (an RLock)."""
    if not enabled:
        return
    if not lock._is_owned():
        raise DiagnosticsError(
            f"{what} requires the shard lock: a concurrent flush mutates the "
            "store tensors this thread is using — wrap the call in "
            f"`with shard.lock:` (thread {threading.current_thread().name})")


class TimedRLock:
    """RLock wrapper that, under ``FILODB_LOCK_DEBUG=1``, checks the declared
    acquisition order (class rank, then ascending ``order_index`` within a
    class) before it blocks, so a would-be deadlock raises instead of
    freezing."""

    def __init__(self, name: str = "lock", order_class: str | None = None,
                 order_index: int | None = None):
        self._lock = threading.RLock()
        self.name = name
        self.order_class = order_class
        self.order_index = order_index

    def _check_order(self) -> None:
        held = _held_locks()
        if self in held:
            return
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
                    f"lock-order violation: acquiring {self.name!r} while "
                    f"holding {lk.name!r}; the declared order is {LOCK_ORDER}, "
                    "ascending index within a class")

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if lock_debug:
            self._check_order()
        if not self._lock.acquire(blocking, timeout):
            return False
        if lock_debug:
            _held_locks().append(self)
        return True

    def release(self):
        self._lock.release()
        held = _held_locks()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is self:
                del held[i]
                break

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def _is_owned(self):
        return self._lock._is_owned()
