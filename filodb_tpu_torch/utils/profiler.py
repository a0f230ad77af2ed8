"""Always-on sampling profiler: periodic stack sampling -> aggregated top-N report.

Reference: standalone/src/main/java/filodb/standalone/SimpleProfiler.java:31-45
(thread-dump sampler writing aggregated stack reports, enabled by config).
Python equivalent built on ``sys._current_frames`` — near-zero overhead at the
default 100ms interval.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from collections import Counter


class SimpleProfiler:
    def __init__(self, interval_s: float = 0.1, top_n: int = 20,
                 report_path: str | None = None):
        self.interval_s = interval_s
        self.top_n = top_n
        self.report_path = report_path
        self._samples: Counter = Counter()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "SimpleProfiler":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="filodb-profiler")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)

    def _run(self) -> None:
        me = threading.get_ident()
        while not self._stop.wait(self.interval_s):
            try:
                for tid, frame in sys._current_frames().items():
                    if tid == me:
                        continue
                    stack = traceback.extract_stack(frame, limit=12)
                    key = tuple(f"{f.filename.rsplit('/', 1)[-1]}:{f.name}:{f.lineno}"
                                for f in stack[-6:])
                    self._samples[key] += 1
            except Exception:  # noqa: BLE001 — a torn frame from a racing
                # thread exit must not kill the sampler for the process
                # lifetime; count it and keep sampling
                from .metrics import FILODB_SWALLOWED_ERRORS, registry
                registry.counter(FILODB_SWALLOWED_ERRORS,
                                 {"site": "profiler-sample"}).increment()

    def report(self) -> str:
        total = sum(self._samples.values()) or 1
        lines = [f"SimpleProfiler report — {total} samples"]
        for stack, n in self._samples.most_common(self.top_n):
            lines.append(f"{n:6d} ({100.0 * n / total:5.1f}%)  {' <- '.join(reversed(stack))}")
        text = "\n".join(lines)
        if self.report_path:
            with open(self.report_path, "w") as f:
                f.write(text + "\n")
        return text
