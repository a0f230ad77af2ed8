"""Result model: the batched [P, T] matrix that flows between ExecPlan nodes.

Host copy of ``filodb_tpu/query/rangevector.py`` (ref: core/.../query/
RangeVector.scala). One ResultMatrix carries *all* series of a plan node:
``values[P, T]`` as a device tensor or a host array, label keys on the host.
NaN marks absent points; presenters drop them at the edge.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Iterator

import numpy as np
import torch


def to_numpy(values) -> np.ndarray:
    """Host array of a result block: device tensors are copied back."""
    if isinstance(values, torch.Tensor):
        return values.detach().cpu().numpy()
    return np.asarray(values)


@dataclass(frozen=True)
class RangeVectorKey:
    """Immutable label set identifying one output series."""
    labels: tuple[tuple[str, str], ...]

    @classmethod
    def of(cls, d: dict[str, str]) -> "RangeVectorKey":
        return cls(tuple(sorted(d.items())))

    def as_dict(self) -> dict[str, str]:
        return dict(self.labels)

    def without(self, names) -> "RangeVectorKey":
        ns = set(names)
        return RangeVectorKey(tuple(kv for kv in self.labels if kv[0] not in ns))

    def only(self, names) -> "RangeVectorKey":
        ns = set(names)
        return RangeVectorKey(tuple(kv for kv in self.labels if kv[0] in ns))


@dataclass
class ResultMatrix:
    """out_ts int64 [T]; values float [P, T] (device or host); keys len P."""
    out_ts: np.ndarray
    values: object                      # torch tensor or numpy array [P, T]
    keys: list[RangeVectorKey]

    @property
    def num_series(self) -> int:
        return len(self.keys)

    def to_host(self) -> "ResultMatrix":
        return ResultMatrix(self.out_ts, to_numpy(self.values), self.keys)

    def iter_series(self) -> Iterator[tuple[RangeVectorKey, np.ndarray, np.ndarray]]:
        """Yield (key, ts, values) per series with NaN points dropped; series
        with no points are skipped (Prometheus empty-series semantics)."""
        vals = to_numpy(self.values)
        for p, key in enumerate(self.keys):
            present = ~np.isnan(vals[p])
            if present.any():
                yield key, self.out_ts[present], vals[p][present]


class QueryStats:
    """Per-query resource accounting threaded through exec via QueryContext
    (ref: the reference's QueryStats aggregated across ExecPlans and
    returned in query responses); the counters the port's local path
    keeps. Thread-safe. ``stage_ms`` sums wall time per stage."""

    FIELDS = ("series_matched", "blocks_raw", "result_cells", "fused_kernels")

    def __init__(self):
        self.series_matched = 0        # series selected by leaf filters
        self.blocks_raw = 0            # raw f32/f64 store blocks read
        self.result_cells = 0          # final matrix series x steps
        self.fused_kernels = 0         # fused-tier executions in this query
        self.stage_ms: dict[str, float] = {}
        self._lock = threading.Lock()

    def add(self, field_name: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, field_name, getattr(self, field_name) + int(n))

    @contextmanager
    def stage(self, name: str):
        """Accumulate one stage's wall time (monotonic clock only)."""
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            ms = (time.perf_counter_ns() - t0) / 1e6
            with self._lock:
                self.stage_ms[name] = self.stage_ms.get(name, 0.0) + ms

    def to_dict(self) -> dict:
        with self._lock:
            out = {f: getattr(self, f) for f in self.FIELDS}
            out["stage_ms"] = {k: round(v, 3)
                               for k, v in self.stage_ms.items()}
        return out


@dataclass
class QueryResult:
    """Ref: query/QueryResults (QueryResult with result schema + RVs)."""
    matrix: ResultMatrix
    result_type: str = "matrix"        # matrix | vector | scalar
    warnings: list[str] = field(default_factory=list)
    # per-query accounting (None only for results built outside an engine)
    stats: "QueryStats | None" = None
    # exec route taken for this query ("local" on the port's path)
    exec_path: str | None = None


class QueryError(Exception):
    pass
