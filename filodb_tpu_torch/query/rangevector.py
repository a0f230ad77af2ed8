"""Result model: the batched [P, T] matrix that flows between ExecPlan nodes.

Host copy of ``filodb_tpu/query/rangevector.py`` (ref: core/.../query/
RangeVector.scala). One ResultMatrix carries *all* series of a plan node:
``values[P, T]`` as a device tensor or a host array, label keys on the host;
a histogram-valued matrix carries ``values[P, T, B]`` and its bucket tops.
NaN marks absent points; presenters drop them at the edge.
"""

from __future__ import annotations

import json
import math
import struct
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Iterator

import numpy as np
import torch


def fmt_value(v: float) -> str:
    """Prometheus sample-value string: full float64 round-trip precision
    (Go's strconv.FormatFloat with shortest round-trip digits — "%g" would
    truncate to 6 significant digits and collide distinct count_values
    labels). Integral values render without a decimal point; non-finite
    values use Prometheus' spellings."""
    v = float(v)
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e17:
        return str(int(v))
    return repr(v)


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
    """out_ts int64 [T]; values float [P, T] (device or host); keys len P.
    Histogram-valued matrices carry [P, T, B] values + bucket_les [B]."""
    out_ts: np.ndarray
    values: object                      # torch tensor or numpy array
    keys: list[RangeVectorKey]
    bucket_les: np.ndarray | None = None

    @property
    def num_series(self) -> int:
        return len(self.keys)

    @property
    def is_histogram(self) -> bool:
        return self.bucket_les is not None

    def to_host(self) -> "ResultMatrix":
        return ResultMatrix(self.out_ts, to_numpy(self.values), self.keys,
                            self.bucket_les)

    def iter_series(self) -> Iterator[tuple[RangeVectorKey, np.ndarray, np.ndarray]]:
        """Yield (key, ts, values) per series with NaN points dropped; series
        with no points are skipped (Prometheus empty-series semantics).

        Histogram-valued matrices expand into the classic Prometheus form:
        one ``le``-labelled series per bucket (cumulative counts), so a raw
        histogram result (``rate(h[5m])``) reads like a scraped classic
        histogram."""
        vals = to_numpy(self.values)
        if self.bucket_les is not None and vals.ndim == 3:
            for p, key in enumerate(self.keys):
                base = key.as_dict()
                for b, le in enumerate(self.bucket_les):
                    col = vals[p, :, b]
                    present = ~np.isnan(col)
                    if present.any():
                        # full round-trip precision: "%g" would collide
                        # near-equal custom bounds into duplicate le labels
                        bkey = RangeVectorKey.of(dict(base, le=fmt_value(le)))
                        yield bkey, self.out_ts[present], col[present]
            return
        for p, key in enumerate(self.keys):
            present = ~np.isnan(vals[p])
            if present.any():
                yield key, self.out_ts[present], vals[p][present]


class QueryStats:
    """Per-query resource accounting threaded through exec via QueryContext
    (ref: the reference's QueryStats aggregated across ExecPlans and
    returned in query responses); the counters the port's local path and
    its serving layer keep. Thread-safe. ``stage_ms`` sums wall time per
    stage."""

    FIELDS = ("series_matched", "blocks_narrow", "blocks_raw",
              "rows_paged_in", "result_cells", "result_cache_hits",
              "negative_cache_hits", "fused_kernels", "admission_shed",
              "subquery_inner_cells", "fragment_steps_reused",
              "windows_widened", "recovering_shards")

    def __init__(self):
        self.series_matched = 0        # series selected by leaf filters
        self.blocks_raw = 0            # raw f32/f64 store blocks read
        self.blocks_narrow = 0         # compressed-resident blocks streamed
        self.rows_paged_in = 0         # series paged in by on-demand paging
        self.result_cells = 0          # final matrix series x steps
        self.result_cache_hits = 0     # answered from the result cache
        self.negative_cache_hits = 0   # empty selection served from the
                                       # TTL-bounded negative cache
        self.fused_kernels = 0         # fused-tier executions in this query
        self.admission_shed = 0        # shed by cost-based admission
        self.subquery_inner_cells = 0  # inner matrix cells subqueries slid over
        self.fragment_steps_reused = 0  # request steps served from the
                                        # incremental fragment cache
        self.windows_widened = 0       # windowed functions widened to the
                                       # serving family's resolution
        self.recovering_shards = 0     # leaf selects served by a shard
                                       # mid-recovery (an empty answer then
                                       # proves nothing: the negative cache
                                       # skips it)
        # the serving resolution the retention router picked ("raw", "1m",
        # "1h+raw" for a stitched range); None when routing is off. A
        # label, not a counter: merge() keeps this object's value
        self.resolution: str | None = None
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

    def reset_counters(self) -> None:
        """Zero the counters, keep the stage times: the replan-once retry
        after a peer failure re-executes every leg, the ones whose peer
        stats already merged included, so the first attempt's counts go
        (stage times measure work done, across attempts)."""
        with self._lock:
            for f in self.FIELDS:
                setattr(self, f, 0)

    def merge(self, other: "QueryStats | dict") -> None:
        """Fold another QueryStats' counters and stage times into this one;
        a dict in ``to_dict`` form (a cached result's stats) folds alike."""
        d = other.to_dict() if isinstance(other, QueryStats) else other
        with self._lock:
            for f in self.FIELDS:
                setattr(self, f, getattr(self, f) + int(d.get(f, 0)))
            for k, v in (d.get("stage_ms") or {}).items():
                self.stage_ms[k] = self.stage_ms.get(k, 0.0) + float(v)

    def to_dict(self) -> dict:
        with self._lock:
            out = {f: getattr(self, f) for f in self.FIELDS}
            if self.resolution is not None:
                out["resolution"] = self.resolution
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
    # exec route taken for this query ("local", "mesh-*", "fused-hist",
    # "result-cache[...]", "retention[<label>]:..." on the port's paths)
    exec_path: str | None = None


class QueryError(Exception):
    pass


# ---- wire serialization (SerializableRangeVector equivalent) ----------------

_MAGIC = 0x46545257  # 'FTRW': the header carries the histogram bucket count


def serialize_matrix(m: ResultMatrix) -> bytes:
    """Compact wire form for cross-node result transfer, byte for byte the
    reference's (ref: RangeVector.scala SerializableRangeVector): one header
    + columnar f64 block + label blob. Histogram-valued matrices ([P, T, B])
    carry the bucket count and bucket bounds after the value block."""
    host = m.to_host()
    P, T = len(host.keys), len(host.out_ts)
    vals = np.asarray(host.values, "<f8")
    if vals.shape[0] > P:
        # padded leaf output (pad rows, pow2-padded kernel rows): rows past
        # the keyed prefix carry no series, and shipping them would desync
        # the receiver's offsets
        vals = vals[:P]
    elif vals.shape[0] < P:
        raise ValueError(
            f"matrix has {len(host.keys)} keys but {vals.shape[0]} value "
            "rows — refusing to ship a truncated result")
    B = len(host.bucket_les) if host.bucket_les is not None else 0
    if (vals.ndim == 3) != (B > 0) or (B and vals.shape[2] != B):
        raise ValueError(
            f"histogram matrix shape {vals.shape} inconsistent with "
            f"{B} bucket bounds")
    blob = json.dumps([k.labels for k in host.keys],
                      separators=(",", ":")).encode()
    head = struct.pack("<IIIII", _MAGIC, P, T, len(blob), B)
    les = (np.asarray(host.bucket_les, "<f8").tobytes() if B else b"")
    return (head + np.asarray(host.out_ts).astype("<i8").tobytes()
            + vals.tobytes() + les + blob)


def deserialize_matrix(buf: bytes) -> ResultMatrix:
    magic, P, T, blob_len, B = struct.unpack_from("<IIIII", buf, 0)
    if magic != _MAGIC:
        raise ValueError("bad result matrix magic")
    off = 20
    out_ts = np.frombuffer(buf, "<i8", T, off).copy()
    off += 8 * T
    n_vals = P * T * (B or 1)
    values = np.frombuffer(buf, "<f8", n_vals, off).copy()
    off += 8 * n_vals
    values = values.reshape((P, T, B) if B else (P, T))
    les = None
    if B:
        les = np.frombuffer(buf, "<f8", B, off).copy()
        off += 8 * B
    keys = [RangeVectorKey(tuple(tuple(kv) for kv in k))
            for k in json.loads(buf[off:off + blob_len])]
    return ResultMatrix(out_ts, values, keys, les)
