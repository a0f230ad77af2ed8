"""First-class histograms: bucket schemes + the compressed wire/storage codec.

Reference: memory/.../format/vectors/Histogram.scala (bucket schemes, quantile
:55,288), HistogramVector.scala (BinaryHistogram wire format, sectioned vectors),
doc/compression.md "Histograms" / "2D Delta Compression".

Buckets are *cumulative* (Prometheus-style: bucket b counts all observations
<= le[b]). On the wire each histogram's bucket array is delta-encoded (buckets
are non-decreasing) and NibblePacked; across time, consecutive histograms are
2D-delta encoded: the delta-of-deltas between histogram t and t-1 is usually
tiny for quiet series. This reproduces the reference's ~50x space win over the
one-series-per-bucket Prometheus data model (tested in test_hist.py).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from . import nibblepack


@dataclass(frozen=True)
class GeometricBuckets:
    """le[i] = first * multiplier^i (ref: Histogram.scala GeometricBuckets)."""
    first: float
    multiplier: float
    num_buckets: int

    def les(self) -> np.ndarray:
        return self.first * self.multiplier ** np.arange(self.num_buckets)


@dataclass(frozen=True)
class CustomBuckets:
    """Explicit bucket tops, last is typically +Inf (ref: CustomBuckets)."""
    le: tuple

    def les(self) -> np.ndarray:
        return np.asarray(self.le, dtype=np.float64)


# ---- wire codec -------------------------------------------------------------

_HDR = struct.Struct("<HH")   # n_hists, n_buckets


def encode_hist_series_py(counts: np.ndarray) -> bytes:
    """counts [n, B] cumulative bucket counts (int64able) -> compressed bytes.

    Layout: header | per-histogram NibblePack'ed *increasing* delta arrays,
    where hist 0 packs its own bucket deltas and hist t>0 packs the 2D-delta
    (bucket-delta array minus previous histogram's bucket-delta array, zigzag).
    numpy spec implementation; the native twin (memory/native hist_encode)
    is bit-identical and handles the whole series in one call.
    """
    c = np.asarray(counts, dtype=np.int64)
    n, B = c.shape
    out = [_HDR.pack(n, B)]
    prev_deltas = None
    for i in range(n):
        deltas = np.diff(c[i], prepend=0)
        if prev_deltas is None:
            payload = nibblepack.pack_u64(deltas.astype(np.uint64))
        else:
            dd = deltas - prev_deltas
            payload = nibblepack.pack_u64(_zigzag(dd))
        out.append(payload)   # no per-hist framing: group count derives from B
        prev_deltas = deltas
    return b"".join(out)


def decode_hist_series_py(buf: bytes) -> np.ndarray:
    n, B = _HDR.unpack_from(buf, 0)
    off = _HDR.size
    out = np.zeros((n, B), np.int64)
    prev_deltas = None
    for i in range(n):
        words, used = nibblepack.unpack_u64_consumed(buf[off:], B); off += used
        if prev_deltas is None:
            deltas = words.astype(np.int64)
        else:
            deltas = prev_deltas + _unzigzag(words)
        out[i] = np.cumsum(deltas)
        prev_deltas = deltas
    return out


def _encode_native(counts: np.ndarray) -> bytes:
    from . import native
    c = np.asarray(counts, dtype=np.int64)
    n, B = c.shape
    return _HDR.pack(n, B) + native.hist_encode(c)


def _decode_native(buf) -> np.ndarray:
    from . import native
    n, B = _HDR.unpack_from(buf, 0)
    return native.hist_decode(buf[_HDR.size:], n, B)


def _bind():
    from . import native
    if native.available():
        return _encode_native, _decode_native
    return encode_hist_series_py, decode_hist_series_py


encode_hist_series, decode_hist_series = _bind()


def _zigzag(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.int64)
    return ((v << 1) ^ (v >> 63)).astype(np.uint64)


def _unzigzag(u: np.ndarray) -> np.ndarray:
    u = u.astype(np.uint64)
    return ((u >> np.uint64(1)).astype(np.int64)) ^ -(u & np.uint64(1)).astype(np.int64)


# ---- quantile (host reference; the device kernel mirrors this) --------------

def histogram_quantile(q: float, les: np.ndarray, counts: np.ndarray) -> float:
    """Prometheus histogram_quantile on one cumulative histogram
    (ref: Histogram.scala quantile :288)."""
    total = counts[-1]
    if total == 0 or np.isnan(total):
        return np.nan
    if q < 0:
        return -np.inf
    if q > 1:
        return np.inf
    rank = q * total
    b = int(np.searchsorted(counts, rank, side="left"))
    b = min(b, len(les) - 1)
    if np.isinf(les[b]):
        # +Inf bucket: return the highest finite bound
        return les[b - 1] if b > 0 else np.nan
    lo_le = les[b - 1] if b > 0 else 0.0
    lo_cnt = counts[b - 1] if b > 0 else 0.0
    hi_cnt = counts[b]
    if hi_cnt == lo_cnt:
        return les[b]
    return lo_le + (les[b] - lo_le) * (rank - lo_cnt) / (hi_cnt - lo_cnt)
