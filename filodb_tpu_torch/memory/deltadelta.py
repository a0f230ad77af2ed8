"""Delta-delta codec for longs/timestamps.

Models the vector as a sloped line (reference: doc/compression.md "Long/Integer
Compression"; memory/.../format/vectors/DeltaDeltaVector.scala): store the first
value and the integer slope, then NibblePack the zigzag-encoded residuals of each
point from the line. Regularly spaced timestamps compress to near-nothing.

Wire layout (our own — the reference's off-heap header is JVM-specific):

    u32 n | i64 first | i64 slope | nibblepacked zigzag residuals
"""

from __future__ import annotations

import struct

import numpy as np

from . import nibblepack

_HDR = struct.Struct("<Iqq")


def _zigzag(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.int64)
    return ((v << 1) ^ (v >> 63)).astype(np.uint64)


def _unzigzag(u: np.ndarray) -> np.ndarray:
    u = u.astype(np.uint64)
    return ((u >> np.uint64(1)).astype(np.int64)) ^ -(u & np.uint64(1)).astype(np.int64)


def encode_py(vals: np.ndarray) -> bytes:
    """numpy spec implementation (native below is bit-identical)."""
    v = np.ascontiguousarray(vals, dtype=np.int64)
    n = len(v)
    if n == 0:
        return _HDR.pack(0, 0, 0)
    first = int(v[0])
    slope = int(round((int(v[-1]) - first) / (n - 1))) if n > 1 else 0
    line = first + slope * np.arange(n, dtype=np.int64)
    resid = v - line
    return _HDR.pack(n, first, slope) + nibblepack.pack_u64(_zigzag(resid))


def decode_py(buf: bytes) -> np.ndarray:
    n, first, slope = _HDR.unpack_from(buf, 0)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    resid = _unzigzag(nibblepack.unpack_u64(buf[_HDR.size:], n))
    return first + slope * np.arange(n, dtype=np.int64) + resid


def _encode_native(vals: np.ndarray) -> bytes:
    from . import native
    v = np.ascontiguousarray(vals, dtype=np.int64)
    n = len(v)
    if n == 0:
        return _HDR.pack(0, 0, 0)
    first = int(v[0])
    # slope stays in Python: int(round()) banker's rounding is the spec
    slope = int(round((int(v[-1]) - first) / (n - 1))) if n > 1 else 0
    zz = native.dd_residuals_zigzag(v, first, slope)
    return _HDR.pack(n, first, slope) + native.pack_u64(zz)


def _decode_native(buf: bytes) -> np.ndarray:
    from . import native
    n, first, slope = _HDR.unpack_from(buf, 0)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    return native.dd_restore(native.unpack_u64(buf[_HDR.size:], n), first, slope)


def _bind():
    from . import native
    if native.available():
        return _encode_native, _decode_native
    return encode_py, decode_py


encode, decode = _bind()
