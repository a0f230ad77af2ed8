"""Bit-packed integer vectors — the IntBinaryVector/LongBinaryVector family.

Reference: memory/.../format/vectors/IntBinaryVector.scala (532 LoC: ints
packed at 1/2/4/8/16/32 bits after a min-value offset) and
LongBinaryVector.scala. The off-heap layout is JVM-internal, so this is a
format-equivalent design, not a byte-for-byte port: the narrowest width that
spans (max - min) is chosen, values store as offsets from the minimum, and
sub-byte widths pack little-endian within each byte.

Wire layout:
  u8  version (1)
  u8  bits per value (0 = constant vector: all values equal base)
  u32 n
  i64 base (the minimum value)
  ceil(n * bits / 8) payload bytes

Used by the persistence layer for integral chunks (counts, downsampled
dCount, integer gauges) — a dCount column packs ~8-16x smaller than f64.
"""

from __future__ import annotations

import struct

import numpy as np

try:
    from . import native as _native
except Exception:  # pragma: no cover - native build unavailable
    _native = None

_HDR = struct.Struct("<BBIq")
WIDTHS = (0, 1, 2, 4, 8, 16, 32, 64)


def _width_for(span: int) -> int:
    for bits in WIDTHS[1:]:
        if bits == 64 or span < (1 << bits):
            return bits
    return 64  # pragma: no cover


def pack_ints(values: np.ndarray) -> bytes:
    """Pack an int64-representable array at the narrowest sufficient width."""
    a = np.asarray(values, np.int64)
    n = len(a)
    if n == 0:
        return _HDR.pack(1, 0, 0, 0)
    base = int(a.min())
    off = (a - base).astype(np.uint64)
    span = int(off.max())
    if span == 0:
        return _HDR.pack(1, 0, n, base)
    bits = _width_for(span)
    if bits >= 8:
        payload = off.astype(f"<u{bits // 8}").tobytes()
    elif _native is not None and _native.available():
        payload = _native.pack_subbyte(off, bits)
    else:
        per = 8 // bits                      # values per byte
        pad = (-n) % per
        o = np.concatenate([off, np.zeros(pad, np.uint64)]).astype(np.uint8)
        o = o.reshape(-1, per)
        shifts = (np.arange(per, dtype=np.uint8) * bits)
        payload = (o << shifts).astype(np.uint16).sum(axis=1).astype(np.uint8).tobytes()
    return _HDR.pack(1, bits, n, base) + payload


def unpack_ints(buf: bytes) -> np.ndarray:
    """Inverse of pack_ints -> int64 array. Corrupt frames raise ValueError so
    the persistence reader's torn-tail tolerance catches them."""
    ver, bits, n, base = _HDR.unpack_from(buf, 0)
    if ver != 1:
        raise ValueError(f"unknown intpack version {ver}")
    if bits not in WIDTHS:
        raise ValueError(f"invalid intpack width {bits}")
    if n == 0:
        return np.zeros(0, np.int64)
    if bits == 0:
        return np.full(n, base, np.int64)
    payload = memoryview(buf)[_HDR.size:]
    if len(payload) * 8 < n * bits:
        raise ValueError("intpack payload shorter than header claims")
    if bits >= 8:
        off = np.frombuffer(payload, f"<u{bits // 8}", n).astype(np.int64)
    elif _native is not None and _native.available():
        off = _native.unpack_subbyte(payload, n, bits).astype(np.int64)
    else:
        per = 8 // bits
        raw = np.frombuffer(payload, np.uint8, (n + per - 1) // per)
        shifts = (np.arange(per, dtype=np.uint8) * bits)
        mask = (1 << bits) - 1
        off = ((raw[:, None] >> shifts) & mask).reshape(-1)[:n].astype(np.int64)
    return off + base


def is_integral(values: np.ndarray) -> bool:
    """True when a float chunk is exactly integral and in int64 range — the
    persistence layer then prefers the bit-packed int codec."""
    v = np.asarray(values)
    if v.dtype.kind in "iu":
        return True
    if v.dtype.kind != "f":
        return False
    # NaN fails the floor-compare, +/-Inf fails the magnitude bound — no
    # separate isfinite pass needed on the flush hot path
    return bool((np.abs(v) < 2**53).all() and (v == np.floor(v)).all())
