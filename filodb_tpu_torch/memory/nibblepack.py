"""Predictive NibblePack codec — bit-exact with the reference storage scheme.

Format (reference: memory/src/main/scala/filodb.memory/format/NibblePack.scala:12-150,
doc/compression.md "Predictive NibblePacking"): 8 u64 words are packed at a time:

    +0  u8 bitmask, bit i set => value i is nonzero
    +1  u8 low nibble  = # trailing zero nibbles (0-15)
        u8 high nibble = # nibbles stored per value - 1 (0-15)
        (byte omitted when bitmask == 0)
    +2  nibble stream, LSB-first, only for nonzero values

Value streams are produced by a *predictor* that maximizes zero bits:
  - ``pack_delta``: increasing longs -> successive deltas (negative deltas clamp to 0)
  - ``pack_doubles``: first double raw, then XOR with previous bit pattern
  - ``pack_u64``: raw words (no transform)

Encoding is vectorized over all 8-groups with numpy; decoding walks groups
sequentially (group sizes are data-dependent) with per-group numpy ops.
"""

from __future__ import annotations

import numpy as np

_U64 = np.uint64


def _popcount(x: np.ndarray) -> np.ndarray:
    return np.bitwise_count(x).astype(np.int64)


def _trailing_zero_nibbles(v: np.ndarray) -> np.ndarray:
    """Per-value count of trailing zero nibbles; 16 for v == 0."""
    v = v.astype(_U64)
    low = v & (~v + _U64(1))          # isolate lowest set bit (two's complement on u64)
    ctz = _popcount(low - _U64(1))
    ctz = np.where(v == 0, 64, ctz)
    return ctz // 4


def _leading_zero_nibbles(v: np.ndarray) -> np.ndarray:
    """Per-value count of leading zero nibbles; 16 for v == 0."""
    v = v.astype(_U64)
    fill = v.copy()
    for s in (1, 2, 4, 8, 16, 32):
        fill |= fill >> _U64(s)
    clz = 64 - _popcount(fill)
    return clz // 4


def pack_u64(vals: np.ndarray) -> bytes:
    """Pack raw u64 words (zero-padding the final partial group of 8)."""
    vals = np.ascontiguousarray(vals, dtype=_U64)
    n = len(vals)
    if n == 0:
        return b""
    groups = -(-n // 8)
    padded = np.zeros(groups * 8, dtype=_U64)
    padded[:n] = vals
    return _pack_groups(padded.reshape(groups, 8))


def pack_delta(vals: np.ndarray) -> bytes:
    """Pack positive increasing longs as deltas from the previous value.

    A value lower than its predecessor packs as delta 0 (negative deltas are
    not representable — matches reference ``packDelta`` semantics).
    """
    v = np.ascontiguousarray(vals, dtype=np.int64).astype(_U64)
    if len(v) == 0:
        return b""
    prev = np.concatenate([[_U64(0)], v[:-1]])
    delta = np.where(v >= prev, v - prev, _U64(0))
    return pack_u64(delta)


def pack_doubles(vals: np.ndarray) -> bytes:
    """First double stored raw (little-endian), rest XOR-ed with previous bits."""
    v = np.ascontiguousarray(vals, dtype=np.float64)
    if len(v) == 0:
        raise ValueError("pack_doubles requires at least one value")
    bits = v.view(_U64)
    head = bits[:1].tobytes()  # little-endian on all supported platforms
    if len(v) == 1:
        return head
    xored = bits[1:] ^ bits[:-1]
    return head + pack_u64(xored)


def _pack_groups(g: np.ndarray) -> bytes:
    """Vectorized pack of ``g`` with shape [G, 8] u64 -> bytes."""
    G = g.shape[0]
    nonzero = g != 0
    bitmask = (nonzero.astype(np.uint16) << np.arange(8, dtype=np.uint16)).sum(axis=1)
    any_nz = bitmask != 0

    tz = _trailing_zero_nibbles(g)
    lz = _leading_zero_nibbles(g)
    # min over nonzero values only (zero values report 16 which never wins anyway)
    trail = tz.min(axis=1)
    lead = lz.min(axis=1)
    nnib = np.where(any_nz, 16 - trail - lead, 0).astype(np.int64)
    nz_count = nonzero.sum(axis=1)
    tot_nib = nnib * nz_count
    gsize = np.where(any_nz, 2 + (tot_nib + 1) // 2, 1)
    goff = np.concatenate([[0], np.cumsum(gsize)[:-1]])
    out = np.zeros(int(gsize.sum()), dtype=np.uint8)

    out[goff] = bitmask.astype(np.uint8)
    hdr_pos = goff[any_nz] + 1
    out[hdr_pos] = (trail[any_nz] | ((nnib[any_nz] - 1) << 4)).astype(np.uint8)

    # Nibble emission for every nonzero value.
    gidx, vidx = np.nonzero(nonzero)           # [Nnz] group / lane of each nonzero value
    if len(gidx):
        vnnib = nnib[gidx]                     # nibbles per value
        # within-group nibble offset of each value = (# nonzero lanes before it) * nnib
        before = np.cumsum(nonzero, axis=1) - 1
        voff = before[gidx, vidx] * vnnib
        # expand to one row per nibble
        rep_val = np.repeat(np.arange(len(gidx)), vnnib)
        pos_in_val = np.arange(len(rep_val)) - np.repeat(np.concatenate([[0], np.cumsum(vnnib)[:-1]]), vnnib)
        shift = (trail[gidx][rep_val] + pos_in_val) * 4
        nib = (g[gidx[rep_val], vidx[rep_val]] >> shift.astype(_U64)) & _U64(0xF)
        glob_nib = (goff[gidx[rep_val]] + 2) * 2 + voff[rep_val] + pos_in_val
        byte_idx = glob_nib >> 1
        nib_shift = (glob_nib & 1) * 4
        np.add.at(out, byte_idx, (nib.astype(np.uint8)) << nib_shift.astype(np.uint8))
    return out.tobytes()


def _unpack_groups(buf: bytes, n: int, return_consumed: bool = False):
    """Decode ``n`` u64 words from ``buf`` (walks variable-size groups)."""
    if n == 0:
        out0 = np.zeros(0, dtype=_U64)
        return (out0, 0) if return_consumed else out0
    raw = np.frombuffer(buf, dtype=np.uint8)
    groups = -(-n // 8)
    out = np.zeros(groups * 8, dtype=_U64)
    pos = 0
    for gi in range(groups):
        bitmask = int(raw[pos])
        if bitmask == 0:
            pos += 1
            continue
        hdr = int(raw[pos + 1])
        trail = hdr & 0xF
        nnib = (hdr >> 4) + 1
        nz = bin(bitmask).count("1")
        tot_nib = nnib * nz
        nbytes = (tot_nib + 1) // 2
        data = raw[pos + 2 : pos + 2 + nbytes]
        # nibble stream, LSB-first
        nibs = np.empty(len(data) * 2, dtype=_U64)
        nibs[0::2] = data & 0xF
        nibs[1::2] = data >> 4
        nibs = nibs[:tot_nib].reshape(nz, nnib)
        vals = (nibs << (np.arange(nnib, dtype=_U64) * _U64(4))).sum(axis=1, dtype=_U64)
        vals <<= _U64(trail * 4)
        lanes = np.nonzero([(bitmask >> i) & 1 for i in range(8)])[0]
        out[gi * 8 + lanes] = vals
        pos += 2 + nbytes
    if return_consumed:
        return out[:n], pos
    return out[:n]


def unpack_u64(buf: bytes, n: int) -> np.ndarray:
    return _unpack_groups(buf, n)


def unpack_u64_consumed(buf: bytes, n: int) -> tuple[np.ndarray, int]:
    """Like unpack_u64 but also returns bytes consumed (for length-prefix-free
    streams of packed arrays, e.g. the histogram codec)."""
    return _unpack_groups(buf, n, return_consumed=True)


def unpack_delta(buf: bytes, n: int) -> np.ndarray:
    deltas = _unpack_groups(buf, n)
    return np.cumsum(deltas.astype(np.int64)).astype(np.int64)


def unpack_doubles(buf: bytes, n: int) -> np.ndarray:
    if n == 0:
        return np.zeros(0, dtype=np.float64)
    head = np.frombuffer(buf[:8], dtype=_U64)[0]
    if n == 1:
        return np.array([head]).view(np.float64)
    xored = _unpack_groups(buf[8:], n - 1)
    bits = np.empty(n, dtype=_U64)
    bits[0] = head
    bits[1:] = xored
    # XOR prefix to undo chaining
    np.bitwise_xor.accumulate(bits, out=bits)
    return bits.view(np.float64)
