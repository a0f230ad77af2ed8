"""Snappy block-format codec (no external dependency).

The Prometheus remote read/write protocol frames protobuf messages in
snappy *block* format (not the framing format). This module implements the
public block-format spec: full decompression (literal + all three copy tag
kinds) and spec-valid compression.

Compression strategy: emit a greedy hash-match LZ with literal fallback —
enough to get real compression on label-heavy payloads while staying simple.
Any snappy decoder (incl. Prometheus itself) can read our output, and we can
read anyone's.
"""

from __future__ import annotations


def _read_uvarint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("uvarint too long")


def _write_uvarint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decompress(data: bytes) -> bytes:
    """Decompress a snappy block (raises ValueError on malformed input)."""
    if not data:
        raise ValueError("empty snappy block")
    try:
        return _decompress(data)
    except IndexError:
        # any out-of-range read means a truncated tag/varint/offset
        raise ValueError("truncated snappy block") from None


def _decompress(data: bytes) -> bytes:
    total, pos = _read_uvarint(data, 0)
    out = bytearray()
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:                       # literal
            ln = tag >> 2
            if ln >= 60:                    # 60..63 -> 1..4 extra length bytes
                extra = ln - 59
                ln = int.from_bytes(data[pos:pos + extra], "little")
                pos += extra
            ln += 1
            out += data[pos:pos + ln]
            pos += ln
            continue
        if kind == 1:                       # copy, 1-byte offset
            ln = ((tag >> 2) & 7) + 4
            offset = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 2:                     # copy, 2-byte offset
            ln = (tag >> 2) + 1
            offset = int.from_bytes(data[pos:pos + 2], "little")
            pos += 2
        else:                               # copy, 4-byte offset
            ln = (tag >> 2) + 1
            offset = int.from_bytes(data[pos:pos + 4], "little")
            pos += 4
        if offset == 0 or offset > len(out):
            raise ValueError("bad copy offset")
        # copies may overlap forward (RLE-style): byte-at-a-time when needed
        start = len(out) - offset
        if offset >= ln:
            out += out[start:start + ln]
        else:
            for i in range(ln):
                out.append(out[start + i])
    if len(out) != total:
        raise ValueError(f"snappy length mismatch: header {total}, got {len(out)}")
    return bytes(out)


def _emit_literal(out: bytearray, chunk: bytes) -> None:
    ln = len(chunk) - 1
    if ln < 60:
        out.append(ln << 2)
    else:
        nbytes = (ln.bit_length() + 7) // 8
        out.append((59 + nbytes) << 2)
        out += ln.to_bytes(nbytes, "little")
    out += chunk


def compress(data: bytes) -> bytes:
    """Compress to snappy block format (greedy 4-byte hash matcher)."""
    out = bytearray(_write_uvarint(len(data)))
    n = len(data)
    if n == 0:
        return bytes(out)
    table: dict[bytes, int] = {}
    pos = 0
    lit_start = 0
    while pos + 4 <= n:
        key = data[pos:pos + 4]
        cand = table.get(key)
        table[key] = pos
        if cand is not None and pos - cand <= 0xFFFF and data[cand:cand + 4] == key:
            # extend the match
            ln = 4
            while pos + ln < n and ln < 64 and data[cand + ln] == data[pos + ln]:
                ln += 1
            if lit_start < pos:
                _emit_literal(out, data[lit_start:pos])
            offset = pos - cand
            if 4 <= ln <= 11 and offset < 2048:
                out.append(1 | ((ln - 4) << 2) | ((offset >> 8) << 5))
                out.append(offset & 0xFF)
            else:
                out.append(2 | ((ln - 1) << 2))
                out += offset.to_bytes(2, "little")
            pos += ln
            lit_start = pos
        else:
            pos += 1
    if lit_start < n:
        _emit_literal(out, data[lit_start:])
    return bytes(out)
