"""The port's snappy block codec (``filodb_tpu_torch/utils/snappy.py``)
against the JAX package's (``filodb_tpu/utils/snappy.py``).

Compression must be byte for byte the reference's (the framing of every
remote-read response and of a client's remote-write body), each package
must decompress the other's output, and every tag kind of the block format
(literals with 0-4 extra length bytes, copies with 1-, 2- and 4-byte
offsets, overlapping copies) must decode to the same bytes in both.
Malformed blocks raise ``ValueError`` in both. Payloads come from a numpy
seed. Tolerance: none — bytes are compared.
"""

import json

import numpy as np
import pytest

from filodb_tpu.utils import snappy as jsnappy
from filodb_tpu_torch.utils import snappy


def _random(seed, n):
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


def _label_heavy(seed, n_series=200):
    """A label-heavy payload: JSON label sets with repeated names and
    values, the shape a remote-write body compresses."""
    rng = np.random.default_rng(seed)
    sets = [{"__name__": "http_requests_total", "job": "api",
             "instance": f"host-{int(rng.integers(0, 64))}:9100",
             "code": str(int(rng.choice([200, 404, 500]))),
             "_ws_": "demo", "_ns_": f"App-{int(rng.integers(0, 8))}"}
            for _ in range(n_series)]
    return json.dumps(sets).encode()


def _low_entropy(seed, n):
    """Runs of a few symbols: long matches and overlapping copies."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    while len(out) < n:
        out += bytes([int(rng.integers(0, 4))]) * int(rng.integers(1, 90))
    return bytes(out[:n])


PAYLOADS = {
    "empty": b"",
    "one": b"a",
    "hello": b"hello world",
    "abcd": b"abcd" * 1000,
    "ramp": bytes(range(256)) * 64,
    "random-1k": _random(1, 1000),
    "random-70k": _random(2, 70_000),      # literals with 3 length bytes
    "labels": _label_heavy(3),
    "labels-big": _label_heavy(4, 3000),
    "low-entropy": _low_entropy(5, 50_000),
}


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_compress_is_byte_identical_to_the_reference(name):
    data = PAYLOADS[name]
    got = snappy.compress(data)
    assert got == jsnappy.compress(data)
    assert snappy.decompress(got) == data


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_each_package_decompresses_the_others_output(name):
    data = PAYLOADS[name]
    assert snappy.decompress(jsnappy.compress(data)) == data
    assert jsnappy.decompress(snappy.compress(data)) == data


def _literal(chunk: bytes) -> bytes:
    ln = len(chunk) - 1
    if ln < 60:
        return bytes([ln << 2]) + chunk
    nbytes = (ln.bit_length() + 7) // 8
    return bytes([(59 + nbytes) << 2]) + ln.to_bytes(nbytes, "little") + chunk


def _uvarint(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _copy1(offset, ln):
    return bytes([1 | ((ln - 4) << 2) | ((offset >> 8) << 5), offset & 0xFF])


def _copy2(offset, ln):
    return bytes([2 | ((ln - 1) << 2)]) + offset.to_bytes(2, "little")


def _copy4(offset, ln):
    return bytes([3 | ((ln - 1) << 2)]) + offset.to_bytes(4, "little")


def _blocks():
    """(name, block, expected) for every tag kind, built by hand from the
    block format's spec (the compressors emit no 4-byte-offset copies)."""
    lit = _random(6, 300)
    big = _random(7, 70_000)
    out = []
    # literal + 1-byte-offset copy (offset < 2048, length 4..11)
    out.append(("copy1", _uvarint(300 + 11) + _literal(lit) + _copy1(300, 11),
                lit + lit[:11]))
    # literal + 2-byte-offset copy (length up to 64)
    out.append(("copy2", _uvarint(300 + 64) + _literal(lit) + _copy2(300, 64),
                lit + lit[:64]))
    # a 70 KB literal (3 length bytes) + a 4-byte-offset copy reaching
    # back past 65535
    out.append(("copy4", _uvarint(70_000 + 40) + _literal(big)
                + _copy4(70_000, 40), big + big[:40]))
    # overlapping copies: RLE by copy(offset 1) and copy(offset 2)
    out.append(("overlap", _uvarint(2 + 8 + 1 + 30) + _literal(b"ab")
                + _copy2(2, 8) + _literal(b"z") + _copy1(1, 11)
                + _copy2(1, 19), b"ab" * 5 + b"z" * 31))
    # literals at the 60-byte boundary and with 1, 2 and 3 length bytes
    for n in (60, 61, 256, 257, 65536, 65537):
        chunk = _random(n, n)
        out.append((f"literal-{n}", _uvarint(n) + _literal(chunk), chunk))
    return out


@pytest.mark.parametrize("name,block,want",
                         _blocks(), ids=[b[0] for b in _blocks()])
def test_every_tag_kind_decodes_as_the_reference(name, block, want):
    assert snappy.decompress(block) == want
    assert jsnappy.decompress(block) == want


BAD_BLOCKS = {
    "empty": b"",
    "offset-past-output": bytes([4]) + bytes([2 | (3 << 2), 9, 0]),
    "length-mismatch": bytes([50]) + bytes([0 << 2]) + b"x",
    "truncated-copy1-offset": bytes([10, 1]),
    "truncated-header": b"\x80",
    "zero-offset": bytes([8]) + _literal(b"abcd") + _copy2(0, 4),
}


@pytest.mark.parametrize("name", sorted(BAD_BLOCKS))
def test_malformed_blocks_raise_value_error_in_both(name):
    for mod in (snappy, jsnappy):
        with pytest.raises(ValueError):
            mod.decompress(BAD_BLOCKS[name])
