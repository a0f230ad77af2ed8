"""The port's host codecs and durable byte formats against the JAX
package's: NibblePack (u64, delta, doubles), delta-delta, bit-packed ints,
the 2D-delta histogram codec, the native C++ library beside the numpy spec,
the chunk-log frames, the index.log time-bucket frames, partkeys.log,
checkpoint.json, meta.json and the FileBus log.

Inputs are seeded numpy arrays (the ``rng`` fixture and fixed generators),
mirroring ``tests/test_nibblepack.py``, ``tests/test_native.py``,
``tests/test_intpack.py`` and ``tests/test_hist.py``'s codec cases.

Tolerance: none. Every encoding must be byte-identical between the two
packages, every decode bit-identical (NaN payloads and signed zeros
included), and every file the two packages' sinks write must hold the same
bytes.
"""

import io
import os

import numpy as np
import pytest

from filodb_tpu.core import store as jstore
from filodb_tpu.core.record import RecordBuilder as JRecordBuilder
from filodb_tpu.core.schemas import GAUGE as JGAUGE
from filodb_tpu.core.schemas import PROM_HISTOGRAM as JPROM_HISTOGRAM
from filodb_tpu.core.schemas import Schemas as JSchemas
from filodb_tpu.ingest.bus import FileBus as JFileBus
from filodb_tpu.memory import deltadelta as jdd
from filodb_tpu.memory import hist as jhist
from filodb_tpu.memory import intpack as jintpack
from filodb_tpu.memory import native as jnative
from filodb_tpu.memory import nibblepack as jnp_
from filodb_tpu_torch.core import store as tstore
from filodb_tpu_torch.core.record import RecordBuilder
from filodb_tpu_torch.core.schemas import GAUGE, PROM_HISTOGRAM, Schemas
from filodb_tpu_torch.ingest.bus import FileBus
from filodb_tpu_torch.memory import deltadelta as tdd
from filodb_tpu_torch.memory import hist as thist
from filodb_tpu_torch.memory import intpack as tintpack
from filodb_tpu_torch.memory import native as tnative
from filodb_tpu_torch.memory import nibblepack as tnp_

BASE = 1_700_000_000_000
IV = 10_000


def u64_values(rng, n):
    vals = rng.integers(0, 2**63, size=n, dtype=np.uint64)
    vals[rng.random(n) < 0.3] = 0
    vals[rng.random(n) < 0.2] >>= np.uint64(40)
    return vals


# -- NibblePack ---------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 3, 7, 8, 9, 64, 1000])
def test_pack_u64_bytes_equal_the_reference(n, rng):
    vals = u64_values(rng, n)
    buf = tnp_.pack_u64(vals)
    assert buf == jnp_.pack_u64(vals)
    np.testing.assert_array_equal(tnp_.unpack_u64(buf, n),
                                  jnp_.unpack_u64(buf, n))
    np.testing.assert_array_equal(tnp_.unpack_u64(buf, n), vals)


def test_pack_u64_extremes_and_spec_example():
    vals = np.array([0, 1, 2**64 - 1, 0xF0, 0x0F, 1 << 63, 0xFFFF_0000_0000],
                    dtype=np.uint64)
    assert tnp_.pack_u64(vals) == jnp_.pack_u64(vals)
    spec = np.array([0x123000, 0x456000, 0, 0, 0, 0, 0, 0, 0, 0xAB],
                    dtype=np.uint64)
    assert tnp_.pack_u64(spec) == jnp_.pack_u64(spec) \
        == bytes.fromhex("03232361450210ab")
    assert tnp_.pack_u64(np.zeros(16, np.uint64)) == b"\x00\x00"


@pytest.mark.parametrize("n", [1, 5, 8, 100, 720])
def test_pack_delta_bytes_equal_the_reference(n, rng):
    vals = np.cumsum(rng.integers(0, 10_000, size=n)).astype(np.int64)
    buf = tnp_.pack_delta(vals)
    assert buf == jnp_.pack_delta(vals)
    np.testing.assert_array_equal(tnp_.unpack_delta(buf, n), vals)
    clamp = np.array([100, 200, 150, 300], dtype=np.int64)
    assert tnp_.pack_delta(clamp) == jnp_.pack_delta(clamp)
    np.testing.assert_array_equal(tnp_.unpack_delta(tnp_.pack_delta(clamp), 4),
                                  jnp_.unpack_delta(jnp_.pack_delta(clamp), 4))


@pytest.mark.parametrize("n", [1, 2, 9, 100, 720])
def test_pack_doubles_bytes_equal_the_reference(n, rng):
    vals = rng.normal(1000, 5, size=n)
    vals[rng.random(n) < 0.1] = 0.0
    buf = tnp_.pack_doubles(vals)
    assert buf == jnp_.pack_doubles(vals)
    got = tnp_.unpack_doubles(buf, n)
    np.testing.assert_array_equal(got.view(np.uint64), vals.view(np.uint64))


def test_pack_doubles_special_values():
    vals = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e308, 5e-324])
    buf = tnp_.pack_doubles(vals)
    assert buf == jnp_.pack_doubles(vals)
    np.testing.assert_array_equal(
        tnp_.unpack_doubles(buf, len(vals)).view(np.uint64),
        vals.view(np.uint64))


# -- delta-delta, intpack, histograms -------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 2, 100, 719])
def test_deltadelta_bytes_equal_the_reference(n, rng):
    ts = np.cumsum(rng.integers(9000, 11000, size=n)).astype(np.int64)
    buf = tdd.encode(ts)
    assert buf == jdd.encode(ts) == tdd.encode_py(ts)
    np.testing.assert_array_equal(tdd.decode(buf), jdd.decode(buf))
    np.testing.assert_array_equal(tdd.decode_py(buf), ts)
    neg = rng.integers(-(2**40), 2**40, size=100).astype(np.int64)
    assert tdd.encode(neg) == jdd.encode(neg)
    line = BASE + IV * np.arange(720, dtype=np.int64)
    assert tdd.encode(line) == jdd.encode(line)


@pytest.mark.parametrize("arr", [
    np.zeros(5, np.int64), np.full(9, 7, np.int64),
    np.arange(100, dtype=np.int64), np.array([-5, 3, 1 << 40], np.int64),
    np.array([0, 1, 0, 1, 1, 0, 1, 0, 1], np.int64)])
def test_intpack_bytes_equal_the_reference(arr):
    buf = tintpack.pack_ints(arr)
    assert buf == jintpack.pack_ints(arr)
    np.testing.assert_array_equal(tintpack.unpack_ints(buf), arr)
    assert tintpack.is_integral(arr.astype(np.float64)) \
        == jintpack.is_integral(arr.astype(np.float64))


def test_intpack_random_widths(rng):
    for span in (1, 3, 15, 255, 65535, 2**31, 2**50):
        arr = rng.integers(0, span, size=333, dtype=np.int64) - span // 3
        assert tintpack.pack_ints(arr) == jintpack.pack_ints(arr), span
    frac = rng.normal(0, 1, 50)
    assert tintpack.is_integral(frac) == jintpack.is_integral(frac) is False


def hist_series(rng, n=100, B=16):
    inc = (rng.random((n, B)) < 0.3) * rng.integers(0, 5, (n, B))
    return np.cumsum(np.cumsum(inc, axis=1), axis=0).astype(np.int64)


def test_hist_codec_bytes_equal_the_reference(rng):
    counts = hist_series(rng)
    buf = thist.encode_hist_series(counts)
    assert buf == jhist.encode_hist_series(counts) \
        == thist.encode_hist_series_py(counts)
    np.testing.assert_array_equal(thist.decode_hist_series(buf), counts)
    np.testing.assert_array_equal(thist.decode_hist_series_py(buf),
                                  jhist.decode_hist_series(buf))


def test_native_library_matches_the_numpy_spec_and_the_reference(rng):
    """The port builds its own copy of codecs.cpp; it must agree bit for
    bit with the numpy spec and with the JAX package's build."""
    if not (tnative.available() and jnative.available()):
        pytest.skip("native codec library unavailable (no toolchain)")
    assert os.path.dirname(tnative._LIB_PATH) != os.path.dirname(
        jnative._LIB_PATH)
    for n in (1, 7, 8, 9, 100, 1000):
        vals = u64_values(rng, n)
        assert tnative.pack_u64(vals) == tnp_.pack_u64(vals) \
            == jnative.pack_u64(vals), n
        np.testing.assert_array_equal(
            tnative.unpack_u64(tnative.pack_u64(vals), n), vals)
    d = rng.normal(0, 1e3, 777)
    assert tnative.pack_doubles(d) == tnp_.pack_doubles(d)
    np.testing.assert_array_equal(
        tnative.unpack_doubles(tnative.pack_doubles(d), 777), d)
    counts = hist_series(rng, 50, 8)
    assert tnative.hist_encode(counts) == jnative.hist_encode(counts)
    assert tstore.CODEC_BACKEND == "native"


# -- chunk-log frames -------------------------------------------------------------

def chunk_records(pkg_store, rng):
    ts = BASE + IV * np.arange(50, dtype=np.int64)
    floats = np.sin(np.arange(50)) * 100
    ints = np.cumsum(rng.integers(0, 9, 50)).astype(np.float64)
    hist = hist_series(rng, 50, 6).astype(np.float64)
    layout = (("sum", 0, 1, False), ("count", 1, 1, False),
              ("h", 2, 6, True))
    multi = np.concatenate([floats[:, None], ints[:, None], hist], axis=1)
    R = pkg_store.ChunkSetRecord
    return [R(7, ts, floats), R(3, ts[:20], ints[:20]), R(9, ts, hist),
            R(11, ts, multi, layout), R(12, ts[:1], floats[:1])]


def test_chunk_frames_are_byte_identical(rng):
    seed = rng.integers(0, 1 << 30)
    frame_t = tstore.encode_chunkset(
        3, chunk_records(tstore, np.random.default_rng(seed)))
    frame_j = jstore.encode_chunkset(
        3, chunk_records(jstore, np.random.default_rng(seed)))
    assert frame_t == frame_j
    # each package decodes the other's frames to the same records
    for parse in (tstore.iter_chunksets, jstore.iter_chunksets):
        (g, recs), = list(parse(io.BytesIO(frame_t)))
        assert g == 3 and [r.part_id for r in recs] == [7, 3, 9, 11, 12]
        ref = chunk_records(tstore, np.random.default_rng(seed))
        for r, want in zip(recs, ref):
            np.testing.assert_array_equal(r.ts, want.ts)
            np.testing.assert_array_equal(r.values, want.values)
    # a torn tail frame truncates; the age-out re-encode matches too
    torn = frame_t + frame_t[:len(frame_t) // 2]
    assert len(list(tstore.iter_chunksets(io.BytesIO(torn)))) == 1
    assert tstore._good_frame_prefix_len(torn) == len(frame_t)
    cut = BASE + 25 * IV
    got_t = tstore.encode_age_out(list(tstore.iter_chunksets(
        io.BytesIO(frame_t))), cut)
    got_j = jstore.encode_age_out(list(jstore.iter_chunksets(
        io.BytesIO(frame_j))), cut)
    assert got_t == got_j and got_t[1] > 0


def test_index_frames_are_byte_identical():
    entries = [(0, BASE, b"a\x01x\x00b\x01y"), (1, BASE + 5, b"a\x01z"),
               (2, -1, b""), (3, BASE, b"", 1)]
    frame = tstore.encode_index_bucket(BASE, entries)
    assert frame == jstore.encode_index_bucket(BASE, entries)
    got = list(tstore.iter_index_frames(io.BytesIO(
        frame + frame[:len(frame) // 2])))
    assert len(got) == 1
    bucket, pids, starts, blobs, flags = got[0]
    assert (bucket, pids.tolist(), starts.tolist(), flags.tolist()) == \
        (BASE, [0, 1, 2, 3], [BASE, BASE + 5, -1, BASE], [0, 0, 0, 1])
    assert tstore.labels_from_blob(blobs[0]) == \
        jstore.labels_from_blob(blobs[0]) == {"a": "x", "b": "y"}
    bad = bytearray(frame)
    bad[-1] ^= 0xFF
    assert list(tstore.iter_index_frames(io.BytesIO(bytes(bad)))) == []


def read_tree(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_sink_files_are_byte_identical(tmp_path, rng):
    """The same writes through each package's FileColumnStore leave the
    same files: chunks.log, partkeys.log, index.log, checkpoint.json,
    meta.json."""
    seed = rng.integers(0, 1 << 30)
    for name, pkg in (("t", tstore), ("j", jstore)):
        sink = pkg.FileColumnStore(str(tmp_path / name))
        sink.write_chunkset("ds", 0, 1, chunk_records(
            pkg, np.random.default_rng(seed)))
        sink.write_part_keys("ds", 0, [(0, {"_metric_": "m", "h": "a"}, BASE),
                                       (1, {}, -1)])
        sink.write_index_bucket("ds", 0, pkg.encode_index_bucket(
            pkg.INDEX_GENESIS_BUCKET, [(0, BASE, b"h\x01a")]))
        sink.write_checkpoint("ds", 0, 2, 41)
        sink.write_checkpoint("ds", 0, 0, 7)
        sink.write_meta("ds", 0, {"bucket_les": [1.0, 2.0, float("inf")]})
    t, j = read_tree(tmp_path / "t"), read_tree(tmp_path / "j")
    assert sorted(t) == sorted(j) == sorted(
        os.path.join("ds", "shard0", f) for f in
        ("chunks.log", "partkeys.log", "index.log", "checkpoint.json",
         "meta.json"))
    for k in t:
        assert t[k] == j[k], k
    cross = tstore.FileColumnStore(str(tmp_path / "j"))
    assert cross.read_checkpoints("ds", 0) == {2: 41, 0: 7}
    assert list(cross.read_part_keys("ds", 0)) == [
        (0, {"_metric_": "m", "h": "a"}, BASE), (1, {}, -1)]


def test_null_column_store_checkpoints():
    for pkg in (tstore, jstore):
        sink = pkg.NullColumnStore()
        sink.write_checkpoint("ds", 0, 1, 42)
        assert sink.read_checkpoints("ds", 0) == {1: 42}


def gauge_container(builder_cls, schema, i):
    b = builder_cls(schema)
    for t in range(10):
        for s in range(4):
            b.add({"_metric_": "m", "host": f"h{s}"}, BASE + (i * 10 + t) * IV,
                  float(s * 1000 + i * 10 + t))
    return b.build()


def hist_container(builder_cls, schema, i):
    les = np.array([1.0, 5.0, 25.0, np.inf])
    b = builder_cls(schema, bucket_les=les)
    for t in range(5):
        b.add({"_metric_": "lat", "host": "h0"}, BASE + (i * 5 + t) * IV,
              {"sum": float(t), "count": float(3 * t),
               "h": np.array([t, 2 * t, 3 * t, 3 * t], np.float64)})
    return b.build()


def test_bus_logs_are_byte_identical(tmp_path):
    tb = FileBus(str(tmp_path / "t" / "bus.log"))
    jb = JFileBus(str(tmp_path / "j" / "bus.log"))
    for i in range(3):
        assert tb.publish(gauge_container(RecordBuilder, GAUGE, i)) == \
            jb.publish(gauge_container(JRecordBuilder, JGAUGE, i)) == 2 * i
        assert tb.publish(hist_container(RecordBuilder, PROM_HISTOGRAM, i)) \
            == jb.publish(hist_container(JRecordBuilder, JPROM_HISTOGRAM, i))
    assert (tmp_path / "t" / "bus.log").read_bytes() == \
        (tmp_path / "j" / "bus.log").read_bytes()
    # the port's bus replays the reference's log from an offset
    cross = FileBus(str(tmp_path / "j" / "bus.log"))
    got = list(cross.consume(Schemas(), 2))
    assert [o for o, _ in got] == [2, 3, 4, 5]
    ref = list(JFileBus(str(tmp_path / "t" / "bus.log")).consume(JSchemas(), 2))
    for (_o, c), (_p, r) in zip(got, ref):
        np.testing.assert_array_equal(c.ts, r.ts)
        np.testing.assert_array_equal(c.values, r.values)
        assert list(c.label_sets) == list(r.label_sets)
    assert cross.publish(gauge_container(RecordBuilder, GAUGE, 9)) == 6


def varied_records(pkg_store, rng, n_rec=40, layout=None):
    """Records of every shape the frame encoder meets: grid and jittered
    timestamps, lengths 1-70, integral values of every bit width (constant,
    sub-byte, 8-64 bits, negative), non-integral values, NaN and Inf."""
    recs = []
    for i in range(n_rec):
        n = int(rng.integers(1, 70))
        if i % 3 == 0:
            ts = BASE + IV * np.arange(n, dtype=np.int64)
        else:
            ts = BASE + np.cumsum(rng.integers(1, 2 * IV, n)).astype(np.int64)
        kinds = []
        for c in range(1 if layout is None else len(layout)):
            k = (i + c) % 8
            if k == 0:
                v = np.full(n, float(rng.integers(-9, 9)))
            elif k == 1:
                v = rng.integers(0, 4, n).astype(np.float64)
            elif k == 2:
                v = rng.integers(-(1 << 40), 1 << 40, n).astype(np.float64)
            elif k == 3:
                v = np.cumsum(rng.integers(0, 300, n)).astype(np.float64)
            elif k == 4:
                v = rng.normal(0, 1e3, n)
            elif k == 5:
                v = rng.integers(0, 1 << 20, n).astype(np.float64)
                v[rng.random(n) < 0.2] = np.nan
            elif k == 6:
                v = rng.integers(0, 2, n).astype(np.float64) * 2.0 ** 52
                v[0] = np.inf
            else:
                v = rng.integers(-5, 5, n).astype(np.float64) + 0.5
            kinds.append(v)
        vals = kinds[0] if layout is None else np.stack(kinds, axis=1)
        recs.append(pkg_store.ChunkSetRecord(int(rng.integers(0, 1 << 20)),
                                             ts, vals, layout))
    return recs


@pytest.mark.parametrize("multicol", [False, True])
def test_frame_encoder_is_byte_identical_on_every_shape(multicol, rng):
    """The frame-wide encoder (checks once a frame, grid timestamps without
    a pack call) writes the reference's per-record bytes; the decoder (grid
    timestamps from the header, scalar columns straight into one block)
    reads back the reference's records bit for bit."""
    layout = (tuple((f"c{j}", j, 1, False) for j in range(7))
              if multicol else None)
    seed = int(rng.integers(0, 1 << 30))
    got = tstore.encode_chunkset(5, varied_records(
        tstore, np.random.default_rng(seed), layout=layout))
    want = jstore.encode_chunkset(5, varied_records(
        jstore, np.random.default_rng(seed), layout=layout))
    assert got == want
    recs = varied_records(tstore, np.random.default_rng(seed), layout=layout)
    assert tstore._encode_records_fast(recs) is not None
    (g, back), = list(tstore.iter_chunksets(io.BytesIO(got)))
    (_g, ref), = list(jstore.iter_chunksets(io.BytesIO(got)))
    for r, j, w in zip(back, ref, recs):
        np.testing.assert_array_equal(r.ts, w.ts)
        np.testing.assert_array_equal(r.values, w.values)
        assert r.values.dtype == j.values.dtype and r.layout == j.layout
        np.testing.assert_array_equal(r.values.view(np.uint64),
                                      j.values.view(np.uint64))
