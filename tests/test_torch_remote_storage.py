"""Prometheus remote read/write in the port against the JAX package.

The port's wire codec (``filodb_tpu_torch/promql/remote_storage.py``, no
``protobuf`` package) is held byte for byte against the reference's
generated ``remote_storage_pb2`` (protobuf's ``upb`` serializer): every
message, the edge cases where a hand-written encoder drifts (implicit
presence, ``-0.0``, NaN payloads, negative varints, an empty but present
submessage), a ``hypothesis`` property over random messages, both ways,
and the parser's handling of truncated, malformed and unknown input.
Then the reference's remote-storage tests as parity cases: the same
containers by shard, the same ReadResponse bytes for the same (f64) store,
HTTP write then read end to end, and the HTTP edges (400, 404, 422, 429,
501). Inputs come from a numpy seed. Tolerance: none — bytes and values
are compared exactly.
"""

import http.client
import json
import struct
import urllib.error
import urllib.request

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from filodb_tpu.promql import remote_storage_pb2 as jpb
from filodb_tpu.utils import snappy as jsnappy
from filodb_tpu_torch.promql import remote
from filodb_tpu_torch.promql import remote_storage as pb
from filodb_tpu_torch.utils import snappy

BASE = 1_700_000_000_000
STALE = struct.unpack("<d", bytes.fromhex("020000000000f07f"))[0]


def _both(build) -> tuple[bytes, bytes]:
    """(the port's bytes, the reference's bytes) of ``build(module)``."""
    return build(pb).SerializeToString(), build(jpb).SerializeToString()


def _cross(got: bytes, cls_name: str) -> None:
    """The reference's bytes parse in the port and serialise back to the
    same bytes, and the other way round."""
    mine = getattr(pb, cls_name)()
    mine.ParseFromString(got)
    assert mine.SerializeToString() == got
    ref = getattr(jpb, cls_name)()
    ref.ParseFromString(got)
    assert ref.SerializeToString() == got


# -- the codec: edge cases by name --------------------------------------------

def _sample(value=0.0, ts=0):
    return lambda m: m.Sample(value=value, timestamp_ms=ts)


def _series(labels, samples):
    def build(m):
        s = m.TimeSeries()
        for k, v in labels:
            s.labels.add(name=k, value=v)
        for v, t in samples:
            s.samples.add(value=v, timestamp_ms=t)
        return s
    return build


def _query_hints(mode):
    def build(m):
        r = m.ReadRequest()
        q = r.queries.add()
        q.start_timestamp_ms = BASE
        q.end_timestamp_ms = BASE + 60_000
        q.matchers.add(type=m.LabelMatcher.EQ, name="__name__", value="m")
        if mode == "set-in-parent":
            q.hints.SetInParent()
        elif mode == "fields":
            q.hints.step_ms = 15_000
            q.hints.func = "rate"
            q.hints.start_ms = BASE
            q.hints.end_ms = BASE + 60_000
        elif mode == "zero-field":
            q.hints.step_ms = 0            # assigning marks it present
        elif mode == "read-only":
            assert q.hints.step_ms == 0    # reading does not
        return r
    return build


def _matcher(t, name="host", value="h.*"):
    return lambda m: m.LabelMatcher(type=t, name=name, value=value)


EDGE = {
    "sample-empty": ("Sample", _sample()),
    "sample-neg-zero": ("Sample", _sample(-0.0)),
    "sample-stale-marker": ("Sample", _sample(STALE, BASE)),
    "sample-neg-ts": ("Sample", _sample(1.5, -5)),
    "sample-int64-min": ("Sample", _sample(2.0, -(1 << 63))),
    "sample-int64-max": ("Sample", _sample(float("inf"), (1 << 63) - 1)),
    "sample-neg-inf": ("Sample", _sample(float("-inf"), 1)),
    "sample-subnormal": ("Sample", _sample(5e-324, 127)),
    "sample-ts-128": ("Sample", _sample(1.0, 128)),
    "label-empty": ("LabelPair", lambda m: m.LabelPair()),
    "label-name-only": ("LabelPair", lambda m: m.LabelPair(name="job")),
    "label-value-only": ("LabelPair", lambda m: m.LabelPair(value="api")),
    "label-unicode": ("LabelPair",
                      lambda m: m.LabelPair(name="ü", value="日本語")),
    "label-long": ("LabelPair",
                   lambda m: m.LabelPair(name="k" * 200, value="v" * 20000)),
    "series-empty": ("TimeSeries", _series([], [])),
    "series-no-samples": ("TimeSeries", _series([("__name__", "m")], [])),
    "series-mixed": ("TimeSeries", _series(
        [("__name__", "m"), ("", ""), ("job", "api")],
        [(0.0, 0), (-0.0, -5), (STALE, BASE), (1.0, 1),
         (float("nan"), 1 << 40), (3.25, -(1 << 63))])),
    "matcher-eq": ("LabelMatcher", _matcher(0)),
    "matcher-neq": ("LabelMatcher", _matcher(1)),
    "matcher-re": ("LabelMatcher", _matcher(2)),
    "matcher-nre": ("LabelMatcher", _matcher(3)),
    "matcher-open-enum": ("LabelMatcher", _matcher(7)),
    "matcher-negative-enum": ("LabelMatcher", _matcher(-1)),
    "hints-absent": ("ReadRequest", _query_hints(None)),
    "hints-read-only": ("ReadRequest", _query_hints("read-only")),
    "hints-empty-present": ("ReadRequest", _query_hints("set-in-parent")),
    "hints-zero-field": ("ReadRequest", _query_hints("zero-field")),
    "hints-fields": ("ReadRequest", _query_hints("fields")),
    "write-empty": ("WriteRequest", lambda m: m.WriteRequest()),
    "read-response": ("ReadResponse", lambda m: _response(m)),
    "query-result-empty": ("QueryResult", lambda m: m.QueryResult()),
}


def _response(m):
    r = m.ReadResponse()
    r.results.add()                       # an empty result
    res = r.results.add()
    for i in range(3):
        s = res.timeseries.add()
        s.labels.add(name="__name__", value="m")
        s.labels.add(name="host", value=f"h{i}")
        for k in range(4):
            s.samples.add(value=float(i * k) - 1.0, timestamp_ms=BASE + k)
    return r


@pytest.mark.parametrize("name", sorted(EDGE))
def test_edge_cases_serialise_byte_for_byte_both_ways(name):
    cls_name, build = EDGE[name]
    got, want = _both(build)
    assert got == want, (got.hex(), want.hex())
    _cross(want, cls_name)


@pytest.mark.parametrize("name,hex_bytes", [
    ("sample-neg-zero", "090000000000000080"),
    ("sample-stale-marker", "09020000000000f07f" + "1080d095ffbc31"),
    ("sample-neg-ts", "09000000000000f83f10fbffffffffffffffff01"),
    ("sample-empty", ""),
    ("label-empty", ""),
    ("matcher-negative-enum", "08ffffffffffffffffff01"
     "1204686f73741a03682e2a"),
])
def test_edge_case_bytes_are_the_documented_ones(name, hex_bytes):
    got, _ = _both(EDGE[name][1])
    assert got.hex() == hex_bytes


def test_present_but_empty_hints_is_2200():
    got, want = _both(_query_hints("set-in-parent"))
    assert "2200" in got.hex() and got == want
    q = pb.ReadRequest()
    q.ParseFromString(got)
    assert q.queries[0].HasField("hints")
    q2 = pb.ReadRequest()
    q2.ParseFromString(_both(_query_hints("read-only"))[0])
    assert not q2.queries[0].HasField("hints")


def test_stale_marker_payload_survives_a_round_trip():
    body, _ = _both(EDGE["series-mixed"][1])
    s = pb.TimeSeries()
    s.ParseFromString(body)
    ts, vals = s.samples.arrays()
    assert vals.view(np.uint64)[2] == 0x7FF0000000000002
    assert struct.pack("<d", s.samples[2].value).hex() == "020000000000f07f"
    assert ts.tolist() == [0, -5, BASE, 1, 1 << 40, -(1 << 63)]


def test_columnar_and_object_samples_serialise_alike():
    rng = np.random.default_rng(11)
    ts = rng.integers(-(1 << 62), 1 << 62, 300)
    ts[::7] = 0
    vals = rng.standard_normal(300)
    vals[::5] = 0.0
    vals[3] = -0.0
    vals[4] = STALE
    a = pb.TimeSeries()
    a.samples.extend_arrays(ts, vals)
    b = pb.TimeSeries()
    for t, v in zip(ts.tolist(), vals.tolist()):
        b.samples.add(value=v, timestamp_ms=t)
    r = jpb.TimeSeries()
    for t, v in zip(ts.tolist(), vals.tolist()):
        r.samples.add(value=v, timestamp_ms=t)
    assert a.SerializeToString() == b.SerializeToString() \
        == r.SerializeToString()


# -- the codec: a property over random messages --------------------------------

_bits = st.integers(0, (1 << 64) - 1).map(
    lambda u: struct.unpack("<d", struct.pack("<Q", u))[0])
_doubles = st.one_of(_bits, st.sampled_from(
    [0.0, -0.0, STALE, float("inf"), float("-inf"), 1.0, 1e300]))
_int64 = st.one_of(st.integers(-(1 << 63), (1 << 63) - 1),
                   st.sampled_from([0, -1, 1, 127, 128, BASE]))
_text = st.text(max_size=12)
_series_spec = st.tuples(
    st.lists(st.tuples(_text, _text), max_size=4),
    st.lists(st.tuples(_doubles, _int64), max_size=12))


def _write_from(spec):
    def build(m):
        w = m.WriteRequest()
        for labels, samples in spec:
            s = w.timeseries.add()
            for k, v in labels:
                s.labels.add(name=k, value=v)
            for v, t in samples:
                s.samples.add(value=v, timestamp_ms=t)
        return w
    return build


_matcher_spec = st.tuples(st.integers(-(1 << 31), (1 << 31) - 1), _text,
                          _text)
_query_spec = st.tuples(
    _int64, _int64, st.lists(_matcher_spec, max_size=3),
    st.one_of(st.none(), st.tuples(_int64, _text, _int64, _int64)))


def _read_from(spec):
    def build(m):
        r = m.ReadRequest()
        for start, end, matchers, hints in spec:
            q = r.queries.add()
            q.start_timestamp_ms = start
            q.end_timestamp_ms = end
            for t, k, v in matchers:
                q.matchers.add(type=t, name=k, value=v)
            if hints is not None:
                q.hints.step_ms, q.hints.func = hints[0], hints[1]
                q.hints.start_ms, q.hints.end_ms = hints[2], hints[3]
        return r
    return build


@settings(max_examples=60, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(_series_spec, max_size=5))
def test_random_write_requests_are_byte_identical(spec):
    got, want = _both(_write_from(spec))
    assert got == want
    _cross(want, "WriteRequest")


@settings(max_examples=60, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(_query_spec, max_size=3))
def test_random_read_requests_are_byte_identical(spec):
    got, want = _both(_read_from(spec))
    assert got == want
    _cross(want, "ReadRequest")


# -- the codec: truncated, malformed and unknown input --------------------------

def _canonical_write() -> bytes:
    return _both(_write_from([
        ([("__name__", "m"), ("host", "h0")],
         [(1.0, BASE), (STALE, BASE + 1), (-0.0, -5)]),
        ([("__name__", "m"), ("host", "ü")], [(2.0, 0)])]))[1]


def _ref_parses(cls_name, body) -> bool:
    from google.protobuf.message import DecodeError as JDecodeError
    try:
        getattr(jpb, cls_name)().ParseFromString(body)
        return True
    except JDecodeError:
        return False


def _port_parses(cls_name, body) -> bool:
    try:
        getattr(pb, cls_name)().ParseFromString(body)
        return True
    except pb.DecodeError:
        return False


def test_every_truncation_is_refused_where_the_reference_refuses_it():
    body = _canonical_write()
    refused = 0
    for n in range(len(body)):
        ok = _ref_parses("WriteRequest", body[:n])
        assert _port_parses("WriteRequest", body[:n]) == ok, n
        refused += not ok
    assert refused > len(body) // 2
    assert issubclass(pb.DecodeError, ValueError)


MALFORMED = {
    "wire-type-6": bytes([0x0E, 0x01]),
    "wire-type-7": bytes([0x0F, 0x01]),
    "field-zero": bytes([0x00, 0x01]),
    "stray-end-group": bytes([0x0C]),
    "mismatched-end-group": bytes([0x1B, 0x24]),
    "varint-11-bytes": bytes([0x10]) + b"\xff" * 10 + b"\x01",
    "truncated-fixed64": bytes([0x09, 1, 2, 3]),
    "length-past-end": bytes([0x0A, 0x05, 0x41]),
}


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_malformed_bodies_raise_decode_error(name):
    body = MALFORMED[name]
    for cls_name in ("Sample", "TimeSeries", "WriteRequest"):
        assert not _ref_parses(cls_name, body), (cls_name, name)
        assert not _port_parses(cls_name, body), (cls_name, name)


def test_invalid_utf8_is_refused_as_the_reference_refuses_it():
    body = bytes([0x0A, 0x01, 0xFF])
    assert not _ref_parses("LabelPair", body)
    with pytest.raises(pb.DecodeError):
        pb.LabelPair().ParseFromString(body)


UNKNOWN = {
    "varint": bytes([0x38, 0x96, 0x01]),                  # field 7
    "fixed64": bytes([0x39]) + bytes(range(8)),
    "len": bytes([0x3A, 0x03]) + b"abc",
    "fixed32": bytes([0x3D]) + bytes(range(4)),
    "group": bytes([0x3B, 0x08, 0x01, 0x3C]),
    "known-number-wrong-type": bytes([0x15]) + bytes(4),  # field 2, i32
}


@pytest.mark.parametrize("name", sorted(UNKNOWN))
def test_unknown_fields_are_skipped_and_the_rest_kept(name):
    """An unknown field (or a known number with the wrong wire type) is
    skipped by its wire type at every level; what remains equals the
    reference's parse with its unknown fields discarded."""
    junk = UNKNOWN[name]
    sample = junk + b"\x09" + struct.pack("<d", 2.5) + junk + b"\x10\x05"
    series = (junk + b"\x0a\x04\x0a\x02ab" + junk + b"\x12"
              + bytes([len(sample)]) + sample + junk)
    body = b"\x0a" + bytes([len(series)]) + series + junk
    ref = jpb.WriteRequest()
    ref.ParseFromString(body)
    ref.DiscardUnknownFields()
    mine = pb.WriteRequest()
    mine.ParseFromString(body)
    assert mine.SerializeToString() == ref.SerializeToString()
    assert mine.timeseries[0].samples[0].value == 2.5
    assert mine.timeseries[0].samples[0].timestamp_ms == 5


def test_repeated_scalars_take_the_last_and_submessages_merge():
    body = (b"\x0a\x10" + b"\x08\x01" + b"\x08\x02"
            + b"\x22\x02\x08\x05" + b"\x22\x04\x12\x02rt" + b"\x10\x07")
    ref = jpb.ReadRequest()
    ref.ParseFromString(body)
    mine = pb.ReadRequest()
    mine.ParseFromString(body)
    assert mine.SerializeToString() == ref.SerializeToString()
    q = mine.queries[0]
    assert (q.start_timestamp_ms, q.end_timestamp_ms) == (2, 7)
    assert (q.hints.step_ms, q.hints.func) == (5, "rt")


def test_open_enum_values_are_kept():
    for t in (4, 99, -1, (1 << 31) - 1):
        got, want = _both(_matcher(t))
        assert got == want
        m = pb.LabelMatcher()
        m.ParseFromString(want)
        assert m.type == t


# -- the reference's remote-storage tests, as parity ---------------------------

def _stores(num_shards=2, dtype="float64"):
    """The reference's fixture in both packages: heap_usage of 4 hosts x 10
    samples on shard 0 of ``num_shards``."""
    from filodb_tpu.core.memstore import StoreConfig as JStoreConfig
    from filodb_tpu.core.memstore import TimeSeriesMemStore as JMemStore
    from filodb_tpu.core.record import RecordBuilder as JRecordBuilder
    from filodb_tpu.core.schemas import GAUGE as JGAUGE
    from filodb_tpu_torch.core.memstore import StoreConfig, TimeSeriesMemStore
    from filodb_tpu_torch.core.record import RecordBuilder
    from filodb_tpu_torch.core.schemas import GAUGE
    out = []
    for StoreConfig_, MemStore, Builder, schema, kw in (
            (StoreConfig, TimeSeriesMemStore, RecordBuilder, GAUGE,
             {"device": "cpu"}),
            (JStoreConfig, JMemStore, JRecordBuilder, JGAUGE, {})):
        ms = MemStore(**kw)
        cfg = StoreConfig_(max_series_per_shard=16, samples_per_series=64,
                           flush_batch_size=10**9, dtype=dtype, **kw)
        for s in range(num_shards):
            ms.setup("prometheus", schema, s, cfg)
        b = Builder(schema)
        for i in range(4):
            for k in range(10):
                b.add({"_metric_": "heap_usage", "host": f"h{i}",
                       "dc": "east"}, BASE + k * 10_000, float(100 * i + k))
        ms.ingest("prometheus", 0, b.build())
        ms.flush_all()
        out.append(ms)
    return out


def _engines(stores):
    from filodb_tpu.query.engine import QueryEngine as JQueryEngine
    from filodb_tpu_torch.query.engine import QueryEngine
    return (QueryEngine(stores[0], "prometheus", device="cpu"),
            JQueryEngine(stores[1], "prometheus"))


def _read_body(mod, matchers, start=BASE, end=BASE + 1_000_000):
    req = mod.ReadRequest()
    q = req.queries.add()
    q.start_timestamp_ms = start
    q.end_timestamp_ms = end
    for t, k, v in matchers:
        q.matchers.add(type=t, name=k, value=v)
    return req


def test_read_request_conversion_parity():
    from filodb_tpu.promql import remote as jremote
    eng, jeng = _engines(_stores())
    matchers = [(0, "__name__", "heap_usage"), (2, "host", "h[01]")]
    body = snappy.compress(_read_body(pb, matchers).SerializeToString())
    assert body == jsnappy.compress(
        _read_body(jpb, matchers).SerializeToString())
    out = remote.read_request(body, eng)
    assert out == jremote.read_request(body, jeng)       # the same bytes
    resp = jpb.ReadResponse()
    resp.ParseFromString(jsnappy.decompress(out))
    assert len(resp.results) == 1
    series = resp.results[0].timeseries
    assert sorted(next(lp.value for lp in s.labels if lp.name == "host")
                  for s in series) == ["h0", "h1"]
    for s in series:
        assert any(lp.name == "__name__" and lp.value == "heap_usage"
                   for lp in s.labels)
        ts = [smp.timestamp_ms for smp in s.samples]
        assert len(ts) == 10 and ts == sorted(ts)


@pytest.mark.parametrize("matchers,window", [
    ([(0, "__name__", "heap_usage")], (BASE, BASE + 1_000_000)),
    ([(1, "host", "h2"), (0, "dc", "east")], (BASE + 20_000, BASE + 60_000)),
    ([(3, "host", "h[12]")], (0, BASE + 45_000)),
    ([(0, "__name__", "nope")], (BASE, BASE + 1_000_000)),
], ids=["all", "neq-window", "nre", "none"])
def test_read_response_bytes_equal_across_packages(matchers, window):
    from filodb_tpu.promql import remote as jremote
    eng, jeng = _engines(_stores())
    body = snappy.compress(
        _read_body(pb, matchers, *window).SerializeToString())
    assert remote.read_request(body, eng) == jremote.read_request(body, jeng)


def test_write_request_routing_parity():
    """The same body gives the same containers by shard, bit for bit."""
    from filodb_tpu.promql import remote as jremote
    stores = _stores(num_shards=4)
    eng, jeng = _engines(stores)
    rng = np.random.default_rng(3)
    req = jpb.WriteRequest()
    for i in range(8):
        series = req.timeseries.add()
        series.labels.add(name="__name__", value="written")
        series.labels.add(name="host", value=f"w{i}")
        for k in range(3):
            series.samples.add(value=float(rng.standard_normal()),
                               timestamp_ms=BASE + k * 10_000)
    req.timeseries.add()                    # a series with nothing in it
    body = jsnappy.compress(req.SerializeToString())
    mine = remote.write_request_to_containers(
        body, stores[0]._dataset_schema["prometheus"], eng.mapper)
    ref = jremote.write_request_to_containers(
        body, stores[1]._dataset_schema["prometheus"], jeng.mapper)
    assert sorted(mine) == sorted(ref)
    assert sum(len(c) for c in mine.values()) == 24
    for shard in ref:
        assert mine[shard].to_bytes() == ref[shard].to_bytes(), shard
        assert mine[shard].schema.name == "gauge"


def test_aggregate_with_empty_shard_parity():
    eng, jeng = _engines(_stores(num_shards=2))
    got = eng.query_range("sum(heap_usage)", BASE, BASE + 60_000, 30_000)
    want = jeng.query_range("sum(heap_usage)", BASE, BASE + 60_000, 30_000)
    assert got.matrix.num_series == 1
    (_, _, gv), = list(got.matrix.iter_series())
    (_, _, wv), = list(want.matrix.iter_series())
    assert gv[0] == 600.0
    assert np.asarray(gv).tolist() == np.asarray(wv).tolist()


def _http(port, path, body, method="POST"):
    rq = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                data=body, method=method)
    try:
        with urllib.request.urlopen(rq, timeout=10) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _write_body(mod, samples, labels=(("__name__", "rw_metric"),
                                      ("src", "remote"))):
    req = mod.WriteRequest()
    s = req.timeseries.add()
    for k, v in labels:
        s.labels.add(name=k, value=v)
    for v, t in samples:
        s.samples.add(value=v, timestamp_ms=t)
    return (snappy if mod is pb else jsnappy).compress(req.SerializeToString())


def test_remote_write_then_read_http_end_to_end():
    """The reference's end-to-end test on the port's server, with the
    bodies encoded by the reference's client; and the same exchange with
    the reference's server answers the same bytes."""
    from filodb_tpu.http.api import FiloHttpServer as JFiloHttpServer
    from filodb_tpu_torch.http.api import FiloHttpServer
    stores = _stores()
    eng, jeng = _engines(stores)

    def writer_for(ms):
        def writer(per_shard):
            for shard, container in per_shard.items():
                ms.ingest("prometheus", shard % 2, container)
            ms.flush_all()
        return writer

    srv = FiloHttpServer({"prometheus": eng}, port=0,
                         writers={"prometheus": writer_for(stores[0])}).start()
    jsrv = JFiloHttpServer({"prometheus": jeng}, port=0,
                           writers={"prometheus": writer_for(stores[1])}
                           ).start()
    try:
        samples = [(2.5 * k, BASE + k * 15_000) for k in range(5)]
        samples.append((STALE, BASE + 5 * 15_000))
        body = _write_body(jpb, samples)
        assert body == _write_body(pb, samples)
        outs = []
        for port in (srv.port, jsrv.port):
            code, _h, _b = _http(port, "/promql/prometheus/api/v1/write",
                                 body)
            assert code == 204
            rr = snappy.compress(_read_body(
                pb, [(0, "__name__", "rw_metric")]).SerializeToString())
            code, headers, out = _http(
                port, "/promql/prometheus/api/v1/read", rr)
            assert code == 200 and headers["Content-Encoding"] == "snappy"
            outs.append(out)
        assert outs[0] == outs[1]
        pr = jpb.ReadResponse()
        pr.ParseFromString(jsnappy.decompress(outs[0]))
        assert len(pr.results[0].timeseries) == 1
        got = pr.results[0].timeseries[0].samples
        assert [s.value for s in got][:5] == [0.0, 2.5, 5.0, 7.5, 10.0]
        assert struct.pack("<d", got[5].value) == struct.pack("<d", STALE)
    finally:
        srv.stop()
        jsrv.stop()


def test_http_error_edges():
    """400 a malformed body (bad snappy, bad protobuf), 404 an unknown
    dataset, 422 the reserved ``__rule__`` label, 501 a write without a
    writer."""
    from filodb_tpu_torch.http.api import FiloHttpServer
    from filodb_tpu_torch.rules import RULE_LABEL
    eng, _ = _engines(_stores())
    got = []
    srv = FiloHttpServer({"prometheus": eng}, port=0,
                         writers={"prometheus": got.append}).start()
    bare = FiloHttpServer({"prometheus": eng}, port=0).start()
    try:
        w = "/promql/prometheus/api/v1/write"
        r = "/promql/prometheus/api/v1/read"
        for path in (w, r):
            assert _http(srv.port, path, b"\x05\x00garbage")[0] == 400
            assert _http(srv.port, path,
                         snappy.compress(b"\x0a\x05\x41"))[0] == 400
        code, _h, payload = _http(srv.port, w, b"")
        assert code == 400 and b"malformed remote-write" in payload
        assert _http(srv.port, "/promql/nope/api/v1/write", b"")[0] == 404
        spoof = _write_body(pb, [(1.0, BASE)],
                            labels=(("__name__", "forged"),
                                    (RULE_LABEL, "g/r")))
        code, _h, payload = _http(srv.port, w, spoof)
        assert code == 422 and b"reserved for recording-rule" in payload
        assert not got
        assert _http(bare.port, w, _write_body(pb, [(1.0, BASE)]))[0] == 501
    finally:
        srv.stop()
        bare.stop()


def test_backpressure_maps_to_429_with_retry_after():
    from filodb_tpu_torch.http.api import FiloHttpServer
    from filodb_tpu_torch.ingest.broker import BrokerRetry
    stores = _stores()
    eng, _ = _engines(stores)
    calls = {"n": 0}

    def writer(per_shard):
        calls["n"] += 1
        if calls["n"] == 1:
            raise BrokerRetry(0.25)
        for shard, c in per_shard.items():
            stores[0].ingest("prometheus", shard % 2, c)

    srv = FiloHttpServer({"prometheus": eng}, port=0,
                         writers={"prometheus": writer}).start()
    try:
        body = _write_body(pb, [(1.0, BASE)])
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=10)
        conn.request("POST", "/promql/prometheus/api/v1/write", body=body)
        r = conn.getresponse()
        payload = json.loads(r.read())
        assert r.status == 429 and payload["errorType"] == "busy"
        assert int(r.getheader("Retry-After")) >= 1
        conn.request("POST", "/promql/prometheus/api/v1/write", body=body)
        r2 = conn.getresponse()
        r2.read()
        assert r2.status == 204 and calls["n"] == 2
        conn.close()
    finally:
        srv.stop()


def _governed_server(pkg):
    """A one-shard f64 store with a tenant limit of 2 series, its HTTP
    server with the governor's fast-shed edge, in ``pkg`` ("port"/"jax")."""
    if pkg == "port":
        from filodb_tpu_torch.core.cardinality import CardinalityGovernor
        from filodb_tpu_torch.core.memstore import (StoreConfig,
                                                    TimeSeriesMemStore)
        from filodb_tpu_torch.core.schemas import GAUGE, part_key_of
        from filodb_tpu_torch.http.api import FiloHttpServer
        from filodb_tpu_torch.query.engine import QueryEngine
        kw = {"device": "cpu"}
    else:
        from filodb_tpu.core.cardinality import CardinalityGovernor
        from filodb_tpu.core.memstore import StoreConfig, TimeSeriesMemStore
        from filodb_tpu.core.schemas import GAUGE, part_key_of
        from filodb_tpu.http.api import FiloHttpServer
        from filodb_tpu.query.engine import QueryEngine
        kw = {}
    ms = TimeSeriesMemStore(**kw)
    sh = ms.setup("prometheus", GAUGE, 0, StoreConfig(
        max_series_per_shard=64, samples_per_series=64,
        flush_batch_size=10**9, dtype="float64", **kw))
    gov = CardinalityGovernor(2, dataset="prometheus", retry_after_s=7.0)
    sh.governor = gov

    def writer(per_shard):
        for shard, c in per_shard.items():
            ms.ingest("prometheus", shard, c)

    def series_known(shard_num, labels):
        with sh.lock:
            return part_key_of(labels, sh.schema.options) \
                in sh._part_key_to_id

    srv = FiloHttpServer({"prometheus": QueryEngine(ms, "prometheus", **kw)},
                         port=0, writers={"prometheus": writer},
                         governors={"prometheus": (gov, series_known)})
    return srv.start(), sh, gov


def _tenant_body(hosts, ts):
    req = pb.WriteRequest()
    for h in hosts:
        s = req.timeseries.add()
        for k, v in (("__name__", "m"), ("_ws_", "acme"), ("_ns_", "app"),
                     ("host", h)):
            s.labels.add(name=k, value=v)
        s.samples.add(value=1.0, timestamp_ms=ts)
    return snappy.compress(req.SerializeToString())


def test_quota_sheds_only_new_series_with_429_as_the_reference():
    """An over-quota NEW series answers 429 + Retry-After (too_many_series)
    and the kept samples of existing series land — in both packages, with
    the same status codes, headers' hint and store effect."""
    from filodb_tpu.core import filters as JF
    from filodb_tpu_torch.core import filters as F
    seen = {}
    for pkg, filters in (("port", F), ("jax", JF)):
        srv, sh, gov = _governed_server(pkg)
        try:
            path = "/promql/prometheus/api/v1/write"
            first = _http(srv.port, path, _tenant_body(["h0", "h1"], BASE))
            second = _http(srv.port, path, _tenant_body(
                ["h0", "h1", "h2"], BASE + 10_000))
            sh.flush()
            pids = sh.part_ids_from_filters([filters.Equals("_metric_", "m")],
                                            0, 1 << 62)
            lens = sorted(len(sh.store.series_snapshot(int(p))[0])
                          for p in pids)
            seen[pkg] = (first[0], second[0],
                         int(second[1]["Retry-After"]),
                         json.loads(second[2])["errorType"],
                         gov.active("acme"), sh.num_series, lens)
        finally:
            srv.stop()
    assert seen["port"] == seen["jax"]
    assert seen["port"][:4] == (204, 429, 7, "too_many_series")
    assert seen["port"][5:] == (2, [2, 2])
