"""Prometheus remote-storage messages: the port's own protobuf wire codec.

The port's twin of ``filodb_tpu/promql/remote_storage_pb2.py``, written by
hand so that the port needs no ``protobuf`` package. It covers exactly the
messages of ``remote_storage.proto`` (beside this file, their
documentation): ``Sample``, ``LabelPair``, ``TimeSeries``,
``WriteRequest``, ``ReadRequest``, ``ReadResponse``, ``Query``,
``LabelMatcher`` (and its ``Type`` enum), ``ReadHints`` and
``QueryResult``, and the slice of the generated classes' surface that
remote read/write uses: keyword construction, ``.add(...)`` and
``.extend`` on repeated fields, ``ParseFromString`` / ``MergeFromString``,
``SerializeToString``, ``HasField`` / ``SetInParent`` on ``Query.hints``,
and the matcher kinds ``LabelMatcher.EQ/NEQ/RE/NRE``.

Serialisation is byte for byte protobuf's own (its ``upb`` serializer):

- fields in field-number order;
- proto3 implicit presence: a zero number, an empty string and enum 0 are
  omitted; ``-0.0`` is not zero and is emitted, and a NaN keeps its payload
  bits (Prometheus's stale marker ``0x7ff0000000000002`` included);
- ``int64`` and enum values are two's-complement varints, ten bytes when
  negative;
- a singular submessage (``Query.hints``) is emitted when it is present,
  even empty, and it becomes present when one of its fields is assigned.

Parsing takes fields in any order, lets the last occurrence of a scalar
win and merges a repeated submessage as protobuf does, skips unknown fields
(and fields whose wire type does not match their number) by wire type,
keeps enum values the enum does not name (proto3 enums are open), and
raises :class:`DecodeError` on a truncated or malformed body. Unlike the
generated classes, skipped unknown fields are not kept for a later
serialisation.

``TimeSeries.samples`` is columnar: a parsed body keeps its samples as two
numpy arrays, decoded in one vectorised pass, and ``samples.arrays()`` /
``samples.extend_arrays(ts, values)`` read and write them without a Python
object a sample; iterating or indexing gives ``Sample`` objects as the
generated classes do. Both forms serialise to the same bytes.
"""

from __future__ import annotations

import struct
import threading

import numpy as np

__all__ = ["DecodeError", "Sample", "LabelPair", "TimeSeries",
           "WriteRequest", "ReadRequest", "ReadResponse", "Query",
           "LabelMatcher", "ReadHints", "QueryResult"]

_VARINT, _I64, _LEN, _SGROUP, _EGROUP, _I32 = 0, 1, 2, 3, 4, 5
_U64 = (1 << 64) - 1
_ONE_BYTE = [bytes((i,)) for i in range(128)]
_pack_d = struct.Struct("<d").pack
_unpack_d = struct.Struct("<d").unpack_from


class DecodeError(ValueError):
    """A truncated or malformed remote-storage body."""


# -- varints -------------------------------------------------------------------

def _uvarint(n: int) -> bytes:
    if n < 128:
        return _ONE_BYTE[n]
    out = bytearray()
    while n >= 128:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _int64(v) -> int:
    v = int(v)
    if not -(1 << 63) <= v < (1 << 63):
        raise ValueError(f"value {v} is out of range for int64")
    return v & _U64


def _read_varint(buf, pos: int, end: int) -> tuple[int, int]:
    """(value mod 2^64, next position); at most ten bytes, bits past the
    64th dropped as protobuf drops them."""
    result = shift = 0
    while True:
        if pos >= end:
            raise DecodeError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result & _U64, pos
        shift += 7
        if shift >= 70:
            raise DecodeError("varint longer than ten bytes")


def _signed64(u: int) -> int:
    return u - (1 << 64) if u >= (1 << 63) else u


def _signed32(u: int) -> int:
    u &= 0xFFFFFFFF
    return u - (1 << 32) if u >= (1 << 31) else u


def _skip(buf, wt: int, pos: int, end: int, field: int) -> int:
    """Position past one unknown field's payload of wire type ``wt``."""
    if wt == _VARINT:
        return _read_varint(buf, pos, end)[1]
    if wt == _I64:
        pos += 8
    elif wt == _I32:
        pos += 4
    elif wt == _LEN:
        n, pos = _read_varint(buf, pos, end)
        pos += n
    elif wt == _SGROUP:
        while True:
            if pos >= end:
                raise DecodeError("truncated group")
            tag, pos = _read_varint(buf, pos, end)
            num, inner = tag >> 3, tag & 7
            if num == 0:
                raise DecodeError("field number 0")
            if inner == _EGROUP:
                if num != field:
                    raise DecodeError("mismatched end-group tag")
                return pos
            pos = _skip(buf, inner, pos, end, num)
    else:
        raise DecodeError(f"invalid wire type {wt}")
    if pos > end:
        raise DecodeError("truncated field")
    return pos


# -- messages ------------------------------------------------------------------

class _Message:
    """Base of the generated-style message classes: ``_SPEC`` is the
    message's fields in field-number order as (number, name, kind, class);
    kind is ``double``, ``int64``, ``string``, ``enum``, ``message`` (a
    singular submessage) or ``repeated`` (of submessages)."""

    _SPEC: tuple = ()
    __slots__ = ()

    def __init__(self, **kw):
        for num, name, kind, cls in self._SPEC:
            if kind == "repeated":
                object.__setattr__(self, name, _Repeated(cls))
            elif kind == "message":
                object.__setattr__(self, "_" + name, None)
            else:
                object.__setattr__(self, name, _DEFAULTS[kind])
        for k, v in kw.items():
            self._init_field(k, v)

    def _init_field(self, name: str, v) -> None:
        spec = self._by_name().get(name)
        if spec is None:
            raise ValueError(f"{type(self).__name__} has no field {name!r}")
        _num, _n, kind, cls = spec
        if kind == "repeated":
            rep = getattr(self, name)
            for item in v:
                rep.append(item if isinstance(item, cls) else cls(**item))
        elif kind == "message":
            sub = v if isinstance(v, cls) else cls(**v)
            sub = cls.FromString(sub.SerializeToString())
            sub.SetInParent()
            object.__setattr__(self, "_" + name, sub)
        else:
            setattr(self, name, _COERCE[kind](v))

    @classmethod
    def _by_name(cls) -> dict:
        d = cls.__dict__.get("_BY_NAME")
        if d is None:
            d = {s[1]: s for s in cls._SPEC}
            cls._BY_NAME = d
        return d

    @classmethod
    def _by_num(cls) -> dict:
        d = cls.__dict__.get("_BY_NUM")
        if d is None:
            d = {s[0]: s for s in cls._SPEC}
            cls._BY_NUM = d
        return d

    # -- serialisation --------------------------------------------------------

    def _body(self) -> bytes:
        out = []
        for num, name, kind, _cls in self._SPEC:
            if kind == "repeated":
                tag = _uvarint((num << 3) | _LEN)
                for m in getattr(self, name):
                    b = m._body()
                    out += (tag, _uvarint(len(b)), b)
            elif kind == "message":
                m = getattr(self, "_" + name)
                if m is not None and m._present:
                    b = m._body()
                    out += (_uvarint((num << 3) | _LEN), _uvarint(len(b)), b)
            else:
                v = getattr(self, name)
                if kind == "double":
                    b = _pack_d(v)
                    if b != b"\0\0\0\0\0\0\0\0":
                        out += (_uvarint((num << 3) | _I64), b)
                elif kind == "string":
                    if v:
                        b = v.encode("utf-8")
                        out += (_uvarint((num << 3) | _LEN),
                                _uvarint(len(b)), b)
                elif v:                       # int64, enum
                    out += (_uvarint(num << 3), _uvarint(_int64(v)))
        return b"".join(out)

    def SerializeToString(self) -> bytes:
        return self._body()

    # -- parsing --------------------------------------------------------------

    def _merge(self, buf, pos: int, end: int) -> None:
        by_num = self._by_num()
        while pos < end:
            tag, pos = _read_varint(buf, pos, end)
            num, wt = tag >> 3, tag & 7
            if num == 0:
                raise DecodeError("field number 0")
            if wt == _EGROUP:
                raise DecodeError("unexpected end-group tag")
            spec = by_num.get(num)
            kind = spec[2] if spec is not None else None
            if kind is None or wt != _WIRE[kind]:
                pos = _skip(buf, wt, pos, end, num)
                continue
            name, cls = spec[1], spec[3]
            if kind in ("repeated", "message", "string"):
                n, pos = _read_varint(buf, pos, end)
                stop = pos + n
                if stop > end:
                    raise DecodeError("truncated length-delimited field")
                if kind == "string":
                    try:
                        v = str(buf[pos:stop], "utf-8")
                    except UnicodeDecodeError as e:
                        raise DecodeError(f"invalid UTF-8 in {name}: {e}") \
                            from None
                    object.__setattr__(self, name, v)
                elif kind == "repeated":
                    sub = cls()
                    sub._merge(buf, pos, stop)
                    getattr(self, name).append(sub)
                else:
                    sub = getattr(self, name)
                    sub._merge(buf, pos, stop)
                    sub.SetInParent()
                pos = stop
            elif kind == "double":
                if pos + 8 > end:
                    raise DecodeError("truncated fixed64")
                object.__setattr__(self, name, _unpack_d(buf, pos)[0])
                pos += 8
            else:
                u, pos = _read_varint(buf, pos, end)
                object.__setattr__(
                    self, name,
                    _signed64(u) if kind == "int64" else _signed32(u))
        if pos != end:
            raise DecodeError("truncated message")

    def _clear(self) -> None:
        type(self).__init__(self)

    def MergeFromString(self, data) -> int:
        buf = memoryview(data).cast("B") if not isinstance(data, bytes) \
            else data
        if getattr(_parse_state, "pending", None) is not None:
            self._merge(buf, 0, len(buf))
            return len(buf)
        # the outermost parse: every TimeSeries' sample records are decoded
        # together, in one vectorised pass, when the walk is done
        _parse_state.pending = pending = []
        try:
            self._merge(buf, 0, len(buf))
        finally:
            _parse_state.pending = None
        _decode_pending(buf, pending)
        return len(buf)

    def ParseFromString(self, data) -> int:
        self._clear()
        return self.MergeFromString(data)

    @classmethod
    def FromString(cls, data):
        m = cls()
        m.MergeFromString(data)
        return m

    # -- presence of singular submessages ------------------------------------

    def HasField(self, name: str) -> bool:
        spec = self._by_name().get(name)
        if spec is None or spec[2] != "message":
            raise ValueError(f"{name!r} is not a singular message field of "
                             f"{type(self).__name__}")
        m = getattr(self, "_" + name)
        return m is not None and m._present

    def __eq__(self, other) -> bool:
        return (type(other) is type(self)
                and other.SerializeToString() == self.SerializeToString())

    __hash__ = None

    def __repr__(self) -> str:
        parts = []
        for _num, name, kind, _cls in self._SPEC:
            v = getattr(self, "_" + name if kind == "message" else name)
            if kind == "repeated":
                v = list(v)
            parts.append(f"{name}={v!r}")
        return f"{type(self).__name__}({', '.join(parts)})"


class _Submessage(_Message):
    """A message that can be a singular field of another: it is present in
    its parent once any of its fields is assigned (or ``SetInParent``)."""

    __slots__ = ()

    def __setattr__(self, name, value):
        spec = self._by_name().get(name)
        if spec is None:
            raise AttributeError(
                f"{type(self).__name__} has no field {name!r}")
        object.__setattr__(self, name, _COERCE[spec[2]](value))
        object.__setattr__(self, "_present", True)

    def SetInParent(self) -> None:
        object.__setattr__(self, "_present", True)

    def _clear(self) -> None:
        present = getattr(self, "_present", False)
        _Message.__init__(self)
        object.__setattr__(self, "_present", present)


def _coerce_double(v) -> float:
    if isinstance(v, (str, bytes)):
        raise TypeError(f"{v!r} has type {type(v).__name__}, but expected a "
                        "number")
    return float(v)


def _coerce_int(v) -> int:
    if isinstance(v, (float, str, bytes)) or isinstance(v, np.floating):
        raise TypeError(f"{v!r} has type {type(v).__name__}, but expected "
                        "an int")
    v = int(v)
    _int64(v)
    return v


def _coerce_str(v) -> str:
    if isinstance(v, bytes):
        return v.decode("utf-8")
    if not isinstance(v, str):
        raise TypeError(f"{v!r} has type {type(v).__name__}, but expected "
                        "str")
    return v


_DEFAULTS = {"double": 0.0, "int64": 0, "enum": 0, "string": ""}
_COERCE = {"double": _coerce_double, "int64": _coerce_int,
           "enum": _coerce_int, "string": _coerce_str}
_WIRE = {"double": _I64, "int64": _VARINT, "enum": _VARINT, "string": _LEN,
         "message": _LEN, "repeated": _LEN}


class _Repeated(list):
    """A repeated submessage field: a list with ``add(**fields)``."""

    __slots__ = ("_cls",)

    def __init__(self, cls):
        super().__init__()
        self._cls = cls

    def add(self, **kw):
        m = self._cls(**kw)
        self.append(m)
        return m


# -- the messages --------------------------------------------------------------

class Sample(_Message):
    __slots__ = ("value", "timestamp_ms")


Sample._SPEC = ((1, "value", "double", None),
                (2, "timestamp_ms", "int64", None))


class LabelPair(_Message):
    __slots__ = ("name", "value")


LabelPair._SPEC = ((1, "name", "string", None), (2, "value", "string", None))


class _Samples:
    """``TimeSeries.samples``: a repeated ``Sample`` held either as
    ``Sample`` objects (``add``, ``extend``, iteration, indexing) or as two
    columns (a parsed body, ``extend_arrays``); each form turns into the
    other on demand."""

    __slots__ = ("_objs", "_ts", "_vals")

    def __init__(self):
        self._objs: list | None = []
        self._ts = self._vals = None

    def _as_objects(self) -> list:
        if self._objs is None:
            self._objs = [Sample(value=v, timestamp_ms=t) for t, v in
                          zip(self._ts.tolist(), self._vals.tolist())]
            self._ts = self._vals = None
        return self._objs

    def arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """(timestamps int64, values float64), in order."""
        if self._objs is None:
            return self._ts, self._vals
        objs = self._objs
        ts = np.fromiter((s.timestamp_ms for s in objs), np.int64,
                         count=len(objs))
        vals = np.fromiter((s.value for s in objs), np.float64,
                           count=len(objs))
        return ts, vals

    def extend_arrays(self, ts, vals) -> None:
        """Append samples from columns (the bulk path: no object a
        sample)."""
        ts = np.ascontiguousarray(ts, np.int64)
        vals = np.ascontiguousarray(vals, np.float64)
        if ts.shape != vals.shape or ts.ndim != 1:
            raise ValueError(f"timestamps {ts.shape} and values {vals.shape} "
                             "must be two 1-D arrays of one length")
        if self._objs is not None and not self._objs:
            self._objs = None
            self._ts, self._vals = ts, vals
            return
        old_ts, old_vals = self.arrays()
        self._objs = None
        self._ts = np.concatenate([old_ts, ts])
        self._vals = np.concatenate([old_vals, vals])

    def add(self, value: float = 0.0, timestamp_ms: int = 0) -> Sample:
        s = Sample(value=value, timestamp_ms=timestamp_ms)
        self._as_objects().append(s)
        return s

    def append(self, s: Sample) -> None:
        self._as_objects().append(s)

    def __len__(self) -> int:
        return len(self._objs) if self._objs is not None else len(self._ts)

    def __iter__(self):
        return iter(self._as_objects())

    def __getitem__(self, i):
        return self._as_objects()[i]



def _encode_samples(ts: np.ndarray, vals: np.ndarray):
    """Samples as TimeSeries field-2 records (``0x12 len Sample``), all in
    one vectorised pass: a Sample is at most 20 bytes, so each record is
    built in a row of 22 (tag, length, the value field in columns 2-10,
    the timestamp field in columns 11-21) and the valid bytes of the rows
    are gathered in order. Returns (the bytes, each record's length)."""
    n = len(ts)
    u = ts.view(np.uint64)
    has_v = vals.view(np.uint64) != 0
    has_t = u != 0
    tlen = np.ones(n, np.int64)               # the varint's bytes, 1..10
    for k in range(1, 10):
        tlen += (u >> np.uint64(7 * k)) != 0
    slen = has_v * 9 + has_t * (1 + tlen)
    rows = np.zeros((n, 22), np.uint8)
    valid = np.zeros((n, 22), bool)
    rows[:, 0] = 0x12
    rows[:, 1] = slen
    valid[:, :2] = True
    rows[:, 2] = 0x09
    rows[:, 3:11] = vals.view(np.uint8).reshape(n, 8)
    valid[:, 2:11] = has_v[:, None]
    rows[:, 11] = 0x10
    k = np.arange(10)
    groups = ((u[:, None] >> (np.uint64(7) * k.astype(np.uint64)))
              & np.uint64(0x7F)).astype(np.uint8)
    more = k[None, :] < (tlen[:, None] - 1)
    rows[:, 12:22] = groups | (more * np.uint8(0x80)).astype(np.uint8)
    valid[:, 11] = has_t
    valid[:, 12:22] = has_t[:, None] & (k[None, :] < tlen[:, None])
    return rows[valid].tobytes(), 2 + slen


def _series_bodies(series: list) -> list[bytes]:
    """Each TimeSeries' body, the samples of all of them encoded in one
    pass."""
    cols = [s.samples.arrays() if len(s.samples) else None for s in series]
    live = [c for c in cols if c is not None]
    if live:
        ts = np.concatenate([c[0] for c in live])
        vals = np.concatenate([c[1] for c in live])
        enc, rec = _encode_samples(ts, vals)
        ends = np.cumsum(rec).tolist()
    out = []
    at = rec_at = 0
    for s, c in zip(series, cols):
        labels = b"".join([b"\x0a" + _uvarint(len(b)) + b
                           for b in (lp._body() for lp in s.labels)])
        if c is None:
            out.append(labels)
            continue
        rec_at += len(c[0])
        stop = ends[rec_at - 1]
        out.append(labels + enc[at:stop])
        at = stop
    return out


def _series_field(series: list, tag: bytes) -> bytes:
    return b"".join([tag + _uvarint(len(b)) + b
                     for b in _series_bodies(series)])


class TimeSeries(_Message):
    __slots__ = ("labels", "samples")

    def __init__(self, labels=(), samples=()):
        self.labels = _Repeated(LabelPair)
        self.samples = _Samples()
        for lp in labels:
            self.labels.append(lp if isinstance(lp, LabelPair)
                               else LabelPair(**lp))
        for s in samples:
            self.samples.append(s if isinstance(s, Sample) else Sample(**s))

    def _body(self) -> bytes:
        return _series_bodies([self])[0]

    def _clear(self) -> None:
        self.labels = _Repeated(LabelPair)
        self.samples = _Samples()

    def _merge(self, buf, pos: int, end: int) -> None:
        # the generic walk, but a Sample record is only located here: every
        # record of the parse is decoded in one pass (_decode_pending)
        starts: list = []
        stops: list = []
        while pos < end:
            tag, pos = _read_varint(buf, pos, end)
            num, wt = tag >> 3, tag & 7
            if num == 0:
                raise DecodeError("field number 0")
            if wt == _EGROUP:
                raise DecodeError("unexpected end-group tag")
            if num in (1, 2) and wt == _LEN:
                n, pos = _read_varint(buf, pos, end)
                stop = pos + n
                if stop > end:
                    raise DecodeError("truncated length-delimited field")
                if num == 1:
                    lp = LabelPair()
                    lp._merge(buf, pos, stop)
                    self.labels.append(lp)
                else:
                    starts.append(pos)
                    stops.append(stop)
                pos = stop
            else:
                pos = _skip(buf, wt, pos, end, num)
        if pos != end:
            raise DecodeError("truncated message")
        if starts:
            span = (self, starts, stops)
            pending = getattr(_parse_state, "pending", None)
            if pending is not None:
                pending.append(span)
            else:
                _decode_pending(buf, [span])


_parse_state = threading.local()


def _decode_pending(buf, pending: list) -> None:
    """Decode the sample records every TimeSeries of one parse collected,
    all in one pass, and hand each series its columns."""
    if not pending:
        return
    ts, vals = _decode_samples(
        buf, np.array([x for p in pending for x in p[1]], np.int64),
        np.array([x for p in pending for x in p[2]], np.int64))
    at = 0
    for series, st, _sp in pending:
        c = len(st)
        series.samples.extend_arrays(ts[at:at + c], vals[at:at + c])
        at += c


def _decode_samples(buf, s: np.ndarray, e: np.ndarray):
    """The Sample bodies ``buf[s[i]:e[i]]`` as (timestamps, values), in one
    vectorised pass over the canonical layout (``09 <8 bytes>`` then ``10
    <varint>``, either omitted); a body of any other layout (fields
    reordered or repeated, unknown fields) is parsed on its own."""
    data = np.frombuffer(buf, np.uint8)
    n = len(s)
    last = len(data) - 1

    def at(idx):
        # gathers past the body's end read its last byte; such rows fail
        # the layout checks and take the generic parse
        return data[np.minimum(idx, last)]

    ln = e - s
    has_v = (ln >= 9) & (at(s) == 0x09)
    vidx = s[:, None] + 1 + np.arange(8)
    # the value's bit pattern, kept (a NaN payload included)
    vb = np.ascontiguousarray(at(vidx)).view("<u8").reshape(n)
    vals = np.where(has_v, vb, np.uint64(0)).view(np.float64)
    q = s + 9 * has_v
    rem = e - q
    has_t = rem > 0
    tag_ok = ~has_t | (at(q) == 0x10)
    tlen = rem - 1
    k = np.arange(10)
    tb = at((q + 1)[:, None] + k).astype(np.uint64)
    in_v = k[None, :] < tlen[:, None]
    cont = (tb & np.uint64(0x80)) != 0
    cont_ok = np.all(np.where(in_v, cont == (k[None, :] < tlen[:, None] - 1),
                              True), axis=1)
    shifts = (np.uint64(7) * k.astype(np.uint64))[None, :]
    u = np.bitwise_or.reduce(
        np.where(in_v, (tb & np.uint64(0x7F)) << shifts, np.uint64(0)),
        axis=1)
    ts = np.where(has_t, u, np.uint64(0)).view(np.int64)
    ok = tag_ok & (~has_t | ((tlen >= 1) & (tlen <= 10) & cont_ok))
    bad = np.nonzero(~ok)[0]
    if len(bad):
        ts = ts.copy()
        vals = vals.copy()
        for i in bad.tolist():
            smp = Sample()
            smp._merge(buf, int(s[i]), int(e[i]))
            ts[i] = smp.timestamp_ms
            vals[i] = smp.value
    return ts, vals


TimeSeries._SPEC = ((1, "labels", "repeated", LabelPair),
                    (2, "samples", "repeated", Sample))


class WriteRequest(_Message):
    __slots__ = ("timeseries",)

    def _body(self) -> bytes:
        return _series_field(self.timeseries, b"\x0a")


WriteRequest._SPEC = ((1, "timeseries", "repeated", TimeSeries),)


class LabelMatcher(_Message):
    __slots__ = ("type", "name", "value")

    # the Type enum's values (an open enum: a parsed value it does not name
    # is kept as its integer)
    EQ, NEQ, RE, NRE = 0, 1, 2, 3


LabelMatcher._SPEC = ((1, "type", "enum", None), (2, "name", "string", None),
                      (3, "value", "string", None))


class ReadHints(_Submessage):
    __slots__ = ("step_ms", "func", "start_ms", "end_ms", "_present")

    def __init__(self, **kw):
        object.__setattr__(self, "_present", False)
        _Message.__init__(self, **kw)


ReadHints._SPEC = ((1, "step_ms", "int64", None), (2, "func", "string", None),
                   (3, "start_ms", "int64", None), (4, "end_ms", "int64", None))


class Query(_Message):
    __slots__ = ("start_timestamp_ms", "end_timestamp_ms", "matchers",
                 "_hints")

    @property
    def hints(self) -> ReadHints:
        """The hints submessage; reading it does not make it present,
        assigning one of its fields does."""
        h = self._hints
        if h is None:
            h = ReadHints()
            object.__setattr__(self, "_hints", h)
        return h


Query._SPEC = ((1, "start_timestamp_ms", "int64", None),
               (2, "end_timestamp_ms", "int64", None),
               (3, "matchers", "repeated", LabelMatcher),
               (4, "hints", "message", ReadHints))


class ReadRequest(_Message):
    __slots__ = ("queries",)


ReadRequest._SPEC = ((1, "queries", "repeated", Query),)


class QueryResult(_Message):
    __slots__ = ("timeseries",)

    def _body(self) -> bytes:
        return _series_field(self.timeseries, b"\x0a")


QueryResult._SPEC = ((1, "timeseries", "repeated", TimeSeries),)


class ReadResponse(_Message):
    __slots__ = ("results",)


ReadResponse._SPEC = ((1, "results", "repeated", QueryResult),)
