"""Cross-node query dispatch: the ExecPlan wire codec and RemoteLeafExec.

Host copy of ``filodb_tpu/query/wire.py`` (ref: query/.../exec/
PlanDispatcher.scala ships an ExecPlan subtree to the node owning its
shard; ExecPlan.scala ``NonLeafExecPlan.dispatchRemotePlan`` reduces the
partials on the caller; the co-location pick is
coordinator/.../queryengine2/QueryEngine.scala:506). Every byte format is
the reference's, so a port node and a JAX node answer each other.

Plans are small (a leaf selector and its pushed-down transformer chain), so
they travel as a whitelisted JSON envelope, never pickle. Results are big,
so they travel as tagged binary: raw little-endian arrays behind a small
JSON header. The map phase (PeriodicSamplesMapper + AggregateMapReduce, K1
on a card-resident shard) runs on the node that owns the data; only the
per-group partial state (AggPartial / TopKPartial / SketchPartial /
CountValuesPartial) or a matrix crosses the wire, in the formats the
in-process reduce already merges (exec.py:_merge_heterogeneous). A
partial's device tensors reach the host in one copy at serialization, on
the serving thread after the leaf released its shard lock.
"""

from __future__ import annotations

import json
import struct
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field, fields, replace

import numpy as np

from ..core import filters as F
from ..ops import aggregators
from ..utils.metrics import (FILODB_PEER_BREAKER_OPEN,
                             FILODB_PEER_EXEC_LATENCY_MS,
                             FILODB_PEER_EXEC_REQUESTS, registry)
from ..utils.tracing import SPAN_QUERY_DISPATCH, span, tracer
from .exec import (AggPartial, AggregateMapReduce, AggregatePresenter,
                   CountValuesPartial, DistConcatExec, ExecPlan,
                   InstantVectorFunctionMapper, MatrixView,
                   MiscellaneousFunctionMapper, PeriodicSamplesMapper,
                   ReduceAggregateExec, ScalarOperationMapper,
                   SelectChunkInfosExec, SelectRawPartitionsExec,
                   SketchPartial, SortFunctionMapper, TopKPartial, _as_matrix)
from .rangevector import (QueryError, QueryStats, RangeVectorKey,
                          deserialize_matrix, serialize_matrix, to_numpy)

# -- plan envelope (JSON, whitelisted types) ---------------------------------

_LEAF_TYPES = {c.__name__: c for c in
               (SelectRawPartitionsExec, SelectChunkInfosExec)}
# non-leaf nodes that may ship when ALL their children live on the target
# peer (co-located reduce — ref: dispatchRemotePlan places the reduce on a
# data node, queryengine2/QueryEngine.scala:506). Children serialize
# recursively; depth is bounded (a hostile deeply-nested body is rejected).
_NONLEAF_TYPES = {c.__name__: c for c in
                  (ReduceAggregateExec, DistConcatExec)}
_MAX_PLAN_DEPTH = 4
_TRANSFORMER_TYPES = {c.__name__: c for c in
                      (PeriodicSamplesMapper, InstantVectorFunctionMapper,
                       ScalarOperationMapper, AggregateMapReduce,
                       AggregatePresenter, SortFunctionMapper,
                       MiscellaneousFunctionMapper)}
_FILTER_TYPES = {c.__name__: c for c in
                 (F.Equals, F.NotEquals, F.In, F.EqualsRegex, F.NotEqualsRegex)}

_SCALARS = (bool, int, float, str, type(None))

# trace-context header on every cross-node /exec POST: one constant shared
# by the sender (_dispatch_post) and the receiver (http/api._exec_plan); a
# one-sided change would silently sever cross-node traces
TRACE_HEADER = "X-Filo-Trace"


class NotWireable(Exception):
    """A plan/transformer holds state that cannot ship (e.g. a
    ScalarOperationMapper whose operand is a materialized subplan)."""


class RemotePeerError(QueryError):
    """A peer dispatch failed (unreachable / transport error). The engine
    re-plans and retries ONCE — and only if the failed shards' routes actually
    changed (ref: the reference retries via Akka ask-timeouts + shard-map
    subscription updates). ``shards`` carries every shard the failed dispatch
    covered (a batched per-peer POST spans many); ``shard`` stays the first
    for message/compat purposes."""

    def __init__(self, msg: str, endpoint: str = "", shard: int = -1,
                 shards: tuple = ()):
        super().__init__(msg)
        self.endpoint = endpoint
        self.shards = tuple(shards) if shards else ((shard,) if shard >= 0 else ())
        self.shard = self.shards[0] if self.shards else shard


class PeerCircuitOpen(RemotePeerError):
    """The per-peer circuit breaker is open: the peer browned out (accepted
    connections but stalled N consecutive dispatches to timeout) and further
    dispatches shed FAST instead of pinning a worker for the full timeout.
    The HTTP layer maps this to 503 (unavailable, retryable) — unlike plain
    query errors which are 422."""


# -- per-peer dispatch instrumentation + circuit breaker ---------------------
#
# Every cross-node POST funnels through _dispatch_post below, so round-trips
# are countable (tests assert a K-shard peer costs ONE request) and a
# browned-out peer (accepts, then stalls to timeout) trips a per-endpoint
# breaker instead of holding 16 workers x 30s each (ref: the failure-
# detection posture of queryengine2/FailureProvider.scala:11-47).

class PeerBreaker:
    """Consecutive-transport-failure circuit breaker for ONE endpoint.
    Closed -> open after ``threshold`` consecutive failures; while open,
    dispatches shed fast. After ``cooldown_s`` the next dispatch probes
    (half-open): success closes, failure re-arms the cooldown."""

    def __init__(self, threshold: int, cooldown_s: float):
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self._fails = 0
        self._opened_at: float | None = None
        self._lock = threading.Lock()

    @property
    def is_open(self) -> bool:
        with self._lock:
            return self._opened_at is not None

    def admit(self) -> bool:
        with self._lock:
            if self._opened_at is None:
                return True
            if time.monotonic() - self._opened_at >= self.cooldown_s:
                # half-open probe: re-arm the window so a failing probe keeps
                # shedding for another cooldown instead of letting every
                # queued caller pile onto the stalled peer at once
                self._opened_at = time.monotonic()
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._fails = 0
            self._opened_at = None

    def record_failure(self) -> None:
        with self._lock:
            self._fails += 1
            if self._fails >= self.threshold:
                self._opened_at = time.monotonic()


class PeerBreakerRegistry:
    """endpoint -> PeerBreaker, plus per-endpoint request counters the tests
    read to assert round-trip counts."""

    def __init__(self, threshold: int = 3, cooldown_s: float = 5.0):
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self._breakers: dict[str, PeerBreaker] = {}
        self.request_counts: dict[str, int] = {}
        self._lock = threading.Lock()

    def for_endpoint(self, ep: str) -> PeerBreaker:
        with self._lock:
            b = self._breakers.get(ep)
            if b is None:
                b = self._breakers[ep] = PeerBreaker(self.threshold,
                                                     self.cooldown_s)
            return b

    def note_request(self, ep: str) -> None:
        with self._lock:
            self.request_counts[ep] = self.request_counts.get(ep, 0) + 1

    def total_requests(self) -> int:
        with self._lock:
            return sum(self.request_counts.values())

    def configure(self, threshold: int | None = None,
                  cooldown_s: float | None = None) -> None:
        with self._lock:
            if threshold is not None:
                self.threshold = threshold
            if cooldown_s is not None:
                self.cooldown_s = cooldown_s
            self._breakers.clear()


breakers = PeerBreakerRegistry()


def _dispatch_post(endpoint: str, dataset: str, body: bytes, timeout_s: float,
                   shards: tuple) -> bytes:
    """The ONE cross-node POST path: breaker admission, request counting,
    per-peer latency gauge, transport-vs-peer error classification, and
    trace-context injection (the dispatch span parents the peer's serve
    span — one trace id across every participating node)."""
    with span(SPAN_QUERY_DISPATCH, endpoint=endpoint, shards=len(shards)):
        return _dispatch_post_traced(endpoint, dataset, body, timeout_s,
                                     shards)


def _dispatch_post_traced(endpoint: str, dataset: str, body: bytes,
                          timeout_s: float, shards: tuple) -> bytes:
    br = breakers.for_endpoint(endpoint)
    gauge_open = registry.gauge(FILODB_PEER_BREAKER_OPEN,
                                {"endpoint": endpoint})
    if not br.admit():
        gauge_open.update(1.0)
        raise PeerCircuitOpen(
            f"peer {endpoint} circuit open (browned out); shedding fast for "
            f"shards {list(shards)}", endpoint=endpoint, shards=shards)
    breakers.note_request(endpoint)
    registry.counter(FILODB_PEER_EXEC_REQUESTS,
                     {"endpoint": endpoint}).increment()
    url = f"http://{endpoint}/exec/{dataset}"
    headers = {"Content-Type": "application/octet-stream"}
    tctx = tracer.current_context()
    if tctx is not None:
        headers[TRACE_HEADER] = json.dumps(tctx, separators=(",", ":"))
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers=headers)
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as r:
            payload = r.read()
    except urllib.error.HTTPError as e:
        # the peer is ALIVE and answered (a query fault, not brownout):
        # counts as breaker success
        br.record_success()
        gauge_open.update(0.0)
        try:
            msg = json.loads(e.read()).get("error", str(e))
        except Exception:  # noqa: BLE001
            msg = str(e)
        raise QueryError(
            f"remote exec on {endpoint} for shards {list(shards)} "
            f"failed: {msg}") from None
    except (urllib.error.URLError, OSError, TimeoutError) as e:
        # only TIMEOUTS feed the breaker: a stalled (browned-out) peer is
        # what pins workers for the full timeout. A fast refusal means the
        # peer is DOWN — replan-once reroutes that without a breaker, and it
        # says nothing about brownout either way (no state change)
        reason = getattr(e, "reason", e)
        if isinstance(reason, TimeoutError) or "timed out" in str(e).lower():
            br.record_failure()
        gauge_open.update(1.0 if br.is_open else 0.0)
        raise RemotePeerError(
            f"peer {endpoint} unreachable for shards {list(shards)}: {e}; "
            "the query is retryable once shards reassign",
            endpoint=endpoint, shards=shards) from None
    br.record_success()
    gauge_open.update(0.0)
    registry.gauge(FILODB_PEER_EXEC_LATENCY_MS, {"endpoint": endpoint}) \
        .update((time.perf_counter() - t0) * 1000.0)
    return payload


def _plan_shards(plan) -> tuple:
    """Sorted shard ids a (possibly non-leaf) wire plan covers."""
    out: set[int] = set()
    stack = [plan]
    while stack:
        p = stack.pop()
        s = getattr(p, "shard", None)
        if s is not None:
            out.add(int(s))
        stack.extend(getattr(p, "children", ()) or ())
    return tuple(sorted(out))


def _enc_val(v):
    if isinstance(v, _SCALARS):
        return v
    if isinstance(v, (tuple, list)):
        if all(isinstance(x, _SCALARS) for x in v):
            return list(v)
    raise NotWireable(f"field value {v!r} not wire-encodable")


def _enc_filters(fs) -> list:
    out = []
    for f in fs:
        name = type(f).__name__
        if name not in _FILTER_TYPES:
            raise NotWireable(f"filter {name} not wire-encodable")
        out.append([name] + [_enc_val(getattr(f, fl.name))
                             for fl in fields(f)])
    return out


def _dec_filters(rows) -> tuple:
    out = []
    for row in rows:
        cls = _FILTER_TYPES[row[0]]
        args = [tuple(a) if isinstance(a, list) else a for a in row[1:]]
        out.append(cls(*args))
    return tuple(out)


def _enc_transformer(t) -> dict:
    name = type(t).__name__
    if name not in _TRANSFORMER_TYPES:
        raise NotWireable(f"transformer {name} not wire-encodable")
    d = {"t": name}
    for fl in fields(t):
        d[fl.name] = _enc_val(getattr(t, fl.name))
    return d


def _dec_transformer(d: dict):
    cls = _TRANSFORMER_TYPES[d["t"]]
    kw = {}
    for fl in fields(cls):
        if fl.name not in d:
            continue
        v = d[fl.name]
        kw[fl.name] = tuple(v) if isinstance(v, list) else v
    return cls(**kw)


def is_wire_transformer(t) -> bool:
    try:
        _enc_transformer(t)
        return True
    except NotWireable:
        return False


def _enc_plan(plan: ExecPlan, depth: int = 0) -> dict:
    if depth > _MAX_PLAN_DEPTH:
        # mirror of the decoder's bound: the planner's co-location check
        # must refuse (and fall back to batched dispatch) anything the peer
        # would reject as over-nested
        raise NotWireable(f"plan nesting exceeds {_MAX_PLAN_DEPTH}")
    name = type(plan).__name__
    if name in _NONLEAF_TYPES:
        d = {"t": name,
             "transformers": [_enc_transformer(t) for t in plan.transformers],
             "children": [_enc_plan(c, depth + 1) for c in plan.children]}
        for fl in fields(plan):
            if fl.name in ("transformers", "children"):
                continue
            d[fl.name] = _enc_val(getattr(plan, fl.name))
        return d
    if name not in _LEAF_TYPES:
        raise NotWireable(f"plan {name} not wire-encodable")
    d = {"t": name,
         "transformers": [_enc_transformer(t) for t in plan.transformers],
         "filters": _enc_filters(plan.filters)}
    for fl in fields(plan):
        if fl.name in ("transformers", "filters"):
            continue
        d[fl.name] = _enc_val(getattr(plan, fl.name))
    return d


def serialize_plan(plan: ExecPlan) -> bytes:
    return json.dumps(_enc_plan(plan), separators=(",", ":")).encode()


def _dec_plan(d: dict, depth: int = 0):
    if depth > _MAX_PLAN_DEPTH:
        raise ValueError(f"plan nesting exceeds {_MAX_PLAN_DEPTH}")
    name = d.pop("t")
    if name in _NONLEAF_TYPES:
        cls = _NONLEAF_TYPES[name]
        kw = {"transformers": [_dec_transformer(t)
                               for t in d.pop("transformers", [])],
              "children": [_dec_plan(c, depth + 1)
                           for c in d.pop("children", [])]}
        for fl in fields(cls):
            if fl.name in d:
                v = d[fl.name]
                kw[fl.name] = tuple(v) if isinstance(v, list) else v
        return cls(**kw)
    cls = _LEAF_TYPES[name]
    kw = {"transformers": [_dec_transformer(t)
                           for t in d.pop("transformers", [])],
          "filters": _dec_filters(d.pop("filters", []))}
    for fl in fields(cls):
        if fl.name in d:
            v = d[fl.name]
            kw[fl.name] = tuple(v) if isinstance(v, list) else v
    return cls(**kw)


def deserialize_plan(buf: bytes) -> ExecPlan:
    try:
        return _dec_plan(json.loads(buf))
    except (KeyError, TypeError, ValueError, AttributeError) as e:
        raise QueryError(f"malformed remote exec plan: {e}") from None


# -- result codec (tagged binary) --------------------------------------------
#
# layout: 1-byte tag + u32 meta_len + meta JSON + concatenated raw arrays.
# meta["arrays"] lists [dtype, shape] per array in payload order.

def _pack(tag: bytes, meta: dict, arrays: list[np.ndarray]) -> bytes:
    meta = dict(meta)
    meta["arrays"] = [[a.dtype.str, list(a.shape)] for a in arrays]
    mb = json.dumps(meta, separators=(",", ":")).encode()
    parts = [tag, struct.pack("<I", len(mb)), mb]
    parts += [np.ascontiguousarray(a).tobytes() for a in arrays]
    return b"".join(parts)


def _unpack(buf: bytes) -> tuple[bytes, dict, list[np.ndarray]]:
    """Decode a tagged-binary result. A truncated or corrupt payload (peer
    died mid-write, proxy mangled the body) surfaces as QueryError — typed,
    so the dispatch layer can classify it as a retryable peer failure
    instead of a bare 500."""
    try:
        tag = buf[:1]
        (mlen,) = struct.unpack_from("<I", buf, 1)
        meta = json.loads(buf[5:5 + mlen])
        off = 5 + mlen
        arrays = []
        for dtype, shape in meta["arrays"]:
            n = int(np.prod(shape)) if shape else 1
            a = np.frombuffer(buf, np.dtype(dtype), n, off).reshape(shape).copy()
            arrays.append(a)
            off += a.nbytes
    except (struct.error, ValueError, KeyError, TypeError,
            UnicodeDecodeError) as e:
        raise QueryError(
            f"truncated/corrupt remote result payload "
            f"({len(buf)} bytes): {e}") from None
    return tag, meta, arrays


def _enc_keys(keys) -> list:
    return [list(map(list, k.labels)) for k in keys]


def _dec_keys(rows) -> list[RangeVectorKey]:
    return [RangeVectorKey(tuple((a, b) for a, b in k)) for k in rows]


def _resolved_parts(parts) -> dict[str, np.ndarray]:
    """AggPartial.parts may be a lazy card bundle (the fused path's
    ``PaddedPartials``, launched under the shard lock with fetch=False) or
    a dict of device tensors: one host copy each, here, after the leaf
    returned and released the lock."""
    parts = aggregators.resolve_partials(parts)
    return {k: to_numpy(v) for k, v in parts.items()}


def serialize_result(data, stats=None) -> bytes:
    if stats is not None:
        # stats wrapper: the serving node's QueryStats ride every /exec
        # result payload (tag b"W"); the caller merges them into its own
        # accumulator, so query responses carry cluster-total accounting
        inner = serialize_result(data)
        return _pack(b"W", {"stats": stats.to_dict()},
                     [np.frombuffer(inner, np.uint8)])
    if isinstance(data, MatrixView):
        data = data.compact()
    if isinstance(data, AggPartial):
        parts = _resolved_parts(data.parts)
        names = sorted(parts)
        meta = {"op": data.op, "names": names, "num_groups": data.num_groups,
                "group_keys": _enc_keys(data.group_keys),
                "has_les": data.bucket_les is not None}
        arrays = [np.asarray(data.out_ts, "<i8")]
        if data.bucket_les is not None:
            arrays.append(np.asarray(data.bucket_les, "<f8"))
        arrays += [np.asarray(parts[n], "<f8") for n in names]
        return _pack(b"A", meta, arrays)
    if isinstance(data, TopKPartial):
        meta = {"k": data.k, "bottom": data.bottom,
                "group_keys": _enc_keys(data.group_keys),
                "key_table": _enc_keys(data.key_table)}
        return _pack(b"T", meta, [np.asarray(data.out_ts, "<i8"),
                                  np.asarray(data.values, "<f8"),
                                  np.asarray(data.key_ref, "<i8")])
    if isinstance(data, SketchPartial):
        meta = {"q": data.q, "group_keys": _enc_keys(data.group_keys)}
        return _pack(b"S", meta, [np.asarray(data.out_ts, "<i8"),
                                  np.asarray(to_numpy(data.counts), "<f4")])
    if isinstance(data, CountValuesPartial):
        items = sorted(data.entries.items())
        meta = {"label": data.label, "group_keys": _enc_keys(data.group_keys),
                "entries": [[gi, vstr] for (gi, vstr), _ in items]}
        rows = (np.stack([np.asarray(to_numpy(r), np.float64)
                          for _, r in items])
                if items else np.zeros((0, len(data.out_ts))))
        return _pack(b"C", meta, [np.asarray(data.out_ts, "<i8"),
                                  np.asarray(rows, "<f8")])
    m = _as_matrix(data)
    return b"M" + serialize_matrix(m)


def deserialize_result(buf: bytes, stats=None):
    """``stats``: an optional QueryStats accumulator — a b"W"-wrapped
    payload's peer stats merge into it (and the wrapper unwraps either
    way, so stats-blind callers stay compatible)."""
    try:
        tag = buf[:1]
        if tag == b"W":
            _t, meta, arrays = _unpack(buf)
            inner = arrays[0].tobytes()
            if inner[:1] == b"W":
                raise QueryError("nested stats wrapper")
            if stats is not None and isinstance(meta.get("stats"), dict):
                stats.merge(meta["stats"])
            return deserialize_result(inner)
        if tag == b"M":
            return deserialize_matrix(buf[1:])
        tag, meta, arrays = _unpack(buf)
        if tag == b"A":
            out_ts = arrays[0]
            i = 1
            les = None
            if meta["has_les"]:
                les = arrays[i]
                i += 1
            parts = dict(zip(meta["names"], arrays[i:]))
            return AggPartial(meta["op"], out_ts, parts,
                              _dec_keys(meta["group_keys"]), meta["num_groups"],
                              les)
        if tag == b"T":
            out_ts, values, key_ref = arrays
            return TopKPartial(meta["k"], meta["bottom"], out_ts,
                               _dec_keys(meta["group_keys"]), values, key_ref,
                               _dec_keys(meta["key_table"]))
        if tag == b"S":
            out_ts, counts = arrays
            return SketchPartial(meta["q"], out_ts,
                                 _dec_keys(meta["group_keys"]), counts)
        if tag == b"C":
            out_ts, rows = arrays
            entries = {(gi, vstr): rows[i]
                       for i, (gi, vstr) in enumerate(meta["entries"])}
            return CountValuesPartial(meta["label"], out_ts,
                                      _dec_keys(meta["group_keys"]), entries)
    except QueryError:
        raise
    except (struct.error, ValueError, KeyError, IndexError, TypeError,
            UnicodeDecodeError) as e:
        # malformed meta fields / short array lists — same class of fault as
        # a torn payload: typed, retryable, never a bare 500
        raise QueryError(
            f"truncated/corrupt remote result payload: {e}") from None
    raise QueryError(f"unknown remote result tag {tag!r}")


# -- batch framing -----------------------------------------------------------
#
# Request: a JSON LIST of plan envelopes (vs a single JSON object) — the
# server peeks at the first byte. Response: one multi-part tagged-binary
# body: b"B" + u32 count, then per part u8 status + u32 len + payload
# (status 0 = a serialize_result body; status 1 = a JSON error record,
# classified per envelope so replan-once still works per leaf).

def pack_multipart(parts: list[tuple[int, bytes]]) -> bytes:
    out = [b"B", struct.pack("<I", len(parts))]
    for status, blob in parts:
        out.append(struct.pack("<BI", status, len(blob)))
        out.append(blob)
    return b"".join(out)


def unpack_multipart(buf: bytes) -> list[tuple[int, bytes]]:
    try:
        if buf[:1] != b"B":
            raise ValueError(f"bad multipart tag {buf[:1]!r}")
        (n,) = struct.unpack_from("<I", buf, 1)
        off = 5
        parts = []
        for _ in range(n):
            status, ln = struct.unpack_from("<BI", buf, off)
            off += 5
            blob = buf[off:off + ln]
            if len(blob) != ln:
                raise ValueError("truncated part body")
            parts.append((status, blob))
            off += ln
        return parts
    except (struct.error, ValueError, IndexError) as e:
        raise QueryError(
            f"truncated/corrupt multipart exec response "
            f"({len(buf)} bytes): {e}") from None


def execute_batch(body: bytes, ctx) -> bytes:
    """Server side of a batched ``/exec``: run the envelopes CONCURRENTLY
    (bounded pool — batching must not serialize what used to be K parallel
    legs under the caller's single timeout) and collect per-envelope
    successes/errors — one bad leaf must not void its siblings' results (the
    caller classifies each part individually)."""
    try:
        envs = json.loads(body)
        if not isinstance(envs, list):
            raise ValueError("batch body must be a JSON list")
    except ValueError as e:
        raise QueryError(f"malformed exec batch: {e}") from None

    def _run_env(d) -> tuple[int, bytes]:
        try:
            if not isinstance(d, dict):
                raise QueryError("batch envelope is not an object")
            # per-envelope stats: envelopes run concurrently and each part's
            # payload carries exactly its own subtree's accounting
            ectx = replace(ctx, stats=QueryStats())
            plan = _dec_plan(dict(d))
            with ectx.stats.stage("peer_exec"):
                data = plan.execute(ectx)
            return (0, serialize_result(data, stats=ectx.stats))
        except QueryError as e:
            return (1, json.dumps(
                {"error": str(e), "kind": "query"}).encode())
        except (KeyError, TypeError, ValueError) as e:
            return (1, json.dumps(
                {"error": f"malformed remote exec plan: {e}",
                 "kind": "query"}).encode())
        except Exception as e:  # noqa: BLE001 — peer stays up per envelope
            return (1, json.dumps(
                {"error": f"{type(e).__name__}: {e}",
                 "kind": "internal"}).encode())

    # envelopes run on pool threads: bind the handler thread's trace
    # context (the caller's dispatch span) so leaf spans join the query's
    # trace instead of rooting fresh ones
    run_env = tracer.wrap(_run_env)
    if len(envs) > 1:
        # 16-wide: the width the pre-batching transport had (the client
        # fanned out up to 16 concurrent POSTs, the leg semaphore admits 16)
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=min(len(envs), 16)) as pool:
            parts = list(pool.map(run_env, envs))
    else:
        parts = [run_env(d) for d in envs]
    return pack_multipart(parts)


# -- the remote leaf ---------------------------------------------------------

def _split_wire_prefix(transformers):
    """(ship, local): the wire-able prefix ships with the plan; the suffix
    (rare: a scalar-operand subplan) applies locally to the returned data —
    chain order preserved because only a suffix stays local."""
    ship, local = [], []
    for t in transformers:
        (ship if not local and is_wire_transformer(t) else local).append(t)
    return ship, local


@dataclass
class RemoteLeafExec(ExecPlan):
    """A subplan whose shards live on a peer node: ship it (selector + the
    wire-able prefix of the transformer chain, including a pushed-down
    AggregateMapReduce — or a whole co-located ReduceAggregate/DistConcat
    whose children all live on that peer) to the owner's ``/exec`` endpoint
    and return the deserialized partial/matrix.

    Ref: PlanDispatcher.scala ActorPlanDispatcher.dispatch + ExecPlan.scala
    ``dispatchRemotePlan``; the owner-node pick is the planner's
    (queryengine2/QueryEngine.scala:506 analog in planner.py)."""
    endpoint: str = ""           # peer "host:port" of its HTTP API
    dataset: str = ""
    inner: ExecPlan = None
    timeout_s: float = 30.0

    IS_REMOTE = True             # non-leaf parents fan these out in threads

    def execute(self, ctx):
        ship, local = _split_wire_prefix(self.transformers)
        plan = replace(self.inner,
                       transformers=list(self.inner.transformers) + ship)
        shards = _plan_shards(plan)
        payload = _dispatch_post(self.endpoint, self.dataset,
                                 serialize_plan(plan), self.timeout_s, shards)
        try:
            # ctx-less execution (unit harnesses) still unwraps; the peer's
            # stats merge only when there is an accumulator to merge into
            data = deserialize_result(payload,
                                      stats=getattr(ctx, "stats", None))
        except QueryError as e:
            # a torn/corrupt result body means the peer (or its transport)
            # failed mid-response: classify like unreachability so the
            # engine's replan-retry can route around a reassigned shard
            raise RemotePeerError(
                f"peer {self.endpoint} returned an undecodable result for "
                f"shards {list(shards)}: {e}", endpoint=self.endpoint,
                shards=shards) from None
        for t in local:
            data = t.apply(data, ctx)
        return data

    def do_execute(self, ctx):  # pragma: no cover — execute() is overridden
        raise NotImplementedError


@dataclass
class RemoteBatchExec(ExecPlan):
    """All of one fan-in node's leaves bound for ONE peer, dispatched as a
    single ``/exec`` POST (a JSON list of envelopes) instead of one POST per
    shard — a query touching a K-shard peer costs one round-trip, not K
    (ref: the reference ships whole subplans to per-node dispatchers; this
    is the transport-batched analog when the reduce itself cannot move).
    ``execute`` returns a LIST of per-member results; the parent's child
    executor splices them in place (exec.py:_execute_children)."""
    endpoint: str = ""
    dataset: str = ""
    members: list = field(default_factory=list)   # RemoteLeafExec wrappers
    timeout_s: float = 30.0
    # original child-list indices of the members (pre-batching): the parent's
    # child executor splices results back into EXACTLY these positions, so
    # reduce/concat merge order — and therefore float accumulation order and
    # bit-parity with the single-node oracle — is unchanged by batching
    slots: list = field(default_factory=list)

    IS_REMOTE = True
    IS_BATCH = True              # parents splice the result list in place

    def execute(self, ctx):
        plans, locals_ = [], []
        for m in self.members:
            ship, local = _split_wire_prefix(m.transformers)
            plans.append(replace(m.inner,
                                 transformers=list(m.inner.transformers) + ship))
            locals_.append(local)
        shards = tuple(s for p in plans for s in _plan_shards(p))
        body = json.dumps([_enc_plan(p) for p in plans],
                          separators=(",", ":")).encode()
        payload = _dispatch_post(self.endpoint, self.dataset, body,
                                 self.timeout_s, shards)
        try:
            parts = unpack_multipart(payload)
        except QueryError as e:
            # a torn multipart body is the batched analog of a torn single
            # result: peer/transport died mid-response, retryable
            raise RemotePeerError(
                f"peer {self.endpoint} returned an undecodable batch "
                f"response for shards {list(shards)}: {e}",
                endpoint=self.endpoint, shards=shards) from None
        if len(parts) != len(plans):
            raise RemotePeerError(
                f"peer {self.endpoint} answered {len(parts)} parts for "
                f"{len(plans)} envelopes", endpoint=self.endpoint,
                shards=shards)
        results = []
        for plan, (status, blob), local in zip(plans, parts, locals_):
            pshards = _plan_shards(plan)
            if status != 0:
                # per-envelope failure: classified individually so the
                # engine's replan-once applies to exactly the failed leaf
                try:
                    err = json.loads(blob)
                except ValueError:
                    err = {"error": blob[:200].decode("utf-8", "replace")}
                raise QueryError(
                    f"remote exec on {self.endpoint} for shards "
                    f"{list(pshards)} failed: {err.get('error', '?')}")
            try:
                data = deserialize_result(blob,
                                          stats=getattr(ctx, "stats", None))
            except QueryError as e:
                raise RemotePeerError(
                    f"peer {self.endpoint} returned an undecodable result "
                    f"for shards {list(pshards)}: {e}",
                    endpoint=self.endpoint, shards=pshards) from None
            for t in local:
                data = t.apply(data, ctx)
            results.append(data)
        return results

    def do_execute(self, ctx):  # pragma: no cover — execute() is overridden
        raise NotImplementedError
