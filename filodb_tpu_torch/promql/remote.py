"""Prometheus remote read/write protocol conversions.

Reference: prometheus/.../query/PrometheusModel.scala (toFiloDBLogicalPlans /
remote-read protobuf conversion) + http route wiring in PrometheusApiRoute.
Wire framing: snappy-block-compressed protobuf (``utils/snappy.py``), messages
from ``remote_storage.proto`` (public Prometheus remote storage spec).

Port of ``filodb_tpu/promql/remote.py``. The messages go through the port's
own codec (``remote_storage.py``), which writes the bytes protobuf writes,
so a body either package encoded is one the other accepts, and a remote
read answers with the reference's bytes for the same store. The samples of
a series cross the codec as columns: ``raw_series``' arrays go into a
``TimeSeries`` without a Python object a sample, and a written series'
samples go into its shard's builder with ``add_batch`` (the same container
as one ``add`` a sample).
"""

from __future__ import annotations

from ..core import filters as F
from ..core.record import RecordBuilder, fnv1a64
from ..core.schemas import Schema, part_key_of, shard_key_of
from ..utils import snappy
from . import remote_storage as pb

_MATCHER_TO_FILTER = {
    pb.LabelMatcher.EQ: F.Equals,
    pb.LabelMatcher.NEQ: F.NotEquals,
    pb.LabelMatcher.RE: F.EqualsRegex,
    pb.LabelMatcher.NRE: F.NotEqualsRegex,
}


def matchers_to_filters(matchers) -> list:
    """LabelMatcher protobufs -> index filters (__name__ -> metric column).
    Regex matchers validate here — compile once, bounded pattern length —
    so a bad pattern is a typed client error naming the matcher, never a
    500 from deep inside a shard select."""
    from .parser import validate_matcher_regex
    out = []
    for m in matchers:
        label = "_metric_" if m.name == "__name__" else m.name
        if m.type in (pb.LabelMatcher.RE, pb.LabelMatcher.NRE):
            validate_matcher_regex(label, m.value)
        out.append(_MATCHER_TO_FILTER[m.type](label, m.value))
    return out


def read_request(body: bytes, engine, local_only: bool = False) -> bytes:
    """snappy(ReadRequest) -> snappy(ReadResponse) against one dataset engine.

    On a multi-node cluster the raw request is forwarded VERBATIM to every
    peer owning shards of the dataset (with local=1 stopping recursion) and
    the peers' ReadResponses merge per query — each node contributes exactly
    its own shards' series, so the union is duplicate-free (ref: the
    reference's remote-read serves from whichever node the LB hits, which
    proxies through its coordinator's scatter)."""
    req = pb.ReadRequest()
    req.ParseFromString(snappy.decompress(body))
    # kick the peer scatter off BEFORE the local scan so the two overlap
    # (latency = max(local, slowest peer), not their sum)
    handle = None
    if not local_only and getattr(engine, "_has_remote_shards", None) \
            and engine._has_remote_shards():
        handle = engine.peer_scatter_begin(_peer_read_fetch(body, engine))
    resp = pb.ReadResponse()
    for q in req.queries:
        result = resp.results.add()
        filters = matchers_to_filters(q.matchers)
        for labels, ts, vals in engine.raw_series(
                filters, q.start_timestamp_ms, q.end_timestamp_ms):
            series = result.timeseries.add()
            for name in sorted(labels):
                wire_name = "__name__" if name == "_metric_" else name
                series.labels.add(name=wire_name, value=labels[name])
            series.samples.extend_arrays(ts, vals)
    if handle is not None:
        # raw reads are DATA queries: a dead peer must fail the request
        # loudly (same rule as query_range's RemoteLeafExec), never return
        # a silently partial ReadResponse a backfill would record as truth
        from ..query.rangevector import QueryError
        for ep, peer in engine.peer_scatter_join(handle):
            if isinstance(peer, Exception):
                raise QueryError(
                    f"remote-read peer {ep} failed: {peer}; the query is "
                    "retryable once shards reassign")
            for i, pres in enumerate(peer.results):
                if i < len(resp.results):
                    resp.results[i].timeseries.extend(pres.timeseries)
    return snappy.compress(resp.SerializeToString())


def _peer_read_fetch(body: bytes, engine):
    """fetch(ep) forwarding the raw ReadRequest verbatim to a peer's
    local-only read endpoint and parsing its ReadResponse (trace context
    rides the shared /exec header so the peer's spans join this trace)."""
    import json
    import urllib.request

    from ..query import wire
    from ..utils.tracing import SPAN_REMOTE_READ, span, tracer

    def fetch(ep: str):
        with span(SPAN_REMOTE_READ, endpoint=ep):
            headers = {"Content-Type": "application/x-protobuf",
                       "Content-Encoding": "snappy"}
            tctx = tracer.current_context()
            if tctx is not None:
                headers[wire.TRACE_HEADER] = json.dumps(
                    tctx, separators=(",", ":"))
            url = f"http://{ep}/promql/{engine.dataset}/api/v1/read?local=1"
            rq = urllib.request.Request(url, data=body, method="POST",
                                        headers=headers)
            with urllib.request.urlopen(rq, timeout=30.0) as r:
                peer = pb.ReadResponse()
                peer.ParseFromString(snappy.decompress(r.read()))
                return peer
    return fetch


def write_request_to_containers(body: bytes, schema: Schema, mapper,
                                governor=None, series_known=None) -> dict:
    """snappy(WriteRequest) -> {shard: RecordContainer} routed like the gateway
    (shard-key hash selects the shard group, part hash spreads within it).

    The reserved ``__rule__`` label is REJECTED here (typed 422): it marks
    recording-rule output, which publishes through the rules subsystem's
    own deterministic-pub-id path — an external write carrying it would
    forge derived-series provenance.

    ``governor``/``series_known(shard, labels) -> bool`` arm the
    cardinality fast-shed edge: a series that is over its tenant's quota
    AND provably new is dropped from the batch and counted; the HTTP edge
    then answers 429 + Retry-After AFTER publishing the kept samples —
    existing-series samples always land (``write_governed`` returns the
    shed count)."""
    return write_governed(body, schema, mapper, governor, series_known)[0]


def write_governed(body: bytes, schema: Schema, mapper,
                   governor=None, series_known=None):
    """write_request_to_containers plus (shed count, shed tenant names) —
    the 429-deciding signal at the HTTP write edge."""
    from ..query.rangevector import QueryError
    from ..rules.spec import RULE_LABEL
    from ..utils.metrics import FILODB_RULES_SPOOF_REJECTS, registry
    req = pb.WriteRequest()
    req.ParseFromString(snappy.decompress(body))
    builders: dict[int, RecordBuilder] = {}
    opts = schema.options
    shed = 0
    shed_tenants: set[str] = set()
    for series in req.timeseries:
        labels = {("_metric_" if lp.name == "__name__" else lp.name): lp.value
                  for lp in series.labels}
        if RULE_LABEL in labels:
            registry.counter(FILODB_RULES_SPOOF_REJECTS,
                             {"site": "remote-write"}).increment()
            raise QueryError(
                f"label {RULE_LABEL!r} is reserved for recording-rule "
                "output and cannot be written externally (derived-series "
                "provenance is broker-verified, not client-asserted)")
        shard = mapper.shard_of(
            fnv1a64(shard_key_of(labels, opts)) & 0xFFFFFFFF,
            fnv1a64(part_key_of(labels, opts)))
        if governor is not None:
            # shed only what is provably a NEW series of an over-quota
            # tenant; anything unprovable passes through — the shard-level
            # limiter stays authoritative and existing samples never drop
            tenant = governor.tenant_of(labels)
            if governor.over_limit(tenant) and series_known is not None \
                    and not series_known(shard, labels):
                governor.count_shed("remote-write", tenant)
                shed += 1
                shed_tenants.add(tenant)
                continue
        b = builders.get(shard)
        if b is None:
            b = builders[shard] = RecordBuilder(schema)
        if not len(series.samples):
            continue
        if schema.is_multi_column:
            for s in series.samples:
                b.add(labels, int(s.timestamp_ms), float(s.value))
        else:
            # one add_batch a series builds the container one add a
            # sample builds, without a Python step a sample
            ts, vals = series.samples.arrays()
            b.add_batch(labels, ts, vals)
    return ({shard: b.build() for shard, b in builders.items()}, shed,
            sorted(shed_tenants))
