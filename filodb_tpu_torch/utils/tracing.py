"""Tracing: in-process spans with a per-thread context stack.

Host copy of the span recorder of ``filodb_tpu/utils/tracing.py``, limited
to what the port opens (the query's stages, admission, the fragment cache's
delta evaluation, a subscription's increment, on-demand paging,
retention routing, a query's cross-node dispatch and its peer-side
serve, the ingest plane: the broker's publish, append and
replication, the consumer's drain, the gateway's publish and the cluster's
gossip, epoch lead, rejoin and rebalance, remote read and write, and a
rule's evaluation, and inside a query's leaf the shard lock's wait, the
index selection and the host's waits on the card): ``with
span(SPAN_QUERY_EXECUTE, ...)`` records one span into a bounded ring,
parented under the innermost open frame of the thread. A span's start and
end come from one clock: the monotonic clock, offset by one wall-clock
anchor taken when the module loads, so every span lies on the wall
clock's timeline (where a profiler's device activities lie) and a span
reads the clock once at each end.

Context crosses threads and the wire as the reference's does:
``current_context()`` is the wire-able form of the innermost frame (the
``/exec`` POST carries it in its trace header), ``activate(ctx)`` adopts
one on the receiving thread, and ``wrap(fn)`` binds the caller's frame to
work handed to a pool. The sampling decision rides the frame, so a trace
records on every node or on none. ``traces()`` assembles the ring parent
to child for the debug page; ``export_zipkin_json`` is its Zipkin v2 form,
and ``ZipkinReporter`` ships the ring to a collector on a cadence. The
sampling decision is made once at a trace root (``sample_rate``).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import random
import threading
import time
from collections import deque
from dataclasses import dataclass, field

from .metrics import FILODB_SWALLOWED_ERRORS, FILODB_TRACE_SPANS, registry

log = logging.getLogger("filodb_tpu_torch.tracing")

# the wall clock's reading at perf_counter_ns() == 0: span times are
# perf_counter_ns() plus this, in one clock for the process's lifetime
_WALL_ANCHOR_NS = time.time_ns() - time.perf_counter_ns()


def now_us() -> int:
    """Now on the spans' clock (wall-clock microseconds)."""
    return (_WALL_ANCHOR_NS + time.perf_counter_ns()) // 1000


SPAN_QUERY = "query"
SPAN_QUERY_PARSE = "query.parse"
SPAN_QUERY_PLAN = "query.plan"
SPAN_QUERY_EXECUTE = "query.execute"
SPAN_QUERY_LEAF = "query.exec.leaf"
SPAN_QUERY_REDUCE = "query.exec.reduce"
# one cross-node /exec POST (tags: endpoint, shards)
SPAN_QUERY_DISPATCH = "query.exec.dispatch"
# the peer side of /exec: the subtree run on the shard-owning node (tags:
# node, dataset)
SPAN_QUERY_SERVE = "query.exec.serve"
SPAN_QUERY_ADMIT = "query.admission"
SPAN_QUERY_FRAGMENT = "query.fragment"
SPAN_QUERY_SUBSCRIBE = "query.subscribe"
# on-demand page-in of cold chunks for one leaf batch (tags: shard, series,
# tier)
SPAN_QUERY_ODP = "query.odp"
# durable-tier chunk scan of one ODP page-in batch (tags: shard,
# tier=local|remote, rows)
SPAN_ODP_DURABLE = "query.odp.durable"
# downsample-aware routing of one query: the resolution decision and its
# routed or stitched leg queries hang under it (tags: dataset, resolution,
# stitched)
SPAN_QUERY_RETENTION = "query.retention"
# Prometheus remote storage: a remote-read fan-out leg to one peer (tags:
# endpoint), and a remote-write batch accepted at the HTTP edge
SPAN_REMOTE_READ = "query.remote_read"
SPAN_REMOTE_WRITE = "ingest.remote_write"
# one rule evaluation inside a scheduler tick (tags: group, rule, eval_ts;
# its PromQL query and derived publish spans hang under it)
SPAN_RULES_EVAL = "rules.eval"
# the ingest plane: a client's publish group, the broker's append, its
# replication batch and the follower's serve of it, one consumer drain, and
# one gateway flush
SPAN_INGEST_PUBLISH = "ingest.publish"
SPAN_BROKER_APPEND = "ingest.broker.append"
SPAN_REPLICATE = "ingest.replicate"
SPAN_REPLICATE_SERVE = "ingest.replicate.serve"
SPAN_INGEST_CONSUME = "ingest.consume"
SPAN_GATEWAY_PUBLISH = "ingest.gateway.publish"
# the elastic cluster: one gossip probe round, an epoch claim, a deposed
# broker's rejoin, a live shard move
SPAN_CLUSTER_GOSSIP = "cluster.gossip"
SPAN_CLUSTER_LEAD = "cluster.epoch.lead"
SPAN_CLUSTER_REJOIN = "cluster.rejoin"
SPAN_CLUSTER_REBALANCE = "cluster.rebalance"
# the port's own spans inside a query's leaf: the wait for a shard lock
# another thread holds (tags: lock), the index selection and capture under
# it (tags: shard, series), and the blocking device-to-host copies where
# the host waits for the card's queue (tags: site)
SPAN_QUERY_LOCK_WAIT = "query.exec.lock_wait"
SPAN_QUERY_SELECT = "query.exec.select"
SPAN_QUERY_FETCH = "query.exec.fetch"

# The reference's TRACE_SPEC names this span too; it belongs to its
# compiled-plan cache (query/plancache.py), which has no port.
NOT_PORTED = ("query.compile",)

# The port's spans that the reference has no twin of.
PORT_ONLY = (SPAN_QUERY_LOCK_WAIT, SPAN_QUERY_SELECT, SPAN_QUERY_FETCH)

# The declared span surface: every span name this process records is named
# by one constant above and documented here (filolint's surface-check
# family enforces it). The reference's, less NOT_PORTED, plus PORT_ONLY.
TRACE_SPEC: dict[str, str] = {
    SPAN_QUERY: "Root span of one PromQL query (tags: dataset, promql).",
    SPAN_QUERY_PARSE: "PromQL text -> LogicalPlan.",
    SPAN_QUERY_PLAN: "LogicalPlan -> ExecPlan materialization + remote "
                     "collapse.",
    SPAN_QUERY_EXECUTE: "ExecPlan execution (mesh, fused, or scatter-gather "
                        "path; tags: path).",
    SPAN_QUERY_LEAF: "One data-reading leaf under its shard lock "
                     "(tags: shard).",
    SPAN_QUERY_LOCK_WAIT: "A thread's wait for a lock another thread "
                          "holds, inside a sampled trace (tags: lock).",
    SPAN_QUERY_SELECT: "A leaf's index selection and tensor capture under "
                       "its shard lock (tags: shard, series).",
    SPAN_QUERY_FETCH: "A blocking device-to-host copy on a query's path: "
                      "the host waits for the card's queue (tags: site).",
    SPAN_QUERY_REDUCE: "Cross-shard reduce merge of child partials.",
    SPAN_QUERY_DISPATCH: "One cross-node /exec POST (tags: endpoint, "
                         "shards).",
    SPAN_QUERY_SERVE: "Peer side of /exec: subtree execution on the "
                      "shard-owning node (tags: node).",
    SPAN_QUERY_ODP: "On-demand page-in of cold chunks for one leaf batch "
                    "(tags: shard, series).",
    SPAN_QUERY_ADMIT: "Cost-based admission decision for one query (tags: "
                      "cost, tenant, shed on rejection).",
    SPAN_REMOTE_READ: "Remote-read fan-out leg to one peer (tags: "
                      "endpoint).",
    SPAN_REMOTE_WRITE: "Remote-write batch accepted at the HTTP edge.",
    SPAN_GATEWAY_PUBLISH: "One built gateway container published to its "
                          "shard's bus (tags: shard).",
    SPAN_INGEST_PUBLISH: "One pipelined PUBLISH_BATCH group on the client "
                         "(tags: partition, failovers on a leader switch).",
    SPAN_BROKER_APPEND: "Broker-side publish append + quorum wait "
                        "(tags: partition, broker).",
    SPAN_REPLICATE: "Leader->follower replication push for one publish "
                    "(tags: partition, peer).",
    SPAN_REPLICATE_SERVE: "Follower side of OP_REPLICATE: CRC check + "
                          "append (tags: partition, broker).",
    SPAN_INGEST_CONSUME: "One consumer drain: bus containers scattered "
                         "into the shard store (tags: dataset, shard).",
    SPAN_QUERY_RETENTION: "Downsample-aware routing of one query: the "
                          "resolution decision and its routed/stitched "
                          "leg queries hang under it (tags: dataset, "
                          "resolution, stitched).",
    SPAN_QUERY_FRAGMENT: "Incremental (delta) evaluation of one range "
                         "query off the fragment cache: reused per-step "
                         "columns + head/tail sub-executions hang under it "
                         "(tags: dataset, reused, computed).",
    SPAN_QUERY_SUBSCRIBE: "One streaming-subscription increment: the steps "
                          "newly covered by the ingest watermarks since "
                          "the subscriber's cursor (tags: dataset, steps).",
    SPAN_ODP_DURABLE: "Durable-tier chunk scan of one ODP page-in batch "
                      "(tags: shard, tier=local|remote, rows).",
    SPAN_RULES_EVAL: "One rule evaluation inside a scheduler tick (tags: "
                     "group, rule, eval_ts; its PromQL query and derived "
                     "publish spans hang under it).",
    SPAN_CLUSTER_GOSSIP: "One membership gossip probe round: digest "
                         "exchange with the scheduled peer (tags: peer, "
                         "round).",
    SPAN_CLUSTER_LEAD: "Leadership claim for one partition: read peer "
                       "epochs, bump, persist, announce (tags: partition, "
                       "epoch).",
    SPAN_CLUSTER_REJOIN: "REJOIN repair of a restarted deposed leader: "
                         "divergent-tail truncation + catch-up from the "
                         "current leader (tags: partition, owner).",
    SPAN_CLUSTER_REBALANCE: "Operator-triggered live shard move: "
                            "flush→handoff→catch-up→cutover (tags: dataset, "
                            "shard, to).",
}


def trace_markdown_table() -> str:
    """The ARCHITECTURE 'Span taxonomy' table, generated from TRACE_SPEC
    (verified against the checked-in ARCHITECTURE.md by
    tests/test_torch_static_analysis.py)."""
    lines = ["| span | meaning |", "|---|---|"]
    for name, doc in sorted(TRACE_SPEC.items()):
        lines.append(f"| `{name}` | {doc} |")
    return "\n".join(lines)

@dataclass
class SpanRecord:
    trace_id: str
    span_id: str
    parent_id: str | None
    name: str
    start_us: int
    duration_us: int
    tags: dict = field(default_factory=dict)
    # monotonic record sequence (per tracer): exporters keep a watermark
    # against it
    seq: int = 0

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id, "name": self.name,
                "start_us": self.start_us, "duration_us": self.duration_us,
                "tags": {k: str(v) for k, v in self.tags.items()}}

    def to_zipkin(self) -> dict:
        """Zipkin v2 JSON shape."""
        return {"traceId": self.trace_id, "id": self.span_id,
                "parentId": self.parent_id, "name": self.name,
                "timestamp": self.start_us, "duration": self.duration_us,
                "tags": {k: str(v) for k, v in self.tags.items()}}


class Tracer:
    """Process-global span recorder. The per-thread stack holds
    ``(trace_id, span_id, sampled)`` frames; ``span()`` parents under the
    innermost one, ``activate`` pushes a remote or cross-thread one."""

    def __init__(self, capacity: int = 4096):
        self.spans: deque[SpanRecord] = deque(maxlen=capacity)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._seq = 0
        self.log_spans = False
        self.enabled = True
        self.sample_rate = 1.0
        self._span_counter = registry.counter(FILODB_TRACE_SPANS)

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _new_id(self) -> str:
        rng = getattr(self._local, "rng", None)
        if rng is None:
            rng = self._local.rng = random.Random(
                int.from_bytes(os.urandom(16), "little"))
        return f"{rng.getrandbits(64):016x}"

    def sampled(self) -> bool:
        """True when the calling thread is inside a sampled trace: a span
        opened now records, and roots no trace of its own."""
        st = getattr(self._local, "stack", None)
        return bool(st) and st[-1][2]

    def current_context(self) -> dict | None:
        st = self._stack()
        if not st:
            return None
        trace_id, span_id, sampled = st[-1]
        return {"trace_id": trace_id, "span_id": span_id,
                "sampled": bool(sampled)}

    def wrap(self, fn):
        """Bind the calling thread's innermost frame to ``fn``: the
        returned callable activates it wherever it runs (every pool
        fan-out hands its work over through this)."""
        ctx = self.current_context()

        def bound(*args, **kwargs):
            with self.activate(ctx):
                return fn(*args, **kwargs)
        return bound

    _ID_CHARS = frozenset("0123456789abcdef")

    @classmethod
    def _valid_id(cls, v) -> bool:
        """Wire-supplied ids must be bounded lowercase hex: they land in
        span records and debug JSON."""
        return (isinstance(v, str) and 0 < len(v) <= 32
                and set(v) <= cls._ID_CHARS)

    @contextlib.contextmanager
    def activate(self, ctx: dict | None):
        """Adopt a remote or cross-thread parent frame on this thread. A
        None or malformed context (non-hex ids from a peer) is a no-op:
        the span below it roots a fresh trace."""
        if not isinstance(ctx, dict) or not self._valid_id(
                ctx.get("trace_id")) or not self._valid_id(
                ctx.get("span_id")):
            yield
            return
        st = self._stack()
        st.append((ctx["trace_id"], ctx["span_id"],
                   bool(ctx.get("sampled", True))))
        try:
            yield
        finally:
            st.pop()

    @contextlib.contextmanager
    def span(self, name: str, **tags):
        """Record one span; yields the tags dict so callers can attach
        outcome tags discovered mid-span."""
        stack = self._stack()
        if stack:
            trace_id, parent_id, sampled = stack[-1]
        elif not self.enabled:
            yield tags
            return
        else:
            trace_id, parent_id = self._new_id(), None
            sampled = (self.sample_rate >= 1.0
                       or self._local.rng.random() < self.sample_rate)
        # a sampled-out frame still propagates (children and peers inherit
        # the decision) but records nothing
        span_id = self._new_id() if sampled else "0"
        stack.append((trace_id, span_id, sampled))
        if sampled:
            t0 = time.perf_counter_ns()
        try:
            yield tags
        finally:
            stack.pop()
            if sampled:
                dur_us = (time.perf_counter_ns() - t0) // 1000
                rec = SpanRecord(trace_id, span_id, parent_id, name,
                                 (_WALL_ANCHOR_NS + t0) // 1000, dur_us, tags)
                with self._lock:
                    self._seq += 1
                    rec.seq = self._seq
                    self.spans.append(rec)
                self._span_counter.increment()
                if self.log_spans:
                    log.info("span %s %.1fms %s", name, dur_us / 1000, tags)

    def snapshot(self) -> list[SpanRecord]:
        with self._lock:
            return list(self.spans)

    def drain(self) -> list[SpanRecord]:
        with self._lock:
            out = list(self.spans)
            self.spans.clear()
            return out

    def traces(self, limit: int = 50,
               trace_id: str | None = None) -> list[dict]:
        """Recent traces assembled parent to child: newest trace first,
        each trace's spans roots first, then depth first by parent links
        (a span whose parent left the ring follows as a root)."""
        by_trace: dict[str, list[SpanRecord]] = {}
        order: list[str] = []
        for s in self.snapshot():
            if trace_id is not None and s.trace_id != trace_id:
                continue
            if s.trace_id not in by_trace:
                order.append(s.trace_id)
            by_trace.setdefault(s.trace_id, []).append(s)
        out = []
        for tid in reversed(order[-limit:] if trace_id is None else order):
            members = by_trace[tid]
            ids = {s.span_id for s in members}
            children: dict[str | None, list[SpanRecord]] = {}
            roots = []
            for s in members:
                if s.parent_id in ids:
                    children.setdefault(s.parent_id, []).append(s)
                else:
                    roots.append(s)
            ordered: list[SpanRecord] = []
            stack = sorted(roots, key=lambda s: s.start_us, reverse=True)
            while stack:
                s = stack.pop()
                ordered.append(s)
                stack.extend(sorted(children.get(s.span_id, ()),
                                    key=lambda c: c.start_us, reverse=True))
            out.append({"trace_id": tid,
                        "duration_us": max((s.duration_us for s in roots),
                                           default=0),
                        "spans": [s.to_dict() for s in ordered]})
        return out

    def export_zipkin_json(self, trace_id: str | None = None) -> str:
        return json.dumps([s.to_zipkin() for s in self.snapshot()
                           if trace_id is None or s.trace_id == trace_id])

    def post_zipkin(self, endpoint: str,
                    spans: list[SpanRecord] | None = None) -> int:
        """POST spans (default: a non-destructive snapshot) to a Zipkin v2
        collector; returns the span count shipped. Never drains the ring:
        the debug plane reads the same ring."""
        import urllib.request
        spans = self.snapshot() if spans is None else spans
        if not spans:
            return 0
        body = json.dumps([s.to_zipkin() for s in spans]).encode()
        req = urllib.request.Request(
            endpoint, data=body, method="POST",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=5.0) as r:
            r.read()
        return len(spans)


class ZipkinReporter:
    """Periodic Zipkin shipper (``trace.zipkin_endpoint``): snapshots the
    tracer's ring on a cadence and POSTs the spans newer than its seq
    watermark. A failed POST leaves the watermark, so those spans retry
    next tick; export faults are counted and logged, never fatal."""

    def __init__(self, tracer_: "Tracer", endpoint: str,
                 interval_s: float = 5.0):
        self.tracer = tracer_
        self.endpoint = endpoint
        self.interval_s = interval_s
        self._watermark = 0
        self._stop_ev = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "ZipkinReporter":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="zipkin-reporter")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop_ev.set()
        if self._thread is not None:
            self._thread.join(timeout=3)
            self._thread = None

    def tick(self) -> int:
        """One export pass: ship spans newer than the watermark, advance it
        only on success. Returns the count shipped."""
        fresh = [s for s in self.tracer.snapshot()
                 if s.seq > self._watermark]
        if not fresh:
            return 0
        n = self.tracer.post_zipkin(self.endpoint, fresh)
        self._watermark = fresh[-1].seq
        return n

    def _run(self) -> None:
        while not self._stop_ev.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — a dead collector must not
                # kill the reporter for the process lifetime
                registry.counter(FILODB_SWALLOWED_ERRORS,
                                 {"site": "zipkin-export"}).increment()
                log.warning("zipkin export to %s failed", self.endpoint,
                            exc_info=True)


tracer = Tracer()


def span(name: str, **tags):
    """``with span(SPAN_QUERY_EXECUTE, dataset=...):`` on the global tracer."""
    return tracer.span(name, **tags)
