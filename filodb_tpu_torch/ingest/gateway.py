"""Ingestion gateway: Influx line protocol -> shard-routed record containers.

Reference: gateway/src/main/scala/filodb/gateway/GatewayServer.scala:37-60 (Netty
TCP server), conversion/InfluxProtocolParser.scala (line protocol), InputRecord
(field mapping), KafkaContainerSink (shard-hashed container publishing).

TPU-native shape: the gateway is pure host-side; it parses lines, batches per
shard with RecordBuilders (shard = ShardMapper(shard-key-hash, part-key-hash)),
and publishes containers to the per-shard bus.

Throughput shape (the ingest-plane pipeline): each connection parses and
batches into its OWN RecordBuilders — no global lock on the line hot path —
and a shared route memo keyed on the line's measurement+tag prefix caches the
series -> (shard, labels, canonical key) resolution, so a repeated series
costs one dict probe instead of two FNV-1a passes over its key bytes. Only
the publish of a BUILT container serializes — per shard, and per connection
(build + publish under one state-lock hold) so a connection's containers
reach the bus in build order and the store never sees its own samples as
out-of-order. Flush is driven by size (``flush_lines``) OR a time bound
(``flush_interval_ms``) so low-rate shards still land promptly.
"""

from __future__ import annotations

import logging
import select
import socket
import socketserver
import threading
import time

from ..core.cardinality import SeriesQuotaExceeded
from ..core.record import RecordBuilder, fnv1a64
from ..core.schemas import GAUGE, Schema, part_key_of, shard_key_of
from ..parallel.shardmapper import ShardMapper
from ..rules.spec import RULE_LABEL
from ..utils.metrics import (FILODB_GATEWAY_INGESTED_ROWS,
                             FILODB_GATEWAY_PARSE_ERRORS,
                             FILODB_RULES_SPOOF_REJECTS,
                             FILODB_SWALLOWED_ERRORS, registry)
from ..utils.tracing import SPAN_GATEWAY_PUBLISH, span

log = logging.getLogger("filodb_tpu_torch.gateway")


class InfluxParseError(ValueError):
    pass


def _split_unescaped(s: str, sep: str) -> list[str]:
    out, cur, i = [], [], 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            cur.append(s[i + 1])
            i += 2
            continue
        if c == sep:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(c)
        i += 1
    out.append("".join(cur))
    return out


def _parse_head_fast(head: str) -> tuple[str, dict[str, str]]:
    """``measurement,tag=v,...`` -> (measurement, tags) for escape-free
    lines (shared by parse_influx_line's fast path and the gateway's
    route-memo miss path — one implementation, no drift)."""
    parts = head.split(",")
    tags = {}
    for t in parts[1:]:
        k, eq, v = t.partition("=")
        if not eq:
            raise InfluxParseError(f"bad tag {t!r}")
        tags[k] = v
    return parts[0], tags


def _parse_fields_fast(seg: str) -> dict[str, float]:
    """``k=1.5,k2=3i`` -> field dict for escape-free lines."""
    fields = {}
    for fkv in seg.split(","):
        k, eq, v = fkv.partition("=")
        if not eq:
            raise InfluxParseError(f"bad field {fkv!r}")
        try:
            fields[k] = float(v)
        except ValueError:
            try:
                fields[k] = float(v.rstrip("iu"))
            except ValueError:
                raise InfluxParseError(f"bad field value {v!r}") from None
    return fields


def parse_influx_line(line: str) -> tuple[str, dict[str, str], dict[str, float], int]:
    """``measurement,tag=v,... field=1.5,... timestamp_ns`` -> parts
    (ref: InfluxProtocolParser.parse)."""
    line = line.strip()
    if not line or line.startswith("#"):
        raise InfluxParseError("empty/comment line")
    if "\\" not in line and '"' not in line:
        # fast path (the overwhelmingly common shape): no escapes, no string
        # fields — C-speed str.split instead of the per-character scanner
        segs = line.split(" ")
        if len(segs) < 2 or len(segs) > 3 or not segs[1]:
            raise InfluxParseError(f"bad line: {line!r}")
        measurement, tags = _parse_head_fast(segs[0])
        fields = _parse_fields_fast(segs[1])
        try:
            ts_ns = int(segs[2]) if len(segs) > 2 and segs[2] else 0
        except ValueError:
            raise InfluxParseError(f"bad timestamp {segs[2]!r}") from None
        return measurement, tags, fields, ts_ns
    # escaped/quoted general path
    segs = []
    cur, i = [], 0
    while i < len(line):
        c = line[i]
        if c == "\\" and i + 1 < len(line):
            cur.append(line[i]); cur.append(line[i + 1]); i += 2; continue
        if c == " ":
            segs.append("".join(cur)); cur = []
        else:
            cur.append(c)
        i += 1
    segs.append("".join(cur))
    if len(segs) < 2:
        raise InfluxParseError(f"bad line: {line!r}")
    head = _split_unescaped(segs[0], ",")
    measurement = head[0]
    tags = {}
    for t in head[1:]:
        if "=" not in t:
            raise InfluxParseError(f"bad tag {t!r}")
        k, v = t.split("=", 1)
        tags[k] = v
    fields = {}
    for fkv in _split_unescaped(segs[1], ","):
        if "=" not in fkv:
            raise InfluxParseError(f"bad field {fkv!r}")
        k, v = fkv.split("=", 1)
        v = v.rstrip("iu")
        if v.startswith('"'):
            continue  # string fields are not time series samples
        fields[k] = float(v)
    try:
        ts_ns = int(segs[2]) if len(segs) > 2 and segs[2] else 0
    except ValueError:
        raise InfluxParseError(f"bad timestamp {segs[2]!r}") from None
    return measurement, tags, fields, ts_ns


class _ConnState:
    """Per-connection parse/batch state: builders never contend across
    connections, and each builder's hash-memo stays hot for the connection's
    lifetime. ``lock`` serializes the handler thread against the timed
    flusher (the only other toucher)."""

    __slots__ = ("builders", "counts", "first_add", "lock")

    def __init__(self):
        self.builders: dict[int, RecordBuilder] = {}
        self.counts: dict[int, int] = {}
        self.first_add: dict[int, float | None] = {}
        self.lock = threading.Lock()


class GatewayServer:
    """TCP line-protocol listener publishing shard-batched containers."""

    def __init__(self, publish, num_shards: int = 4, spread: int = 0,
                 schema: Schema = GAUGE, host="127.0.0.1", port=0,
                 flush_lines: int = 1000, flush_interval_ms: int = 500,
                 strict: bool = False, route_memo_max: int = 1 << 18,
                 governor=None, series_known=None):
        """``publish(shard, container)`` delivers a built container (e.g. to a
        FileBus per shard or straight into a memstore). ``flush_lines`` is the
        size bound per (connection, shard) batch; ``flush_interval_ms`` the
        time bound (0 disables the timed flusher). ``strict`` re-raises
        malformed lines instead of counting them (tests); the default counts
        drops in ``filodb_gateway_parse_errors`` and keeps the latest offender
        in ``last_parse_error``.

        ``governor``/``series_known(shard, key) -> bool``: the cardinality
        fast-shed edge (core/cardinality.py). A line that would BIRTH a new
        series for an over-quota tenant sheds here with the typed
        SeriesQuotaExceeded RETRY (strict mode) or a counted drop — but only
        when ``series_known`` proves the series is new; an unprovable case
        passes through and the shard-level limiter stays authoritative, so
        the edge can never drop samples for an existing series."""
        self.publish = publish
        self.mapper = ShardMapper(num_shards, spread)
        self.schema = schema
        self.flush_lines = flush_lines
        self.flush_interval_ms = flush_interval_ms
        self.strict = strict
        self._governor = governor
        self._series_known = series_known
        # optional shutdown hook: stop() calls it after the final builder
        # flush so windowed bus publishers drain their sub-window remainder
        # (no acked-but-unflushed lines on shutdown); owners wire it to
        # e.g. ``lambda: [b.flush_publishes() for b in buses]``
        self.bus_drain = None
        # (measurement+tags line prefix) -> {field name -> (shard, labels,
        # canonical key tuple)}: the hash/dict work dominates the per-line
        # cost, and real scrape traffic repeats series — bounded, reset
        # wholesale under pathological unique-tag floods
        self._routes: dict[str, dict] = {}
        self._memo_lock = threading.Lock()
        self._memo_max = route_memo_max
        self._publish_locks = [threading.Lock() for _ in range(num_shards)]
        self._state = _ConnState()          # direct ingest_line() callers
        self._conn_states: set[_ConnState] = set()
        self._conns: set = set()            # live client sockets (stop sever)
        self._states_lock = threading.Lock()
        self._stop_ev = threading.Event()
        self._flusher: threading.Thread | None = None
        self._serve_thread: threading.Thread | None = None
        self._parse_errors = registry.counter(FILODB_GATEWAY_PARSE_ERRORS)
        # rows, not lines: a line with F fields contributes F samples
        self._rows = registry.counter(FILODB_GATEWAY_INGESTED_ROWS)
        self.last_parse_error: str | None = None
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                st = _ConnState()
                with outer._states_lock:
                    outer._conn_states.add(st)
                    outer._conns.add(self.request)
                try:
                    # chunked reads + ONE decode per block: per-line
                    # readline/decode overhead is measurable at 100k lines/s
                    pending = b""
                    while True:
                        chunk = self.rfile.read1(1 << 16)
                        if not chunk:
                            break
                        pending += chunk
                        if b"\n" not in chunk:
                            continue
                        block, _, pending = pending.rpartition(b"\n")
                        for line in block.decode(errors="replace").split("\n"):
                            if line:
                                outer.ingest_line(line, st)
                    if pending.strip():
                        outer.ingest_line(pending.decode(errors="replace"), st)
                except (InfluxParseError, SeriesQuotaExceeded):
                    # strict mode: the bad line drops the connection — count
                    # the severed connection so operators see the drop rate
                    registry.counter(FILODB_SWALLOWED_ERRORS,
                                     {"site": "gateway-strict-abort"}) \
                        .increment()
                finally:
                    with outer._states_lock:
                        outer._conn_states.discard(st)
                        outer._conns.discard(self.request)
                    outer.flush_state(st)

        self._server = socketserver.ThreadingTCPServer((host, port), Handler)
        self._server.daemon_threads = True

    @property
    def port(self):
        return self._server.server_address[1]

    def start(self):
        self._serve_thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name="gw-serve")
        self._serve_thread.start()
        if self.flush_interval_ms and self._flusher is None:
            self._flusher = threading.Thread(target=self._flush_loop,
                                             daemon=True, name="gw-flusher")
            self._flusher.start()
        return self

    def stop(self):
        """Deterministic teardown: stop accepting, release the listening
        socket, JOIN both threads (bounded) so a caller that restarts a
        gateway on the same port never races the old acceptor, then FLUSH —
        every connection's pending builders publish, and ``bus_drain``
        drains the windowed publisher — so a stopped gateway holds no
        accepted-but-unpublished lines."""
        self._stop_ev.set()
        self._server.shutdown()
        # the accept-backlog race: a client can connect, send, and close
        # entirely between two serve_forever polls — its lines are TCP-ACKed
        # (accepted, from the client's view) but no handler ever ran, and
        # closing the listener now would drop them. Drain the backlog
        # synchronously: each pending connection runs its handler inline
        # under a bounded read timeout, so a still-open straggler cannot
        # wedge shutdown while fully-sent lines always land.
        while True:
            try:
                ready, _, _ = select.select([self._server.socket], [], [],
                                            0.05)
            except (OSError, ValueError):
                break           # listener already unusable: nothing pending
            if not ready:
                break
            try:
                request, addr = self._server.socket.accept()
            except OSError:
                break
            request.settimeout(1.0)
            try:
                self._server.finish_request(request, addr)
            except Exception:  # noqa: BLE001 — a straggler's read timeout or
                # reset must not abort shutdown; whatever it sent in time
                # already flushed via the handler's exit path
                log.warning("gateway backlog drain handler failed",
                            exc_info=True)
            finally:
                self._server.shutdown_request(request)
        self._server.server_close()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=3)
            self._serve_thread = None
        if self._flusher is not None:
            self._flusher.join(timeout=3)
            self._flusher = None
        # connection handlers flush their own state on exit: give in-flight
        # bursts a short grace, then SEVER lingering client sockets (an
        # idle keep-alive connection would otherwise hold its handler in
        # read() forever — nothing may ingest after stop() returns) and
        # wait for the unblocked handlers to run their exit flush
        self._wait_states_drained(1.0)
        with self._states_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass    # racing close: the connection is already gone
        self._wait_states_drained(3.0)
        self.flush()
        if self.bus_drain is not None:
            try:
                self.bus_drain()
            except Exception:  # noqa: BLE001 — shutdown must complete; the
                # drain fault is logged, not fatal (the bus owner's own
                # close path retries)
                log.warning("gateway bus drain failed on stop", exc_info=True)

    def _wait_states_drained(self, timeout_s: float) -> None:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._states_lock:
                if not self._conn_states:
                    return
            time.sleep(0.01)

    def _all_states(self) -> list[_ConnState]:
        with self._states_lock:
            return [self._state, *self._conn_states]

    def _flush_loop(self) -> None:
        """Time-bound flush: a low-rate shard's rows land within roughly one
        interval instead of waiting out ``flush_lines``."""
        iv = self.flush_interval_ms / 1000.0
        while not self._stop_ev.wait(iv / 2):
            now = time.monotonic()
            for st in self._all_states():
                try:
                    self._flush_ripe(st, now, iv)
                except Exception:  # noqa: BLE001 — ANY publish-callback fault
                    # must not kill the timed flusher for the gateway's
                    # lifetime; the size bound and the next tick still flush
                    log.warning("gateway timed flush failed", exc_info=True)

    def _flush_ripe(self, st: _ConnState, now: float = 0.0,
                    min_age_s: float = 0.0) -> None:
        """Build + publish pending shards (all when ``min_age_s`` <= 0, else
        only those whose oldest pending row is at least that old). Build and
        publish stay under ONE state lock hold: a built container must reach
        the bus before the state's next build for the same shard, or the
        store drops the older container's rows as out-of-order."""
        with st.lock:
            for shard, b in st.builders.items():
                if not st.counts.get(shard):
                    continue
                if min_age_s > 0:
                    t0 = st.first_add.get(shard)
                    if t0 is None or now - t0 < min_age_s:
                        continue
                container = b.build()
                # reset BEFORE publish: a publish fault must not leave a
                # stale count over the drained builder (the next flush would
                # emit an empty container); the fault drops this container's
                # rows — the gateway edge is lossy on publish failure
                st.counts[shard] = 0
                st.first_add[shard] = None
                self._publish(shard, container)

    def _publish(self, shard: int, container) -> None:
        # publish serializes per shard (and per connection via the caller's
        # state lock) — parse/batch of other connections proceeds
        # concurrently. The span is per built CONTAINER (≤ flush_lines
        # rows), never per line: it roots the ingest trace that the
        # windowed broker publish continues over PUBLISH_BATCH when the
        # window fills inside this call
        with span(SPAN_GATEWAY_PUBLISH, shard=shard, rows=len(container)):
            with self._publish_locks[shard]:
                self.publish(shard, container)
        self._rows.increment(len(container))

    def _resolve_route(self, head: str | None, measurement: str | None,
                       tags: dict | None, fname: str):
        """(shard, labels, canonical-key) for one (series, field) — the slow
        path behind the route memo."""
        if measurement is None:
            measurement, tags = _parse_head_fast(head)
        metric = measurement if fname == "value" else f"{measurement}_{fname}"
        labels = dict(tags)
        labels["_metric_"] = metric
        labels.setdefault("_ws_", "default")
        labels.setdefault("_ns_", "default")
        opts = self.schema.options
        shard = self.mapper.shard_of(
            fnv1a64(shard_key_of(labels, opts)) & 0xFFFFFFFF,
            fnv1a64(part_key_of(labels, opts)))
        if self._governor is not None:
            # a memo miss is the only place a NEW series can first appear:
            # shed it typed (RETRY) when the tenant is over quota AND the
            # series is provably unknown — never on an unprovable probe
            tenant = self._governor.tenant_of(labels)
            if self._governor.over_limit(tenant) \
                    and self._series_known is not None \
                    and not self._series_known(shard, labels):
                self._governor.count_shed("gateway", tenant)
                raise SeriesQuotaExceeded(
                    tenant, retry_after_s=self._governor.retry_after_s)
        route = (shard, labels, tuple(sorted(labels.items())))
        if head is not None:
            with self._memo_lock:
                if len(self._routes) >= self._memo_max \
                        and head not in self._routes:
                    self._routes.clear()
                self._routes.setdefault(head, {})[fname] = route
        return route

    def ingest_line(self, line: str, state: _ConnState | None = None) -> None:
        st = state if state is not None else self._state
        line = line.strip()
        if not line:
            return
        head = routes = None
        if "\\" not in line and '"' not in line:
            sp = line.find(" ")
            if sp > 0:
                head = line[:sp]
                routes = self._routes.get(head)
        try:
            if routes is not None:
                # memo hit: only fields + timestamp still need parsing —
                # slices off the already-located head, no split list
                rest = line[sp + 1:]
                sp2 = rest.find(" ")
                if sp2 < 0:
                    fseg, tseg = rest, ""
                else:
                    fseg, tseg = rest[:sp2], rest[sp2 + 1:]
                    if not fseg or " " in tseg:
                        raise InfluxParseError(f"bad line: {line!r}")
                fields = _parse_fields_fast(fseg)
                try:
                    ts_ns = int(tseg) if tseg else 0
                except ValueError:
                    raise InfluxParseError(f"bad timestamp {tseg!r}") from None
                measurement = tags = None
            else:
                measurement, tags, fields, ts_ns = parse_influx_line(line)
                if RULE_LABEL in tags:
                    # reserved provenance tag: only the rules subsystem's
                    # deterministic-pub-id publisher may write it (strict
                    # re-raises; otherwise a counted drop like any bad
                    # line). A spoofed head never reaches the route memo,
                    # so every such line funnels through this parse path.
                    registry.counter(FILODB_RULES_SPOOF_REJECTS,
                                     {"site": "gateway"}).increment()
                    raise InfluxParseError(
                        f"tag {RULE_LABEL!r} is reserved for "
                        "recording-rule output and cannot be ingested "
                        "externally")
        except InfluxParseError:
            if self.strict:
                raise
            self._parse_errors.increment()
            self.last_parse_error = line[:256]   # one sampled offender
            return
        ts_ms = ts_ns // 1_000_000 if ts_ns else 0
        with st.lock:
            for fname, fval in fields.items():
                route = None if routes is None else routes.get(fname)
                if route is None:
                    try:
                        route = self._resolve_route(head, measurement, tags,
                                                    fname)
                    except SeriesQuotaExceeded:
                        if self.strict:
                            raise       # typed RETRY to the caller
                        continue        # counted; only the NEW series drops
                shard, labels, key = route
                b = st.builders.get(shard)
                if b is None:
                    b = st.builders[shard] = RecordBuilder(self.schema)
                    st.counts[shard] = 0
                b.add_interned(key, labels, ts_ms, fval)
                n = st.counts[shard] + 1
                if n == 1:
                    st.first_add[shard] = time.monotonic()
                if n >= self.flush_lines:
                    container = b.build()
                    # reset before publish (see _flush_ripe), then publish
                    # INSIDE the state lock: per-series publish order must
                    # match build order
                    n = 0
                    st.counts[shard] = 0
                    st.first_add[shard] = None
                    self._publish(shard, container)
                st.counts[shard] = n

    def flush_state(self, st: _ConnState) -> None:
        self._flush_ripe(st)

    def flush(self) -> None:
        """Flush every connection's pending batches (and the direct-call
        state) — shutdown / test barrier."""
        for st in self._all_states():
            self._flush_ripe(st)
