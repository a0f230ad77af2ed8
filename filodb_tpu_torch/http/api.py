"""Prometheus-compatible HTTP API of one node.

Port of ``filodb_tpu/http/api.py`` (ref: http/src/main/scala/filodb/http/
PrometheusApiRoute.scala:36-90 for /promql/{dataset}/api/v1/query_range and
query, ClusterApiRoute.scala for shard status, HealthRoute.scala for
/__health; responses in the Prometheus model, PrometheusModel.scala), with
the cross-node ``/exec/{dataset}`` route a peer ships plan subtrees to
(ref: PlanDispatcher.scala's receiving side): the subtree runs on this
node's card and its partials go back in the wire's tagged binary.

Routes: query_range and query (``tenant``, ``resolution``), /exec (one
envelope or a batch), /api/v1/epochs, labels, label values and series
(``local=1`` marks a peer's fan-out leg), /metrics, /__health,
/api/v1/cluster/status with the server's elasticity extras, the live
shard moves (POST /api/v1/cluster/rebalance and /adopt), the debug pages
(traces, slow queries, the sampling profiler, the fragment cache),
/api/v1/subscribe, Prometheus remote read and write (POST
/promql/{dataset}/api/v1/read|write: snappy-framed protobuf through the
port's own codec, ``promql/remote_storage.py``) and the rules surface
(/api/v1/rules, /api/v1/alerts). Errors map as the reference's do:
422 bad data (a remote write carrying the reserved ``__rule__`` label
included), 400 a malformed remote-storage body, 501 a remote write without
a writer, 503 with Retry-After on an admission shed, 503 when the
scheduler or the peer-leg budget is saturated or a peer's breaker is open,
504 on a timeout, 429 from the cardinality governor and, with
Retry-After, from the broker's backpressure.
"""

from __future__ import annotations

import dataclasses
import json
import re
import time
import threading
import traceback
from contextlib import contextmanager
from concurrent.futures import TimeoutError as FuturesTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ..core import filters as F
from ..core.cardinality import SeriesQuotaExceeded
from ..ingest.broker import BrokerRetry
from ..promql import remote
from ..promql.parser import ParseError, Parser
from ..promql.remote_storage import DecodeError
from ..query import wire
from ..query.engine import QueryEngine, slow_query_log
from ..query.incremental import data_lead_ms, poll_increment
from ..query.rangevector import QueryError
from ..query.rangevector import fmt_value as _fmt
from ..query.scheduler import AdmissionRejected, Priority, SchedulerBusy
from ..utils.metrics import (FILODB_QUERY_SUBSCRIBE_INCREMENTS,
                             FILODB_SHARD_LOCK_CONTENTIONS,
                             FILODB_SHARD_LOCK_LONG_HOLDS,
                             FILODB_SHARD_NUM_SERIES, registry)
from ..utils.tracing import (SPAN_QUERY_SERVE, SPAN_QUERY_SUBSCRIBE,
                             SPAN_REMOTE_WRITE, span,
                             tracer)


def matrix_to_prom_json(result) -> dict:
    """QueryResult -> Prometheus /api/v1 response data (ref: PrometheusModel
    convertSampl... matrix/vector conversion; values are [sec, "str"] pairs)."""
    out = []
    vector = result.result_type == "vector"
    for key, ts, vals in result.matrix.iter_series():
        metric = dict(key.labels)
        if "_metric_" in metric:
            metric["__name__"] = metric.pop("_metric_")
        if vector:
            out.append({"metric": metric,
                        "value": [ts[-1] / 1000.0, _fmt(vals[-1])]})
        else:
            out.append({"metric": metric,
                        "values": [[t / 1000.0, _fmt(v)] for t, v in zip(ts, vals)]})
    return {"resultType": "vector" if vector else "matrix", "result": out}


def _parse_time(v: str) -> int:
    """Prometheus time param (unix seconds, possibly float) -> epoch ms."""
    return int(float(v) * 1000)


def _parse_step(v: str) -> int:
    m = re.fullmatch(r"(\d+(?:\.\d+)?)(ms|[smhdwy])?", v)
    if not m:
        raise ValueError(f"bad step {v!r}")
    mult = {"ms": 1, None: 1000, "s": 1000, "m": 60_000, "h": 3_600_000,
            "d": 86_400_000, "w": 604_800_000, "y": 31_536_000_000}[m.group(2)]
    return int(float(m.group(1)) * mult)


def _selector_to_filters(sel: str):
    expr = Parser(sel).parse()
    filters = list(expr.matchers)
    if expr.metric:
        filters.append(F.Equals("_metric_", expr.metric))
    # __name__ aliases the internal metric label for EVERY matcher kind —
    # a regex/not-equals metric matcher left as __name__ would match nothing
    return [dataclasses.replace(f, label="_metric_") if f.label == "__name__" else f
            for f in filters]


class FiloHttpServer:
    """Stdlib threaded HTTP server hosting the Prometheus API for one or more
    datasets (ref: FiloHttpServer / akka-http binding). Bind port 0 for a
    free port (``.port`` reads it back); ``stop()`` shuts the acceptor
    down, closes the socket and joins the serving thread."""

    def __init__(self, engines: dict[str, QueryEngine], host="127.0.0.1",
                 port=8080, cluster=None, writers: dict | None = None,
                 scheduler=None, cluster_ops: dict | None = None,
                 subscribe_poll_s: float = 0.1,
                 governors: dict | None = None):
        """``writers``: dataset -> callable(per_shard: dict[shard, container])
        receiving remote-write batches atomically (bus publish or direct
        ingest). ``scheduler``: optional QueryScheduler — query work runs
        through its priority lanes (ref: QueryActor priority mailbox)
        instead of directly on the HTTP handler thread. ``cluster``: the
        ShardManager /api/v1/cluster/status reports.
        ``cluster_ops``: optional elasticity hooks from the FiloServer —
        ``extra()`` enriches /api/v1/cluster/status (membership table,
        epochs, last failover), ``rebalance(dataset, shard, to)`` and
        ``adopt(dataset, shard)`` drive live shard moves."""
        self.engines = engines
        self.cluster = cluster
        self.writers = writers or {}
        self.scheduler = scheduler
        self.cluster_ops = cluster_ops or {}
        # dataset -> (CardinalityGovernor, series_known) for the remote-write
        # fast-shed edge (new series of over-quota tenants answer 429 +
        # Retry-After AFTER the kept samples published)
        self.governors = governors or {}
        # rules subsystem handle (RulesManager): serves /api/v1/rules and
        # /api/v1/alerts when the FiloServer configured rule groups (404
        # while None)
        self.rules = None
        # debug-plane profiler slot (/api/v1/debug/profile start/stop/
        # report); FiloServer hands over its config-started SimpleProfiler
        self.profiler = None
        self._profiler_lock = threading.Lock()
        # admission control for peer fan-out legs (/exec, read?local=1):
        # they must NOT queue behind the scheduler's QUERY lane (the root
        # request holds a QUERY worker blocked on this response — two
        # saturated nodes would deadlock), but an unbounded handler-thread
        # free-for-all is a DoS vector; a bounded semaphore gives both
        self._leg_sem = threading.BoundedSemaphore(16)
        # streaming subscriptions (/api/v1/subscribe): long-poll waits and
        # chunked streams occupy their handler thread for up to the request
        # timeout — a separate bounded semaphore keeps them from starving
        # the peer-leg budget or becoming a thread-exhaustion DoS
        self._sub_sem = threading.BoundedSemaphore(32)
        # watermark poll cadence between subscription increments
        # (query.subscribe_poll)
        self._subscribe_poll_s = max(float(subscribe_poll_s), 0.005)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _send(self, code: int, payload: dict, headers: dict | None = None):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                try:
                    outer._route(self)
                except wire.PeerCircuitOpen as e:
                    # a browned-out peer's breaker shed the dispatch fast:
                    # unavailable (retryable), NOT a bad query
                    self._send(503, {"status": "error",
                                     "errorType": "unavailable",
                                     "error": str(e)})
                except AdmissionRejected as e:
                    # cost-based admission shed BEFORE execution: retryable
                    # overload, with the controller's hint as Retry-After —
                    # an honored-backoff client lands every query
                    self._send(503, {"status": "error",
                                     "errorType": "unavailable",
                                     "error": str(e)},
                               headers={"Retry-After": str(max(
                                   1, int(e.retry_after_s + 0.999)))})
                except (QueryError, ParseError) as e:
                    self._send(422, {"status": "error", "errorType": "bad_data",
                                     "error": str(e)})
                except SeriesQuotaExceeded as e:
                    # cardinality governance: NEW series of an over-quota
                    # tenant were shed — existing-series samples landed
                    # before this was raised, so a resend after churn (or a
                    # raised quota) loses nothing (duplicates dedup at the
                    # store). 429 like backpressure, distinct errorType.
                    self._send(429, {"status": "error",
                                     "errorType": "too_many_series",
                                     "error": str(e)},
                               headers={"Retry-After": str(max(
                                   1, int(e.retry_after_s + 0.999)))})
                except BrokerRetry as e:
                    # ingest backpressure (quorum stall / queue overload):
                    # retryable, with the broker's hint as Retry-After —
                    # remote-write clients re-send the batch after it
                    self._send(429, {"status": "error", "errorType": "busy",
                                     "error": str(e)},
                               headers={"Retry-After": str(max(
                                   1, int(e.retry_after_s + 0.999)))})
                except SchedulerBusy as e:
                    self._send(503, {"status": "error", "errorType": "unavailable",
                                     "error": str(e)})
                except FuturesTimeout:
                    self._send(504, {"status": "error", "errorType": "timeout",
                                     "error": "query timed out"})
                except Exception as e:  # noqa: BLE001
                    traceback.print_exc()
                    self._send(500, {"status": "error", "errorType": "internal",
                                     "error": str(e)})

            do_POST = do_GET

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self):
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        """Deterministic teardown: stop the acceptor, release the listening
        socket, join the serve thread with a timeout, and stop the debug
        plane's profiler — a sampler started via /api/v1/debug/profile
        lives only on this server and must not outlive it (stop() is
        idempotent, so a config-started profiler the FiloServer also stops
        is fine)."""
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=3)
            self._thread = None
        with self._profiler_lock:
            prof, self.profiler = self.profiler, None
        if prof is not None:
            prof.stop()

    def _sync_shard_stats(self) -> None:
        """Refresh per-shard ingest/eviction gauges on each scrape (ref:
        TimeSeriesShardStats Kamon counters, TimeSeriesShard.scala:36-97)."""
        # snapshot: a downsample serving refresh adds family engines
        # concurrently (standalone ds_serve_loop)
        for ds, e in list(self.engines.items()):
            for s in e.memstore.shards_of(ds):
                tags = {"dataset": ds, "shard": str(s.shard_num)}
                for k, v in dataclasses.asdict(s.stats).items():
                    # dynamic family, declared as filodb_shard_* in
                    # METRICS_SPEC (one gauge per IngestStats field)
                    registry.gauge(f"filodb_shard_{k}", tags).update(float(v))
                registry.gauge(FILODB_SHARD_NUM_SERIES, tags).update(
                    float(s.num_series))
                if hasattr(s.lock, "contentions"):   # TimedRLock diagnostics
                    registry.gauge(FILODB_SHARD_LOCK_CONTENTIONS, tags) \
                        .update(float(s.lock.contentions))
                    registry.gauge(FILODB_SHARD_LOCK_LONG_HOLDS, tags) \
                        .update(float(s.lock.long_holds))

    @contextmanager
    def _leg_guard(self):
        """Bounded admission for peer fan-out legs running on the handler
        thread; saturation sheds with 503 like the scheduler would."""
        if not self._leg_sem.acquire(timeout=30.0):
            raise SchedulerBusy("peer-leg capacity saturated; retry later")
        try:
            yield
        finally:
            self._leg_sem.release()

    def _run(self, fn, priority: Priority):
        """Run query work through the priority scheduler when configured."""
        if self.scheduler is None:
            return fn()
        return self.scheduler.run(fn, priority)

    # -- routing -------------------------------------------------------------

    def _route(self, h) -> None:
        url = urlparse(h.path)
        path = url.path
        qs = parse_qs(url.query)
        q = {k: v[0] for k, v in qs.items()}

        # cross-node plan dispatch: a peer ships an ExecPlan subtree for a
        # shard this node owns; partials go back as tagged binary (ref:
        # PlanDispatcher.scala — the receiving coordinator runs the subtree)
        m = re.fullmatch(r"/exec/([^/]+)", path)
        if m and h.command == "POST":
            self._exec_plan(h, m.group(1))
            return

        # remote read/write carry snappy-compressed protobuf bodies — handle
        # them before the urlencoded body parsing below consumes rfile
        m = re.fullmatch(r"/promql/([^/]+)/api/v1/(read|write)", path)
        if m and h.command == "POST":
            # strict marker: ONLY local=1 means "peer fan-out leg". A client
            # sending local=0 (or garbage) must get the full cluster answer,
            # not a silently partial local-only one
            self._remote_storage(h, m.group(1), m.group(2),
                                 local=q.get("local") == "1")
            return

        if h.command == "POST":
            ln = int(h.headers.get("Content-Length") or 0)
            if ln:
                body = h.rfile.read(ln).decode()
                bqs = parse_qs(body)
                q.update({k: v[0] for k, v in bqs.items()})
                for k, v in bqs.items():
                    qs.setdefault(k, []).extend(x for x in v
                                                if x not in qs.get(k, []))

        if path == "/__health":
            h._send(200, {"status": "healthy"})
            return
        if path == "/metrics":
            self._sync_shard_stats()
            body = registry.expose_prometheus().encode()
            h.send_response(200)
            h.send_header("Content-Type", "text/plain; version=0.0.4")
            h.send_header("Content-Length", str(len(body)))
            h.end_headers()
            h.wfile.write(body)
            return
        if path in ("/api/v1/rules", "/api/v1/alerts"):
            # Prometheus rules surface: the evaluator's view of every
            # group/rule (health, last eval, alert instances) — served on
            # the handler thread like /__health (index-free snapshot reads)
            if self.rules is None:
                h._send(404, {"status": "error",
                              "error": "no rule groups configured "
                                       "(rules.groups)"})
                return
            data = (self.rules.rules_payload() if path.endswith("/rules")
                    else self.rules.alerts_payload())
            h._send(200, {"status": "success", "data": data})
            return
        if path in ("/api/v1/cluster/rebalance", "/api/v1/cluster/adopt") \
                and h.command == "POST":
            # live shard moves (cluster/: flush→handoff→catch-up→cutover);
            # rebalance POSTs to the current owner, adopt is its
            # server-to-server receiving leg
            which = path.rsplit("/", 1)[1]
            hook = self.cluster_ops.get(which)
            if hook is None:
                h._send(404, {"status": "error",
                              "error": f"no {which} hook on this server "
                                       "(standalone cluster mode only)"})
                return
            try:
                if which == "rebalance":
                    data = hook(q["dataset"], int(q["shard"]), q["to"])
                else:
                    data = hook(q["dataset"], int(q["shard"]))
            except KeyError as e:
                raise QueryError(f"missing {which} parameter: {e}") from None
            except ValueError as e:
                raise QueryError(f"bad {which} parameter: {e}") from None
            h._send(200, {"status": "success", "data": data})
            return
        if path == "/api/v1/cluster/status" or path.startswith("/api/v1/cluster/"):
            h._send(200, {"status": "success", "data": self._cluster_status()})
            return
        if path.startswith("/api/v1/debug/"):
            self._debug(h, path.removeprefix("/api/v1/debug/"), q)
            return

        m = re.fullmatch(r"/promql/([^/]+)/api/v1/(query_range|query)", path)
        if m:
            engine = self.engines.get(m.group(1))
            if engine is None:
                h._send(404, {"status": "error", "error": f"no dataset {m.group(1)}"})
                return
            # tenant identity for admission quotas: header wins over the
            # query param (proxies inject the header; dashboards the param)
            tenant = h.headers.get("X-Filo-Tenant") or q.get("tenant") or None
            # &resolution=: per-query retention routing override ("raw" /
            # "1m" / ...) — validated by the engine against the configured
            # set (unknown values fail 422 with the available list)
            resolution = q.get("resolution") or None
            if m.group(2) == "query_range":
                res = self._run(
                    lambda: engine.query_range(q["query"], _parse_time(q["start"]),
                                               _parse_time(q["end"]),
                                               _parse_step(q["step"]),
                                               tenant=tenant,
                                               resolution=resolution),
                    Priority.QUERY)
            else:
                res = self._run(
                    lambda: engine.query_instant(q["query"],
                                                 _parse_time(q["time"]),
                                                 tenant=tenant,
                                                 resolution=resolution),
                    Priority.QUERY)
            body = {"status": "success", "data": matrix_to_prom_json(res)}
            if res.stats is not None:
                # per-query resource accounting, aggregated across every
                # participating shard and peer (reference QueryStats shape)
                body["stats"] = res.stats.to_dict()
            h._send(200, body)
            return

        m = re.fullmatch(r"/promql/([^/]+)/api/v1/epochs", path)
        if m:
            engine = self.engines.get(m.group(1))
            if engine is None:
                h._send(404, {"status": "error",
                              "error": f"no dataset {m.group(1)}"})
                return
            # ingest-watermark probe for peer result-cache validation:
            # local shards only by construction (each node reports its own
            # counters), index-free and cheap — served on the handler
            # thread like /__health so it never queues behind query work.
            # log=1 (fragment-cache probes) adds each shard's recent
            # (epoch, min affected ts) bump log — the per-step validity
            # substrate (query/incremental.stable_before)
            if q.get("log") == "1":
                data = {}
                for s in engine.memstore.shards_of(engine.dataset):
                    ep, lg = s.epoch_state()
                    data[str(s.shard_num)] = [ep, [[e, m_] for e, m_ in lg]]
            else:
                data = {str(s.shard_num): s.data_epoch
                        for s in engine.memstore.shards_of(engine.dataset)}
            h._send(200, {"status": "success", "data": data})
            return

        m = re.fullmatch(r"/promql/([^/]+)/api/v1/subscribe", path)
        if m:
            self._subscribe(h, m.group(1), q)
            return

        # local=1 (strictly) marks a peer's metadata fan-out request: answer
        # from local shards only (stops mutual-recursion between nodes);
        # local=0 or malformed values mean a normal client request
        local_only = q.get("local") == "1"
        # optional match[] selectors restrict labels/values to matching
        # series; REPEATED selectors union (Prometheus API semantics)
        mfilter_sets = [_selector_to_filters(sel)
                        for sel in qs.get("match[]", [])]
        m = re.fullmatch(r"/promql/([^/]+)/api/v1/labels", path)
        if m:
            engine = self.engines[m.group(1)]

            def fetch_names():
                out: set = set()
                for filt in (mfilter_sets or [None]):
                    out.update(engine.label_names(filt,
                                                  local_only=local_only))
                # Prometheus surface: the internal metric label renders as
                # __name__ (the series endpoint already maps it; labels
                # must agree so UI discovery works on ds families too)
                return sorted("__name__" if n == "_metric_" else n
                              for n in out)

            h._send(200, {"status": "success",
                          "data": self._run(fetch_names, Priority.METADATA)})
            return
        m = re.fullmatch(r"/promql/([^/]+)/api/v1/label/([^/]+)/values", path)
        if m:
            engine = self.engines[m.group(1)]
            name = m.group(2)
            # Prometheus surface: /labels advertises __name__ for the
            # internal _metric_ label — fold it back so discovered-name
            # lookups hit the index instead of returning empty
            if name == "__name__":
                name = "_metric_"
            top_k = int(q["top_k"]) if q.get("top_k") else None
            # counts=1: peer-leg form — return [value, series_count] pairs so
            # the caller can re-rank ACROSS nodes (a value barely in one
            # node's local top-k may dominate cluster-wide)
            counted = q.get("counts") == "1"

            def fetch_values():
                if top_k is not None or counted:
                    from collections import Counter
                    c: Counter = Counter()
                    for filt in (mfilter_sets or [None]):
                        # element-wise MAX across repeated match[] selectors:
                        # overlapping selectors match the same series, so
                        # summing would count them once per selector and
                        # skew the ranking (never overcounts; exact for the
                        # single-selector peer-leg form)
                        for v, n in engine.label_value_counts(
                                name, filt, top_k=top_k,
                                local_only=local_only).items():
                            c[v] = max(c[v], n)
                    ranked = c.most_common(top_k)
                    return ([[v, n] for v, n in ranked] if counted
                            else [v for v, _ in ranked])
                out: set = set()
                for filt in (mfilter_sets or [None]):
                    out.update(engine.label_values(name, filt,
                                                   local_only=local_only))
                return sorted(out)

            h._send(200, {"status": "success",
                          "data": self._run(fetch_values, Priority.METADATA)})
            return
        m = re.fullmatch(r"/promql/([^/]+)/api/v1/series", path)
        if m:
            engine = self.engines[m.group(1)]
            if not mfilter_sets:
                h._send(400, {"status": "error", "errorType": "bad_data",
                              "error": "series requires at least one match[]"})
                return
            start = _parse_time(q.get("start", "0"))
            end = _parse_time(q.get("end", "9999999999"))

            def fetch_series():
                data = []
                seen = set()
                for filt in mfilter_sets:
                    for labels in engine.series(filt, start, end,
                                                local_only=local_only):
                        d = dict(labels)
                        if "_metric_" in d:
                            d["__name__"] = d.pop("_metric_")
                        key = tuple(sorted(d.items()))
                        if key not in seen:   # selector overlap / takeovers
                            seen.add(key)
                            data.append(d)
                return data

            h._send(200, {"status": "success",
                          "data": self._run(fetch_series, Priority.METADATA)})
            return
        h._send(404, {"status": "error", "error": f"unknown path {path}"})

    # -- debug introspection plane (traces / slow queries / profiler) ---------

    def _debug(self, h, which: str, q: dict) -> None:
        """``/api/v1/debug/{traces,slow_queries,profile}`` — the read
        surface of the observability layer (ref: the reference's Zipkin
        reporter + SimpleProfiler report files; here both are queryable
        in-process)."""
        if which == "traces":
            limit = int(q.get("limit") or 50)
            trace_id = q.get("trace_id")
            if q.get("format") == "zipkin":
                body = tracer.export_zipkin_json(trace_id=trace_id).encode()
                h.send_response(200)
                h.send_header("Content-Type", "application/json")
                h.send_header("Content-Length", str(len(body)))
                h.end_headers()
                h.wfile.write(body)
                return
            h._send(200, {"status": "success",
                          "data": tracer.traces(limit=limit,
                                                trace_id=trace_id)})
            return
        if which == "slow_queries":
            limit = int(q.get("limit") or 0) or None
            h._send(200, {"status": "success",
                          "data": slow_query_log.entries(limit)})
            return
        if which == "profile":
            action = q.get("action", "report")
            with self._profiler_lock:
                prof = self.profiler
                if action == "start":
                    if prof is None:
                        from ..utils.profiler import SimpleProfiler
                        iv = float(q.get("interval_s") or 0.1)
                        prof = self.profiler = SimpleProfiler(iv).start()
                    h._send(200, {"status": "success",
                                  "data": {"running": True}})
                    return
                if action == "stop":
                    report = None
                    if prof is not None:
                        prof.stop()
                        report = prof.report()
                        self.profiler = None
                    h._send(200, {"status": "success",
                                  "data": {"running": False,
                                           "report": report}})
                    return
                h._send(200, {"status": "success",
                              "data": {"running": prof is not None,
                                       "report": prof.report()
                                       if prof is not None else None}})
            return
        if which == "fragment_cache":
            # incremental-serving observability: per-engine stats + the
            # per-entry byte accounting (which fragments are resident, how
            # many steps/series/bytes each holds)
            data = {}
            for ds, e in list(self.engines.items()):
                cache = getattr(e, "fragment_cache", None)
                if cache is not None:
                    data[ds] = {"stats": cache.stats(),
                                "entries": cache.entries_debug()}
            h._send(200, {"status": "success", "data": data})
            return
        h._send(404, {"status": "error",
                      "error": f"unknown debug endpoint {which}"})

    # -- streaming subscriptions (incremental serving) ------------------------

    def _subscribe(self, h, dataset: str, q: dict) -> None:
        """``/promql/{ds}/api/v1/subscribe?query=...&step=...`` — per-step
        increments as the shard ingest watermarks advance, powered by the
        same delta-evaluation machinery as the fragment cache (each
        increment is a tail-extension range query).

        Stateless long-poll by default: the response carries the steps
        newly covered past ``since`` (or an empty increment at ``timeout``)
        plus ``next_since`` for the next request. ``mode=stream`` keeps the
        connection open and writes one ND-JSON line per increment until
        ``timeout`` — the chunked-HTTP form of the same protocol."""
        engine = self.engines.get(dataset)
        if engine is None:
            h._send(404, {"status": "error", "error": f"no dataset {dataset}"})
            return
        expr = q.get("query")
        if not expr:
            raise QueryError("subscribe requires a query= expression")
        step = _parse_step(q["step"]) if q.get("step") else 15_000
        tenant = h.headers.get("X-Filo-Tenant") or q.get("tenant") or None
        if q.get("since"):
            since = _parse_time(q["since"])
        else:
            # default cursor: one step behind the VISIBLE lead's grid point,
            # so the first increment delivers exactly the newest complete
            # step; an empty dataset floors at 0 and the poll loop waits
            # for the first real sample (poll_increment's span clamp keeps
            # the eventual catch-up bounded)
            since = max((data_lead_ms(engine) // step) * step - step, 0)
        wait_s = min(float(q.get("timeout") or 30.0), 300.0)
        stream = q.get("mode") == "stream"
        if not self._sub_sem.acquire(blocking=False):
            raise SchedulerBusy("subscription capacity saturated; retry later")
        try:
            deadline = time.monotonic() + wait_s
            counter = registry.counter(FILODB_QUERY_SUBSCRIBE_INCREMENTS,
                                       {"dataset": dataset})

            def one_increment():
                with span(SPAN_QUERY_SUBSCRIBE, dataset=dataset) as tags:
                    res, nxt = poll_increment(engine, expr, step, since,
                                              tenant=tenant)
                    if res is not None:
                        tags["steps"] = len(res.matrix.out_ts)
                        counter.increment()
                    return res, nxt

            if not stream:
                while True:
                    res, nxt = one_increment()
                    if res is not None or time.monotonic() >= deadline:
                        body = {"status": "success",
                                "since": since / 1000.0,
                                "next_since": nxt / 1000.0,
                                "data": (matrix_to_prom_json(res)
                                         if res is not None else None)}
                        if res is not None and res.stats is not None:
                            body["stats"] = res.stats.to_dict()
                        h._send(200, body)
                        return
                    if time.monotonic() + self._subscribe_poll_s > deadline:
                        time.sleep(max(deadline - time.monotonic(), 0.0))
                    else:
                        time.sleep(self._subscribe_poll_s)
            # chunked-style stream: no Content-Length — one ND-JSON line per
            # increment until the timeout; the connection close delimits
            h.send_response(200)
            h.send_header("Content-Type", "application/x-ndjson")
            h.send_header("Cache-Control", "no-cache")
            h.end_headers()
            while time.monotonic() < deadline:
                try:
                    res, nxt = one_increment()
                except Exception as e:  # noqa: BLE001 — headers are out:
                    # the JSON error handlers can't run; close the stream
                    # with a terminal error line instead
                    err = json.dumps({"error": f"{type(e).__name__}: {e}"})
                    try:
                        h.wfile.write((err + "\n").encode())
                    except (BrokenPipeError, ConnectionError, OSError):
                        pass
                    return
                if res is not None:
                    line = json.dumps(
                        {"since": since / 1000.0, "next_since": nxt / 1000.0,
                         "data": matrix_to_prom_json(res)},
                        separators=(",", ":")) + "\n"
                    try:
                        h.wfile.write(line.encode())
                        h.wfile.flush()
                    except (BrokenPipeError, ConnectionError, OSError):
                        return            # subscriber went away
                    since = nxt
                time.sleep(self._subscribe_poll_s)
        finally:
            self._sub_sem.release()

    # -- cross-node plan execution (ref: PlanDispatcher receiving side) -------

    @staticmethod
    def _trace_ctx(h):
        """Extract the cross-node trace-context header (the one constant
        query/wire.py TRACE_HEADER, which the _dispatch_post sender writes);
        None when absent or malformed (the peer roots its own trace)."""
        raw = h.headers.get(wire.TRACE_HEADER)
        if not raw:
            return None
        try:
            ctx = json.loads(raw)
        except ValueError:
            return None
        return ctx if isinstance(ctx, dict) else None

    def _exec_plan(self, h, dataset: str) -> None:
        engine = self.engines.get(dataset)
        if engine is None:
            h._send(404, {"status": "error", "error": f"no dataset {dataset}"})
            return
        ln = int(h.headers.get("Content-Length") or 0)
        if ln > (16 << 20):
            # plans are a selector + transformer chain — kilobytes; a
            # multi-MB body is malformed or hostile, not a bigger query
            h._send(413, {"status": "error", "errorType": "bad_data",
                          "error": f"exec plan too large ({ln} bytes)"})
            return
        body = h.rfile.read(ln)

        # executes on the HTTP handler thread, NOT the scheduler's QUERY lane:
        # the root query already passed admission control on the caller node
        # and its worker blocks on this response — queueing subtrees behind
        # other root queries would deadlock two saturated nodes against each
        # other (every worker waiting on a peer whose workers all wait back)
        with self._leg_guard(), tracer.activate(self._trace_ctx(h)), \
                span(SPAN_QUERY_SERVE, node=engine.node or "local",
                     dataset=dataset):
            if body[:1] == b"[":
                # batched dispatch: a JSON LIST of envelopes (all leaves a
                # caller routed at this node) -> one multi-part tagged-binary
                # response with per-envelope error classification
                payload = wire.execute_batch(body, engine._ctx())
            else:
                ctx = engine._ctx()
                plan = wire.deserialize_plan(body)
                with ctx.stats.stage("peer_exec"):
                    data = plan.execute(ctx)
                payload = wire.serialize_result(data, stats=ctx.stats)
        h.send_response(200)
        h.send_header("Content-Type", "application/octet-stream")
        h.send_header("Content-Length", str(len(payload)))
        h.end_headers()
        h.wfile.write(payload)

    # -- Prometheus remote storage protocol (snappy + protobuf) ---------------

    def _remote_storage(self, h, dataset: str, which: str,
                        local: bool = False) -> None:
        engine = self.engines.get(dataset)
        if engine is None:
            h._send(404, {"status": "error", "error": f"no dataset {dataset}"})
            return
        body = h.rfile.read(int(h.headers.get("Content-Length") or 0))
        try:
            self._remote_storage_inner(h, engine, dataset, which, body, local)
        except (ValueError, DecodeError) as e:
            # bad snappy framing / protobuf — client error, not a server fault
            h._send(400, {"status": "error", "errorType": "bad_data",
                          "error": f"malformed remote-{which} body: {e}"})

    def _remote_storage_inner(self, h, engine, dataset: str, which: str,
                              body: bytes, local: bool = False) -> None:
        if which == "read":
            # remote read is a full data-reading query — it goes through the
            # scheduler's QUERY lane like query_range, not the handler thread.
            # local=1 marks a peer's fan-out leg: answer from local shards
            # only AND stay on the handler thread (the root request holds a
            # QUERY-lane worker that blocks on this response — queueing the
            # leg behind other root queries would deadlock saturated nodes,
            # same rule as /exec)
            if local:
                with self._leg_guard(), tracer.activate(self._trace_ctx(h)):
                    payload = remote.read_request(body, engine,
                                                  local_only=True)
            else:
                payload = self._run(
                    lambda: remote.read_request(body, engine), Priority.QUERY)
            h.send_response(200)
            h.send_header("Content-Type", "application/x-protobuf")
            h.send_header("Content-Encoding", "snappy")
            h.send_header("Content-Length", str(len(payload)))
            h.end_headers()
            h.wfile.write(payload)
            return
        writer = self.writers.get(dataset)
        if writer is None:
            h._send(501, {"status": "error",
                          "error": f"no remote-write sink configured for {dataset}"})
            return
        schema = engine.memstore._dataset_schema[dataset]
        # the remote-write edge joins the sender's trace when the request
        # carries the trace header; the publish path below (bus/broker)
        # propagates it onward over PUBLISH_BATCH
        gov, known = self.governors.get(dataset) or (None, None)
        with tracer.activate(self._trace_ctx(h)), \
                span(SPAN_REMOTE_WRITE, dataset=dataset):
            per_shard, shed, shed_tenants = remote.write_governed(
                body, schema, engine.mapper, governor=gov, series_known=known)
            writer(per_shard)
        if shed:
            # the kept samples ARE published above — only the over-quota NEW
            # series were dropped; the typed 429 tells the client which
            # tenant(s) and when to retry
            raise SeriesQuotaExceeded(",".join(shed_tenants), shed,
                                      retry_after_s=gov.retry_after_s)
        h.send_response(204)
        h.send_header("Content-Length", "0")
        h.end_headers()

    def _cluster_status(self):
        if self.cluster is None:
            return {"shards": [
                {"dataset": ds, "shard": s.shard_num, "status": "Active",
                 "numSeries": s.num_series}
                for ds, e in list(self.engines.items())
                for s in e.memstore.shards_of(ds)]}
        data = self.cluster.status()
        extra = self.cluster_ops.get("extra")
        if extra is not None:
            # elasticity surface: membership table, epochs, known-bad
            # windows, last failover — merged beside nodes/datasets so the
            # legacy status consumers keep working
            data = {**data, **extra()}
        return data
