"""Recording rules and alerts in the port against the JAX package.

The reference's rules tests (``tests/test_rules.py``) as parity cases: the
same seeded store in both packages, the same rule groups, and the port's
evaluator, scheduler, alert manager, state store and publisher held to the
reference's — derived values bit for bit on f64 stores and within rtol
1e-5 on f32, the same pub-ids, the same alert transitions and webhook
events, the same ``pending_ticks`` under one fake clock, the same
``/api/v1/rules`` and ``/api/v1/alerts`` payloads, and a rules meta
document written by either package resumed by the other. Then the port's
own wiring: exactly-once through a port broker pair under a leader kill,
``rules.streaming`` against the instant path, the spoof guards, and a
``FiloServer`` with ``rules.groups`` end to end on the CPU.
"""

import contextlib
import json
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from filodb_tpu_torch.config import Config
from filodb_tpu_torch.core.record import RecordBuilder
from filodb_tpu_torch.core.schemas import GAUGE
from filodb_tpu_torch.core.store import FileColumnStore
from filodb_tpu_torch.http.api import FiloHttpServer
from filodb_tpu_torch.promql import remote
from filodb_tpu_torch.promql import remote_storage as pb
from filodb_tpu_torch.promql.parser import ParseError
from filodb_tpu_torch.query.rangevector import QueryError
from filodb_tpu_torch.rules import (RULE_LABEL, RulesManager, derive_pub_id,
                                    load_groups)
from filodb_tpu_torch.utils import snappy

from .test_torch_replication import make_pair, mk, sleepless_bus

START = 1_000_000
IV = 10_000
N = 120
E1 = START + 600_000


# -- one fixture, two packages --------------------------------------------------

class Pkg:
    """The names a rules test needs, from the port or from the JAX
    package."""

    def __init__(self, which: str):
        self.which = which
        if which == "port":
            from filodb_tpu_torch import rules
            from filodb_tpu_torch.core import memstore, record, schemas, store
            from filodb_tpu_torch.parallel import shardmapper
            from filodb_tpu_torch.query import engine
            self.kw = {"device": "cpu"}
        else:
            from filodb_tpu import rules
            from filodb_tpu.core import memstore, record, schemas, store
            from filodb_tpu.parallel import shardmapper
            from filodb_tpu.query import engine
            self.kw = {}
        self.rules = rules
        self.memstore, self.record, self.schemas = memstore, record, schemas
        self.store = store
        self.shardmapper, self.engine = shardmapper, engine

    def mem(self, num_shards=1, dtype="float64"):
        ms = self.memstore.TimeSeriesMemStore(**self.kw)
        cfg = self.memstore.StoreConfig(
            max_series_per_shard=64, samples_per_series=512,
            flush_batch_size=10**9, dtype=dtype, **self.kw)
        gauge = self.schemas.GAUGE
        for s in range(num_shards):
            ms.setup("ds", gauge, s, cfg)
        b = self.record.RecordBuilder(gauge)
        for i in range(4):
            for t in range(N):
                b.add({"_metric_": "m", "host": f"h{i}", "dc": f"dc{i % 2}"},
                      START + t * IV, 100.0 * (i + 1) + t)
        ms.ingest("ds", 0, b.build())
        ms.flush_all()
        return ms

    def query_engine(self, ms):
        return self.engine.QueryEngine(ms, "ds", **self.kw)

    def manager(self, ms, spec, sink=None, published=None, **kw):
        eng = self.query_engine(ms)

        def pub(shard, container, pub_id):
            if published is not None:
                published.append((shard, container.to_bytes(), pub_id))
            ms.ingest("ds", shard, container)

        publisher = self.rules.DerivedSeriesPublisher(
            self.schemas.GAUGE, self.shardmapper.ShardMapper(1), pub,
            dataset="ds")
        groups = self.rules.load_groups(spec, default_interval_ms=30_000)
        return self.rules.RulesManager(groups, eng, publisher=publisher,
                                       sink=sink, dataset="ds", **kw)

    def file_sink(self, path):
        return self.store.FileColumnStore(str(path))


PORT, JAX = Pkg("port"), Pkg("jax")


def _instant(eng, q, ts):
    """{sorted labels: value} of an instant query."""
    res = eng.query_instant(q, ts)
    return {json.dumps(sorted(dict(k.labels).items())): float(v[-1])
            for k, _t, v in res.matrix.iter_series()}


def _groups(spec):
    return load_groups(spec, default_interval_ms=30_000)


# -- spec validation ------------------------------------------------------------

BAD_SPECS = {
    "no-kind": [{"name": "g", "rules": [{"expr": "m"}]}],
    "no-expr": [{"name": "g", "rules": [{"record": "r"}]}],
    "syntax": [{"name": "g", "rules": [{"record": "r", "expr": "sum(("}]}],
    "at-modifier": [{"name": "g",
                     "rules": [{"record": "r", "expr": "sum(m @ 1000)"}]}],
    "reserved-label": [{"name": "g", "rules": [
        {"record": "r", "expr": "m", "labels": {RULE_LABEL: "x"}}]}],
    "for-on-record": [{"name": "g", "rules": [
        {"record": "r", "expr": "m", "for": "1m"}]}],
    "duplicate-group": [
        {"name": "g", "rules": [{"record": "r", "expr": "m"}]},
        {"name": "g", "rules": [{"record": "r2", "expr": "m"}]}],
    "duplicate-rule": [{"name": "g", "rules": [
        {"record": "r", "expr": "m"}, {"record": "r", "expr": "m"}]}],
    "no-rules": [{"name": "g", "rules": []}],
    "nested-at": [{"name": "g", "rules": [
        {"record": "r", "expr": "max_over_time(rate(m[1m] @ 500)[5m:1m])"}]}],
}


@pytest.mark.parametrize("name", sorted(BAD_SPECS))
def test_spec_validation_typed_errors(name):
    from filodb_tpu.promql.parser import ParseError as JParseError
    spec = BAD_SPECS[name]
    with pytest.raises(JParseError) as want:
        JAX.rules.load_groups(spec, default_interval_ms=30_000)
    with pytest.raises(ParseError) as got:
        _groups(spec)
    assert str(got.value) == str(want.value)


def test_spec_defaults_and_uids():
    spec = [{"name": "g", "rules": [
        {"record": "r", "expr": "sum(rate(m[1m]))", "labels": {"a": "b"}},
        {"alert": "A", "expr": "m > 1", "for": "90s"}]}]
    gs, js = _groups(spec), JAX.rules.load_groups(spec, 30_000)
    assert gs[0].interval_ms == js[0].interval_ms == 30_000
    for r, j in zip(gs[0].rules, js[0].rules):
        assert (r.uid, r.kind, r.for_ms, r.labels, r.expr) \
            == (j.uid, j.kind, j.for_ms, j.labels, j.expr)
    assert gs[0].rules[0].uid == "g/r" and gs[0].rules[1].for_ms == 90_000


# -- evaluation: derived series, parity, idempotent replay ----------------------

REC_SPEC = [{"name": "g", "interval": "30s", "rules": [
    {"record": "dc:m:sum", "expr": "sum by (dc) (rate(m[1m]))",
     "labels": {"team": "sre"}},
    {"record": "m:sum", "expr": "sum(m)"},
    {"record": "m:avg_rate", "expr": "avg(rate(m[5m]))"},
    {"record": "m:max", "expr": "max by (host) (m)"}]}]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_recording_rule_parity_and_provenance(dtype):
    """Derived values against the JAX evaluator's over the same store:
    bit for bit on f64, within rtol 1e-5 on f32; the label sets (rule
    labels, provenance, the metric rename) equal."""
    out = {}
    for pkg in (PORT, JAX):
        ms = pkg.mem(dtype=dtype)
        mgr = pkg.manager(ms, REC_SPEC)
        for k in range(3):
            assert mgr.scheduler.run_group_once(mgr.groups[0], E1 + k * 30_000)
        ms.flush_all()
        eng = mgr.evaluator.engine
        out[pkg.which] = {r: _instant(eng, r, E1 + 60_000 + 1_000)
                          for r in ("dc:m:sum", "m:sum", "m:avg_rate",
                                    "m:max")}
    for rule, want in out["jax"].items():
        got = out["port"][rule]
        assert set(got) == set(want) and want, rule
        for k, v in want.items():
            if dtype == "float64":
                assert got[k] == v, (rule, k)
            else:
                np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=0)
    for k in out["port"]["dc:m:sum"]:
        labels = dict(json.loads(k))
        assert labels[RULE_LABEL] == "g/dc:m:sum"
        assert labels["team"] == "sre" and labels["_metric_"] == "dc:m:sum"


def test_recording_rule_bit_parity_with_the_one_shot_oracle():
    ms = PORT.mem()
    mgr = PORT.manager(ms, [{"name": "g", "rules": [
        REC_SPEC[0]["rules"][0]]}])
    assert mgr.scheduler.run_group_once(mgr.groups[0], E1)
    ms.flush_all()
    eng = mgr.evaluator.engine
    derived = eng.query_instant("dc:m:sum", E1 + 1_000)
    oracle = eng.query_instant("sum by (dc) (rate(m[1m]))", E1)
    want = {dict(k.labels).get("dc"): float(v[-1])
            for k, _t, v in oracle.matrix.iter_series()}
    got = {dict(k.labels).get("dc"): float(v[-1])
           for k, _t, v in derived.matrix.iter_series()}
    assert got == want


def test_published_containers_and_pub_ids_equal_the_reference():
    """The publisher's containers (bytes) and pub-ids for the same ticks
    are the reference's."""
    pubs = {}
    for pkg in (PORT, JAX):
        ms = pkg.mem()
        got: list = []
        mgr = pkg.manager(ms, REC_SPEC, published=got)
        for k in range(2):
            mgr.scheduler.run_group_once(mgr.groups[0], E1 + k * 30_000)
        pubs[pkg.which] = got
    assert len(pubs["port"]) == len(pubs["jax"]) == 8
    assert pubs["port"] == pubs["jax"]


def test_replayed_tick_is_idempotent_in_store():
    spec = [{"name": "g", "rules": [{"record": "r", "expr": "sum(m)"}]}]
    seen = {}
    for pkg in (PORT, JAX):
        ms = pkg.mem()
        mgr = pkg.manager(ms, spec)
        g = mgr.groups[0]
        e1, e2 = E1, E1 + 30_000
        assert mgr.scheduler.run_group_once(g, e1)
        assert mgr.scheduler.run_group_once(g, e2)
        ms.flush_all()
        eng = mgr.evaluator.engine

        def read():
            return [(np.asarray(t).tolist(), np.asarray(v).tolist())
                    for _k, t, v in eng.query_range(
                        "r", e1, e2, 30_000).matrix.iter_series()]
        before = read()
        assert mgr.scheduler.run_group_once(g, e1, advance_watermark=False)
        ms.flush_all()
        assert read() == before
        seen[pkg.which] = before
    assert seen["port"] == seen["jax"]


@pytest.mark.parametrize("uid,ts,shard", [
    ("g/r", 1000, 0), ("g/r", 1030, 0), ("g/r2", 1000, 0), ("g/r", 1000, 1),
    ("grp/dc:m:sum", 1_700_000_000_000, 3), ("ü/日本", -5, 7)])
def test_pub_ids_are_the_reference_integers(uid, ts, shard):
    from filodb_tpu.rules import derive_pub_id as jderive
    got = derive_pub_id(uid, ts, shard)
    assert got == jderive(uid, ts, shard) and got & 1


def test_pub_ids_deterministic():
    assert derive_pub_id("g/r", 1000, 0) == derive_pub_id("g/r", 1000, 0)
    assert derive_pub_id("g/r", 1000, 0) != derive_pub_id("g/r", 1030, 0)
    assert derive_pub_id("g/r", 1000, 0) != derive_pub_id("g/r2", 1000, 0)
    assert derive_pub_id("g/r", 1000, 0) != derive_pub_id("g/r", 1000, 1)
    assert derive_pub_id("g/r", 1000, 0) & 1     # broker 'no id' guard


def test_exactly_once_under_broker_leader_kill(tmp_path):
    """Derived ticks publish through a port two-node replica set; the
    leader dies (FaultPlan kill-at-offset) mid-stream. Re-driving the SAME
    ticks at the survivor, with the same pub-ids, leaves the log dense with
    zero lost and zero duplicated frames."""
    from filodb_tpu_torch.ingest.faults import FaultPlan, FaultRule
    plan = FaultPlan([FaultRule("append", "kill_server", partition=0,
                                at_offset=3)])
    peers, a, b = make_pair(tmp_path, fault_plan_a=plan)
    try:
        bus = sleepless_bus(peers, 0, track_acks=True)
        ticks = [E1 + k * 30_000 for k in range(8)]
        expected = {derive_pub_id("g/r", ts, 0) for ts in ticks}
        for ts in ticks:
            bus.publish_with_id(mk(f"tick{ts}"), derive_pub_id("g/r", ts, 0))
        assert plan.fired and plan.fired[0][1] == "kill_server"
        assert bus._cur == 1                 # failed over to the survivor
        for ts in ticks:
            bus.publish_with_id(mk(f"tick{ts}"), derive_pub_id("g/r", ts, 0))
        logged = [pid for _off, pid in b._journals[0].items()]
        assert set(logged) == expected       # zero lost
        assert len(logged) == len(ticks)     # zero duplicated
        offs = [off for off, _pid in b._journals[0].items()]
        assert sorted(offs) == list(range(len(ticks)))   # dense log
        bus.close()
    finally:
        with contextlib.suppress(Exception):
            a.stop()
        b.stop()


# -- alert state machine ---------------------------------------------------------

ALERT_SPEC = [{"name": "g", "rules": [
    {"alert": "High", "expr": "m > 300", "for": "60s",
     "labels": {"sev": "page"}}]}]


def _strip_volatile(payload):
    """A rules/alerts payload without the measured evaluation time."""
    for g in payload.get("groups", []):
        for r in g["rules"]:
            r.pop("evaluationTime", None)
    return payload


def test_alert_for_duration_state_machine():
    seen = {}
    for pkg in (PORT, JAX):
        ms = pkg.mem()
        mgr = pkg.manager(ms, ALERT_SPEC)
        g = mgr.groups[0]
        steps = []
        for dt in (0, 30_000, 60_000):
            mgr.scheduler.run_group_once(g, E1 + dt)
            steps.append(mgr.alerts.snapshot())
        seen[pkg.which] = (steps, mgr.alerts_payload(),
                           _strip_volatile(mgr.rules_payload()))
    assert seen["port"] == seen["jax"]
    steps, payload, _ = seen["port"]
    assert [sorted(s["state"] for s in st["g/High"].values())
            for st in steps] == [["pending"] * 2, ["pending"] * 2,
                                 ["firing"] * 2]
    assert all(s["active_at"] == E1 for s in steps[-1]["g/High"].values())
    assert len(payload["alerts"]) == 2
    assert all(a["state"] == "firing" and a["labels"]["sev"] == "page"
               and a["labels"]["alertname"] == "High"
               for a in payload["alerts"])


def test_alert_zero_for_fires_immediately_and_resolves():
    seen = {}
    for pkg in (PORT, JAX):
        ms = pkg.mem()
        mgr = pkg.manager(ms, [{"name": "g", "rules": [
            {"alert": "Any", "expr": "m > 450"}]}])
        events = []
        mgr.alerts.notifier = type("N", (), {
            "enqueue": staticmethod(events.append)})()
        mgr.scheduler.run_group_once(mgr.groups[0], E1)
        snap = mgr.alerts.snapshot()["g/Any"]
        mgr.alerts.observe(mgr.groups[0].rules[0], E1 + 30_000, [])
        seen[pkg.which] = (events, snap, mgr.alerts.snapshot())
    assert seen["port"] == seen["jax"]
    events, snap, after = seen["port"]
    assert [e["event"] for e in events] == ["firing", "resolved"]
    assert len(snap) == 1 and next(iter(snap.values()))["state"] == "firing"
    assert after["g/Any"] == {}


def test_alert_pending_timer_survives_restart(tmp_path):
    sink = FileColumnStore(str(tmp_path))
    spec = [{"name": "g", "rules": [
        {"alert": "High", "expr": "m > 300", "for": "60s"}]}]
    ms = PORT.mem()
    mgr1 = PORT.manager(ms, spec, sink=sink)
    mgr1.scheduler.run_group_once(mgr1.groups[0], E1)
    assert all(s["state"] == "pending"
               for s in mgr1.alerts.snapshot()["g/High"].values())
    mgr2 = PORT.manager(ms, spec, sink=sink)
    restored = mgr2.alerts.snapshot()["g/High"]
    assert restored and all(s["active_at"] == E1 for s in restored.values())
    mgr2.scheduler.run_group_once(mgr2.groups[0], E1 + 60_000)
    assert all(s["state"] == "firing"
               for s in mgr2.alerts.snapshot()["g/High"].values())
    assert mgr2.state.watermark("g") == E1 + 60_000


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_rules_meta_document_resumes_in_the_other_package(tmp_path, writer,
                                                          reader):
    """A sink holding one package's watermark and pending timers resumes
    the other's manager: the same watermark, the same restored timers, and
    the firing transition when it would have come; the meta documents the
    two write are the same JSON."""
    spec = [{"name": "g", "rules": [
        {"record": "r", "expr": "sum(m)"},
        {"alert": "High", "expr": "m > 300", "for": "60s"}]}]
    w, r = (PORT if writer == "port" else JAX), (PORT if reader == "port"
                                                 else JAX)
    mgr1 = w.manager(w.mem(), spec, sink=w.file_sink(tmp_path))
    mgr1.scheduler.run_group_once(mgr1.groups[0], E1)
    doc1 = w.file_sink(tmp_path).read_meta("ds:rules", 0)
    mgr2 = r.manager(r.mem(), spec, sink=r.file_sink(tmp_path))
    assert mgr2.state.watermark("g") == E1
    assert mgr2.alerts.snapshot() == mgr1.alerts.snapshot()
    mgr2.scheduler.run_group_once(mgr2.groups[0], E1 + 60_000)
    assert all(s["state"] == "firing" and s["active_at"] == E1
               for s in mgr2.alerts.snapshot()["g/High"].values())
    # the reader's document after one tick equals the writer's after the
    # same tick
    mgr1.scheduler.run_group_once(mgr1.groups[0], E1 + 60_000)
    doc_w = w.file_sink(tmp_path).read_meta("ds:rules", 0)
    assert doc_w == r.file_sink(tmp_path).read_meta("ds:rules", 0)
    assert doc1["wm"] == {"g": E1}


# -- webhook notifier ---------------------------------------------------------------

class _Hook(BaseHTTPRequestHandler):
    fail_first = 0
    got: list = []
    lock = threading.Lock()

    def do_POST(self):
        body = self.rfile.read(int(self.headers.get("Content-Length") or 0))
        with _Hook.lock:
            if _Hook.fail_first > 0:
                _Hook.fail_first -= 1
                self.send_response(500)
                self.end_headers()
                return
            _Hook.got.append(json.loads(body))
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def log_message(self, fmt, *args):
        pass


def _hook_server():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Hook)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}/hook"


def test_webhook_delivery_with_retry():
    from filodb_tpu_torch.rules import WebhookNotifier
    srv, url = _hook_server()
    _Hook.got, _Hook.fail_first = [], 2
    n = WebhookNotifier(url, retries=3, backoff_s=0.0)
    try:
        n.enqueue({"event": "firing", "rule": "g/r", "labels": {"a": "b"}})
        n.drain()
        deadline = time.monotonic() + 5
        while not _Hook.got and time.monotonic() < deadline:
            time.sleep(0.02)
        assert _Hook.got and _Hook.got[0]["rule"] == "g/r"
        assert _Hook.fail_first == 0         # both failures consumed
    finally:
        n.stop()
        srv.shutdown()
        srv.server_close()


# -- HTTP surface ----------------------------------------------------------------

def test_rules_and_alerts_http_endpoints():
    """The port's /api/v1/rules and /api/v1/alerts answer the payloads the
    reference's server answers for the same manager state."""
    from filodb_tpu.http.api import FiloHttpServer as JFiloHttpServer
    spec = [{"name": "g", "interval": "15s", "rules": [
        {"record": "r", "expr": "sum(m)"},
        {"alert": "High", "expr": "m > 300", "for": "30s"}]}]
    got = {}
    for pkg, Server in ((PORT, FiloHttpServer), (JAX, JFiloHttpServer)):
        ms = pkg.mem()
        mgr = pkg.manager(ms, spec)
        mgr.scheduler.run_group_once(mgr.groups[0], E1)
        srv = Server({"ds": mgr.evaluator.engine}, port=0)
        srv.rules = mgr
        srv.start()
        try:
            base = f"http://127.0.0.1:{srv.port}"
            with urllib.request.urlopen(f"{base}/api/v1/rules",
                                        timeout=10) as r:
                rules_doc = _strip_volatile(json.load(r)["data"])
            with urllib.request.urlopen(f"{base}/api/v1/alerts",
                                        timeout=10) as r:
                alerts = json.load(r)["data"]["alerts"]
            got[pkg.which] = (rules_doc, alerts)
        finally:
            srv.stop()
    assert got["port"] == got["jax"]
    (g,), alerts = got["port"][0]["groups"], got["port"][1]
    assert g["name"] == "g" and g["interval"] == 15.0
    rec, al = g["rules"]
    assert rec["type"] == "recording" and rec["health"] == "ok"
    assert rec["lastEvaluation"] == E1 / 1000.0
    assert al["type"] == "alerting" and al["state"] == "pending"
    assert al["duration"] == 30.0 and len(al["alerts"]) == 2
    assert len(alerts) == 2 and all(a["state"] == "pending" for a in alerts)


def test_rules_endpoint_404_when_unconfigured():
    srv = FiloHttpServer({"ds": PORT.query_engine(PORT.mem())},
                         port=0).start()
    try:
        for path in ("/api/v1/rules", "/api/v1/alerts"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{path}",
                                       timeout=10)
            assert ei.value.code == 404
    finally:
        srv.stop()


def test_failing_rule_shows_health_err_and_the_group_goes_on():
    spec = [{"name": "g", "rules": [
        {"record": "good", "expr": "sum(m)"},
        {"record": "bad", "expr": "sum(m)"}]}]
    ms = PORT.mem()
    mgr = PORT.manager(ms, spec)
    real = mgr.evaluator.engine.query_instant

    def flaky(q, ts, **kw):
        if kw.get("tenant") and flaky.calls == 1:
            flaky.calls += 1
            raise RuntimeError("device fault")
        flaky.calls += 1
        return real(q, ts, **kw)
    flaky.calls = 0
    mgr.evaluator.engine.query_instant = flaky
    assert mgr.scheduler.run_group_once(mgr.groups[0], E1)
    rows = {r["name"]: r for r in mgr.rules_payload()["groups"][0]["rules"]}
    assert rows["good"]["health"] == "ok"
    assert rows["bad"]["health"] == "err"
    assert "device fault" in rows["bad"]["lastError"]


# -- scheduler mechanics -----------------------------------------------------------

def test_scheduler_pending_ticks_and_catchup_cap():
    spec = [{"name": "g", "interval": "30s",
             "rules": [{"record": "r", "expr": "sum(m)"}]}]
    seen = {}
    for pkg in (PORT, JAX):
        mgr = pkg.manager(pkg.mem(), spec, max_catchup=2)
        sched, g = mgr.scheduler, mgr.groups[0]
        iv = g.interval_ms
        now = E1 + 5_000
        out = [sched.pending_ticks(g, now)]
        sched.state.set_watermark("g", (now // iv) * iv)
        out.append(sched.pending_ticks(g, now))
        for k in (1, 2, 5, 17):
            out.append(sched.pending_ticks(g, now + k * iv + 123))
        seen[pkg.which] = out
    assert seen["port"] == seen["jax"]
    iv, now = 30_000, E1 + 5_000
    assert seen["port"][0] == [(now // iv) * iv]
    assert seen["port"][1] == []
    due = ((now + 5 * iv + 123) // iv) * iv
    assert seen["port"][4] == [due - iv, due]


def test_scheduler_live_loop_with_fake_clock():
    ms = PORT.mem()
    clock = {"ms": E1}
    mgr = PORT.manager(ms, [{"name": "g", "interval": "30s", "rules": [
        {"record": "r", "expr": "sum(m)"}]}], clock_ms=lambda: clock["ms"])
    sched = mgr.scheduler
    sched.start()
    try:
        deadline = time.monotonic() + 10
        while sched.state.watermark("g") < 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        wm1 = sched.state.watermark("g")
        assert wm1 == (clock["ms"] // 30_000) * 30_000
        clock["ms"] += 30_000
        deadline = time.monotonic() + 10
        while sched.state.watermark("g") == wm1 \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        assert sched.state.watermark("g") == wm1 + 30_000
        threads = list(sched._threads)
    finally:
        sched.stop()
    assert threads and not any(t.is_alive() for t in threads)
    ms.flush_all()
    res = mgr.evaluator.engine.query_range("r", wm1, wm1 + 30_000, 30_000)
    assert res.matrix.num_series == 1


def test_scheduler_waits_for_ready_before_the_first_tick():
    """``start(ready)``: no group evaluates until ``ready()`` first
    returns True (the server's own shards have recovered); then the loop
    runs as without it."""
    ms = PORT.mem()
    clock = {"ms": E1}
    mgr = PORT.manager(ms, [{"name": "g", "interval": "30s", "rules": [
        {"record": "r", "expr": "sum(m)"}]}], clock_ms=lambda: clock["ms"])
    sched = mgr.scheduler
    ready = threading.Event()
    polls = []

    def is_ready():
        polls.append(1)
        return ready.is_set()

    sched.start(ready=is_ready)
    try:
        deadline = time.monotonic() + 10
        while len(polls) < 5 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert len(polls) >= 5
        assert sched.state.watermark("g") < 0
        ready.set()
        while sched.state.watermark("g") < 0 \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        assert sched.state.watermark("g") == (E1 // 30_000) * 30_000
    finally:
        sched.stop()
    assert not sched._threads


def test_scheduler_failed_catchup_tick_holds_watermark():
    ms = PORT.mem()
    mgr = PORT.manager(ms, [{"name": "g", "interval": "30s", "rules": [
        {"record": "r", "expr": "sum(m)"}]}])
    sched, g = mgr.scheduler, mgr.groups[0]
    t1 = 1_620_000
    sched.state.set_watermark("g", t1)
    real = mgr.evaluator.evaluate_group

    def flaky(group, eval_ts):
        if eval_ts == t1 + 30_000:
            raise RuntimeError("transient publish fault")
        return real(group, eval_ts)

    mgr.evaluator.evaluate_group = flaky
    now = t1 + 2 * 30_000 + 1_000
    ticks = sched.pending_ticks(g, now)
    assert ticks == [t1 + 30_000, t1 + 60_000]
    assert [sched.run_group_once(g, ts) for ts in ticks[:1]] == [False]
    assert sched.state.watermark("g") == t1
    assert sched.pending_ticks(g, now)[0] == t1 + 30_000


def test_scheduler_stagger_spreads_groups():
    spec = [{"name": f"g{i}", "interval": "30s",
             "rules": [{"record": f"r{i}", "expr": "sum(m)"}]}
            for i in range(3)]
    offsets = {}
    for pkg in (PORT, JAX):
        sched = pkg.manager(pkg.mem(), spec).scheduler
        offsets[pkg.which] = [sched._stagger_ms(i, 30_000) for i in range(3)]
    assert offsets["port"] == offsets["jax"] == [0, 10_000, 20_000]


def test_streaming_catch_up_equals_the_instant_path_and_the_reference():
    """``rules.streaming``: a catch-up span prefetched as one range query
    a rule gives the derived values the instant path gives, bit for bit
    (f64), in the port and in the JAX package."""
    ticks = [E1 + k * 30_000 for k in range(6)]
    seen = {}
    for pkg in (PORT, JAX):
        for streaming in (False, True):
            ms = pkg.mem()
            mgr = pkg.manager(ms, REC_SPEC, streaming=streaming)
            g = mgr.groups[0]
            mgr.evaluator.prefetch(g, ticks)
            assert all(mgr.scheduler.run_group_once(g, t) for t in ticks)
            ms.flush_all()
            eng = mgr.evaluator.engine
            seen[(pkg.which, streaming)] = {
                r: [(np.asarray(t).tolist(), np.asarray(v).tolist())
                    for _k, t, v in eng.query_range(
                        r, ticks[0], ticks[-1], 30_000).matrix.iter_series()]
                for r in ("dc:m:sum", "m:sum", "m:avg_rate", "m:max")}
    want = seen[("port", False)]
    assert all(want[r] for r in want)
    for key in seen:
        assert seen[key] == want, key


def test_manager_from_config():
    eng = PORT.query_engine(PORT.mem())
    cfg = Config({"rules": {"groups": [
        {"name": "g", "rules": [{"record": "r", "expr": "sum(m)"}]}],
        "streaming": True, "max_catchup": 5}})
    mgr = RulesManager.from_config(cfg, eng, None, None, "ds")
    assert mgr is not None and mgr.groups[0].interval_ms == 30_000
    assert mgr.evaluator.streaming and mgr.scheduler.max_catchup == 5
    assert RulesManager.from_config(Config(), eng, None, None, "ds") is None


# -- __rule__ spoof guards ---------------------------------------------------------

def test_remote_write_rejects_rule_label_spoof():
    from filodb_tpu_torch.utils.metrics import (FILODB_RULES_SPOOF_REJECTS,
                                                registry)
    ms = PORT.mem()
    eng = PORT.query_engine(ms)
    req = pb.WriteRequest()
    series = req.timeseries.add()
    series.labels.add(name="__name__", value="forged")
    series.labels.add(name=RULE_LABEL, value="g/r")
    series.samples.add(value=1.0, timestamp_ms=START)
    before = registry.counter(FILODB_RULES_SPOOF_REJECTS,
                              {"site": "remote-write"}).value
    with pytest.raises(QueryError, match="reserved for recording-rule"):
        remote.write_request_to_containers(
            snappy.compress(req.SerializeToString()),
            ms._dataset_schema["ds"], eng.mapper)
    assert registry.counter(FILODB_RULES_SPOOF_REJECTS,
                            {"site": "remote-write"}).value == before + 1


def test_gateway_rejects_rule_label_spoof():
    from filodb_tpu_torch.ingest.gateway import (GatewayServer,
                                                 InfluxParseError)
    from filodb_tpu_torch.utils.metrics import (FILODB_RULES_SPOOF_REJECTS,
                                                registry)
    got = []
    gw = GatewayServer(lambda s, c: got.append((s, c)), num_shards=1,
                       strict=True, flush_interval_ms=0)
    with pytest.raises(InfluxParseError, match="reserved for recording"):
        gw.ingest_line(f"m,{RULE_LABEL}=g/r,host=h0 value=1.0 1000000000")
    before = registry.counter(FILODB_RULES_SPOOF_REJECTS,
                              {"site": "gateway"}).value
    gw.strict = False
    gw.ingest_line(f"m,{RULE_LABEL}=g/r,host=h0 value=1.0 1000000000")
    gw.flush()
    assert not got
    assert registry.counter(FILODB_RULES_SPOOF_REJECTS,
                            {"site": "gateway"}).value == before + 1


# -- the server, end to end on the CPU ----------------------------------------------

def test_standalone_server_rules_end_to_end(tmp_path):
    """FiloServer wiring: rule groups evaluate on the live scheduler,
    derived series publish through the bus and become queryable over HTTP,
    /api/v1/rules and /api/v1/alerts serve, the watermark persists to the
    durable sink, a remote write lands and reads back, a spoofed remote
    write is a 422, and shutdown joins the group thread."""
    from filodb_tpu_torch.ingest.bus import FileBus
    from filodb_tpu_torch.standalone import FiloServer

    now_ms = int(time.time() * 1000)
    bus = FileBus(str(tmp_path / "bus" / "shard0.log"))
    b = RecordBuilder(GAUGE)
    for i in range(2):
        for t in range(60):
            b.add({"_metric_": "live", "host": f"h{i}"},
                  now_ms - 300_000 + t * 5_000, 10.0 * (i + 1))
    bus.publish(b.build())
    cfg = Config({
        "num_shards": 1,
        "data_dir": str(tmp_path / "data"),
        "bus_dir": str(tmp_path / "bus"),
        "http": {"port": 0},
        "store": {"max_series_per_shard": 16, "samples_per_series": 256,
                  "flush_batch_size": 1_000_000_000, "dtype": "float64"},
        "rules": {"groups": [
            {"name": "g", "interval": "1s", "rules": [
                {"record": "live:sum", "expr": "sum(live)"},
                {"alert": "LiveUp", "expr": "sum(live) > 0"}]}]},
    })
    server = FiloServer(cfg, device="cpu").start()
    threads = list(server.rules.scheduler._threads)
    try:
        port = server.http.port

        def get(path):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}{path}", timeout=10) as r:
                return json.load(r)

        deadline = time.time() + 20
        rules_doc = None
        while time.time() < deadline:
            rules_doc = get("/api/v1/rules")["data"]
            if all(r["health"] == "ok"
                   for r in rules_doc["groups"][0]["rules"]):
                break
            time.sleep(0.2)
        assert all(r["health"] == "ok"
                   for r in rules_doc["groups"][0]["rules"])
        got = None
        while time.time() < deadline:
            q = get("/promql/prometheus/api/v1/query?query=live:sum"
                    f"&time={time.time()}")
            if q["data"]["result"]:
                got = q["data"]["result"][0]
                break
            time.sleep(0.2)
        assert got, "derived series never became queryable"
        assert got["metric"]["__name__"] == "live:sum"
        assert got["metric"][RULE_LABEL] == "g/live:sum"
        assert float(got["value"][1]) == 30.0    # sum(10 + 20)
        alerts = None
        while time.time() < deadline:
            alerts = get("/api/v1/alerts")["data"]["alerts"]
            if alerts and alerts[0]["state"] == "firing":
                break
            time.sleep(0.2)
        assert alerts and alerts[0]["labels"]["alertname"] == "LiveUp"
        assert server.rules.state.watermark("g") > 0
        assert server.rules.state.sink is not None

        def post(path, body):
            rq = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                        data=body, method="POST")
            try:
                with urllib.request.urlopen(rq, timeout=10) as r:
                    return r.status, r.read()
            except urllib.error.HTTPError as e:
                return e.code, e.read()

        # a remote write through the file bus, read back by remote read
        w = pb.WriteRequest()
        s = w.timeseries.add()
        s.labels.add(name="__name__", value="rw")
        s.labels.add(name="src", value="remote")
        s.samples.extend_arrays(np.array([now_ms - 1_000, now_ms]),
                                np.array([1.5, 2.5]))
        assert post("/promql/prometheus/api/v1/write",
                    snappy.compress(w.SerializeToString()))[0] == 204
        rr = pb.ReadRequest()
        q = rr.queries.add()
        q.start_timestamp_ms, q.end_timestamp_ms = now_ms - 10_000, now_ms
        q.matchers.add(type=pb.LabelMatcher.EQ, name="__name__", value="rw")
        back = None
        while time.time() < deadline + 10:
            code, body = post("/promql/prometheus/api/v1/read",
                              snappy.compress(rr.SerializeToString()))
            assert code == 200
            back = pb.ReadResponse()
            back.ParseFromString(snappy.decompress(body))
            if back.results[0].timeseries:
                break
            time.sleep(0.2)
        ts, vals = back.results[0].timeseries[0].samples.arrays()
        assert ts.tolist() == [now_ms - 1_000, now_ms]
        assert vals.tolist() == [1.5, 2.5]
        # spoofed remote write: typed 422 end to end
        req = pb.WriteRequest()
        s = req.timeseries.add()
        s.labels.add(name="__name__", value="forged")
        s.labels.add(name=RULE_LABEL, value="g/x")
        s.samples.add(value=1.0, timestamp_ms=now_ms)
        code, _ = post("/promql/prometheus/api/v1/write",
                       snappy.compress(req.SerializeToString()))
        assert code == 422
    finally:
        server.shutdown()
    assert threads and not any(t.is_alive() for t in threads)
