"""The port's multi-process bootstrap (ref: the reference's
``tests/test_bootstrap.py``; akka-bootstrapper's seed discovery and join,
the coordinator's multi-jvm specs): discovery, a deterministic world,
membership feeding shard reassignment; then two real processes, each a
cluster node (``filodb_tpu_torch.entry --cluster-node``) on the CPU that
joins a Gloo process group, owns one seeded shard and serves its HTTP API.
Both nodes answer a spanning query as one node holding both shards does,
bit for bit, and each rank's ``all_reduce`` of its host partials gives the
same sum(rate)."""

import json
import os
import subprocess
import sys
import time
import urllib.parse
import urllib.request

import numpy as np
import pytest

from filodb_tpu_torch.parallel.bootstrap import (ClusterBootstrap, EnvSeedDiscovery,
                                           FileRegistrarDiscovery,
                                           MembershipMonitor,
                                           WhitelistSeedDiscovery, free_port)
from filodb_tpu_torch.parallel.cluster import ShardManager


def test_whitelist_and_env_discovery(monkeypatch):
    d = WhitelistSeedDiscovery(["b:2", " a:1 ", ""])
    assert d.discover() == ["b:2", "a:1"]
    monkeypatch.setenv("FILODB_SEEDS", "n1:7000,n2:7000")
    assert EnvSeedDiscovery().discover() == ["n1:7000", "n2:7000"]


def test_file_registrar_discovery(tmp_path):
    reg = FileRegistrarDiscovery(str(tmp_path / "members.jsonl"), stale_s=5)
    reg.register("node-b:7001")
    reg.register("node-a:7001")
    assert reg.discover() == ["node-a:7001", "node-b:7001"]
    # stale members age out; a heartbeat refreshes
    reg2 = FileRegistrarDiscovery(str(tmp_path / "m2.jsonl"), stale_s=0.2)
    reg2.register("old:1")
    time.sleep(0.3)
    reg2.register("new:1")
    assert reg2.discover() == ["new:1"]
    reg2.heartbeat("old:1")
    assert reg2.discover() == ["new:1", "old:1"]


def test_world_resolution_is_deterministic(tmp_path):
    """Three members sharing a registrar agree on coordinator + ranks."""
    path = str(tmp_path / "members.jsonl")
    addrs = ["host-c:7000", "host-a:7000", "host-b:7000"]
    worlds = []
    for addr in addrs:
        reg = FileRegistrarDiscovery(path)
        reg.register(addr)
    for addr in addrs:
        b = ClusterBootstrap(FileRegistrarDiscovery(path), addr)
        worlds.append(b.resolve_world(min_members=3))
    assert all(w.coordinator == "host-a:7000" for w in worlds)
    assert all(w.num_processes == 3 for w in worlds)
    assert sorted(w.process_id for w in worlds) == [0, 1, 2]
    assert worlds[1].is_coordinator          # host-a sorts first
    # single-member world needs no waiting and no coordinator service
    solo = ClusterBootstrap(WhitelistSeedDiscovery([]), "only:1").resolve_world()
    assert solo.num_processes == 1 and solo.is_coordinator


def test_membership_monitor_feeds_shard_reassignment(tmp_path):
    """A peer going silent triggers on_down -> ShardManager.remove_node, and
    its shards move to surviving nodes (ref: doc/sharding.md auto-reassignment)."""
    reg = FileRegistrarDiscovery(str(tmp_path / "members.jsonl"), stale_s=0.4)
    mgr = ShardManager(min_reassignment_interval_s=0.0)
    mgr.add_node("n1:70")
    mgr.add_node("n2:70")
    mgr.add_dataset("ds", 4)
    assert {mgr.node_of("ds", s) for s in range(4)} == {"n1:70", "n2:70"}
    mon = MembershipMonitor(reg, "n1:70", on_down=mgr.remove_node,
                            interval_s=0.1)
    reg.register("n2:70")
    mon.poll_once()                          # sees both members
    assert "n2:70" in mon._known
    time.sleep(0.5)                          # n2 never heartbeats again
    mon.poll_once()
    assert {mgr.node_of("ds", s) for s in range(4)} == {"n1:70"}



def test_self_stale_quarantine(tmp_path):
    """A node whose own heartbeat lapsed (peers declared it dead) must
    fail-stop instead of re-announcing and double-owning its shards."""
    reg = FileRegistrarDiscovery(str(tmp_path / "members"), stale_s=0.2)
    quarantined = []
    mon = MembershipMonitor(reg, "me:1", on_down=lambda n: None,
                            on_self_stale=lambda: quarantined.append(True),
                            interval_s=0.05)
    mon.poll_once()                       # first heartbeat
    assert not quarantined
    time.sleep(0.35)                      # lapse past stale_s
    mon.poll_once()
    assert quarantined == [True]
    # the monitor stopped itself and did NOT re-heartbeat: we age out of
    # discovery rather than re-announcing a dead node
    time.sleep(0.25)
    assert "me:1" not in reg.discover()


def test_dns_srv_discovery():
    """SRV resolution against an in-process fake DNS server whose answers use
    RFC-1035 compression pointers (the shape real servers emit); ref:
    DnsSrvClusterSeedDiscovery.scala:12,87."""
    import socket
    import struct
    import threading

    from filodb_tpu_torch.parallel.bootstrap import DnsSrvSeedDiscovery

    srv_name = "_filodb._tcp.example.local"

    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]

    def encode_name(name):
        out = b""
        for label in name.split("."):
            out += bytes([len(label)]) + label.encode()
        return out + b"\x00"

    def serve_once():
        data, peer = sock.recvfrom(4096)
        qid = data[:2]
        # answers: two SRV records; NAME is a compression pointer to the
        # question name at offset 12; targets are plain encoded names
        ans = b""
        for prio, weight, tport, target in ((10, 5, 9001, "node-b.example.local"),
                                            (10, 5, 9000, "node-a.example.local")):
            tgt = encode_name(target)
            ans += (b"\xc0\x0c" + struct.pack(">HHIH", 33, 1, 60, 6 + len(tgt))
                    + struct.pack(">HHH", prio, weight, tport) + tgt)
        resp = (qid + struct.pack(">HHHHH", 0x8180, 1, 2, 0, 0)
                + encode_name(srv_name) + struct.pack(">HH", 33, 1) + ans)
        sock.sendto(resp, peer)

    t = threading.Thread(target=serve_once, daemon=True)
    t.start()
    try:
        d = DnsSrvSeedDiscovery(srv_name, resolver=f"127.0.0.1:{port}")
        assert d.discover() == ["node-a.example.local:9000",
                                "node-b.example.local:9001"]
    finally:
        sock.close()


def test_consul_discovery_register_and_catalog():
    """Register/discover against a Consul-compatible HTTP registry (ref:
    ConsulClient.scala:5) served by an in-process stub."""
    import json as _json
    import threading
    from http.server import BaseHTTPRequestHandler, HTTPServer

    from filodb_tpu_torch.parallel.bootstrap import ConsulSeedDiscovery

    services = {}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_PUT(self):
            if self.path.startswith("/v1/agent/service/deregister/"):
                services.pop(self.path.rsplit("/", 1)[-1], None)
                self.send_response(200)
                self.end_headers()
                return
            body = _json.loads(self.rfile.read(
                int(self.headers.get("Content-Length", 0))))
            assert self.path == "/v1/agent/service/register"
            services[body["ID"]] = body
            self.send_response(200)
            self.end_headers()

        def do_GET(self):
            name = self.path.rsplit("/", 1)[-1]
            rows = [{"ServiceAddress": s["Address"], "ServicePort": s["Port"],
                     "ServiceMeta": s.get("Meta", {})}
                    for s in services.values() if s["Name"] == name]
            raw = _json.dumps(rows).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(raw)))
            self.end_headers()
            self.wfile.write(raw)

    httpd = HTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        base = f"http://127.0.0.1:{httpd.server_port}"
        d = ConsulSeedDiscovery(base, service="filodb")
        assert d.discover() == []
        d.register("10.0.0.1:9000")
        d.register("10.0.0.2:9000")
        assert d.discover() == ["10.0.0.1:9000", "10.0.0.2:9000"]
        # a second registry user under another service name stays separate
        other = ConsulSeedDiscovery(base, service="gateway")
        other.register("10.0.0.3:7000")
        assert d.discover() == ["10.0.0.1:9000", "10.0.0.2:9000"]
        # claims ride the registration; a dead node ages out of discovery
        d.register("10.0.0.1:9000", claims={"prometheus": [0, 1]})
        assert d.claims()["10.0.0.1:9000"] == {"prometheus": [0, 1]}
        stale = ConsulSeedDiscovery(base, service="filodb", stale_s=0.0)
        import time as _t
        _t.sleep(0.05)
        assert stale.discover() == []          # every stamped entry expired
        d.deregister("10.0.0.1:9000")
        d.deregister("10.0.0.2:9000")
        assert d.discover() == []
    finally:
        httpd.shutdown()


def test_discovery_classes_match_the_reference(tmp_path, monkeypatch):
    """The port's registrar files and world are the reference's: a member
    registered by either package is discovered by both, with the same
    coordinator and ranks."""
    from filodb_tpu.parallel import bootstrap as jboot
    path = str(tmp_path / "members")
    FileRegistrarDiscovery(path).register("host-b:1", claims={"ds": [1]},
                                          http="127.0.0.1:9")
    jboot.FileRegistrarDiscovery(path).register("host-a:1")
    for mod in (jboot, None):
        reg = (mod.FileRegistrarDiscovery(path) if mod
               else FileRegistrarDiscovery(path))
        assert reg.discover() == ["host-a:1", "host-b:1"]
        assert reg.endpoints() == {"host-b:1": "127.0.0.1:9"}
        assert reg.claims()["host-b:1"] == {"ds": [1]}
    w = ClusterBootstrap(FileRegistrarDiscovery(path), "host-b:1") \
        .resolve_world(min_members=2)
    jw = jboot.ClusterBootstrap(jboot.FileRegistrarDiscovery(path),
                                "host-b:1").resolve_world(min_members=2)
    assert (w.coordinator, w.num_processes, w.process_id, w.members) == \
        (jw.coordinator, jw.num_processes, jw.process_id, jw.members)
    # a single-process world brings up no process group
    solo = ClusterBootstrap(WhitelistSeedDiscovery([]), "only:1")
    assert solo.initialize_torch().num_processes == 1
    import torch.distributed as dist
    assert not dist.is_initialized()


SERIES, SAMPLES, CAPACITY = 64, 60, 64
BASE = 1_700_000_000_000
QRANGE = (BASE + 300_000, BASE + 590_000, 30_000)


def _q(ep, query):
    s, e, step = QRANGE
    params = urllib.parse.urlencode({"query": query, "start": s / 1000.0,
                                     "end": e / 1000.0,
                                     "step": f"{step}ms"})
    url = f"http://{ep}/promql/prometheus/api/v1/query_range?{params}"
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.load(r)["data"]["result"]


def _as_rows(result):
    return {tuple(sorted(s["metric"].items())):
            [(t, float(v)) for t, v in s["values"]] for s in result}


def test_two_process_gloo_cluster(tmp_path):
    """Two fresh interpreters discover each other, agree on the world,
    join a Gloo process group and each own one shard; both answer the
    spanning sum(rate) and topk as one node over both shards does, bit
    for bit, and both ranks' all_reduce of their partials gives that
    sum(rate)."""
    import torch

    from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.entry import seeded_counter_shard
    from filodb_tpu_torch.http.api import matrix_to_prom_json
    from filodb_tpu_torch.parallel.shardmapper import ShardMapper
    from filodb_tpu_torch.query.engine import QueryEngine

    reg = str(tmp_path / "members")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    port = free_port()
    addrs = [f"127.0.0.1:{port}", f"127.0.0.2:{port}"]
    rng = ",".join(str(x) for x in QRANGE)
    procs, logs = [], []
    try:
        for a in addrs:
            lg = str(tmp_path / f"{a.replace(':', '_')}.log")
            logs.append(lg)
            with open(lg, "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "filodb_tpu_torch.entry",
                     "--cluster-node", "--registrar", reg, "--addr", a,
                     "--series", str(SERIES), "--samples", str(SAMPLES),
                     "--capacity", str(CAPACITY), "--device", "cpu",
                     "--range", rng],
                    env=env, cwd=root, stdout=out, stderr=subprocess.STDOUT))

        def lines(tag):
            out = []
            for p, lg in zip(procs, logs):
                with open(lg) as f:
                    text = f.read()
                if p.poll() not in (None, 0):
                    raise AssertionError(f"node died: {text[-2000:]}")
                out += [json.loads(ln[len(tag) + 1:])
                        for ln in text.splitlines() if ln.startswith(tag)]
            return out

        deadline = time.monotonic() + 120
        while len(lines("NODE")) < 2 and time.monotonic() < deadline:
            time.sleep(0.2)
        nodes = sorted(lines("NODE"), key=lambda n: n["rank"])
        assert [(n["rank"], n["world"]) for n in nodes] == [(0, 2), (1, 2)]
        # the oracle: one node holding both seeded shards
        ms = TimeSeriesMemStore(device="cpu")
        for s in (0, 1):
            seeded_counter_shard(ms, "prometheus", s, SERIES, SAMPLES,
                                 CAPACITY, 23)
        oracle = QueryEngine(ms, "prometheus", ShardMapper(2), device="cpu")
        for query in ("sum(rate(m[5m]))", "topk(3, rate(m[5m]))",
                      "sum by (grp) (rate(m[5m]))"):
            want = _as_rows(matrix_to_prom_json(
                oracle.query_range(query, *QRANGE))["result"])
            for n in nodes:
                assert _as_rows(_q(n["http"], query)) == want, \
                    (n["rank"], query)
        want = oracle.query_range("sum(rate(m[5m]))", *QRANGE)
        (_k, _t, vals), = list(want.matrix.iter_series())
        for n in nodes:
            assert n["allreduce"] == [float(v) for v in vals], n["rank"]
        open(os.path.join(reg, "stop"), "w").close()
        for p in procs:
            assert p.wait(timeout=60) == 0
        assert len(lines("DONE")) == 2
    finally:
        open(os.path.join(reg, "stop"), "a").close()
        for p in procs:
            if p.poll() is None:
                p.terminate()
                p.wait(timeout=10)
