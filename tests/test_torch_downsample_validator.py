"""The port's downsample validator, against the reference's and a live port
server.

Mirrors the reference's ``tests/test_downsample_validator.py``: the
comparison must fail on a wrong value, a missing series, an interior gap
(but not on trailing lag) and drift beyond ``rtol`` — case for case the
same report as the reference's ``compare_results``; the two live-server
tests (one node, and two nodes on one broker, each node validated over
its own port) run against port ``FiloServer(device="cpu")``s and stay
slow, as in the reference. Then the command line: ``python -m
filodb_tpu_torch.scripts.downsample_validator`` validates a live port
server with the reference's arguments. It speaks HTTP only and takes no
``--device``, so it runs on a host without a card.
"""

import importlib.util
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from filodb_tpu_torch.config import Config
from filodb_tpu_torch.core.record import RecordBuilder
from filodb_tpu_torch.core.schemas import GAUGE
from filodb_tpu_torch.ingest.bus import FileBus
from filodb_tpu_torch.scripts import downsample_validator as mod
from filodb_tpu_torch.standalone import FiloServer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = 1_700_000_000_000
RES = 60_000


def _reference_validator():
    spec = importlib.util.spec_from_file_location(
        "reference_downsample_validator",
        os.path.join(ROOT, "scripts", "downsample_validator.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    return ref


def _one_node(tmp_path, series=3):
    """A port server with 1 m inline downsampling and the reference test's
    data through its bus: ``series`` gauges, 60 samples at a 7 s cadence
    offset by 500 ms (no sample on a bucket edge)."""
    cfg = Config({
        "num_shards": 1,
        "data_dir": str(tmp_path / "data"),
        "bus_dir": str(tmp_path / "bus"),
        "http": {"port": 0},
        "downsample": {"enabled": True, "resolutions": ["1m"],
                       "serve_interval": "500ms"},
        "store": {"max_series_per_shard": 16, "samples_per_series": 128,
                  "flush_batch_size": 10**9, "groups_per_shard": 1},
    })
    srv = FiloServer(cfg, device="cpu").start()
    rng = np.random.default_rng(3)
    bus = FileBus(str(tmp_path / "bus" / "shard0.log"))
    b = RecordBuilder(GAUGE)
    for i in range(series):
        vals = 50.0 * (i + 1) + rng.normal(0, 5, 60)
        for t in range(60):
            b.add({"_metric_": "m", "host": f"h{i}"},
                  BASE + 500 + t * 7_000, float(vals[t]))
    bus.publish(b.build())
    _wait_series(srv, [0], series)
    return srv


def _wait_series(srv, shards, n, timeout_s=60):
    """Until the server's shards hold ``n`` series between them: a raw
    query answered before the consumer ingested would sit, empty, in the
    negative cache for its TTL (the reference behaves the same)."""
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        try:
            if sum(srv.memstore.shard("prometheus", s).num_series
                   for s in shards) == n:
                return
        except KeyError:       # the shard is not set up yet
            pass
        time.sleep(0.05)
    raise AssertionError(f"{n} series never ingested on {srv.node}")


def _wait_ok(url, enough, timeout_s=60):
    """Validate until the report is ok and ``enough(report)`` (the serving
    refresh exposes the family a bucket at a time)."""
    deadline = time.time() + timeout_s
    report = None
    while time.time() < deadline:
        try:
            report = mod.validate(url, "prometheus", "1m", "m",
                                  BASE, BASE + 60 * 7_000)
            if report["ok"] and enough(report):
                break
        except OSError:        # the family is not served yet
            pass
        except RuntimeError as e:
            if "query failed" not in str(e):
                raise
        time.sleep(0.5)
    return report


@pytest.mark.slow
def test_validator_against_live_server(tmp_path):
    srv = _one_node(tmp_path)
    try:
        url = f"http://127.0.0.1:{srv.http.port}"
        # data spans 7 minutes -> ~6 complete buckets
        report = _wait_ok(url, lambda r: r["checked"] >= 3 * 4 * 4)
        assert report is not None and report["ok"], report
        # every check column compared real points for every series
        for col in ("dMin", "dMax", "dAvg", "dCount"):
            c = report["checks"][col]
            assert c["compared"] >= 3 * 4, (col, c)
            assert c["mismatches"] == 0 and c["missing_ds_series"] == 0, \
                (col, c)
            assert c["max_rel_err"] <= 1e-6, (col, c)
    finally:
        srv.shutdown()


DETECTION_CASES = ("clean", "wrong_value", "missing_series",
                   "interior_gap_vs_lag", "drift_inside_rtol",
                   "drift_outside_rtol")


def _detection_inputs(case):
    """(raw, ds, rtol) of each detection case of the reference's test."""
    key = (("host", "h0"),)
    raw = {key: {1000: 5.0, 2000: 6.0, 3000: 7.0},
           (("host", "h1"),): {1000: 1.0}}
    if case == "clean":
        return raw, {key: {1000: 5.0, 2000: 6.0, 3000: 7.0},
                     (("host", "h1"),): {1000: 1.0}}, 1e-9
    if case == "wrong_value":
        return raw, {key: {1000: 5.0, 2000: 9.0, 3000: 7.0},
                     (("host", "h1"),): {1000: 1.0}}, 1e-9
    if case == "missing_series":
        return raw, {key: {1000: 5.0}}, 1e-9
    if case == "interior_gap_vs_lag":
        return ({key: {1000: 5.0, 2000: 6.0, 3000: 7.0, 4000: 8.0}},
                {key: {1000: 5.0, 3000: 7.0}}, 1e-9)
    drift = {key: {1000: 5.0 * (1 + 1e-7)}}
    if case == "drift_inside_rtol":
        return {key: {1000: 5.0}}, drift, 1e-6
    return {key: {1000: 5.0}}, drift, 1e-8


def test_validator_detects_mismatches():
    """The comparison must fail on wrong values, missing series and
    out-of-tolerance drift — a validator that cannot fail validates
    nothing — and report each case exactly as the reference's does."""
    ref = _reference_validator()
    got = {}
    for case in DETECTION_CASES:
        raw, ds, rtol = _detection_inputs(case)
        got[case] = mod.compare_results(raw, ds, rtol=rtol)
        assert got[case] == ref.compare_results(raw, ds, rtol=rtol), case
    assert got["clean"]["compared"] == 4 and got["clean"]["mismatches"] == 0
    c = got["wrong_value"]
    assert c["mismatches"] == 1 and c["max_rel_err"] > 0.3
    assert got["missing_series"]["missing_ds_series"] == 1
    # an interior dropped bucket is lost data; trailing lag is not
    assert got["interior_gap_vs_lag"]["missing_ds_points"] == 1
    assert got["drift_inside_rtol"]["mismatches"] == 0
    assert got["drift_outside_rtol"]["mismatches"] == 1
    # the family's name is the reference's
    assert mod.ds_family("prometheus", RES) \
        == ref._family("prometheus", RES)
    assert mod.ds_family("prometheus", 15_000) == "prometheus:ds_15s"


@pytest.mark.slow
def test_validator_on_two_node_cluster(tmp_path):
    """Downsample families on a two-node cluster: each node serves its own
    shard's family from its sink and routes the peer's shard through
    cross-node dispatch — the validator passes against either node's
    port, seeing every series."""
    from filodb_tpu_torch.ingest.broker import BrokerBus, BrokerServer

    broker = BrokerServer(str(tmp_path / "broker"), num_partitions=2).start()
    reg = str(tmp_path / "members.jsonl")

    def server(name):
        return FiloServer(Config({
            "num_shards": 2, "bus_addr": f"127.0.0.1:{broker.port}",
            "data_dir": str(tmp_path / "data" / name.replace(":", "_")),
            "http": {"port": 0},
            "cluster": {"registrar": reg, "self_addr": name,
                        "heartbeat_interval": "200ms", "stale_after": "5s",
                        "min_members": 2, "join_timeout": "20s"},
            "downsample": {"enabled": True, "resolutions": ["1m"],
                           "serve_interval": "500ms"},
            "store": {"max_series_per_shard": 16, "samples_per_series": 128,
                      "flush_batch_size": 10**9, "groups_per_shard": 1},
        }), device="cpu")

    servers, errors = {}, {}

    def starter(n):
        try:
            servers[n] = server(n).start()
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors[n] = e

    threads = [threading.Thread(target=starter, args=(n,))
               for n in ("node-a:1", "node-b:1")]
    for t in threads:
        t.start()
    try:
        for t in threads:
            t.join(timeout=40)
        assert not errors, f"server start failed: {errors}"
        assert set(servers) == {"node-a:1", "node-b:1"}, \
            f"server start hung: {sorted(servers)}"
        rng = np.random.default_rng(5)
        for s in (0, 1):
            bus = BrokerBus(f"127.0.0.1:{broker.port}", s)
            bld = RecordBuilder(GAUGE)
            for i in range(2):
                vals = 40.0 * (s * 2 + i + 1) + rng.normal(0, 3, 60)
                for t in range(60):
                    bld.add({"_metric_": "m", "host": f"s{s}h{i}"},
                            BASE + 500 + t * 7_000, float(vals[t]))
            bus.publish(bld.build())
            bus.close()
        for srv in servers.values():
            _wait_series(srv, sorted(srv._running), 2 * len(srv._running))

        def all_four(r):
            return all(c["series_raw"] == 4 and c["series_ds"] == 4
                       for c in r["checks"].values())

        for srv in servers.values():
            report = _wait_ok(f"http://127.0.0.1:{srv.http.port}", all_four,
                              timeout_s=90)
            assert report is not None and report["ok"], (srv.node, report)
            for col, c in report["checks"].items():
                assert c["series_raw"] == 4 and c["series_ds"] == 4, \
                    (srv.node, col, c)
                assert c["mismatches"] == 0 and c["missing_ds_series"] == 0
    finally:
        for srv in servers.values():
            srv.shutdown()
        broker.stop()


def test_cli_validates_a_live_server(tmp_path):
    """``python -m filodb_tpu_torch.scripts.downsample_validator`` with the
    reference's arguments validates a live port server (exit 0, an ok JSON
    report, the in-process report's count). It takes no ``--device``: an
    HTTP client computes nothing on a device, and runs where there is no
    card."""
    srv = _one_node(tmp_path, series=2)
    try:
        url = f"http://127.0.0.1:{srv.http.port}"
        report = _wait_ok(url, lambda r: all(
            c["series_ds"] == 2 and c["compared"] >= 2 * 4
            for c in r["checks"].values()))
        assert report is not None and report["ok"], report
        args = ["--url", url, "--metric", "m", "--start", str(BASE / 1000),
                "--end", str((BASE + 60 * 7_000) / 1000)]
        env = dict(os.environ, PYTHONPATH=ROOT)
        out = subprocess.run(
            [sys.executable, "-m",
             "filodb_tpu_torch.scripts.downsample_validator", *args],
            env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        got = json.loads(out.stdout)
        assert got["ok"] and got["checked"] == report["checked"]
        assert set(got) == set(report)
    finally:
        srv.shutdown()
