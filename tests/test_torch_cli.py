"""The port's filo-cli (``python -m filodb_tpu_torch.cli``) against the JAX
package's: every read verb run by both CLIs against one port server prints
the same thing; the write verbs (``dataset create``, ``importcsv``) write
the same bytes; ``serve`` and ``broker`` run as processes; and
``entry.dryrun_multichip``'s step 5 (two FiloServer processes over one
broker) on the CPU.

Tolerance: none — outputs and files must be equal (the query payload's
per-run stage timings aside).
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from filodb_tpu import cli as jcli
from filodb_tpu_torch import cli as tcli
from filodb_tpu_torch.config import Config
from filodb_tpu_torch.core.record import RecordBuilder
from filodb_tpu_torch.core.schemas import GAUGE
from filodb_tpu_torch.ingest.bus import FileBus
from filodb_tpu_torch.standalone import FiloServer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = 1_700_000_000_000
IV = 10_000
N = 40


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    """A port FiloServer on the CPU: 2 shards fed from file buses."""
    tmp = tmp_path_factory.mktemp("cli")
    bus_dir = tmp / "bus"
    os.makedirs(bus_dir)
    for s in (0, 1):
        b = RecordBuilder(GAUGE)
        for i in range(4):
            b.add_batch({"_metric_": "m", "host": f"s{s}h{i}",
                         "dc": f"dc{i % 2}"},
                        BASE + np.arange(N, dtype=np.int64) * IV,
                        np.arange(N, dtype=float) * (i + 1))
        FileBus(str(bus_dir / f"shard{s}.log")).publish(b.build())
    srv = FiloServer(Config({
        "num_shards": 2, "bus_dir": str(bus_dir), "http": {"port": 0},
        "store": {"max_series_per_shard": 16, "samples_per_series": 64,
                  "flush_batch_size": 10**9}}), device="cpu").start()
    host = f"http://127.0.0.1:{srv.http.port}"
    deadline = time.time() + 30
    while time.time() < deadline:
        with_data = [sh for sh in srv.memstore.shards_of("prometheus")
                     if sh.num_series == 4]
        if len(with_data) == 2:
            break
        time.sleep(0.1)
    try:
        yield srv, host
    finally:
        srv.shutdown()


def _run(capsys, main, argv):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _both(capsys, argv):
    t = _run(capsys, tcli.main, argv)
    j = _run(capsys, jcli.main, argv)
    return t, j


@pytest.mark.parametrize("argv", [
    ["labelvalues", "dc"],
    ["labelvalues", "host"],
    ["series", 'm{dc="dc0"}'],
    ["series", "m", "--start", str(BASE // 1000),
     "--end", str(BASE // 1000 + N * 10)],
    ["status"],
    ["status", "--dataset", "prometheus"],
    ["status", "--dataset", "prometheus", "--shard", "1"],
    ["status", "--dataset", "nope"],
    ["cluster"],
    ["dataset", "list", "--host", "{host}"],
])
def test_read_verbs_print_what_the_jax_cli_prints(server, capsys, argv):
    _srv, host = server
    argv = [a.replace("{host}", host) for a in argv]
    if "--host" not in argv and argv[0] != "dataset":
        argv += ["--host", host]
    (trc, tout, terr), (jrc, jout, jerr) = _both(capsys, argv)
    assert (trc, tout, terr) == (jrc, jout, jerr)
    assert tout or terr


@pytest.mark.parametrize("promql", ["sum(rate(m[2m]))", "m",
                                    "count by (dc) (m)"])
def test_query_verb_prints_the_jax_clis_data(server, capsys, promql):
    _srv, host = server
    argv = ["query", promql, "--host", host,
            "--start", str(BASE // 1000 + 120),
            "--end", str(BASE // 1000 + 390), "--step", "30s"]
    (trc, tout, _), (jrc, jout, _) = _both(capsys, argv)
    assert trc == jrc == 0
    t, j = json.loads(tout), json.loads(jout)
    assert t["data"] == j["data"] and t["data"]["result"]
    # the stats object carries this run's stage timings: keys, not values
    assert set(t["stats"]) == set(j["stats"])


def test_dataset_verbs_write_what_the_jax_cli_writes(tmp_path, capsys):
    for name, main in (("port", tcli.main), ("jax", jcli.main)):
        d = str(tmp_path / name)
        assert _run(capsys, main, ["dataset", "create", "--data-dir", d,
                                   "--dataset", "metrics", "--schema",
                                   "prom-counter", "--shards", "2"])[0] == 0
        assert _run(capsys, main, ["dataset", "create", "--data-dir", d,
                                   "--dataset", "x", "--schema",
                                   "nope"])[0] == 1
    for root, _dirs, files in os.walk(tmp_path / "jax"):
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), tmp_path / "jax")
            assert (tmp_path / "port" / rel).read_bytes() == \
                (tmp_path / "jax" / rel).read_bytes(), rel
    for argv in (["dataset", "list", "--data-dir", "{d}"],
                 ["dataset", "validate", "--schema", "gauge"],
                 ["dataset", "validate"],
                 ["dataset", "validate", "--schema", "nope"],
                 ["dataset", "list"]):
        t = _run(capsys, tcli.main,
                 [a.replace("{d}", str(tmp_path / "port")) for a in argv])
        j = _run(capsys, jcli.main,
                 [a.replace("{d}", str(tmp_path / "jax")) for a in argv])
        assert t == j, argv


def test_importcsv_publishes_the_jax_clis_bytes(tmp_path, capsys):
    p = tmp_path / "d.csv"
    rows = ["metric,timestamp,value,labels"] + [
        f"cpu,{1000 * (t + 1)},{t}.5,host=h{t % 3}" for t in range(2500)]
    p.write_text("\n".join(rows) + "\n")
    t = _run(capsys, tcli.main, ["importcsv", str(p), "--bus",
                                 str(tmp_path / "t.log")])
    j = _run(capsys, jcli.main, ["importcsv", str(p), "--bus",
                                 str(tmp_path / "j.log")])
    assert t[0] == j[0] == 0
    assert t[1].replace("t.log", "") == j[1].replace("j.log", "")
    assert (tmp_path / "t.log").read_bytes() == \
        (tmp_path / "j.log").read_bytes()


def _spawn(args, tmp_path, name):
    log = open(tmp_path / f"{name}.log", "w")
    p = subprocess.Popen([sys.executable, "-m", "filodb_tpu_torch.cli"]
                         + args, cwd=ROOT, stdout=log,
                         stderr=subprocess.STDOUT,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    return p, log


def _first_line(tmp_path, name, p, needle, deadline_s=60):
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        text = (tmp_path / f"{name}.log").read_text()
        for line in text.splitlines():
            if needle in line:
                return line
        assert p.poll() is None, text
        time.sleep(0.1)
    raise AssertionError(f"{name}: {needle!r} never printed")


def _stop(p, log):
    if p.poll() is None:
        p.send_signal(signal.SIGTERM)
    try:
        rc = p.wait(timeout=30)
    except subprocess.TimeoutExpired:
        p.kill()
        rc = p.wait(timeout=10)
    log.close()
    return rc


def test_serve_runs_a_filoserver_with_seed_data(tmp_path):
    import urllib.request
    cfg = tmp_path / "server.json"
    cfg.write_text(json.dumps({"http": {"port": 0}, "num_shards": 2,
                               "store": {"max_series_per_shard": 256,
                                         "samples_per_series": 128}}))
    p, log = _spawn(["serve", "--config", str(cfg), "--device", "cpu",
                     "--seed-data"], tmp_path, "serve")
    try:
        line = _first_line(tmp_path, "serve", p, "serving dataset")
        assert "'prometheus'" in line and "(cpu)" in line
        port = int(line.split(" on :")[1].split()[0])
        q = ("/promql/prometheus/api/v1/query?query=count(heap_usage0)"
             "&time=1091")
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{q}") as r:
            res = json.load(r)["data"]["result"]
        # SyntheticStream's 100 instances, spread over the two shards
        assert float(res[0]["value"][1]) == 100.0
    finally:
        assert _stop(p, log) == 0


def test_serve_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves to it")
    out = subprocess.run([sys.executable, "-m", "filodb_tpu_torch.cli",
                          "serve", "--port", "0"], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "DeviceUnavailable" in out.stderr


def test_broker_verb_serves_a_replicated_pair(tmp_path):
    """Two ``broker`` processes from one config (bus_addrs, replication 2):
    a publish through one lands on both, readable from either."""
    from filodb_tpu_torch.core.schemas import Schemas
    from filodb_tpu_torch.ingest.broker import BrokerBus
    from filodb_tpu_torch.parallel.bootstrap import free_port
    ports = [free_port(), free_port()]
    addrs = [f"127.0.0.1:{q}" for q in ports]
    cfg = tmp_path / "broker.json"
    cfg.write_text(json.dumps({"bus_addrs": addrs, "num_shards": 2,
                               "ingest": {"replication": 2}}))
    procs = []
    try:
        for i, port in enumerate(ports):
            procs.append(_spawn(["broker", "--config", str(cfg),
                                 "--data-dir", str(tmp_path / f"b{i}"),
                                 "--node-index", str(i), "--port",
                                 str(port)], tmp_path, f"broker{i}"))
        for i, (p, _log) in enumerate(procs):
            line = _first_line(tmp_path, f"broker{i}", p, "serving")
            assert "(replicated)" in line and "2 partition(s)" in line
        b = RecordBuilder(GAUGE)
        b.add({"_metric_": "m", "host": "h"}, BASE, 1.0)
        c = b.build()
        bus = BrokerBus(addrs, 1)
        try:
            assert bus.publish(c) == 0
        finally:
            bus.close()
        for a in addrs:
            reader = BrokerBus([a], 1)
            try:
                (off, got), = list(reader.consume(Schemas()))
            finally:
                reader.close()
            assert off == 0 and got.to_bytes() == c.to_bytes()
    finally:
        for p, log in procs:
            assert _stop(p, log) == 0

