"""BENCHMARK.json against the benchmark's contract, and every piece it
names found by that name."""

import json
import re
from pathlib import Path

import pytest

from tsdb_bench import harness

ROOT = Path(harness.ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = harness.load_bench()


def line_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["tsdb_bench"]
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(line_ok(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and \
        1 <= BENCH["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_full_check_fits_the_budget_at_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and line_ok(cfg["source"]) and \
        line_ok(cfg["why"])
    assert cfg["file"].startswith("tsdb_bench/")
    data = harness.load_config(BENCH, cfg["name"])
    assert data["name"] == cfg["name"] and line_ok(data["source"])
    assert len(cfg["reduced"]) <= 16
    for key in cfg["reduced"]:
        assert NAME.match(key) and key in data and key in data["assumed"]
        assert not key.endswith(("_dim", "_rank")) and key != "buckets"
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] in (1, 4) and line_ok(cell["why"])
    traffic = harness.load_traffic(cell["traffic"])
    assert traffic["loop"] == "closed" and traffic["clients"] >= 1
    for q in traffic["queries"]:
        assert NAME.match(q["name"]) and q["weight"] >= 1
        assert all(v is not None for v in q["limits"].values()), \
            (q["name"], "a limit not set")
    e2e = harness.cell_metrics(BENCH, cell["name"], "end_to_end")
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    layer = harness.cell_metrics(BENCH, cell["name"], "per_layer")
    assert layer
    for m in BENCH["per_layer"]:
        if cell["name"] in m.get("workloads", ()):
            assert m["moves"] in names, (m["name"], "moves a metric the "
                                         "cell does not report")
    for m in layer:
        assert m["moves"] in names


def test_cells_unique_and_four_chip_share():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert 1 <= len(BENCH["workloads"]) <= 24
    names = [w["name"] for w in BENCH["workloads"]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    if "bound" in m:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert line_ok(m["layer"])
        assert callable(harness.metric_reader(m["name"]))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_layers_named_alike():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_every_piece_found_by_name():
    for cell in BENCH["workloads"]:
        cfg = harness.load_config(BENCH, cell["config"])
        harness.load_traffic(cell["traffic"])
        assert (Path(harness.PKG) / "data" / f"{cfg['data']}.py").exists()
        assert (Path(harness.PKG) / "deploy" / f"{cfg['builder']}.py").exists()
    for m in BENCH["per_layer"]:
        harness.metric_reader(m["name"])
    assert json.loads((ROOT / "BENCHMARK.json").read_text()) == BENCH
