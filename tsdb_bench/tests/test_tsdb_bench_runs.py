"""Each cell end to end on the CPU at a small size: the window's answers
judged against the plain reference (correct), the control and the planted
faults judged the same way (not correct)."""

import numpy as np
import pytest
import torch

from tsdb_bench import harness, readings
from tsdb_bench.tests.small import SMALL

BENCH = harness.load_bench()
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2_305_843_009_213_693_951          # larger than 32 signed bits hold


def run(cell, seed=SEED, traced=False, seconds=1.0):
    cfg = harness.by_name(BENCH["workloads"], cell, "workload")["config"]
    return harness.run_cell(BENCH, cell, seed, seconds, traced, "cpu",
                            cfg_override=SMALL[cfg], log=lambda *a: None)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_cpu(cell):
    out = run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    e2e = {m["name"] for m in harness.cell_metrics(BENCH, cell,
                                                   "end_to_end")}
    assert set(out["metrics"]) == e2e
    rate = [n for n in e2e if harness.quantity(n) == "queries_per_s"]
    assert len(rate) == 1 and out["metrics"][rate[0]]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_the_host_side_layers(cell):
    out = run(cell, traced=True)
    assert out["correct"], out["checks"]
    # the device's metrics need the card; the program's spans, counters
    # and stage times, and the host's clock, are read on any host: each
    # such metric the cell lists finds something to read
    host_side = {m["name"] for m in harness.cell_metrics(
        BENCH, cell, "per_layer") if m["source"] != "device_trace"}
    assert host_side and host_side <= set(out["metrics"]), out["metrics"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_number(cell):
    """The reference in bfloat16, put in the program's place, fails at
    least one of the cell's limits."""
    c = harness.by_name(BENCH["workloads"], cell, "workload")
    cfg = harness.load_config(BENCH, c["config"])
    cfg.update(SMALL[c["config"]])
    traffic = harness.load_traffic(c["traffic"])
    got = readings.control_readings(cfg, traffic, SEED, torch.device("cpu"))
    limits = {f"{q['name']}.{n}": lim for q in traffic["queries"]
              for n, lim in q["limits"].items()}
    assert set(got) == set(limits)
    assert any(got[k] > limits[k] for k in got), got


def alter_answer(monkeypatch):
    """An answer altered where the engine produces it: its first present
    value moved by 1 %."""
    from filodb_tpu_torch.query.engine import QueryEngine
    orig = QueryEngine.query_range

    def altered(self, *a, **k):
        r = orig(self, *a, **k)
        v = r.matrix.values
        v = v.clone() if torch.is_tensor(v) else np.array(v, copy=True)
        flat = v.reshape(-1)
        i = int(np.flatnonzero(~np.isnan(np.asarray(flat, np.float64)))[0])
        flat[i] = flat[i] * 1.01 + 1.0
        r.matrix.values = v
        return r
    monkeypatch.setattr(QueryEngine, "query_range", altered)


def drop_half(monkeypatch):
    """Half of the series left out of every selection: the aggregates run
    over the rest."""
    from filodb_tpu_torch.core.memstore import TimeSeriesShard
    orig = TimeSeriesShard.part_ids_from_filters

    def half(self, *a, **k):
        return orig(self, *a, **k)[::2]
    monkeypatch.setattr(TimeSeriesShard, "part_ids_from_filters", half)


@pytest.mark.parametrize("fault", [alter_answer, drop_half],
                         ids=["answer_altered", "half_left_out"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = run(cell)
    assert not out["correct"], out["checks"]


def test_histograms_hold_whole_counts_and_all_compress():
    """Bucket counts are whole numbers, as an exporter's are, growing over
    time and over the buckets; so the shard's own flush holds every row in
    the i8 2D-delta form and leaves its raw pool empty."""
    from tsdb_bench.data import histograms as data
    from tsdb_bench.deploy import histograms as deploy
    cfg = harness.load_config(BENCH, "prom_hist_131k")
    cfg.update(SMALL["prom_hist_131k"])
    assert cfg["buckets"] == 64
    dev = torch.device("cpu")
    for _r0, c, count, total in data.blocks(cfg, SEED, dev):
        assert torch.equal(c, torch.round(c))
        assert bool((torch.diff(c, dim=1) >= 0).all())
        assert bool((torch.diff(c, dim=2) >= 0).all())
        assert bool((torch.diff(total, dim=1) >= 0).all())
        assert torch.equal(count, c[..., -1])
    dep = deploy.build(cfg, SEED, dev)
    dd, _first_d, ok = dep.shards[0].store.hist_operands()
    assert dd.dtype == torch.int8 and bool(np.all(ok))
