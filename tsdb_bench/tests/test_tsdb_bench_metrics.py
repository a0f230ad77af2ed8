"""The metric arithmetic on synthetic traces, and the byte counts of the
rooflines against PERF.md's bounds at their shapes."""

import math

import numpy as np
import pytest

from tsdb_bench import harness, stats, trace
from tsdb_bench.reference import plain
from tsdb_bench.roofline import k1, k2, peaks

BENCH = harness.load_bench()


def req(q, ri, t0, t1, ok=True, stage=None):
    return harness.Request(q, ri, t0, t1, ok, stage or {})


def view(kernels, window_s, requests=(), counters=None, cell="c",
         cfg=None, traffic=None, ranges=None, spans=(), lost=0):
    busy = stats.busy_ns([(s, e) for _, s, e in kernels]) / 1e9
    dev = trace.DeviceTrace(list(kernels), stats.attribute(list(kernels)),
                            window_s, busy, list(spans), lost)
    return trace.RunView(cell, cfg or {}, traffic or {"queries": []},
                         ranges or [], list(requests), (0, window_s),
                         counters or {}, dev)


def test_idle_share_is_the_union_of_busy_intervals():
    ks = [("a", 0, 100), ("b", 50, 150), ("c", 400, 500), ("d", 450, 460)]
    assert stats.busy_ns([(s, e) for _, s, e in ks]) == 250
    read = harness.metric_reader("device_idle_share")
    assert read(view(ks, 1e-6)) == pytest.approx(75.0)
    assert read(view([], 1.0)) is None


def test_p95_is_over_all_requests_and_failures_miss_it():
    reqs = [req("q", 0, 0, i / 1000.0) for i in range(1, 101)]
    assert stats.percentile([r.latency_ms for r in reqs], 95) == \
        pytest.approx(95.0)
    reqs[-10:] = [req("q", 0, 0, 0.001, ok=False) for _ in range(10)]
    assert math.isinf(stats.percentile([r.latency_ms for r in reqs], 95))
    read = harness.metric_reader("sum_rate_p95_ms")
    assert read(view([], 1.0, reqs)) is None


def test_fold_goes_to_the_map_before_it():
    names = ["void (anonymous namespace)::fused_grid_map<0>(Params)",
             "void fold_chunks(float const*, float*, int, int)",
             "void (anonymous namespace)::fused_hist_map(Params)",
             "void fold_chunks(float const*, float*, int, int)",
             "void (anonymous namespace)::fold_steps(float const*, ...)",
             "void (anonymous namespace)::segfold<float, 1, true>(Params)",
             "void at::native::elementwise_kernel<128, 2>(...)"]
    fams = stats.attribute([(n, 0, 1) for n in names])
    assert fams == ["k1", "k1", "k2", "k2", "k2", "segfold", None]


def counter_cell():
    cell = "prom_counters_1m.sum_rate_dash"
    c = harness.by_name(BENCH["workloads"], cell, "workload")
    cfg = harness.load_config(BENCH, c["config"])
    traffic = harness.load_traffic(c["traffic"])
    return cell, cfg, traffic, plain.ranges_of(cfg, traffic)


def test_k1_roofline_share(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    cell, cfg, traffic, ranges = counter_cell()
    reqs = [req("sum_rate", 0, 0, 0.01), req("sum_rate", 7, 0, 0.01)]
    ms = 2_000_000                                  # 2 ms a launch
    ks = [("fused_grid_map<0>(P)", 0, ms - 10_000),
          ("void fold_chunks(float const*)", ms - 10_000, ms),
          ("fused_grid_map<0>(P)", 5 * ms, 6 * ms - 10_000),
          ("void fold_chunks(float const*)", 6 * ms - 10_000, 6 * ms),
          ("elementwise_kernel<128>", 6 * ms, 9 * ms)]
    want = sum(k1.query_bytes(cfg, plain.steps_of(ranges[r.range_idx]),
                              {"window_ms": 300000}) for r in reqs)
    read = harness.metric_reader("k1_roofline")
    got = read(view(ks, 1.0, reqs, {"k1_launches": 2}, cell, cfg, traffic,
                    ranges))
    assert got == pytest.approx(100 * want / 3.35e12 / (2 * ms / 1e9))
    # a launch the mix does not account for: nothing is read
    assert read(view(ks, 1.0, reqs, {"k1_launches": 3}, cell, cfg, traffic,
                     ranges)) is None


def test_per_query_device_times():
    reqs = [req("q", 0, 0, 0.01) for _ in range(4)]
    ks = [("segfold<float, 1, false>(P)", 0, 4_000_000),
          ("elementwise_kernel<128>", 4_000_000, 12_000_000),
          ("Memcpy HtoD (Pageable -> Device)", 12_000_000, 13_000_000)]
    v = view(ks, 1.0, reqs)
    assert harness.metric_reader("segfold_ms_per_query")(v) == \
        pytest.approx(1.0)
    assert harness.metric_reader("eager_device_ms_per_query")(v) == \
        pytest.approx(2.0)


def test_leaf_and_stage_readers():
    class Span:
        def __init__(self, name, us):
            self.name, self.duration_us = name, us
    reqs = [req("q", 0, 0, 0.01, stage={"parse": 0.25, "plan": 0.5}),
            req("q", 0, 0, 0.01, stage={"parse": 0.75})]
    v = view([], 1.0, reqs, {"shard_lock_contentions": 3},
             spans=[Span("query.exec.leaf", 3000), Span("query", 9000)])
    assert harness.metric_reader("parse_plan_ms")(v) == pytest.approx(0.75)
    assert harness.metric_reader("leaf_ms")(v) == pytest.approx(1.5)
    assert harness.metric_reader(
        "shard_lock_contentions_per_query")(v) == pytest.approx(1.5)
    v.device.spans_lost = 1
    assert harness.metric_reader("leaf_ms")(v) is None


def test_a_split_quantity_is_read_alike():
    """``leaf_ms.hist`` has no file of its own: it is ``leaf_ms`` read in
    the cells that report another end-to-end metric."""
    assert harness.quantity("leaf_ms.hist") == "leaf_ms"
    reqs = [req("q", 0, 0, 0.01, stage={"parse": 0.25, "plan": 0.5})]
    v = view([], 1.0, reqs)
    assert harness.metric_reader("parse_plan_ms.hist")(v) == \
        harness.metric_reader("parse_plan_ms")(v) == pytest.approx(0.75)


def test_a_per_layer_metric_without_cells_follows_what_it_moves():
    bench = {"end_to_end": [
        {"name": "a_per_s", "workloads": ["x"]},
        {"name": "a_per_s.y", "workloads": ["y"]}, {"name": "setup_s"}],
        "per_layer": [{"name": "m", "moves": "a_per_s"},
                      {"name": "m.y", "moves": "a_per_s.y"},
                      {"name": "k", "moves": "a_per_s.y",
                       "workloads": ["y"]}]}
    names = {c: [m["name"] for m in harness.cell_metrics(bench, c,
                                                         "per_layer")]
             for c in "xy"}
    assert names == {"x": ["m"], "y": ["m.y", "k"]}


def test_k1_bytes_hold_perf_bound():
    """PERF.md section 6: K1 raw at 2^20 x 768, 47 steps: 3.230 GB, 0.964 ms
    at 3.35 TB/s."""
    b = k1.bytes_needed(1 << 20, 768, 47)
    assert round(b / 1e9, 3) == 3.230
    assert round(b / peaks.bytes_per_s("NVIDIA H100 80GB HBM3") * 1e3, 3) \
        == 0.964


def test_k2_bytes_hold_perf_bound():
    """PERF.md section 6: K2 at 2^17 x 320 x 32 i8, one row in 16 pooled,
    39 steps: 1.153 GB, 0.3443 ms at 3.35 TB/s."""
    cfg = {"series": 1 << 17, "samples_per_series": 300, "buckets": 32,
           "pool_every": 16, "base_ts_ms": 1_700_000_000_000,
           "interval_ms": 10_000}
    rows = k2.kernel_rows(cfg)
    assert rows == (1 << 17) - (1 << 13)
    b = k2.bytes_needed(rows, 1 << 17, 288, 32, 39)
    assert round(b / 1e9, 3) == 1.153
    assert round(b / 3.35e12 * 1e3, 4) == 0.3443
    steps = np.arange(cfg["base_ts_ms"] + 600_000,
                      cfg["base_ts_ms"] + 2_900_001, 60_000)
    assert k2.query_bytes(cfg, steps, {}) == b


def test_peaks_by_card_name():
    assert peaks.bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert peaks.bytes_per_s("NVIDIA H100 NVL") == 3.9e12
    with pytest.raises(KeyError):
        peaks.bytes_per_s("a card nobody published")
