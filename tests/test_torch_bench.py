"""The port's bench and entry step against the JAX package's, on the CPU.

``filodb_tpu_torch.bench.build_engine`` builds bench.py's shard at a small
size (2048 series x 100 samples, capacity 128) through the real ingest
path; bench.py's own ``build_engine``, its size constants patched down, builds
the JAX shard the same way, and the port's value block (numpy) is installed
in it. Both engines then answer ``sum(rate(m[5m]))`` over bench.py's 8 range
variants: rtol 1e-5 of the largest magnitude (the fused folds sum rows in
different orders). The concurrent harness must give every answer bit-equal
to its variant's; the result line must carry bench.py's metric name and
``detail`` keys. ``entry()`` is held against ``__graft_entry__.entry()``.
"""

import ast
import contextlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
import bench
from filodb_tpu.ops import fusedresident as jfusedresident
from filodb_tpu_torch import bench as tbench
from filodb_tpu_torch.device import DeviceUnavailable
from filodb_tpu_torch.entry import entry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(num_series=2048, num_samples=100, capacity=128)
# bench.py's own batch sizes, patched down with its shape for the JAX build
JAX_SMALL = dict(NUM_SERIES=2048, NUM_SAMPLES=100, CAPACITY=128,
                 REG_BATCH=1024, DATA_BATCH=512)


@contextlib.contextmanager
def jax_xla_mode():
    old = jfusedresident.mode()
    jfusedresident.set_mode("xla")
    try:
        yield
    finally:
        jfusedresident.set_mode(old)


@pytest.fixture(scope="module")
def engines():
    """(port engine, port shard, JAX engine, JAX shard) over one block."""
    teng, tshard, _reg = tbench.build_engine("cpu", **SMALL)
    with pytest.MonkeyPatch.context() as mp:
        for name, value in JAX_SMALL.items():
            mp.setattr(bench, name, value)
        jeng, jshard, _jreg = bench.build_engine()
    jshard.store.val = jnp.asarray(tshard.store.val.numpy())
    return teng, tshard, jeng, jshard


def test_build_engine_registers_like_bench(engines):
    _teng, tshard, _jeng, jshard = engines
    assert tshard.num_series == jshard.num_series == SMALL["num_series"]
    tst, jst = tshard.store, jshard.store
    np.testing.assert_array_equal(tst.ts.numpy(), np.asarray(jst.ts))
    np.testing.assert_array_equal(tst.n.numpy(), np.asarray(jst.n))
    np.testing.assert_array_equal(tst.last_ts, jst.last_ts)
    assert (tst.grid_base, tst.grid_interval, tst.grid_ok) == \
        (jst.grid_base, jst.grid_interval, jst.grid_ok)
    val = tst.val.numpy()
    assert np.isfinite(val).all()
    assert (np.diff(val[:, :100], axis=1) >= 0).all()
    assert (val[:, 100:] == 0).all()


@pytest.mark.parametrize("k", range(tbench.NUM_VARIANTS))
def test_sum_rate_over_each_variant_matches_jax(engines, k):
    teng, tshard, jeng, _jshard = engines
    s, e = tbench.range_variants(tshard)[k]
    start = bench.BASE_TS + bench.WINDOW_MS
    assert (s, e) == (start + k * bench.INTERVAL_MS,
                      bench.BASE_TS + (SMALL["num_samples"] - k)
                      * bench.INTERVAL_MS)
    with jax_xla_mode():
        ref = jeng.query_range(tbench.QUERY, s, e, bench.STEP_MS)
    got = teng.query_range(tbench.QUERY, s, e, bench.STEP_MS)
    r = np.asarray(ref.matrix.values, np.float64)
    g = np.asarray(got.matrix.values, np.float64)
    assert g.shape == r.shape == (1, len(ref.matrix.out_ts))
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, r, rtol=1e-5,
                               atol=1e-5 * float(np.abs(r).max()))
    assert got.stats.fused_kernels == ref.stats.fused_kernels == 1
    # the runner's answer is the engine's
    run = tbench.query_runner(teng, tbench.range_variants(tshard))
    np.testing.assert_array_equal(run(k), g[0])


def test_concurrent_rounds_answer_bit_equal(engines):
    teng, tshard, _jeng, _jshard = engines
    run = tbench.query_runner(teng, tbench.range_variants(tshard))
    expect = [run(k) for k in range(tbench.NUM_VARIANTS)]
    rounds = tbench.concurrent_rounds(run, expect, queries=64, workers=8)
    assert len(rounds) == tbench.ROUNDS and all(r > 0 for r in rounds)


def test_concurrent_rounds_refuse_a_divergent_answer():
    expect = [np.arange(3.0), np.arange(3.0) + 1]

    def run(i):
        return expect[i % 2] + (i == 37)
    with pytest.raises(RuntimeError, match="concurrent query 37"):
        tbench.concurrent_rounds(run, expect, queries=64, workers=8)


def bench_result_keys():
    """bench.py's metric name and ``detail`` keys, read from its source."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys = [k.value for k in node.keys if isinstance(k, ast.Constant)]
            if "metric" in keys and "detail" in keys:
                metric = node.values[keys.index("metric")].value
                detail = node.values[keys.index("detail")]
                return metric, {k.value for k in detail.keys}
    raise AssertionError("bench.py's result dict not found")


def test_result_line_has_bench_metric_and_detail_keys(engines, monkeypatch):
    teng, tshard, _jeng, _jshard = engines
    monkeypatch.setattr(tbench, "measure_baseline_proxy", lambda: (
        tbench.JVM_BASELINE_EST_MS, "estimate_100M_evals_per_sec", 0.0))
    res = tbench.measure(teng, tshard, 1.0, queries=64, workers=8)
    metric, keys = bench_result_keys()
    assert res["metric"] == metric == tbench.METRIC
    assert {"metric", "value", "unit", "vs_baseline", "detail"} <= set(res)
    assert keys <= set(res["detail"]), keys - set(res["detail"])
    d = res["detail"]
    assert d["series"] == SMALL["num_series"]
    assert d["samples_per_series"] == SMALL["num_samples"]
    assert d["device"] == "cpu" and d["hbm_stream_pass_device_ms"] is None
    assert len(d["per_query_ms_rounds"]) == tbench.ROUNDS
    assert res["value"] == min(d["per_query_ms_rounds"]) > 0
    assert d["baseline_per_query_ms_at_methodology"] == \
        tbench.JVM_BASELINE_EST_MS / (os.cpu_count() or 1)


def test_baseline_proxy_without_a_compiler_takes_the_estimate(monkeypatch,
                                                              tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    ms, how, secs = tbench.measure_baseline_proxy()
    assert (ms, how) == (tbench.JVM_BASELINE_EST_MS,
                         "estimate_100M_evals_per_sec")
    assert secs >= 0


def test_entry_points_without_a_card_raise():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves to it")
    with pytest.raises(DeviceUnavailable):
        tbench.build_engine(num_series=512, num_samples=10, capacity=128)
    with pytest.raises(DeviceUnavailable):
        tbench.main()
    with pytest.raises(DeviceUnavailable):
        entry()


def test_entry_matches_the_graft_entry():
    jfn, jargs = __graft_entry__.entry()
    ref = np.asarray(jfn(*jargs))
    fn, args = entry(device="cpu")
    got = fn(*args)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    got = got.numpy()
    assert got.shape == ref.shape == (1, 17) and got.dtype == np.float32
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * float(np.abs(ref).max()))
    # the same operands as the reference's entry, in its order
    assert len(args) == len(jargs) == 8
    for a, j in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy().reshape(-1),
                                      np.asarray(j).reshape(-1))
