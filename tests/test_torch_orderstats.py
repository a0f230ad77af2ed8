"""The order statistics against the JAX package: topk/bottomk, quantile,
count_values.

- The quantile sketch: the port counts on the device (here the CPU) what
  the reference counts with host numpy. On data with no value within 1e-9
  relative of a bucket edge the counts are equal (the test asserts that
  condition: a different ``log`` may put a value an ulp from an edge one
  bucket over); on unrestricted data the presented quantile stays within
  the sketch's relative error, (gamma - 1) / (gamma + 1) = 1.96 %, of the
  exact one.
- The full-matrix helpers (``topk_mask``, ``group_quantile``) equal the
  reference's on ties, NaN and several groups.
- Engines over two shards: per-shard partials merge at the reduce
  (``_merge_topk``/``_merge_sketch``/``_merge_count_values``), and a shard
  whose group count passes the 64-group cap falls back to its full matrix
  and is normalized there (``_merge_heterogeneous``) or presented whole.
  Keys, NaN placement and values as in tests/test_torch_general_query.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from filodb_tpu.core.memstore import StoreConfig as JStoreConfig
from filodb_tpu.core.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.core.record import RecordBuilder as JRecordBuilder
from filodb_tpu.core.schemas import GAUGE as JGAUGE
from filodb_tpu.ops import aggregators as jagg
from filodb_tpu.query.engine import QueryEngine as JQueryEngine
from filodb_tpu_torch.core.memstore import StoreConfig, TimeSeriesMemStore
from filodb_tpu_torch.core.record import RecordBuilder
from filodb_tpu_torch.core.schemas import GAUGE
from filodb_tpu_torch.ops import aggregators as tagg
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.query.exec import MatrixView, _map_topk
from filodb_tpu_torch.query.rangevector import RangeVectorKey

START = 1_600_000_000_000
IV = 10_000
N_SAMPLES = 60
RANGE = (START + 300_000, START + 590_000, 30_000)


def edge_distance(vals):
    """Relative distance of each finite non-zero value to its nearest
    sketch bucket edge SKETCH_MIN * gamma^k."""
    mag = np.abs(vals[np.isfinite(vals) & (vals != 0)])
    k = np.round(np.log(mag / tagg.SKETCH_MIN) / np.log(tagg.SKETCH_GAMMA))
    edge = tagg.SKETCH_MIN * np.power(tagg.SKETCH_GAMMA, k)
    return np.abs(mag / edge - 1.0)


def sketch_data(rng, P=40, T=12):
    """Values over many magnitudes and both signs, zeros, +-Inf and NaN."""
    vals = (rng.choice([-1.0, 1.0], (P, T))
            * np.exp(rng.uniform(-20, 30, (P, T))))
    vals[rng.random((P, T)) < 0.05] = 0.0
    vals[rng.random((P, T)) < 0.1] = np.nan
    vals[0, 0], vals[1, 1], vals[2, 2] = np.inf, -np.inf, 1e-13
    return vals


def test_sketch_counts_equal_the_reference():
    rng = np.random.default_rng(2)
    vals = sketch_data(rng)
    assert (edge_distance(vals) > 1e-9).all()
    gids = rng.integers(0, 3, vals.shape[0]).astype(np.int32)
    ref = jagg.quantile_sketch(vals, gids, 3)
    got = tagg.quantile_sketch(torch.from_numpy(vals), torch.from_numpy(gids),
                               3)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    for q in (0.0, 0.25, 0.5, 0.99, 1.0, -0.5, 1.5):
        np.testing.assert_array_equal(
            tagg.present_quantile_sketch(got.numpy(), q),
            jagg.present_quantile_sketch(ref, q))


def test_sketch_quantile_within_its_relative_error():
    """Unrestricted positive data (exact powers of gamma included): each
    presented quantile within 1.96 % of the exact PromQL quantile."""
    rng = np.random.default_rng(3)
    P, T = 500, 6
    vals = rng.exponential(3.0, (P, T)) * 10.0 ** rng.integers(-3, 4, (P, T))
    vals[:10, 0] = tagg.SKETCH_MIN * tagg.SKETCH_GAMMA ** np.arange(600, 610)
    counts = tagg.quantile_sketch(torch.from_numpy(vals),
                                  torch.zeros(P, dtype=torch.int32), 1).numpy()
    bound = (tagg.SKETCH_GAMMA - 1) / (tagg.SKETCH_GAMMA + 1)
    assert abs(bound - 0.0196) < 1e-4
    for q in (0.01, 0.1, 0.5, 0.9, 0.99):
        got = tagg.present_quantile_sketch(counts, q)[0]
        want = np.quantile(vals, q, axis=0)            # linear: PromQL's rank
        assert (np.abs(got / want - 1.0) <= bound).all(), (q, got, want)


@pytest.mark.parametrize("bottom", (False, True))
@pytest.mark.parametrize("k", (1, 3, 40))
def test_topk_mask_matches_the_reference(k, bottom):
    rng = np.random.default_rng(4)
    vals = rng.integers(0, 4, (37, 9)).astype(np.float64)   # many ties
    vals[rng.random(vals.shape) < 0.2] = np.nan
    vals[3, 2], vals[4, 2] = np.inf, -np.inf
    gids = rng.integers(0, 5, 37).astype(np.int32)
    ref = np.asarray(jagg.topk_mask(jnp.asarray(vals), jnp.asarray(gids), 8,
                                    k, bottom))
    got = tagg.topk_mask(torch.from_numpy(vals), torch.from_numpy(gids), 8, k,
                         bottom)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("q", (0.0, 0.3, 0.5, 0.99, 1.0))
def test_group_quantile_matches_the_reference(q):
    rng = np.random.default_rng(5)
    vals = rng.normal(0, 10, (41, 7))
    vals[rng.random(vals.shape) < 0.25] = np.nan
    vals[:, 3] = np.nan                                    # an empty step
    gids = rng.integers(0, 6, 41).astype(np.int32)
    ref = np.asarray(jagg.group_quantile(jnp.asarray(vals), jnp.asarray(gids),
                                         8, q))
    got = tagg.group_quantile(torch.from_numpy(vals), torch.from_numpy(gids),
                              8, q).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got, ref, rtol=1e-12, equal_nan=True)


def test_map_topk_breaks_ties_to_the_lower_row():
    """All-equal values: the first k selected rows at each step are the k
    lowest of the selection, for topk and bottomk alike; pad rows (beyond
    the keys) never appear."""
    R, T, k = 16, 5, 3
    vals = torch.full((R, T), 7.0, dtype=torch.float64)
    keys = [RangeVectorKey((("inst", f"i{i}"),)) for i in range(10)]
    m = MatrixView(np.arange(T, dtype=np.int64), vals, keys,
                   np.arange(10, dtype=np.int32)[::-1].copy())
    for bottom in (False, True):
        p = _map_topk(m, np.zeros(R, np.int32), [RangeVectorKey(())], 1, k,
                      bottom, torch.device("cpu"))
        assert [kt.labels for kt in p.key_table] == \
            [keys[9 - r].labels for r in range(k)]
        np.testing.assert_array_equal(p.values, 7.0)


# -- engines over two shards --------------------------------------------------

def samples():
    """Shard 0: 72 ``g`` series, each its own ``inst`` (past the 64-group
    cap for ``by (inst)``) plus 24 counters ``m``; shard 1: 8 ``g`` series
    and 24 counters."""
    rng = np.random.default_rng(9)
    shards = ([], [])
    for s in range(80):
        shard = shards[0 if s < 72 else 1]
        shard.append(({"_metric_": "g", "host": f"h{s % 4}", "inst": f"i{s}"},
                      rng.integers(0, 8, N_SAMPLES).astype(np.float64)))
    for s in range(48):
        shards[s % 2].append(
            ({"_metric_": "m", "host": f"h{s % 4}", "inst": f"c{s}"},
             np.cumsum(rng.exponential(5.0, N_SAMPLES))))
    return shards


def ingest(shard, builder_cls, schema, data):
    for t in range(N_SAMPLES):
        b = builder_cls(schema)
        for labels, vals in data:
            b.add(labels, START + t * IV, float(vals[t]))
        shard.ingest(b.build())
    shard.flush()


@pytest.fixture(scope="module")
def engines():
    data = samples()
    jms = JMemStore()
    tms = TimeSeriesMemStore(device="cpu")
    for s in range(2):
        ingest(jms.setup("p", JGAUGE, s, JStoreConfig(
            max_series_per_shard=128, samples_per_series=64,
            flush_batch_size=10**9)), JRecordBuilder, JGAUGE, data[s])
        ingest(tms.setup("p", GAUGE, s, StoreConfig(
            max_series_per_shard=128, samples_per_series=64,
            flush_batch_size=10**9, device="cpu")), RecordBuilder, GAUGE,
            data[s])
    return JQueryEngine(jms, "p"), QueryEngine(tms, "p", device="cpu")


TWO_SHARD_QUERIES = (
    # per-shard partials merged at the reduce
    "topk(3, rate(m[5m]))", "bottomk(5, g)", "topk by (host) (2, g)",
    "quantile(0.9, rate(m[5m]))", "quantile by (host) (0.25, g)",
    'count_values("v", g)', 'count_values by (host) ("x", g)',
    "sum by (host) (rate(m[5m]))", "max(g)",
    # shard 0 past the 64-group cap: its full matrix is normalized into
    # the partial form of shard 1's
    "topk by (inst) (1, g)", "bottomk by (inst) (1, g)",
    "quantile by (inst) (0.5, g)", 'count_values by (inst) ("v", g)',
    # both shards past the cap through one full matrix: the presenter's
    # full-matrix path
    "topk by (inst) (1, g or m)", "quantile by (inst) (0.5, g or m)",
    'count_values by (inst) ("v", g or m)',
)
EXACT = {"bottomk(5, g)", "topk by (host) (2, g)", 'count_values("v", g)',
         'count_values by (host) ("x", g)', "max(g)", "topk by (inst) (1, g)",
         "bottomk by (inst) (1, g)", 'count_values by (inst) ("v", g)',
         'count_values by (inst) ("v", g or m)', "quantile by (inst) (0.5, g)",
         "quantile by (host) (0.25, g)"}


@pytest.mark.parametrize("q", TWO_SHARD_QUERIES)
def test_two_shards_match_the_jax_engine(engines, q):
    jeng, teng = engines
    ref = jeng.query_range(q, *RANGE)
    got = teng.query_range(q, *RANGE)
    assert [k.labels for k in got.matrix.keys] == \
        [k.labels for k in ref.matrix.keys], q
    r = np.asarray(ref.matrix.values, np.float64)
    g = np.asarray(got.matrix.values, np.float64)
    assert g.shape == r.shape and g.shape[0] > 0, q
    np.testing.assert_array_equal(np.isnan(g), np.isnan(r), err_msg=q)
    if q in EXACT:
        np.testing.assert_array_equal(g, r, err_msg=q)
    else:
        scale = float(np.nanmax(np.abs(r)))
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5 * scale,
                                   equal_nan=True, err_msg=q)
    assert got.stats.fused_kernels == ref.stats.fused_kernels, q
