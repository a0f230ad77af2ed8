"""The port's cluster control plane (ref: the reference's
``tests/test_cluster.py``; ShardManagerSpec, ShardMapperSpec,
FailureProviderSpec, HA federation through two in-process HTTP servers):
assignment, reassignment and events, time splits around failures, the
stitch, and the high-availability engine over port engines on the CPU.
The assignment must be the reference's for the same membership, so
mixed clusters agree on who owns what."""

import numpy as np
import pytest

from filodb_tpu_torch.parallel.cluster import (FailureProvider, FailureTimeRange,
                                         HighAvailabilityEngine, RemotePromExec,
                                         ShardManager, ShardStatus,
                                         plan_time_splits, stitch_matrices)
from filodb_tpu_torch.parallel.shardmapper import ShardMapper
from filodb_tpu_torch.query.rangevector import RangeVectorKey, ResultMatrix


def test_assignment_even_spread():
    sm = ShardManager()
    sm.add_node("node-a")
    sm.add_node("node-b")
    sm.add_dataset("prometheus", 8)
    per_node = {n: len(sm.shards_of_node("prometheus", n)) for n in ("node-a", "node-b")}
    assert per_node == {"node-a": 4, "node-b": 4}
    # a third node joining picks up nothing until shards free (no rebalance churn)
    sm.add_node("node-c")
    assert len(sm.shards_of_node("prometheus", "node-c")) == 0


def test_node_failure_reassigns_and_emits_events():
    sm = ShardManager()
    sm.add_node("a")
    sm.add_node("b")
    sm.add_dataset("ds", 4)
    lost = sm.shards_of_node("ds", "b")
    sm.remove_node("b")
    kinds = [e.kind for e in sm.events]
    assert "ShardDown" in kinds
    # shards came back on the surviving node
    for s in lost:
        assert sm.node_of("ds", s) == "a"
    snap = sm.snapshot("ds")
    assert all(v["status"] == "Assigned" for v in snap.values())


def test_status_transitions_and_subscribe():
    sm = ShardManager()
    seen = []
    sm.subscribe(seen.append)
    sm.add_node("a")
    sm.add_dataset("ds", 2)
    sm.set_status("ds", 0, ShardStatus.RECOVERY)
    sm.set_status("ds", 0, ShardStatus.ACTIVE)
    assert [e.kind for e in seen[-2:]] == ["RecoveryInProgress", "IngestionStarted"]


def test_shard_mapper_spread():
    m = ShardMapper(8, spread=2)
    group = m.shards_for_shard_key(0xABCD)
    assert len(group) == 4                    # 2^spread members
    # all series of one shard key land inside its group
    for ph in range(100):
        assert m.shard_of(0xABCD, ph) in group
    # spread=0: single shard per key
    m0 = ShardMapper(8, spread=0)
    assert len(m0.shards_for_shard_key(123)) == 1


def test_plan_time_splits():
    fails = [FailureTimeRange(50_000, 70_000)]
    splits = plan_time_splits(0, 200_000, 10_000, fails, lookback_ms=20_000)
    assert [s.remote for s in splits] == [False, True, False]
    # remote covers failure + lookback, step aligned
    rem = splits[1]
    assert rem.start_ms <= 50_000 and rem.end_ms >= 90_000
    # no failures = single local split
    assert plan_time_splits(0, 100, 10, []) == [
        pytest.approx(plan_time_splits(0, 100, 10, [])[0])]


def test_stitch_matrices():
    k1, k2 = RangeVectorKey.of({"a": "1"}), RangeVectorKey.of({"a": "2"})
    m1 = ResultMatrix(np.array([0, 10], np.int64), np.array([[1.0, 2.0]]), [k1])
    m2 = ResultMatrix(np.array([20, 30], np.int64),
                      np.array([[3.0, 4.0], [8.0, 9.0]]), [k1, k2])
    out = stitch_matrices([m1, m2])
    assert out.num_series == 2
    np.testing.assert_array_equal(out.out_ts, [0, 10, 20, 30])
    np.testing.assert_array_equal(out.values[0], [1, 2, 3, 4])
    np.testing.assert_array_equal(out.values[1][:2], [np.nan, np.nan])


def test_ha_federation_end_to_end():
    """Two clusters; the local one has a failure window — the HA engine stitches
    local + remote results into a seamless answer."""
    from filodb_tpu_torch.core.memstore import StoreConfig, TimeSeriesMemStore
    from filodb_tpu_torch.core.record import RecordBuilder
    from filodb_tpu_torch.core.schemas import GAUGE
    from filodb_tpu_torch.http.api import FiloHttpServer
    from filodb_tpu_torch.query.engine import QueryEngine

    def build(name):
        ms = TimeSeriesMemStore(device="cpu")
        cfg = StoreConfig(max_series_per_shard=8, samples_per_series=256,
                          flush_batch_size=10**9, dtype="float64",
                          device="cpu")
        shard = ms.setup("prometheus", GAUGE, 0, cfg)
        b = RecordBuilder(GAUGE)
        for t in range(120):
            b.add({"_metric_": "m", "host": "h0"}, 1_000_000 + t * 10_000, float(t))
        shard.ingest(b.build())
        shard.flush()
        return QueryEngine(ms, "prometheus", device="cpu")

    local = build("local")
    buddy = build("buddy")
    srv = FiloHttpServer({"prometheus": buddy}, port=0).start()
    try:
        fp = FailureProvider()
        fp.record(FailureTimeRange(1_400_000, 1_500_000))
        ha = HighAvailabilityEngine(
            local, fp, RemotePromExec(f"http://127.0.0.1:{srv.port}", "prometheus"))
        r = ha.query_range("sum_over_time(m[1m])", 1_200_000, 1_900_000, 50_000)
        (key, ts, vals), = list(r.matrix.iter_series())
        # seamless: every step answered, equal to the single-cluster answer
        direct = local.query_range("sum_over_time(m[1m])", 1_200_000, 1_900_000, 50_000)
        (_, dts, dvals), = list(direct.matrix.iter_series())
        np.testing.assert_array_equal(ts, dts)
        np.testing.assert_allclose(vals, dvals)
    finally:
        srv.stop()


def test_ha_engine_passes_through_and_tags_stitched_answers():
    """Without a failure window the wrapper is the engine itself; with one
    and no buddy, the local splits stitch and the route says so."""
    class Stub:
        memstore = "ms"

        def query_range(self, q, s, e, st, **kw):
            from filodb_tpu_torch.query.rangevector import QueryResult
            out_ts = np.arange(s, e + 1, st, dtype=np.int64)
            return QueryResult(ResultMatrix(out_ts, np.ones((1, len(out_ts))),
                                            [RangeVectorKey.of({"a": "1"})]))

    fp = FailureProvider()
    ha = HighAvailabilityEngine(Stub(), fp, None)
    assert ha.memstore == "ms"
    assert ha.query_range("m", 0, 100, 10).exec_path is None
    fp.open_window("node-b", 50)
    assert [f.end_ms for f in fp.failures_in(0, 100)] == [1 << 62]
    r = ha.query_range("m", 0, 100, 10)
    assert r.exec_path == "ha-stitched"
    np.testing.assert_array_equal(r.matrix.out_ts, np.arange(0, 50, 10))
    fp.close_window("node-b", 70)
    assert fp.open_windows() == {}
    assert fp.failures_in(0, 100) == [FailureTimeRange(50, 70)]


@pytest.mark.parametrize("shards,nodes", [(2, 2), (4, 2), (8, 3), (5, 4)])
def test_assignment_equals_the_reference(shards, nodes):
    from filodb_tpu.parallel.cluster import ShardManager as JShardManager
    mine, ref = ShardManager(), JShardManager()
    for sm in (mine, ref):
        for i in range(nodes):
            sm.add_node(f"n{i}")
        sm.add_dataset("ds", shards)
        sm.remove_node("n0")
        sm.reassign("ds", 0, "n1")
    assert mine.status() == ref.status()
    assert [(e.kind, e.shard, e.node) for e in mine.events] == \
        [(e.kind, e.shard, e.node) for e in ref.events]


def test_dryrun_multichip_on_two_cpu_shards():
    """The port's dry run (the reference's multi-device dry run, step 5's
    two server processes included) on a mesh of two CPU devices: every
    route and check holds."""
    from filodb_tpu_torch.entry import dryrun_multichip
    out = dryrun_multichip(2, "cpu")
    two = out.pop("two_process")
    assert two["device"] == "cpu" and two["nodes"] == ["node-a:1",
                                                       "node-b:1"]
    assert set(two["answers"]) == {"sum(rate(tm[2m]))", "count(tm)"}
    (series,) = two["answers"]["sum(rate(tm[2m]))"]
    assert all(abs(float(v) - 0.6) < 1e-3 for _t, v in series["values"])
    (count,) = two["answers"]["count(tm)"]
    assert {v for _t, v in count["values"]} == {"4"}
    assert out == {"devices": ["cpu", "cpu"], "shards": 2,
                   "fused": "mesh-fused", "churned": "mesh-twostep",
                   "order_stats": ["mesh-topk", "mesh-sketch"],
                   "histogram": True, "recovered": "mesh-fused",
                   "evicted_paged": True}
