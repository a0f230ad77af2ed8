"""The readers that split the query leaf: the shard lock's wait and hold,
the index selection and the host's wait on the card, on synthetic runs."""

import pytest

from tsdb_bench import harness

from .test_tsdb_bench_metrics import BENCH, req, view


class Sp:
    """A drained span as the readers see it."""

    def __init__(self, name, us, **tags):
        self.name, self.duration_us, self.tags = name, us, tags


LEAF_SPLITS = ("shard_lock_wait_ms_per_query", "shard_lock_held_share",
               "leaf_select_ms", "fetch_ms")


def test_leaf_split_readers():
    """Two requests over a 2 s window: shard 0's leaves held their lock
    0.5 s + 0.3 s, shard 1's 0.6 s; two waits, one selection, two
    copies."""
    reqs = [req("q", 0, 0, 0.01), req("q", 0, 0, 0.01)]
    spans = [Sp("query.exec.leaf", 900_000, shard=0, lock_held_us=500_000),
             Sp("query.exec.leaf", 400_000, shard=0, lock_held_us=300_000),
             Sp("query.exec.leaf", 700_000, shard=1, lock_held_us=600_000),
             Sp("query.exec.lock_wait", 3000, lock="shard-0"),
             Sp("query.exec.lock_wait", 1000, lock="shard-0"),
             Sp("query.exec.select", 5000, shard=0, series=9),
             Sp("query.exec.fetch", 7000, site="k1_partials"),
             Sp("query.exec.fetch", 1000, site="result")]
    v = view([], 2.0, reqs, spans=spans)
    read = {n: harness.metric_reader(n)(v) for n in LEAF_SPLITS}
    assert read == {"shard_lock_wait_ms_per_query": pytest.approx(2.0),
                    "shard_lock_held_share": pytest.approx(40.0),
                    "leaf_select_ms": pytest.approx(2.5),
                    "fetch_ms": pytest.approx(4.0)}
    v.device.spans_lost = 1
    assert all(harness.metric_reader(n)(v) is None for n in LEAF_SPLITS)


def test_the_held_share_takes_the_busiest_shard():
    spans = [Sp("query.exec.leaf", 10, shard=s, lock_held_us=us)
             for s, us in ((0, 100_000), (1, 250_000), (0, 100_000),
                           (2, 50_000))]
    v = view([], 1.0, [req("q", 0, 0, 0.01)], spans=spans)
    assert harness.metric_reader("shard_lock_held_share")(v) == \
        pytest.approx(25.0)


def test_no_wait_reads_zero_where_the_leaves_record_their_holds():
    reqs = [req("q", 0, 0, 0.01)]
    held = view([], 1.0, reqs, spans=[
        Sp("query.exec.leaf", 900, shard=0, lock_held_us=800)])
    assert harness.metric_reader("shard_lock_wait_ms_per_query")(held) \
        == 0.0
    # a program whose leaves record no hold records no wait either: nothing
    bare = view([], 1.0, reqs, spans=[Sp("query.exec.leaf", 900, shard=0)])
    for n in LEAF_SPLITS:
        assert harness.metric_reader(n)(bare) is None, n


@pytest.mark.parametrize("name", [f"{q}{s}" for q in LEAF_SPLITS
                                  for s in ("", ".quantile_dash",
                                            ".hist_mix")]
                         + ["leaf_ms.quantile_dash"])
def test_every_leaf_split_is_found_by_name(name):
    spec = {m["name"]: m for m in BENCH["per_layer"]}
    assert spec[name]["source"] == "program_span"
    assert harness.metric_reader(name) is not None
    suffix = name.partition(".")[2]
    want = f"queries_per_s.{suffix}" if suffix else "queries_per_s"
    assert spec[name]["moves"] == want and "workloads" not in spec[name]
