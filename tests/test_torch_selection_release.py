"""A wide selection's release check, on small CPU shards.

A selection wider than ``GATHER_THRESHOLD`` defers its keys (``LazyKeys``)
and captures the shard's release epoch at leaf time. A key read (``take``,
``__iter__``, ``__getitem__``) after a partition release fails the query
when a selected slot was released since the capture, and only then: a
release of an unselected slot leaves the keys readable. The check is held
here against the per-slot snapshot of ``slot_epoch`` that the capture used
to take, over a seeded sequence of releases and slot reuses. The index's
cached pid sets come back as equal read-only arrays, and a time-masked
lookup as a fresh writable one.
"""

import numpy as np
import pytest
import torch

from filodb_tpu_torch.core import filters as F
from filodb_tpu_torch.core.memstore import StoreConfig, TimeSeriesMemStore
from filodb_tpu_torch.core.record import RecordBuilder
from filodb_tpu_torch.core.schemas import GAUGE
from filodb_tpu_torch.query import exec as X
from filodb_tpu_torch.query.rangevector import QueryError
from filodb_tpu_torch.utils.metrics import (
    FILODB_QUERY_SELECTION_RELEASE_RECHECKS, registry)

START = 1_600_000_000_000
IV = 10_000
DS = "relcheck"
# each half of the shard is still a wide selection
SERIES = 2 * X.GATHER_THRESHOLD + 2048
HALF = (F.Equals("_metric_", "m"), F.Equals("half", "a"))
ALL = (F.Equals("_metric_", "m"),)
INVALIDATED = "selection invalidated by concurrent partition release"


def register(sh, hosts, ts):
    b = RecordBuilder(GAUGE)
    b.add_series_batch({"_metric_": "m",
                        "host": [f"h{i}" for i in hosts],
                        "half": ["ab"[i % 2] for i in hosts]}, ts, 1.0)
    sh.ingest(b.build())
    sh.flush()


def build(shard_num=0):
    ms = TimeSeriesMemStore(device="cpu")
    sh = ms.setup(DS, GAUGE, shard_num, StoreConfig(
        max_series_per_shard=SERIES, samples_per_series=8,
        flush_batch_size=10**9, device="cpu"))
    register(sh, range(SERIES), START)
    return ms, sh


@pytest.fixture
def shard():
    return build()


def release(sh, pids):
    with sh.lock:
        sh._release_partitions_locked(np.asarray(pids, np.int32))


def rechecks(sh):
    return registry.counter(FILODB_QUERY_SELECTION_RELEASE_RECHECKS,
                            {"dataset": DS,
                             "shard": str(sh.shard_num)}).value


def wide_selection(ms, sh, filters):
    """The leaf's selection as ``SelectRawPartitionsExec`` takes it under
    the shard lock."""
    leaf = X.SelectRawPartitionsExec(shard=sh.shard_num, filters=filters,
                                     start_ms=START, end_ms=START + IV)
    ctx = X.QueryContext(ms, DS, torch.device("cpu"))
    with sh.lock:
        return leaf.do_execute(ctx)


def read(keys, how):
    if how == "take":
        return keys.take([0, len(keys) - 1])
    if how == "iter":
        return list(keys)
    if how == "item":
        return keys[0]
    return keys[1:4]


@pytest.mark.parametrize("how", ["take", "iter", "item", "slice"])
def test_release_of_a_selected_slot_fails_every_key_read(shard, how):
    ms, sh = shard
    sel = wide_selection(ms, sh, HALF)
    assert isinstance(sel.keys, X.LazyKeys)
    assert len(sel.keys) == SERIES // 2
    release(sh, sel.rows[[7]])
    with pytest.raises(QueryError, match=INVALIDATED):
        read(sel.keys, how)


@pytest.mark.parametrize("how", ["take", "iter", "item", "slice"])
def test_release_of_an_unselected_slot_leaves_the_keys(shard, how):
    ms, sh = shard
    sel = wide_selection(ms, sh, HALF)
    with sh.lock:
        eager = [sh.rv_key_of(int(p)) for p in sel.rows]
    others = np.setdiff1d(np.arange(SERIES), sel.rows)[:5]
    release(sh, others)
    got = read(sel.keys, how)
    want = read(eager, how) if how != "take" else [eager[0], eager[-1]]
    assert got == want


def test_unreleased_keys_equal_the_eager_list(shard):
    ms, sh = shard
    sel = wide_selection(ms, sh, ALL)
    keys = sel.keys
    with sh.lock:
        eager = [sh.rv_key_of(int(p)) for p in sel.rows]
    assert list(keys) == eager
    assert keys[5] == eager[5] and keys[10:20] == eager[10:20]
    idx = [3, 0, len(eager) - 1, 3]
    assert keys.take(idx) == [eager[i] for i in idx]
    assert X._keys_at(keys, idx) == [eager[i] for i in idx]


def test_the_check_agrees_with_a_per_slot_snapshot():
    """Captures of every round stay live across later rounds of seeded
    releases (of selected and unselected slots, or none) and slot reuses:
    each read fails exactly when ``slot_epoch`` moved for one of its pids
    since its capture, the check the per-slot snapshot made."""
    ms, sh = build(shard_num=1)
    rng = np.random.default_rng(26)
    live = []                      # (LazyKeys, pids, slot_epoch snapshot)
    next_host = SERIES
    outcomes = set()
    for _round in range(12):
        sel = wide_selection(ms, sh, HALF)
        assert isinstance(sel.keys, X.LazyKeys)
        live.append((sel.keys, sel.rows, sh.slot_epoch[sel.rows].copy()))
        occupied = np.asarray(sorted(sh._part_key_of_id), np.int64)
        k = int(rng.integers(0, 4))
        if k:
            release(sh, rng.choice(occupied, size=k, replace=False))
        if rng.random() < 0.5:
            # new series take the freed slots
            free = SERIES - sh.num_series
            if free:
                register(sh, range(next_host, next_host + free), START)
                next_host += free
        for keys, pids, snap in live:
            stale = bool((sh.slot_epoch[pids] != snap).any())
            outcomes.add(stale)
            if stale:
                with pytest.raises(QueryError, match=INVALIDATED):
                    keys.take([0])
            else:
                keys.take([0])
    assert outcomes == {False, True}


def test_rechecks_count_only_reads_after_a_release(shard):
    ms, sh = shard
    sel = wide_selection(ms, sh, HALF)
    before = rechecks(sh)
    sel.keys.take([0])
    list(sel.keys)
    assert rechecks(sh) == before
    release(sh, np.setdiff1d(np.arange(SERIES), sel.rows)[:1])
    sel.keys.take([0])
    sel.keys[1]
    assert rechecks(sh) == before + 2
    # a capture taken after the release reads on the fast branch
    later = wide_selection(ms, sh, HALF)
    later.keys.take([0])
    assert rechecks(sh) == before + 2


def test_cached_pid_sets_are_shared_read_only(shard):
    _ms, sh = shard
    for filters in (HALF, ALL, (F.Equals("host", "h5"),)):
        a = sh.part_ids_from_filters(list(filters), START, START + IV)
        b = sh.part_ids_from_filters(list(filters), START, START + IV)
        assert a.dtype == np.int32 and b.dtype == np.int32
        assert np.array_equal(a, b) and len(a)
        assert not a.flags.writeable and not b.flags.writeable
        with pytest.raises(ValueError):
            a[0] = 0
    # the index still writes its own postings: a series leaves the half and
    # a new one joins it, and the next lookup sees both
    (gone,) = sh.part_ids_from_filters([F.Equals("host", "h2")], START,
                                       START + IV)
    release(sh, [gone])
    register(sh, [SERIES], START)
    (new,) = sh.part_ids_from_filters([F.Equals("host", f"h{SERIES}")],
                                      START, START + IV)
    got = sh.part_ids_from_filters(list(HALF), START, START + IV)
    assert len(got) == SERIES // 2 and not got.flags.writeable
    assert new in got
    assert gone not in got or new == gone


def test_a_time_masked_lookup_is_a_fresh_writable_array(shard):
    _ms, sh = shard
    # one series starts late: windows that end before it mask by time
    release(sh, [0])
    register(sh, [SERIES + 7], START + 100 * IV)
    early = sh.part_ids_from_filters(list(ALL), START, START + 50 * IV)
    again = sh.part_ids_from_filters(list(ALL), START, START + 50 * IV)
    assert early.dtype == np.int32 and len(early) == SERIES - 1
    assert early.flags.writeable and again.flags.writeable
    assert not np.shares_memory(early, again)
    early[0] = -1
    assert again[0] != -1
    full = sh.part_ids_from_filters(list(ALL), START, START + 200 * IV)
    assert len(full) == SERIES and not full.flags.writeable
