"""The port's columnar part-key index against the JAX package's.

Mirrors the reference's ``tests/test_index_columnar.py`` case for case:
postings fold/merge and remove/remap, bitmap algebra, mandatory literals
(every parametrised pattern), the trigram cover, the 64k ``GRID_FILTERS``
grid against brute force, churn and compaction, both top-k paths, the
mixed local/peer top-k over two HTTP nodes, and the typed regex errors.
Each case feeds the same seeded inputs to both packages' modules
(``core.index_columnar``, ``core.partkey_index``, ``core.filters``) and
asserts the reference's assertions on each, and that the two give
identical pid sets and counts. The port's ``core/index_columnar.py`` is a
copy of the reference's; these cases pin the copy.
"""

import re
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest

import filodb_tpu.core.filters as JF
import filodb_tpu.core.index_columnar as JIC
from filodb_tpu.core.partkey_index import PartKeyIndex as JPartKeyIndex
import filodb_tpu_torch.core.filters as TF
import filodb_tpu_torch.core.index_columnar as TIC
from filodb_tpu_torch.core.partkey_index import PartKeyIndex as TPartKeyIndex

BASE = 1_700_000_000_000

PKGS = {"jax": SimpleNamespace(F=JF, ic=JIC, PartKeyIndex=JPartKeyIndex),
        "torch": SimpleNamespace(F=TF, ic=TIC, PartKeyIndex=TPartKeyIndex)}


def both(fn):
    """``fn(pkg)`` for each package; the two results must be equal."""
    got = {name: fn(p) for name, p in PKGS.items()}
    assert got["torch"] == got["jax"], got
    return got["torch"]


# -- engine units ------------------------------------------------------------

def test_label_postings_fold_merge_and_queries():
    def run(p):
        lp = p.ic.LabelPostings()
        lp.add(5, 10)
        lp.add(5, 3)                    # out of order: fold must sort
        lp.add(2, 7)
        assert lp.n_postings == 3
        assert lp.ids_of(5).tolist() == [3, 10]
        assert lp.ids_of(2).tolist() == [7]
        assert lp.ids_of(99).tolist() == []
        # incremental fold: committed merges with a later staged batch
        lp.add_bulk(np.array([2, 5], np.uint32), np.array([1, 1], np.int64))
        assert lp.ids_of(2).tolist() == [1, 7]
        assert lp.ids_of(5).tolist() == [1, 3, 10]
        tv, counts = lp.counts()
        assert tv.tolist() == [2, 5] and counts.tolist() == [2, 3]
        got = lp.all_ids()
        assert got.tolist() == sorted(got.tolist())
        # gather = union of disjoint terms
        u = lp.gather(lp.term_indices(np.array([2, 5])))
        assert sorted(u.tolist()) == [1, 1, 3, 7, 10]
        return (got.tolist(), u.tolist(), tv.tolist(), counts.tolist())
    both(run)


def test_label_postings_remove_and_remap():
    def run(p):
        lp = p.ic.LabelPostings()
        lp.add_bulk(np.arange(4, dtype=np.uint32),
                    np.arange(4, dtype=np.int64))
        lp.remove(np.array([1, 2]))
        assert lp.ids_of(1).tolist() == []
        assert lp.term_vids().tolist() == [0, 3]   # emptied terms pruned
        vid_map = np.full(4, -1, np.int64)
        vid_map[0], vid_map[3] = 1, 0              # swap + drop dead vids
        lp.remap_vids(vid_map)
        assert lp.ids_of(0).tolist() == [3]
        assert lp.ids_of(1).tolist() == [0]
        return lp.term_vids().tolist(), lp.all_ids().tolist()
    both(run)


def test_selection_bitmap_algebra_and_popcount():
    def run(p):
        a = p.ic.SelectionBitmap.from_ids(np.array([0, 63, 64, 1000]), 2048)
        assert a.count() == 4
        assert a.to_ids().tolist() == [0, 63, 64, 1000]
        a.iand_ids(np.array([63, 64, 9]))
        assert a.to_ids().tolist() == [63, 64]
        a.iandnot_ids(np.array([64]))
        assert a.to_ids().tolist() == [63]
        mat = np.zeros((2, 4), np.uint64)
        mat[0, 0] = np.uint64(0b1011)
        mat[1, 3] = np.uint64(1) << np.uint64(63)
        assert p.ic.popcount_rows(mat).tolist() == [3, 1]
        return a.to_ids().tolist(), p.ic.popcount_rows(mat).tolist()
    both(run)


@pytest.mark.parametrize("pattern,expect", [
    ("checkout-.*", ["checkout-"]),
    ("h1.", ["h1"]),
    ("abc+d", ["abc", "d"]),
    ("ab*cd", ["a", "cd"]),
    ("a{2,3}bcd", ["bcd"]),
    (r"abc\.def", ["abc.def"]),
    ("[ab]cde", ["cde"]),
    ("^prod-db-[0-9]+$", ["prod-db-"]),
    ("(east|west)-zone", ["-zone"]),
    ("x|yyy", []),                  # top-level alternation: no prefilter
    ("(?i)API", []),                # inline flags: no prefilter
    (r"\d+foo", ["foo"]),
    ("(ab)?cde", ["cde"]),
    (r"\x41abc", []),               # numeric char escape: the digits are
                                    # NOT literal text — must bail, never
    (r"\N{BULLET}abc", []),         # extract "41abc"-style false literals
])
def test_mandatory_literal_extraction(pattern, expect):
    assert both(lambda p: p.ic.mandatory_literals(pattern)) == expect


def test_numeric_escape_regex_still_matches():
    """The \\x-escape bail keeps the trigram path correct: the pattern
    falls back to the full scan and finds the real match."""
    def run(p):
        idx = p.PartKeyIndex()
        idx.add_part_key(0, {"host": "Aabc"}, BASE)
        idx.add_part_key(1, {"host": "41abc"}, BASE)
        return idx.part_ids_from_filters(
            [p.F.EqualsRegex("host", r"\x41abc")], 0, 1 << 62).tolist()
    assert both(run) == [0]


def test_in_filter_duplicate_values_dedup():
    def run(p):
        idx = p.PartKeyIndex()
        idx.add_part_key(0, {"host": "h1"}, BASE)
        idx.add_part_key(1, {"host": "h2"}, BASE)
        return idx.part_ids_from_filters([p.F.In("host", ("h1", "h1"))],
                                         0, 1 << 62).tolist()
    assert both(run) == [0]


def test_mandatory_literals_never_wrong():
    """Property: every extracted literal must appear in every match — an
    over-eager extraction silently DROPS matching terms downstream."""
    cases = [
        ("checkout-.*", ["checkout-1", "checkout-", "checkout-xyz"]),
        ("abc+d", ["abcd", "abccd", "abcccd"]),
        ("ab*cd", ["acd", "abcd", "abbcd"]),
        (r"abc\.def", ["abc.def"]),
        ("a{2,3}bcd", ["aabcd", "aaabcd"]),
        ("(east|west)-zone", ["east-zone", "west-zone"]),
        ("[ab]cde-f.g", ["acde-fxg", "bcde-f-g"]),
        ("^prod-db-[0-9]+$", ["prod-db-0", "prod-db-42"]),
    ]
    for pattern, matches in cases:
        pat = re.compile(pattern)
        lits = both(lambda p: p.ic.mandatory_literals(pattern))
        for m in matches:
            assert pat.fullmatch(m), (pattern, m)
            for lit in lits:
                assert lit in m, (pattern, lit, m)


def test_trigram_candidates_cover_all_matches():
    pool = [f"api-{i}" for i in range(50)] + [f"web-{i}" for i in range(50)] \
        + ["checkout-svc", "checkout-db", "short", "x", "has\x00nul-api-1"]

    def run(p):
        tri = p.ic.TrigramIndex()
        out = {}
        for pattern in ("api-.*", ".*out-s.*", "checkout-(svc|db)", "short"):
            cand = tri.candidates(pattern, pool)
            pat = re.compile(pattern)
            truth = {i for i, v in enumerate(pool) if pat.fullmatch(v)}
            out[pattern] = None if cand is None else sorted(cand.tolist())
            if cand is None:
                continue             # no prefilter: full scan downstream
            assert truth <= set(cand.tolist()), pattern
        assert p.ic.required_trigram_codes("h.") is None
        assert p.ic.required_trigram_codes("xy") is None   # too short
        return out
    both(run)


# -- correctness grid vs brute force (64k series, tier-1) --------------------

N_GRID = 65536


def _grid_columns(n=N_GRID):
    hosts = [f"host-{i % 997}" for i in range(n)]
    jobs = [f"job-{i % 53}" for i in range(n)]
    insts = [f"inst-{i:06d}" for i in range(n)]
    return hosts, jobs, insts


def _grid_index(p):
    hosts, jobs, insts = _grid_columns()
    idx = p.PartKeyIndex()
    ok = idx.add_part_keys_columnar(
        np.arange(N_GRID), {"_metric_": "request_latency", "_ws_": "demo"},
        ["host", "job", "instance"], [hosts, jobs, insts], BASE)
    assert ok
    return idx


def _label_rows():
    hosts, jobs, insts = _grid_columns()
    return [{"_metric_": "request_latency", "_ws_": "demo",
             "host": hosts[i], "job": jobs[i], "instance": insts[i]}
            for i in range(N_GRID)]


def _brute(p, label_rows, filters, start, end, idx):
    out = []
    for pid, labels in enumerate(label_rows):
        if labels is None:
            continue
        ok = all(f.matches(labels.get(f.label, ""))
                 if not isinstance(f, (p.F.NotEquals, p.F.NotEqualsRegex))
                 or f.label in labels
                 else True
                 for f in filters)
        if ok and idx.start_time(pid) <= end and idx.end_time(pid) >= start:
            out.append(pid)
    return np.asarray(out, np.int32)


def _grid_filters(F):
    return [
        [F.Equals("host", "host-7")],
        [F.Equals("_metric_", "request_latency"), F.Equals("job", "job-11")],
        [F.Equals("_metric_", "request_latency"), F.Equals("job", "job-11"),
         F.Equals("host", "host-7")],
        [F.EqualsRegex("instance", "inst-00001.")],
        [F.Equals("_metric_", "request_latency"),
         F.EqualsRegex("host", "host-1.")],
        [F.Equals("_metric_", "request_latency"),
         F.NotEquals("job", "job-0")],
        [F.EqualsRegex("job", "job-(1|2|3)"), F.Equals("_ws_", "demo")],
        [F.In("host", ("host-1", "host-2", "host-990"))],
        [F.Equals("_metric_", "request_latency"),
         F.NotEqualsRegex("host", "host-9.*")],
        [F.Equals("_metric_", "nope")],
        [F.NotEquals("missing_label", "x")],
    ]


GRID_FILTERS = _grid_filters(TF)


@pytest.fixture(scope="module")
def grid():
    return {name: _grid_index(p) for name, p in PKGS.items()}, _label_rows()


@pytest.mark.parametrize("fi", range(len(GRID_FILTERS)))
def test_grid_matches_brute_force(grid, fi):
    idxs, label_rows = grid
    got = {}
    for name, p in PKGS.items():
        filters = _grid_filters(p.F)[fi]
        got[name] = idxs[name].part_ids_from_filters(list(filters), 0,
                                                     1 << 62)
        assert got[name].tolist() == sorted(got[name].tolist())
    p = PKGS["torch"]
    want = _brute(p, label_rows, _grid_filters(p.F)[fi], 0, 1 << 62,
                  idxs["torch"])
    np.testing.assert_array_equal(np.sort(got["torch"]), want)
    np.testing.assert_array_equal(got["torch"], got["jax"])


def test_grid_survives_churn_and_compaction():
    def run(p):
        idx = _grid_index(p)
        rows = _label_rows()
        F = p.F
        # purge a band, reuse some slots under NEW label values, end a band
        gone = np.arange(1000, 3000, dtype=np.int32)
        idx.remove_part_keys(gone)
        for pid in gone.tolist():
            rows[pid] = None
        for pid in range(1000, 1200):
            labels = {"_metric_": "request_latency", "_ws_": "demo",
                      "host": "host-reborn", "job": "job-11",
                      "instance": f"re-{pid}"}
            idx.add_part_key(pid, labels, BASE + 5)
            rows[pid] = labels
        for pid in range(50_000, 50_100):
            idx.update_end_time(pid, BASE + 1)
        idx.maybe_compact_arena(min_dead_ratio=0.0)
        out = []
        for filters in ([F.Equals("host", "host-reborn")],
                        [F.Equals("job", "job-11"),
                         F.EqualsRegex("instance", "re-1[01].*")],
                        [F.Equals("_metric_", "request_latency"),
                         F.NotEquals("host", "host-reborn")]):
            got = np.sort(idx.part_ids_from_filters(list(filters), 0,
                                                    1 << 62))
            want = _brute(p, rows, filters, 0, 1 << 62, idx)
            np.testing.assert_array_equal(got, want)
            out.append(got.tolist())
        # ended band excluded by the time filter
        got = idx.part_ids_from_filters(
            [F.Equals("_metric_", "request_latency")], BASE + 2, 1 << 62)
        assert not (set(range(50_000, 50_100)) & set(got.tolist()))
        out.append(got.tolist())
        return out
    both(run)


def test_topk_counts_both_paths_match_brute_force(grid):
    """Top-k counts read off the columnar structure — CSR diffs
    unfiltered, posting-bitmap popcounts (small labels) / membership pass
    (big labels) filtered — equal the brute-force count exactly, in both
    packages."""
    idxs, label_rows = grid

    def run(p, idx):
        # unfiltered
        want = Counter(r["job"] for r in label_rows)
        got = dict(idx.label_value_counts("job"))
        assert got == dict(want)
        # filtered: job is small-cardinality (popcount path), instance is
        # high-cardinality (membership path) — both vs brute force
        filters = [p.F.EqualsRegex("host", "host-1.")]
        sel = set(_brute(p, label_rows, filters, 0, 1 << 62, idx).tolist())
        want_job = Counter(label_rows[q]["job"] for q in sel)
        got_job = dict(idx.label_value_counts("job", list(filters)))
        assert got_job == dict(want_job)
        want_inst = Counter(label_rows[q]["instance"] for q in sel)
        got_inst = dict(idx.label_value_counts("instance", list(filters)))
        assert got_inst == dict(want_inst)
        # top-k ranking agrees on counts (ties may order differently)
        top = idx.label_value_counts("job", list(filters), top_k=5)
        for v, c in top:
            assert want_job[v] == c
        return got, got_job, got_inst, sorted(c for _v, c in top)
    got = {name: run(p, idxs[name]) for name, p in PKGS.items()}
    assert got["torch"] == got["jax"]


def _topk_node_pair(jax: bool):
    """Two nodes (a port pair or a JAX pair) of a 2-shard dataset whose
    per-shard job skew differs, and the brute-force truth."""
    if jax:
        from filodb_tpu.core.memstore import StoreConfig, TimeSeriesMemStore
        from filodb_tpu.core.record import RecordBuilder
        from filodb_tpu.core.schemas import GAUGE
        from filodb_tpu.http.api import FiloHttpServer
        from filodb_tpu.parallel.cluster import ShardManager
        from filodb_tpu.parallel.shardmapper import ShardMapper
        from filodb_tpu.query.engine import QueryEngine
        kw, ekw = {}, {}
    else:
        from filodb_tpu_torch.core.memstore import (StoreConfig,
                                                    TimeSeriesMemStore)
        from filodb_tpu_torch.core.record import RecordBuilder
        from filodb_tpu_torch.core.schemas import GAUGE
        from filodb_tpu_torch.http.api import FiloHttpServer
        from filodb_tpu_torch.parallel.cluster import ShardManager
        from filodb_tpu_torch.parallel.shardmapper import ShardMapper
        from filodb_tpu_torch.query.engine import QueryEngine
        kw, ekw = {"device": "cpu"}, {"device": "cpu"}
    ds = "topkparity"
    mgr = ShardManager()
    mgr.add_node("a")
    mgr.add_node("b")
    mgr.add_dataset(ds, 2)
    owner = {s: mgr.node_of(ds, s) for s in (0, 1)}
    stores = {"a": TimeSeriesMemStore(**kw), "b": TimeSeriesMemStore(**kw)}
    cfg = StoreConfig(max_series_per_shard=512, samples_per_series=16,
                      flush_batch_size=10**9, dtype="float64", **kw)
    for s in (0, 1):
        stores[owner[s]].setup(ds, GAUGE, s, cfg)
    truth: Counter = Counter()
    for shard in (0, 1):
        b = RecordBuilder(GAUGE)
        for i in range(120):
            # value skew differs per shard so the cluster ranking differs
            # from either node's local one
            job = f"job-{(i + shard * 3) % 7}"
            b.add({"_metric_": "m", "_ws_": "demo", "_ns_": "app",
                   "job": job, "inst": f"s{shard}-i{i}"}, BASE, 1.0)
            truth[job] += 1
        stores[owner[shard]].ingest(ds, shard, b.build())
    eps: dict[str, str] = {}
    engines = {n: QueryEngine(stores[n], ds, ShardMapper(2), cluster=mgr,
                              node=n, endpoint_resolver=eps.get, **ekw)
               for n in ("a", "b")}
    servers = {n: FiloHttpServer({ds: engines[n]}, port=0).start()
               for n in ("a", "b")}
    for n, srv in servers.items():
        eps[n] = f"127.0.0.1:{srv.port}"
    return engines, servers, truth


def test_topk_parity_mixed_local_peer():
    """Cluster-wide top-k by SUMMED count on a mixed local+peer fixture
    equals the brute-force count over both nodes' series, and the port's
    ranking equals the JAX cluster's."""
    got = {}
    for jax in (True, False):
        engines, servers, truth = _topk_node_pair(jax)
        try:
            counts = engines["a"].label_value_counts("job", top_k=3)
            ranked = counts.most_common(3)
            want = truth.most_common(3)
            assert [c for _v, c in ranked] == [c for _v, c in want]
            for v, c in ranked:
                assert truth[v] == c
            top2 = engines["a"].label_values("job", top_k=2)
            assert top2 == [v for v, _ in truth.most_common(2)]
            got[jax] = (dict(counts), ranked, top2)
        finally:
            for srv in servers.values():
                srv.stop()
    assert got[False] == got[True]


# -- parse-time regex validation (typed 422 edge) ----------------------------

def test_invalid_matcher_regex_is_typed_parse_error():
    from filodb_tpu.promql.parser import ParseError as JParseError
    from filodb_tpu.promql.parser import Parser as JParser
    from filodb_tpu_torch.core.memstore import (StoreConfig,
                                                TimeSeriesMemStore)
    from filodb_tpu_torch.promql.parser import ParseError, Parser
    from filodb_tpu_torch.query.engine import QueryEngine
    big = "a" * 2000
    for perr, parser in ((ParseError, Parser), (JParseError, JParser)):
        msgs = []
        with pytest.raises(perr,
                           match=r"invalid regex in matcher host=~") as e:
            parser('m{host=~"h["}').parse()
        msgs.append(str(e.value))
        with pytest.raises(perr, match=r"invalid regex in matcher dc!~") as e:
            parser('m{dc!~"(unclosed"}').parse()
        msgs.append(str(e.value))
        # bounded pattern length: a multi-KB pattern is refused outright
        with pytest.raises(perr, match="chars") as e:
            parser('m{host=~"%s"}' % big).parse()
        msgs.append(str(e.value))
        if parser is Parser:
            port_msgs = msgs
    assert port_msgs == msgs
    # the engine surface raises the same typed error (HTTP maps it to 422)
    ms = TimeSeriesMemStore(device="cpu")
    ms.setup("prometheus", "gauge", 0,
             StoreConfig(max_series_per_shard=8, samples_per_series=16))
    eng = QueryEngine(ms, "prometheus", device="cpu")
    with pytest.raises(ParseError, match="invalid regex"):
        eng.query_range('sum(m{host=~"h["})', BASE, BASE + 60_000, 15_000)


def test_match_selector_regex_validated():
    from filodb_tpu.http.api import _selector_to_filters as j_sel
    from filodb_tpu.promql.parser import ParseError as JParseError
    from filodb_tpu_torch.http.api import _selector_to_filters
    from filodb_tpu_torch.promql.parser import ParseError
    with pytest.raises(ParseError, match="invalid regex"):
        _selector_to_filters('up{job=~"*bad"}')
    with pytest.raises(JParseError, match="invalid regex"):
        j_sel('up{job=~"*bad"}')
    got = _selector_to_filters('up{job=~"good.*"}')
    assert got
    assert [(type(f).__name__, f.label, getattr(f, "value", None))
            for f in got] == [(type(f).__name__, f.label,
                               getattr(f, "value", None))
                              for f in j_sel('up{job=~"good.*"}')]


# -- scale (excluded from tier-1) --------------------------------------------

@pytest.mark.slow
def test_one_million_series_build_and_select():
    n = 1_000_000
    hosts = [f"host-{i % 10000}" for i in range(n)]
    insts = [f"inst-{i:07d}" for i in range(n)]
    got = {}
    for name, p in PKGS.items():
        F = p.F
        idx = p.PartKeyIndex()
        assert idx.add_part_keys_columnar(
            np.arange(n), {"_metric_": "m", "_ws_": "demo"},
            ["host", "instance"], [hosts, insts], BASE)
        assert len(idx) == n
        a = idx.part_ids_from_filters(
            [F.Equals("_metric_", "m"), F.Equals("host", "host-7")],
            0, 1 << 62)
        assert len(a) == n // 10000
        b = idx.part_ids_from_filters(
            [F.Equals("_metric_", "m"),
             F.EqualsRegex("instance", "inst-00001..")], 0, 1 << 62)
        assert len(b) == 100
        top = idx.label_value_counts("host", top_k=3)
        assert all(c == n // 10000 for _v, c in top)
        got[name] = (a.tolist(), b.tolist())
    assert got["torch"] == got["jax"]
