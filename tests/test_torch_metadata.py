"""The metadata API in both packages: label values (and their counts and
top-k), label names, ``series`` and ``raw_series`` (the remote-read path).

The same seeded rows go through each package's RecordBuilder into two
shards of one dataset: two metrics, hosts spread over two data centres,
one series that starts late (so a time-bounded ``series`` query can miss
it). The port answers over its part-key index and, for ``raw_series``,
one gather of the selected rows on the store's device; on a
compressed-resident store ("gauge": integer counters, delta8) that read
decodes the narrow block. Every answer must equal the JAX engine's local
one exactly (labels are strings, timestamps integers, the samples exact
in f32).
"""

import numpy as np
import pytest

from filodb_tpu.core import filters as JF
from filodb_tpu.core.memstore import StoreConfig as JStoreConfig
from filodb_tpu.core.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.core.record import RecordBuilder as JRecordBuilder
from filodb_tpu.core.schemas import GAUGE as JGAUGE
from filodb_tpu.query.engine import QueryEngine as JQueryEngine
from filodb_tpu_torch.core import filters as TF
from filodb_tpu_torch.core.memstore import StoreConfig, TimeSeriesMemStore
from filodb_tpu_torch.core.record import RecordBuilder
from filodb_tpu_torch.core.schemas import GAUGE
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.query.rangevector import QueryError

START = 1_000_000
IV = 10_000
CELLS = 40
LATE = 25          # cells before the late series' first sample


def rows():
    """[(labels, first cell, values)]: seeded integer counters."""
    rng = np.random.default_rng(11)
    out = []
    for s in range(12):
        labels = {"_metric_": "m" if s < 8 else "g", "host": f"h{s % 5}",
                  "dc": f"dc{s % 2}", "inst": f"i{s}"}
        if s == 3:
            labels["extra"] = "x"
        first = LATE if s == 7 else 0
        vals = np.cumsum(rng.integers(0, 9, CELLS - first)).astype(float)
        out.append((labels, first, vals))
    return out


def build(residency: str):
    """(JAX engine, port engine): two shards each, series alternating."""
    data = rows()
    kw = dict(max_series_per_shard=16, samples_per_series=64,
              flush_batch_size=10**9, compressed_residency=residency)
    jms, tms = JMemStore(), TimeSeriesMemStore(device="cpu")
    for sh in (0, 1):
        jms.setup("meta", JGAUGE, sh, JStoreConfig(**kw))
        tms.setup("meta", GAUGE, sh, StoreConfig(**kw, device="cpu"))
    for rb, schema, ms in ((JRecordBuilder, JGAUGE, jms),
                           (RecordBuilder, GAUGE, tms)):
        # one container a series: a part key's start time is its first
        # container's earliest sample
        for s, (labels, first, vals) in enumerate(data):
            b = rb(schema)
            ts = START + (first + np.arange(len(vals))) * IV
            b.add_batch(labels, ts.astype(np.int64), vals)
            ms.ingest("meta", s % 2, b.build())
        ms.flush_all()
    if residency == "gauge":
        assert all(s.store._val_compressed for s in tms.shards_of("meta"))
    return JQueryEngine(jms, "meta"), QueryEngine(tms, "meta", device="cpu")


@pytest.fixture(scope="module", params=["off", "gauge"])
def engines(request):
    return build(request.param)


FILTERS = [
    [],
    [("Equals", "_metric_", "m")],
    [("Equals", "_metric_", "m"), ("EqualsRegex", "host", "h[12]")],
    [("NotEquals", "dc", "dc0")],
    [("Equals", "_metric_", "nope")],
]


def filters(mod, spec):
    return [getattr(mod, cls)(label, value) for cls, label, value in spec]


@pytest.mark.parametrize("spec", range(len(FILTERS)))
def test_label_api_matches_the_reference(engines, spec):
    jeng, teng = engines
    jf, tf = (filters(JF, FILTERS[spec]) or None,
              filters(TF, FILTERS[spec]) or None)
    for label in ("host", "dc", "_metric_", "extra", "missing"):
        assert teng.label_values(label, tf) == \
            jeng.label_values(label, jf, local_only=True)
        assert teng.label_values(label, tf, top_k=2) == \
            jeng.label_values(label, jf, top_k=2, local_only=True)
        assert teng.label_value_counts(label, tf) == \
            jeng.label_value_counts(label, jf, local_only=True)
    assert teng.label_names(tf) == jeng.label_names(jf, local_only=True)


def test_label_values_sum_counts_over_the_shards(engines):
    _jeng, teng = engines
    counts = teng.label_value_counts("host")
    assert counts == {"h0": 3, "h1": 3, "h2": 2, "h3": 2, "h4": 2}
    assert teng.label_values("host", top_k=2) == ["h0", "h1"]
    assert teng.label_names() == ["_metric_", "dc", "extra", "host", "inst"]


@pytest.mark.parametrize("spec", range(len(FILTERS)))
@pytest.mark.parametrize("window", [(0, 1 << 62),
                                    (START, START + 10 * IV)])
def test_series_matches_the_reference(engines, spec, window):
    jeng, teng = engines
    got = teng.series(filters(TF, FILTERS[spec]), *window)
    ref = jeng.series(filters(JF, FILTERS[spec]), *window, local_only=True)
    assert got == ref
    if window[1] < START + LATE * IV and spec in (0, 1):
        assert "i7" not in {d["inst"] for d in got}


def _raw(gen):
    return [(lbl, ts.tolist(), vals.tolist()) for lbl, ts, vals in gen]


@pytest.mark.parametrize("spec", range(len(FILTERS)))
@pytest.mark.parametrize("window", [(START, START + 60 * IV),
                                    (START + 12 * IV, START + 30 * IV)])
def test_raw_series_matches_the_reference(engines, spec, window):
    jeng, teng = engines
    got = _raw(teng.raw_series(filters(TF, FILTERS[spec]), *window))
    ref = _raw(jeng.raw_series(filters(JF, FILTERS[spec]), *window))
    assert got == ref
    for _lbl, ts, vals in got:
        assert all(window[0] <= t <= window[1] for t in ts)
        assert len(ts) == len(vals) > 0
    if spec == 1:
        assert len(got) == 8       # every m series has samples inside


def test_raw_series_types_and_the_paging_branch(engines, monkeypatch):
    _jeng, teng = engines
    (lbl, ts, vals), *_ = teng.raw_series([TF.Equals("inst", "i0")], START,
                                          START + 60 * IV)
    assert lbl["inst"] == "i0"
    assert ts.dtype == np.int64 and vals.dtype == np.float64
    assert len(ts) == CELLS
    # a selection that needs paged-out rows takes the paging branch: with
    # nothing in a sink, it reads exactly the resident samples
    resident = list(teng.raw_series([TF.Equals("_metric_", "m")], START,
                                    START + 60 * IV))
    sh = teng.memstore.shards_of("meta")[0]
    monkeypatch.setattr(sh, "needs_paging", lambda pids, start: True)
    paged = list(teng.raw_series([TF.Equals("_metric_", "m")], START,
                                 START + 60 * IV))
    assert len(paged) == len(resident) > 0
    for (pl, pt, pv), (rl, rt, rv) in zip(paged, resident):
        assert pl == rl
        np.testing.assert_array_equal(pt, rt)
        np.testing.assert_array_equal(pv, rv)
