"""The cross-node wire codec in both packages: plan envelopes, tagged-binary
results and multipart batches, byte for byte.

The same plan (a shard leaf with its pushed-down map phase, a co-located
reduce of two leaves) and the same seeded numpy partials (AggPartial,
TopKPartial, SketchPartial, CountValuesPartial, a matrix, a histogram
matrix, a stats-wrapped payload) go through ``serialize_plan`` /
``serialize_result`` / ``pack_multipart`` of the JAX package and of the
port; the bytes must be equal, and each package must decode the other's.
The port's own partials on the CPU (device tensors, a lazy fused bundle)
serialize as their host arrays would. Also the codec's guards: unwireable
transformers, hostile or too-deep envelopes, torn payloads.
"""

import json

import numpy as np
import pytest
import torch

from filodb_tpu.core import filters as JF
from filodb_tpu.query import exec as JX
from filodb_tpu.query import rangevector as JR
from filodb_tpu.query import wire as jwire
from filodb_tpu_torch.core import filters as TF
from filodb_tpu_torch.ops import fusedgrid
from filodb_tpu_torch.query import exec as TX
from filodb_tpu_torch.query import rangevector as TR
from filodb_tpu_torch.query import wire as twire

START = 1_000_000


def leaf(X, F, shard=3, op="sum", by=("host",)):
    return X.SelectRawPartitionsExec(
        transformers=[
            X.PeriodicSamplesMapper(START, 30_000, START + 600_000, 120_000,
                                    "rate", ()),
            X.AggregateMapReduce(op, (), by, ()),
        ],
        shard=shard,
        filters=(F.Equals("_metric_", "m"), F.EqualsRegex("host", "h.*"),
                 F.NotEquals("dc", "dc9"), F.In("zone", ("a", "b")),
                 F.NotEqualsRegex("pod", "x.+")),
        start_ms=START, end_ms=START + 600_000, column="sum")


def reduce_plan(X, F):
    return X.ReduceAggregateExec(
        transformers=[X.AggregatePresenter("avg", (), ("dc",), ())],
        operator="avg", params=(), by=("dc",), without=(),
        children=[leaf(X, F, 0, "avg", ("dc",)),
                  leaf(X, F, 1, "avg", ("dc",))])


def chunk_plan(X, F):
    return X.SelectChunkInfosExec(
        transformers=[X.InstantVectorFunctionMapper("abs", ()),
                      X.ScalarOperationMapper("*", 2.0, False),
                      X.SortFunctionMapper("sort_desc"),
                      X.MiscellaneousFunctionMapper("label_replace",
                                                    ("a", "$1", "b", "(.*)"))],
        shard=1, filters=(F.Equals("_metric_", "m"),), start_ms=START,
        end_ms=START + 60_000, column="")


PLANS = {"leaf": leaf, "reduce": reduce_plan, "chunk_infos": chunk_plan}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_bytes_equal_the_reference(name):
    jb = jwire.serialize_plan(PLANS[name](JX, JF))
    tb = twire.serialize_plan(PLANS[name](TX, TF))
    assert tb == jb
    # each package decodes the other's envelope into its own plan
    assert twire.deserialize_plan(jb) == PLANS[name](TX, TF)
    assert jwire.deserialize_plan(tb) == PLANS[name](JX, JF)


def test_plan_codec_rejects_unwireable_and_hostile_envelopes():
    som = TX.ScalarOperationMapper("+", TX.ScalarExec(value=1.0), False)
    assert not twire.is_wire_transformer(som)
    assert twire.is_wire_transformer(TX.ScalarOperationMapper("+", 2.0, True))
    with pytest.raises(twire.NotWireable):
        twire.serialize_plan(TX.SelectRawPartitionsExec(transformers=[som],
                                                        shard=0))
    with pytest.raises(TR.QueryError):
        twire.deserialize_plan(b'{"t": "Evil", "transformers": []}')
    # nesting is bounded on both sides: the serializer refuses, the decoder
    # rejects a hostile deep body
    base = leaf(TX, TF)
    deep = base
    for _ in range(8):
        deep = TX.ReduceAggregateExec(transformers=[], operator="sum",
                                      children=[deep])
    with pytest.raises(twire.NotWireable, match="nesting"):
        twire.serialize_plan(deep)
    d = json.loads(twire.serialize_plan(base))
    for _ in range(8):
        d = {"t": "ReduceAggregateExec", "transformers": [], "children": [d],
             "operator": "sum", "params": [], "by": [], "without": []}
    with pytest.raises(TR.QueryError, match="nesting"):
        twire.deserialize_plan(json.dumps(d).encode())


def _key(R, **labels):
    return R.RangeVectorKey.of(labels)


def partials(X, R, rng_seed=5):
    """The same seeded partial of every kind, built in package X."""
    rng = np.random.default_rng(rng_seed)
    out_ts = np.arange(START, START + 150_000, 30_000, dtype=np.int64)
    T = len(out_ts)
    gk = [_key(R, host="a"), _key(R, host="b"), _key(R, host="c")]
    agg = X.AggPartial("stddev", out_ts,
                       {"sum": rng.random((4, T)), "count": np.ones((4, T)),
                        "sumsq": rng.random((4, T))}, gk, 3, None)
    hagg = X.AggPartial("sum", out_ts,
                        {"sum": rng.random((2, T * 3)),
                         "count": np.ones((2, T * 3))}, gk[:1], 1,
                        np.array([1.0, 4.0, np.inf]))
    vals = rng.random((1, 2, T))
    vals[0, 1, 2] = np.nan
    vals[0, 0, 0] = np.inf
    topk = X.TopKPartial(2, True, out_ts, [_key(R)], vals,
                         np.array([[[0, 1, -1, 0, 1], [1, 0, 1, -1, 0]]],
                                  np.int64), gk[:2])
    sketch = X.SketchPartial(0.9, out_ts, gk[:2],
                             rng.random((2, 9, T)).astype(np.float32))
    cv = X.CountValuesPartial("v", out_ts, [_key(R, dc="x")],
                              {(0, "1.5"): rng.random(T), (0, "2"): np.ones(T),
                               (0, "NaN"): np.zeros(T)})
    mvals = rng.random((3, T))
    mvals[1, 3] = np.nan
    matrix = R.ResultMatrix(out_ts, mvals, gk)
    hmatrix = R.ResultMatrix(out_ts, rng.random((2, T, 3)), gk[:2],
                             np.array([1.0, 4.0, np.inf]))
    empty = R.ResultMatrix(out_ts, np.zeros((0, T)), [])
    return {"agg": agg, "hist_agg": hagg, "topk": topk, "sketch": sketch,
            "count_values": cv, "matrix": matrix, "hist_matrix": hmatrix,
            "empty": empty}


RESULTS = sorted(partials(TX, TR))


@pytest.mark.parametrize("name", RESULTS)
def test_result_bytes_equal_the_reference(name):
    jb = jwire.serialize_result(partials(JX, JR)[name])
    tb = twire.serialize_result(partials(TX, TR)[name])
    assert tb == jb
    # the reference decodes the port's bytes and re-encodes them unchanged,
    # and the port decodes the reference's
    assert jwire.serialize_result(jwire.deserialize_result(tb)) == jb
    assert twire.serialize_result(twire.deserialize_result(jb)) == tb


def test_device_partials_serialize_as_their_host_arrays():
    """The port's partials hold device tensors (a dict off the composed
    map phase, a lazy fused bundle off K1's plain twin here, sketch counts)
    and one host copy at serialization gives the bytes of the same numpy
    partial."""
    p = partials(TX, TR)
    agg = p["agg"]
    on_dev = TX.AggPartial(agg.op, agg.out_ts,
                           {k: torch.from_numpy(v.astype(np.float32))
                            for k, v in agg.parts.items()},
                           agg.group_keys, agg.num_groups)
    as_host = TX.AggPartial(agg.op, agg.out_ts,
                            {k: v.astype(np.float32)
                             for k, v in agg.parts.items()},
                            agg.group_keys, agg.num_groups)
    assert twire.serialize_result(on_dev) == \
        jwire.serialize_result(partials(JX, JR)["agg"].__class__(
            as_host.op, as_host.out_ts, as_host.parts,
            [JR.RangeVectorKey(k.labels) for k in as_host.group_keys],
            as_host.num_groups))
    outs = [torch.from_numpy(np.random.default_rng(1).random((8, 128))
                             .astype(np.float32)) for _ in range(2)]
    lazy = fusedgrid.PaddedPartials(outs, "sum", 3, 5)
    host = lazy.parts_of([o.numpy() for o in outs])
    gk = agg.group_keys
    assert twire.serialize_result(TX.AggPartial("sum", agg.out_ts, lazy, gk,
                                                3)) == \
        twire.serialize_result(TX.AggPartial("sum", agg.out_ts, host, gk, 3))
    sk = p["sketch"]
    dev_sk = TX.SketchPartial(sk.q, sk.out_ts, sk.group_keys,
                              torch.from_numpy(sk.counts))
    assert twire.serialize_result(dev_sk) == twire.serialize_result(sk)
    m = p["matrix"]
    dev_m = TR.ResultMatrix(m.out_ts, torch.from_numpy(m.values), m.keys)
    assert twire.serialize_result(dev_m) == twire.serialize_result(m)


def test_stats_wrapper_bytes_and_merge():
    js, ts = JR.QueryStats(), TR.QueryStats()
    for st in (js, ts):
        st.add("series_matched", 12)
        st.add("fused_kernels", 1)
        st.add("recovering_shards", 1)
    jb = jwire.serialize_result(partials(JX, JR)["agg"], stats=js)
    tb = twire.serialize_result(partials(TX, TR)["agg"], stats=ts)
    assert tb == jb
    acc = TR.QueryStats()
    out = twire.deserialize_result(jb, stats=acc)
    assert isinstance(out, TX.AggPartial)
    assert (acc.series_matched, acc.fused_kernels,
            acc.recovering_shards) == (12, 1, 1)
    # a nested wrapper is refused
    with pytest.raises(TR.QueryError):
        twire.deserialize_result(twire._pack(b"W", {"stats": {}},
                                             [np.frombuffer(tb, np.uint8)]))


def test_multipart_bytes_and_torn_payloads():
    parts = [(0, jwire.serialize_result(partials(JX, JR)["topk"])),
             (1, b'{"error":"x","kind":"query"}'), (0, b"")]
    jb = jwire.pack_multipart(parts)
    assert twire.pack_multipart(parts) == jb
    assert twire.unpack_multipart(jb) == parts
    with pytest.raises(TR.QueryError):
        twire.unpack_multipart(jb[:-3])
    with pytest.raises(TR.QueryError):
        twire.unpack_multipart(b"Zjunk")
    blob = twire.serialize_result(partials(TX, TR)["agg"])
    for cut in (3, 20, len(blob) - 1):
        with pytest.raises(TR.QueryError):
            twire.deserialize_result(blob[:cut])
    with pytest.raises(TR.QueryError, match="unknown remote result tag"):
        twire.deserialize_result(b"Q" + blob[1:])
