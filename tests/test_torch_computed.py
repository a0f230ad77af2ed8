"""Computed columns (``filodb_tpu_torch/core/computed.py``) against the JAX
package's (``filodb_tpu/core/computed.py``).

The reference's nine tests (``tests/test_computed.py``) as parity cases:
the same containers, built in each package from the same samples, give the
same arrays (values and dtypes) and the same strings exactly, and the same
expressions raise the same typed errors. Tolerance: none.
"""

import numpy as np
import pytest

from filodb_tpu.core import computed as jcomputed
from filodb_tpu.core.record import RecordBuilder as JRecordBuilder
from filodb_tpu.core.schemas import GAUGE as JGAUGE
from filodb_tpu_torch.core import computed
from filodb_tpu_torch.core.computed import (BadArgument, NoSuchFunction,
                                            NotComputedColumn,
                                            WrongNumberArguments, analyze)
from filodb_tpu_torch.core.record import RecordBuilder
from filodb_tpu_torch.core.schemas import GAUGE, ColumnType

BASE = 1_700_000_000_000


def _rows(n=6):
    rows = []
    for i in range(n):
        labels = {"_metric_": "m", "host": f"host-{i % 2}", "dc": "us-east"}
        if i % 2:
            labels["rack"] = f"r{i}"
        rows.append((labels, BASE + i * 45_000, float(i) * 1.5))
    return rows


def _containers(rows=None):
    """The same samples as a port container and a reference one."""
    rows = rows if rows is not None else _rows()
    out = []
    for Builder, schema in ((RecordBuilder, GAUGE), (JRecordBuilder, JGAUGE)):
        b = Builder(schema)
        for labels, ts, v in rows:
            b.add(labels, ts, v)
        out.append(b.build())
    return out


def _same(expr, rows=None):
    """The port's and the reference's output of ``expr`` on the same
    container: equal values and dtypes (arrays) or equal lists."""
    mine, ref = _containers(rows)
    c, jc = analyze(expr, GAUGE), jcomputed.analyze(expr, JGAUGE)
    assert c.ctype.value == jc.ctype.value and c.source == jc.source
    assert c.name == jc.name == expr
    got, want = c.compute(mine), jc.compute(ref)
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        assert got.tolist() == want.tolist()
    else:
        assert got == want
    return got, mine


def _same_error(expr, err):
    jerr = getattr(jcomputed, err.__name__)
    with pytest.raises(jerr) as want:
        jcomputed.analyze(expr, JGAUGE)
    with pytest.raises(err) as got:
        analyze(expr, GAUGE)
    assert str(got.value) == str(want.value)


def test_not_computed_and_unknown():
    _same_error("plain_column", NotComputedColumn)
    _same_error(":nope arg", NoSuchFunction)
    _same_error(":round timestamp", WrongNumberArguments)
    _same_error(":", NoSuchFunction)


def test_const_string():
    out, _ = _same(":string prod")
    assert analyze(":string prod", GAUGE).ctype == ColumnType.STRING
    assert out == ["prod"] * 6


def test_get_or_else_label_default():
    out, _ = _same(":getOrElse rack none")
    assert out[0] == "none" and out[1] == "r1" and out[2] == "none"
    _same_error(":getOrElse timestamp 0", BadArgument)


def test_round_double_and_ts():
    out, cont = _same(":round value 1.0")
    np.testing.assert_array_equal(out, np.floor(cont.values))
    out2, cont = _same(":round timestamp 60000")
    assert (out2 % 60000 == 0).all() and (out2 <= cont.ts).all()
    _same_error(":round value -5", BadArgument)
    _same_error(":round nosuch 10", BadArgument)
    _same_error(":round timestamp x", BadArgument)


def test_string_prefix():
    out, _ = _same(":stringPrefix host 4")
    assert set(out) == {"host"}
    _same(":stringPrefix rack 1")
    _same_error(":stringPrefix host -1", BadArgument)


def test_hash_label_and_numeric():
    out, cont = _same(":hash host 8")
    assert out.dtype == np.int32 and ((0 <= out) & (out < 8)).all()
    h0 = [o for o, ls in zip(out, (cont.label_sets[i] for i in cont.part_idx))
          if ls["host"] == "host-0"]
    assert len(set(h0)) == 1
    outn, _ = _same(":hash timestamp 4")
    assert ((0 <= outn) & (outn < 4)).all()
    _same(":hash value 3")
    _same_error(":hash host 0", BadArgument)


def test_timeslice():
    out, cont = _same(":timeslice timestamp 1m")
    assert analyze(":timeslice timestamp 1m", GAUGE).ctype \
        == ColumnType.TIMESTAMP
    assert (out % 60_000 == 0).all() and ((cont.ts - out) < 60_000).all()
    _same(":timeslice timestamp 5m")
    _same_error(":timeslice timestamp xyz", BadArgument)
    _same_error(":timeslice value 1m", BadArgument)


def test_month_of_year():
    # 2023-01-15 and 2023-12-31 UTC, and a seeded spread over the years
    rows = [({"_metric_": "m"}, 1673740800000, 1.0),
            ({"_metric_": "m"}, 1704000000000, 2.0)]
    rng = np.random.default_rng(9)
    rows += [({"_metric_": "m", "i": str(k)}, int(t), 0.5)
             for k, t in enumerate(rng.integers(0, 4_000_000_000_000, 64))]
    out, _ = _same(":monthOfYear timestamp", rows)
    assert list(out[:2]) == [1, 12]
    assert ((1 <= out) & (out <= 12)).all()


def test_registry_matches_reference_set():
    assert set(computed.ALL_COMPUTATIONS) == set(jcomputed.ALL_COMPUTATIONS) \
        == {"string", "getOrElse", "round", "timeslice", "monthOfYear",
            "stringPrefix", "hash"}
