"""Computed (derived) columns — ``:func arg...`` expressions over ingest batches.

Reference: core/src/main/scala/filodb.core/metadata/ComputedColumn.scala (expression
analysis, ``AllComputations`` registry, InvalidFunctionSpec errors),
SimpleComputations.scala (:string/:getOrElse/:round/:stringPrefix/:hash) and
TimeComputations.scala (:timeslice/:monthOfYear).

Port of ``filodb_tpu/core/computed.py``: host numpy only, no device work.
As there, where the Scala original computes values row-at-a-time through
``TypedFieldExtractor``s in the ingest hot loop; here a computed column is a
*vectorized* function over a whole ``RecordContainer`` (numpy for numeric sources,
one pass over the distinct label sets for string sources), so the cost is
per-batch, not per-record.

A computed column reads either a data column of the schema (``timestamp``,
``value``...) or a label tag; the analyzer resolves which at analysis time.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

from .record import RecordContainer, fnv1a64
from .schemas import ColumnType, Schema


class InvalidFunctionSpec(ValueError):
    """Base for expression-analysis failures (ref: ComputedColumn.scala:61-66)."""


class NoSuchFunction(InvalidFunctionSpec):
    pass


class WrongNumberArguments(InvalidFunctionSpec):
    def __init__(self, given: int, expected: int):
        super().__init__(f"wrong number of arguments: given {given}, expected {expected}")


class BadArgument(InvalidFunctionSpec):
    pass


class NotComputedColumn(InvalidFunctionSpec):
    pass


@dataclass(frozen=True)
class ComputedColumn:
    """An analyzed expression ready to evaluate against containers.

    ``compute(container)`` returns a per-record numpy array (numeric results) or a
    list[str] (string results), parallel to ``container.ts``.
    """
    expr: str
    ctype: ColumnType
    source: str | None                    # data-column or label name ('' for const)
    _fn: Callable[[RecordContainer], "np.ndarray | list[str]"]

    @property
    def name(self) -> str:
        return self.expr

    def compute(self, container: RecordContainer):
        return self._fn(container)


def is_computed(expr: str) -> bool:
    return expr.startswith(":")


def _parse_duration_ms(arg: str) -> int:
    from ..config import parse_duration_ms
    try:
        return parse_duration_ms(arg)
    except ValueError as e:
        raise BadArgument(str(e)) from None


def _numeric_source(schema: Schema, name: str) -> ColumnType:
    for c in schema.columns:
        if c.name == name:
            if c.ctype not in (ColumnType.INT, ColumnType.LONG, ColumnType.DOUBLE,
                               ColumnType.TIMESTAMP):
                raise BadArgument(f"column {name} of type {c.ctype.value} is not numeric")
            return c.ctype
    raise BadArgument(f"no numeric data column named {name!r} in schema {schema.name}")


def _numeric_values(container: RecordContainer, name: str) -> np.ndarray:
    # The columnar container carries exactly the timestamp + value columns.
    if name == container.schema.columns[0].name:
        return container.ts
    if container.values.ndim != 1:
        raise BadArgument(f"column {name!r} is not a scalar column in this container")
    return container.values


def _label_values(container: RecordContainer, tag: str, default: str | None = None) -> list[str]:
    """One lookup per *distinct* label set, then a vectorized gather per record."""
    distinct = [ls.get(tag, default) for ls in container.label_sets]
    missing = [i for i, v in enumerate(distinct) if v is None]
    if missing:
        raise BadArgument(f"label {tag!r} missing from series {missing[0]} and no default given")
    return [distinct[i] for i in container.part_idx]


def _is_data_column(schema: Schema, name: str) -> bool:
    return any(c.name == name for c in schema.columns)


def _analyze_string(args: list[str], schema: Schema) -> ComputedColumn:
    # :string <const> — constant string column (SimpleComputations.scala:19)
    if len(args) != 1:
        raise WrongNumberArguments(len(args), 1)
    const = args[0]
    return ComputedColumn(f":string {const}", ColumnType.STRING, None,
                          lambda c: [const] * len(c))


def _analyze_get_or_else(args: list[str], schema: Schema) -> ComputedColumn:
    # :getOrElse <tag> <default> (SimpleComputations.scala:40)
    if len(args) != 2:
        raise WrongNumberArguments(len(args), 2)
    tag, default = args
    if _is_data_column(schema, tag):
        raise BadArgument(f"{tag!r} is a data column; :getOrElse applies to label tags")
    return ComputedColumn(f":getOrElse {tag} {default}", ColumnType.STRING, tag,
                          lambda c: _label_values(c, tag, default))


def _analyze_round(args: list[str], schema: Schema) -> ComputedColumn:
    # :round <col> <to-nearest> — rounds DOWN to a multiple (SimpleComputations.scala:73)
    if len(args) != 2:
        raise WrongNumberArguments(len(args), 2)
    col, nearest_s = args
    ctype = _numeric_source(schema, col)
    try:
        nearest = float(nearest_s) if ctype == ColumnType.DOUBLE else int(nearest_s)
    except ValueError as e:
        raise BadArgument(str(e)) from None
    if nearest <= 0:
        raise BadArgument(f"round-to value must be positive, got {nearest_s}")

    def fn(c: RecordContainer):
        v = _numeric_values(c, col)
        if ctype == ColumnType.DOUBLE:
            return np.floor(v / nearest) * nearest
        return (v.astype(np.int64) // int(nearest)) * int(nearest)

    return ComputedColumn(f":round {col} {nearest_s}", ctype, col, fn)


def _analyze_string_prefix(args: list[str], schema: Schema) -> ComputedColumn:
    # :stringPrefix <tag> <numChars> (SimpleComputations.scala:103)
    if len(args) != 2:
        raise WrongNumberArguments(len(args), 2)
    tag, n_s = args
    try:
        n = int(n_s)
    except ValueError as e:
        raise BadArgument(str(e)) from None
    if n < 0:
        raise BadArgument("prefix length must be >= 0")
    return ComputedColumn(f":stringPrefix {tag} {n}", ColumnType.STRING, tag,
                          lambda c: [s[:n] for s in _label_values(c, tag, "")])


def _analyze_hash(args: list[str], schema: Schema) -> ComputedColumn:
    # :hash <col-or-tag> <numBuckets> (SimpleComputations.scala:121)
    if len(args) != 2:
        raise WrongNumberArguments(len(args), 2)
    src, nb_s = args
    try:
        buckets = int(nb_s)
    except ValueError as e:
        raise BadArgument(str(e)) from None
    if buckets <= 0:
        raise BadArgument("bucket count must be positive")

    if _is_data_column(schema, src):
        _numeric_source(schema, src)

        def fn(c: RecordContainer):
            v = _numeric_values(c, src).astype(np.int64)
            return np.abs(v % buckets).astype(np.int32)
    else:
        # hash once per distinct label set, then a vectorized gather per record
        def fn(c: RecordContainer):
            distinct = np.asarray(
                [fnv1a64(ls.get(src, "").encode()) % buckets for ls in c.label_sets],
                np.int32)
            return distinct[c.part_idx]

    return ComputedColumn(f":hash {src} {buckets}", ColumnType.INT, src, fn)


def _analyze_timeslice(args: list[str], schema: Schema) -> ComputedColumn:
    # :timeslice <tsCol> <duration> (TimeComputations.scala:22)
    if len(args) != 2:
        raise WrongNumberArguments(len(args), 2)
    col, dur_s = args
    ctype = _numeric_source(schema, col)
    if ctype not in (ColumnType.LONG, ColumnType.TIMESTAMP):
        raise BadArgument(f":timeslice needs a long/timestamp column, got {ctype.value}")
    dur = _parse_duration_ms(dur_s)

    def fn(c: RecordContainer):
        v = _numeric_values(c, col).astype(np.int64)
        return (v // dur) * dur

    return ComputedColumn(f":timeslice {col} {dur_s}", ColumnType.TIMESTAMP, col, fn)


def _analyze_month_of_year(args: list[str], schema: Schema) -> ComputedColumn:
    # :monthOfYear <tsCol> — 1..12 in UTC (TimeComputations.scala:51)
    if len(args) != 1:
        raise WrongNumberArguments(len(args), 1)
    col = args[0]
    ctype = _numeric_source(schema, col)
    if ctype not in (ColumnType.LONG, ColumnType.TIMESTAMP):
        raise BadArgument(f":monthOfYear needs a long/timestamp column, got {ctype.value}")

    def fn(c: RecordContainer):
        ms = _numeric_values(c, col).astype("datetime64[ms]")
        months = ms.astype("datetime64[M]").astype(np.int64) % 12 + 1
        return months.astype(np.int32)

    return ComputedColumn(f":monthOfYear {col}", ColumnType.INT, col, fn)


ALL_COMPUTATIONS: dict[str, Callable[[list[str], Schema], ComputedColumn]] = {
    "string": _analyze_string,
    "getOrElse": _analyze_get_or_else,
    "round": _analyze_round,
    "stringPrefix": _analyze_string_prefix,
    "hash": _analyze_hash,
    "timeslice": _analyze_timeslice,
    "monthOfYear": _analyze_month_of_year,
}


def analyze(expr: str, schema: Schema) -> ComputedColumn:
    """Parse + validate a ``:func arg...`` expression against a schema.

    Raises ``NotComputedColumn`` / ``NoSuchFunction`` / ``WrongNumberArguments`` /
    ``BadArgument`` (ref: ComputedColumn.analyze, ComputedColumn.scala:45-57).
    """
    if not is_computed(expr):
        raise NotComputedColumn(expr)
    parts = expr[1:].split()
    if not parts:
        raise NoSuchFunction("(empty)")
    fname, args = parts[0], parts[1:]
    analyzer = ALL_COMPUTATIONS.get(fname)
    if analyzer is None:
        raise NoSuchFunction(fname)
    return analyzer(args, schema)
