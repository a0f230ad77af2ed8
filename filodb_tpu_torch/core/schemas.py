"""Dataset schemas: columns, partition keys, and the multi-schema registry.

Reference: core/src/main/scala/filodb.core/metadata/Schemas.scala (config-driven
registry with 2-byte schema ids), metadata/Dataset.scala (partition vs data columns,
options incl. shardKeyColumns/metricColumn), metadata/Column.scala:94-103 (column types).

TPU-native difference: a schema here also fixes the *device layout* of its data
columns (which arrays exist in the HBM store), so it is the single source of truth
for both wire records and on-device storage.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from enum import Enum
from typing import Mapping, Sequence


class ColumnType(Enum):
    INT = "int"
    LONG = "long"
    DOUBLE = "double"
    STRING = "string"
    TIMESTAMP = "ts"
    MAP = "map"
    HISTOGRAM = "hist"


@dataclass(frozen=True)
class Column:
    name: str
    ctype: ColumnType
    # detectDrops: counter semantics -> reset correction applied by range functions
    is_counter: bool = False


@dataclass(frozen=True)
class DatasetOptions:
    """Reference: metadata/Dataset.scala DatasetOptions."""
    shard_key_columns: tuple[str, ...] = ("_ws_", "_ns_", "_metric_")
    metric_column: str = "_metric_"
    # labels ignored when computing the partition (series) identity hash
    ignore_shard_key_tags: tuple[str, ...] = ()


@dataclass(frozen=True)
class Schema:
    """One named schema: data columns (first must be the timestamp) + value column."""
    name: str
    columns: tuple[Column, ...]
    value_column: str
    downsamplers: tuple[str, ...] = ()
    options: DatasetOptions = field(default_factory=DatasetOptions)

    def __post_init__(self):
        assert self.columns[0].ctype == ColumnType.TIMESTAMP, "first data column must be timestamp"
        assert any(c.name == self.value_column for c in self.columns)

    @property
    def schema_id(self) -> int:
        """Stable 16-bit id from name+column shape (ref: Schemas.scala genHash)."""
        sig = self.name + "|" + ",".join(f"{c.name}:{c.ctype.value}:{int(c.is_counter)}" for c in self.columns)
        return zlib.crc32(sig.encode()) & 0xFFFF

    @property
    def value_col(self) -> Column:
        return next(c for c in self.columns if c.name == self.value_column)

    @property
    def is_histogram(self) -> bool:
        return self.value_col.ctype == ColumnType.HISTOGRAM

    # -- multi-value-column layout (ref: the reference's schemas carry several
    #    data columns per dataset — prom-histogram is timestamp+sum+count+h,
    #    filodb-defaults.conf:17-106 — selected at query time via __col__) ----

    @property
    def data_columns(self) -> tuple[Column, ...]:
        """All value-bearing columns (everything after the timestamp)."""
        return self.columns[1:]

    @property
    def is_multi_column(self) -> bool:
        return len(self.data_columns) > 1

    def column_named(self, name: str) -> Column | None:
        return next((c for c in self.data_columns if c.name == name), None)

    def col_layout(self, nbuckets: int) -> list[tuple[str, int, int, bool]]:
        """Flat ingest-row layout: [(name, offset, width, is_hist)] over a
        [n, W] values matrix; histogram columns span ``nbuckets`` slots."""
        out = []
        off = 0
        for c in self.data_columns:
            w = nbuckets if c.ctype == ColumnType.HISTOGRAM else 1
            out.append((c.name, off, w, c.ctype == ColumnType.HISTOGRAM))
            off += w
        return out

    def flat_width(self, nbuckets: int) -> int:
        return sum(w for _n, _o, w, _h in self.col_layout(nbuckets))


# The stock schemas shipped in the reference's filodb-defaults.conf:17-106.
GAUGE = Schema(
    "gauge",
    (Column("timestamp", ColumnType.TIMESTAMP), Column("value", ColumnType.DOUBLE)),
    value_column="value",
    downsamplers=("dMin", "dMax", "dSum", "dCount", "tTime"),
)
PROM_COUNTER = Schema(
    "prom-counter",
    (Column("timestamp", ColumnType.TIMESTAMP), Column("count", ColumnType.DOUBLE, is_counter=True)),
    value_column="count",
    downsamplers=("dLast", "tTime"),
)
PROM_HISTOGRAM = Schema(
    "prom-histogram",
    (
        Column("timestamp", ColumnType.TIMESTAMP),
        Column("sum", ColumnType.DOUBLE, is_counter=True),
        Column("count", ColumnType.DOUBLE, is_counter=True),
        Column("h", ColumnType.HISTOGRAM, is_counter=True),
    ),
    value_column="h",
    downsamplers=("dLast", "dLast", "hLast", "tTime"),
)
UNTYPED = Schema(
    "untyped",
    (Column("timestamp", ColumnType.TIMESTAMP), Column("value", ColumnType.DOUBLE)),
    value_column="value",
)


class Schemas:
    """Registry keyed by name and by 16-bit schema id."""

    def __init__(self, schemas: Sequence[Schema] = (GAUGE, PROM_COUNTER, PROM_HISTOGRAM, UNTYPED)):
        self.by_name: dict[str, Schema] = {}
        self.by_id: dict[int, Schema] = {}
        for s in schemas:
            self.register(s)

    def register(self, s: Schema) -> None:
        if s.name in self.by_name:
            raise ValueError(f"duplicate schema {s.name}")
        if s.schema_id in self.by_id:
            raise ValueError(f"schema id collision for {s.name}")
        self.by_name[s.name] = s
        self.by_id[s.schema_id] = s

    def __getitem__(self, key: str | int) -> Schema:
        return self.by_name[key] if isinstance(key, str) else self.by_id[key]


def part_key_bytes(sorted_items, ignore) -> bytes:
    """Canonical key bytes from PRE-SORTED (k, v) items — the builder hot
    path sorts once and derives part key, shard key, and its memo key from
    the same pass (each unique series pays this exactly once per builder)."""
    # build one str and encode once: ~3x faster than per-item encodes
    return "\x00".join(f"{k}\x01{v}" for k, v in sorted_items
                       if k not in ignore).encode()


def part_key_of(labels: Mapping[str, str], options: DatasetOptions = DatasetOptions()) -> bytes:
    """Canonical partition-key bytes for a label set (sorted, ignoring configured tags).

    Reference: BinaryRecord2 part keys sort their map field so identical label sets
    hash identically (binaryrecord2/RecordBuilder.scala sortAndComputeHashes).
    """
    return part_key_bytes(sorted(labels.items()), options.ignore_shard_key_tags)


def shard_key_of(labels: Mapping[str, str], options: DatasetOptions = DatasetOptions()) -> bytes:
    """Shard-key bytes: only the shard-key columns (ws/ns/metric) participate.

    Reference: RecordBuilder.shardKeyHash / doc/sharding.md:27-47 — the shard-key
    hash selects the shard group; the full part-key hash spreads within the group.
    """
    g = labels.get
    # one str build + one encode (UTF-8 is context-free: encoding the joined
    # string equals joining the per-item encodings)
    return "\x00".join(f"{k}\x01{g(k, '')}"
                       for k in options.shard_key_columns).encode()
