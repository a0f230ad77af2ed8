"""Derived-series publisher: rule output -> shard-routed containers with
DETERMINISTIC pub-ids.

The write path is the SAME replicated ingest plane every external sample
rides (gateway/broker -> bus consumers -> shard stores), so derived metrics
are first-class: queryable cluster-wide, downsampled, retained, cached —
nothing special-cases them. The one difference from the gateway is the
publish id: instead of a random nonce, every container's id derives from
``(rule uid, eval_ts, shard)``, so RE-evaluating a tick after a crash or a
broker leader failover re-publishes byte-identical frames under ids the
broker's journal already holds — the replay is a no-op and the derived
stream is exactly-once (the broker's pub-id idempotence, exercised
deliberately).

Port of ``filodb_tpu/rules/publish.py``: the same containers and the same
pub-id integers.
"""

from __future__ import annotations

from ..core.record import RecordBuilder, fnv1a64
from ..core.schemas import Schema, part_key_of, shard_key_of
from ..utils.metrics import FILODB_RULES_DERIVED_ROWS, registry
from .spec import RULE_LABEL


def derive_pub_id(uid: str, eval_ts: int, shard: int) -> int:
    """The deterministic publish id for one (rule, eval tick, shard)
    container. Low bit forced set — the broker treats id 0 as 'no id'."""
    return fnv1a64(f"{uid}|{int(eval_ts)}|{int(shard)}".encode()) | 1


class DerivedSeriesPublisher:
    """Builds per-shard containers from rule output rows and hands them to
    ``publish_fn(shard, container, pub_id)`` — the FiloServer wires that to
    ``BrokerBus.publish_with_id`` (replicated deployments) or a direct
    memstore ingest (in-process; the store's out-of-order drop dedupes a
    same-timestamp replay there)."""

    def __init__(self, schema: Schema, mapper, publish_fn,
                 dataset: str = ""):
        self.schema = schema
        self.mapper = mapper
        self.publish_fn = publish_fn
        self.dataset = dataset

    def route(self, labels: dict) -> int:
        opts = self.schema.options
        return self.mapper.shard_of(
            fnv1a64(shard_key_of(labels, opts)) & 0xFFFFFFFF,
            fnv1a64(part_key_of(labels, opts)))

    def publish(self, uid: str, group: str, eval_ts: int,
                rows: list[tuple[dict, float]]) -> int:
        """Publish one rule evaluation's derived samples; returns the row
        count. Rows sort into per-shard builders; container identity (and
        therefore pub-id coverage) is (rule, eval_ts, shard)."""
        if not rows:
            return 0
        builders: dict[int, RecordBuilder] = {}
        for labels, value in rows:
            assert labels.get(RULE_LABEL), "derived series must be tagged"
            shard = self.route(labels)
            b = builders.get(shard)
            if b is None:
                b = builders[shard] = RecordBuilder(self.schema)
            b.add(labels, int(eval_ts), float(value))
        for shard in sorted(builders):
            self.publish_fn(shard, builders[shard].build(),
                            derive_pub_id(uid, eval_ts, shard))
        registry.counter(FILODB_RULES_DERIVED_ROWS,
                         {"group": group}).increment(len(rows))
        return len(rows)
