"""Shard mapping: consistent series -> shard routing with spread.

Reference: coordinator/.../ShardMapper.scala:26 + doc/sharding.md:27-60 — the
shard-key hash (ws/ns/metric) selects a group of 2^spread shards; low bits of the
full part-key hash spread series within the group. Queries whose filters pin the
whole shard key only touch 2^spread shards.

TPU-native reading: a shard is a slice of the device mesh's "shard" axis; this
module is pure host arithmetic shared by ingest routing and the query planner.
"""

from __future__ import annotations

import numpy as np


class ShardMapper:
    def __init__(self, num_shards: int, spread: int = 0):
        assert num_shards & (num_shards - 1) == 0, "num_shards must be a power of two"
        assert (1 << spread) <= num_shards
        self.num_shards = num_shards
        self.spread = spread

    def shard_of(self, shard_hash: int, part_hash: int) -> int:
        """Upper bits from the shard-key hash pick the group; ``spread`` low bits
        from the part-key hash pick the member (ref: ShardMapper.ingestionShard)."""
        group_bits = self.num_shards.bit_length() - 1 - self.spread
        group = (shard_hash & 0xFFFFFFFF) % (1 << group_bits) if group_bits else 0
        member = part_hash & ((1 << self.spread) - 1)
        return (group << self.spread) | member

    def shards_vector(self, shard_hash: np.ndarray, part_hash: np.ndarray) -> np.ndarray:
        group_bits = self.num_shards.bit_length() - 1 - self.spread
        group = (shard_hash.astype(np.uint64) % np.uint64(1 << group_bits)) if group_bits \
            else np.zeros(len(shard_hash), np.uint64)
        member = part_hash.astype(np.uint64) & np.uint64((1 << self.spread) - 1)
        return ((group << np.uint64(self.spread)) | member).astype(np.int32)

    def shards_for_shard_key(self, shard_hash: int) -> list[int]:
        """All shards that may hold series of one shard key (query fan-out)."""
        base = self.shard_of(shard_hash, 0)
        return [base | m for m in range(1 << self.spread)]

    def all_shards(self) -> list[int]:
        return list(range(self.num_shards))
