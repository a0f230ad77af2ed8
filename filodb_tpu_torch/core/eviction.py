"""Eviction policies + evicted-part-key membership filter.

Reference: core/.../memstore/PartitionEvictionPolicy.scala:1-43 (pluggable policy
deciding when the shard must reclaim memory; WriteBufferFreeEvictionPolicy /
CompositeEvictionPolicy) and TimeSeriesShard.scala:93-96 (bloom filter of evicted
part keys, consulted on ingest so a returning series is detected, :1092).

TPU-native framing: "memory pressure" is HBM-row occupancy of the preallocated
``SeriesStore`` (sample columns) and series-slot occupancy (rows), instead of JVM
write buffers + off-heap blocks.
"""

from __future__ import annotations

import numpy as np


class EvictionPolicy:
    """Decides when a shard should reclaim store capacity."""

    def should_evict(self, store, config) -> bool:  # pragma: no cover - interface
        raise NotImplementedError


class CapacityEvictionPolicy(EvictionPolicy):
    """Evict only when some series row is full — the minimal policy (and the
    historical default): compaction happens exactly when an append could wrap."""

    def should_evict(self, store, config) -> bool:
        return bool(store.n_host.max(initial=0) >= config.samples_per_series)


class HeadroomEvictionPolicy(EvictionPolicy):
    """Keep at least ``headroom`` fraction of sample capacity free on the fullest
    row (ref: WriteBufferFreeEvictionPolicy's min-free-percent idea)."""

    def __init__(self, headroom: float = 0.1):
        assert 0.0 < headroom < 1.0
        self.headroom = headroom

    def should_evict(self, store, config) -> bool:
        cap = config.samples_per_series
        return bool(store.n_host.max(initial=0) >= cap * (1.0 - self.headroom))


class CompositeEvictionPolicy(EvictionPolicy):
    """Evict when any sub-policy says so (ref: CompositeEvictionPolicy)."""

    def __init__(self, *policies: EvictionPolicy):
        self.policies = policies

    def should_evict(self, store, config) -> bool:
        return any(p.should_evict(store, config) for p in self.policies)


class BloomFilter:
    """Fixed-size bloom filter over part-key bytes (ref: TimeSeriesShard's
    evictedPartKeys bloom, sized for millions of keys at low fp rate)."""

    def __init__(self, capacity: int = 1 << 20, hashes: int = 4):
        # ~9.6 bits/key at k=4 gives ~2% fp; round bits to a power of two
        bits = 1
        while bits < capacity * 10:
            bits <<= 1
        self._mask = bits - 1
        self._bits = np.zeros(bits >> 3, np.uint8)
        self._k = hashes
        self.count = 0

    def _positions(self, key: bytes):
        import zlib
        h1 = zlib.crc32(key)
        h2 = zlib.adler32(key) | 1
        for i in range(self._k):
            yield (h1 + i * h2) & self._mask

    def add(self, key: bytes) -> None:
        for pos in self._positions(key):
            self._bits[pos >> 3] |= 1 << (pos & 7)
        self.count += 1

    def __contains__(self, key: bytes) -> bool:
        if not self.count:      # nothing ever evicted: registration hot path
            return False
        return all(self._bits[p >> 3] & (1 << (p & 7)) for p in self._positions(key))
