"""TimeSeriesMemStore: per-dataset shards wiring ingest -> part-key index -> device store.

Port of ``filodb_tpu/core/memstore.py`` for the main path (ref:
core/.../memstore/TimeSeriesMemStore.scala, TimeSeriesShard.scala ingest
:459/:1183 and flush :771). Partition lookup is one host probe per distinct
label set per container (the native part-key table, or a dict); ingest
stages host buffers and lands them on the device store in one batched
in-place scatter per flush; eviction frees rows for reuse under slot
pressure.

The port's shards carry no durable sink yet, and no ingest offsets or group
watermarks with it. Recovery, purge, on-demand paging, inline downsampling,
the cardinality governor and compressed residency arrive with later slices.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..device import resolve_device
from ..utils.diagnostics import TimedRLock, assert_owned
from .chunkstore import SeriesStore
from .eviction import BloomFilter, CapacityEvictionPolicy, EvictionPolicy
from .filters import Filter
from .partkey_index import PartKeyIndex
from .record import RecordContainer
from .schemas import Schema, Schemas


@dataclass
class StoreConfig:
    """Per-dataset store tuning (ref: core/.../store/IngestionConfig.scala).
    ``device`` is where the shard's store lives: ``"cuda"`` by default, and
    construction raises when there is no card and the CPU was not asked
    for."""
    max_series_per_shard: int = 1 << 20
    samples_per_series: int = 1024          # device row capacity (ring via compaction)
    flush_batch_size: int = 65536           # staged samples triggering a device flush
    retention_ms: int = 3 * 3600 * 1000
    dtype: str = "float32"
    device: str | None = None

    def __post_init__(self):
        if self.dtype not in ("float32", "float64"):
            raise ValueError(f"dtype must be float32|float64, got {self.dtype!r}")


@dataclass
class ShardStats:
    rows_ingested: int = 0
    series_created: int = 0
    unknown_schema_dropped: int = 0
    partitions_evicted: int = 0
    evicted_part_key_reingests: int = 0


class TimeSeriesShard:
    """All state for one shard of one dataset."""

    BULK_CREATE_MIN = 512      # below this, per-key creation wins

    def __init__(self, dataset: str, schema: Schema, shard_num: int,
                 config: StoreConfig, device=None,
                 eviction_policy: EvictionPolicy | None = None):
        if schema.is_histogram or schema.is_multi_column:
            raise NotImplementedError(
                f"schema {schema.name!r}: histogram and multi-column stores "
                "are not yet ported")
        self.dataset = dataset
        self.schema = schema
        self.shard_num = shard_num
        self.config = config
        self.device = resolve_device(device if device is not None
                                     else config.device)
        self.index = PartKeyIndex()
        self._part_key_to_id: dict[bytes, int] = {}
        self._part_key_of_id: dict[int, bytes] = {}
        # native open-addressing part-key table, batch-probed once per
        # container; the dicts above stay the source of truth (and the
        # fallback without a toolchain)
        from . import native as _native
        self._pending_native: list = []
        self._native_ps = (_native.NativePartSet(config.max_series_per_shard)
                           if _native.available() else None)
        # hash each pid was inserted under: removal must use the same value
        self._pid_hash = (np.zeros(config.max_series_per_shard, np.uint64)
                          if self._native_ps is not None else None)
        # bumped on every partition release: invalidates batch-resolved pids
        self._release_epoch = 0
        self._free_pids: list[int] = []
        self._evicted_keys = BloomFilter()
        self._rv_keys: dict[int, object] = {}
        self.eviction_policy = eviction_policy or CapacityEvictionPolicy()
        # guards the in-place store mutation against concurrent query
        # launches: a query captures the tensors AND launches under it
        self.lock = TimedRLock(f"shard-{shard_num}-lock", order_class="shard",
                               order_index=shard_num)
        # per-slot release counters: lazily materialized query artifacts
        # (LazyKeys) detect slot reuse for exactly their pids
        self.slot_epoch = np.zeros(config.max_series_per_shard, np.uint32)
        self.store = SeriesStore(config.max_series_per_shard,
                                 config.samples_per_series,
                                 dtype=config.dtype, device=self.device)
        self.store.owner_lock = self.lock
        self._stage_pid: list[np.ndarray] = []
        self._stage_ts: list[np.ndarray] = []
        self._stage_val: list[np.ndarray] = []
        self._staged = 0
        self.stats = ShardStats()

    # -- partition resolution ----------------------------------------------

    def _resolve_segment_locked(self, container, mapping, first_ts, start) -> int:
        """Resolve label sets from ``start`` onward to dense part ids,
        creating partitions (and index entries) as needed, evicting under
        slot pressure. Returns one past the last label set resolved: when
        every eviction candidate is a series of this very container, the
        caller stages the prefix (making them evictable) and re-enters."""
        n_sets = len(container.label_sets)
        keys, hashes = container.resolved_keys()
        protected: set[int] = set()
        i = start
        while i < n_sets:
            if self._native_ps is not None:
                self._flush_native_locked()
                pids = self._native_ps.resolve_batch(hashes[i:], keys[i:])
            else:
                g = self._part_key_to_id.get
                pids = np.fromiter((g(k, -1) for k in keys[i:]), np.int32,
                                   count=n_sets - i)
            if i == start and self._bulk_create_locked(container, mapping,
                                                       pids, i, first_ts):
                return n_sets
            epoch0 = self._release_epoch
            seg = i
            for j in range(seg, n_sets):
                pid = int(pids[j - seg])
                if pid < 0:
                    pid = self._create_series_locked(
                        container.label_sets[j], keys[j], int(hashes[j]),
                        first_ts, protected)
                    if pid is None:
                        return j   # blocked on this container's own series
                mapping[j] = pid
                protected.add(pid)
                i = j + 1
                if self._release_epoch != epoch0 and i < n_sets:
                    break          # eviction ran: re-probe the tail
        return n_sets

    def _bulk_create_locked(self, container, mapping, probe_pids,
                            seg: int, first_ts) -> bool:
        """Registration fast path: admit all of a probe's misses in one bulk
        pass (dense pids, one bulk index add, one dict update). Only when
        nothing per-key can happen: capacity for every miss, no reusable
        slots, nothing ever evicted, no ignored shard-key tags."""
        miss = np.nonzero(probe_pids < 0)[0]
        if len(miss) < self.BULK_CREATE_MIN:
            return False
        if (self._free_pids or self.stats.partitions_evicted
                or self.schema.options.ignore_shard_key_tags
                or len(self.index) + len(miss) > self.config.max_series_per_shard):
            return False
        keys, hashes = container.resolved_keys()
        label_sets = container.label_sets
        n_sets = len(label_sets)
        base = len(self.index)
        new_pids = np.arange(base, base + len(miss), dtype=np.int64)
        new_keys = [keys[seg + j] for j in miss.tolist()]
        if len(set(new_keys)) != len(new_keys):
            return False
        added = False
        if (container.label_columns is not None and seg == 0
                and len(miss) == n_sets):
            fixed, vary, cols = container.label_columns
            added = self.index.add_part_keys_columnar(
                new_pids, fixed, vary, cols, first_ts)
        if not added:
            counts_hint = np.fromiter((len(label_sets[seg + j])
                                       for j in miss.tolist()), np.int64,
                                      count=len(miss))
            if not self.index.add_part_keys_bulk(new_pids, new_keys, first_ts,
                                                 counts_hint=counts_hint):
                return False
        pid_list = new_pids.tolist()
        self._part_key_to_id.update(zip(new_keys, pid_list))
        self._part_key_of_id.update(zip(pid_list, new_keys))
        if self._native_ps is not None:
            hs = hashes[seg + miss]
            self._flush_native_locked()
            self._native_ps.insert_arrays(hs, new_keys, new_pids.astype(np.int32))
            self._pid_hash[new_pids] = hs
        self.stats.series_created += len(miss)
        seg_map = mapping[seg:seg + (n_sets - seg)]
        hit = probe_pids >= 0
        seg_map[hit] = probe_pids[hit]
        seg_map[miss] = new_pids
        return True

    def _flush_native_locked(self) -> None:
        """Land deferred part-key inserts in one native call; runs before
        any native probe or removal."""
        if self._pending_native:
            self._native_ps.insert_batch(self._pending_native)
            self._pending_native.clear()

    def _create_series_locked(self, labels, pk: bytes, ph: int, first_ts,
                              protected) -> int | None:
        """Admit a new series: assign a slot (evicting under pressure),
        index it, mirror the key into the native table. None when every
        eviction candidate is protected."""
        S = self.config.max_series_per_shard
        pid = self._part_key_to_id.get(pk)
        if pid is not None:
            return pid
        if not self._free_pids and len(self.index) >= S:
            if not self._ensure_free_space_locked(protected):
                return None
        if pk in self._evicted_keys:
            self.stats.evicted_part_key_reingests += 1
        pid = self._free_pids.pop() if self._free_pids else len(self.index)
        self._part_key_to_id[pk] = pid
        self._part_key_of_id[pid] = pk
        if self._native_ps is not None:
            self._pending_native.append((ph, pk, pid))
            self._pid_hash[pid] = ph
        self.index.add_part_key(pid, labels, start_time=first_ts)
        self.stats.series_created += 1
        return pid

    def _ensure_free_space_locked(self, protected: set[int]) -> bool:
        """Evict the least-recently-active partitions so a new series can be
        admitted (ref: TimeSeriesShard.ensureFreeSpace :1315). False when
        every occupied slot is protected."""
        self._flush_staged_locked()   # staged rows must land before slots move
        occupied = np.fromiter(self._part_key_of_id.keys(), np.int64,
                               count=len(self._part_key_of_id))
        if protected:
            occupied = occupied[~np.isin(
                occupied, np.fromiter(protected, np.int64, count=len(protected)))]
        if occupied.size == 0:
            return False
        k = min(occupied.size, max(1, self.config.max_series_per_shard // 16))
        last = self.store.last_ts[occupied]
        victims = (occupied[np.argpartition(last, k - 1)[:k]]
                   if k < occupied.size else occupied)
        self._release_partitions_locked(victims.astype(np.int32))
        self.stats.partitions_evicted += int(victims.size)
        return True

    def _release_partitions_locked(self, pids: np.ndarray) -> None:
        """Teardown shared by purge and eviction: drop id maps (recording
        the keys in the evicted-keys filter), tombstone index entries, free
        the device rows, make the slots reusable."""
        pid_list = pids.tolist()
        self.slot_epoch[pids] += 1
        self._release_epoch += 1
        for pid in pid_list:
            pk = self._part_key_of_id.pop(pid, None)
            if pk is not None:
                del self._part_key_to_id[pk]
                self._evicted_keys.add(pk)
                if self._native_ps is not None:
                    self._flush_native_locked()
                    self._native_ps.remove(int(self._pid_hash[pid]), pk)
        self.index.remove_part_keys(pids)
        self.store.free_rows(pids)
        for pid in pid_list:
            self._rv_keys.pop(pid, None)
        self._free_pids.extend(pid_list)

    # -- ingest -------------------------------------------------------------

    def ingest(self, container: RecordContainer) -> None:
        """Ingest one container: resolve its label sets to part ids and
        stage its samples; a full staging buffer flushes to the device."""
        if container.schema.schema_id != self.schema.schema_id:
            with self.lock:
                self.stats.unknown_schema_dropped += len(container)
            return
        n_sets = len(container.label_sets)
        if n_sets == 0 or len(container) == 0:
            return
        mapping = np.empty(n_sets, np.int32)
        first_ts = int(container.ts.min())
        with self.lock:
            start = 0
            while start < n_sets:
                done = self._resolve_segment_locked(container, mapping,
                                                    first_ts, start)
                self._stage_segment_locked(container, mapping, start, done)
                if done < n_sets:
                    self._flush_staged_locked()
                start = done
        if self._staged >= self.config.flush_batch_size:
            self.flush()

    def _stage_segment_locked(self, container, mapping, start, done) -> None:
        """Stage the samples of label sets ``[start, done)``."""
        if start == 0 and done == len(container.label_sets):
            pids = mapping[container.part_idx]
            ts, vals = container.ts, container.values
        else:
            sel = (container.part_idx >= start) & (container.part_idx < done)
            pids = mapping[container.part_idx[sel]]
            ts, vals = container.ts[sel], container.values[sel]
        if len(pids) == 0:
            return
        self._stage_pid.append(pids)
        self._stage_ts.append(ts)
        self._stage_val.append(vals)
        self._staged += len(ts)
        self.stats.rows_ingested += len(ts)

    def _flush_staged_locked(self) -> int:
        """Land staged samples on the device store (caller holds the lock)."""
        if not self._staged:
            return 0
        pids = np.concatenate(self._stage_pid)
        ts = np.concatenate(self._stage_ts)
        vals = np.concatenate(self._stage_val, axis=0)
        self._stage_pid.clear(); self._stage_ts.clear(); self._stage_val.clear()
        self._staged = 0
        return self.store.append(pids, ts, vals)

    def discard_staged(self) -> None:
        """Drop staged samples without landing them (bulk-load set-up: the
        series are registered through the real ingest path and their data
        installed on the device directly)."""
        with self.lock:
            self._stage_pid.clear(); self._stage_ts.clear()
            self._stage_val.clear()
            self._staged = 0

    def flush(self) -> int:
        """Push staged samples to the device store; under capacity pressure
        compact out data older than retention (ref:
        PartitionEvictionPolicy.scala)."""
        with self.lock:
            if not self._staged:
                return 0
            written = self._flush_staged_locked()
        if self.eviction_policy.should_evict(self.store, self.config):
            cutoff = int(self.store.last_ts.max(initial=0)) - self.config.retention_ms
            with self.lock:
                self.store.compact(cutoff)
        return written

    # -- queries ------------------------------------------------------------

    def rv_key_of(self, pid: int):
        """Memoized RangeVectorKey for a live pid; call under the shard lock."""
        assert_owned(self.lock, "rv_key_of")
        k = self._rv_keys.get(pid)
        if k is None:
            from ..query.rangevector import RangeVectorKey
            k = self._rv_keys[pid] = RangeVectorKey.of(self.index.labels_of(pid))
        return k

    def part_ids_from_filters(self, filters: list[Filter], start: int,
                              end: int) -> np.ndarray:
        self.flush()
        with self.lock:
            return self.index.part_ids_from_filters(filters, start, end)

    @property
    def num_series(self) -> int:
        return len(self._part_key_to_id)


class TimeSeriesMemStore:
    """Dataset -> shards facade (ref: MemStore.scala + TimeSeriesMemStore).
    ``device`` is the default for shards set up without one."""

    def __init__(self, schemas: Schemas | None = None, device=None):
        self.schemas = schemas or Schemas()
        self.device = resolve_device(device)
        self._shards: dict[tuple[str, int], TimeSeriesShard] = {}
        self._configs: dict[str, StoreConfig] = {}
        self._dataset_schema: dict[str, Schema] = {}

    def setup(self, dataset: str, schema: Schema | str, shard: int,
              config: StoreConfig | None = None, device=None,
              eviction_policy: EvictionPolicy | None = None) -> TimeSeriesShard:
        if isinstance(schema, str):
            schema = self.schemas[schema]
        cfg = config or self._configs.get(dataset) or StoreConfig()
        dev = device if device is not None else (cfg.device or self.device)
        self._configs[dataset] = cfg
        self._dataset_schema[dataset] = schema
        key = (dataset, shard)
        if key in self._shards:
            raise ValueError(f"shard {shard} of {dataset} already set up")
        s = TimeSeriesShard(dataset, schema, shard, cfg, device=dev,
                            eviction_policy=eviction_policy)
        self._shards[key] = s
        return s

    def shard(self, dataset: str, shard: int) -> TimeSeriesShard:
        return self._shards[(dataset, shard)]

    def shards_of(self, dataset: str) -> list[TimeSeriesShard]:
        return [s for (d, _), s in sorted(self._shards.items()) if d == dataset]

    def ingest(self, dataset: str, shard: int, container: RecordContainer) -> None:
        self._shards[(dataset, shard)].ingest(container)

    def flush_all(self, dataset: str | None = None) -> None:
        for (d, _), s in self._shards.items():
            if dataset is None or d == dataset:
                s.flush()
