"""TimeSeriesMemStore: per-dataset shards wiring ingest -> part-key index -> device store.

Port of ``filodb_tpu/core/memstore.py`` (ref: core/.../memstore/
TimeSeriesMemStore.scala, TimeSeriesShard.scala ingest :459/:1183, flush
pipeline :771-:1048, recovery, eviction). Partition lookup is one host probe
per distinct label set per container (the native part-key table, or a
dict); ingest stages host buffers and lands them on the device store in one
batched in-place scatter per flush; eviction frees rows for reuse under slot
pressure.

Histogram schemas (prom-histogram: sum, count and the ``h`` bucket column)
create their store lazily — the bucket scheme arrives with the first
container. Under ``compressed_residency`` "gauge" a flush compresses a
scalar single-column store to its narrowest exact decode variant (delta8,
quant16 or delta16); under "all" also the [S, C, B] bucket block of a
histogram store, to i8/i16 2D-delta form. Compression runs in two phases:
the build outside the shard lock, the swap under it only if the store did
not mutate meanwhile. Under ``narrow_mirror`` a raw store keeps a quant16
copy beside its f32 block, rebuilt at flush outside the shard lock.

The durable tier (a ``ChunkSink``, ``core/store.py``), as in the reference:
flush groups (``pid % groups_per_shard``) collect each group's staged
samples with the highest ingest offset they carry; ``flush_group`` encodes
them on the host and writes one chunk-log frame, then commits the group's
checkpoint, and the group watermark advances. Part-key events (births and
release tombstones, in event order) persist before the chunks that use
them, to ``partkeys.log`` and as columnar index time buckets to
``index.log``. ``recover`` rebuilds a fresh shard from the sink — the index
from ``index.log`` when its trust window allows, else ``partkeys.log``; the
chunks as batched appends; then the bus replayed past the watermarks.
Retention drops partitions gone quiet (``purge_expired_partitions``) and
durable samples past a cutoff (``age_out_durable``, its heavy rewrite off
every lock). On-demand paging merges a query's cold sink chunks with the
resident rows (``read_with_paging``), one device gather and one host copy a
paged batch. An inline downsampler, when attached, consumes each durable
flush. The sink's encode and write run outside the shard lock; locks nest
``group_flush < sink < shard``.

Every change to what a query can see bumps the shard's ``data_epoch``
under the shard lock and logs the minimum data timestamp it can have
affected (``EPOCH_SPEC`` names the sites): the engine's result, negative
and fragment caches key on these epochs. A per-tenant cardinality governor
(``core/cardinality.py``), when attached, sheds new series at its quota.
The metadata API (label values and names) reads the part-key index.
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..utils.diagnostics import TimedRLock, assert_owned
from ..utils.metrics import (FILODB_INDEX_PERSISTED_BUCKETS,
                             FILODB_INDEX_RECOVER_MS,
                             FILODB_RETENTION_AGED_OUT_ROWS,
                             FILODB_RETENTION_ODP_ROWS,
                             FILODB_STORE_RESIDENCY_FALLBACK, registry)
from ..utils.tracing import SPAN_ODP_DURABLE, span
from .chunkstore import TS_PAD, SeriesStore, _Deferred
from .eviction import BloomFilter, CapacityEvictionPolicy, EvictionPolicy
from .filters import Filter
from .partkey_index import PartKeyIndex
from .record import RecordContainer
from .schemas import Schema, Schemas, part_key_bytes, part_key_of
from .store import (INDEX_FLAG_UNPARSEABLE, INDEX_GENESIS_BUCKET,
                    INDEX_RETIRE_BUCKET, INDEX_TOMBSTONE_BUCKET,
                    ChunkSetRecord, ChunkSink, encode_index_bucket,
                    labels_from_blob)

log = logging.getLogger(__name__)

# epoch-log sentinel: this visibility bump may have affected data at ANY
# timestamp (destructive mutations: partition release, retention
# compaction, durable age-out). Fragments validated against a log holding it invalidate
# whole (query/incremental.py stable_before).
EPOCH_AFFECTS_ALL = -(1 << 62)

# The declared visibility surface, a pure literal as in the reference
# (whose static checker reads it from the AST): every function where
# query-visible store state changes, with the affected-timestamp class its
# bump records:
#   "batch_min_ts"      — the bump logs the minimum data timestamp the
#                         mutation touched (staged flush, recovery chunk
#                         load, purge end-time marks); per-step fragment
#                         validity survives for steps before it
#   "EPOCH_AFFECTS_ALL" — destructive: rows at arbitrary timestamps
#                         vanished (release/eviction, retention
#                         compaction, durable age-out); caches invalidate
#                         whole
#   "admit"             — series admission only: a partition with no
#                         visible sample changes no answer, so no bump
#                         until the first staged flush lands its data
# Mutations that change no
# answer bump nothing: ``discard_staged`` drops rows no query saw,
# ``compress_commit`` swaps a store for its bit-exact narrow form, and a
# ``NarrowMirror`` refresh rebuilds a copy queries only consult.
EPOCH_SPEC = {
    "class": "TimeSeriesShard",
    "bump": "_bump_epoch_locked",
    "lock": "lock",
    "visible_calls": {
        "store": ("append", "compact", "free_rows"),
        "index": ("remove_part_keys", "update_end_time"),
        "sink": ("age_out", "age_out_commit"),
    },
    "admit_calls": {
        "index": ("add_part_key", "add_part_keys_bulk",
                  "add_part_keys_columnar"),
    },
    "admit_maps": ("_part_key_of_id", "_part_key_to_id"),
    "sites": {
        "staged_flush": {
            "fn": "TimeSeriesShard._flush_staged_locked",
            "affects": "batch_min_ts"},
        "partition_release": {
            "fn": "TimeSeriesShard._release_partitions_locked",
            "affects": "EPOCH_AFFECTS_ALL"},
        "purge_mark_ended": {
            "fn": "TimeSeriesShard.purge_expired_partitions",
            "affects": "batch_min_ts"},
        "compaction": {
            "fn": "TimeSeriesShard.flush",
            "affects": "EPOCH_AFFECTS_ALL"},
        "age_out": {
            "fn": "TimeSeriesShard.age_out_durable",
            "affects": "EPOCH_AFFECTS_ALL"},
        "recovery_chunk_load": {
            "fn": "TimeSeriesShard._recover_inner",
            "affects": "batch_min_ts"},
        "series_admit": {
            "fn": "TimeSeriesShard._create_series_locked",
            "affects": "admit"},
        "series_admit_bulk": {
            "fn": "TimeSeriesShard._bulk_create_locked",
            "affects": "admit"},
    },
}

# _create_series_locked outcome distinct from "blocked, stage the prefix
# first" (None): the tenant's cardinality quota shed this NEW series — the
# caller skips its samples (existing series are never affected)
SHED_PID = -2

# default granularity of persisted index time buckets (index.time_bucket)
DEFAULT_INDEX_BUCKET_MS = 6 * 3600 * 1000

# dense live runs at least this long load via ONE columnar bulk add at
# recovery; shorter runs stay per-key (bulk setup costs more than it saves)
RECOVER_BULK_MIN = 256


@dataclass
class StoreConfig:
    """Per-dataset store tuning (ref: core/.../store/IngestionConfig.scala).
    ``device`` is where the shard's store lives: ``"cuda"`` by default, and
    construction raises when there is no card and the CPU was not asked
    for."""
    max_series_per_shard: int = 1 << 20
    samples_per_series: int = 1024          # device row capacity (ring via compaction)
    flush_batch_size: int = 65536           # staged samples triggering a device flush
    groups_per_shard: int = 16              # durable flush groups (pid % groups)
    retention_ms: int = 3 * 3600 * 1000
    dtype: str = "float32"
    device: str | None = None
    # which store shapes adopt the compressed-resident form after flush:
    #   "off"   — raw f32/i64 blocks stay resident
    #   "gauge" — scalar f32 single-column stores: the narrowest decode
    #             variant that carries the data bit-exactly (delta8, quant16,
    #             delta16: ops/decodereg.py) + timestamp elision
    #   "all"   — "gauge", and [S, C, B] histogram stores (i8/i16 2D-delta
    #             bucket blocks + timestamp elision)
    compressed_residency: str = "off"
    # keep a quant16 mirror (ops/narrow.NarrowMirror) beside a raw f32
    # store's value block, rebuilt at flush: the fused pass streams 2 B a
    # sample instead of 4 for the rows that round-trip bit-exactly (the
    # rest ride the general kernels). Off by default, as in the reference;
    # only with residency "off" (a compressed store is its own narrow form)
    narrow_mirror: bool = False

    def __post_init__(self):
        if self.dtype not in ("float32", "float64"):
            raise ValueError(f"dtype must be float32|float64, got {self.dtype!r}")
        if self.compressed_residency not in ("off", "gauge", "all"):
            raise ValueError(
                f"compressed_residency must be off|gauge|all, "
                f"got {self.compressed_residency!r}")


@dataclass
class ShardStats:
    rows_ingested: int = 0
    series_created: int = 0
    unknown_schema_dropped: int = 0
    partitions_purged: int = 0
    partitions_evicted: int = 0
    evicted_part_key_reingests: int = 0
    series_quota_shed: int = 0


class TimeSeriesShard:
    """All state for one shard of one dataset."""

    BULK_CREATE_MIN = 512      # below this, per-key creation wins

    def __init__(self, dataset: str, schema: Schema, shard_num: int,
                 config: StoreConfig, device=None,
                 sink: ChunkSink | None = None,
                 eviction_policy: EvictionPolicy | None = None):
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
        # O(1) data-time lead: the max sample timestamp ever staged or
        # recovered (the retention router reads it per query; monotonic)
        self.lead_ms = 0
        # visibility watermark: bumped under the shard lock whenever what a
        # query can see changes (a staged flush landing rows, a partition
        # release, a retention compaction). The engine's caches record the
        # vector of these counters and serve only while it still matches.
        self.data_epoch = 0
        # (new epoch, min affected data ts) per bump, for per-step fragment
        # validity (query/incremental.stable_before): an append logs the
        # minimum timestamp that became visible, a destructive bump
        # EPOCH_AFFECTS_ALL. Bounded; a gap reads as "unknown" and the
        # fragment invalidates whole, never a stale serve.
        self._epoch_log: deque[tuple[int, int]] = deque(maxlen=256)
        # staged-but-not-visible sample timestamps: min feeds the epoch log
        # at the flush, max the visible lead
        self._stage_min_ts: int | None = None
        self._stage_max_ts = 0
        # query-visible data-time lead: advances when staged rows land on
        # the store (streaming increments chase it, never the staged lead)
        self.visible_lead_ms = 0
        # True while recover() rebuilds the shard: an empty selection seen
        # meanwhile is no proof of emptiness, so the negative cache does not
        # record it
        self.recovering = False
        self._free_pids: list[int] = []
        self._evicted_keys = BloomFilter()
        self._rv_keys: dict[int, object] = {}
        self.eviction_policy = eviction_policy or CapacityEvictionPolicy()
        # guards the in-place store mutation against concurrent query
        # launches: a query captures the tensors AND launches under it
        self.lock = TimedRLock(f"shard-{shard_num}-lock", order_class="shard",
                               order_index=shard_num)
        # per-slot release counters: the flush requeue detects slot reuse
        # for exactly its pids
        self.slot_epoch = np.zeros(config.max_series_per_shard, np.uint32)
        # the ``_release_epoch`` of each slot's latest release (0: never
        # released): a lazily materialized query artifact (LazyKeys) that
        # captured the release epoch e0 fails for exactly the selected
        # slots released since, ``slot_released_at[pids] > e0``
        self.slot_released_at = np.zeros(config.max_series_per_shard,
                                         np.uint64)
        self.bucket_les: np.ndarray | None = None
        if schema.is_histogram:
            # histogram stores are created lazily: the bucket scheme arrives
            # with the first container
            self.store = None
        else:
            self.store = self._make_store()
            self.store.owner_lock = self.lock
        self._last_compress_epoch = None
        self._stage_pid: list[np.ndarray] = []
        self._stage_ts: list[np.ndarray] = []
        self._stage_val: list[np.ndarray] = []
        self._staged = 0
        # per-group ingest offset watermarks (ref: checkpoint per flush group)
        G = config.groups_per_shard
        self.group_watermarks = np.full(G, -1, np.int64)
        self._pending_offset = -1
        # persistence (ref: doFlushSteps — encode + sink write + checkpoint
        # commit): per group, the staged (pids, ts, vals) awaiting a durable
        # flush and the highest offset they carry
        self.sink = sink
        self._pending_chunks: list[list] = [[] for _ in range(G)]
        self._pending_group_offset = np.full(G, -1, np.int64)
        # pids of chunk snapshots a flush_group is writing (token -> unique
        # pids): eviction and purge must not release them, or the dead
        # pid's samples would persist after its tombstone and, after slot
        # reuse, recover as the slot's next owner's
        self._inflight_flush: dict[object, np.ndarray] = {}
        # one flush at a time per group: when flush_group(g) returns, any
        # flush of g that had snapshotted the pending chunks has finished
        # its sink write and its inline-downsample publish
        self._group_flush_locks = [
            TimedRLock(f"shard-{shard_num}-group-{g}-flush",
                       order_class="group_flush", order_index=g)
            for g in range(G)]
        # ordered part-key event log awaiting durable persist: creations
        # (pid, labels, start) and release tombstones (pid, {}, -1) in event
        # order, so recovery's last-entry-wins resolves slot reuse
        self._partkey_log: list[tuple] = []
        # serializes drain + write batches (ordered: sink < shard)
        self._sink_lock = TimedRLock(f"shard-{shard_num}-sink-lock",
                                     order_class="sink",
                                     order_index=shard_num)
        self._meta_written = False
        # inline downsampling at flush (ref: ShardDownsampler +
        # DownsamplePublisher): (resolution_ms, target) where the target is
        # a streaming InlineDownsampler or callback(shard, {agg: records})
        self.downsample: tuple | None = None
        # durable index time buckets (0 disables): each part-key drain also
        # appends columnar index frames, so a restart recovers the index by
        # bulk loads instead of per key
        self.index_bucket_ms = DEFAULT_INDEX_BUCKET_MS
        # True once index.log carries a GENESIS snapshot of this shard's
        # full history: recovery trusts the log only from its last genesis
        self._index_log_seeded = False
        self.stats = ShardStats()
        # per-tenant active-series governor (core/cardinality.py), shared by
        # a dataset's shards and consulted under the shard lock at every
        # series birth; None: no quota
        self.governor = None

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
                if pid >= 0:       # SHED_PID: quota-shed birth, no slot
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
        gov_tenant = None
        if self.governor is not None and self.governor.limit is not None:
            # all-or-nothing block reservation; mixed-tenant batches (or a
            # batch that does not fit) take the per-key path, which sheds
            # series-precisely
            tenants = {self.governor.tenant_of(label_sets[seg + int(j)])
                       for j in miss}
            if len(tenants) != 1:
                return False
            gov_tenant = tenants.pop()
            if not self.governor.admit_block(gov_tenant, len(miss)):
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
                if gov_tenant is not None:   # the reservation rolls back
                    self.governor.retire(gov_tenant, len(miss))
                return False
        pid_list = new_pids.tolist()
        self._part_key_to_id.update(zip(new_keys, pid_list))
        self._part_key_of_id.update(zip(pid_list, new_keys))
        if self._native_ps is not None:
            hs = hashes[seg + miss]
            self._flush_native_locked()
            self._native_ps.insert_arrays(hs, new_keys, new_pids.astype(np.int32))
            self._pid_hash[new_pids] = hs
        if self.sink is not None:
            # 4-tuple form: labels stay a (sequence, index) reference so the
            # dicts build at flush time, outside the shard lock
            self._partkey_log.extend(
                (pid, label_sets, seg + j, first_ts)
                for pid, j in zip(pid_list, miss.tolist()))
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
        eviction candidate is protected; SHED_PID when the tenant's quota
        sheds the birth."""
        S = self.config.max_series_per_shard
        pid = self._part_key_to_id.get(pk)
        if pid is not None:
            return pid
        gov_tenant = None
        if self.governor is not None:
            # series-birth limiter, checked before any eviction so an
            # over-quota birth never evicts another series for a slot it
            # will not use; samples of existing series are unaffected
            gov_tenant = self.governor.tenant_of(labels)
            if not self.governor.admit(gov_tenant):
                self.stats.series_quota_shed += 1
                self.governor.count_shed("shard", gov_tenant)
                return SHED_PID
        if not self._free_pids and len(self.index) >= S:
            if not self._ensure_free_space_locked(protected):
                # blocked (the caller stages its prefix and retries, which
                # admits again): the reservation rolls back
                if gov_tenant is not None:
                    self.governor.retire(gov_tenant)
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
        if self.sink is not None:
            self._partkey_log.append((pid, labels, first_ts))
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
        if self._inflight_flush:
            # snapshots mid-write: releasing these pids would persist dead
            # samples after their tombstone
            inflight = np.unique(np.concatenate(
                list(self._inflight_flush.values())))
            occupied = occupied[~np.isin(occupied, inflight)]
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
        the device rows, make the slots reusable. Durable tombstones (queued
        here, written outside the lock by the next drain) keep recovery from
        resurrecting the series or giving its persisted chunks to a later
        owner of the slot."""
        pid_list = pids.tolist()
        self.slot_epoch[pids] += 1
        self._release_epoch += 1
        self.slot_released_at[pids] = self._release_epoch
        # destructive: a released series held samples at any timestamp
        self._bump_epoch_locked(EPOCH_AFFECTS_ALL)
        if self.governor is not None:
            # labels still resolve here (the index tombstones below):
            # released series give back their tenant's quota slots
            for pid in pid_list:
                self.governor.retire(
                    self.governor.tenant_of(self.index.labels_of(pid)))
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
        # open downsample buckets of released partitions must never emit:
        # the slot's next owner would be attributed the dead series' data
        if self.downsample is not None and hasattr(self.downsample[1],
                                                   "drop_pids"):
            self.downsample[1].drop_pids(pid_list)
        if self.sink is not None:
            # unpersisted samples of a released partition must never reach
            # the sink under a pid the slot's next owner may hold by
            # recovery time (purge refuses pids with pending chunks;
            # eviction cannot refuse, so it scrubs them)
            gone_arr = np.asarray(pid_list, np.int32)
            for g, pending in enumerate(self._pending_chunks):
                if not pending:
                    continue
                kept = []
                for pids_, ts_, vals_ in pending:
                    m = ~np.isin(pids_, gone_arr)
                    if m.all():
                        kept.append((pids_, ts_, vals_))
                    elif m.any():
                        kept.append((pids_[m], ts_[m], vals_[m]))
                self._pending_chunks[g] = kept
            self._partkey_log.extend((pid, {}, -1) for pid in pid_list)

    def _bump_epoch_locked(self, min_affected_ms: int) -> None:
        """Advance the visibility watermark (the caller holds the shard
        lock), logging the minimum data timestamp the mutation can have
        touched (``EPOCH_AFFECTS_ALL`` for destructive changes). Every
        ``data_epoch`` bump goes through here: per-step fragment validity
        needs one log entry a bump."""
        self.data_epoch += 1
        self._epoch_log.append((self.data_epoch, int(min_affected_ms)))

    def epoch_state(self) -> tuple[int, list[tuple[int, int]]]:
        """``(data_epoch, recent (epoch, min affected ts) entries)``, read
        together under the shard lock (host integers only: no device
        sync)."""
        with self.lock:
            return self.data_epoch, list(self._epoch_log)

    # -- durable part-key events ---------------------------------------------

    def _flush_partkey_log(self) -> None:
        """Persist queued part-key events. Drain and write share one
        critical section (``_sink_lock``, not the shard lock: sink I/O must
        not stall ingest or queries): two concurrent drains could otherwise
        write out of event order, and a released slot's tombstone landing
        after its new owner's key would erase that series on recovery."""
        if self.sink is None:
            return
        with self._sink_lock:
            with self.lock:
                events, self._partkey_log = self._partkey_log, []
            if not events:
                return
            try:
                # (pid, labels, start), or the bulk path's deferred
                # (pid, labels_seq, idx, start), materialized here
                rows = []
                for e in events:
                    if len(e) == 3:
                        pid, labels, start = e
                    else:
                        pid, seq, i, start = e
                        labels = seq[i]
                    rows.append((int(pid), labels, int(start)))
                # index time buckets first, then the JSON part-key log: a
                # crash between the two leaves index.log ahead (extra
                # events replay idempotently), never behind
                self._persist_index_buckets(rows)
                self.sink.write_part_keys(self.dataset, self.shard_num, rows)
            except Exception:
                # transient sink failure: the events survive for the retry,
                # ahead of anything queued meanwhile
                with self.lock:
                    self._partkey_log = events + self._partkey_log
                raise

    @staticmethod
    def _index_entry(pid: int, labels: dict, start: int) -> tuple:
        """(pid, start, blob, flags) for one index.log entry. Labels the
        pair encoding cannot represent get the UNPARSEABLE flag: recovery
        then refuses the frames path for the shard."""
        for k, v in labels.items():
            if "\x00" in k or "\x00" in v or "\x01" in k:
                return (pid, start, b"", INDEX_FLAG_UNPARSEABLE)
        return (pid, start, part_key_bytes(sorted(labels.items()), ()), 0)

    def _write_index_genesis(self) -> None:
        """Append a GENESIS frame (a complete live-series snapshot, the
        trust anchor recovery applies the log from): at the first drain of
        a fresh shard, or after a recovery that rebuilt from partkeys.log.
        The caller holds ``_sink_lock`` or is the recovery; the snapshot
        takes the shard lock (sink < shard)."""
        with self.lock:
            snapshot = [self._index_entry(pid, self.index.labels_of(pid),
                                          self.index.start_time(pid))
                        for pid in sorted(self._part_key_of_id)]
        self.sink.write_index_bucket(
            self.dataset, self.shard_num,
            encode_index_bucket(INDEX_GENESIS_BUCKET, snapshot))
        self._index_log_seeded = True

    def _persist_index_buckets(self, rows) -> None:
        """Append columnar index frames for one drain batch, grouped into
        consecutive same-bucket runs (grouping by dict could move a
        tombstone past a slot-reusing re-creation; last-entry-wins recovery
        needs event order). Births bucket by start time; tombstones ride
        the tombstone pseudo-bucket."""
        if not self.index_bucket_ms \
                or not hasattr(self.sink, "write_index_bucket"):
            return
        if not self._index_log_seeded:
            self._write_index_genesis()
        frames: list[bytes] = []
        cur_bucket: int | None = None
        cur: list[tuple] = []
        for pid, labels, start in rows:
            if labels:
                entry = self._index_entry(pid, labels, start)
                bucket = (start // self.index_bucket_ms) \
                    * self.index_bucket_ms
            else:
                entry = (pid, start, b"", 0)
                bucket = INDEX_TOMBSTONE_BUCKET
            if bucket != cur_bucket and cur:
                frames.append(encode_index_bucket(cur_bucket, cur))
                cur = []
            cur_bucket = bucket
            cur.append(entry)
        if cur:
            frames.append(encode_index_bucket(cur_bucket, cur))
        for frame in frames:
            self.sink.write_index_bucket(self.dataset, self.shard_num, frame)
        if frames:
            registry.counter(FILODB_INDEX_PERSISTED_BUCKETS,
                             {"dataset": self.dataset,
                              "shard": str(self.shard_num)}) \
                .increment(len(frames))

    # -- ingest -------------------------------------------------------------

    def _make_store(self, width_hint: int = 0) -> SeriesStore:
        """Device store shaped by the schema: multi-column schemas get one
        tensor per data column sharing ts/n (Schema.col_layout); single
        column schemas keep the flat scalar/histogram layout
        (``width_hint``: bucket count of a les-less 2-D container)."""
        nb = len(self.bucket_les) if self.bucket_les is not None else 0
        if not nb and not self.schema.is_multi_column:
            nb = width_hint
        layout = (self.schema.col_layout(nb)
                  if self.schema.is_multi_column else None)
        return SeriesStore(self.config.max_series_per_shard,
                           self.config.samples_per_series,
                           dtype=self.config.dtype, device=self.device,
                           nbuckets=nb, layout=layout,
                           default_col=self.schema.value_column)

    def ingest(self, container: RecordContainer, offset: int = -1,
               recovery_watermarks: np.ndarray | None = None) -> None:
        """Ingest one container from bus ``offset``: resolve its label sets
        to part ids and stage its samples; a full staging buffer flushes to
        the device. During recovery replay, rows whose flush group already
        persisted past ``offset`` are skipped (ref: TimeSeriesShard
        recovery skips rows below the group watermark, :180-184)."""
        if container.schema.schema_id != self.schema.schema_id:
            with self.lock:
                self.stats.unknown_schema_dropped += len(container)
            return
        if self.store is None:
            # double-checked under the shard lock: two writers racing the
            # first container would each build a store
            with self.lock:
                if self.store is None:
                    self.bucket_les = (np.asarray(container.bucket_les)
                                       if container.bucket_les is not None
                                       else None)
                    width = (container.values.shape[1]
                             if container.values.ndim == 2 else 0)
                    self.store = self._make_store(width_hint=width)
                    self.store.owner_lock = self.lock
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
                self._stage_segment_locked(container, mapping, start, done,
                                           offset, recovery_watermarks)
                if done < n_sets:
                    self._flush_staged_locked()
                start = done
        if self._staged >= self.config.flush_batch_size:
            self.flush()

    def _stage_segment_locked(self, container, mapping, start, done, offset,
                              recovery_watermarks) -> None:
        """Stage the samples of label sets ``[start, done)``, and file them
        under their flush groups when a sink is attached."""
        if start == 0 and done == len(container.label_sets):
            pids = mapping[container.part_idx]
            ts, vals = container.ts, container.values
        else:
            sel = (container.part_idx >= start) & (container.part_idx < done)
            pids = mapping[container.part_idx[sel]]
            ts, vals = container.ts[sel], container.values[sel]
        if len(pids) and pids.min() < 0:
            # quota-shed births (SHED_PID): drop exactly their samples
            keep = pids >= 0
            pids, ts, vals = pids[keep], ts[keep], vals[keep]
        if recovery_watermarks is not None:
            keep = recovery_watermarks[pids % self.config.groups_per_shard] < offset
            if not keep.all():
                pids, ts, vals = pids[keep], ts[keep], vals[keep]
        if len(pids) == 0:
            return
        self._stage_pid.append(pids)
        self._stage_ts.append(ts)
        self._stage_val.append(vals)
        batch_min, lead = int(ts.min()), int(ts.max())
        if self._stage_min_ts is None or batch_min < self._stage_min_ts:
            self._stage_min_ts = batch_min
        if lead > self._stage_max_ts:
            self._stage_max_ts = lead
        if lead > self.lead_ms:
            self.lead_ms = lead
        self._staged += len(ts)
        self._pending_offset = max(self._pending_offset, offset)
        self.stats.rows_ingested += len(ts)
        if self.sink is not None:
            # one stable argsort + split instead of a mask per group (the
            # narrowest key type: a byte-wide key sorts by radix)
            G = self.config.groups_per_shard
            groups = pids % G
            order = np.argsort(groups.astype(np.min_scalar_type(G - 1)),
                               kind="stable")
            gs = groups[order]
            for idx in np.split(order, np.flatnonzero(np.diff(gs)) + 1):
                if not len(idx):
                    continue
                g = int(groups[idx[0]])
                self._pending_chunks[g].append((pids[idx], ts[idx], vals[idx]))
                self._pending_group_offset[g] = max(
                    self._pending_group_offset[g], offset)

    def _flush_staged_locked(self) -> int:
        """Land staged samples on the device store (caller holds the lock)."""
        if not self._staged:
            return 0
        # the visibility point: staged rows are host-side until this
        # scatter, so the bump belongs here, not at staging (a query cached
        # in between would validate against rows it did not see)
        self._bump_epoch_locked(self._stage_min_ts
                                if self._stage_min_ts is not None
                                else EPOCH_AFFECTS_ALL)
        self._stage_min_ts = None
        if self._stage_max_ts > self.visible_lead_ms:
            self.visible_lead_ms = self._stage_max_ts
        pids = np.concatenate(self._stage_pid)
        ts = np.concatenate(self._stage_ts)
        vals = np.concatenate(self._stage_val, axis=0)
        self._stage_pid.clear(); self._stage_ts.clear(); self._stage_val.clear()
        self._staged = 0
        return self.store.append(pids, ts, vals)

    def discard_staged(self) -> None:
        """Drop staged samples without landing them (bulk-load set-up: the
        series are registered through the real ingest path and their data
        installed on the device directly). No epoch bump: no query saw the
        dropped rows."""
        with self.lock:
            self._stage_pid.clear(); self._stage_ts.clear()
            self._stage_val.clear()
            self._staged = 0
            self._stage_min_ts = None
            self._stage_max_ts = 0

    def flush(self) -> int:
        """Push staged samples to the device store; under capacity pressure
        compact out data older than retention (ref:
        PartitionEvictionPolicy.scala); then adopt the compressed-resident
        form when the residency mode asks for it."""
        with self.lock:
            staged = bool(self._staged)
            written = self._flush_staged_locked() if staged else 0
        resident = self.config.compressed_residency != "off"
        if not staged:
            # nothing new — but a compaction since the last flush may have
            # rehydrated a compressed-resident store: re-adopt
            if resident:
                self._compress_resident_two_phase()
            return 0
        if self.config.narrow_mirror and not resident:
            # flush-time rebuild, outside the lock: the build streams the
            # whole store and copies the ok flags to the host; queries only
            # consult the mirror
            self.store.narrow.refresh(self.store)
        if self.sink is None and self._pending_offset >= 0:
            # without a durable sink, device residency is the only watermark
            with self.lock:
                self.group_watermarks[:] = self._pending_offset
        if self.eviction_policy.should_evict(self.store, self.config):
            cutoff = int(self.store.last_ts.max(initial=0)) - self.config.retention_ms
            with self.lock:
                self.store.compact(cutoff)
                # rows aged out (destructive)
                self._bump_epoch_locked(EPOCH_AFFECTS_ALL)
        if resident:
            # after any compaction (which rehydrates): the streaming build
            # and host fetches run OUTSIDE the shard lock, only the swap
            # takes it
            self._compress_resident_two_phase()
        return written

    def _compress_resident_two_phase(self) -> None:
        """Build the compressed-resident state without the shard lock, then
        swap under it iff nothing mutated meanwhile (a racing append writes
        into the very tensors the build streams — its result is stale and
        dropped; the next flush retries). Histogram stores compress only
        under "all"."""
        st = self.store
        if st is None or (st.nbuckets
                          and self.config.compressed_residency != "all"):
            return
        epoch0 = st.mutation_epoch()
        # idempotence: fully compressed already, or nothing mutated since
        # the last (possibly declined) attempt — a declined store must not
        # re-run the whole-store build on every empty flush
        if st._val_compressed and (st._ts_elided or st.grid_info() is None):
            return
        if self._last_compress_epoch == epoch0:
            return
        self._last_compress_epoch = epoch0
        prep = st.compress_prepare()
        if prep is None:
            if st.residency_decline is not None:
                # "tried and fell back" must be a visible signal, not a
                # silent raw-residency downgrade
                registry.counter(FILODB_STORE_RESIDENCY_FALLBACK,
                                 {"reason": st.residency_decline}).increment()
            return
        with self.lock:
            if st.mutation_epoch() == epoch0:
                st.compress_commit(prep)

    # -- persistence flush pipeline (ref: TimeSeriesShard.doFlushSteps :814) --

    def flush_group(self, group: int) -> int:
        """Encode and persist one flush group's pending samples, then commit
        its checkpoint after the write (ref: :989 writeChunks -> :1048
        commitCheckpoint). Serialized per group. Returns the number of
        chunkset records written."""
        if self.sink is None:
            return 0
        with self._group_flush_locks[group]:
            return self._flush_group_serialized(group)

    def _flush_group_serialized(self, group: int) -> int:
        self.flush()                      # device state first
        token = object()
        with self.lock:
            pending = self._pending_chunks[group]
            self._pending_chunks[group] = []
            # per-batch slot epochs: if the persist fails and a release ran
            # meanwhile, the requeue scrubs exactly the released slots
            pend_epochs = [self.slot_epoch[p].copy() for (p, _, _) in pending]
            if pending:
                self._inflight_flush[token] = np.unique(
                    np.concatenate([p for (p, _, _) in pending]))
        try:
            # part-key events land before the chunks that reference them.
            # The chunk snapshot comes first: every pid in it was resolved
            # (and logged) before its samples were staged, so this drain
            # covers it
            self._flush_partkey_log()
            if not pending:
                return 0
            pids = np.concatenate([p for p, _, _ in pending])
            ts = np.concatenate([t for _, t, _ in pending])
            vals = np.concatenate([v for _, _, v in pending])
            order = np.argsort(pids, kind="stable")
            pids, ts, vals = pids[order], ts[order], vals[order]
            bounds = np.concatenate([[0], np.nonzero(np.diff(pids))[0] + 1,
                                     [len(pids)]])
            layout = None
            if self.schema.is_multi_column:
                nb = len(self.bucket_les) if self.bucket_les is not None else 0
                layout = tuple(self.schema.col_layout(nb))
            records = [
                ChunkSetRecord(int(pids[bounds[i]]),
                               ts[bounds[i]:bounds[i + 1]],
                               vals[bounds[i]:bounds[i + 1]], layout)
                for i in range(len(bounds) - 1)
            ]
            if self.bucket_les is not None and not self._meta_written:
                if hasattr(self.sink, "write_meta"):
                    self.sink.write_meta(
                        self.dataset, self.shard_num,
                        {"bucket_les": list(map(float, self.bucket_les))})
                self._meta_written = True
            self.sink.write_chunkset(self.dataset, self.shard_num, group,
                                     records)
        except Exception:
            # a transient sink failure must not lose the snapshot: requeue
            # it for the next attempt. A duplicate frame from a partial
            # attempt dedups at recovery (the store's out-of-order drop) and
            # at paged reads (keep-first); a torn tail frame is skipped by
            # the reader
            with self.lock:
                self._requeue_pending_locked(group, pending, pend_epochs)
                self._inflight_flush.pop(token, None)
            raise
        try:
            # inline downsample after the durable write, still under the
            # inflight token: a release between the write and this add
            # would otherwise rebuild an open bucket of a dead pid after
            # drop_pids scrubbed it. A failure keeps the downsampler's
            # accumulators for the next flush
            if self.downsample is not None and vals.ndim == 1:
                res_ms, target = self.downsample
                try:
                    if hasattr(target, "add"):    # streaming InlineDownsampler
                        target.add(self, pids, ts, vals)
                    else:                         # plain callback
                        from .downsample import downsample_records
                        target(self, downsample_records(pids, ts, vals, res_ms))
                except Exception:
                    log.exception("inline downsample publish failed; "
                                  "will retry")
        finally:
            with self.lock:
                self._inflight_flush.pop(token, None)
        off = int(self._pending_group_offset[group])
        if off >= 0:
            # a checkpoint failure does not requeue: the chunks are durable,
            # the watermark lags and recommits on the next flush
            self.sink.write_checkpoint(self.dataset, self.shard_num, group,
                                       off)
            with self.lock:
                self.group_watermarks[group] = off
        return len(records)

    def _requeue_pending_locked(self, group, pending, pend_epochs) -> None:
        """Return a failed flush's snapshot to the front of the pending
        queue, scrubbing samples whose slot was released while the snapshot
        was out of ``_pending_chunks``. Caller holds the lock."""
        kept = []
        for (pids_, ts_, vals_), eps in zip(pending, pend_epochs):
            m = self.slot_epoch[pids_] == eps
            if m.all():
                kept.append((pids_, ts_, vals_))
            elif m.any():
                kept.append((pids_[m], ts_[m], vals_[m]))
        self._pending_chunks[group] = kept + self._pending_chunks[group]

    def flush_all_groups(self) -> None:
        for g in range(self.config.groups_per_shard):
            self.flush_group(g)

    # -- recovery (ref: TimeSeriesShard.recoverIndex :483 +
    #    TimeSeriesMemStore.recoverStream :148) -----------------------------

    def recover(self, bus=None, schemas: Schemas | None = None,
                on_chunks_loaded=None, accept=None) -> int:
        """Restore the shard from the sink and replay the bus from the
        minimum checkpointed offset. Returns rows replayed.
        ``accept(container)`` filters replayed containers when several
        shards share one bus. ``on_chunks_loaded()`` runs between the chunk
        load and the replay."""
        assert self.sink is not None and len(self.index) == 0
        # queries admitted mid-recovery see a partial shard: the serving
        # layer must not cache an empty selection seen now
        self.recovering = True
        try:
            return self._recover_inner(bus, schemas, on_chunks_loaded, accept)
        finally:
            self.recovering = False

    def _recover_inner(self, bus, schemas, on_chunks_loaded, accept) -> int:
        if self.store is None and (self.schema.is_histogram
                                   or self.schema.is_multi_column):
            meta = self.sink.read_meta(self.dataset, self.shard_num) \
                if hasattr(self.sink, "read_meta") else {}
            # create early only when the bucket count is knowable: a
            # histogram schema without persisted les must stay None so the
            # replay creates it with its first container's bucket scheme
            if meta.get("bucket_les") or not self.schema.is_histogram:
                with self.lock:
                    self.bucket_les = (np.asarray(meta["bucket_les"])
                                       if meta.get("bucket_les") else None)
                    self.store = self._make_store()
                    self.store.owner_lock = self.lock
        # 1. part keys -> index (last entry per pid wins: a purged slot may
        #    have been re-persisted under a new series). index.log's
        #    columnar frames are the fast path, partkeys.log the fallback
        t0_index = time.perf_counter()
        # pid -> (labels | None, label blob | None, start)
        latest: dict[int, tuple[dict | None, bytes | None, int]] = {}
        last_live: dict[int, tuple[dict | None, bytes | None]] = {}
        frames_reader = getattr(self.sink, "read_index_frames", None)
        used_frames = False
        if frames_reader is not None and self.index_bucket_ms:
            try:
                frames = list(frames_reader(self.dataset,
                                            self.shard_num) or ())
                # trust window: from the LAST genesis snapshot on, and only
                # when no RETIRE marker (a persistence-off recovery)
                # supersedes it
                gen_at = retire_at = -1
                for fi, fr in enumerate(frames):
                    if fr[0] == INDEX_GENESIS_BUCKET:
                        gen_at = fi
                    elif fr[0] == INDEX_RETIRE_BUCKET:
                        retire_at = fi
                trusted = gen_at >= 0 and gen_at > retire_at
                for fr in (frames[gen_at:] if trusted else ()):
                    _bucket, fpids, fstarts, fblobs, fflags = fr
                    if len(fflags) \
                            and (fflags & INDEX_FLAG_UNPARSEABLE).any():
                        trusted = False     # placeholder entries
                        break
                    for pid, start, blob in zip(fpids.tolist(),
                                                fstarts.tolist(), fblobs):
                        latest[pid] = (None, blob, start)
                        if blob:
                            last_live[pid] = (None, blob)
                if trusted and latest:
                    used_frames = True
                    self._index_log_seeded = True
                else:
                    latest.clear()
                    last_live.clear()
            except Exception:
                log.warning("index.log recovery failed; rebuilding from "
                            "partkeys.log", exc_info=True)
                latest.clear()
                last_live.clear()
        if not used_frames:
            for pid, labels, start in self.sink.read_part_keys(
                    self.dataset, self.shard_num) or ():
                latest[pid] = (labels, None, start)
                if labels:
                    last_live[pid] = (labels, None)
        opts = self.schema.options

        def _pk_and_labels(labels, blob):
            if labels is None:
                labels = labels_from_blob(blob)
            if blob and not opts.ignore_shard_key_tags:
                return blob, labels      # the full-label blob is the key
            return part_key_of(labels, opts), labels

        # queries are admitted while recovery streams in: index and store
        # mutations take the shard lock as ingest does
        with self.lock:
            recovered_keys: list[tuple[int, bytes]] = []
            items = [(pid,) + latest[pid] for pid in sorted(latest)]
            # bulk-loadable only when the blob is the canonical key
            can_bulk = used_frames and not opts.ignore_shard_key_tags
            i = 0
            while i < len(items):
                pid, labels, blob, start = items[i]
                while len(self.index) < pid:   # gap: entry lost; free hole
                    hole = len(self.index)
                    self.index.add_part_key(hole, {}, 0, end_time=-1)
                    self._free_pids.append(hole)
                if not labels and not blob:    # tombstone won: slot is free
                    self.index.add_part_key(pid, {}, 0, end_time=-1)
                    self._free_pids.append(pid)
                    prev = last_live.get(pid)
                    if prev is not None:       # returning-series detection
                        self._evicted_keys.add(_pk_and_labels(*prev)[0])
                    i += 1
                    continue
                # a dense live run -> ONE columnar bulk add
                j = i
                while (can_bulk and j < len(items) and items[j][2]
                       and items[j][0] == pid + (j - i)):
                    j += 1
                if j - i >= RECOVER_BULK_MIN and \
                        len({items[k][2] for k in range(i, j)}) == j - i and \
                        self.index.add_part_keys_bulk(
                            np.arange(pid, pid + (j - i)),
                            [items[k][2] for k in range(i, j)], 0,
                            start_times=np.asarray(
                                [items[k][3] for k in range(i, j)],
                                np.int64)):
                    if self.governor is not None:
                        # one adopt per distinct tenant
                        tenants: dict[str, int] = {}
                        for k in range(i, j):
                            t = self.governor.tenant_from_key_bytes(
                                items[k][2])
                            tenants[t] = tenants.get(t, 0) + 1
                        for t, cnt in tenants.items():
                            self.governor.adopt(t, cnt)
                    for k in range(i, j):
                        rpid, _rl, rblob, _rs = items[k]
                        self._part_key_to_id[rblob] = rpid
                        self._part_key_of_id[rpid] = rblob
                        recovered_keys.append((rpid, rblob))
                    i = j
                    continue
                pk, labels = _pk_and_labels(labels, blob)
                self._part_key_to_id[pk] = pid
                self._part_key_of_id[pid] = pk
                recovered_keys.append((pid, pk))
                self.index.add_part_key(pid, labels, start)
                if self.governor is not None:
                    self.governor.adopt(self.governor.tenant_of(labels))
                i += 1
            if self._native_ps is not None and recovered_keys:
                # one batch hash + one batch insert
                from .native import fnv1a64_batch
                hashes = fnv1a64_batch([pk for _pid, pk in recovered_keys])
                self._native_ps.insert_batch(
                    [(int(h), pk, pid)
                     for (pid, pk), h in zip(recovered_keys, hashes)])
                for (pid, _pk), h in zip(recovered_keys, hashes):
                    self._pid_hash[pid] = h
        registry.gauge(FILODB_INDEX_RECOVER_MS,
                       {"dataset": self.dataset,
                        "shard": str(self.shard_num)}) \
            .update((time.perf_counter() - t0_index) * 1000.0)
        if hasattr(self.sink, "write_index_bucket"):
            # re-anchor the index log's trust: a fallback rebuild appends a
            # fresh GENESIS, a persistence-off recovery a RETIRE marker.
            # Best-effort: a failed write defers seeding to the next drain
            try:
                if self.index_bucket_ms and not used_frames:
                    self._write_index_genesis()
                elif not self.index_bucket_ms:
                    self.sink.write_index_bucket(
                        self.dataset, self.shard_num,
                        encode_index_bucket(INDEX_RETIRE_BUCKET, []))
            except Exception:
                log.warning("index.log trust re-anchor failed; the next "
                            "drain or recovery retries", exc_info=True)
        # 2. chunks -> device store: batched appends, one a frame, in flush
        #    (= time) order. Chunks of purged partitions are skipped; on a
        #    reused slot, samples older than the owner's start belong to
        #    the released predecessor
        own_start = {pid: start
                     for pid, (labels, blob, start) in latest.items()
                     if labels or blob}
        start_of = np.full(len(self.index) + 1, 1 << 62, np.int64)
        for pid, start in own_start.items():
            start_of[pid] = start
        for _group, records in self.sink.read_chunksets(
                self.dataset, self.shard_num) or ():
            keep = [r for r in records if r.part_id in own_start]
            if not keep:
                continue
            pids = np.concatenate([np.full(len(r.ts), r.part_id, np.int32)
                                   for r in keep])
            ts = np.concatenate([r.ts for r in keep])
            vals = np.concatenate([r.values for r in keep])
            owned = ts >= start_of[pids]
            if not owned.all():
                pids, ts, vals = pids[owned], ts[owned], vals[owned]
            if len(pids):
                with self.lock:
                    self.store.append(pids, ts, vals)
                    # loaded chunks change query-visible data as a flush
                    # does: the epoch-validated caches must see the bump
                    self._bump_epoch_locked(int(ts.min()))
                    lead = int(ts.max())
                    if lead > self.lead_ms:
                        self.lead_ms = lead
                    if lead > self.visible_lead_ms:
                        self.visible_lead_ms = lead   # loaded = visible
        # between chunk load and replay: replayed rows flow through the
        # normal flush pipeline, so state seeded here (the streaming
        # downsampler's open buckets) sees each sample exactly once
        if on_chunks_loaded is not None:
            on_chunks_loaded()
        # 3. checkpoints -> watermarks; replay the bus past them
        cps = self.sink.read_checkpoints(self.dataset, self.shard_num)
        with self.lock:
            for g, off in cps.items():
                self.group_watermarks[g] = off
                self._pending_group_offset[g] = off
        replayed = 0
        if bus is not None:
            wm = self.group_watermarks.copy()
            start_off = int(wm[wm >= 0].min()) if (wm >= 0).any() else 0
            next_off = start_off
            for off, container in bus.consume(schemas or Schemas(), start_off):
                next_off = off + 1
                if accept is not None and not accept(container):
                    continue
                before = self.stats.rows_ingested
                self.ingest(container, off, recovery_watermarks=wm)
                replayed += self.stats.rows_ingested - before
            self.flush()
            # the exact offset replay reached: a live consumer resumes here
            self.recovered_through = next_off
        return replayed

    # -- retention (ref: TimeSeriesShard.purgeExpiredPartitions :751) -------

    def purge_expired_partitions(self, cutoff_ms: int) -> int:
        """Remove partitions whose last sample is older than ``cutoff_ms``:
        index entries tombstoned, device rows freed for reuse, part keys
        recorded in the evicted-keys filter. Returns partitions purged."""
        self.flush()
        if self.store is None:
            return 0
        with self.lock:
            # mark end times of inactive series (the host last_ts mirror is
            # authoritative)
            last = self.store.last_ts
            inactive = np.nonzero((self.store.n_host > 0)
                                  & (last < cutoff_ms))[0]
            ended = {pid: int(last[pid]) for pid in inactive.tolist()
                     if self.index.is_live(pid)}
            if ended:
                # the marks alone are query-visible (a series ended at T
                # drops out of selections past T even when the purge below
                # is vetoed): bump first, with the earliest mark
                self._bump_epoch_locked(min(ended.values()))
                for pid, end_ts in ended.items():
                    self.index.update_end_time(pid, end_ts)
            purged = self.index.part_ids_ended_before(cutoff_ms)
            # never purge series with data pending a group flush, nor pids
            # of a snapshot being written
            if len(purged) and self.sink is not None:
                staged = [pids for chunks in self._pending_chunks
                          for (pids, _, _) in chunks]
                staged.extend(self._inflight_flush.values())
                if staged:
                    pending = np.unique(np.concatenate(staged))
                    purged = np.setdiff1d(purged, pending).astype(np.int32)
            if len(purged) == 0:
                return 0
            self._release_partitions_locked(purged)
            self.stats.partitions_purged += len(purged)
        self._flush_partkey_log()   # the durable write runs off the shard lock
        return len(purged)

    def age_out_durable(self, cutoff_ms: int) -> int:
        """Durable raw retention: drop sink samples older than
        ``cutoff_ms`` and bump ``data_epoch`` so cached results over the
        range invalidate. The read-decode-rewrite half runs with no lock
        held; only the commit (splicing the tail appended since the
        snapshot, then an atomic rename) runs under every group flush lock,
        so it never loses a concurrent append. Sinks without the split keep
        the single call under the locks."""
        sink = self.sink
        if sink is None or not hasattr(sink, "age_out"):
            return 0
        prepare = getattr(sink, "age_out_prepare", None)
        if prepare is not None:
            token = prepare(self.dataset, self.shard_num, cutoff_ms)
            if token is None:
                return 0
            with contextlib.ExitStack() as stack:
                for lk in self._group_flush_locks:   # ascending: in order
                    stack.enter_context(lk)
                dropped = int(sink.age_out_commit(token))
        else:
            with contextlib.ExitStack() as stack:
                for lk in self._group_flush_locks:
                    stack.enter_context(lk)
                dropped = int(sink.age_out(self.dataset, self.shard_num,
                                           cutoff_ms))
        if dropped:
            with self.lock:
                # rows aged out (destructive)
                self._bump_epoch_locked(EPOCH_AFFECTS_ALL)
            registry.counter(FILODB_RETENTION_AGED_OUT_ROWS,
                             {"dataset": self.dataset,
                              "shard": str(self.shard_num)}).increment(dropped)
        return dropped

    # -- on-demand paging (ref: OnDemandPagingShard.scala:26,58 +
    #    DemandPagedChunkStore.scala:35: cold chunks paged in for queries) ---

    def needs_paging(self, pids: np.ndarray, start_ms: int) -> bool:
        """True when the query needs data older than what is resident for
        any selected series and a durable sink exists to page from."""
        if self.sink is None or len(pids) == 0 or self.store is None:
            return False
        first = self.store.first_ts[pids]
        return bool((first[first >= 0] > start_ms).any())

    def read_cold_for(self, pids: np.ndarray, start_ms: int, end_ms: int):
        """Sink-side cold chunks for the given pids: pid -> ([ts...],
        [vals...]). Needs no shard lock (the sink logs are append-only and
        torn-tolerant), so wide paged scans never stall ingest on disk."""
        cold_ts: dict[int, list] = {int(p): [] for p in pids}
        cold_val: dict[int, list] = {int(p): [] for p in pids}
        reader = getattr(self.sink, "read_chunksets", None)
        if reader is not None:
            tier = ("remote" if getattr(self.sink, "remote_tier", False)
                    else "local")
            rows = 0
            with span(SPAN_ODP_DURABLE, shard=self.shard_num,
                      tier=tier) as tags:
                for _g, records in reader(self.dataset, self.shard_num,
                                          start_ms, end_ms) or ():
                    for r in records:
                        if r.part_id in cold_ts:
                            cold_ts[r.part_id].append(r.ts)
                            cold_val[r.part_id].append(np.asarray(r.values))
                            rows += len(r.ts)
                tags["rows"] = rows
            if rows:
                registry.counter(FILODB_RETENTION_ODP_ROWS,
                                 {"dataset": self.dataset,
                                  "tier": tier}).increment(rows)
        return cold_ts, cold_val

    def gather_resident_locked(self, pids: np.ndarray, column=None):
        """The resident half of a paged read, under the shard lock: the
        selected rows' (ts, values) gathered on the store's device into one
        [2, P, C] i64 tensor (values widened to f64 and bit-viewed, so the
        host copy is one transfer), with the rows' sample counts and their
        owners' start times. A compressed-resident store decodes only the
        selected rows. The gather is a copy, ordered on the stream before
        any later in-place write, so its host copy waits until the lock is
        released (``merge_paged``)."""
        assert_owned(self.lock, "gather_resident_locked")
        tsrc, vsrc, _n = self.store.arrays(column)
        rid = torch.from_numpy(np.asarray(pids, np.int64)).to(self.device)
        ts_rows = (tsrc.gather_rows(rid) if isinstance(tsrc, _Deferred)
                   else tsrc.index_select(0, rid))
        val_rows = (vsrc.gather_rows(rid) if isinstance(vsrc, _Deferred)
                    else vsrc.index_select(0, rid))
        packed = torch.stack([ts_rows.long(),
                              val_rows.double().view(torch.int64)])
        pids = np.asarray(pids)
        own_start = np.asarray([self.index.start_time(int(p)) for p in pids],
                               np.int64)
        return packed, self.store.n_host[pids].copy(), own_start

    def merge_paged(self, pids: np.ndarray, gathered, cold, column=None):
        """Merged (ts [P, C'], val [P, C'], n [P]) host arrays from a
        ``gather_resident_locked`` result and ``read_cold_for``'s cold
        chunks, deduped on each series' resident first timestamp. Call
        without the shard lock: the one host copy of the batch runs
        here."""
        packed, n_host, own_starts = gathered
        host = packed.cpu().numpy()
        ts_host, val_host = host[0], host[1].view(np.float64)
        cold_ts, cold_val = cold
        col_off = None
        if self.schema.is_multi_column:
            nb = len(self.bucket_les) if self.bucket_les is not None else 0
            name = column or self.store.default_col
            for nm, off, w, _ih in self.schema.col_layout(nb):
                if nm == name:
                    assert w == 1, "histogram columns do not page on demand"
                    col_off = off
                    break
        rows_ts, rows_val = [], []
        for i, p in enumerate(pids):
            p = int(p)
            cnt = int(n_host[i])
            hot_t = ts_host[i, :cnt]
            hot_v = val_host[i, :cnt]
            boundary = hot_t[0] if len(hot_t) else (1 << 62)
            if cold_ts[p]:
                ct = np.concatenate(cold_ts[p])
                cv = np.concatenate(cold_val[p])
                if col_off is not None and cv.ndim == 2:
                    cv = cv[:, col_off]
                # the recovery's slot-reuse rule: sink chunks older than the
                # current owner's start belong to a released predecessor
                sel = (ct < boundary) & (ct >= own_starts[i])
                order = np.argsort(ct[sel], kind="stable")
                st, sv = ct[sel][order], cv[sel][order]
                if len(st):
                    # keep-first timestamp dedup: a requeued flush can leave
                    # duplicate frames in the log (recovery dedups through
                    # the store's out-of-order drop; paged reads match it)
                    keep = np.concatenate([[True], np.diff(st) > 0])
                    st, sv = st[keep], sv[keep]
                rows_ts.append(np.concatenate([st, hot_t]))
                rows_val.append(np.concatenate([sv, hot_v]))
            else:
                rows_ts.append(hot_t)
                rows_val.append(hot_v)
        C = max((len(t) for t in rows_ts), default=1)
        P = len(pids)
        ts_arr = np.full((P, C), TS_PAD, np.int64)
        val_arr = np.zeros((P, C), np.float64)
        n_arr = np.zeros(P, np.int32)
        for i, (t, v) in enumerate(zip(rows_ts, rows_val)):
            ts_arr[i, :len(t)] = t
            val_arr[i, :len(t)] = v
            n_arr[i] = len(t)
        return ts_arr, val_arr, n_arr

    def read_with_paging(self, pids: np.ndarray, start_ms: int, end_ms: int,
                         cold=None, column=None):
        """Merged (ts [P, C'], val [P, C'], n [P]) host arrays combining the
        paged cold chunks (from the sink) with the resident rows. ``cold``
        accepts a pre-fetched ``read_cold_for`` result; ``column`` selects
        one scalar column of a multi-column store."""
        if cold is None:
            cold = self.read_cold_for(pids, start_ms, end_ms)
        with self.lock:
            gathered = self.gather_resident_locked(pids, column)
        return self.merge_paged(pids, gathered, cold, column)

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
                              end: int, limit: int | None = None) -> np.ndarray:
        self.flush()
        with self.lock:
            return self.index.part_ids_from_filters(filters, start, end,
                                                    limit)

    def label_values(self, label: str, filters=None, top_k=None) -> list[str]:
        with self.lock:
            return self.index.label_values(label, filters, top_k=top_k)

    def label_value_counts(self, label: str, filters=None,
                           top_k=None) -> list[tuple[str, int]]:
        with self.lock:
            return self.index.label_value_counts(label, filters, top_k=top_k)

    def label_names(self, filters=None) -> list[str]:
        with self.lock:
            return self.index.label_names(filters)

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
              sink: ChunkSink | None = None,
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
                            sink=sink, eviction_policy=eviction_policy)
        self._shards[key] = s
        return s

    def shard(self, dataset: str, shard: int) -> TimeSeriesShard:
        return self._shards[(dataset, shard)]

    def shards_of(self, dataset: str) -> list[TimeSeriesShard]:
        return [s for (d, _), s in sorted(self._shards.items()) if d == dataset]

    def ingest(self, dataset: str, shard: int, container: RecordContainer,
               offset: int = -1) -> None:
        self._shards[(dataset, shard)].ingest(container, offset)

    def flush_all(self, dataset: str | None = None) -> None:
        for (d, _), s in self._shards.items():
            if dataset is None or d == dataset:
                s.flush()
