"""TimeSeriesMemStore: per-dataset shards wiring ingest -> part-key index -> device store.

Port of ``filodb_tpu/core/memstore.py`` for the main path (ref:
core/.../memstore/TimeSeriesMemStore.scala, TimeSeriesShard.scala ingest
:459/:1183 and flush :771). Partition lookup is one host probe per distinct
label set per container (the native part-key table, or a dict); ingest
stages host buffers and lands them on the device store in one batched
in-place scatter per flush; eviction frees rows for reuse under slot
pressure.

Histogram schemas (prom-histogram: sum, count and the ``h`` bucket column)
create their store lazily — the bucket scheme arrives with the first
container. Under ``compressed_residency`` "gauge" a flush compresses a
scalar single-column store to its narrowest exact decode variant (delta8,
quant16 or delta16); under "all" also the [S, C, B] bucket block of a
histogram store, to i8/i16 2D-delta form. Compression runs in two phases:
the build outside the shard lock, the swap under it only if the store did
not mutate meanwhile.

Every change to what a query can see bumps the shard's ``data_epoch``
under the shard lock and logs the minimum data timestamp it can have
affected (``EPOCH_SPEC`` names the sites): the engine's result, negative
and fragment caches key on these epochs. A per-tenant cardinality governor
(``core/cardinality.py``), when attached, sheds new series at its quota.
The metadata API (label values and names) reads the part-key index.

The port's shards carry no durable sink yet, and no ingest offsets or group
watermarks with it. Recovery, purge, on-demand paging and inline
downsampling arrive with later slices. Under ``narrow_mirror`` a raw store
keeps a quant16 copy beside its f32 block, rebuilt at flush outside the
shard lock.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np

from ..device import resolve_device
from ..utils.diagnostics import TimedRLock, assert_owned
from ..utils.metrics import FILODB_STORE_RESIDENCY_FALLBACK, registry
from .chunkstore import SeriesStore
from .eviction import BloomFilter, CapacityEvictionPolicy, EvictionPolicy
from .filters import Filter
from .partkey_index import PartKeyIndex
from .record import RecordContainer
from .schemas import Schema, Schemas

# epoch-log sentinel: this visibility bump may have affected data at ANY
# timestamp (destructive mutations: partition release, retention
# compaction). Fragments validated against a log holding it invalidate
# whole (query/incremental.py stable_before).
EPOCH_AFFECTS_ALL = -(1 << 62)

# The declared visibility surface, a pure literal as in the reference
# (whose static checker reads it from the AST): every function where
# query-visible store state changes, with the affected-timestamp class its
# bump records:
#   "batch_min_ts"      — the bump logs the minimum data timestamp the
#                         mutation touched (staged flush); per-step
#                         fragment validity survives for steps before it
#   "EPOCH_AFFECTS_ALL" — destructive: rows at arbitrary timestamps
#                         vanished (release/eviction, retention
#                         compaction); caches invalidate whole
#   "admit"             — series admission only: a partition with no
#                         visible sample changes no answer, so no bump
#                         until the first staged flush lands its data
# The reference's purge, durable age-out and recovery sites arrive with
# their functions (the port's persistence slice). Mutations that change no
# answer bump nothing: ``discard_staged`` drops rows no query saw,
# ``compress_commit`` swaps a store for its bit-exact narrow form, and a
# ``NarrowMirror`` refresh rebuilds a copy queries only consult.
EPOCH_SPEC = {
    "class": "TimeSeriesShard",
    "bump": "_bump_epoch_locked",
    "lock": "lock",
    "visible_calls": {
        "store": ("append", "compact", "free_rows"),
        "index": ("remove_part_keys",),
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
        "compaction": {
            "fn": "TimeSeriesShard.flush",
            "affects": "EPOCH_AFFECTS_ALL"},
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
    partitions_evicted: int = 0
    evicted_part_key_reingests: int = 0
    series_quota_shed: int = 0


class TimeSeriesShard:
    """All state for one shard of one dataset."""

    BULK_CREATE_MIN = 512      # below this, per-key creation wins

    def __init__(self, dataset: str, schema: Schema, shard_num: int,
                 config: StoreConfig, device=None,
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
        # True while a recovery rebuilds the shard (the persistence slice
        # sets it): an empty selection seen meanwhile is no proof of
        # emptiness, so the negative cache does not record it
        self.recovering = False
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

    def ingest(self, container: RecordContainer) -> None:
        """Ingest one container: resolve its label sets to part ids and
        stage its samples; a full staging buffer flushes to the device."""
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
        if len(pids) and pids.min() < 0:
            # quota-shed births (SHED_PID): drop exactly their samples
            keep = pids >= 0
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
        self._staged += len(ts)
        self.stats.rows_ingested += len(ts)

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

    def needs_paging(self, pids: np.ndarray, start_ms: int) -> bool:
        """True when a read needs samples older than the resident rows and a
        durable sink holds them. The port's shards have no sink until the
        persistence slice (ROADMAP queue 1 item 6): nothing pages."""
        return False

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
