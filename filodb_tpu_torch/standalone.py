"""Standalone server: config -> cluster -> shards -> ingestion -> HTTP.

Reference: standalone/.../FiloServer.scala:15-38 (bootstraps the cluster, creates
datasets from config, starts HTTP) + coordinator/.../IngestionActor.scala:57
(per-shard ingestion lifecycle: resync on shard assignment, recovery from
checkpoints, then live consumption with status events).

Port of ``filodb_tpu/standalone.py``. Host Python as in the reference, but
for where it touches a device:

- ``FiloServer(config, device=...)`` takes the server's device under the
  port's device policy (``device.py``): ``cuda`` by default, raising
  without a card unless the caller asks for ``cpu``.
- The mesh is built only when the server was asked for ``cuda`` with no
  card index, there is more than one card, this node owns every shard and
  the shards divide evenly over the cards (the reference's condition).
  Then shard ``i`` lives on card ``i mod torch.cuda.device_count()``, as
  ``make_mesh`` places it. Otherwise every shard lives on the server's
  device (an explicit ``cuda:k`` keeps them all on card ``k``) and the
  engine gets ``mesh=None`` by decision, serving through the host loop
  (one K1 launch per shard leaf). Placement and mesh are one decision
  (:func:`mesh_cards`); nothing is decided by catching an error.
- Each ``IngestionConsumer`` runs under ``torch.cuda.device`` of its shard,
  so the tensors its ingest makes land there (a new thread's current
  device is card 0). ``_DecodeAhead`` stays host-only.
- ``shutdown()`` joins every thread that launches work on the card before
  it returns, so no launch runs during interpreter teardown.
- The reference's XLA program machinery (fused-mode switch, mesh program
  mode and donation, plan cache, warm-up) has no port (ROADMAP ground
  rules); ``query.fused_kernels`` is validated (``config.
  fused_kernels_mode``).
- Not yet ported, and refused rather than ignored: the remote-write writer
  (the HTTP server takes no writers until ``promql/remote.py`` lands) and
  ``rules.groups`` (the rules subsystem, next slice).
"""

from __future__ import annotations

import itertools
import logging
import queue
import threading
import time

import torch

from .config import Config, fused_kernels_mode, parse_duration_ms
from .core.memstore import TimeSeriesMemStore
from .core.store import FileColumnStore
from .device import resolve_device
from .http.api import FiloHttpServer
from .ingest.bus import FileBus
from .parallel.cluster import ShardManager, ShardStatus
from .parallel.shardmapper import ShardMapper
from .query.engine import QueryEngine
from .query.rangevector import QueryError
from .utils.metrics import (FILODB_INGEST_DECODE_ERRORS,
                            FILODB_INGESTED_ROWS, ShardHealthStats, registry)
from .utils.tracing import SPAN_INGEST_CONSUME, span, tracer

log = logging.getLogger("filodb_tpu_torch.server")


class _DecodeAhead:
    """Double-buffered container decode: a daemon thread pulls (offset,
    container) pairs from the bus iterator into a bounded queue, so the
    host-side decode (network read + ``RecordContainer.from_bytes``) of batch
    N+1 overlaps the shard's device scatter of batch N. Offsets are committed
    by the CONSUMER after ingest exactly as before — decoded-but-undelivered
    containers are simply re-fetched after a fault, so checkpoint/durability
    semantics are unchanged."""

    _END = object()

    def __init__(self, it, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, int(depth)))
        self._err: BaseException | None = None
        self._closed = False
        self._thread = threading.Thread(target=self._fill, args=(it,),
                                        daemon=True, name="ingest-decode")
        self._thread.start()

    def _fill(self, it) -> None:
        try:
            for item in it:
                while not self._closed:
                    try:
                        self._q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
                if self._closed:
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised on the consumer
            # fail LOUD: the consumer re-raises on its next __next__, and the
            # counter makes a recurring decode fault visible even when the
            # consumer's retry loop keeps absorbing it
            self._err = e
            registry.counter(FILODB_INGEST_DECODE_ERRORS).increment()
        while not self._closed:
            try:
                self._q.put(self._END, timeout=0.5)
                return
            except queue.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self):
        # timed get + liveness check: _fill guarantees the _END sentinel on
        # every normal exit path, but a fill thread killed uncleanly (or a
        # bug there) must not park this consumer forever on a bare get
        # (filolint: live-wait-no-timeout)
        while True:
            try:
                item = self._q.get(timeout=1.0)
            except queue.Empty:
                if not self._thread.is_alive():
                    if self._err is not None:
                        raise self._err
                    raise StopIteration
                continue
            if item is self._END:
                if self._err is not None:
                    raise self._err
                raise StopIteration
            return item

    def close(self) -> None:
        """Unblock and retire the fill thread after an early exit."""
        self._closed = True
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass


class IngestionConsumer(threading.Thread):
    """Per-shard bus consumer (ref: IngestionActor drives memStore.ingestStream /
    recoverStream with RecoveryInProgress -> IngestionStarted events)."""

    def __init__(self, shard, bus: FileBus, schemas, manager: ShardManager,
                 dataset: str, poll_s: float = 0.5, purge_interval_s: float = 600.0,
                 decode_ahead: int = 2, accept=None):
        super().__init__(daemon=True, name=f"ingest-{dataset}-{shard.shard_num}")
        self.shard = shard
        self.bus = bus
        self.schemas = schemas
        self.manager = manager
        self.dataset = dataset
        self.poll_s = poll_s
        self.purge_interval_s = purge_interval_s
        self.decode_ahead = decode_ahead
        # shared-partition demux: with fewer broker partitions than shards
        # several shards replay one partition; ``accept(container)`` keeps
        # only this shard's containers (offsets still advance past skips)
        self.accept = accept
        self._stop_ev = threading.Event()
        self._offset = 0

    def _seed_downsampler(self, sh) -> None:
        """Resume the streaming downsampler after recovery: the durable
        publish floor comes from the fine family's meta, and buckets left
        open across the restart rebuild from the recovered store (replay
        alone would re-emit them with only post-watermark samples)."""
        if sh.downsample is None:
            return
        target = sh.downsample[1]
        if not hasattr(target, "seed_from_store"):
            return
        pub = target.publish
        floor = -1
        sink = getattr(pub, "sink", None)
        fam = getattr(pub, "family", None)
        if sink is not None and fam and hasattr(sink, "read_meta"):
            floor = int(sink.read_meta(fam, sh.shard_num)
                        .get("published_through", -1))
        target.floor_ms = floor
        if floor >= 0 and hasattr(pub, "published_max"):
            pub.published_max[sh.shard_num] = floor
        target.seed_from_store(sh)

    def run(self):
        # a new thread's current CUDA device is card 0: every tensor this
        # consumer's ingest, flush and recovery make must land on the
        # shard's card
        dev = self.shard.device
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                self._run()
        else:
            self._run()

    def _run(self):
        sh = self.shard
        try:
            # recovery prelude retries transient bus outages too — a broker
            # restarting while we start must not permanently kill the shard
            backoff = 0.0
            while True:
                try:
                    if sh.sink is not None:
                        self.manager.set_status(self.dataset, sh.shard_num,
                                                ShardStatus.RECOVERY)
                        sh.recover(self.bus, self.schemas,
                                   on_chunks_loaded=lambda: self._seed_downsampler(sh),
                                   accept=self.accept)
                        # resume at the offset replay actually reached —
                        # reading end_offset here instead would skip frames
                        # published between the replay's end snapshot and
                        # this line (a real gap on a shard adopted under
                        # live publish load)
                        self._offset = int(getattr(sh, "recovered_through",
                                                   self.bus.end_offset))
                    break
                except (ConnectionError, OSError):
                    backoff = min(max(1.0, backoff * 2), 30.0)
                    log.warning("bus unavailable for shard %s recovery; "
                                "retrying in %.0fs", sh.shard_num, backoff)
                    self.manager.set_status(self.dataset, sh.shard_num,
                                            ShardStatus.ERROR)
                    if self._stop_ev.wait(backoff):
                        return
            self.manager.set_status(self.dataset, sh.shard_num, ShardStatus.ACTIVE)
            rows = registry.counter(FILODB_INGESTED_ROWS,
                                    {"dataset": self.dataset, "shard": str(sh.shard_num)})
            last_purge = time.monotonic()
            backoff = 0.0
            while not self._stop_ev.wait(backoff or self.poll_s):
                # transient bus outages (e.g. a broker restart) must not kill
                # the shard: back off and retry, ERROR only while disconnected
                # (ref: IngestionError events -> resync, not actor death).
                # Only network faults count as transient — a broker-reported
                # error (RuntimeError, e.g. bad partition) or an ingest fault
                # is permanent and fails the shard loudly via the outer handler
                try:
                    src = self.bus.consume(self.schemas, self._offset)
                    # peek before spinning up the decode thread: an idle
                    # poll (the common case) must not create a thread
                    first = next(src, None)
                    if first is not None:
                        if self.decode_ahead:
                            src = _DecodeAhead(src, self.decode_ahead)
                        # one span per consumer DRAIN (not per container):
                        # the scatter leg of the ingest path, tagged with
                        # how much it moved
                        n_rows = 0
                        try:
                            with span(SPAN_INGEST_CONSUME,
                                      dataset=self.dataset,
                                      shard=sh.shard_num) as tags:
                                for off, container in itertools.chain(
                                        [first], src):
                                    if self.accept is None or \
                                            self.accept(container):
                                        sh.ingest(container, off)
                                        rows.increment(len(container))
                                        n_rows += len(container)
                                    self._offset = off + 1
                                tags["rows"] = n_rows
                        finally:
                            if isinstance(src, _DecodeAhead):
                                src.close()
                except (ConnectionError, OSError):
                    backoff = min(max(1.0, backoff * 2), 30.0)
                    log.warning("bus unavailable for shard %s; retrying in %.0fs",
                                sh.shard_num, backoff)
                    self.manager.set_status(self.dataset, sh.shard_num,
                                            ShardStatus.ERROR)
                    continue
                if backoff:
                    backoff = 0.0
                    self.manager.set_status(self.dataset, sh.shard_num,
                                            ShardStatus.ACTIVE)
                sh.flush()
                if sh.sink is not None:
                    sh.flush_all_groups()
                if time.monotonic() - last_purge >= self.purge_interval_s:
                    last_purge = time.monotonic()
                    lead = int(sh.store.last_ts.max(initial=0)) if sh.store is not None else 0
                    if lead > 0:
                        n = sh.purge_expired_partitions(lead - sh.config.retention_ms)
                        if n:
                            log.info("purged %d expired partitions from shard %d",
                                     n, sh.shard_num)
        except Exception:  # noqa: BLE001
            log.exception("ingestion failed for shard %s", sh.shard_num)
            self.manager.set_status(self.dataset, sh.shard_num, ShardStatus.ERROR)

    def stop(self):
        self._stop_ev.set()


class FiloServer:
    """One FiloDB node: its config, its shards and their bus consumers, the
    query engine and the HTTP API, and optionally the gateway and the
    elastic-cluster plane. ``device`` is where the shards live (``cuda``
    when None; raises without a card unless ``"cpu"`` is asked for)."""

    def __init__(self, config: Config | None = None, node_name: str = "local",
                 device=None):
        self.config = config or Config()
        self.node = node_name
        # an explicit card index pins every shard to that card (no mesh)
        self._pinned = (device is not None
                        and torch.device(device).index is not None)
        self.device = resolve_device(device)
        self._mesh_cards = 0            # > 1 once start() builds the mesh
        self.memstore = TimeSeriesMemStore(device=self.device)
        self.manager = ShardManager()
        self.manager.add_node(node_name)
        self.consumers: list[IngestionConsumer] = []
        self.http: FiloHttpServer | None = None
        self.gateway = None
        self._gw_buses: dict[int, object] = {}
        self._gw_flush_stop: threading.Event | None = None
        self.scheduler = None
        self.engines: dict[str, QueryEngine] = {}
        self.profiler = None
        self.membership = None
        self.gossip = None              # cluster/membership.py GossipAgent
        self.failures = None            # buddy-routing FailureProvider
        self._fence = None              # cluster/epoch.py StoreFence
        self.last_failover: dict = {}   # operator surface: the most recent
        # node-down / takeover / rebalance event on this node
        self._registrar = None
        self._running: set[int] = set()
        self._buses: dict[int, object] = {}
        self._quarantined = False
        # guards _running/_buses/consumers/_quarantined: mutated by the
        # membership-monitor thread (resync/quarantine) while HTTP writers
        # snapshot them and resync events start consumers
        self._shards_lock = threading.Lock()
        self._sink = None
        self._store_cfg = None
        self._ds_publish = None
        self._ds_res: list[int] = []
        self._cascade_stop = None
        self._cascade_wm: dict[int, int] = {}
        self._ds_serve_stop = None
        self._retention_stop = None
        self._endpoints: dict[str, str] = {}
        self._endpoints_at = 0.0
        self._zipkin = None
        # background loops that touch the shards' tensors (downsample
        # serving, cascade, age-out, the gateway bus flush): joined at
        # shutdown so no launch outlives the server
        self._threads: list[threading.Thread] = []

    def _start_shard(self, dataset: str, shard_num: int) -> None:
        """Bring up one owned shard: store + (optionally) its bus consumer
        (ref: IngestionActor.startIngestion per assigned shard)."""
        # claim the shard atomically: a resync event racing quarantine (or a
        # duplicate event) must not start a consumer that quarantine already
        # stopped — or never saw
        with self._shards_lock:
            if self._quarantined or shard_num in self._running:
                return
            self._running.add(shard_num)
        try:
            self._start_shard_claimed(dataset, shard_num)
        except Exception:
            # a failed start (disk error, broker refused) releases the claim
            # so a later resync can retry — a leaked claim would silently
            # no-op every retry and accept writes for a shard with no store
            with self._shards_lock:
                self._running.discard(shard_num)
            raise

    def _shard_device(self, shard_num: int) -> torch.device:
        """Placement: on the mesh (``self._mesh_cards`` > 1), shard ``i``
        lives on card ``i mod n`` (as ``make_mesh`` orders them); otherwise
        on the server's device."""
        n = self._mesh_cards
        if n > 1:
            return torch.device("cuda", shard_num % n)
        return self.device

    def _start_shard_claimed(self, dataset: str, shard_num: int) -> None:
        cfg = self.config
        try:
            shard = self.memstore.setup(dataset, cfg["schema"], shard_num,
                                        self._store_cfg, sink=self._sink,
                                        device=self._shard_device(shard_num))
        except ValueError:
            # a retried start after a partial failure: the store exists
            shard = self.memstore.shard(dataset, shard_num)
        # cardinality governance + durable index time buckets, wired BEFORE
        # the consumer starts (recovery adopts tenants and reads index.log)
        shard.governor = self._governor
        shard.index_bucket_ms = self._index_bucket_ms
        if self._fence is not None:
            # epoch-fence the store ring BEFORE the consumer starts: our
            # claim supersedes any deposed owner's, and its straggler
            # flushes now raise FencedWriteError instead of corrupting the
            # shard we are warming
            self._fence.claim(shard_num)
        if self._ds_publish is not None and not shard.schema.is_histogram:
            from .core.downsample import InlineDownsampler
            shard.downsample = (self._ds_res[0],
                                InlineDownsampler(self._ds_res[0],
                                                  self._ds_publish))
        if self._bus_addrs() or cfg.get("bus_dir"):
            accept = None
            if self._bus_addrs():
                # remote broker: shard N consumes partition N mod
                # ingest.partitions (ref: Kafka PartitionStrategy; the
                # default keeps 1 shard == 1 partition). With shared
                # partitions each consumer keeps only its own shard's
                # containers, re-deriving the shard from the container's
                # hashes (gateway containers are single-shard by build).
                from .ingest.broker import BrokerBus
                parts = self._num_partitions()
                bus = BrokerBus(self._bus_addrs(), shard_num % parts,
                                publish_window=cfg.get("ingest.publish_window",
                                                       64),
                                retry_backoff_ms=parse_duration_ms(
                                    cfg["ingest.retry_backoff"]),
                                max_retries=cfg["ingest.publish_retries"],
                                epoch_fencing=cfg["ingest.epoch_fencing"])
                if parts < len(self.manager.map[dataset]):
                    accept = self._shard_accept(shard_num)
            else:
                bus = FileBus(f"{cfg['bus_dir']}/shard{shard_num}.log")
            c = IngestionConsumer(shard, bus, self.memstore.schemas,
                                  self.manager, dataset,
                                  purge_interval_s=parse_duration_ms(
                                      cfg.get("store.purge_interval", "10m")) / 1000.0,
                                  decode_ahead=cfg.get("ingest.decode_ahead", 2),
                                  accept=accept)
            with self._shards_lock:
                if self._quarantined:       # raced quarantine: do not start
                    self._running.discard(shard_num)
                    return
                self._buses[shard_num] = bus
                self.consumers.append(c)
            c.start()
        else:
            self.manager.set_status(dataset, shard_num, ShardStatus.ACTIVE)

    def _bus_addrs(self) -> list[str]:
        """Broker replica addresses: ``bus_addrs`` (the replicated tier) or
        the single legacy ``bus_addr``."""
        cfg = self.config
        addrs = cfg.get("bus_addrs")
        if addrs:
            return list(addrs)
        return [cfg["bus_addr"]] if cfg.get("bus_addr") else []

    def _num_partitions(self) -> int:
        cfg = self.config
        return int(cfg.get("ingest.partitions")
                   or _pow2(cfg["num_shards"]))

    def _make_shard_buses(self, num_shards: int) -> dict[int, object]:
        """Per-shard PUBLISH buses over the configured ingest plane —
        BrokerBus against the replicated broker tier (shard s publishes to
        partition s mod partitions) or FileBus per shard; empty when
        neither is configured (callers then ingest directly). One
        construction shared by the gateway and rules publishers so their
        wiring can never drift."""
        cfg = self.config
        if self._bus_addrs():
            from .ingest.broker import BrokerBus
            parts = self._num_partitions()
            return {s: BrokerBus(self._bus_addrs(), s % parts,
                                 publish_window=cfg["ingest.publish_window"],
                                 retry_backoff_ms=parse_duration_ms(
                                     cfg["ingest.retry_backoff"]),
                                 max_retries=cfg["ingest.publish_retries"],
                                 epoch_fencing=cfg["ingest.epoch_fencing"])
                    for s in range(num_shards)}
        if cfg.get("bus_dir"):
            return {s: FileBus(f"{cfg['bus_dir']}/shard{s}.log")
                    for s in range(num_shards)}
        return {}

    def _shard_accept(self, shard_num: int):
        """Demux predicate for shared broker partitions: keep containers
        whose (single-shard, by gateway build) records route to this
        shard."""
        cfg = self.config
        mapper = ShardMapper(_pow2(cfg["num_shards"]), cfg["spread"])

        def accept(container, _s=shard_num, _m=mapper):
            if not len(container.ts):
                return False
            return _m.shard_of(int(container.shard_hash[0]),
                               int(container.part_hash[0])) == _s
        return accept

    def _resolve_endpoint(self, node: str) -> str | None:
        """HTTP endpoint of a peer node, from registrar heartbeats (each node
        publishes its own with MembershipMonitor.http_addr). A short TTL cache
        keeps per-query registrar reads off the query path."""
        if self._registrar is None or not hasattr(self._registrar, "endpoints"):
            return None
        now = time.monotonic()
        if now - self._endpoints_at > 1.0:
            try:
                self._endpoints = self._registrar.endpoints()
                self._endpoints_at = now
            except Exception:
                log.exception("registrar endpoint read failed")
        return self._endpoints.get(node)

    def _quarantine(self) -> None:
        """Our heartbeat lapsed past stale_after: peers have declared us dead
        and reassigned our shards, so continuing to consume would double-own
        them. Fail-stop ingestion; an operator restart rejoins cleanly
        (ref: Akka quarantine — a removed-but-alive node must restart)."""
        log.error("node %s quarantined (heartbeat lapsed); stopping ingestion — "
                  "restart to rejoin", self.node)
        with self._shards_lock:
            self._quarantined = True        # no further _start_shard succeeds
            consumers = list(self.consumers)
            stopped = sorted(self._running)
            self._running.clear()
            buses = list(self._buses.values())
            self._buses.clear()
        for c in consumers:
            c.stop()                # flag FIRST: a woken consumer exits
        for b in buses:
            try:
                b.close()           # unblocks any consumer mid-recv
            except OSError:
                log.warning("bus close failed during quarantine",
                            exc_info=True)
        for c in consumers:
            c.join(timeout=3)
        for b in buses:
            try:
                b.close()           # re-sever: a consumer that raced the
                                    # first close and reconnected is now
                                    # joined, so this one sticks
            except OSError:
                log.warning("bus close failed during quarantine",
                            exc_info=True)
        if self._fence is not None:
            # drop our store-ring claims: any straggler flush thread now
            # fences locally without even a durable read
            for s in stopped:
                self._fence.release(s)
        for ds in list(self.engines):
            if ds not in self.manager.map:
                continue       # downsample-family serving view, not a dataset
            for s in stopped:
                if self.manager.node_of(ds, s) == self.node:
                    self.manager.set_status(ds, s, ShardStatus.STOPPED)

    def _on_shard_event(self, ev) -> None:
        """Resync (ref: IngestionActor.resync on shard snapshots): an
        assignment targeting this node starts the shard's consumer."""
        if ev.kind == "AssignmentStarted" and ev.node == self.node \
                and ev.shard not in self._running:
            log.info("resync: starting reassigned shard %s", ev.shard)
            self._start_shard(ev.dataset, ev.shard)
            if self.membership is not None:
                # publish the takeover immediately: a node joining right now
                # must see the updated ownership claims
                self.membership.publish_now()

    # -- elastic cluster (membership, fencing, rebalance — cluster/) ---------

    def _peer_down(self, node: str) -> None:
        """A peer was declared dead (registrar staleness or gossip counted
        suspicion): reassign its shards and open a known-bad window so
        buddy routing covers the takeover gap."""
        if node not in self.manager.nodes:
            return                      # both detectors fired: already done
        self.manager.remove_node(node)
        if self.failures is not None:
            self.failures.open_window(f"node-{node}",
                                      int(time.time() * 1000))
        self.last_failover = {"event": "node-down", "node": node,
                              "at": time.time()}

    def _peer_up(self, node: str) -> None:
        self.manager.add_node(node)
        if self.failures is not None:
            self.failures.close_window(f"node-{node}",
                                       int(time.time() * 1000))

    def _ha_track(self, ev) -> None:
        """Failure-window bookkeeping for buddy routing: a shard this node
        is warming (takeover/rebalance) is known-bad until its consumer
        reaches ACTIVE, and a dead NODE's window seals once none of its
        shards remain orphaned — a permanently dead node must not steer
        every later query to the buddy forever."""
        if self.failures is None:
            return
        now_ms = int(time.time() * 1000)
        if ev.kind == "AssignmentStarted" and ev.node == self.node:
            self.failures.open_window(f"shard-{ev.dataset}-{ev.shard}",
                                      now_ms)
        elif ev.kind == "IngestionStarted" and ev.node == self.node:
            self.failures.close_window(f"shard-{ev.dataset}-{ev.shard}",
                                       now_ms)
            self._maybe_close_node_windows(now_ms)

    def _maybe_close_node_windows(self, now_ms: int) -> None:
        """Seal every open node-down window once no shard is orphaned
        (DOWN/UNASSIGNED) and this node has no shard still warming: from
        here the cluster serves complete data again, and the closed range
        keeps routing around the actual outage. Claims reconciliation
        calls this too, so non-adopting nodes converge as peers' takeovers
        publish."""
        if self.failures is None:
            return
        for shards in self.manager.map.values():
            for _s, (_n, st) in shards.items():
                if st in (ShardStatus.DOWN, ShardStatus.UNASSIGNED):
                    return
        for key in list(self.failures.open_windows()):
            if key.startswith("node-"):
                self.failures.close_window(key, now_ms)

    def _adopt_claims(self, peer: str, claims: dict) -> None:
        """Reconcile a peer's published shard claims into our map: after a
        rebalance cutover (or takeover we did not witness), every node
        converges on the new ownership without a restart. Shards we run
        live are never ceded here — losing one goes through quarantine."""
        for ds, shards in (claims or {}).items():
            if ds not in self.manager.map:
                continue
            for s in shards:
                s = int(s)
                if not 0 <= s < len(self.manager.map[ds]):
                    continue
                cur = self.manager.node_of(ds, s)
                if cur == peer:
                    continue
                with self._shards_lock:
                    mine = s in self._running
                if cur == self.node and mine:
                    continue
                self.manager.reassign(ds, s, peer)
        if self.failures is not None:
            # peers' published takeovers count toward sealing node-down
            # windows on nodes that adopted nothing themselves
            self._maybe_close_node_windows(int(time.time() * 1000))

    def _cluster_extra(self) -> dict:
        """The elasticity surface of GET /api/v1/cluster/status: gossip
        membership table, per-scope epochs, open known-bad windows, and
        the last failover/rebalance event on this node."""
        out: dict = {"node": self.node}
        if self.gossip is not None:
            out["membership"] = self.gossip.table.rows()
        if self._fence is not None:
            out["epochs"] = {"shards": {str(s): e for s, e
                                        in self._fence.owned().items()}}
        if self.failures is not None:
            out["known_bad_windows"] = self.failures.open_windows()
        if self.last_failover:
            out["last_failover"] = self.last_failover
        return out

    def rebalance_shard(self, dataset: str, shard: int, to_node: str) -> dict:
        """Operator-triggered live shard move (flush→handoff→catch-up→
        cutover). This node must own the shard; ``to_node`` warms it from
        the durable ring + broker replay and takes over ingest. The move
        is epoch-fenced: the adopter's store-ring claim supersedes ours
        before its consumer starts, so exactly one owner ever ingests."""
        import urllib.request

        from .utils.metrics import FILODB_CLUSTER_REBALANCES
        from .utils.tracing import SPAN_CLUSTER_REBALANCE
        shard = int(shard)
        if dataset not in self.manager.map \
                or not 0 <= shard < len(self.manager.map[dataset]):
            raise QueryError(f"unknown dataset/shard {dataset}/{shard}")
        owner = self.manager.node_of(dataset, shard)
        if owner != self.node:
            raise QueryError(
                f"shard {shard} is owned by {owner}, not this node — POST "
                "the rebalance to the owner")
        if to_node == self.node:
            raise QueryError("rebalance target is the current owner")
        ep = self._resolve_endpoint(to_node)
        if ep is None:
            raise QueryError(f"no HTTP endpoint known for node {to_node}")
        with span(SPAN_CLUSTER_REBALANCE, dataset=dataset, shard=shard,
                  to=to_node):
            # 1. pause ingest for the shard: stop its consumer (publishes
            # keep buffering in the broker; the adopter replays the tail)
            with self._shards_lock:
                moving = [c for c in self.consumers
                          if c.dataset == dataset
                          and c.shard.shard_num == shard]
                bus = self._buses.pop(shard, None)
                for c in moving:
                    self.consumers.remove(c)
                self._running.discard(shard)
            for c in moving:
                c.stop()
            if bus is not None:
                bus.close()             # unblocks a consumer mid-recv
            for c in moving:
                c.join(timeout=5)
            # 2. final flush: everything consumed becomes durable and
            # checkpointed — the adopter's recovery resumes exactly there
            sh = self.memstore.shard(dataset, shard)
            sh.flush()
            if sh.sink is not None:
                sh.flush_all_groups()
            # 3. release our fence claim; the adopter's claim supersedes
            if self._fence is not None:
                self._fence.release(shard)
            # 4. cutover: the adopter claims the epoch, warms from the
            # ring, replays the bus tail, and starts consuming
            try:
                req = urllib.request.Request(
                    f"http://{ep}/api/v1/cluster/adopt?dataset={dataset}"
                    f"&shard={shard}", method="POST", data=b"")
                with urllib.request.urlopen(req, timeout=60.0) as r:
                    import json as _json
                    adopted = _json.load(r)
            except (OSError, ValueError) as e:
                # aborted handoff: restart the shard locally (re-claims the
                # fence) so the cluster never has zero owners
                log.warning("rebalance adopt on %s failed; restarting "
                            "shard %s locally: %s", to_node, shard, e)
                self._start_shard(dataset, shard)
                raise QueryError(
                    f"rebalance aborted ({e}); shard restarted locally") \
                    from None
            # 5. flip our map and publish the new ownership
            self.manager.reassign(dataset, shard, to_node)
            if self.membership is not None:
                self.membership.publish_now()
            registry.counter(FILODB_CLUSTER_REBALANCES,
                             {"dataset": dataset}).increment()
            self.last_failover = {"event": "rebalance", "dataset": dataset,
                                  "shard": shard, "from": self.node,
                                  "to": to_node, "at": time.time()}
        return {"dataset": dataset, "shard": shard, "from": self.node,
                "to": to_node, "adopted": adopted.get("data")}

    def adopt_shard(self, dataset: str, shard: int) -> dict:
        """Receiving side of a live rebalance: claim the shard (epoch bump
        via _start_shard's fence claim), warm it from the durable ring,
        replay the broker tail, and start consuming. Idempotent."""
        shard = int(shard)
        if dataset not in self.manager.map \
                or not 0 <= shard < len(self.manager.map[dataset]):
            raise QueryError(f"unknown dataset/shard {dataset}/{shard}")
        with self._shards_lock:
            running = shard in self._running
        if running and self.manager.node_of(dataset, shard) == self.node:
            return {"dataset": dataset, "shard": shard, "node": self.node,
                    "already_owned": True}
        # reassign fires AssignmentStarted -> _on_shard_event starts the
        # consumer (fence claim + ring recovery + bus replay happen there)
        self.manager.reassign(dataset, shard, self.node)
        self.last_failover = {"event": "adopt", "dataset": dataset,
                              "shard": shard, "node": self.node,
                              "at": time.time()}
        return {"dataset": dataset, "shard": shard, "node": self.node}

    def start(self) -> "FiloServer":
        cfg = self.config
        # refuse what the port cannot honour BEFORE anything binds or starts
        fused_kernels_mode(cfg)
        if cfg.get("rules.groups"):
            raise NotImplementedError(
                "rules.groups needs filodb_tpu_torch.rules' evaluator, "
                "scheduler and publisher (rules/manager.py, rules/publish.py),"
                " which are not ported yet")
        # unconditional: the flag is process-global, so a later server in the
        # same process must be able to turn it back off
        from .utils import diagnostics
        diagnostics.enable(bool(cfg.get("diagnostics.enabled")))
        dataset = cfg["dataset"]
        # shard ids live in a power-of-two space (hash routing, spread); a
        # non-pow2 count would leave routable ids with no owning shard
        num_shards = _pow2(cfg["num_shards"])
        if cfg.get("cluster.registrar"):
            # multi-host join BEFORE shard assignment: wait for min_members in
            # the registrar and seed the manager with the *sorted* member list,
            # so every node computes the identical assignment (the reference
            # avoids this by putting the one ShardManager in a cluster
            # singleton; here determinism replaces the singleton)
            from .parallel.bootstrap import (ClusterBootstrap,
                                             FileRegistrarDiscovery)
            self_addr = cfg.get("cluster.self_addr") or \
                f"{cfg['http.host']}:{cfg['http.port']}"
            self._registrar = FileRegistrarDiscovery(
                cfg["cluster.registrar"],
                stale_s=parse_duration_ms(cfg["cluster.stale_after"]) / 1000.0)
            if cfg["cluster.min_members"] <= 1:
                log.warning(
                    "cluster.registrar is set but cluster.min_members=1: two "
                    "nodes cold-starting concurrently can each resolve a "
                    "single-member world and double-own shards — set "
                    "min_members to the expected cluster size")
            world = ClusterBootstrap(self._registrar, self_addr).resolve_world(
                min_members=cfg["cluster.min_members"],
                timeout_s=parse_duration_ms(cfg["cluster.join_timeout"]) / 1000.0)
            self.manager.nodes.remove(self.node)
            self.node = self_addr
            for m in world.members:
                self.manager.add_node(m)
            # adopt incumbent ownership published in peers' heartbeats: a
            # node (re)joining an established cluster must not recompute a
            # fresh full assignment (the survivors keep their takeover state;
            # ref: the cluster-singleton ShardManager avoids this upstream).
            # Settle one heartbeat first (only when live peers exist) so an
            # in-flight takeover's claims have landed in the registrar.
            if any(m != self_addr for m in self._registrar.discover()):
                time.sleep(
                    parse_duration_ms(cfg["cluster.heartbeat_interval"]) / 1000.0)
            claimed: dict[int, str] = {}
            for peer, peer_claims in self._registrar.claims().items():
                if peer == self_addr:
                    continue
                for s in peer_claims.get(dataset, ()):
                    claimed[int(s)] = peer
            self.manager.add_dataset(dataset, num_shards, claimed=claimed)
        else:
            self.manager.add_dataset(dataset, num_shards)
        if cfg.get("store_nodes"):
            # remote storage nodes with replication (the Cassandra-layer
            # deployment shape; ref: CassandraTSStoreFactory wiring) —
            # links get bounded connect/read timeouts so a dead backend
            # fails over instead of stalling flush/query threads
            from .core.diststore import RemoteStore, ReplicatedColumnStore
            store_tmo = parse_duration_ms(
                cfg["retention.store_timeout"]) / 1000.0
            self._sink = ReplicatedColumnStore(
                [RemoteStore(a, timeout_s=store_tmo,
                             connect_timeout_s=min(store_tmo, 5.0))
                 for a in cfg["store_nodes"]],
                replication=cfg.get("store_replication") or 2)
        else:
            self._sink = FileColumnStore(cfg["data_dir"]) if cfg.get("data_dir") else None
        if cfg.get("cluster.shard_fencing") and self._sink is not None:
            # epoch-fence store-ring writers: each owned shard's leadership
            # epoch persists in the durable ring; a deposed owner's flush or
            # checkpoint raises FencedWriteError (cluster/epoch.py)
            from .cluster.epoch import StoreFence
            self._fence = StoreFence(self._sink, self.node)
            if hasattr(self._sink, "write_guard"):
                self._sink.write_guard = self._fence
        self._store_cfg = cfg.store_config()
        # ingest cardinality governance (index.max_series_per_tenant): ONE
        # governor per dataset shared by every local shard and both ingest
        # edges — shard-level birth checks are authoritative, the edges
        # fast-shed what they can prove is a new over-quota series
        self._governor = None
        if cfg.get("index.max_series_per_tenant") is not None:
            from .core.cardinality import CardinalityGovernor
            self._governor = CardinalityGovernor(
                int(cfg["index.max_series_per_tenant"]),
                tenant_label=cfg["index.tenant_label"], dataset=dataset,
                retry_after_s=parse_duration_ms(
                    cfg["index.quota_retry_after"]) / 1000.0)
        self._index_bucket_ms = (parse_duration_ms(cfg["index.time_bucket"])
                                 if cfg.get("index.persist") else 0)

        def series_known(shard_num: int, labels, _ds=dataset) -> bool:
            """Edge probe: is this label set an EXISTING series of a LOCAL
            shard? Unknown/remote shards answer True (never shed on an
            unprovable probe — the shard-level limiter is authoritative)."""
            from .core.schemas import part_key_of as _pk_of
            try:
                sh = self.memstore.shard(_ds, shard_num)
            except KeyError:
                return True
            pk = _pk_of(dict(labels) if not isinstance(labels, dict)
                        else labels, sh.schema.options)
            with sh.lock:
                return pk in sh._part_key_to_id

        self._series_known = series_known
        health = ShardHealthStats(dataset)
        self.manager.subscribe(lambda ev: health.update(self.manager.snapshot(dataset)))
        # inline downsampling publisher (ref: ShardDownsampler at flush); the
        # first resolution publishes at every group flush, coarser ones
        # cascade periodically below
        if cfg.get("downsample.enabled") and self._sink is not None:
            from .jobs.batch_downsampler import make_inline_publisher
            self._ds_res = [parse_duration_ms(r)
                            for r in cfg["downsample.resolutions"]]
            for fine, coarse in zip(self._ds_res, self._ds_res[1:]):
                if coarse <= fine or coarse % fine:
                    raise ValueError(
                        "downsample.resolutions must ascend and each must be "
                        f"a multiple of the previous; got {cfg['downsample.resolutions']}")
            self._ds_publish = make_inline_publisher(self._sink, dataset,
                                                     self._ds_res[0])
        # shards spread round-robin over local cards (>= 1 per card) =>
        # PromQL aggregates run on the mesh (query/engine.py _try_mesh); any
        # other topology (a pinned card, peer-owned shards, indivisible
        # counts) keeps every shard on self.device and stays on the
        # in-process / cross-node dispatch paths. Decided once, before the
        # first shard is placed.
        owned = self.manager.shards_of_node(dataset, self.node)
        self._mesh_cards = mesh_cards(
            self.device.type, self._pinned,
            torch.cuda.device_count() if self.device.type == "cuda" else 0,
            num_shards, len(owned))
        for shard_num in owned:
            self._start_shard(dataset, shard_num)
        self.manager.subscribe(self._on_shard_event)
        mapper = ShardMapper(num_shards, spread=cfg["spread"])
        mesh = None
        if self._mesh_cards:
            from .parallel.distributed import make_mesh
            mesh = make_mesh()
        # cluster + endpoint resolver: leaves for peer-owned shards dispatch
        # over HTTP /exec (query/wire.py RemoteLeafExec) instead of erroring
        self.engines[dataset] = QueryEngine(
            self.memstore, dataset, mapper, cfg.query_config(), mesh=mesh,
            cluster=self.manager, node=self.node,
            endpoint_resolver=self._resolve_endpoint, device=self.device)
        if cfg.get("retention.routing"):
            # downsample-aware routing on the RAW engine: long-range /
            # coarse-step queries serve from the ds_family whose resolution
            # best covers [start,end,step], stitching the recent raw tail
            # (query/retention.py; family engines resolve live from
            # self.engines — the serving refresh below keeps them fresh)
            from .core.downsample import ds_family as _fam_of
            from .query.retention import RetentionPolicy, RetentionRouter
            policy = RetentionPolicy.from_config(
                cfg.get("retention.resolutions") or [], list(self._ds_res),
                raw_window_ms=self._store_cfg.retention_ms)
            self.engines[dataset].retention = RetentionRouter(
                policy,
                lambda res_ms, _ds=dataset: self.engines.get(
                    _fam_of(_ds, res_ms)),
                dataset=dataset)
        if cfg.get("cluster.buddy_endpoint"):
            # failure-aware query routing: time ranges overlapping a
            # known-bad window (node dead, shard warming) steer sub-queries
            # to the buddy cluster over its Prometheus HTTP API and stitch
            # with local results — the reference's FailureProvider/
            # PromQlExec dual-datacenter, no-SPOF design
            from .parallel.cluster import (FailureProvider,
                                           HighAvailabilityEngine,
                                           RemotePromExec)
            self.failures = FailureProvider()
            self.engines[dataset] = HighAvailabilityEngine(
                self.engines[dataset], self.failures,
                RemotePromExec(cfg["cluster.buddy_endpoint"], dataset))
            self.manager.subscribe(self._ha_track)

        # the remote-write writer (and its cardinality edge) waits for
        # promql/remote.py: the port's HTTP server takes no writers yet
        from .query.scheduler import QueryScheduler
        self.scheduler = QueryScheduler(
            num_threads=cfg["query.num_threads"],
            max_queue=cfg["query.queue_size"],
            timeout_s=parse_duration_ms(cfg["query.timeout"]) / 1000.0)
        self.http = FiloHttpServer(self.engines, host=cfg["http.host"],
                                   port=cfg["http.port"], cluster=self.manager,
                                   scheduler=self.scheduler,
                                   cluster_ops={
                                       "extra": self._cluster_extra,
                                       "rebalance": self.rebalance_shard,
                                       "adopt": self.adopt_shard},
                                   subscribe_poll_s=parse_duration_ms(
                                       cfg["query.subscribe_poll"]) / 1000.0
                                   ).start()
        if cfg.get("ingest.gateway_port") is not None:
            # Influx line-protocol gateway, config-wired: lines route to ALL
            # broker partitions (owned or not — the broker is global), or
            # straight into the local memstore when no bus is configured.
            # Broker publishes ride the windowed PUBLISH_BATCH path; sub-
            # window remainders drain on the gateway's flush cadence.
            from .ingest.gateway import GatewayServer
            self._gw_buses = self._make_shard_buses(num_shards)

            def gw_publish(shard, container, _ds=dataset):
                bus = self._gw_buses.get(shard)
                if bus is None:
                    self.memstore.ingest(_ds, shard, container)
                elif hasattr(bus, "publish_async"):
                    bus.publish_async(container)
                else:
                    bus.publish(container)

            gw_iv_ms = parse_duration_ms(cfg["ingest.gateway_flush_interval"])
            self.gateway = GatewayServer(
                gw_publish, num_shards=num_shards, spread=cfg["spread"],
                schema=self.memstore.schemas[cfg["schema"]],
                host=cfg["http.host"], port=cfg["ingest.gateway_port"],
                flush_lines=cfg["ingest.gateway_flush_lines"],
                flush_interval_ms=gw_iv_ms,
                governor=self._governor,
                series_known=self._series_known).start()

            def gw_drain():
                # gateway.stop() parity: the windowed publishers' sub-window
                # remainders drain with the final builder flush
                for b in list(self._gw_buses.values()):
                    if hasattr(b, "flush_publishes"):
                        b.flush_publishes()

            self.gateway.bus_drain = gw_drain
            if gw_iv_ms > 0 and any(hasattr(b, "flush_publishes")
                                    for b in self._gw_buses.values()):
                # interval 0 disables the timed flusher — starting the bus
                # drain loop anyway would busy-spin on wait(0)
                self._gw_flush_stop = threading.Event()

                def gw_bus_flush():
                    # broad on purpose: ANY fault must not kill the drain
                    # loop for the server's lifetime — sub-window remainders
                    # would never flush again (filolint:
                    # resource-worker-silent-death)
                    while not self._gw_flush_stop.wait(gw_iv_ms / 1000.0):
                        for b in list(self._gw_buses.values()):
                            try:
                                b.flush_publishes()
                            except Exception:  # noqa: BLE001
                                log.warning("gateway publish flush failed",
                                            exc_info=True)

                self._spawn(gw_bus_flush, "gw-bus-flush")
        # rules.groups was refused at the top of start(): the rules
        # subsystem comes in the next slice
        if cfg.get("cluster.registrar"):
            # watch peers: a silent peer's shards are reassigned to survivors,
            # whose _on_shard_event resync starts the consumers
            # (ref: gossip deathwatch -> ShardManager auto-reassignment)
            from .parallel.bootstrap import MembershipMonitor
            self.membership = MembershipMonitor(
                self._registrar, self.node, on_down=self._peer_down,
                on_up=self._peer_up, on_self_stale=self._quarantine,
                interval_s=parse_duration_ms(cfg["cluster.heartbeat_interval"]) / 1000.0)
            # steady-state ownership reconciliation: peers' published claims
            # (rebalance cutovers, takeovers) fold into our map each poll
            self.membership.on_claims = self._adopt_claims
            # publish current ownership with each heartbeat so late joiners
            # adopt the incumbent assignment (rejoin without split-brain)
            # only manager-known datasets claim shards: downsample-family
            # engines (ds:ds_1m) are serving views, not assignable datasets
            self.membership.claims_fn = lambda: {
                ds: [int(s) for s in self.manager.shards_of_node(ds, self.node)]
                for ds in list(self.engines) if ds in self.manager.map}
            # publish OUR http endpoint so peers can dispatch plan subtrees
            # here; the bound port is authoritative (config may say port 0).
            # A wildcard bind address is not dialable by peers: advertise the
            # cluster self_addr's host instead (or the explicit
            # http.advertise override for NAT/multi-homed hosts)
            adv = cfg.get("http.advertise")
            if not adv:
                adv = cfg["http.host"]
                if adv in ("0.0.0.0", "::", ""):
                    adv = self.node.rsplit(":", 1)[0]
            self.membership.http_addr = f"{adv}:{self.http.port}"
            if cfg.get("cluster.gossip_port") is not None:
                # membership gossip: counted (not timed) failure detection
                # over the broker wire framing, alongside the registrar
                # heartbeats (which remain the discovery/claims substrate).
                # The agent's bound address publishes with our heartbeat so
                # peers' agents can probe it.
                from .cluster.membership import GossipAgent, MembershipTable
                table = MembershipTable(
                    self.node,
                    suspect_after=cfg["cluster.suspect_after"],
                    dead_after=cfg["cluster.dead_after"],
                    http=self.membership.http_addr,
                    on_down=self._peer_down, on_up=self._peer_up,
                    on_claims=self._adopt_claims)

                def gossip_peers(_reg=self._registrar):
                    return _reg.gossips() if hasattr(_reg, "gossips") else {}

                self.gossip = GossipAgent(
                    self.node, gossip_peers, table, host=cfg["http.host"],
                    port=cfg["cluster.gossip_port"],
                    interval_s=parse_duration_ms(
                        cfg["cluster.gossip_interval"]) / 1000.0)
                self.gossip.claims_fn = self.membership.claims_fn
                self.gossip.start()
                self.membership.gossip_addr = f"{adv}:{self.gossip.port}"
            self.membership.poll_once()
            self.membership.start()
        if self._ds_publish is not None:
            # serve the downsample families over HTTP: a background refresh
            # loads each resolution's published chunks from the sink into a
            # serving memstore and swaps the family's engine atomically, so
            # /promql/{ds}:ds_1m/... answers PromQL over dMin/dMax/dAvg/...
            # columns (ref: the reference's separate downsample cluster
            # reading the downsample tables; here the same process serves
            # both). Full reload per refresh — family sizes are 1/res of raw.
            self._ds_serve_stop = threading.Event()
            serve_s = parse_duration_ms(
                cfg.get("downsample.serve_interval", "30s")) / 1000.0

            def ds_serve_loop(_ds=dataset, _mapper=mapper):
                from .core.downsample import ds_family
                from .jobs.batch_downsampler import load_downsampled
                while True:
                    try:
                        with self._shards_lock:
                            owned = sorted(self._running)
                        for res in self._ds_res:
                            fam = ds_family(_ds, res)
                            ms = TimeSeriesMemStore(device=self.device)
                            for s in owned:
                                try:
                                    load_downsampled(self._sink, _ds, s, res,
                                                     "dAvg", ms)
                                except KeyError:
                                    continue      # not yet published
                                except Exception:  # noqa: BLE001
                                    log.exception(
                                        "downsample load failed for %s "
                                        "shard %s", fam, s)
                            if ms.shards_of(fam):
                                # loaded-state fingerprint: when the durable
                                # family data is UNCHANGED since the last
                                # refresh, keep the serving engine (and its
                                # warm result/fragment caches — the stitched
                                # downsampled body stays cached across
                                # dashboard ticks; a swap would reset the
                                # epoch baseline and void every entry). The
                                # value SUM makes it sensitive to in-place
                                # bucket rewrites (late raw samples
                                # re-downsampled into existing buckets keep
                                # counts and lead unchanged); any surprise
                                # reading it falls back to a plain swap —
                                # staleness is the failure mode to avoid,
                                # a dropped cache is just a warm-up
                                fp = None
                                try:
                                    # the family store is this loop's own
                                    # (no lock); its value sum reduces on
                                    # its device, one scalar comes back
                                    fp = tuple(sorted(
                                        (s.shard_num, s.num_series,
                                         int(getattr(s, "lead_ms", 0)),
                                         int(s.store.n_host.sum()),
                                         float(torch.nansum(
                                             s.store.snapshot_arrays()[1]
                                             .to(torch.float64))))
                                        for s in ms.shards_of(fam)
                                        if s.store is not None))
                                except Exception:  # noqa: BLE001 — see above
                                    fp = None
                                cur = self.engines.get(fam)
                                if fp is not None and cur is not None \
                                        and getattr(cur, "_serve_fingerprint",
                                                    None) == fp:
                                    continue
                                # cluster-aware like the raw engine: leaves
                                # for peer-owned shards dispatch to the peer's
                                # serving view of the same family
                                eng = QueryEngine(
                                    ms, fam, _mapper, cfg.query_config(),
                                    cluster=self.manager, node=self.node,
                                    endpoint_resolver=self._resolve_endpoint,
                                    route_dataset=_ds, device=self.device)
                                eng._serve_fingerprint = fp
                                self.engines[fam] = eng
                    except Exception:  # noqa: BLE001
                        log.exception("downsample serving refresh failed")
                    if self._ds_serve_stop.wait(serve_s):
                        return

            self._spawn(ds_serve_loop, "ds-serving")
        if self._ds_publish is not None and len(self._ds_res) > 1:
            # periodic cascade to coarser resolutions (ref: DownsamplerMain's
            # 6-hourly batch job). Windows advance to the last COMPLETE coarse
            # bucket of the DURABLY PUBLISHED finer data (never in-memory
            # ingest state), and watermarks persist in the sink's meta so a
            # restart or shard takeover resumes instead of re-appending.
            self._cascade_stop = threading.Event()
            interval_s = parse_duration_ms(cfg["downsample.cascade_interval"]) / 1000.0

            def cascade_loop(_ds=dataset):
                from .core.downsample import ds_family
                from .jobs.batch_downsampler import run_cascade_downsample
                while not self._cascade_stop.wait(interval_s):
                    try:
                        with self._shards_lock:
                            owned = sorted(self._running)
                        for sh_num in owned:
                            pub_max = self._ds_publish.published_max.get(sh_num)
                            if pub_max is None:
                                continue
                            for i in range(1, len(self._ds_res)):
                                coarse = self._ds_res[i]
                                fam = ds_family(_ds, coarse)
                                # one-coarse-bucket lateness margin: series
                                # whose fine buckets publish a little behind
                                # the shard's fastest are still included
                                # (the reference's late-data widening analog)
                                hi = ((pub_max - coarse) // coarse) * coarse - 1
                                key = (sh_num, i)
                                lo = self._cascade_wm.get(key)
                                if lo is None:   # durable watermark survives
                                    meta = self._sink.read_meta(fam, sh_num) \
                                        if hasattr(self._sink, "read_meta") else {}
                                    lo = int(meta.get("cascade_wm", -1))
                                if hi <= lo:
                                    self._cascade_wm[key] = lo
                                    continue
                                run_cascade_downsample(
                                    self._sink, _ds, sh_num,
                                    self._ds_res[i - 1], coarse,
                                    start_ms=lo + 1, end_ms=hi)
                                self._cascade_wm[key] = hi
                                if hasattr(self._sink, "write_meta"):
                                    # merge: the cascade job records the
                                    # family's column order in the same meta
                                    m = self._sink.read_meta(fam, sh_num) or {}
                                    m["cascade_wm"] = hi
                                    self._sink.write_meta(fam, sh_num, m)
                    except Exception:
                        log.exception("cascade downsample pass failed")

            self._spawn(cascade_loop, "cascade-downsampler")
        if cfg.get("retention.raw_ttl") is not None and self._sink is not None:
            # durable raw age-out: drop sink samples older than raw_ttl on a
            # cadence; each pass bumps the shard's data_epoch so cached
            # results over the aged-out range invalidate (the downsample
            # families keep the history at their resolutions)
            self._retention_stop = threading.Event()
            raw_ttl_ms = parse_duration_ms(cfg["retention.raw_ttl"])
            compact_s = parse_duration_ms(
                cfg["retention.compact_interval"]) / 1000.0

            def retention_loop(_ds=dataset):
                # broad on purpose: ANY fault must not kill the age-out
                # loop for the server's lifetime (filolint:
                # resource-worker-silent-death)
                while not self._retention_stop.wait(compact_s):
                    try:
                        with self._shards_lock:
                            owned = sorted(self._running)
                        for s in owned:
                            sh = self.memstore.shard(_ds, s)
                            # O(1) per-shard data-lead watermark (the same
                            # one the router reads) — not an O(max_series)
                            # last_ts scan per pass
                            lead = int(getattr(sh, "lead_ms", 0))
                            if lead > 0:
                                n = sh.age_out_durable(lead - raw_ttl_ms)
                                if n:
                                    log.info("retention: aged %d raw "
                                             "samples out of shard %d", n, s)
                    except Exception:  # noqa: BLE001
                        log.exception("retention age-out pass failed")

            self._spawn(retention_loop, "retention-ageout")
        if cfg.get("profiler.enabled"):
            from .utils.profiler import SimpleProfiler
            self.profiler = SimpleProfiler(
                parse_duration_ms(cfg["profiler.interval"]) / 1000.0).start()
        # hand the profiler to the HTTP debug plane: /api/v1/debug/profile
        # start/stop/report drives this one instance (or lazily creates its
        # own when the config didn't start one)
        self.http.profiler = self.profiler
        tracer.log_spans = bool(cfg.get("tracing.log_spans"))
        # distributed tracing: sampling decided at trace roots on THIS node;
        # the decision propagates to peers in the trace context
        tracer.enabled = bool(cfg.get("trace.enabled", True))
        tracer.sample_rate = float(cfg.get("trace.sample_rate", 1.0))
        from .query.engine import slow_query_log
        slow_query_log.resize(int(cfg["query.slow_log_size"]))
        # The reference sets its process-global fused mode, mesh program
        # mode and donation here, sizes its compiled-plan cache and starts
        # a warm-up thread. None of that machinery has a port (ROADMAP
        # ground rules: "XLA program machinery has no port"): the port runs
        # eagerly, its mesh has one mode, and query.fused_kernels was
        # validated at the top of start().
        zep = cfg.get("trace.zipkin_endpoint")
        if zep:
            from .utils.tracing import ZipkinReporter
            self._zipkin = ZipkinReporter(tracer, zep).start()
        log.info("FiloServer up: dataset=%s shards=%s port=%s",
                 dataset, num_shards, self.http.port)
        return self

    def _spawn(self, target, name: str) -> None:
        """Start a background loop the shutdown joins."""
        t = threading.Thread(target=target, daemon=True, name=name)
        self._threads.append(t)
        t.start()

    def shutdown(self) -> None:
        if self._cascade_stop is not None:
            self._cascade_stop.set()
        if self._ds_serve_stop is not None:
            self._ds_serve_stop.set()
        if self._retention_stop is not None:
            self._retention_stop.set()
        if self._gw_flush_stop is not None:
            self._gw_flush_stop.set()
        if self.gateway is not None:
            # stop() owns the whole drain contract: it flushes every
            # pending builder and runs bus_drain (the windowed publishers'
            # sub-window remainders) before returning
            self.gateway.stop()
        for b in self._gw_buses.values():
            try:
                if hasattr(b, "close"):
                    b.close()
            except (ConnectionError, OSError, RuntimeError):
                log.warning("gateway bus close failed on shutdown",
                            exc_info=True)
        # stop flags first, then SEVER the buses (unblocks a consumer stuck
        # in a broker recv — joining first would stall behind the socket
        # timeout), join, and re-sever to catch a reconnect that raced the
        # first close (same ordering as _quarantine)
        for c in self.consumers:
            c.stop()
        with self._shards_lock:
            for b in self._buses.values():
                try:
                    b.close()
                except OSError:
                    log.warning("bus close failed on shutdown",
                                exc_info=True)
        for c in self.consumers:
            c.join(timeout=3)
        with self._shards_lock:
            for b in self._buses.values():
                try:
                    b.close()
                except OSError:
                    log.warning("bus close failed on shutdown",
                                exc_info=True)
            self._buses.clear()
        # the consumers launch work on the card: none may still run when
        # shutdown returns (a launch during interpreter teardown aborts the
        # process). A consumer the first join missed is mid-ingest; its
        # stop flag is set and its bus severed, so it ends within a drain.
        for c in self.consumers:
            c.join(timeout=60)
            if c.is_alive():
                log.error("ingest consumer %s did not stop", c.name)
        for t in self._threads:
            t.join(timeout=60)
            if t.is_alive():
                log.error("background loop %s did not stop", t.name)
        if self.http:
            self.http.stop()
        if self.scheduler:
            self.scheduler.shutdown()
        if self.membership:
            self.membership.stop()
        if self.gossip is not None:
            self.gossip.stop()
        if self.profiler:
            self.profiler.stop()
        if self._zipkin is not None:
            self._zipkin.stop()


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def mesh_cards(device_type: str, pinned: bool, ncards: int, num_shards: int,
               n_owned: int) -> int:
    """Cards the server's shards spread over, the mesh's width: ``ncards``
    when a ``cuda`` server with no pinned card index sees more than one
    card, owns every one of more than one shard, and the shards divide
    evenly over the cards; else 0 (every shard on the server's device, no
    mesh)."""
    if (device_type == "cuda" and not pinned and ncards > 1
            and 1 < num_shards == n_owned and num_shards % ncards == 0):
        return ncards
    return 0
