"""Monotonic leadership epochs — the fencing currency of elastic failover.

Reference: the reference outsources write fencing to Kafka (broker
generations / zombie-fenced producers) and Cassandra (single-writer-per-
shard by cluster-singleton assignment). Here both fences are in-framework:

  * :class:`PartitionEpochs` — per broker partition, persisted as a JSON
    sidecar beside the partition logs. Every ``OP_REPLICATE`` batch
    carries the leader's epoch; a follower holding a HIGHER epoch refuses
    the batch, and a leader that learns of a higher epoch steps down —
    its publish acks are refused from that point on (the spurious-
    failover split-brain window from ARCHITECTURE "Known limits" closes:
    two concurrent writers can exist only until the first replicate or
    publish round-trip, and the deposed one can never ack).
  * :class:`StoreFence` — per shard of the durable store ring, persisted
    IN the ring itself (``write_meta`` under the reserved
    ``_cluster_epochs`` dataset, so the epoch record is exactly as
    durable and replicated as the data it fences). A node claims a
    shard's epoch when it starts the shard; flush/checkpoint writes from
    a node whose claimed epoch is below the ring's current one raise
    :class:`FencedWriteError` — a deposed owner cannot corrupt the shard
    a replacement already warmed.

Both fences are monotonic and crash-safe: adopt/claim only ever moves an
epoch up, and persistence is atomic-replace, so a torn write leaves the
previous epoch in force (refusing writes is always safe; acking them is
not).
"""

from __future__ import annotations

import json
import os
import threading

from ..utils.metrics import (FILODB_CLUSTER_EPOCH,
                             FILODB_CLUSTER_FENCED_REJECTS, registry)

# reserved meta dataset holding per-shard store-ring epochs; StoreFence
# bypasses its own guard for it (the claim write must never self-fence)
EPOCH_DATASET = "_cluster_epochs"


class FencedWriteError(IOError):
    """A store-ring write was refused by epoch fencing: this node's claim
    on the shard was superseded (failover takeover or rebalance cutover
    moved ownership while we still held a stale claim)."""

    def __init__(self, shard: int, mine: int, current: int, owner: str = ""):
        super().__init__(
            f"fenced: shard {shard} epoch {current} (owner {owner or '?'}) "
            f"supersedes this node's claim at epoch {mine}")
        self.shard = int(shard)
        self.mine = int(mine)
        self.current = int(current)
        self.owner = owner


def _epoch_gauge(scope: str, key) -> None:
    return registry.gauge(FILODB_CLUSTER_EPOCH,
                          {"scope": scope, "id": str(key)})


class PartitionEpochs:
    """Per-partition (epoch, owner) map persisted as ``epochs.json`` in the
    broker's data directory (atomic replace; a torn write keeps the prior
    epoch in force). ``adopt`` is the ONLY mutator and it is monotonic —
    an equal-or-lower epoch is refused, so replays and races cannot move
    leadership backwards."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._map: dict[int, tuple[int, str]] = {}
        try:
            with open(path) as f:
                raw = json.load(f)
            self._map = {int(k): (int(v["epoch"]), str(v.get("owner") or ""))
                         for k, v in raw.items()}
        except (FileNotFoundError, ValueError, KeyError, TypeError):
            self._map = {}      # no/torn file: every partition at epoch 0

    def get(self, part: int) -> tuple[int, str]:
        with self._lock:
            return self._map.get(int(part), (0, ""))

    def adopt(self, part: int, epoch: int, owner: str) -> bool:
        """Record ``epoch``/``owner`` for the partition iff strictly higher
        than the current record — ordering is LEXICOGRAPHIC over
        ``(epoch, owner)``, so two concurrent claims that both computed the
        same epoch resolve deterministically (the higher owner address
        wins everywhere, and the loser's next publish/replicate is fenced)
        instead of leaving two fenced-in leaders on an epoch tie. Persists
        before returning True."""
        part, epoch = int(part), int(epoch)
        owner = str(owner)
        with self._lock:
            cur, cur_owner = self._map.get(part, (0, ""))
            if (epoch, owner) <= (cur, cur_owner):
                return False
            self._map[part] = (epoch, owner)
            blob = json.dumps({str(p): {"epoch": e, "owner": o}
                               for p, (e, o) in self._map.items()})
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                f.write(blob)
            os.replace(tmp, self.path)
        _epoch_gauge("partition", part).update(float(epoch))
        return True

    def items(self) -> dict[int, dict]:
        """Status-surface view: partition -> {epoch, owner}."""
        with self._lock:
            return {p: {"epoch": e, "owner": o}
                    for p, (e, o) in sorted(self._map.items())}


class StoreFence:
    """Epoch fence for store-ring shard writers, persisted to the durable
    ring itself (``write_meta``/``read_meta`` under ``_cluster_epochs``).

    Install the instance as a :class:`ReplicatedColumnStore`
    ``write_guard``: every replica write consults ``__call__`` first. The
    check is COUNTED, not timed — every ``refresh_every``-th write per
    shard re-reads the durable epoch (plus the very first write after a
    claim), so a deposed owner is fenced within a bounded number of
    writes with zero read amplification on the steady state."""

    def __init__(self, sink, node: str, refresh_every: int = 8):
        self.sink = sink
        self.node = node
        self.refresh_every = max(1, int(refresh_every))
        self._lock = threading.Lock()
        self._owned: dict[int, int] = {}        # shard -> epoch we claimed
        self._checks: dict[int, int] = {}       # shard -> guard-call count

    def claim(self, shard: int) -> int:
        """Bump the shard's durable epoch and record this node as owner.
        Called when a node starts (or adopts) a shard — the previous
        owner's stale claim is superseded the moment this lands."""
        shard = int(shard)
        meta = {}
        if hasattr(self.sink, "read_meta"):
            meta = self.sink.read_meta(EPOCH_DATASET, shard) or {}
        new = int(meta.get("epoch", 0)) + 1
        self.sink.write_meta(EPOCH_DATASET, shard,
                             {"epoch": new, "owner": self.node})
        with self._lock:
            self._owned[shard] = new
            self._checks[shard] = 0
        _epoch_gauge("shard", shard).update(float(new))
        return new

    def release(self, shard: int) -> None:
        """Drop the local claim (rebalance handoff / quarantine): later
        writes for the shard are refused without a durable read."""
        with self._lock:
            self._owned.pop(int(shard), None)
            self._checks.pop(int(shard), None)

    def owned(self) -> dict[int, int]:
        with self._lock:
            return dict(self._owned)

    def __call__(self, dataset: str, shard: int, op: str) -> None:
        """The write guard. Raises :class:`FencedWriteError` when this
        node's claim is missing or superseded."""
        if dataset == EPOCH_DATASET:
            return                  # the claim write must not self-fence
        shard = int(shard)
        with self._lock:
            mine = self._owned.get(shard)
            if mine is not None:
                n = self._checks.get(shard, 0) + 1
                self._checks[shard] = n
                if n != 1 and n % self.refresh_every:
                    return          # counted steady-state: no durable read
        if mine is None:
            registry.counter(FILODB_CLUSTER_FENCED_REJECTS,
                             {"site": "store"}).increment()
            raise FencedWriteError(shard, 0, 0, "")
        meta = {}
        if hasattr(self.sink, "read_meta"):
            meta = self.sink.read_meta(EPOCH_DATASET, shard) or {}
        cur = int(meta.get("epoch", 0))
        cur_owner = str(meta.get("owner") or "")
        # the ring has no CAS: two racing claims can both land epoch N+1,
        # and the LAST write is the durable record. The owner check breaks
        # the tie — a node whose claim was overwritten (same epoch,
        # different durable owner) fences on its next counted refresh, so
        # the double-owner window is bounded by refresh_every writes
        if cur > mine or (cur == mine and cur_owner != self.node):
            with self._lock:
                self._owned.pop(shard, None)
            registry.counter(FILODB_CLUSTER_FENCED_REJECTS,
                             {"site": "store"}).increment()
            raise FencedWriteError(shard, mine, cur, cur_owner)
