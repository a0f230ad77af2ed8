"""Membership gossip: heartbeat counters, counted suspicion, deterministic
probe schedule.

Reference: Akka Cluster gossip + phi-accrual deathwatch feeding
``ShardManager.remove_node`` (NodeClusterActor.scala:187). The TPU-native
translation replaces wall-clock phi with COUNTED suspicion, mirroring the
replicated broker's counted in-sync tracking (ingest/replication.py
``FAIL_THRESHOLD``): every probe ROUND each node (a) bumps its own
heartbeat counter, (b) exchanges digests with one peer chosen by a seeded
deterministic schedule, and (c) ages every peer whose counter did not
advance. A peer stale for ``suspect_after`` rounds turns SUSPECT, for
``dead_after`` rounds DEAD — `on_down` fires once and the shard manager
reassigns. Counters flow transitively through digests, so an alive node
two hops away never goes stale, and a FaultPlan ``gossip``-site rule can
drop exactly the nth probe — failure detection is replayable run to run.

Refutation (SWIM-style): digests carry ``(incarnation, heartbeat)`` pairs
compared lexicographically. A restarted node whose fresh counter would
lose to its own stale record learns that from the first digest mentioning
itself and bumps its incarnation past it — no wall clock, no randomness.
"""

from __future__ import annotations

import logging
import threading

from ..utils.metrics import (FILODB_CLUSTER_GOSSIP_ROUNDS,
                             FILODB_CLUSTER_PEER_STATE, registry)
from ..utils.tracing import SPAN_CLUSTER_GOSSIP, span
from .gossip import ClusterLink

log = logging.getLogger("filodb_tpu_torch.membership")

ALIVE, SUSPECT, DEAD = "alive", "suspect", "dead"
_STATE_GAUGE = {ALIVE: 0.0, SUSPECT: 1.0, DEAD: 2.0}


class MembershipTable:
    """One node's view of the cluster: addr -> (incarnation, heartbeat,
    state, http endpoint, shard claims). Thread-safe; transitions fire the
    agent's callbacks OUTSIDE the table lock."""

    def __init__(self, self_addr: str, suspect_after: int = 3,
                 dead_after: int = 8, http: str | None = None,
                 on_down=None, on_up=None, on_claims=None):
        assert dead_after > suspect_after > 0
        self.self_addr = self_addr
        self.suspect_after = int(suspect_after)
        self.dead_after = int(dead_after)
        self.http = http
        self.claims: dict = {}
        self.on_down = on_down
        self.on_up = on_up
        self.on_claims = on_claims
        self.incarnation = 0
        self.heartbeat = 0
        self.round = 0
        self._lock = threading.Lock()
        # addr -> {"inc", "hb", "state", "stale", "http", "claims"}
        self._peers: dict[str, dict] = {}

    # -- digest exchange -----------------------------------------------------

    def digest(self) -> dict:
        with self._lock:
            members = {self.self_addr: {
                "inc": self.incarnation, "hb": self.heartbeat,
                "state": ALIVE, "http": self.http, "claims": self.claims}}
            for addr, m in self._peers.items():
                members[addr] = {"inc": m["inc"], "hb": m["hb"],
                                 "state": m["state"], "http": m["http"],
                                 "claims": m["claims"]}
        return {"from": self.self_addr, "members": members}

    def merge(self, digest: dict) -> dict:
        """Adopt fresher (incarnation, heartbeat) records from a peer's
        digest; returns our own digest as the response. Fires on_up for a
        DEAD peer whose counter advanced (it is back) and on_claims when a
        peer's shard claims changed."""
        revived, claimed = [], []
        members = digest.get("members") or {}
        with self._lock:
            for addr, m in members.items():
                try:
                    inc, hb = int(m["inc"]), int(m["hb"])
                except (KeyError, TypeError, ValueError):
                    continue        # malformed member row: skip, not sever
                if addr == self.self_addr:
                    # refutation: someone holds a STRICTLY fresher record of
                    # us than we do — only possible after a restart reset
                    # our counter — so bump past it (a digest merely echoing
                    # our current record is not a refutation)
                    if (inc, hb) > (self.incarnation, self.heartbeat):
                        self.incarnation = inc + 1
                    continue
                cur = self._peers.get(addr)
                if cur is None:
                    self._peers[addr] = {
                        "inc": inc, "hb": hb, "state": ALIVE, "stale": 0,
                        "http": m.get("http"), "claims": m.get("claims") or {}}
                    if m.get("claims"):
                        claimed.append((addr, m["claims"]))
                    continue
                if (inc, hb) <= (cur["inc"], cur["hb"]):
                    continue        # nothing fresher
                was = cur["state"]
                cur.update(inc=inc, hb=hb, stale=0, state=ALIVE,
                           http=m.get("http") or cur["http"])
                if (m.get("claims") or {}) != cur["claims"]:
                    cur["claims"] = m.get("claims") or {}
                    claimed.append((addr, cur["claims"]))
                if was == DEAD:
                    revived.append(addr)
                self._gauge(addr).update(_STATE_GAUGE[ALIVE])
        for addr in revived:
            if self.on_up is not None:
                self.on_up(addr)
        for addr, claims in claimed:
            if self.on_claims is not None:
                self.on_claims(addr, claims)
        return self.digest()

    # -- counted aging -------------------------------------------------------

    def tick(self) -> None:
        """One probe round: bump our heartbeat, age every peer, transition
        alive→suspect→dead at the counted thresholds."""
        died = []
        with self._lock:
            self.heartbeat += 1
            self.round += 1
            for addr, m in self._peers.items():
                if m["state"] == DEAD:
                    continue
                m["stale"] += 1
                if m["stale"] >= self.dead_after:
                    m["state"] = DEAD
                    died.append(addr)
                elif m["stale"] >= self.suspect_after:
                    m["state"] = SUSPECT
                self._gauge(addr).update(_STATE_GAUGE[m["state"]])
        for addr in died:
            log.warning("membership: peer %s declared dead after %d silent "
                        "rounds", addr, self.dead_after)
            if self.on_down is not None:
                self.on_down(addr)

    def _gauge(self, addr: str):
        return registry.gauge(FILODB_CLUSTER_PEER_STATE, {"peer": addr})

    # -- views ---------------------------------------------------------------

    def state_of(self, addr: str) -> str:
        if addr == self.self_addr:
            return ALIVE
        with self._lock:
            m = self._peers.get(addr)
            return m["state"] if m else DEAD

    def rows(self) -> list[dict]:
        """Status-surface table (filo-cli cluster / /api/v1/cluster)."""
        with self._lock:
            out = [{"node": self.self_addr, "state": ALIVE,
                    "heartbeat": self.heartbeat, "incarnation": self.incarnation,
                    "stale_rounds": 0, "http": self.http, "self": True}]
            for addr, m in sorted(self._peers.items()):
                out.append({"node": addr, "state": m["state"],
                            "heartbeat": m["hb"], "incarnation": m["inc"],
                            "stale_rounds": m["stale"], "http": m["http"],
                            "self": False})
        return out


class GossipAgent:
    """Drives one node's gossip: hosts the digest endpoint (GossipServer)
    and runs probe rounds against a seeded deterministic schedule.
    ``peers_fn`` resolves the current peer gossip addresses each round
    (registrar-fed, so joins need no restart); tests call
    :meth:`probe_round` directly, production calls :meth:`start`."""

    def __init__(self, self_addr: str, peers_fn, table: MembershipTable,
                 host: str = "127.0.0.1", port: int = 0, seed: int = 0,
                 interval_s: float = 1.0, fault_plan=None):
        from .gossip import GossipServer
        self.self_addr = self_addr
        self.peers_fn = peers_fn
        self.table = table
        self.seed = int(seed)
        self.interval_s = float(interval_s)
        self.fault_plan = fault_plan
        # optional provider of this node's shard-ownership claims, carried
        # in every digest so peers reconcile ownership (rebalance cutover
        # propagation without waiting out a registrar heartbeat)
        self.claims_fn = None
        self._stop_ev = threading.Event()
        self._thread: threading.Thread | None = None
        self.server = GossipServer(self, host=host, port=port)

    # serve_cluster host interface: the digest endpoint merges into our table
    @property
    def membership(self) -> MembershipTable:
        return self.table

    @property
    def port(self) -> int:
        return self.server.port

    def probe_round(self) -> str | None:
        """One deterministic round: tick the table, pick the scheduled
        peer, exchange digests. ``peers_fn`` may return a plain address
        list or a {node identity: gossip address} map (the registrar-fed
        form). Returns the probed node (None when no peers). A transport
        fault just means no counter advance — the counted aging converts
        silence into suspicion."""
        registry.counter(FILODB_CLUSTER_GOSSIP_ROUNDS).increment()
        if self.claims_fn is not None:
            self.table.claims = self.claims_fn()
        self.table.tick()
        peers = self.peers_fn() or {}
        if not isinstance(peers, dict):
            peers = {a: a for a in peers}
        names = sorted(n for n in peers if n != self.self_addr)
        if not names:
            return None
        target = names[(self.table.round + self.seed) % len(names)]
        with span(SPAN_CLUSTER_GOSSIP, peer=target, round=self.table.round):
            try:
                resp = ClusterLink(peers[target],
                                   fault_plan=self.fault_plan).gossip(
                    self.table.digest(), round_no=self.table.round)
                self.table.merge(resp)
            except (ConnectionError, OSError) as e:
                log.debug("gossip probe to %s failed: %s", target, e)
        return target

    def start(self) -> "GossipAgent":
        self.server.start()

        def loop():
            # broad on purpose: ANY fault must not kill the gossip loop for
            # the node's lifetime — a silent agent reads as a dead node to
            # every peer (filolint: resource-worker-silent-death)
            while not self._stop_ev.wait(self.interval_s):
                try:
                    self.probe_round()
                except Exception:  # noqa: BLE001
                    log.exception("gossip probe round failed")

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="filo-gossip-probe")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop_ev.set()
        if self._thread is not None:
            self._thread.join(timeout=3)
            self._thread = None
        self.server.stop()
