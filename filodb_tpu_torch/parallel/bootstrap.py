"""Multi-process cluster bootstrap: seed discovery, ``torch.distributed``
init, and membership with heartbeat failure detection.

Host copy of ``filodb_tpu/parallel/bootstrap.py``; its
``initialize_jax`` becomes :meth:`ClusterBootstrap.initialize_torch`.

Reference: akka-bootstrapper/.../AkkaBootstrapper.scala:31 (strategy-driven
seed discovery, then join-or-become-seed), WhitelistClusterSeedDiscovery.scala:18
(static seed list), DnsSrvClusterSeedDiscovery.scala / ConsulClient.scala
(registration-based discovery — nodes register themselves and discover peers
from the registrar), plus Akka Cluster gossip deathwatch feeding
ShardManager.remove_node (coordinator/.../NodeClusterActor.scala:187).

Joining the cluster means agreeing on a process-group world: a
coordinator address, a process count and a stable rank per process. Seed
discovery produces exactly that tuple: the lexicographically first
member is the coordinator (deterministic without an election, the analog of
akka-bootstrapper's "lowest address becomes seed"), and each member's rank is
its index in the sorted member list. Membership liveness is heartbeat-based
(registrar timestamps), feeding ShardManager reassignment on failure.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time
from dataclasses import dataclass

log = logging.getLogger(__name__)


# --------------------------------------------------------------------------
# Seed discovery strategies (ref: akka-bootstrapper discovery hierarchy)
# --------------------------------------------------------------------------

class SeedDiscovery:
    """Strategy interface: produce the member list this node should join."""

    def discover(self) -> list[str]:  # pragma: no cover - interface
        raise NotImplementedError

    def register(self, addr: str) -> None:
        """Registration-based strategies record this node; static ones no-op."""


class WhitelistSeedDiscovery(SeedDiscovery):
    """Static seed list (ref: WhitelistClusterSeedDiscovery.scala:18)."""

    def __init__(self, seeds: list[str]):
        self.seeds = [s.strip() for s in seeds if s.strip()]

    def discover(self) -> list[str]:
        return list(self.seeds)


class EnvSeedDiscovery(WhitelistSeedDiscovery):
    """Seeds from an environment variable (comma-separated host:port)."""

    def __init__(self, var: str = "FILODB_SEEDS"):
        super().__init__(os.environ.get(var, "").split(","))


class FileRegistrarDiscovery(SeedDiscovery):
    """Shared-directory registrar: each node owns one member file it rewrites
    atomically on heartbeat; discovery reads all member files (the Consul/
    DNS-SRV analog for environments without either — ref: ConsulClient.scala
    registration + query). Per-node files mean no cross-process write races
    and no unbounded growth; members silent past ``stale_s`` are gone."""

    def __init__(self, path: str, stale_s: float = 30.0):
        self.path = path
        self.stale_s = stale_s
        os.makedirs(path, exist_ok=True)
        self._lock = threading.Lock()

    def _member_file(self, addr: str) -> str:
        safe = addr.replace(":", "_").replace("/", "_")
        return os.path.join(self.path, f"{safe}.member")

    def register(self, addr: str, claims: dict | None = None,
                 http: str | None = None, gossip: str | None = None) -> None:
        """Heartbeat, optionally carrying the node's shard ownership claims
        ({dataset: [shard ids]}), its HTTP endpoint ("host:port"), and its
        membership-gossip endpoint. Claims let a (re)joining node adopt the
        incumbent assignment instead of computing a fresh one; the HTTP
        endpoint lets peers dispatch query subtrees to this node
        (query/wire.py); the gossip endpoint is how peers' GossipAgents
        find each other (cluster/membership.py)."""
        tmp = self._member_file(addr) + ".tmp"
        with self._lock:
            with open(tmp, "w") as f:
                f.write(json.dumps({"addr": addr, "ts": time.time(),
                                    "claims": claims or {}, "http": http,
                                    "gossip": gossip}))
            os.replace(tmp, self._member_file(addr))

    heartbeat = register     # a re-registration refreshes the timestamp

    def _live_entries(self):
        now = time.time()
        for name in os.listdir(self.path):
            if not name.endswith(".member"):
                continue
            try:
                with open(os.path.join(self.path, name)) as f:
                    m = json.loads(f.read())
                if now - m["ts"] <= self.stale_s:
                    yield m
            except (OSError, ValueError, KeyError):
                continue     # torn read of a concurrent rewrite — skip

    def discover(self) -> list[str]:
        return sorted(m["addr"] for m in self._live_entries())

    def claims(self) -> dict[str, dict]:
        """Live members' shard-ownership claims: addr -> {dataset: [ids]}."""
        return {m["addr"]: m.get("claims") or {} for m in self._live_entries()}

    def endpoints(self) -> dict[str, str]:
        """Live members' published HTTP endpoints: addr -> "host:port"."""
        return {m["addr"]: m["http"] for m in self._live_entries()
                if m.get("http")}

    def gossips(self) -> dict[str, str]:
        """Live members' published gossip endpoints: addr -> "host:port"."""
        return {m["addr"]: m["gossip"] for m in self._live_entries()
                if m.get("gossip")}


class DnsSrvSeedDiscovery(SeedDiscovery):
    """Seeds from DNS SRV records (ref: DnsSrvClusterSeedDiscovery.scala:12,87
    — resolve ``_filodb._tcp.<domain>`` and join the returned host:port set).

    Kubernetes headless services and Consul DNS both publish peers this way.
    The stdlib has no SRV resolver, so a minimal RFC-1035 query/parse lives
    here (same dependency-free stance as utils/snappy.py); name compression
    pointers in answers are handled."""

    SRV, IN = 33, 1

    def __init__(self, srv_name: str, resolver: str | None = None,
                 timeout_s: float = 3.0):
        self.srv_name = srv_name.rstrip(".")
        self.timeout_s = timeout_s
        self.resolver = resolver or self._system_resolver()

    @staticmethod
    def _system_resolver() -> str:
        try:
            with open("/etc/resolv.conf") as f:
                for line in f:
                    parts = line.split()
                    if len(parts) >= 2 and parts[0] == "nameserver":
                        ns = parts[1]
                        # IPv6 literals must be bracketed — "fd00::1:53"
                        # would parse as a DIFFERENT address
                        return f"[{ns}]:53" if ":" in ns else f"{ns}:53"
        except OSError:
            pass
        return "127.0.0.1:53"

    @staticmethod
    def _encode_name(name: str) -> bytes:
        out = b""
        for label in name.split("."):
            raw = label.encode()
            out += bytes([len(raw)]) + raw
        return out + b"\x00"

    @staticmethod
    def _read_name(buf: bytes, off: int) -> tuple[str, int]:
        """Domain name at ``off``; follows RFC-1035 compression pointers.
        Returns (name, offset-after-the-name-as-stored)."""
        labels, jumped, end = [], False, off
        hops = 0
        while True:
            ln = buf[off]
            if ln & 0xC0 == 0xC0:             # compression pointer
                if not jumped:
                    end = off + 2
                off = ((ln & 0x3F) << 8) | buf[off + 1]
                jumped = True
                hops += 1
                if hops > 64:
                    raise ValueError("DNS name pointer loop")
                continue
            if ln == 0:
                if not jumped:
                    end = off + 1
                return ".".join(labels), end
            off += 1
            labels.append(buf[off:off + ln].decode())
            off += ln

    def _resolver_addr(self) -> tuple[str, int, int]:
        """(host, port, socket family) — handles '[v6]:53', bare IPv6
        literals (port defaults to 53), and host:port."""
        r = self.resolver
        if r.startswith("["):                      # [v6]:port
            host, _, rest = r[1:].partition("]")
            port = int(rest.lstrip(":") or 53)
        elif r.count(":") > 1:                     # bare IPv6 literal
            host, port = r, 53
        elif ":" in r:
            host, port_s = r.rsplit(":", 1)
            port = int(port_s)
        else:
            host, port = r, 53
        fam = (socket.AF_INET6 if ":" in host else socket.AF_INET)
        return host, port, fam

    def query_srv(self) -> list[tuple[int, int, int, str]]:
        """[(priority, weight, port, target)] for the SRV name."""
        import struct as st
        qid = int.from_bytes(os.urandom(2), "big")
        msg = (st.pack(">HHHHHH", qid, 0x0100, 1, 0, 0, 0)
               + self._encode_name(self.srv_name) + st.pack(">HH", self.SRV, self.IN))
        host, port, fam = self._resolver_addr()
        with socket.socket(fam, socket.SOCK_DGRAM) as s:
            s.settimeout(self.timeout_s)
            s.sendto(msg, (host, port))
            buf, _ = s.recvfrom(4096)
        rid, flags, qd, an, _ns, _ar = st.unpack(">HHHHHH", buf[:12])
        if rid != qid:
            raise ValueError("DNS response id mismatch")
        if flags & 0x0200:
            # TC: the SRV RRset exceeded the UDP payload — a silently partial
            # peer list would bootstrap an undersized world
            raise ValueError(
                "truncated DNS response (TC): SRV record set too large for "
                "UDP; configure fewer/shorter records or a TCP-capable "
                "registrar (ConsulSeedDiscovery)")
        rcode = flags & 0x000F
        if rcode:
            # SERVFAIL/NXDOMAIN etc must not read as an empty (healthy) seed
            # list — that bootstraps a single-node world silently
            raise ValueError(
                f"DNS SRV query for {self.srv_name!r} failed with rcode "
                f"{rcode}")
        off = 12
        for _ in range(qd):                   # skip the echoed question
            _, off = self._read_name(buf, off)
            off += 4
        out = []
        for _ in range(an):
            _, off = self._read_name(buf, off)
            rtype, _cls, _ttl, rdlen = st.unpack(">HHIH", buf[off:off + 10])
            off += 10
            if rtype == self.SRV:
                prio, weight, port = st.unpack(">HHH", buf[off:off + 6])
                target, _ = self._read_name(buf, off + 6)
                out.append((prio, weight, port, target))
            off += rdlen
        return out

    def discover(self) -> list[str]:
        return sorted(f"{target}:{port}"
                      for _p, _w, port, target in self.query_srv())


class ConsulSeedDiscovery(SeedDiscovery):
    """Registration-based discovery against a Consul-compatible HTTP registry
    (ref: ConsulClusterSeedDiscovery.scala + ConsulClient.scala:5 — nodes
    register a service and discover peers from the catalog).

    Liveness: each registration stamps a heartbeat timestamp into the service
    Meta; ``discover()`` drops entries whose stamp is older than ``stale_s``
    (the FileRegistrarDiscovery expiry rule — a crashed node must not inflate
    the resolved world forever). Entries registered by other tooling (no
    stamp) are kept: their lifecycle belongs to Consul's own health checks.
    Shard-ownership ``claims`` ride Meta too, so rejoining nodes adopt the
    incumbent assignment exactly as with the file registrar."""

    def __init__(self, base_url: str, service: str = "filodb",
                 timeout_s: float = 5.0, stale_s: float = 30.0):
        self.base = base_url.rstrip("/")
        self.service = service
        self.timeout_s = timeout_s
        self.stale_s = stale_s

    def _http(self, method: str, path: str, body: dict | None = None):
        import urllib.request
        req = urllib.request.Request(
            self.base + path, method=method,
            data=json.dumps(body).encode() if body is not None else None,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
            raw = r.read()
        return json.loads(raw) if raw else None

    def register(self, addr: str, claims: dict | None = None,
                 http: str | None = None, gossip: str | None = None) -> None:
        host, port_s = addr.rsplit(":", 1)
        meta = {"filodb_ts": str(time.time()),
                "filodb_claims": json.dumps(claims or {})}
        if http:
            meta["filodb_http"] = http
        if gossip:
            meta["filodb_gossip"] = gossip
        self._http("PUT", "/v1/agent/service/register", {
            "Name": self.service, "ID": f"{self.service}-{addr}",
            "Address": host, "Port": int(port_s), "Meta": meta})

    heartbeat = register     # re-registration refreshes the timestamp

    def deregister(self, addr: str) -> None:
        self._http("PUT",
                   f"/v1/agent/service/deregister/{self.service}-{addr}")

    def _live_rows(self):
        rows = self._http("GET", f"/v1/catalog/service/{self.service}") or []
        now = time.time()
        for r in rows:
            meta = (r.get("ServiceMeta") or r.get("Meta") or {})
            ts = meta.get("filodb_ts")
            if ts is not None and now - float(ts) > self.stale_s:
                continue      # our own dead entry; foreign entries stay
            yield r, meta

    def discover(self) -> list[str]:
        out = set()
        for r, _meta in self._live_rows():
            host = r.get("ServiceAddress") or r.get("Address")
            port = r.get("ServicePort")
            if host and port:
                out.add(f"{host}:{port}")
        return sorted(out)

    def claims(self) -> dict[str, dict]:
        """Live members' shard-ownership claims (FileRegistrar API twin)."""
        out = {}
        for r, meta in self._live_rows():
            host = r.get("ServiceAddress") or r.get("Address")
            port = r.get("ServicePort")
            if host and port:
                try:
                    out[f"{host}:{port}"] = json.loads(
                        meta.get("filodb_claims") or "{}")
                except ValueError:
                    out[f"{host}:{port}"] = {}
        return out

    def endpoints(self) -> dict[str, str]:
        """Live members' published HTTP endpoints (FileRegistrar API twin)."""
        out = {}
        for r, meta in self._live_rows():
            host = r.get("ServiceAddress") or r.get("Address")
            port = r.get("ServicePort")
            if host and port and meta.get("filodb_http"):
                out[f"{host}:{port}"] = meta["filodb_http"]
        return out

    def gossips(self) -> dict[str, str]:
        """Live members' published gossip endpoints (FileRegistrar twin)."""
        out = {}
        for r, meta in self._live_rows():
            host = r.get("ServiceAddress") or r.get("Address")
            port = r.get("ServicePort")
            if host and port and meta.get("filodb_gossip"):
                out[f"{host}:{port}"] = meta["filodb_gossip"]
        return out


# --------------------------------------------------------------------------
# Bootstrap: discovery -> torch.distributed world
# --------------------------------------------------------------------------

@dataclass
class ClusterWorld:
    """The agreed process-group topology."""
    coordinator: str          # host:port of process 0
    num_processes: int
    process_id: int
    members: list[str]        # sorted member addresses

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0


class ClusterBootstrap:
    """Join-or-become-seed (ref: AkkaBootstrapper.bootstrap): discover peers,
    derive a deterministic world, and (optionally) bring up a
    ``torch.distributed`` process group."""

    def __init__(self, discovery: SeedDiscovery, self_addr: str,
                 settle_s: float = 0.0):
        self.discovery = discovery
        self.self_addr = self_addr
        self.settle_s = settle_s

    def resolve_world(self, min_members: int = 1,
                      timeout_s: float = 30.0) -> ClusterWorld:
        """Register, wait for at least ``min_members`` peers to appear (the
        akka-bootstrapper expected-contact-points analog), and compute the
        world. Deterministic across members: everyone sorts the same member
        list, so everyone agrees on coordinator and ranks without an election."""
        self.discovery.register(self.self_addr)
        if self.settle_s:
            time.sleep(self.settle_s)
        deadline = time.monotonic() + timeout_s
        while True:
            members = self.discovery.discover()
            if self.self_addr not in members:
                members = sorted(members + [self.self_addr])
            if len(members) >= min_members or time.monotonic() >= deadline:
                break
            time.sleep(0.2)
        if len(members) < min_members:
            raise TimeoutError(
                f"only {len(members)}/{min_members} members after {timeout_s}s")
        return ClusterWorld(coordinator=members[0], num_processes=len(members),
                            process_id=members.index(self.self_addr),
                            members=members)

    def initialize_torch(self, world: ClusterWorld | None = None,
                         timeout_s: float = 120.0) -> ClusterWorld:
        """Bring up a ``torch.distributed`` process group for a world of
        more than one process (a single-process world skips it). The
        coordinator's address is the rendezvous (its rank-0 process serves
        the TCP store there). The backend is Gloo: its collectives run on
        host tensors, and it accepts several ranks sharing one card, which
        NCCL refuses; the partials a rank reduces are host arrays anyway."""
        import datetime

        import torch.distributed as dist
        world = world or self.resolve_world()
        if world.num_processes > 1 and not dist.is_initialized():
            dist.init_process_group(
                backend="gloo", init_method=f"tcp://{world.coordinator}",
                world_size=world.num_processes, rank=world.process_id,
                timeout=datetime.timedelta(seconds=timeout_s))
        return world


# --------------------------------------------------------------------------
# Membership + heartbeat failure detection -> ShardManager reassignment
# --------------------------------------------------------------------------

class MembershipMonitor(threading.Thread):
    """Heartbeats this node into the registrar and watches peers' timestamps;
    a silent peer is reported down (ref: Akka gossip deathwatch ->
    ShardManager.remove_node auto-reassignment, doc/sharding.md
    'Automatic Reassignment')."""

    def __init__(self, registrar: FileRegistrarDiscovery, self_addr: str,
                 on_down, on_up=None, on_self_stale=None, interval_s: float = 5.0):
        super().__init__(daemon=True, name="membership-monitor")
        self.registrar = registrar
        self.self_addr = self_addr
        self.on_down = on_down
        self.on_up = on_up
        # optional provider of this node's shard-ownership claims, published
        # with every heartbeat so late joiners adopt the incumbent assignment
        self.claims_fn = None
        # this node's HTTP endpoint ("host:port"), published with heartbeats
        # so peers can dispatch query subtrees here (query/wire.py)
        self.http_addr: str | None = None
        # this node's membership-gossip endpoint, published the same way so
        # peers' GossipAgents can probe it (cluster/membership.py)
        self.gossip_addr: str | None = None
        # fired when OUR OWN heartbeat gap exceeded stale_s — peers have
        # declared us dead and reassigned our shards, so we must fail-stop
        # (the Akka quarantine analog: a removed-but-alive node restarts)
        self.on_self_stale = on_self_stale
        # optional per-poll claims reconciliation: fired with (peer, claims)
        # for every live peer's published shard ownership, so a rebalance
        # cutover on two nodes propagates to every other node's map
        self.on_claims = None
        self.interval_s = interval_s
        self._stop_ev = threading.Event()
        self._known: set[str] = set()
        self._last_beat: float | None = None

    def poll_once(self) -> None:
        now = time.monotonic()
        if (self._last_beat is not None
                and now - self._last_beat > self.registrar.stale_s
                and self.on_self_stale is not None):
            # do NOT heartbeat: peers already consider us dead — re-announcing
            # while still holding shards would create double ownership
            self._stop_ev.set()
            self.on_self_stale()
            return
        self._beat()
        self._last_beat = now
        live = set(self.registrar.discover())
        for gone in sorted(self._known - live - {self.self_addr}):
            self.on_down(gone)
        if self.on_up is not None:
            for fresh in sorted(live - self._known):
                self.on_up(fresh)
        self._known = live
        if self.on_claims is not None and hasattr(self.registrar, "claims"):
            for peer, peer_claims in sorted(self.registrar.claims().items()):
                if peer != self.self_addr:
                    self.on_claims(peer, peer_claims)

    def _beat(self) -> None:
        claims = self.claims_fn() if self.claims_fn is not None else None
        if self.gossip_addr is not None:
            try:
                self.registrar.heartbeat(self.self_addr, claims,
                                         http=self.http_addr,
                                         gossip=self.gossip_addr)
                return
            except TypeError:
                pass     # registrar predating gossip publication
        try:
            self.registrar.heartbeat(self.self_addr, claims,
                                     http=self.http_addr)
            return
        except TypeError:
            pass     # custom registrar predating endpoint/claims publication
        if claims is not None:
            try:
                self.registrar.heartbeat(self.self_addr, claims)
                return
            except TypeError:
                pass
        self.registrar.heartbeat(self.self_addr)

    def publish_now(self) -> None:
        """Push a fresh heartbeat (with current claims) immediately — called
        on assignment changes so joiners reading the registrar see takeover
        state without waiting out the heartbeat interval."""
        try:
            self._beat()
        except Exception:
            log.exception("claim publish failed")

    def run(self) -> None:
        # a transient registrar error (e.g. OSError on a shared/NFS heartbeat
        # file) must not silently kill the monitor thread: the node would stop
        # heartbeating but never reach the self-stale check, so peers would
        # reassign its shards WHILE it keeps ingesting — the exact double-
        # ownership the quarantine exists to prevent. Failed polls leave
        # _last_beat unset, so a lapse long enough trips on_self_stale above.
        while not self._stop_ev.wait(self.interval_s):
            try:
                self.poll_once()
            except Exception:
                log.exception("membership poll failed; treating as a missed "
                              "heartbeat")

    def stop(self) -> None:
        self._stop_ev.set()


def free_port(host: str = "127.0.0.1") -> int:
    """A free TCP port (the process group's rendezvous, a test server)."""
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]
