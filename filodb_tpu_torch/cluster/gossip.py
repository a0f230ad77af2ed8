"""Cluster wire ops: gossip digests, epoch claims, REJOIN log sync.

The op family rides the broker's existing TCP framing (``_REQ``/``_RESP``
little-endian structs) so the replicated broker tier serves it natively —
``BrokerServer._serve`` delegates ops in :data:`CLUSTER_OPS` here exactly
like it delegates ``OP_REPLICATE`` — while membership-only nodes (the
standalone servers' gossip agents) host the same dispatch through the
lightweight :class:`GossipServer`.

Ops (values 17+ keep clear air from broker client ops 1-4 and
``OP_REPLICATE`` = 16; sender+receiver parity and value collisions are
checked by filolint's op-parity rule over this module):

  ``OP_GOSSIP``      membership digest exchange: payload and response are
                     JSON digests (see membership.MembershipTable.merge).
  ``OP_EPOCH_READ``  current (epoch, owner) of one partition — response
                     offset field = epoch, body = owner address.
  ``OP_EPOCH_LEAD``  ask the TARGET node to claim leadership of the
                     partition: it reads reachable replicas' epochs, bumps
                     to max+1, persists, and announces to the others.
  ``OP_EPOCH_SET``   peer announce: adopt (epoch, owner) iff higher.
  ``OP_SYNC``        REJOIN catch-up read: the leader's log tail with
                     journaled pub-ids from a given offset (the repair
                     currency of truncate-and-catch-up).
"""

from __future__ import annotations

import json
import logging
import socket
import socketserver
import threading

from ..ingest.broker import _REQ, _RESP, ST_ERR, ST_OK
from ..utils.netio import recv_exact as _recv_exact
from ..utils.tracing import SPAN_CLUSTER_LEAD, span

log = logging.getLogger("filodb_tpu_torch.cluster")

OP_GOSSIP = 17
OP_EPOCH_READ = 18
OP_EPOCH_LEAD = 19
OP_EPOCH_SET = 20
OP_SYNC = 21

CLUSTER_OPS = frozenset({OP_GOSSIP, OP_EPOCH_READ, OP_EPOCH_LEAD,
                         OP_EPOCH_SET, OP_SYNC})

_MAX_SYNC_BYTES = 4 << 20       # per-OP_SYNC response bound (repair chunks)


class ClusterError(RuntimeError):
    """The peer answered a cluster op with a typed error."""


def fence_message(part: int, epoch: int, owner: str) -> str:
    """The ONE fenced-refusal message shape, parsed by :func:`parse_fenced`
    on brokers and clients — a one-sided format change cannot desync the
    fleet."""
    return f"fenced: partition {part} epoch {epoch} owner {owner}"


def parse_fenced(msg: str) -> tuple[int, int, str] | None:
    """(partition, epoch, owner) from a fenced refusal, or None."""
    import re
    m = re.match(r"fenced: partition (\d+) epoch (\d+) owner (\S*)", msg)
    if not m:
        return None
    return int(m.group(1)), int(m.group(2)), m.group(3)


def _ok(offset: int = 0, body: bytes = b"") -> bytes:
    return _RESP.pack(ST_OK, offset, len(body)) + body


def _err(msg: str) -> bytes:
    raw = msg.encode()[:1024]
    return _RESP.pack(ST_ERR, 0, len(raw)) + raw


def lead_partition(host, part: int) -> int:
    """Claim leadership of ``part`` for ``host`` (a BrokerServer): read
    reachable replicas' epochs, bump past the max, persist locally, then
    announce to the reachable replicas (best effort — an unreachable peer
    adopts from the first replicate batch or its own REJOIN probe).
    Returns the new epoch."""
    epochs = host.epochs
    if epochs is None:
        raise ClusterError("epoch fencing not enabled on this node")
    self_addr = host.self_addr
    with span(SPAN_CLUSTER_LEAD, partition=part) as tags:
        cur, _owner = epochs.get(part)
        peers = [a for a in host.cluster_peers(part) if a != self_addr]
        for addr in peers:
            try:
                e, _o = ClusterLink(addr).epoch_read(part)
                cur = max(cur, e)
            except (ConnectionError, OSError, ClusterError):
                continue        # unreachable/refusing peer: claim proceeds
        new = cur + 1
        epochs.adopt(part, new, self_addr)
        for addr in peers:
            try:
                ClusterLink(addr).epoch_set(part, new, self_addr)
            except (ConnectionError, OSError, ClusterError):
                continue        # it adopts from replication or REJOIN
        tags["epoch"] = new
    return new


def serve_cluster(host, op: int, part: int, payload: bytes) -> bytes:
    """Server-side dispatch for the cluster op family. ``host`` is a
    BrokerServer (epochs + partition logs, optionally membership) or a
    GossipServer (membership only) — ops a host cannot serve answer a
    typed error instead of severing."""
    if op == OP_GOSSIP:
        table = getattr(host, "membership", None)
        if table is None:
            return _err("gossip not enabled on this node")
        try:
            digest = json.loads(payload)
        except ValueError as e:
            return _err(f"malformed gossip digest: {e}")
        resp = table.merge(digest)
        return _ok(body=json.dumps(resp, separators=(",", ":")).encode())
    epochs = getattr(host, "epochs", None)
    if op == OP_EPOCH_READ:
        if epochs is None:
            return _err("epoch fencing not enabled on this node")
        e, owner = epochs.get(part)
        return _ok(e, owner.encode())
    if op == OP_EPOCH_SET:
        if epochs is None:
            return _err("epoch fencing not enabled on this node")
        try:
            d = json.loads(payload)
            epochs.adopt(part, int(d["epoch"]), str(d["owner"]))
        except (ValueError, KeyError, TypeError) as e:
            return _err(f"malformed epoch announce: {e}")
        e, owner = epochs.get(part)
        return _ok(e, owner.encode())
    if op == OP_EPOCH_LEAD:
        try:
            return _ok(lead_partition(host, part))
        except ClusterError as e:
            return _err(str(e))
    if op == OP_SYNC:
        from ..ingest.replication import pack_entries
        parts = getattr(host, "_parts", None)
        if parts is None or not 0 <= part < len(parts):
            return _err(f"no partition {part} on this node")
        try:
            frm = int(json.loads(payload)["from"])
        except (ValueError, KeyError, TypeError) as e:
            return _err(f"malformed sync request: {e}")
        with host._publish_locks[part]:
            end = parts[part].end_offset
            entries = host._frames_with_ids(part, frm, end, _MAX_SYNC_BYTES)
        return _ok(end, pack_entries(entries))
    return _err(f"unknown cluster op {op}")


class ClusterLink:
    """Client for the cluster op family against one node (a broker or a
    gossip agent). Control-plane rate is low, so every request uses a
    transient bounded connection — no pooled socket to leak or sever."""

    def __init__(self, addr: str, timeout_s: float = 3.0, fault_plan=None):
        host, _, port = addr.rpartition(":")
        self.addr = addr
        self._addr = (host or "127.0.0.1", int(port))
        self.timeout_s = float(timeout_s)
        self.fault_plan = fault_plan

    def _request(self, op: int, part: int,
                 payload: bytes = b"") -> tuple[int, bytes]:
        with socket.create_connection(self._addr,
                                      timeout=self.timeout_s) as s:
            s.settimeout(self.timeout_s)
            s.sendall(_REQ.pack(op, part, 0, len(payload)) + payload)
            st, off, rlen = _RESP.unpack(_recv_exact(s, _RESP.size))
            body = _recv_exact(s, rlen) if rlen else b""
        if st != ST_OK:
            raise ClusterError(body.decode(errors="replace"))
        return off, body

    def gossip(self, digest: dict, round_no: int = 0) -> dict:
        """Exchange membership digests; returns the peer's digest. The
        FaultPlan ``gossip`` site drops the nth probe deterministically
        (offset carries the round counter for at_offset rules)."""
        if self.fault_plan is not None:
            act = self.fault_plan.decide("gossip", offset=round_no)
            if act is not None and act.action == "drop":
                raise ConnectionError("fault: gossip probe dropped")
        _off, body = self._request(
            OP_GOSSIP, 0, json.dumps(digest, separators=(",", ":")).encode())
        resp = json.loads(body)
        if not isinstance(resp, dict):
            raise ClusterError("malformed gossip response")
        return resp

    def epoch_read(self, part: int) -> tuple[int, str]:
        off, body = self._request(OP_EPOCH_READ, part)
        return off, body.decode()

    def epoch_lead(self, part: int) -> int:
        off, _body = self._request(OP_EPOCH_LEAD, part)
        return off

    def epoch_set(self, part: int, epoch: int, owner: str) -> int:
        off, _body = self._request(
            OP_EPOCH_SET, part,
            json.dumps({"epoch": int(epoch), "owner": owner},
                       separators=(",", ":")).encode())
        return off

    def sync(self, part: int, from_off: int) -> tuple[int, list]:
        """(leader end offset, [(offset, pub_id, frame)]) from
        ``from_off`` — one bounded repair chunk."""
        from ..ingest.replication import _RENTRY
        end, body = self._request(
            OP_SYNC, part,
            json.dumps({"from": int(from_off)},
                       separators=(",", ":")).encode())
        entries = []
        pos = 0
        while pos < len(body):
            off, pid, _crc, ln = _RENTRY.unpack_from(body, pos)
            pos += _RENTRY.size
            frame = body[pos:pos + ln]
            pos += ln
            if len(frame) < ln:
                raise ClusterError(
                    f"torn sync frame at offset {off} (short read)")
            entries.append((off, pid, frame))
        return end, entries


class GossipServer:
    """Minimal TCP host for the cluster op family on membership-only nodes
    (standalone servers): same framing and dispatch as the broker, no
    partition logs. ``host_obj`` provides ``membership`` (and optionally
    ``epochs``)."""

    def __init__(self, host_obj, host: str = "127.0.0.1", port: int = 0):
        self.host_obj = host_obj
        self._conns: set[socket.socket] = set()
        self._conns_lock = threading.Lock()
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def setup(self):
                with outer._conns_lock:
                    outer._conns.add(self.request)

            def finish(self):
                with outer._conns_lock:
                    outer._conns.discard(self.request)

            def handle(self):
                try:
                    while True:
                        hdr = _recv_exact(self.request, _REQ.size)
                        op, part, _off, plen = _REQ.unpack(hdr)
                        if plen > (1 << 20):
                            return      # hostile frame: drop connection
                        payload = _recv_exact(self.request, plen) \
                            if plen else b""
                        if op in CLUSTER_OPS:
                            resp = serve_cluster(outer.host_obj, op, part,
                                                 payload)
                        else:
                            resp = _err(f"unknown op {op}")
                        self.request.sendall(resp)
                except (ConnectionError, OSError):
                    return

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = Server((host, port), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="filo-gossip")

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> "GossipServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass    # racing close: the connection is already gone
            try:
                c.close()
            except OSError:
                pass    # racing close: the connection is already gone
        self._thread.join(timeout=3)
