"""Deterministic fault injection for the ingest plane.

Reference posture: the reference validates its Kafka ingestion with
chaos-style integration jobs; here faults are FIRST-CLASS and deterministic
so tier-1 tests (and the ``ingest_soak`` bench scenario) can kill a leader
at an exact log offset, drop exactly the 3rd response, or corrupt exactly
one replication frame — with NO wall-clock dependence and NO luck.

A :class:`FaultPlan` is a list of :class:`FaultRule`. Hook sites call
``plan.decide(site, partition=..., op=..., offset=...)``; matching is
COUNTER-based (the nth matching event at that site fires the rule), so a
plan replays identically run to run. The plan's RNG exists only for
actions that need bytes to corrupt — seeded, never time-derived.

Hook sites wired in this package:

  ``append``      broker, after a partition append (ctx: partition, offset
                  = new end offset) — ``kill_server`` implements
                  kill-at-offset leader death.
  ``serve``       broker, before sending a response (ctx: partition, op) —
                  ``drop_response`` severs without replying (the
                  lost-response shape), ``delay`` holds the response.
  ``replicate``   leader->follower stream, before sending a frame batch —
                  ``torn_write`` truncates mid-frame and severs,
                  ``corrupt`` flips a payload byte (CRC mismatch at the
                  follower), ``drop`` fails the send outright.
  ``client_recv`` BrokerBus, between send and response read —
                  ``drop_response`` closes the socket (client-side lost
                  response; the windowed publisher must replay).
"""

from __future__ import annotations

import random
import threading


class FaultRule:
    """One deterministic fault: fire on the nth..nth+count-1 matching
    events at ``site``. ``partition``/``op`` filter events; ``at_offset``
    matches only events whose offset reached it (kill-at-offset)."""

    __slots__ = ("site", "action", "nth", "count", "partition", "op",
                 "at_offset", "delay_s")

    def __init__(self, site: str, action: str, nth: int = 1, count: int = 1,
                 partition: int | None = None, op: int | None = None,
                 at_offset: int | None = None, delay_s: float = 0.0):
        self.site = site
        self.action = action
        self.nth = int(nth)
        self.count = count          # None = keep firing forever
        self.partition = partition
        self.op = op
        self.at_offset = at_offset
        self.delay_s = float(delay_s)

    def matches(self, partition, op, offset) -> bool:
        if self.partition is not None and partition != self.partition:
            return False
        if self.op is not None and op != self.op:
            return False
        if self.at_offset is not None and (offset is None
                                           or offset < self.at_offset):
            return False
        return True


class FaultPlan:
    """Deterministic fault schedule. ``decide`` returns the fired rule (or
    None); ``fired`` logs every firing for test assertions."""

    def __init__(self, rules: list[FaultRule] | tuple = (), seed: int = 0):
        self.rules = list(rules)
        self.rng = random.Random(seed)      # NEVER wall-clock seeded
        self.fired: list[tuple[str, str, dict]] = []
        self._counts: dict[int, int] = {}   # rule id -> matching events seen
        self._lock = threading.Lock()

    @classmethod
    def from_spec(cls, spec: list[dict] | None, seed: int = 0) -> "FaultPlan":
        """Build from config (``ingest.faults``): a list of rule dicts with
        the FaultRule field names."""
        rules = [FaultRule(**dict(r)) for r in (spec or [])]
        return cls(rules, seed=seed)

    def decide(self, site: str, partition=None, op=None,
               offset=None) -> FaultRule | None:
        with self._lock:
            for i, r in enumerate(self.rules):
                if r.site != site or not r.matches(partition, op, offset):
                    continue
                n = self._counts.get(i, 0) + 1
                self._counts[i] = n
                if n < r.nth:
                    continue
                if r.count is not None and n >= r.nth + r.count:
                    continue
                self.fired.append((site, r.action,
                                   {"partition": partition, "op": op,
                                    "offset": offset, "event": n}))
                return r
        return None

    def corrupt(self, payload: bytes) -> bytes:
        """Flip one byte (position from the seeded RNG — deterministic for
        a given plan instance and call sequence)."""
        if not payload:
            return payload
        i = self.rng.randrange(len(payload))
        b = bytearray(payload)
        b[i] ^= 0xFF
        return bytes(b)


def plan_from_config(cfg) -> FaultPlan | None:
    """``ingest.faults`` config -> FaultPlan (None when no rules: the hot
    paths skip the hook entirely)."""
    spec = cfg.get("ingest.faults")
    if not spec:
        return None
    return FaultPlan.from_spec(spec)
