"""Ingest cardinality governance: per-tenant active-series accounting and
the series-birth limiter.

Host copy of ``filodb_tpu/core/cardinality.py`` (pure Python; imports
re-pointed at the port's metrics registry). The shard consults it at every
series birth (``TimeSeriesShard.governor``); recovery's ``adopt`` calls
arrive with the port's durable sink, and the gateway and remote-write edges
with its ingest and HTTP layers.

Reference: the reference's cardinality-buster postmortems — one tenant with a
label explosion (a request-id tag, a per-pod metric) evicts everyone else's
series. The multi-tenant defense is governance at series BIRTH: samples for
EXISTING series always land, but a tenant at its active-series quota cannot
create NEW part keys — the shard sheds the birth (typed RETRY at the gateway,
429 + Retry-After at remote-write) and the tenant's existing dashboards keep
working.

The governor is authoritative at the shard (``TimeSeriesShard`` consults it
under the shard lock at every series creation); the gateway and remote-write
edges use it as an ADVISORY fast-shed — they only shed a series they can
prove is both over-quota and new, so an edge can never drop samples for an
existing series (the hard guarantee lives at the shard)."""

from __future__ import annotations

import threading

from ..utils.metrics import (FILODB_TENANT_ACTIVE_SERIES,
                             FILODB_TENANT_SERIES_SHED, registry)

DEFAULT_TENANT = "default"


class SeriesQuotaExceeded(RuntimeError):
    """A tenant at its active-series quota tried to create NEW series.
    Retryable-after-churn: existing-series samples were NOT dropped — the
    HTTP edge answers 429 + Retry-After, the gateway's strict mode raises
    this typed error in place of a silent drop."""

    def __init__(self, tenant: str, shed: int = 1,
                 retry_after_s: float = 30.0):
        super().__init__(
            f"tenant {tenant!r} is at its active-series quota; {shed} new "
            f"series shed (samples for existing series were ingested) — "
            f"retry after {retry_after_s:.0f}s or expire old series")
        self.tenant = tenant
        self.shed = int(shed)
        self.retry_after_s = float(retry_after_s)


class CardinalityGovernor:
    """Per-tenant active-series gauge + birth limiter for one dataset.

    ONE instance per dataset per node, shared by every local shard and the
    ingest edges: `admit` / `adopt` / `retire` mutate the count under an
    internal lock (shards call them under their own shard locks — the
    governor lock is leaf-level and never held around other locks), and
    ``over_limit`` is the edges' lock-free advisory probe."""

    def __init__(self, max_series_per_tenant: int | None,
                 tenant_label: str = "_ws_", dataset: str = "",
                 retry_after_s: float = 30.0):
        self.limit = (int(max_series_per_tenant)
                      if max_series_per_tenant is not None else None)
        self.tenant_label = tenant_label
        self.dataset = dataset
        self.retry_after_s = float(retry_after_s)
        self._lock = threading.Lock()
        self._active: dict[str, int] = {}
        self._gauges: dict[str, object] = {}

    def tenant_of(self, labels) -> str:
        """Tenant identity of a label set (the workspace label by default;
        labels may be a dict or a sorted (k, v) tuple from a route memo)."""
        if isinstance(labels, dict):
            return labels.get(self.tenant_label, DEFAULT_TENANT)
        for k, v in labels:
            if k == self.tenant_label:
                return v
        return DEFAULT_TENANT

    def tenant_from_key_bytes(self, blob: bytes) -> str:
        """Tenant straight from canonical part-key bytes — the bulk
        recovery path adopts millions of keys and must not build a dict
        per key just to read one label."""
        lbl = self.tenant_label.encode()
        if blob.startswith(lbl + b"\x01"):
            at = len(lbl) + 1
        else:
            p = blob.find(b"\x00" + lbl + b"\x01")
            if p < 0:
                return DEFAULT_TENANT
            at = p + len(lbl) + 2
        end = blob.find(b"\x00", at)
        raw = blob[at:] if end < 0 else blob[at:end]
        return raw.decode("utf-8", "replace")

    def _gauge(self, tenant: str):
        g = self._gauges.get(tenant)
        if g is None:
            g = self._gauges[tenant] = registry.gauge(
                FILODB_TENANT_ACTIVE_SERIES,
                {"dataset": self.dataset, "tenant": tenant})
        return g

    def admit(self, tenant: str) -> bool:
        """Reserve one active-series slot for a NEW series; False = shed
        (the caller must not create the series and counts the shed)."""
        with self._lock:
            n = self._active.get(tenant, 0)
            if self.limit is not None and n >= self.limit:
                return False
            self._active[tenant] = n + 1
        self._gauge(tenant).update(n + 1)
        return True

    def admit_block(self, tenant: str, n: int) -> bool:
        """All-or-nothing reservation for a bulk registration batch; False
        sends the caller to the per-key path, which sheds precisely."""
        with self._lock:
            have = self._active.get(tenant, 0)
            if self.limit is not None and have + n > self.limit:
                return False
            self._active[tenant] = have + n
        self._gauge(tenant).update(have + n)
        return True

    def adopt(self, tenant: str, n: int = 1) -> None:
        """Count series that pre-exist (recovery, takeover warm-up): they
        are active regardless of the limit — governance applies to births,
        never to data already owned."""
        with self._lock:
            total = self._active.get(tenant, 0) + n
            self._active[tenant] = total
        self._gauge(tenant).update(total)

    def retire(self, tenant: str, n: int = 1) -> None:
        """Release slots on purge/eviction/release — churned-out series
        make room for the tenant's next births."""
        with self._lock:
            total = max(self._active.get(tenant, 0) - n, 0)
            self._active[tenant] = total
        self._gauge(tenant).update(total)

    def over_limit(self, tenant: str) -> bool:
        """Advisory probe for the ingest edges (no reservation)."""
        if self.limit is None:
            return False
        return self._active.get(tenant, 0) >= self.limit

    def active(self, tenant: str) -> int:
        return self._active.get(tenant, 0)

    def count_shed(self, site: str, tenant: str, n: int = 1) -> None:
        registry.counter(FILODB_TENANT_SERIES_SHED,
                         {"dataset": self.dataset, "site": site,
                          "tenant": tenant}).increment(n)
