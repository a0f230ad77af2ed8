"""The per-tenant cardinality governor at series birth, in both packages.

The governor class is host Python copied from the reference; its shard
hooks are the port's. The same containers (each package's RecordBuilder,
the same labels and samples) go through a governed shard in each package:
per-key births, bulk registration, a release by eviction. Shed counts,
``num_series``, the tenants' active counts, the samples each series holds
and the exported gauges and counters must equal the reference's (exact:
everything compared is an integer).
"""

import pytest

from filodb_tpu.core import cardinality as jcard
from filodb_tpu.core.memstore import StoreConfig as JStoreConfig
from filodb_tpu.core.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.core.record import RecordBuilder as JRecordBuilder
from filodb_tpu.core.schemas import GAUGE as JGAUGE
from filodb_tpu.utils import metrics as jmetrics
from filodb_tpu_torch.core import cardinality as tcard
from filodb_tpu_torch.core.memstore import StoreConfig, TimeSeriesMemStore
from filodb_tpu_torch.core.record import RecordBuilder
from filodb_tpu_torch.core.schemas import GAUGE
from filodb_tpu_torch.utils import metrics as tmetrics
from tests.test_torch_result_cache import fresh_dataset

BASE = 1_700_000_000_000
PKGS = {
    "jax": (JMemStore, JStoreConfig, JRecordBuilder, JGAUGE, jcard, jmetrics,
            {}),
    "torch": (TimeSeriesMemStore, StoreConfig, RecordBuilder, GAUGE, tcard,
              tmetrics, {"device": "cpu"}),
}


def governed_shard(pkg: str, ds: str, limit, n: int = 256):
    """A shard with a governor attached (``limit`` None: accounting
    without a quota)."""
    ms_cls, cfg_cls, _rb, schema, card, _m, dev = PKGS[pkg]
    ms = ms_cls(**dev)
    sh = ms.setup(ds, schema, 0, cfg_cls(
        max_series_per_shard=n, samples_per_series=64,
        flush_batch_size=10**9, **dev))
    sh.governor = card.CardinalityGovernor(limit, dataset=ds)
    return sh, sh.governor


def container(pkg: str, tenant: str, names, ts=BASE, value=1.0):
    _ms, _cfg, rb, schema, *_ = PKGS[pkg]
    b = rb(schema)
    for nm in names:
        b.add({"_metric_": "m", "_ws_": tenant, "_ns_": "app", "host": nm},
              ts, value)
    return b.build()


def batch(pkg: str, tenant: str, n: int, prefix: str = "h"):
    _ms, _cfg, rb, schema, *_ = PKGS[pkg]
    b = rb(schema)
    b.add_series_batch({"_metric_": "m", "_ws_": tenant,
                        "host": [f"{prefix}{i}" for i in range(n)]}, BASE, 1.0)
    return b.build()


def state(sh, gov, tenants) -> tuple:
    sh.flush()
    return (sh.num_series, sh.stats.series_quota_shed,
            sh.stats.partitions_evicted,
            {t: gov.active(t) for t in tenants},
            sorted(int(n) for n in sh.store.n_host[sh.store.n_host > 0]))


def run_both(scenario) -> dict:
    """``scenario(pkg, ds)`` on each package, each with its own dataset
    name (the gauges are process-global, tagged by dataset)."""
    return {pkg: scenario(pkg, fresh_dataset("card")) for pkg in PKGS}


def test_governor_class_matches_the_reference():
    def seq(card):
        gov = card.CardinalityGovernor(2, dataset=fresh_dataset("gov"))
        out = [gov.admit("t"), gov.admit("t"), gov.admit("t"),
               gov.over_limit("t")]
        gov.retire("t")
        out += [gov.over_limit("t"), gov.admit("t")]
        gov.adopt("t", 5)
        out += [gov.active("t"), gov.admit_block("u", 3),
                gov.admit_block("u", 2), gov.active("u")]
        out += [gov.tenant_of({"_ws_": "acme", "x": "1"}),
                gov.tenant_of((("_ws_", "acme"), ("x", "1"))),
                gov.tenant_of({"x": "1"}),
                gov.tenant_from_key_bytes(b"_metric_\x01m\x00_ws_\x01acme"),
                gov.tenant_from_key_bytes(b"_ws_\x01beta\x00x\x011"),
                gov.tenant_from_key_bytes(b"x\x011")]
        free = card.CardinalityGovernor(None)
        out += [free.admit("anyone"), free.over_limit("anyone")]
        e = card.SeriesQuotaExceeded("acme", shed=3, retry_after_s=5.0)
        out += [str(e), e.shed, e.retry_after_s]
        return out

    got, ref = seq(tcard), seq(jcard)
    assert got == ref
    assert got[:4] == [True, True, False, True]


def test_shard_sheds_new_series_never_existing_samples():
    def scenario(pkg, ds):
        sh, gov = governed_shard(pkg, ds, 3)
        out = []
        sh.ingest(container(pkg, "acme", [f"h{i}" for i in range(3)]))
        out.append(state(sh, gov, ["acme"]))
        # 3 existing series + 2 new over the quota: only the new shed
        sh.ingest(container(pkg, "acme", [f"h{i}" for i in range(5)],
                            ts=BASE + 10_000))
        out.append(state(sh, gov, ["acme"]))
        sh.ingest(container(pkg, "beta", ["b0"]))
        out.append(state(sh, gov, ["acme", "beta"]))
        metrics = PKGS[pkg][5]
        out.append(metrics.registry.gauge(
            metrics.FILODB_TENANT_ACTIVE_SERIES,
            {"dataset": ds, "tenant": "acme"}).value)
        out.append(metrics.registry.counter(
            metrics.FILODB_TENANT_SERIES_SHED,
            {"dataset": ds, "site": "shard", "tenant": "acme"}).value)
        return out

    res = run_both(scenario)
    assert res["torch"] == res["jax"]
    assert res["torch"][1][:2] == (3, 2)
    assert res["torch"][1][4] == [2, 2, 2]    # both rounds of samples landed


def test_bulk_registration_takes_the_block_reservation():
    def scenario(pkg, ds):
        sh, gov = governed_shard(pkg, ds, 600, n=4096)
        sh.ingest(batch(pkg, "acme", 1000))     # over: per-key sheds 400
        out = [state(sh, gov, ["acme"])]
        sh.ingest(batch(pkg, "beta", 600, "b"))  # fits: one block admit
        out.append(state(sh, gov, ["acme", "beta"]))
        return out

    res = run_both(scenario)
    assert res["torch"] == res["jax"]
    assert res["torch"][0][:2] == (600, 400)
    assert res["torch"][1][0] == 1200


@pytest.mark.parametrize("limit", (None, 6))
def test_release_by_eviction_retires_quota_slots(limit):
    """Eight slots: the ninth and tenth series evict the least recently
    active ones, whose tenant gets its slots back."""
    def scenario(pkg, ds):
        sh, gov = governed_shard(pkg, ds, limit, n=8)
        out = []
        for k in range(5):
            sh.ingest(container(pkg, "acme", [f"h{k}"], ts=BASE + k * 1000))
            sh.ingest(container(pkg, "beta", [f"b{k}"], ts=BASE + k * 1000))
            sh.flush()
        out.append(state(sh, gov, ["acme", "beta"]))
        out.append(sh.data_epoch)
        return out

    res = run_both(scenario)
    assert res["torch"] == res["jax"]
    num_series, _shed, evicted, active, _n = res["torch"][0]
    assert evicted > 0 and sum(active.values()) == num_series == 8
