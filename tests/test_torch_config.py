"""The port's configuration (``filodb_tpu_torch/config.py``) against the
JAX package's: the declared keys, their types, defaults and layering, the
duration parser over a table of spellings, the store and query configs a
config builds, and what the port does with the keys it cannot honour
(an unknown ``query.fused_kernels`` name, a non-default cohort gate, and
``rules.groups`` over a histogram schema, which the reference refuses too).
``query.fused_kernels="off"`` is accepted: tests/test_torch_fused_off.py.

Tolerance: none — every value must be equal.
"""

import dataclasses
import json

import pytest

from filodb_tpu import config as jconfig
from filodb_tpu_torch import config as tconfig
from filodb_tpu_torch.config import Config, fused_kernels_mode
from filodb_tpu_torch.standalone import FiloServer

DURATIONS = ["0ms", "1ms", "250ms", "1s", "1.5s", "90s", "5m", "2h", "1d",
             "0.25h", "3.75m", 7, 0, 12.9, "100ms", "60s", "6h",
             "1000000ms"]
BAD_DURATIONS = ["", "5", "10", "m", "5 m", "-5m", "5x", "5mm", "1.s", "s5",
                 "five minutes", "5M", "1e3s"]
# keys that drive XLA program machinery: kept so the reference's config
# files load, and documented as doing nothing in the port
NO_PORT_KEYS = ("query.plan_cache_size", "query.warmup_shapes",
                "query.mesh_programs", "query.mesh_donation")


def test_every_key_type_and_default_equal_the_reference():
    assert set(tconfig.CONFIG_SPEC) == set(jconfig.CONFIG_SPEC)
    for key, (typ, default, _doc) in jconfig.CONFIG_SPEC.items():
        ttyp, tdefault, tdoc = tconfig.CONFIG_SPEC[key]
        assert (ttyp, tdefault) == (typ, default), key
        assert tdoc, key
    assert tconfig.DEFAULTS == jconfig.DEFAULTS
    # the runtime defaults read back equal, key by key
    t, j = Config(), jconfig.Config()
    for key in jconfig.CONFIG_SPEC:
        assert t[key] == j[key], key


@pytest.mark.parametrize("key", NO_PORT_KEYS)
def test_keys_without_a_port_say_so(key):
    assert "nothing in the port" in tconfig.CONFIG_SPEC[key][2]


@pytest.mark.parametrize("v", DURATIONS)
def test_parse_duration_ms_equals_the_reference(v):
    assert tconfig.parse_duration_ms(v) == jconfig.parse_duration_ms(v)


@pytest.mark.parametrize("v", BAD_DURATIONS)
def test_bad_durations_fail_in_both(v):
    with pytest.raises(ValueError):
        jconfig.parse_duration_ms(v)
    with pytest.raises(ValueError):
        tconfig.parse_duration_ms(v)


def test_layering_file_then_overrides(tmp_path):
    p = tmp_path / "server.json"
    p.write_text(json.dumps({
        "num_shards": 4, "store": {"dtype": "float64",
                                   "samples_per_series": 256},
        "ingest": {"partitions": 2, "replication": 2},
        "cluster": {"gossip_port": 0},
        "query": {"tenant_quotas": {"a": 5}}}))
    over = {"store": {"samples_per_series": 77}, "http": {"port": 0},
            "query": {"tenant_quotas": {"b": 7}}}
    t = Config.load(str(p), over)
    j = jconfig.Config.load(str(p), over)
    assert t.data == j.data
    assert t["store.samples_per_series"] == 77
    assert t["store.flush_batch_size"] == 65536        # default survives
    assert t["query.tenant_quotas"] == {"a": 5, "b": 7}
    assert t.get("no.such.key", "x") == j.get("no.such.key", "x") == "x"
    assert t.get("cluster.gossip_port") == 0
    # layers never mutate the defaults
    assert tconfig.DEFAULTS["store"]["samples_per_series"] == 1024


def test_store_and_query_configs_equal_the_reference(tmp_path):
    layer = {"store": {"max_series_per_shard": 128, "samples_per_series": 64,
                       "flush_batch_size": 1000, "groups_per_shard": 4,
                       "retention": "90m", "dtype": "float64",
                       "compressed_residency": "gauge",
                       "narrow_mirror": True},
             "query": {"stale_sample_after": "2m", "sample_limit": 5000,
                       "slow_log_threshold_ms": None,
                       "result_cache_size": 16, "max_concurrent_cost": 1e6,
                       "tenant_quotas": {"t": 10}, "shed_retry_after": "2s",
                       "negative_cache_size": 8,
                       "negative_cache_ttl": "10s",
                       "fragment_cache_size": 4,
                       "fragment_cache_bytes": 4096,
                       "fragment_max_steps": 64}}
    t, j = Config(layer), jconfig.Config(layer)
    ts, js = t.store_config(), j.store_config()
    assert ts.device is None          # the memstore's device decides
    for f in dataclasses.fields(ts):
        if f.name != "device":
            assert getattr(ts, f.name) == getattr(js, f.name), f.name
    tq, jq = t.query_config(), j.query_config()
    assert dataclasses.asdict(tq) == {
        f.name: getattr(jq, f.name) for f in dataclasses.fields(tq)}


def test_a_cohort_gate_the_port_does_not_have_is_refused():
    assert Config().store_config() is not None
    with pytest.raises(ValueError, match="cohort gate"):
        Config({"store": {"narrow_cohort_gate": 0.5}}).store_config()


@pytest.mark.parametrize("mode", ["xla", "pallas"])
def test_fused_kernel_modes_that_run_the_hand_kernels(mode):
    assert fused_kernels_mode(Config({"query": {"fused_kernels": mode}})) \
        == mode


@pytest.mark.parametrize("mode", ["mosaic"])
def test_fused_kernels_off_is_refused_before_anything_starts(mode):
    """A fused-kernel mode that neither package knows is refused at start,
    before the server binds a port or starts a thread. ("off", the
    composed two-step chain, is served: tests/test_torch_fused_off.py.)"""
    import threading
    cfg = Config({"query": {"fused_kernels": mode}, "http": {"port": 0}})
    with pytest.raises(ValueError, match="fused_kernels"):
        fused_kernels_mode(cfg)
    before = set(threading.enumerate())
    srv = FiloServer(cfg, device="cpu")
    with pytest.raises(ValueError, match="fused_kernels"):
        srv.start()
    assert srv.http is None and not srv.consumers
    assert srv.memstore.shards_of(cfg["dataset"]) == []
    assert set(threading.enumerate()) <= before


def test_rules_groups_are_refused_naming_the_missing_module():
    """The rules subsystem is ported: ``rules.groups`` starts it over a
    scalar schema, and over a histogram schema it is refused as the
    reference refuses it, naming ``rules.groups`` (recording rules emit
    scalar samples)."""
    groups = {"groups": [{"name": "g", "interval": "1s",
                          "rules": [{"record": "r", "expr": "sum(m)"}]}]}
    srv = FiloServer(Config({"http": {"port": 0}, "rules": groups}),
                     device="cpu").start()
    threads = list(srv.rules.scheduler._threads)
    try:
        assert srv.http.rules is srv.rules
        assert [g.name for g in srv.rules.groups] == ["g"]
        assert len(threads) == 1 and threads[0].is_alive()
    finally:
        srv.shutdown()
    assert not threads[0].is_alive()     # shutdown joins the group thread
    hist = FiloServer(Config({"http": {"port": 0}, "schema": "prom-histogram",
                              "rules": groups}), device="cpu")
    try:
        with pytest.raises(ValueError, match="rules.groups requires a "
                                             "scalar"):
            hist.start()
    finally:
        hist.shutdown()
