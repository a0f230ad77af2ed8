#!/usr/bin/env python
"""Benchmark suite of the port — parity with the reference's jmh suites.

    python3 -m filodb_tpu_torch.scripts.bench_suite [--suite NAME ...] \\
        [--full] [--device cuda|cpu]

The port's counterpart of ``scripts/bench_suite.py``: the same ``SUITES``
keys, the same seeds, ``BASE``/``IV``, default and ``--full`` sizes, the
same ``timed()`` rule, the same metric names and units, and the same JSON
line per metric:

    {"suite": "...", "metric": "...", "value": N, "unit": "..."}

Each sub-benchmark mirrors the *workload definition* of one reference jmh
suite (jmh/src/main/scala/filodb.jmh/) or of one of the system's own
features:

  ingestion     container build + memstore ingest hot path  (IngestionBenchmark.scala)
  encoding      delta-delta / NibblePack codec throughput, Python + C++
                (EncodingBenchmark.scala, BasicFiloBenchmark.scala)
  partkey_index 100k (1M with --full) series tag index: add rate,
                equals/regex lookups, top-k  (PartKeyIndexBenchmark.scala)
  hist_ingest   histogram container ingest + 2D-delta encode  (HistogramIngestBenchmark.scala)
  hist_query    histogram_quantile(sum(rate(h[5m])))  (HistogramQueryBenchmark.scala)
  query_hicard  8000-series single-shard sum(rate) query throughput
                (QueryHiCardInMemoryBenchmark.scala: 15m @ 10s, quarter queried)
  query_ingest  interleaved ingest + query  (QueryAndIngestBenchmark.scala)
  gateway       Influx line-protocol parse throughput  (GatewayBenchmark.scala)
  serving, fused_resident, mesh_query, count_values, narrow_resident,
  scalar_residency, hist_retention, odp, retention, ingest, ingest_soak,
  elastic, rules, dashboard_soak, observability — the serving fast path,
                the fused tier against the composed ``off`` chain, the mesh,
                residency ladders, paging and retention tiers, the ingest
                plane and its soaks, rules, the elastic cluster, incremental
                serving and tracing overhead (each suite's docstring).

Device: the default is ``cuda``; without a card, and without
``--device cpu``, the run raises ``DeviceUnavailable``
(``filodb_tpu_torch/device.py``). The first line printed is the card's name
and power limit (``nvidia-smi``; ``cpu`` on the CPU), then the session
floors (``filodb_tpu_torch/bench.py``'s ``session_floor_ms`` and
``device_dispatch_floor_ms``) and ``session/backend`` with the unit
``is_cuda``; then each suite's lines. Wherever the reference blocked on a
device array, the twin synchronises the card.

What differs from the reference, each with its reason, is in three tables
below: ``NO_PORT`` (a metric the port does not emit), ``RENAMED`` (a metric
the port emits under another name) and ``SUBSTITUTED`` (a mechanism the
port replaces, without a change of metric). In short: the XLA program
machinery (plan cache, warm-up, pjit/shard_map mesh modes, the xla/pallas
pair) has no port; ``jax.random`` store fills become a ``torch.Generator``
with the same seed and distributions on the store's device, so those
values differ in bits from the reference's; the fused tier's A/B is the
composed ``query.fused_kernels="off"`` chain against the hand kernels.

Each suite's data comes from a module-level fixture function that returns
host records (containers or numpy arrays), so the same records can be fed
to both packages. Each suite takes the device and, as keyword arguments,
the sizes its fixtures take (None: the default or ``--full`` size).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import socket
import sys
import threading
import time

import numpy as np
import torch

from ..device import resolve_device


def emit(suite: str, metric: str, value: float, unit: str) -> None:
    print(json.dumps({"suite": suite, "metric": metric,
                      "value": round(float(value), 3), "unit": unit}), flush=True)


def timed(fn, *, min_s: float = 0.3, max_iters: int = 50) -> tuple[float, int]:
    """Run fn repeatedly for >= min_s; return (total seconds, iterations)."""
    fn()                                # warmup (kernel build / cache fill)
    t0 = time.perf_counter()
    iters = 0
    while True:
        fn()
        iters += 1
        dt = time.perf_counter() - t0
        if dt >= min_s or iters >= max_iters:
            return dt, iters


def sync(dev: torch.device) -> None:
    """Wait for the card's queued work (CPU work is already done)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _pick(value, full: bool, default, at_full):
    return value if value is not None else (at_full if full else default)


class Workers:
    """Daemon threads a suite runs beside its own: each target's exception
    is kept and raised by :meth:`join`, as is a thread still running at
    the deadline, so a worker that dies fails the suite instead of
    leaving it to wait or to measure less work."""

    def __init__(self):
        self.threads: list[threading.Thread] = []
        self.errors: list[BaseException] = []

    def start(self, fn, *args) -> threading.Thread:
        def guarded():
            try:
                fn(*args)
            except Exception as e:  # noqa: BLE001 - raised by join()
                self.errors.append(e)
        t = threading.Thread(target=guarded, daemon=True)
        self.threads.append(t)
        t.start()
        return t

    def join(self, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        for t in self.threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        self.threads = [t for t in self.threads if t.is_alive()]
        if self.errors:
            raise self.errors[0]
        if self.threads:
            raise RuntimeError(f"{len(self.threads)} worker(s) still running "
                               f"after {timeout} s")


def _free_port() -> int:
    """A port the kernel hands out now, for a server that must know its
    peers' ports before any of them binds."""
    with socket.socket() as s:
        s.settimeout(5.0)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _send_lines(port: int, lines) -> None:
    """Influx lines over one TCP connection to a gateway."""
    with socket.create_connection(("127.0.0.1", port), timeout=60.0) as s:
        s.sendall(("\n".join(lines) + "\n").encode())


# ---------------------------------------------------------------- tables

FUSED_SHAPES = ("rate_sum", "window_reduce", "hist_quantile")

_PLANCACHE = ("query/plancache.py (a cache of compiled XLA programs) has no "
              "port: the port compiles nothing at serve time, so there is "
              "no warm-up or trace count to measure")
_ONE_MESH_MODE = ("the port's mesh has one mode, eager (make_mesh places "
                  "shard i on card i % ndev): no pjit or shard_map program")
_ONE_FUSED_MODE = ("xla and pallas are one mode in the port: the hand "
                   "kernel (K1/K2) on the card, its plain twin on the CPU")

# (suite, reference metric) -> why the port does not emit it
NO_PORT = {
    ("serving", "warmed_first_query_ms"): _PLANCACHE,
    ("serving", "warmup_ms"): _PLANCACHE,
    ("serving", "warmup_programs"): _PLANCACHE,
    ("serving", "first_query_compiles_after_warmup"): _PLANCACHE,
    ("mesh_query", "skipped_single_device"):
        "the suite runs on one card: make_mesh places shard i on card "
        "i % ndev, as chip_smoke.py's phase 11b does",
    ("mesh_query", "warm_compile_count"): _PLANCACHE,
    ("mesh_query", "mesh_pjit_p50"): _ONE_MESH_MODE,
    **{("fused_resident", f"{s}_{m}"): _ONE_FUSED_MODE
       for s in FUSED_SHAPES for m in ("xla_ms", "speedup_xla_x")},
}

# (suite, reference metric) -> (the port's metric, why)
RENAMED = {
    ("mesh_query", "mesh_shard_map_p50"): ("mesh_eager_p50", _ONE_MESH_MODE),
    ("mesh_query", "mesh_pjit_overhead_p50"):
        ("mesh_eager_overhead_p50", _ONE_MESH_MODE),
    ("mesh_query", "mesh_vs_host_total_ratio"):
        ("mesh_eager_vs_host_total_ratio", _ONE_MESH_MODE),
    ("mesh_query", "mesh_vs_host_ratio"):
        ("mesh_eager_vs_host_ratio", _ONE_MESH_MODE),
    ("fused_resident", "flush_scatter_donated_ms"):
        ("flush_scatter_inplace_ms",
         "the port's flush scatter is an in-place index_put_ on the "
         "preallocated store (core/chunkstore.py), not an XLA donation"),
    **{("fused_resident", f"{s}_pallas_ms"): (f"{s}_fused_ms", _ONE_FUSED_MODE)
       for s in FUSED_SHAPES},
    **{("fused_resident", f"{s}_speedup_pallas_x"):
       (f"{s}_speedup_fused_x", _ONE_FUSED_MODE) for s in FUSED_SHAPES},
    **{("fused_resident", f"{s}_variant_bit_parity"):
       (f"{s}_kernel_plain_parity",
        "the reference's pallas-vs-xla bit parity becomes the kernel's "
        "partials against its plain twin called on the same tensors: "
        "counts exact, sums within rtol 1e-5 of the largest magnitude")
       for s in FUSED_SHAPES},
}

# mechanisms the port replaces without a change of metric: suite ->
# [(the reference's, the port's, why)]
SUBSTITUTED = {
    "session": [("unit is_tpu (jax.default_backend() == 'tpu')",
                 "unit is_cuda (the run's device is a card)",
                 "is_tpu would misname the card")],
    "narrow_resident": [
        ("jax.random.randint store fill (PRNGKey(3))",
         "torch.Generator(seed 3).randint on the store's device",
         "the port imports no JAX; same seed and distributions, values "
         "differ in bits"),
        ("StoreConfig(narrow_resident=True) + compress_resident()",
         "compressed_residency='gauge' + compress_prepare/compress_commit",
         "the port has only compressed_residency (the reference maps "
         "narrow_resident onto 'gauge'); its compression is two-phase")],
    "scalar_residency": [
        ("jax.random store fills (PRNGKey(17))",
         "torch.Generator(seed 17) on the store's device",
         "the port imports no JAX; same seed and distributions, values "
         "differ in bits"),
        ("one store built per residency",
         "one store per data shape, queried raw, compressed in place, "
         "queried again",
         "the bit parity then holds for all three kinds, and each kind's "
         "K1 variant runs")],
    "fused_resident": [
        ("modes off / xla / pallas", "modes off / pallas",
         _ONE_FUSED_MODE),
        ("jitted donated scatter vs an undonated jitted copy",
         "in-place index_put_ vs a clone-then-write twin of the same body",
         "the port updates its preallocated store in place")],
    "dashboard_soak": [("forces query.fused_kernels='xla'",
                        "leaves the default mode (the hand kernel)",
                        "xla is the reference's CPU serving mode"),
                       ("bit_parity emitted, not asserted",
                        "bit_parity emitted; every refresh also asserted "
                        "within the bar",
                        "K1 on the card groups its fold by launch shape")],
    "hist_retention": [("asserts the residencies' quantiles bit for bit",
                        "asserts them within the bar; bit_parity says "
                        "whether they were also bit for bit",
                        "K2 on the card folds its per-block partials in "
                        "its own order, the raw store's grid path in "
                        "another")],
    "mesh_query": [("skips on one device", "runs on one card",
                    "make_mesh places shard i on card i % ndev")],
    "elastic": [("one rebalance POST",
                 "the POST asked again while the owner does not yet know "
                 "the new node's HTTP endpoint (422, at most 20 s)",
                 "the endpoint arrives with the new node's first "
                 "registrar heartbeats: a race of the harness, not of the "
                 "move")],
}

# suite -> the metric names it emits at the default size, in order
METRICS = {
    "ingestion": ("record_build_throughput", "record_build_batch_throughput",
                  "ingest_throughput", "ingest_hot_throughput"),
    "encoding": tuple(f"{c}_{k}" for c in ("deltadelta_ts",
                                           "nibblepack_doubles")
                      for k in ("encode", "decode", "ratio"))
    + ("native_pack_doubles", "native_unpack_doubles"),
    "partkey_index": None,          # filled below: it depends on --full
    "hist_ingest": ("ingest_throughput", "record_build_throughput",
                    "encode_2d_delta"),
    "hist_query": ("quantile_of_sum_rate", "quantile_of_sum_rate_p50",
                   "quantile_of_sum_rate_concurrent",
                   "device_marginal_ms_per_query"),
    "query_hicard": ("sum_rate_quarter_series", "sum_rate_p50"),
    "query_ingest": ("idle_query_throughput", "idle_device_marginal_ms",
                     "mixed_ingest_target", "mixed_ingest_throughput",
                     "mixed_query_throughput", "mixed_device_marginal_ms",
                     "mixed_vs_idle_query_ratio"),
    "ingest": ("gateway_lines_serial", "gateway_lines_batched",
               "gateway_speedup", "gateway_connections",
               "broker_publish_rows_serial", "broker_publish_rows_batched",
               "broker_publish_speedup", "broker_publish_round_trips",
               "broker_publish_window", "replay_rows_per_s", "bit_parity"),
    "ingest_soak": ("soak_lines_per_s", "frames_on_survivor",
                    "rows_on_survivor", "rows_expected", "pubid_lost",
                    "pubid_duplicated", "row_parity", "kill_offset",
                    "client_retries", "client_failovers",
                    "overload_publishes", "overload_landed",
                    "overload_sheds", "overload_publish_rate",
                    "overload_queue_cap", "overload_zero_loss"),
    "gateway": ("influx_parse",),
    "narrow_resident": ("resident_bytes_f32", "resident_bytes_narrow",
                        "retention_multiple_at_fixed_hbm", "fused_ms_f32",
                        "fused_ms_narrow", "fused_ratio_narrow_vs_f32",
                        "bit_parity"),
    "scalar_residency": ("encode_flush_ms", "encode_flush_throughput",
                         "resident_bytes_f32", "resident_bytes_delta8",
                         "retention_multiple_at_fixed_hbm", "fused_ms_f32",
                         "fused_ms_delta8", "fused_ratio_delta8_vs_f32",
                         "bit_parity", "bytes_per_sample_quant16",
                         "bytes_per_sample_delta16",
                         "bytes_per_sample_delta8", "bytes_per_sample_f32"),
    "hist_retention": ("resident_bytes_f32", "resident_bytes_compressed",
                       "retention_multiple_at_fixed_hbm",
                       "series_at_fixed_hbm_multiple", "dd_dtype_bits",
                       "quantile_of_sum_rate_ms_f32",
                       "quantile_of_sum_rate_ms_compressed",
                       "fused_ratio_compressed_vs_f32", "bit_parity"),
    "odp": ("cold_first_touch_ms", "cold_query_page_in_ms", "cold_query_qps",
            "paged_series_per_s", "resident_query_ms", "series",
            "cold_samples_per_series"),
    "retention": ("ingest_flush_s", "span_days", "series", "raw_samples",
                  "downsample_build_s", "latency_raw_ms", "qps_raw",
                  "latency_1h_ms", "qps_1h", "latency_6h_ms", "qps_6h",
                  "auto_resolution_is_stitched", "cold_paged_series",
                  "cold_paged_samples_per_query", "cold_month_rate_ms",
                  "cold_month_rate_qps", "reads_after_kill_ok",
                  "writes_after_kill_ok", "replica_failovers", "resolutions"),
    "count_values": ("query_ms", "host_merge_ms", "host_merge_fraction",
                     "series"),
    "observability": ("query_p50_off", "query_p50_sampled_1pct",
                      "query_p50_full", "spans_per_query_full",
                      "overhead_sampled_vs_off", "overhead_full_vs_off",
                      "span_cost_us_off", "span_cost_us_full",
                      "est_overhead_off_pct", "est_overhead_full_pct"),
    "serving": ("cold_first_query_ms", "warm_p50_ms", "cold_vs_warm_speedup",
                "result_hit_p50_ms", "reexec_p50_ms", "result_cache_speedup",
                "result_cache_bit_parity", "dashboard_qps_cache_on",
                "dashboard_qps_cache_off", "overload_budget_cost",
                "overload_queries_landed", "overload_sheds",
                "overload_peak_cost_in_use", "overload_budget_respected",
                "overload_wall_s"),
    "fused_resident": tuple(
        f"{s}_{k}" for s in FUSED_SHAPES
        for k in ("off_ms", "fused_ms", "kernel_plain_parity",
                  "oracle_exact", "oracle_maxrel_ppm", "speedup_fused_x"))
    + ("flush_scatter_inplace_ms", "flush_scatter_copy_ms",
       "flush_scatter_speedup_x", "flush_alloc_saved_mb"),
    "rules": ("rules_per_sec_isolated", "rules_per_sec_concurrent",
              "dashboard_qps_during_rules", "dashboard_p50_ms_during_rules",
              "derived_parity_cells_checked", "derived_parity_mismatches",
              "soak_frames_published", "soak_leader_kills", "soak_lost",
              "soak_duplicated", "soak_wall_s"),
    "elastic": ("kill_node_takeover_s", "kill_node_rows_published",
                "kill_node_rows_lost",
                "kill_node_query_errors_during_takeover",
                "kill_node_queries_served", "kill_node_warm_parity",
                "rebalance_cutover_s", "rebalance_rows_under_load",
                "rebalance_parity", "splitbrain_frames",
                "splitbrain_leader_kills", "splitbrain_survivor_epoch",
                "splitbrain_lost", "splitbrain_duplicated",
                "splitbrain_log_dense", "splitbrain_rate"),
    "dashboard_soak": ("panels", "refreshes", "steps_per_panel", "series",
                       "effective_qps_delta", "effective_qps_full",
                       "delta_speedup", "bit_parity",
                       "baseline_result_cache_hits", "fragment_extensions",
                       "fragment_hits", "fragment_bytes"),
    "mesh_query": ("shards", "series", "samples", "host_loop_p50",
                   "mesh_eager_p50", "leaf_compute_floor_p50",
                   "host_loop_overhead_p50", "mesh_eager_overhead_p50",
                   "mesh_eager_vs_host_total_ratio", "mesh_eager_vs_host_ratio",
                   "bit_parity"),
}

# what main() prints before the suites, under the suite name "session"
SESSION_METRICS = ("rt_floor_ms", "device_dispatch_floor_ms", "backend")

# emitted only when the run produced the measurement, as in the reference
# (no dashboard query finished during the rule ticks)
OPTIONAL = {("rules", "dashboard_p50_ms_during_rules")}


def _partkey_metrics(tags) -> tuple:
    out = []
    for tag in tags:
        out += [f"build_columnar_rate_{tag}"]
        out += [f"{n}_ms_{tag}" for n in ("equals", "regex", "multi_matcher",
                                          "dense_multi")]
        out += [f"labelvalues_topk_ms_{tag}",
                f"labelvalues_topk_filtered_ms_{tag}",
                f"label_storage_{tag}", f"postings_storage_{tag}"]
    out += ["pure_build_rate_100k"]
    for n in ("equals", "regex", "multi_matcher", "dense_multi"):
        out += [f"pure_{n}_ms_100k", f"{n}_parity_vs_pure"]
    for tag in tags:
        out += [f"recover_index_ms_{tag}", f"recover_total_ms_{tag}",
                f"recover_rate_{tag}"]
    out += ["ingest_p99_plain_ms", "ingest_p99_governed_ms",
            "ingest_p99_governed_ratio"]
    return tuple(out)


METRICS["partkey_index"] = _partkey_metrics(("100k",))


def declared_metrics(suite: str, full: bool = False) -> tuple:
    """The metric names ``suite`` emits at the default (or ``--full``)
    size, in order; names in ``OPTIONAL`` may be missing from a run."""
    if suite == "partkey_index" and full:
        return _partkey_metrics(("100k", "1m"))
    return METRICS[suite]


def _launches() -> tuple[int, int]:
    from ..ops import fusedgrid, fusedresident
    return (fusedgrid.fused_grid_kernel.launches,
            fusedresident.fused_hist_kernel.launches)


# ---------------------------------------------------------------- fixtures

BASE = 1_700_000_000_000
IV = 10_000
DATA_BATCH = 1 << 17          # store-fill chunk (bounds transient memory)


def _gauge_containers(n_series: int, n_samples: int, per_container: int = 1000):
    """linearMultiSeries-style data grouped into ~1000-record containers
    (ref IngestionBenchmark: 100k records in 1000-record containers)."""
    from ..core.record import RecordBuilder
    from ..core.schemas import GAUGE
    containers = []
    b = RecordBuilder(GAUGE)
    count = 0
    for t in range(n_samples):
        for s in range(n_series):
            b.add({"_metric_": "heap_usage", "_ws_": "demo", "_ns_": "app",
                   "host": f"h{s}", "job": f"App-{s % 8}"},
                  BASE + t * IV, float(s * 100 + t))
            count += 1
            if count % per_container == 0:
                containers.append(b.build())
                b = RecordBuilder(GAUGE)
    if count % per_container:
        containers.append(b.build())
    return containers


def hicard_containers(n_series: int, seed: int = 11, n_samples: int = 90):
    """query_hicard's (seed 11), observability's (11) and serving's (13)
    counters: one container a series, ``n_samples`` exponential(5)
    increments cumulated, 15 minutes at 10 s; job J{s % 4}."""
    from ..core.record import RecordBuilder
    from ..core.schemas import PROM_COUNTER
    rng = np.random.default_rng(seed)
    out = []
    for s in range(n_series):
        b = RecordBuilder(PROM_COUNTER)
        vals = np.cumsum(rng.exponential(5.0, n_samples))
        for t in range(n_samples):
            b.add({"_metric_": "request_total", "job": f"J{s % 4}",
                   "instance": f"i{s}"}, BASE + t * IV, float(vals[t]))
        out.append(b.build())
    return out


def hist_counts(n_series: int, n_samples: int, B: int, seed: int):
    """Per-series [n_samples, B] cumulative histogram counts: Poisson(0.3)
    arrivals cumulated over time and over buckets (hist_ingest seed 3,
    hist_query 4, hist_retention 12)."""
    rng = np.random.default_rng(seed)
    return [np.cumsum(np.cumsum(rng.poisson(0.3, (n_samples, B)), axis=0),
                      axis=1).astype(np.float64) for _ in range(n_series)]


def hist_les(B: int) -> np.ndarray:
    return np.concatenate([2.0 ** np.arange(B - 1), [np.inf]])


def hist_query_containers(n_series: int, n_samples: int, B: int,
                          seed: int = 4):
    """hist_query's histograms: one container a series, one record a
    sample (the per-record build path)."""
    from ..core.record import RecordBuilder
    from ..core.schemas import PROM_HISTOGRAM
    les = hist_les(B)
    out = []
    for s, c in enumerate(hist_counts(n_series, n_samples, B, seed)):
        b = RecordBuilder(PROM_HISTOGRAM, bucket_les=les)
        for t in range(n_samples):
            b.add({"_metric_": "req_latency", "host": f"h{s}"},
                  BASE + t * IV, c[t])
        out.append(b.build())
    return out


def fused_scalar_containers(n_series: int, n_samp: int = 48,
                            siv: int = 30_000, seed: int = 3):
    """fused_resident's counters: 512 series a container, sample-major,
    exponential(5) increments cumulated, a 30 s scrape; job J{s % 8}."""
    from ..core.record import RecordBuilder
    from ..core.schemas import PROM_COUNTER
    rng = np.random.default_rng(seed)
    out = []
    for s0 in range(0, n_series, 512):
        b = RecordBuilder(PROM_COUNTER)
        vals = np.cumsum(rng.exponential(5.0, (512, n_samp)), axis=1)
        for t in range(n_samp):
            for s in range(s0, s0 + 512):
                b.add({"_metric_": "rt", "job": f"J{s % 8}", "inst": f"i{s}"},
                      BASE + t * siv, float(vals[s - s0, t]))
        out.append(b.build())
    return out


def fused_hist_containers(n_hist: int, nh_samp: int = 32, nb: int = 32,
                          seed: int = 5):
    """fused_resident's histograms: 256 series a container, sample-major,
    Poisson(0.4) arrivals cumulated over time and buckets, a 10 s scrape."""
    from ..core.record import RecordBuilder
    from ..core.schemas import PROM_HISTOGRAM
    les = hist_les(nb)
    rng = np.random.default_rng(seed)
    out = []
    for s0 in range(0, n_hist, 256):
        b = RecordBuilder(PROM_HISTOGRAM, bucket_les=les)
        c = np.cumsum(np.cumsum(rng.poisson(0.4, (256, nh_samp, nb)), axis=1),
                      axis=2).astype(np.float64)
        for t in range(nh_samp):
            for s in range(256):
                b.add({"_metric_": "h", "host": f"x{s0 + s}"},
                      BASE + t * IV, c[s, t])
        out.append(b.build())
    return out


def encoding_data(n: int):
    """(timestamps with +-50 ms jitter, exponential(5) cumulated doubles),
    seed 7."""
    rng = np.random.default_rng(7)
    ts = BASE + np.arange(n, dtype=np.int64) * IV + rng.integers(-50, 50, n)
    return ts, np.cumsum(rng.exponential(5.0, n))


def odp_values(n_series: int, n_samples: int):
    """odp's per-series values: exponential(2) increments cumulated, seed 9."""
    rng = np.random.default_rng(9)
    return [np.cumsum(rng.exponential(2.0, n_samples))
            for _ in range(n_series)]


def retention_values(n_series: int, n_samples: int):
    """retention's per-series values: exponential(2) cumulated, seed 13."""
    rng = np.random.default_rng(13)
    return [np.cumsum(rng.exponential(2.0, n_samples))
            for _ in range(n_series)]


def count_values_values(nshards: int, per: int, n_samples: int):
    """count_values' small-integer values in [0, 20), seed 21: a list per
    shard of per-series arrays."""
    rng = np.random.default_rng(21)
    return [[rng.integers(0, 20, n_samples).astype(np.float64)
             for _ in range(per)] for _ in range(nshards)]


def rules_values(n_series: int, n_samples: int):
    """rules' per-series values: 100 + exponential(2) cumulated, seed 29."""
    rng = np.random.default_rng(29)
    return [100.0 + np.cumsum(rng.exponential(2.0, n_samples))
            for _ in range(n_series)]


def mesh_values(n_series: int, n_samples: int):
    """mesh_query's per-series counters: exponential(5) cumulated, seed 16."""
    rng = np.random.default_rng(16)
    return [np.cumsum(rng.exponential(5.0, n_samples))
            for _ in range(n_series)]


def _within_bar(got: np.ndarray, want: np.ndarray) -> bool:
    """The parity bar where an answer is not bit for bit the other's: the
    same shape and NaN placement, every value within rtol 1e-5 of the
    reference answer's largest magnitude."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape or not np.array_equal(np.isnan(got),
                                                     np.isnan(want)):
        return False
    fin = ~np.isnan(want)
    if not fin.any():
        return True
    scale = float(np.abs(want[fin]).max())
    return float(np.abs(got[fin] - want[fin]).max()) <= 1e-5 * scale


def _parts_agree(got, want) -> bool:
    """A kernel's partials against its plain twin's at chip_smoke.py's bar:
    the counts (output 1) bit for bit, every other output within rtol 1e-5
    of its largest magnitude; NaN where the other has NaN."""
    for i, (a, b) in enumerate(zip(got, want)):
        a = a.detach().double().cpu()
        b = b.detach().double().cpu()
        if not torch.equal(a.isnan(), b.isnan()):
            return False
        fin = ~b.isnan()
        if i == 1:
            if not torch.equal(a[fin], b[fin]):
                return False
            continue
        if not bool(fin.any()):
            continue
        scale = float(b[fin].abs().max())
        if float((a[fin] - b[fin]).abs().max()) > 1e-5 * scale:
            return False
    return True


# ---------------------------------------------------------------- suites

def bench_ingestion(full: bool, device=None, *, n_series=None,
                    n_samples=None) -> None:
    """Ref IngestionBenchmark: RecordBuilder build + the partition-resolve +
    ingest hot loop into a memstore with a null sink."""
    from ..core.memstore import StoreConfig, TimeSeriesMemStore
    from ..core.record import RecordBuilder
    from ..core.schemas import GAUGE

    dev = resolve_device(device)
    # full scale: 500k records, the reference's large-block ingest scale
    n_series = _pick(n_series, full, 500, 1000)
    n_samples = _pick(n_samples, full, 40, 500)
    t0 = time.perf_counter()
    containers = _gauge_containers(n_series, n_samples)
    build_s = time.perf_counter() - t0
    n_records = n_series * n_samples
    emit("ingestion", "record_build_throughput", n_records / build_s, "records/s")
    # bulk path: one add_batch per series (backfills/CSV/generators)
    ts_arr = BASE + np.arange(n_samples, dtype=np.int64) * IV
    t0 = time.perf_counter()
    b = RecordBuilder(GAUGE)
    for s in range(n_series):
        b.add_batch({"_metric_": "heap_usage", "_ws_": "demo", "_ns_": "app",
                     "host": f"h{s}", "job": f"App-{s % 8}"},
                    ts_arr, np.full(n_samples, float(s)))
    b.build()
    emit("ingestion", "record_build_batch_throughput",
         n_records / (time.perf_counter() - t0), "records/s")

    cfg = StoreConfig(max_series_per_shard=n_series, samples_per_series=n_samples + 8,
                      flush_batch_size=10**9, dtype="float32")
    ms = TimeSeriesMemStore(device=dev)
    ms.setup("bench", GAUGE, 0, cfg)
    t0 = time.perf_counter()
    for c in containers:
        ms.ingest("bench", 0, c)
    ms.flush_all()
    sync(dev)
    ingest_s = time.perf_counter() - t0
    emit("ingestion", "ingest_throughput", n_records / ingest_s, "records/s")

    # re-ingest = pure hot path (every partition already exists: the
    # PartitionSet-probe side of ref ingestBinaryRecords)
    t0 = time.perf_counter()
    for c in containers:
        ms.ingest("bench", 0, c)
    ms.flush_all()
    sync(dev)
    emit("ingestion", "ingest_hot_throughput",
         n_records / (time.perf_counter() - t0), "records/s")


def bench_encoding(full: bool, device=None, *, n=None) -> None:
    """Ref EncodingBenchmark/BasicFiloBenchmark: codec encode/decode speeds
    (host codecs: the Python ones and the port's C++ ``memory/native``)."""
    from ..memory import deltadelta, native, nibblepack

    resolve_device(device)            # the device policy; host work only
    n = _pick(n, full, 20_000, 100_000)
    ts, doubles = encoding_data(n)

    for name, enc, dec, data, nbytes in [
        ("deltadelta_ts", deltadelta.encode, lambda b: deltadelta.decode(b),
         ts, n * 8),
        ("nibblepack_doubles", nibblepack.pack_doubles,
         lambda b: nibblepack.unpack_doubles(b, n), doubles, n * 8),
    ]:
        buf = enc(data)
        dt, it = timed(lambda: enc(data))
        emit("encoding", f"{name}_encode", nbytes * it / dt / 1e6, "MB/s")
        dt, it = timed(lambda: dec(buf))
        emit("encoding", f"{name}_decode", nbytes * it / dt / 1e6, "MB/s")
        emit("encoding", f"{name}_ratio", nbytes / len(buf), "x")

    if native.available():
        buf = native.pack_doubles(doubles)
        dt, it = timed(lambda: native.pack_doubles(doubles))
        emit("encoding", "native_pack_doubles", n * 8 * it / dt / 1e6, "MB/s")
        dt, it = timed(lambda: native.unpack_doubles(buf, n))
        emit("encoding", "native_unpack_doubles", n * 8 * it / dt / 1e6, "MB/s")


class _PurePythonIndex:
    """The seed-era index shape — dicts of sets, per-value regex loops — the
    baseline the columnar engine's >= 10x acceptance bar measures against
    (bit-identical results asserted)."""

    def __init__(self):
        self.inv: dict = {}              # name -> value -> set(pid)

    def add(self, pid, labels):
        for k, v in labels.items():
            self.inv.setdefault(k, {}).setdefault(v, set()).add(pid)

    def query(self, filters):
        import re

        from ..core import filters as F
        result = None
        for f in filters:
            vals = self.inv.get(f.label, {})
            if isinstance(f, F.Equals):
                ids = set(vals.get(f.value, ()))
            elif isinstance(f, F.EqualsRegex):
                pat = re.compile(f.pattern)
                ids = set()
                for v, s in vals.items():
                    if pat.fullmatch(v):
                        ids |= s
            elif isinstance(f, F.NotEquals):
                ids = set()
                for v, s in vals.items():
                    if v != f.value:
                        ids |= s
            else:
                raise TypeError(f)
            result = ids if result is None else (result & ids)
        return np.asarray(sorted(result or ()), np.int32)

    def topk(self, label, k):
        from collections import Counter
        c = Counter({v: len(s) for v, s in self.inv.get(label, {}).items()})
        return [v for v, _ in c.most_common(k)]


def bench_partkey_index(full: bool, device=None, *, sizes=None,
                        governed_series=5000) -> None:
    """Ref PartKeyIndexBenchmark: the columnar index at 100k (and 1M with
    --full) — build rate, equals/regex/multi-matcher select latency with
    COLD select caches (the filter/union/match caches cleared per batch, so
    the rows measure the columnar set algebra, not a memo), top-k
    label_values, recover-ms from a 2-replica durable ring, ingest p99 with
    the cardinality limiter armed, and the >= 10x bar vs the pure-Python
    dicts-of-sets baseline at bit-identical results. ``sizes`` overrides the
    index sizes; the first is the one the pure-Python baseline mirrors (its
    metrics keep the reference's ``100k`` names)."""
    from ..core import filters as F
    from ..core.partkey_index import PartKeyIndex

    dev = resolve_device(device)
    sizes = list(sizes) if sizes is not None else (
        [100_000, 1_000_000] if full else [100_000])
    n_base = sizes[0]

    def tag_of(n):
        return "1m" if n >= 1_000_000 or n != n_base else "100k"

    def labels_of(i):
        return {"_metric_": "heap_usage", "_ws_": "demo", "_ns_": "app",
                "job": f"App-{i % 100}", "host": f"H{i % 1000}",
                "instance": f"I{i:07d}"}

    def build_columnar(n):
        idx = PartKeyIndex()
        t0 = time.perf_counter()
        ok = idx.add_part_keys_columnar(
            np.arange(n),
            {"_metric_": "heap_usage", "_ws_": "demo", "_ns_": "app"},
            ["job", "host", "instance"],
            [[f"App-{i % 100}" for i in range(n)],
             [f"H{i % 1000}" for i in range(n)],
             [f"I{i:07d}" for i in range(n)]], BASE)
        assert ok
        # readers fold the staged columns: include it in the build cost
        idx.part_ids_from_filters([F.Equals("_metric_", "heap_usage")],
                                  0, 1 << 62)
        return idx, time.perf_counter() - t0

    def filter_batches():
        return [
            ("equals", [[F.Equals("job", f"App-{i}"), F.Equals("host", "H0"),
                         F.Equals("_metric_", "heap_usage")]
                        for i in range(20)]),
            ("regex", [[F.Equals("_metric_", "heap_usage"),
                        F.EqualsRegex("instance", f"I00000{i % 10}.*")]
                       for i in range(20)]),
            ("multi_matcher", [[F.Equals("_metric_", "heap_usage"),
                                F.EqualsRegex("host", f"H{i % 10}.*"),
                                F.NotEquals("job", "App-0")]
                               for i in range(20)]),
            # every operand dense (covers most of the pid space): the
            # u64-word bitmap AND/ANDNOT plane
            ("dense_multi", [[F.Equals("_metric_", "heap_usage"),
                              F.Equals("_ws_", "demo"),
                              F.NotEquals("job", f"App-{i % 100}")]
                             for i in range(20)]),
        ]

    def cold(idx):
        # measure the select plane, not the memo layer: dashboards DO hit
        # these caches, but the acceptance bar is the cold set algebra
        idx._filter_cache.clear()
        idx._regex_union_cache.clear()
        idx._regex_cache.clear()

    results_base: dict[str, list] = {}
    for n in sizes:
        tag = tag_of(n)
        idx, build_s = build_columnar(n)
        emit("partkey_index", f"build_columnar_rate_{tag}", n / build_s,
             "keys/s")
        for name, batches in filter_batches():
            def run(idx=idx, batches=batches):
                cold(idx)
                for flt in batches:
                    idx.part_ids_from_filters(list(flt), 0, 1 << 62)
            dt, it = timed(run, max_iters=20)
            emit("partkey_index", f"{name}_ms_{tag}",
                 dt / (it * len(batches)) * 1000, "ms")
            if n == n_base:
                cold(idx)
                results_base[name] = [
                    idx.part_ids_from_filters(list(flt), 0, 1 << 62)
                    for flt in batches]
        dt, it = timed(lambda idx=idx: idx.label_value_counts("job",
                                                              top_k=10),
                       max_iters=50)
        emit("partkey_index", f"labelvalues_topk_ms_{tag}", dt / it * 1000,
             "ms")
        filt = [F.EqualsRegex("host", "H1.*")]
        dt, it = timed(lambda idx=idx, filt=filt: idx.label_value_counts(
            "job", list(filt), top_k=10), max_iters=20)
        emit("partkey_index", f"labelvalues_topk_filtered_ms_{tag}",
             dt / it * 1000, "ms")
        emit("partkey_index", f"label_storage_{tag}",
             idx.arena_bytes() / n, "bytes/series")
        emit("partkey_index", f"postings_storage_{tag}",
             idx.postings_bytes() / n, "bytes/series")

    # ---- >= 10x bar vs the pure-Python baseline (bit-identical) ----------
    n = n_base
    pure = _PurePythonIndex()
    t0 = time.perf_counter()
    for i in range(n):
        pure.add(i, labels_of(i))
    emit("partkey_index", "pure_build_rate_100k",
         n / (time.perf_counter() - t0), "keys/s")
    for name, batches in filter_batches():
        def run_pure(batches=batches):
            for flt in batches:
                pure.query(list(flt))
        dt, it = timed(run_pure, min_s=0.5, max_iters=5)
        pure_ms = dt / (it * len(batches)) * 1000
        emit("partkey_index", f"pure_{name}_ms_100k", pure_ms, "ms")
        # bit-identical results: same sorted pid arrays per batch entry
        parity = all(
            np.array_equal(got, pure.query(list(flt)))
            for got, flt in zip(results_base[name], batches))
        emit("partkey_index", f"{name}_parity_vs_pure", float(parity), "bool")

    # ---- recover-ms from the durable ring --------------------------------
    import shutil
    import tempfile

    from ..core.diststore import (RemoteStore, ReplicatedColumnStore,
                                  StoreServer)
    from ..core.memstore import StoreConfig, TimeSeriesMemStore
    from ..core.record import RecordBuilder
    from ..core.schemas import GAUGE
    from ..utils.metrics import FILODB_INDEX_RECOVER_MS, registry
    for n in sizes:
        tag = tag_of(n)
        root = tempfile.mkdtemp(prefix="pkib-")
        servers = [StoreServer(f"{root}/n{i}").start() for i in range(2)]
        try:
            ring = ReplicatedColumnStore(
                [RemoteStore(f"127.0.0.1:{s.port}") for s in servers],
                replication=2)
            cfg = StoreConfig(max_series_per_shard=max(n, 1 << 20),
                              samples_per_series=4, flush_batch_size=10**9,
                              dtype="float64")
            ms = TimeSeriesMemStore(device=dev)
            sh = ms.setup("pkib", GAUGE, 0, cfg, sink=ring)
            step = 200_000
            for base_i in range(0, n, step):
                b = RecordBuilder(GAUGE)
                m = min(step, n - base_i)
                b.add_series_batch(
                    {"_metric_": "heap_usage", "_ws_": "demo", "_ns_": "app",
                     "job": [f"App-{(base_i + i) % 100}" for i in range(m)],
                     "host": [f"H{(base_i + i) % 1000}" for i in range(m)],
                     "instance": [f"I{base_i + i:07d}" for i in range(m)]},
                    BASE, 1.0)
                sh.ingest(b.build())
            sh.flush_all_groups()
            ms2 = TimeSeriesMemStore(device=dev)
            sh2 = ms2.setup("pkib", GAUGE, 0, cfg, sink=ring)
            t0 = time.perf_counter()
            sh2.recover()
            sync(dev)
            total_s = time.perf_counter() - t0
            assert sh2.num_series == n
            idx_ms = registry.gauge(FILODB_INDEX_RECOVER_MS,
                                    {"dataset": "pkib", "shard": "0"}).value
            emit("partkey_index", f"recover_index_ms_{tag}", idx_ms, "ms")
            emit("partkey_index", f"recover_total_ms_{tag}", total_s * 1000,
                 "ms")
            emit("partkey_index", f"recover_rate_{tag}",
                 n / max(idx_ms / 1000.0, 1e-9), "keys/s")
            del ms, sh, ms2, sh2
        finally:
            for s in servers:
                with contextlib.suppress(Exception):
                    s.stop()
            shutil.rmtree(root, ignore_errors=True)

    # ---- ingest p99 with the limiter armed -------------------------------
    from ..core.cardinality import CardinalityGovernor
    p99s = {}
    for governed in (False, True):
        cfg = StoreConfig(max_series_per_shard=1 << 16,
                          samples_per_series=256, flush_batch_size=10**9,
                          dtype="float64")
        ms = TimeSeriesMemStore(device=dev)
        sh = ms.setup("pkg", GAUGE, 0, cfg)
        if governed:
            sh.governor = CardinalityGovernor(50_000, dataset="pkg")
        n_series, per = governed_series, min(1000, governed_series)
        b = RecordBuilder(GAUGE)
        b.add_series_batch(
            {"_metric_": "m", "_ws_": "demo", "_ns_": "app",
             "host": [f"h{i}" for i in range(n_series)]}, BASE, 1.0)
        sh.ingest(b.build())          # registration: every later row exists
        lat = []
        for t in range(60):
            b = RecordBuilder(GAUGE)
            b.add_series_batch(
                {"_metric_": "m", "_ws_": "demo", "_ns_": "app",
                 "host": [f"h{i}" for i in range(per)]},
                BASE + (t + 1) * 10_000, float(t))
            c = b.build()
            t0 = time.perf_counter()
            sh.ingest(c)
            lat.append((time.perf_counter() - t0) * 1000)
        p99 = sorted(lat)[int(len(lat) * 0.99) - 1]
        p99s[governed] = p99
        emit("partkey_index",
             "ingest_p99_governed_ms" if governed else "ingest_p99_plain_ms",
             p99, "ms")
        del ms, sh
    emit("partkey_index", "ingest_p99_governed_ratio",
         p99s[True] / max(p99s[False], 1e-9), "x")


def bench_hist_ingest(full: bool, device=None, *, n_series=None,
                      n_samples=None) -> None:
    """Ref HistogramIngestBenchmark: ingest native-histogram records."""
    from ..core.memstore import StoreConfig, TimeSeriesMemStore
    from ..core.record import RecordBuilder
    from ..core.schemas import PROM_HISTOGRAM
    from ..memory import hist as H

    dev = resolve_device(device)
    n_series = _pick(n_series, full, 50, 100)
    n_samples = _pick(n_samples, full, 100, 300)
    B = 64
    les = hist_les(B)
    counts = hist_counts(n_series, n_samples, B, seed=3)
    cfg = StoreConfig(max_series_per_shard=n_series, samples_per_series=n_samples + 8,
                      flush_batch_size=10**9, dtype="float64")
    ts_arr = BASE + np.arange(n_samples, dtype=np.int64) * IV

    def ingest_all():
        ms = TimeSeriesMemStore(device=dev)
        ms.setup("bench", PROM_HISTOGRAM, 0, cfg)
        for s in range(n_series):
            b = RecordBuilder(PROM_HISTOGRAM, bucket_les=les)
            # the reference benchmark ships pre-built containers into the
            # shard; add_batch is the equivalent bulk build path
            b.add_batch({"_metric_": "req_latency", "host": f"h{s}"},
                        ts_arr, counts[s])
            ms.ingest("bench", 0, b.build())
        ms.flush_all()
        sync(dev)
        return ms

    ingest_all()                      # warm the caches (jmh warmup)
    t0 = time.perf_counter()
    ingest_all()
    total = n_series * n_samples
    emit("hist_ingest", "ingest_throughput",
         total / (time.perf_counter() - t0), "hist_records/s")
    # per-record build path (one b.add per sample, 64-bucket rows)
    t0 = time.perf_counter()
    b = RecordBuilder(PROM_HISTOGRAM, bucket_les=les)
    for t in range(n_samples):
        b.add({"_metric_": "req_latency", "host": "h0"}, BASE + t * IV,
              counts[0][t])
    b.build()
    emit("hist_ingest", "record_build_throughput",
         n_samples / (time.perf_counter() - t0), "hist_records/s")

    one = counts[0]
    dt, it = timed(lambda: H.encode_hist_series(one))
    emit("hist_ingest", "encode_2d_delta", n_samples * it / dt, "hists/s")


def bench_hist_query(full: bool, device=None, *, n_series=None,
                     n_samples=None) -> None:
    """Ref HistogramQueryBenchmark: quantile-of-rate over native hists."""
    from concurrent.futures import ThreadPoolExecutor

    from ..core.memstore import StoreConfig, TimeSeriesMemStore
    from ..core.schemas import PROM_HISTOGRAM
    from ..query.engine import QueryEngine

    dev = resolve_device(device)
    n_series = _pick(n_series, full, 40, 100)
    n_samples = _pick(n_samples, full, 120, 300)
    B = 64
    cfg = StoreConfig(max_series_per_shard=n_series, samples_per_series=n_samples + 8,
                      flush_batch_size=10**9, dtype="float64")
    ms = TimeSeriesMemStore(device=dev)
    ms.setup("bench", PROM_HISTOGRAM, 0, cfg)
    for c in hist_query_containers(n_series, n_samples, B):
        ms.ingest("bench", 0, c)
    ms.flush_all()
    eng = QueryEngine(ms, "bench", device=dev)
    start, end = BASE + 600_000, BASE + (n_samples - 10) * IV

    def q(_=None):
        eng.query_range('histogram_quantile(0.9, sum(rate(req_latency[5m])))',
                        start, end, 60_000)

    dt, it = timed(q, max_iters=30)
    emit("hist_query", "quantile_of_sum_rate", it / dt, "queries/s")
    emit("hist_query", "quantile_of_sum_rate_p50", dt / it * 1000, "ms")
    # concurrent throughput (the jmh methodology: queries in flight), 64
    # workers
    n_q = 128
    with ThreadPoolExecutor(64) as ex:
        list(ex.map(q, range(16)))
        t0 = time.perf_counter()
        list(ex.map(q, range(n_q)))
        cdt = time.perf_counter() - t0
    emit("hist_query", "quantile_of_sum_rate_concurrent", n_q / cdt, "queries/s")
    emit("hist_query", "device_marginal_ms_per_query", cdt / n_q * 1000, "ms")


def bench_query_hicard(full: bool, device=None, *, n_series=None) -> None:
    """Ref QueryHiCardInMemoryBenchmark: 8000 series, 15m @ 10s, a quarter
    queried per sum(rate) query (K1 raw on the card)."""
    from ..core.memstore import StoreConfig, TimeSeriesMemStore
    from ..core.schemas import PROM_COUNTER
    from ..query.engine import QueryEngine

    dev = resolve_device(device)
    n_series = _pick(n_series, full, 2000, 8000)
    n_samples = 90                       # 15 minutes @ 10s
    cfg = StoreConfig(max_series_per_shard=n_series, samples_per_series=128,
                      flush_batch_size=10**9, dtype="float32")
    ms = TimeSeriesMemStore(device=dev)
    ms.setup("bench", PROM_COUNTER, 0, cfg)
    for c in hicard_containers(n_series, seed=11, n_samples=n_samples):
        ms.ingest("bench", 0, c)
    ms.flush_all()
    eng = QueryEngine(ms, "bench", device=dev)
    start, end = BASE + 300_000, BASE + (n_samples - 1) * IV

    def q():
        eng.query_range('sum(rate(request_total{job="J0"}[1m]))',
                        start, end, 60_000)

    dt, it = timed(q, max_iters=30)
    emit("query_hicard", "sum_rate_quarter_series", it / dt, "queries/s")
    emit("query_hicard", "sum_rate_p50", dt / it * 1000, "ms")


def bench_query_ingest(full: bool, device=None, *, n_series=None,
                       n_samples=None) -> None:
    """Ref QueryAndIngestBenchmark: an ingest thread keeps streaming
    containers (with per-batch flushes) while concurrent query threads run —
    the reference likewise measures queries DURING ingestion (the shard's
    single ingest thread + concurrent query scheduler model,
    TimeSeriesShard.scala:258-260 + FiloSchedulers)."""
    from concurrent.futures import ThreadPoolExecutor

    from ..core.memstore import StoreConfig, TimeSeriesMemStore
    from ..core.record import RecordBuilder, RecordContainer
    from ..core.schemas import GAUGE
    from ..query.engine import QueryEngine

    dev = resolve_device(device)
    n_series = _pick(n_series, full, 400, 1000)
    n_samples = _pick(n_samples, full, 60, 100)
    containers = _gauge_containers(n_series, n_samples)
    # capacity 1024 keeps the fused single-pass path; longer retention would
    # compact, as in production
    cfg = StoreConfig(max_series_per_shard=n_series, samples_per_series=1024,
                      flush_batch_size=10**9, dtype="float32")
    ms = TimeSeriesMemStore(device=dev)
    ms.setup("bench", GAUGE, 0, cfg)
    sh = ms.shard("bench", 0)
    for c in containers[: len(containers) // 2]:
        ms.ingest("bench", 0, c)
    ms.flush_all()
    eng = QueryEngine(ms, "bench", device=dev)
    start = BASE + 120_000
    end = BASE + (n_samples // 2 - 1) * IV

    def run_query(_=None):
        eng.query_range('sum(rate(heap_usage[1m]))', start, end, 30_000)

    run_query()   # kernel build, operand caches
    # idle baseline: 16 queries in flight — a bounded dashboard load (an
    # unbounded pool measures GIL starvation of the ingest thread, not the
    # store)
    n_q = 128
    POOL = 16
    with ThreadPoolExecutor(POOL) as ex:
        list(ex.map(run_query, range(16)))   # thread warm
        t0 = time.perf_counter()
        list(ex.map(run_query, range(n_q)))
        idle_qps = n_q / (time.perf_counter() - t0)
    emit("query_ingest", "idle_query_throughput", idle_qps, "queries/s")
    emit("query_ingest", "idle_device_marginal_ms", 1000.0 / idle_qps, "ms")

    stop = threading.Event()
    ingested = [0]
    # the SLO question: sustain a FIXED scrape rate and measure what
    # concurrent queries keep. The stream is paced by wall clock and SKIPS
    # missed ticks (catch-up bursts measure the pacer, not the store)
    target_rps = 12_000 if full else 8_000

    def ingest_loop():
        # one template container per tick (1 sample per series, timestamps
        # shifted per tick); ~20 ticks staged per device flush
        b = RecordBuilder(GAUGE)
        for s in range(n_series):
            b.add({"_metric_": "heap_usage", "_ws_": "demo", "_ns_": "app",
                   "host": f"h{s}", "job": f"App-{s % 8}"}, 0, float(s))
        tpl = b.build()
        k = 0
        period = n_series / target_rps
        base = BASE + (n_samples // 2) * IV   # contiguous with the preload
        while not stop.is_set():
            t0 = time.perf_counter()
            ts = np.full(len(tpl.ts), base + k * IV, np.int64)
            c = RecordContainer(tpl.schema, ts, tpl.values, tpl.part_hash,
                                tpl.shard_hash, tpl.part_idx,
                                tpl.label_sets, tpl.bucket_les,
                                tpl.part_keys, tpl.set_hashes)
            ms.ingest("bench", 0, c)
            ingested[0] += n_series
            k += 1
            if k % 20 == 0:
                sh.flush()
            wait = period - (time.perf_counter() - t0)
            if wait > 0:
                stop.wait(wait)

    ingester = Workers()
    ingester.start(ingest_loop)
    time.sleep(0.3)
    # best of 2 rounds, as the reference measures it
    best = None
    try:
        for _ in range(2):
            # snapshot-delta instead of resetting: the ingest thread's +=
            # isn't atomic against a cross-thread reset
            snap = ingested[0]
            with ThreadPoolExecutor(POOL) as ex:
                t0 = time.perf_counter()
                list(ex.map(run_query, range(n_q)))
                dt = time.perf_counter() - t0
            if best is None or n_q / dt > best[0]:
                best = (n_q / dt, (ingested[0] - snap) / dt)
    finally:
        stop.set()
        ingester.join(timeout=10)
    emit("query_ingest", "mixed_ingest_target", target_rps, "records/s")
    emit("query_ingest", "mixed_ingest_throughput", best[1], "records/s")
    emit("query_ingest", "mixed_query_throughput", best[0], "queries/s")
    emit("query_ingest", "mixed_device_marginal_ms", 1000.0 / best[0], "ms")
    emit("query_ingest", "mixed_vs_idle_query_ratio",
         best[0] / idle_qps, "x")


def _values(r) -> np.ndarray:
    """A result's values on the host (the port's may be device tensors)."""
    return np.asarray(r.matrix.to_host().values)


def bench_serving(full: bool, device=None, *, n_series=None) -> None:
    """The query-serving fast path. Three phases on the hicard fixture:
    (a) cold-vs-warm latency — the cold query is the first on a fresh
    engine (the reference's plan-cache warm-up rows have no port:
    NO_PORT); (b) repeated-dashboard serving with the result cache on vs
    off (a hit at bit parity); (c) overload: a cost budget that admits ~2
    queries at a time under 8 honored-backoff clients — every query lands,
    the admitted cost never passes the budget, and the shed count shows
    the gate actually worked."""
    from ..core.memstore import StoreConfig, TimeSeriesMemStore
    from ..core.schemas import PROM_COUNTER
    from ..promql import parser as promql
    from ..query.engine import QueryConfig, QueryEngine
    from ..query.scheduler import AdmissionRejected

    dev = resolve_device(device)
    n_series = _pick(n_series, full, 2048, 8192)
    n_samples = 90                       # 15 minutes @ 10s
    cfg = StoreConfig(max_series_per_shard=n_series, samples_per_series=128,
                      flush_batch_size=10**9, dtype="float32")
    ms = TimeSeriesMemStore(device=dev)
    ms.setup("serve", PROM_COUNTER, 0, cfg)
    for c in hicard_containers(n_series, seed=13, n_samples=n_samples):
        ms.ingest("serve", 0, c)
    ms.flush_all()
    start, end, step = BASE + 300_000, BASE + (n_samples - 1) * IV, 60_000
    q = 'sum(rate(request_total[1m]))'

    # -- (a) cold vs warm ----------------------------------------------------
    eng = QueryEngine(ms, "serve", device=dev)

    def one(engine=eng, query=q):
        return engine.query_range(query, start, end, step)

    t0 = time.perf_counter()
    one()
    cold_ms = (time.perf_counter() - t0) * 1000
    dt, it = timed(one, max_iters=40)
    warm_ms = dt / it * 1000
    emit("serving", "cold_first_query_ms", cold_ms, "ms")
    emit("serving", "warm_p50_ms", warm_ms, "ms")
    emit("serving", "cold_vs_warm_speedup", cold_ms / warm_ms, "x")

    # -- (b) result cache on vs off ----------------------------------------
    ceng = QueryEngine(ms, "serve", device=dev,
                       config=QueryConfig(result_cache_size=64))
    r_off = one()                        # warm, uncached engine
    r_hit = ceng.query_range(q, start, end, step)   # populate
    dt, it = timed(lambda: ceng.query_range(q, start, end, step),
                   max_iters=200)
    hit_ms = dt / it * 1000
    dt, it = timed(one, max_iters=40)
    exec_ms = dt / it * 1000
    r_hit = ceng.query_range(q, start, end, step)
    assert (r_hit.exec_path or "").startswith("result-cache"), r_hit.exec_path
    parity = float(np.array_equal(_values(r_off), _values(r_hit)))
    emit("serving", "result_hit_p50_ms", hit_ms, "ms")
    emit("serving", "reexec_p50_ms", exec_ms, "ms")
    emit("serving", "result_cache_speedup", exec_ms / hit_ms, "x")
    emit("serving", "result_cache_bit_parity", parity, "bool")
    # repeated-dashboard qps, cache on vs off
    dt, it = timed(lambda: ceng.query_range(q, start, end, step),
                   max_iters=200)
    emit("serving", "dashboard_qps_cache_on", it / dt, "queries/s")
    dt, it = timed(one, max_iters=40)
    emit("serving", "dashboard_qps_cache_off", it / dt, "queries/s")

    # -- (c) overload: admission gate + honored-backoff clients ------------
    per_cost = eng.estimate_cost(
        promql.query_to_logical_plan(q, start, end, step))
    budget = per_cost * 2.5              # ~2 queries execute at a time
    aeng = QueryEngine(ms, "serve", device=dev, config=QueryConfig(
        max_concurrent_cost=budget, shed_retry_after_s=0.005))
    n_clients, per_client = 8, 6
    sheds = [0]
    landed = [0]
    peak = [0.0]
    lock = threading.Lock()

    def client():
        done = 0
        while done < per_client:
            try:
                r = aeng.query_range(q, start, end, step)
                assert r.matrix.num_series == 1
                done += 1
            except AdmissionRejected as e:
                with lock:
                    sheds[0] += 1
                time.sleep(e.retry_after_s)      # honor the hint
            with lock:
                peak[0] = max(peak[0], aeng.admission.stats()["in_use"])
        with lock:
            landed[0] += done

    t0 = time.perf_counter()
    clients = Workers()
    for _ in range(n_clients):
        clients.start(client)
    clients.join(timeout=300)
    wall = time.perf_counter() - t0
    emit("serving", "overload_budget_cost", budget, "cost")
    emit("serving", "overload_queries_landed", landed[0], "count")
    emit("serving", "overload_sheds", sheds[0], "count")
    emit("serving", "overload_peak_cost_in_use", peak[0], "cost")
    emit("serving", "overload_budget_respected",
         float(peak[0] <= budget), "bool")
    emit("serving", "overload_wall_s", wall, "s")
    assert landed[0] == n_clients * per_client, \
        "every honored-backoff client must land every query"
    assert peak[0] <= budget, "admitted cost exceeded the budget"


def _k1_against_plain(st, fn: str, out_ts: np.ndarray, window_ms: int,
                      dev) -> tuple[bool, int]:
    """K1 (the plain twin on the CPU) on a raw store's tensors against
    ``fused_grid_aggregate_plain`` on the same operands, G = 8. Returns
    (agree, K1 launches made)."""
    from ..ops import fusedgrid
    base_ts, interval_ms = st.grid_info()
    Tp = -(-max(len(out_ts), 1) // 128) * 128
    band, ohlo, lo, hi, rel, c0, Ck = fusedgrid.device_operands(
        st.C, Tp, np.ascontiguousarray(out_ts, np.int64).tobytes(),
        int(window_ms), int(base_ts), int(interval_ms),
        "window" if fn in fusedgrid.FUSED_WINDOW_FNS else "rate", False, dev)
    gids = fusedgrid.zero_gids(st.S, dev)
    k0 = _launches()[0]
    got = fusedgrid.fused_grid_partials(fn, False, int(window_ms),
                                        int(interval_ms), st.val, st.n, gids,
                                        band, ohlo, lo, hi, rel, 8, c0, Ck)
    launched = _launches()[0] - k0
    want = fusedgrid.fused_grid_aggregate_plain(
        fn, False, int(window_ms), int(interval_ms), st.val,
        st.n.to(torch.int32), gids, band, ohlo, lo, hi, rel, 8, c0, Ck)
    return _parts_agree(got, want), launched


def _k2_against_plain(st, fn: str, out_ts: np.ndarray, window_ms: int,
                      dev) -> tuple[bool, int]:
    """K2 (the plain twin on the CPU) on a hist-resident store's block
    against ``fused_hist_map_plain`` on the same operands, G = 8; rows
    outside the block's exact rows (the cohort pool) get n = 0. Returns
    (agree, K2 launches made)."""
    from ..ops import fusedgrid, fusedresident
    base_ts, interval_ms = st.grid_info()
    dd, first_d, ok = st.hist_operands()
    n = torch.where(torch.from_numpy(np.asarray(ok, bool)).to(dev), st.n,
                    torch.zeros_like(st.n)).to(torch.int32)
    Tp = -(-max(len(out_ts), 1) // 128) * 128
    ops = fusedresident.hist_device_operands(
        st.C, Tp, np.ascontiguousarray(out_ts, np.int64).tobytes(),
        int(window_ms), int(base_ts), int(interval_ms), dev)
    gids = fusedgrid.zero_gids(st.S, dev)
    k0 = _launches()[1]
    got = fusedresident.fused_hist_map(fn, int(window_ms), int(interval_ms),
                                       dd, first_d, n, gids, ops, 8)
    launched = _launches()[1] - k0
    want = fusedresident.fused_hist_map_plain(
        fn, int(window_ms), int(interval_ms), dd, first_d, n, gids, ops.band,
        ops.plo, ops.lo, ops.hi, ops.rel, 8)
    return _parts_agree(got, want), launched


def bench_fused_resident(full: bool, device=None, *, n_series=None,
                         n_hist=None, scatter_rows=None) -> dict:
    """The fused compressed-resident kernel tier. Per-shape A/B of the
    fused path (the hand kernels: K1 for the scalar shapes, K2 for
    hist_quantile over an "all" store) against the composed two-step chain
    (``query.fused_kernels="off"``) at matched fixtures; plus the
    flush-path row: the port's in-place scatter against a clone-then-write
    twin of the same body. Both legs run warm.

    Fixtures are the shapes the tier exists for: high-cardinality
    dashboards (many series, a fine step grid, T steps >> C stored
    samples), where the composed chain materializes the [S, Tp] / [S,
    Tp*B] windowed intermediate and re-reads it for the reduce.

    Parity: the kernel's partials against its plain twin on the same
    tensors (counts exact, sums within rtol 1e-5 of the largest
    magnitude); against the composed oracle the max relative delta (the
    per-tile f32 fold sums in another order than the oracle's), asserted
    <= 2e-5 as the reference does. The "off" leg launches no kernel.

    Returns, for a caller that counts kernel launches, ``{"legs": {shape:
    {"off" | "fused": {"k1", "k2", "values", "route", "queries"}}},
    "compare_launches": {"k1", "k2"}}``: each leg's launches, answer and
    route, and the launches made only to hold a kernel against its plain
    twin (not on a query's path)."""
    from ..core.memstore import StoreConfig, TimeSeriesMemStore
    from ..core.schemas import PROM_COUNTER, PROM_HISTOGRAM
    from ..ops import fusedresident
    from ..query.engine import QueryEngine

    dev = resolve_device(device)
    n_series = _pick(n_series, full, 16384, 32768)
    n_samp = 48          # 30s scrape over a 23-minute retention window
    siv = 30_000
    n_hist = _pick(n_hist, full, 4096, 8192)
    nh_samp = 32         # 10s scrape, 32-bucket latency histograms
    nb = 32

    def scalar_store():
        ms = TimeSeriesMemStore(device=dev)
        cfg = StoreConfig(max_series_per_shard=n_series,
                          samples_per_series=n_samp,
                          flush_batch_size=10**9, dtype="float32")
        ms.setup("fr", PROM_COUNTER, 0, cfg)
        for c in fused_scalar_containers(n_series, n_samp, siv):
            ms.ingest("fr", 0, c)
        ms.flush_all()
        return ms

    def hist_store():
        ms = TimeSeriesMemStore(device=dev)
        sh = ms.setup("frh", PROM_HISTOGRAM, 0,
                      StoreConfig(max_series_per_shard=n_hist,
                                  samples_per_series=nh_samp,
                                  flush_batch_size=10**9, dtype="float32",
                                  compressed_residency="all"))
        for c in fused_hist_containers(n_hist, nh_samp, nb):
            ms.ingest("frh", 0, c)
        sh.flush()
        assert sh.store.is_narrow_resident
        return ms

    # dashboard step grids: T steps >> C stored cells (step finer than the
    # scrape interval — Grafana auto-intervals on a zoomed panel)
    sc_range = (BASE + 240_000, BASE + (n_samp - 2) * siv, 2_500)
    h_range = (BASE + 120_000, BASE + (nh_samp - 2) * IV, 2_500)
    old_mode = fusedresident.mode()
    sstore = scalar_store()          # shared: both scalar shapes, one build
    shapes = [
        ("rate_sum", sstore, "fr", "sum(rate(rt[2m]))", sc_range,
         "rate", 120_000),
        ("window_reduce", sstore, "fr", "sum(avg_over_time(rt[2m]))",
         sc_range, "avg_over_time", 120_000),
        ("hist_quantile", hist_store(), "frh",
         "histogram_quantile(0.9, sum(rate(h[1m])))", h_range, "rate",
         60_000),
    ]
    legs_of: dict = {}
    compare = {"k1": 0, "k2": 0}
    try:
        for shape, ms, ds, q, (start, end, step), fn, window in shapes:
            eng = QueryEngine(ms, ds, device=dev)
            res = {}
            for mode, leg in (("off", "off"), ("pallas", "fused")):
                fusedresident.set_mode(mode)
                k0 = _launches()
                r0 = eng.query_range(q, start, end, step)   # warm
                dt, iters = timed(
                    lambda: eng.query_range(q, start, end, step))
                k1 = _launches()
                ms_q = dt / iters * 1000
                res[leg] = (ms_q, _values(r0))
                legs_of.setdefault(shape, {})[leg] = {
                    "k1": k1[0] - k0[0], "k2": k1[1] - k0[1],
                    "values": res[leg][1], "route": r0.exec_path,
                    "queries": iters + 2}
                emit("fused_resident", f"{shape}_{leg}_ms", ms_q, "ms")
            legs = legs_of[shape]
            assert legs["off"]["k1"] == legs["off"]["k2"] == 0, \
                f"{shape}: the composed chain launched a fused kernel"
            if dev.type == "cuda":
                assert legs["fused"]["k1" if shape != "hist_quantile"
                                     else "k2"] > 0, \
                    f"{shape}: the fused leg launched no kernel"
            # the kernel against its plain twin on the same tensors
            st = ms.shards_of(ds)[0].store
            out_ts = np.arange(start, end + 1, step, dtype=np.int64)
            if shape == "hist_quantile":
                kparity, n = _k2_against_plain(st, fn, out_ts, window, dev)
                compare["k2"] += n
            else:
                kparity, n = _k1_against_plain(st, fn, out_ts, window, dev)
                compare["k1"] += n
            emit("fused_resident", f"{shape}_kernel_plain_parity",
                 float(kparity), "bool")
            assert kparity, f"{shape}: the kernel disagrees with its twin"
            # vs the composed oracle: exact at single-tile, f32 fold-order
            # delta at this scale (see docstring)
            with np.errstate(all="ignore"):
                o = res["off"][1]
                f = res["fused"][1]
                maxrel = float(np.nanmax(np.abs(f - o)
                                         / np.maximum(np.abs(o), 1e-12),
                                         initial=0.0))
            emit("fused_resident", f"{shape}_oracle_exact",
                 float(np.array_equal(f, o, equal_nan=True)), "bool")
            emit("fused_resident", f"{shape}_oracle_maxrel_ppm",
                 maxrel * 1e6, "ppm")
            assert maxrel <= 2e-5, (shape, maxrel)
            emit("fused_resident", f"{shape}_speedup_fused_x",
                 res["off"][0] / res["fused"][0], "x")
    finally:
        fusedresident.set_mode(old_mode)
    del sstore, shapes

    # -- flush-path scatter: the port writes a staged commit into the
    # preallocated [S, C] ts+val tensors in place (core/chunkstore.py's
    # append); the clone-then-write twin of the same body allocates and
    # writes a full copy of both blocks per commit
    S = _pick(scatter_rows, full, 32768, 65536)
    C, m = 512, 4096
    ts = torch.full((S, C), 1 << 62, dtype=torch.int64, device=dev)
    val = torch.zeros((S, C), dtype=torch.float32, device=dev)
    n = torch.zeros(S, dtype=torch.int32, device=dev)
    rows = torch.arange(m, dtype=torch.int64, device=dev) % S
    cols = torch.zeros(m, dtype=torch.int64, device=dev)
    new_ts = torch.full((m,), BASE, dtype=torch.int64, device=dev)
    new_val = torch.ones(m, dtype=torch.float32, device=dev)
    counts = torch.zeros(S, dtype=torch.int32, device=dev)

    def inplace():
        ts.index_put_((rows, cols), new_ts)
        val.index_put_((rows, cols), new_val)
        n.add_(counts)
        sync(dev)

    def copied():
        t2 = ts.clone()
        t2.index_put_((rows, cols), new_ts)
        v2 = val.clone()
        v2.index_put_((rows, cols), new_val)
        n + counts
        sync(dev)

    dt_c, it_c = timed(copied, min_s=0.5)
    dt_d, it_d = timed(inplace, min_s=0.5)
    ms_d, ms_c = dt_d / it_d * 1000, dt_c / it_c * 1000
    bytes_saved = S * C * (8 + 4)      # the ts+val copy that never exists
    emit("fused_resident", "flush_scatter_inplace_ms", ms_d, "ms")
    emit("fused_resident", "flush_scatter_copy_ms", ms_c, "ms")
    emit("fused_resident", "flush_scatter_speedup_x", ms_c / ms_d, "x")
    emit("fused_resident", "flush_alloc_saved_mb", bytes_saved / 2**20, "MB")
    return {"legs": legs_of, "compare_launches": compare}


def bench_count_values(full: bool, device=None, *, n_series=None) -> None:
    """Mesh count_values closure: count_values is the one aggregation whose
    reduce stays a HOST merge (partial state keyed by rendered value
    strings — no fixed-size device layout to gather). Measure the host
    merge's share of total query time at bench scale over 8 shards; the
    mesh exclusion stands while the fraction is small."""
    from ..core.memstore import StoreConfig, TimeSeriesMemStore
    from ..core.record import RecordBuilder
    from ..core.schemas import GAUGE
    from ..promql import parser as promql
    from ..query.engine import QueryEngine
    from ..query.exec import _merge_heterogeneous

    dev = resolve_device(device)
    nshards = 8
    n_series = _pick(n_series, full, 1024, 8192)
    n_samples = 120 if full else 60
    per = n_series // nshards
    cfg = StoreConfig(max_series_per_shard=per,
                      samples_per_series=n_samples + 8,
                      flush_batch_size=10**9, dtype="float32")
    ms = TimeSeriesMemStore(device=dev)
    ts_arr = BASE + np.arange(n_samples, dtype=np.int64) * IV
    for s, shard_vals in enumerate(count_values_values(nshards, per,
                                                       n_samples)):
        ms.setup("bench", GAUGE, s, cfg)
        b = RecordBuilder(GAUGE)
        for i, vals in enumerate(shard_vals):
            # small-int values: the realistic count_values shape (status
            # codes, bucketed levels) — distinct-value count stays bounded
            b.add_batch({"_metric_": "m_cv", "host": f"h{s}-{i}"},
                        ts_arr, vals)
        ms.ingest("bench", s, b.build())
    ms.flush_all()
    eng = QueryEngine(ms, "bench", device=dev)
    start, end = BASE + 120_000, BASE + (n_samples - 1) * IV

    def q(_=None):
        eng.query_range('count_values("v", m_cv)', start, end, 60_000)

    dt, it = timed(q, max_iters=20)
    total_ms = dt / it * 1000
    emit("count_values", "query_ms", total_ms, "ms")

    # isolate the host merge: per-shard map-phase partials captured once,
    # then the reduce (merge + present) timed on its own
    plan = promql.query_to_logical_plan('count_values("v", m_cv)', start, end,
                                        60_000)
    ep = eng.planner.materialize(plan)
    ctx = eng._ctx()
    partials = [c.execute(ctx) for c in ep.children]
    presenter = ep.transformers[0]

    def merge(_=None):
        presenter.apply(_merge_heterogeneous(
            partials, "count_values", ("v",), (), (), dev), ctx)

    dt, it = timed(merge, max_iters=50)
    merge_ms = dt / it * 1000
    emit("count_values", "host_merge_ms", merge_ms, "ms")
    emit("count_values", "host_merge_fraction", merge_ms / total_ms, "x")
    emit("count_values", "series", n_series, "count")


def bench_mesh_query(full: bool, device=None, *, per_shard=None) -> None:
    """Per-query dispatch floor of the mesh path vs the host shard loop, at
    the hicard fixture sharded 8 ways (full: 8 shards x 2048 series x 48
    samples f32 counter = 16384x48). Two engines over bit-identical
    ingests — one mesh-configured (each shard's store on its mesh card,
    shard i on card i % ndev), one plain (the scatter-gather host loop
    runs 8 per-shard legs and merges partials on the host) — serve the
    same sum(rate) dashboard query. Emitted: p50 ms per query for the host
    loop and the mesh (its one mode, eager: the reference's pjit and
    shard_map programs have no port, NO_PORT/RENAMED), the leaf compute
    floor every orchestration runs (K1 on each shard, one synchronise),
    each path's overhead above it, the mesh/host ratios, and bit_parity
    (EXACT equality of the rendered matrices — the host-order f64 fold
    contract, not allclose)."""
    from ..core.memstore import StoreConfig, TimeSeriesMemStore
    from ..core.record import RecordBuilder
    from ..core.schemas import PROM_COUNTER
    from ..ops import fusedgrid, fusedresident
    from ..parallel.distributed import make_mesh
    from ..query.engine import QueryEngine

    dev = resolve_device(device)
    n_shards = 8
    per_shard = _pick(per_shard, full, 256, 2048)
    n_samples = 48
    cfg = StoreConfig(max_series_per_shard=per_shard, samples_per_series=64,
                      flush_batch_size=10**9, dtype="float32")
    mesh = make_mesh() if dev.type == "cuda" else make_mesh([dev] * n_shards)
    mesh_ms = TimeSeriesMemStore(device=dev)
    host_ms = TimeSeriesMemStore(device=dev)
    for s in range(n_shards):
        mesh_ms.setup("meshq", PROM_COUNTER, s, cfg,
                      device=mesh[s % len(mesh)])
        host_ms.setup("meshq", PROM_COUNTER, s, cfg)
    ts_arr = BASE + np.arange(n_samples, dtype=np.int64) * IV
    for s, vals in enumerate(mesh_values(n_shards * per_shard, n_samples)):
        for ms in (mesh_ms, host_ms):
            b = RecordBuilder(PROM_COUNTER)
            b.add_batch({"_metric_": "request_total", "instance": f"i{s}"},
                        ts_arr, vals)
            ms.ingest("meshq", s % n_shards, b.build())
    mesh_ms.flush_all()
    host_ms.flush_all()
    mesh_eng = QueryEngine(mesh_ms, "meshq", device=dev, mesh=mesh)
    host_eng = QueryEngine(host_ms, "meshq", device=dev)
    query = 'sum(rate(request_total[1m]))'
    start, end, step = BASE + 120_000, BASE + 460_000, 20_000

    r_mesh = mesh_eng.query_range(query, start, end, step)
    assert r_mesh.exec_path.startswith("mesh"), r_mesh.exec_path

    def render(r):
        return sorted((k.labels, ts.tobytes(),
                       np.asarray(v, np.float64).tobytes())
                      for k, ts, v in r.matrix.iter_series())

    out = {}

    def run(eng, tag):
        def q():
            r = eng.query_range(query, start, end, step)
            _values(r)                   # force the fold/fetch: the mesh
            out[tag] = r                 # result is lazy until rendered
        dt, it = timed(q, max_iters=30)
        return dt / it * 1000

    results = {"host_loop_p50": run(host_eng, "host"),
               "mesh_eager_p50": run(mesh_eng, "mesh")}
    assert out["mesh"].exec_path.startswith("mesh"), out["mesh"].exec_path

    # the leaf compute EVERY orchestration must execute: the same fused
    # kernel over each shard's resident block, launched back-to-back with
    # no per-shard fetch, synchronised once. Subtracting it isolates
    # per-query ORCHESTRATION overhead
    out_ts_arr = np.arange(start, end + 1, step, dtype=np.int64)
    leaf_shards = [host_ms.shard("meshq", s) for s in range(n_shards)]

    def floor_q():
        for sh in leaf_shards:
            st = sh.store
            fusedresident.scalar_aggregate(
                "sum", "rate", st.value_block(), st.n,
                fusedgrid.zero_gids(st.S, st.n.device), 1, out_ts_arr,
                60_000, BASE, IV, fetch=False)
        sync(dev)

    dt, it = timed(floor_q, max_iters=30)
    floor = dt / it * 1000
    emit("mesh_query", "shards", n_shards, "count")
    emit("mesh_query", "series", n_shards * per_shard, "count")
    emit("mesh_query", "samples", n_samples, "count")
    for tag, v in results.items():
        emit("mesh_query", tag, v, "ms")
    emit("mesh_query", "leaf_compute_floor_p50", floor, "ms")
    over = {t: max(v - floor, 0.0) for t, v in results.items()}
    emit("mesh_query", "host_loop_overhead_p50", over["host_loop_p50"], "ms")
    emit("mesh_query", "mesh_eager_overhead_p50", over["mesh_eager_p50"],
         "ms")
    emit("mesh_query", "mesh_eager_vs_host_total_ratio",
         results["mesh_eager_p50"] / results["host_loop_p50"], "x")
    emit("mesh_query", "mesh_eager_vs_host_ratio",
         over["mesh_eager_p50"] / max(over["host_loop_p50"], 1e-9), "x")
    parity = render(out["host"]) == render(out["mesh"])
    emit("mesh_query", "bit_parity", float(parity), "bool")
    assert parity, "the mesh answer differs from the host loop's"


def _filled_store(dev, S: int, C: int, NS: int, fill, seed: int):
    """(memstore, shard): ``S`` gauge series ``m`` registered through the
    real ingest path (``add_series_batch`` -> ``shard.ingest``, the staged
    registration samples dropped), then ``NS`` samples a series written into
    the store on ``dev`` from ``torch.Generator(seed)``: ``fill(g, rows)``
    gives the [rows, NS] f32 values of ``DATA_BATCH`` rows at a time, on a
    10 s grid from BASE. Its residency setting is "off", so no flush (a
    query's selection flushes) compresses it: it stays raw until
    :func:`_compress` adopts the compressed form, as the reference's
    suites do with ``compress_resident()``."""
    from ..core.chunkstore import TS_PAD
    from ..core.memstore import StoreConfig, TimeSeriesMemStore
    from ..core.record import RecordBuilder
    from ..core.schemas import GAUGE
    ms = TimeSeriesMemStore(device=dev)
    sh = ms.setup("prometheus", GAUGE, 0, StoreConfig(
        max_series_per_shard=S, samples_per_series=C, flush_batch_size=10**9,
        dtype="float32"))
    b = RecordBuilder(GAUGE)
    b.add_series_batch({"_metric_": "m",
                        "host": [f"h{i}" for i in range(S)]}, BASE, 0.0)
    sh.ingest(b.build())
    sh.discard_staged()
    st = sh.store
    g = torch.Generator(device=dev).manual_seed(seed)
    row = BASE + torch.arange(NS, dtype=torch.int64, device=dev) * IV
    with sh.lock:
        for r0 in range(0, S, DATA_BATCH):
            rows = min(DATA_BATCH, S - r0)
            st.val[r0:r0 + rows, :NS] = fill(g, rows)
        st.val[:, NS:] = 0.0
        st.ts[:, :NS] = row
        st.ts[:, NS:] = int(TS_PAD)
        st.n.fill_(NS)
        st.n_host[:] = NS
        st.first_ts[:] = BASE
        st.last_ts[:] = BASE + (NS - 1) * IV
        st.grid_base, st.grid_interval, st.grid_ok = BASE, IV, True
        st._cohorts = None
        # a direct write of query-visible rows: bump the epoch and lead as
        # the staged flush it stands in for would
        sh._bump_epoch_locked(BASE)
        sh.visible_lead_ms = BASE + (NS - 1) * IV
    sync(dev)
    return ms, sh


def _compress(sh) -> None:
    """Adopt the compressed-resident form now: the store's two-phase
    compression (prepare without the lock, commit under it)."""
    st = sh.store
    prep = st.compress_prepare()
    assert prep is not None, f"data must compress ({st.residency_decline})"
    with sh.lock:
        st.compress_commit(prep)
    sync(st.n.device)


def _marginal_ms(eng, q, start, end, step, K=24, reps=3) -> float:
    """Per-query ms: K back-to-back queries, median of reps (the same
    methodology as bench.py)."""
    eng.query_range(q, start, end, step)               # warm
    outs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(K):
            eng.query_range(q, start, end, step)
        outs.append((time.perf_counter() - t0) / K * 1000)
    return sorted(outs)[len(outs) // 2]


def _one_series(r) -> np.ndarray:
    (_k, _t, v), = list(r.matrix.iter_series())
    return np.asarray(v).copy()


def bench_narrow_resident(full: bool, device=None, *, S=None) -> None:
    """Compressed-resident store (``compressed_residency="gauge"``, the
    reference's legacy ``narrow_resident=True``): retention per device byte
    vs the raw f32 store, bit parity of the flagship aggregate, and the
    fused path's per-query ms ratio. Ref: doc/compression.md +
    DoubleVector.scala — the reference's read path keeps values only
    compressed; here the narrow block + grid-derived timestamps replace the
    12 B/sample raw blocks. Data: integer increments in [1, 50) cumulated,
    from ``torch.Generator(3)`` (the reference's ``jax.random`` fill: same
    seed and distribution, other bits)."""
    from ..query.engine import QueryEngine

    dev = resolve_device(device)
    S = _pick(S, full, 1 << 14, 1 << 20)
    C = 768 if full else 256
    NS = 720 if full else 200

    def fill(g, rows):
        inc = torch.randint(1, 50, (rows, NS), generator=g, device=dev)
        return torch.cumsum(inc.to(torch.float32), 1)

    start = BASE + 300_000
    end = BASE + (NS - 1) * IV
    q = "sum(rate(m[5m]))"

    ms, sh = _filled_store(dev, S, C, NS, fill, 3)
    eng = QueryEngine(ms, "prometheus", device=dev)
    f32_ms = _marginal_ms(eng, q, start, end, 150_000)
    f32_bytes = sh.store.resident_sample_bytes()
    a = _one_series(eng.query_range(q, start, end, 150_000))
    # in place: the raw blocks' memory goes as the compressed form comes
    _compress(sh)
    st = sh.store
    assert st.is_narrow_resident and st.val is None and st.ts is None
    eng = QueryEngine(ms, "prometheus", device=dev)
    nr_ms = _marginal_ms(eng, q, start, end, 150_000)
    nr_bytes = st.resident_sample_bytes()
    b = _one_series(eng.query_range(q, start, end, 150_000))
    # bit parity of the flagship aggregate between residencies
    assert np.array_equal(a, b), "narrow-resident query diverged"

    retention = f32_bytes / max(nr_bytes, 1)
    emit("narrow_resident", "resident_bytes_f32", f32_bytes, "bytes")
    emit("narrow_resident", "resident_bytes_narrow", nr_bytes, "bytes")
    emit("narrow_resident", "retention_multiple_at_fixed_hbm", retention, "x")
    emit("narrow_resident", "fused_ms_f32", f32_ms, "ms/query")
    emit("narrow_resident", "fused_ms_narrow", nr_ms, "ms/query")
    emit("narrow_resident", "fused_ratio_narrow_vs_f32", nr_ms / f32_ms, "x")
    emit("narrow_resident", "bit_parity", 1.0, "bool")


def bench_scalar_residency(full: bool, device=None, *, S=None) -> None:
    """Scalar narrow residency: the delta8/quant16/delta16 preference ladder
    on gauge/counter stores. Measures retention at fixed device memory for
    the counter-shaped delta8 path (bar: >= 3x vs the 12 B/sample raw
    f32+i64 store), the fused query's per-query ms A/B (the bytes/sample
    effect on the streamed operand), per-kind resident bytes/sample, and
    the encode-at-flush cost (``compress_prepare``, the flush path's
    encode). Each data shape's store is queried raw (K1 raw), compressed
    in place, and queried again through its kind's K1 variant, bit for bit
    the raw answer. Data from ``torch.Generator(17)`` (the reference's
    ``jax.random`` fills: same seed and distributions, other bits)."""
    from ..query.engine import QueryEngine

    dev = resolve_device(device)
    S = _pick(S, full, 1 << 14, 1 << 20)
    C = 768 if full else 256
    NS = 720 if full else 200

    def filler(shape):
        def fill(g, rows):
            if shape == "counter":      # small int increments -> delta8
                inc = torch.randint(1, 50, (rows, NS), generator=g,
                                    device=dev)
                return torch.cumsum(inc, 1).to(torch.float32)
            if shape == "halfint":      # 0.5 steps: non-integral -> quant16
                a0 = torch.randint(0, 1000, (rows, 1), generator=g,
                                   device=dev)
                return a0.to(torch.float32) + 0.5 * torch.arange(
                    NS, device=dev, dtype=torch.float32)
            # big odd increments -> delta16
            inc = torch.randint(100, 3000, (rows, NS), generator=g,
                                device=dev) * 2 + 1
            return torch.cumsum(inc, 1).to(torch.float32)
        return fill

    start = BASE + 300_000
    end = BASE + (NS - 1) * IV
    q = "sum(rate(m[5m]))"

    # ---- raw f32 A-side: fused ms, bytes, parity sample, encode cost
    ms, sh = _filled_store(dev, S, C, NS, filler("counter"), 17)
    st = sh.store
    eng = QueryEngine(ms, "prometheus", device=dev)
    f32_ms = _marginal_ms(eng, q, start, end, 150_000)
    f32_bytes = st.resident_sample_bytes()
    a = _one_series(eng.query_range(q, start, end, 150_000))
    # encode-at-flush: compress_prepare is the lock-free encode the flush
    # path pays; time it hot (prep discarded, store stays raw)

    def encode():
        st.compress_prepare()
        sync(dev)
    dt, it = timed(encode, min_s=0.5, max_iters=20)
    enc_ms = dt / it * 1000
    emit("scalar_residency", "encode_flush_ms", enc_ms, "ms")
    emit("scalar_residency", "encode_flush_throughput",
         st.val.numel() * 4 / (dt / it) / 1e9, "GB/s")

    # ---- narrow B-side: counter data lands on delta8 (1 B/sample values)
    _compress(sh)
    assert st.is_narrow_resident and st.val is None and st.ts is None
    kind = st.narrow_operands()[0]
    assert kind == "delta8", f"counter data must land on delta8, got {kind}"
    eng = QueryEngine(ms, "prometheus", device=dev)
    nr_ms = _marginal_ms(eng, q, start, end, 150_000)
    nr_bytes = st.resident_sample_bytes()
    bvals = _one_series(eng.query_range(q, start, end, 150_000))
    assert np.array_equal(a, bvals), "delta8-resident query diverged"
    del ms, sh, st, eng

    retention = f32_bytes / max(nr_bytes, 1)
    assert retention >= 3.0, f"retention multiple {retention:.2f} < 3x"
    emit("scalar_residency", "resident_bytes_f32", f32_bytes, "bytes")
    emit("scalar_residency", "resident_bytes_delta8", nr_bytes, "bytes")
    emit("scalar_residency", "retention_multiple_at_fixed_hbm", retention, "x")
    emit("scalar_residency", "fused_ms_f32", f32_ms, "ms/query")
    emit("scalar_residency", "fused_ms_delta8", nr_ms, "ms/query")
    emit("scalar_residency", "fused_ratio_delta8_vs_f32", nr_ms / f32_ms, "x")
    emit("scalar_residency", "bit_parity", 1.0, "bool")

    # ---- the rest of the ladder: adopted kind + resident bytes/sample,
    # and the kind's K1 variant bit for bit the raw answer
    for shape, want in (("halfint", "quant16"), ("bigodd", "delta16")):
        ms_k, sh_k = _filled_store(dev, S, C, NS, filler(shape), 17)
        eng = QueryEngine(ms_k, "prometheus", device=dev)
        raw = _one_series(eng.query_range(q, start, end, 150_000))
        _compress(sh_k)
        stk = sh_k.store
        kind = stk.narrow_operands()[0]
        assert kind == want, f"{shape} data must land on {want}, got {kind}"
        got = _one_series(eng.query_range(q, start, end, 150_000))
        assert np.array_equal(raw, got), f"{want}-resident query diverged"
        emit("scalar_residency", f"bytes_per_sample_{want}",
             stk.resident_sample_bytes() / (S * NS), "B/sample")
        del ms_k, sh_k, stk, eng
    emit("scalar_residency", "bytes_per_sample_delta8",
         nr_bytes / (S * NS), "B/sample")
    emit("scalar_residency", "bytes_per_sample_f32",
         f32_bytes / (S * NS), "B/sample")


def bench_hist_retention(full: bool, device=None, *, n_series=None) -> None:
    """Compressed-resident HISTOGRAM store (compressed_residency="all"):
    series-at-fixed-memory retention vs the raw f32 [S, C, B] store, plus
    quantile-of-sum-of-rate parity and ms between residencies (K2 serves
    the "all" store's query where its gate admits the shape). Ref:
    doc/compression.md "Histograms" — the reference's in-memory histogram
    vectors are 2D-delta compressed; this is the device-resident analog
    (i8/i16 dd blocks + first-frame deltas)."""
    from ..core.memstore import StoreConfig, TimeSeriesMemStore
    from ..core.record import RecordBuilder
    from ..core.schemas import PROM_HISTOGRAM
    from ..query.engine import QueryEngine

    dev = resolve_device(device)
    n_series = _pick(n_series, full, 64, 2000)
    n_samples, B = (300, 64) if full else (120, 32)
    les = hist_les(B)
    ts_arr = BASE + np.arange(n_samples, dtype=np.int64) * IV
    data = hist_counts(n_series, n_samples, B, seed=12)

    def build(mode: str):
        ms = TimeSeriesMemStore(device=dev)
        cfg = StoreConfig(max_series_per_shard=n_series,
                          samples_per_series=n_samples + 8,
                          flush_batch_size=10**9, dtype="float32",
                          compressed_residency=mode)
        sh = ms.setup("bench", PROM_HISTOGRAM, 0, cfg)
        for s in range(n_series):
            b = RecordBuilder(PROM_HISTOGRAM, bucket_les=les)
            b.add_batch({"_metric_": "req_latency", "host": f"h{s}"},
                        ts_arr, data[s])
            ms.ingest("bench", 0, b.build())
        ms.flush_all()
        return ms, sh

    start, end = BASE + 600_000, BASE + (n_samples - 10) * IV
    q = 'histogram_quantile(0.9, sum(rate(req_latency[5m])))'

    def series_result(eng):
        return _one_series(eng.query_range(q, start, end, 60_000))

    ms_raw, sh_raw = build("off")
    e_raw = QueryEngine(ms_raw, "bench", device=dev)
    raw_bytes = sh_raw.store.resident_sample_bytes()
    dt, it = timed(lambda: series_result(e_raw), max_iters=20)
    raw_ms = dt / it * 1000
    a = series_result(e_raw)
    del ms_raw, sh_raw, e_raw

    ms_c, sh_c = build("all")
    st = sh_c.store
    assert st.is_narrow_resident and st.val is None and st.ts is None, \
        "hist store must adopt compressed residency"
    e_c = QueryEngine(ms_c, "bench", device=dev)
    dt, it = timed(lambda: series_result(e_c), max_iters=20)
    nr_ms = dt / it * 1000
    b = series_result(e_c)
    # bit for bit where both residencies fold alike (the CPU's plain twins,
    # the reference's one tiling plan); on the card K2 folds its per-block
    # partials in its own order, so the answers are held to the bar and
    # bit_parity says whether they were also bit for bit
    parity = np.array_equal(a, b)
    assert parity or _within_bar(b, a), "hist-resident quantile diverged"
    nr_bytes = st.resident_sample_bytes()

    retention = raw_bytes / max(nr_bytes, 1)
    emit("hist_retention", "resident_bytes_f32", raw_bytes, "bytes")
    emit("hist_retention", "resident_bytes_compressed", nr_bytes, "bytes")
    emit("hist_retention", "retention_multiple_at_fixed_hbm", retention, "x")
    emit("hist_retention", "series_at_fixed_hbm_multiple", retention, "x")
    emit("hist_retention", "dd_dtype_bits",
         st._nhist[0].element_size() * 8, "bits")
    emit("hist_retention", "quantile_of_sum_rate_ms_f32", raw_ms, "ms")
    emit("hist_retention", "quantile_of_sum_rate_ms_compressed", nr_ms, "ms")
    emit("hist_retention", "fused_ratio_compressed_vs_f32",
         nr_ms / max(raw_ms, 1e-9), "x")
    emit("hist_retention", "bit_parity", float(parity), "bool")


def bench_odp(full: bool, device=None, *, n_series=None,
              n_samples=None) -> None:
    """Ref QueryOnDemandBenchmark: evict resident data, then query a COLD
    range — every query merges sink chunks with the resident tail through
    paging. Reports first-touch latency (page-in, first use), steady
    cold-query page-in ms / qps, and the resident-range baseline for
    contrast."""
    import shutil
    import tempfile

    from ..core.memstore import StoreConfig, TimeSeriesMemStore
    from ..core.record import RecordBuilder
    from ..core.schemas import GAUGE
    from ..core.store import FileColumnStore
    from ..query.engine import QueryEngine

    dev = resolve_device(device)
    n_series = _pick(n_series, full, 400, 2000)
    n_samples = _pick(n_samples, full, 120, 240)
    tmp = tempfile.mkdtemp(prefix="filodb_odp_")
    try:
        cfg = StoreConfig(max_series_per_shard=n_series,
                          samples_per_series=n_samples + 8,
                          flush_batch_size=10**9, dtype="float32")
        ms = TimeSeriesMemStore(device=dev)
        sh = ms.setup("bench", GAUGE, 0, cfg, sink=FileColumnStore(tmp))
        ts_arr = BASE + np.arange(n_samples, dtype=np.int64) * IV
        b = RecordBuilder(GAUGE)
        for s, vals in enumerate(odp_values(n_series, n_samples)):
            b.add_batch({"_metric_": "m_odp", "host": f"h{s}"}, ts_arr, vals)
        ms.ingest("bench", 0, b.build())
        ms.flush_all()
        # evict the early two thirds: resident data starts at `cut`, the
        # cold range below it pages from the sink on every query
        cut = BASE + (2 * n_samples // 3) * IV
        # before any engine exists: no cached answer can go stale, so no
        # epoch is owed (the reference compacts the store directly too)
        sh.store.compact(cut)  # filolint: ignore[epoch-undeclared-visibility]
        eng = QueryEngine(ms, "bench", device=dev)
        cold_start, cold_end = BASE + 120_000, cut - IV
        hot_start, hot_end = cut + 60_000, BASE + (n_samples - 1) * IV

        def q_cold(_=None):
            eng.query_range('sum(rate(m_odp[1m]))', cold_start, cold_end,
                            60_000)

        def q_hot(_=None):
            eng.query_range('sum(rate(m_odp[1m]))', hot_start, hot_end,
                            60_000)

        t0 = time.perf_counter()
        q_cold()
        emit("odp", "cold_first_touch_ms",
             (time.perf_counter() - t0) * 1000, "ms")   # first page-in
        dt, it = timed(q_cold, max_iters=20)
        emit("odp", "cold_query_page_in_ms", dt / it * 1000, "ms")
        emit("odp", "cold_query_qps", it / dt, "queries/s")
        emit("odp", "paged_series_per_s", n_series * it / dt, "series/s")
        dt, it = timed(q_hot, max_iters=20)
        emit("odp", "resident_query_ms", dt / it * 1000, "ms")
        emit("odp", "series", n_series, "count")
        emit("odp", "cold_samples_per_series",
             (cold_end - BASE) // IV, "samples")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def bench_retention(full: bool, device=None, *, days=None,
                    n_series=None) -> None:
    """Retention tiering: a (scaled) year of synthetic data answered at
    three resolutions through the retention router (latency + qps per
    resolution), a cold month-long rate() over evicted series paged from
    the replicated durable StoreServer tier at measured qps, and a
    kill-one-replica run proving reads AND writes continue (ref: the
    reference's downsample cluster + Cassandra chunk store)."""
    import shutil
    import tempfile

    from ..core.diststore import (RemoteStore, ReplicatedColumnStore,
                                  StoreServer)
    from ..core.downsample import ds_family
    from ..core.memstore import StoreConfig, TimeSeriesMemStore
    from ..core.record import RecordBuilder
    from ..core.schemas import GAUGE
    from ..jobs.batch_downsampler import load_downsampled, run_batch_downsample
    from ..query.engine import QueryEngine
    from ..query.retention import (RetentionPolicy, RetentionRouter,
                                   resolution_label)
    from ..utils.metrics import (FILODB_RETENTION_ODP_ROWS,
                                 FILODB_RETENTION_REPLICA_FAILOVER, registry)

    dev = resolve_device(device)
    RAW_IV = 300_000                       # 5m raw scrape interval
    H1, H6 = 3_600_000, 21_600_000
    DAY = 86_400_000
    days = _pick(days, full, 60, 365)
    n_series = _pick(n_series, full, 8, 16)
    n_samples = days * DAY // RAW_IV
    tmp = tempfile.mkdtemp(prefix="filodb_retention_")
    servers = [StoreServer(f"{tmp}/node{i}").start() for i in range(2)]
    stores = [RemoteStore(f"127.0.0.1:{s.port}", timeout_s=5.0,
                          connect_timeout_s=2.0) for s in servers]
    repl = ReplicatedColumnStore(stores, replication=2)
    try:
        cfg = StoreConfig(max_series_per_shard=n_series,
                          samples_per_series=1 << (n_samples - 1).bit_length(),
                          flush_batch_size=10**9, groups_per_shard=4,
                          dtype="float64")
        ms = TimeSeriesMemStore(device=dev)
        sh = ms.setup("bench", GAUGE, 0, cfg, sink=repl)
        ts_arr = BASE + np.arange(n_samples, dtype=np.int64) * RAW_IV
        t0 = time.perf_counter()
        b = RecordBuilder(GAUGE)
        for s, vals in enumerate(retention_values(n_series, n_samples)):
            b.add_batch({"_metric_": "m", "host": f"h{s}"}, ts_arr, vals)
        sh.ingest(b.build(), offset=0)
        sh.flush_all_groups()
        sync(dev)
        emit("retention", "ingest_flush_s", time.perf_counter() - t0, "s")
        emit("retention", "span_days", days, "days")
        emit("retention", "series", n_series, "count")
        emit("retention", "raw_samples", n_series * n_samples, "samples")
        t0 = time.perf_counter()
        for res in (H1, H6):
            run_batch_downsample(repl, "bench", 0, res)
        emit("retention", "downsample_build_s", time.perf_counter() - t0, "s")
        fams = {}
        for res in (H1, H6):
            fms = TimeSeriesMemStore(device=dev)
            load_downsampled(repl, "bench", 0, res, "dAvg", fms)
            fams[res] = QueryEngine(fms, ds_family("bench", res), device=dev)
        eng = QueryEngine(ms, "bench", device=dev)
        eng.retention = RetentionRouter(
            RetentionPolicy([H1, H6], raw_window_ms=7 * DAY),
            lambda r: fams.get(r), dataset="bench")
        lead = int(ts_arr[-1])
        # the same year-long question at each resolution (step = 6h so the
        # three answers are comparable; the override pins the tier)
        q = "sum(avg_over_time(m[6h]))"
        for lbl in ("raw", "1h", "6h"):
            def q_res(_lbl=lbl):
                eng.query_range(q, BASE + H6, lead, H6, resolution=_lbl)
            dt, it = timed(q_res, max_iters=10)
            emit("retention", f"latency_{lbl}_ms", dt / it * 1000, "ms")
            emit("retention", f"qps_{lbl}", it / dt, "queries/s")
        # auto-routing over the full span stitches ds body + raw tail
        auto = eng.query_range(q, BASE + H6, lead, H6)
        emit("retention", "auto_resolution_is_stitched",
             float(auto.stats.resolution.endswith("+raw")), "bool")
        # cold month-long rate(): evict everything older than 7 days from
        # memory, then force raw over a month far past the horizon — every
        # query pages from the replicated durable tier
        with sh.lock:
            # the engine keeps no result or fragment cache (QueryConfig
            # defaults): no cached answer can go stale, so no epoch is owed
            sh.store.compact(lead - 7 * DAY)  # filolint: ignore[epoch-undeclared-visibility]
        cold_lo = lead - min(40, days - 10) * DAY
        cold_hi = cold_lo + 30 * DAY

        odp_rows = registry.counter(FILODB_RETENTION_ODP_ROWS,
                                    {"dataset": "bench", "tier": "remote"})
        odp_before = odp_rows.value

        def q_cold(_=None):
            return eng.query_range("sum(rate(m[1h]))", cold_lo, cold_hi,
                                   H6, resolution="raw")
        first = q_cold()
        emit("retention", "cold_paged_series",
             first.stats.rows_paged_in, "series")
        emit("retention", "cold_paged_samples_per_query",
             odp_rows.value - odp_before, "samples")
        dt, it = timed(q_cold, max_iters=8)
        emit("retention", "cold_month_rate_ms", dt / it * 1000, "ms")
        emit("retention", "cold_month_rate_qps", it / dt, "queries/s")
        # kill one replica holding the shard: reads fail over, writes land
        # on the survivor (consistency ONE), failovers are counted
        holders = [i for i, st in enumerate(stores)
                   if st.chunk_log_size("bench", 0) > 0]
        fo = registry.counter(FILODB_RETENTION_REPLICA_FAILOVER,
                              {"op": "read_chunksets"})
        fo_before = fo.value
        servers[holders[0]].stop()
        stores[holders[0]].close()
        after_kill = q_cold()
        emit("retention", "reads_after_kill_ok",
             float(np.array_equal(_values(after_kill), _values(first),
                                  equal_nan=True)), "bool")
        b2 = RecordBuilder(GAUGE)
        ts2 = lead + RAW_IV + np.arange(4, dtype=np.int64) * RAW_IV
        for s in range(n_series):
            b2.add_batch({"_metric_": "m", "host": f"h{s}"}, ts2,
                         np.full(4, 1.0))
        sh.ingest(b2.build(), offset=1)
        sh.flush_all_groups()
        emit("retention", "writes_after_kill_ok", 1.0, "bool")
        emit("retention", "replica_failovers", fo.value - fo_before, "count")
        emit("retention", "resolutions",
             float(len([resolution_label(r) for r in (H1, H6)]) + 1), "count")
    finally:
        for s in servers:
            with contextlib.suppress(Exception):   # one was killed mid-run
                s.stop()
        shutil.rmtree(tmp, ignore_errors=True)


def bench_ingest(full: bool, device=None, *, n_lines=None) -> None:
    """Ingest-plane pipeline: end-to-end gateway lines/s (per-connection
    builders + route memo + per-shard publish locks) vs the serial per-line
    baseline (one global lock, per-line key hashing — the pre-batching
    gateway hot path), broker publish rows/s with the windowed
    PUBLISH_BATCH publisher vs one frame per round trip, and consume-side
    replay rows/s. Bit-parity: per-shard row multisets of the two gateway
    paths must match, and the batched-published partition must replay
    byte-identical to the serial one. Host work only."""
    import shutil
    import tempfile
    import threading
    from collections import Counter

    from ..core.record import RecordBuilder, fnv1a64
    from ..core.schemas import GAUGE, Schemas, part_key_of, shard_key_of
    from ..ingest.broker import BrokerBus, BrokerServer
    from ..ingest.gateway import GatewayServer, parse_influx_line
    from ..parallel.shardmapper import ShardMapper

    resolve_device(device)            # the device policy; host work only
    n_lines = _pick(n_lines, full, 20_000, 100_000)
    n_conns = 8 if full else 4
    n_series = 500
    lines = [f"cpu,host=h{i % n_series},dc=us-east usage={i % 97}.5 "
             f"{(BASE + i) * 1_000_000}" for i in range(n_lines)]

    # -- gateway: serial per-line baseline (parse, rebuild labels, hash
    # shard+part key PER LINE, one global lock)
    mapper = ShardMapper(4, 0)
    glock = threading.Lock()
    builders: dict[int, RecordBuilder] = {}
    serial_out: list[tuple[int, object]] = []

    def serial_line(line: str) -> None:
        measurement, tags, fields, ts_ns = parse_influx_line(line)
        ts_ms = ts_ns // 1_000_000 if ts_ns else 0
        with glock:
            for fname, fval in fields.items():
                metric = measurement if fname == "value" \
                    else f"{measurement}_{fname}"
                labels = dict(tags)
                labels["_metric_"] = metric
                labels.setdefault("_ws_", "default")
                labels.setdefault("_ns_", "default")
                opts = GAUGE.options
                shard = mapper.shard_of(
                    fnv1a64(shard_key_of(labels, opts)) & 0xFFFFFFFF,
                    fnv1a64(part_key_of(labels, opts)))
                b = builders.get(shard)
                if b is None:
                    b = builders[shard] = RecordBuilder(GAUGE)
                b.add(labels, ts_ms, fval)

    t0 = time.perf_counter()
    for ln in lines:
        serial_line(ln)
    for shard, b in builders.items():
        serial_out.append((shard, b.build()))
    serial_s = time.perf_counter() - t0
    emit("ingest", "gateway_lines_serial", n_lines / serial_s, "lines/s")

    # -- gateway: batched/pipelined path, end to end over N TCP connections
    got: list[tuple[int, object]] = []
    gw = GatewayServer(lambda s, c: got.append((s, c)), num_shards=4,
                       flush_lines=2048, flush_interval_ms=200, port=0).start()
    slices = [lines[k::n_conns] for k in range(n_conns)]

    try:
        t0 = time.perf_counter()
        senders = Workers()
        for sl in slices:
            senders.start(_send_lines, gw.port, sl)
        senders.join(timeout=300)
        deadline = time.time() + 120
        while sum(len(c) for _, c in got) < n_lines and time.time() < deadline:
            time.sleep(0.002)
        gw_s = time.perf_counter() - t0
    finally:
        gw.stop()
    assert sum(len(c) for _, c in got) == n_lines, "gateway lost lines"
    emit("ingest", "gateway_lines_batched", n_lines / gw_s, "lines/s")
    emit("ingest", "gateway_speedup", serial_s / gw_s, "x")
    emit("ingest", "gateway_connections", n_conns, "count")

    def multiset(pairs):
        out: dict[int, Counter] = {}
        for shard, c in pairs:
            keys, _ = c.resolved_keys()
            ms = out.setdefault(shard, Counter())
            for i in range(len(c)):
                ms[(keys[int(c.part_idx[i])], int(c.ts[i]),
                    float(c.values[i]))] += 1
        return out

    assert multiset(got) == multiset(serial_out), \
        "batched gateway diverged from the serial path"

    # -- broker publish: one frame per round trip vs windowed PUBLISH_BATCH
    rows_per, n_conts, window = (100, 400, 32) if full else (50, 200, 32)
    conts = []
    for i in range(n_conts):
        b = RecordBuilder(GAUGE)
        b.add_batch({"_metric_": "pub", "host": f"h{i}"},
                    BASE + np.arange(rows_per, dtype=np.int64) * IV,
                    np.arange(rows_per, dtype=np.float64))
        conts.append(b.build())
    total_rows = rows_per * n_conts
    tmp = tempfile.mkdtemp(prefix="filodb_ingest_bench_")
    try:
        broker = BrokerServer(tmp, 2).start()
        bus = BrokerBus(f"127.0.0.1:{broker.port}", 0, publish_window=window)
        t0 = time.perf_counter()
        for c in conts:
            bus.publish(c)                     # serial: 1 round trip / frame
        serial_pub_s = time.perf_counter() - t0
        emit("ingest", "broker_publish_rows_serial",
             total_rows / serial_pub_s, "rows/s")
        bus2 = BrokerBus(f"127.0.0.1:{broker.port}", 1, publish_window=window)
        before = bus2.requests
        t0 = time.perf_counter()
        bus2.publish_batch(conts)              # ceil(n/W) pipelined trips
        batch_pub_s = time.perf_counter() - t0
        emit("ingest", "broker_publish_rows_batched",
             total_rows / batch_pub_s, "rows/s")
        emit("ingest", "broker_publish_speedup",
             serial_pub_s / batch_pub_s, "x")
        emit("ingest", "broker_publish_round_trips",
             bus2.requests - before, "count")
        emit("ingest", "broker_publish_window", window, "count")
        # replay: consume-side decode throughput (FETCH already batches)
        t0 = time.perf_counter()
        replayed = list(bus2.consume(Schemas()))
        replay_s = time.perf_counter() - t0
        emit("ingest", "replay_rows_per_s",
             sum(len(c) for _, c in replayed) / replay_s, "rows/s")
        # bit parity: the batched partition's log replays identical to the
        # per-round-trip partition's
        serial_frames = [c.to_bytes() for _, c in bus.consume(Schemas())]
        batch_frames = [c.to_bytes() for _, c in replayed]
        assert serial_frames == batch_frames, \
            "batched publish log diverged from serial publish log"
        bus.close(), bus2.close()
        broker.stop()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("ingest", "bit_parity", 1.0, "bool")


def bench_ingest_soak(full: bool, device=None, *, n_lines=None) -> None:
    """Replicated multi-partition ingest soak: 2 gateways x 3 partitions x
    replication 2 over two broker nodes. The leader of partition 1 is
    KILLED mid-stream (deterministic kill-at-offset fault); gateways fail
    over to the survivor and replay their unacked windows. Audit: pub-id
    reconciliation of every gateway's acked-id ledger against the
    survivor's journals — zero lost, zero duplicated — plus end-to-end
    row-count parity. Overload phase: queue cap 1 + response-delay faults
    shed RETRY at the wire while client backoff lands every publish. Host
    work only."""
    import shutil
    import tempfile

    from ..core.record import RecordBuilder
    from ..core.schemas import GAUGE, Schemas
    from ..ingest.broker import BrokerBus, BrokerServer
    from ..ingest.faults import FaultPlan, FaultRule
    from ..ingest.gateway import GatewayServer
    from ..utils.metrics import (FILODB_INGEST_FAILOVERS,
                                 FILODB_INGEST_PUBLISH_SHED,
                                 FILODB_INGEST_RETRIES, registry)

    resolve_device(device)            # the device policy; host work only
    n_lines = _pick(n_lines, full, 6_000, 30_000)     # per gateway
    n_parts, n_shards, kill_at = 3, 4, 10

    pa, pb = _free_port(), _free_port()
    peers = [f"127.0.0.1:{pa}", f"127.0.0.1:{pb}"]
    tmp = tempfile.mkdtemp(prefix="filodb_soak_")
    retries0 = registry.counter(FILODB_INGEST_RETRIES).value
    failovers0 = registry.counter(FILODB_INGEST_FAILOVERS).value
    try:
        # leader(p) = peers[p % 2]: partition 1 leads on node B — the kill
        # target; A survives and leads/follows everything afterwards
        a = BrokerServer(f"{tmp}/a", n_parts, port=pa, peers=peers,
                         node_index=0, replication=2).start()
        plan = FaultPlan([FaultRule("append", "kill_server", partition=1,
                                    at_offset=kill_at)])
        b = BrokerServer(f"{tmp}/b", n_parts, port=pb, peers=peers,
                         node_index=1, replication=2, fault_plan=plan).start()

        gateways = []
        for g in range(2):
            buses = {s: BrokerBus(peers, s % n_parts, publish_window=16,
                                  retry_backoff_ms=5, max_retries=12,
                                  seed=100 + g, track_acks=True)
                     for s in range(n_shards)}
            gw = GatewayServer(
                lambda s, c, _bs=buses: _bs[s].publish_async(c),
                num_shards=n_shards, flush_lines=64, flush_interval_ms=100,
                port=0).start()
            gw.bus_drain = (lambda _bs=buses:
                            [bus.flush_publishes() for bus in _bs.values()])
            gateways.append((gw, buses))

        def send(gw_idx):
            gw, _ = gateways[gw_idx]
            _send_lines(gw.port, [
                f"cpu,host=g{gw_idx}h{i % 400},dc=east usage={i % 97}.5 "
                f"{(BASE + i) * 1_000_000}" for i in range(n_lines)])

        t0 = time.perf_counter()
        senders = Workers()
        for g in (0, 1):
            senders.start(send, g)
        senders.join(timeout=300)
        for gw, _ in gateways:
            gw.stop()           # flush builders + drain publish windows
        soak_s = time.perf_counter() - t0
        assert plan.fired, "leader kill never fired"

        # -- pub-id reconciliation against the SURVIVOR (node A) ----------
        acked: dict[int, set] = {p: set() for p in range(n_parts)}
        for _gw, buses in gateways:
            for s, bus in buses.items():
                acked[s % n_parts].update(bus.acked_ids)
        lost = dup = frames = rows = 0
        for p in range(n_parts):
            items = a._journals[p].items()
            offsets = [o for o, _pid in items]
            pids = [pid for _o, pid in items]
            assert offsets == list(range(len(offsets))), "journal not dense"
            dup += len(pids) - len(set(pids))
            lost += len(acked[p] - set(pids))
            # every logged frame was acked to SOME gateway (drain completed)
            dup += len(set(pids) - acked[p])
            frames += len(pids)
            rows += sum(len(c) for _off, c in
                        BrokerBus([peers[0]], p).consume(Schemas()))
        emit("ingest_soak", "soak_lines_per_s", 2 * n_lines / soak_s,
             "lines/s")
        emit("ingest_soak", "frames_on_survivor", frames, "count")
        emit("ingest_soak", "rows_on_survivor", rows, "rows")
        emit("ingest_soak", "rows_expected", 2 * n_lines, "rows")
        emit("ingest_soak", "pubid_lost", lost, "count")
        emit("ingest_soak", "pubid_duplicated", dup, "count")
        emit("ingest_soak", "row_parity",
             float(rows == 2 * n_lines), "bool")
        emit("ingest_soak", "kill_offset", kill_at, "offset")
        emit("ingest_soak", "client_retries",
             registry.counter(FILODB_INGEST_RETRIES).value - retries0,
             "count")
        emit("ingest_soak", "client_failovers",
             registry.counter(FILODB_INGEST_FAILOVERS).value - failovers0,
             "count")
        assert lost == 0 and dup == 0 and rows == 2 * n_lines
        for _gw, buses in gateways:
            for bus in buses.values():
                bus.close()
        a.stop()
        with contextlib.suppress(Exception):
            b.stop()

        # -- overload: queue cap 1 + delayed responses -> RETRY shed, then
        # client backoff lands every publish
        shed0 = registry.counter(FILODB_INGEST_PUBLISH_SHED).value
        oplan = FaultPlan([FaultRule("serve", "delay", nth=1, count=40,
                                     delay_s=0.02)])
        o = BrokerServer(f"{tmp}/o", 1, max_queue=1, fault_plan=oplan).start()
        n_pub, n_threads = (400, 8) if full else (120, 6)

        def hammer(k):
            bus = BrokerBus([f"127.0.0.1:{o.port}"], 0, retry_backoff_ms=10,
                            max_retries=16, seed=k)
            for i in range(n_pub // n_threads):
                bld = RecordBuilder(GAUGE)
                bld.add({"_metric_": "ov", "t": f"{k}-{i}"}, BASE, 1.0)
                bus.publish(bld.build())
            bus.close()

        t0 = time.perf_counter()
        hammers = Workers()
        for k in range(n_threads):
            hammers.start(hammer, k)
        hammers.join(timeout=300)
        odt = time.perf_counter() - t0
        n_expected = (n_pub // n_threads) * n_threads
        end = o._parts[0].end_offset
        sheds = registry.counter(FILODB_INGEST_PUBLISH_SHED).value - shed0
        emit("ingest_soak", "overload_publishes", n_expected, "count")
        emit("ingest_soak", "overload_landed", end, "count")
        emit("ingest_soak", "overload_sheds", sheds, "count")
        emit("ingest_soak", "overload_publish_rate", n_expected / odt,
             "frames/s")
        emit("ingest_soak", "overload_queue_cap", 1, "count")
        emit("ingest_soak", "overload_zero_loss",
             float(end == n_expected), "bool")
        assert end == n_expected and sheds > 0
        o.stop()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def bench_gateway(full: bool, device=None, *, n=None) -> None:
    """Ref GatewayBenchmark: Influx line-protocol parse + shard-hash rate.
    Host work only."""
    from ..ingest.gateway import parse_influx_line

    resolve_device(device)            # the device policy; host work only
    n = _pick(n, full, 10_000, 50_000)
    lines = [
        f"cpu,host=h{i % 100},dc=us-east usage_user={i % 90}.5,usage_sys=1.25 "
        f"{(BASE + i) * 1_000_000}" for i in range(n)
    ]

    def parse_all():
        for ln in lines:
            parse_influx_line(ln)

    dt, it = timed(parse_all, max_iters=10)
    emit("gateway", "influx_parse", n * it / dt, "lines/s")


def bench_rules(full: bool, device=None, *, n_series=None,
                n_ticks=None) -> None:
    """Streaming recording rules & alerting. Four phases: (a) isolated rule
    throughput — grid ticks of a 4-group / 16-rule set evaluated through
    the full engine, derived series published back into the store; (b) the
    same rule load sustained WHILE a dashboard pool hammers query_range
    (both rates + dashboard p50 under load reported); (c) derived-series
    bit-parity vs one-shot oracle evaluation at every tick; (d)
    exactly-once soak — derived ticks published through a REAL two-broker
    replica set with a FaultPlan leader kill mid-stream, then
    crash-replayed; the survivor's pub-id journal must show zero lost and
    zero duplicated frames."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from ..core.memstore import StoreConfig, TimeSeriesMemStore
    from ..core.record import RecordBuilder
    from ..core.schemas import GAUGE
    from ..ingest.broker import BrokerBus, BrokerServer
    from ..ingest.faults import FaultPlan, FaultRule
    from ..parallel.shardmapper import ShardMapper
    from ..query.engine import QueryEngine
    from ..rules import (DerivedSeriesPublisher, RULE_LABEL, RulesManager,
                         derive_pub_id, load_groups)

    dev = resolve_device(device)
    n_series = _pick(n_series, full, 512, 2048)
    n_samples = 120
    ms = TimeSeriesMemStore(device=dev)
    ms.setup("rb", GAUGE, 0, StoreConfig(
        max_series_per_shard=n_series + 256, samples_per_series=1024,
        flush_batch_size=10**9, dtype="float64"))
    ts_arr = BASE + np.arange(n_samples, dtype=np.int64) * IV
    b = RecordBuilder(GAUGE)
    for s, vals in enumerate(rules_values(n_series, n_samples)):
        b.add_batch({"_metric_": "m", "host": f"h{s}", "dc": f"dc{s % 4}",
                     "job": f"J{s % 8}"}, ts_arr, vals)
    ms.ingest("rb", 0, b.build())
    ms.flush_all()
    eng = QueryEngine(ms, "rb", device=dev)

    def pub(shard, container, pub_id):
        ms.ingest("rb", shard, container)

    publisher = DerivedSeriesPublisher(GAUGE, ShardMapper(1), pub,
                                       dataset="rb")
    fns = ["sum", "avg", "max", "min"]
    spec = [{"name": f"g{gi}", "interval": "30s", "rules":
             [{"record": f"g{gi}:m:{fn}",
               "expr": f"{fn} by (dc) (rate(m[1m]))"} for fn in fns]}
            for gi in range(4)]
    groups = load_groups(spec)
    mgr = RulesManager(groups, eng, publisher=publisher, sink=None,
                       dataset="rb")
    n_rules = sum(len(g.rules) for g in groups)
    tick0 = BASE + 600_000

    # -- (a) isolated throughput -------------------------------------------
    def run_tick(k: int) -> None:
        # 1s tick spacing keeps every eval inside the fixture's 20-minute
        # data range (pub-id determinism is spacing-agnostic)
        for g in groups:
            mgr.scheduler.run_group_once(g, tick0 + k * 1_000,
                                         advance_watermark=False)

    run_tick(0)                          # warmup
    t0 = time.perf_counter()
    ticks = 0
    while time.perf_counter() - t0 < 0.4 and ticks < 150:
        ticks += 1
        run_tick(ticks)
    dt = time.perf_counter() - t0
    emit("rules", "rules_per_sec_isolated", ticks * n_rules / dt, "rules/s")

    # -- (b) rules sustained under dashboard traffic -----------------------
    start, end, step = BASE + 600_000, BASE + (n_samples - 1) * IV, 30_000
    dash_q = "sum by (job) (rate(m[1m]))"
    eng.query_range(dash_q, start, end, step)          # warm the shape
    stop = threading.Event()
    lat: list[float] = []

    def dashboard():
        while not stop.is_set():
            q0 = time.perf_counter()
            eng.query_range(dash_q, start, end, step)
            lat.append((time.perf_counter() - q0) * 1000)

    pool = ThreadPoolExecutor(max_workers=4)
    futs = [pool.submit(dashboard) for _ in range(4)]
    try:
        t0 = time.perf_counter()
        cticks = 0
        while time.perf_counter() - t0 < 0.6 and cticks < 150:
            cticks += 1
            run_tick(200 + cticks)
        cdt = time.perf_counter() - t0
    finally:
        stop.set()
        pool.shutdown(wait=True)
    for f in futs:
        f.result()                       # a failed dashboard query raises
    emit("rules", "rules_per_sec_concurrent", cticks * n_rules / cdt,
         "rules/s")
    emit("rules", "dashboard_qps_during_rules", len(lat) / cdt, "q/s")
    if lat:
        emit("rules", "dashboard_p50_ms_during_rules",
             float(np.percentile(lat, 50)), "ms")

    # -- (c) derived bit-parity vs one-shot oracle -------------------------
    # the oracle runs IMMEDIATELY BEFORE each tick, against the exact store
    # state the rule itself evaluates
    ms.flush_all()
    mismatches = checked = 0
    for k in range(3):
        ets = tick0 + (360 + k) * 1_000      # fresh ticks, in-range
        for rule in groups[0].rules:
            oracle = eng.query_instant(rule.expr, ets)
            want = {dict(kk.labels).get("dc"): float(v[-1])
                    for kk, _t, v in oracle.matrix.iter_series()}
            mgr.evaluator.evaluate_rule(rule, ets)
            ms.flush_all()
            got_res = eng.query_instant(
                f'{rule.name}{{{RULE_LABEL}="{rule.uid}"}}', ets)
            got_n = 0
            for kk, _t, v in got_res.matrix.iter_series():
                got_n += 1
                checked += 1
                if want.get(dict(kk.labels).get("dc")) != float(v[-1]):
                    mismatches += 1
            if got_n != len(want):
                mismatches += abs(got_n - len(want))
    emit("rules", "derived_parity_cells_checked", checked, "cells")
    emit("rules", "derived_parity_mismatches", mismatches, "cells")

    # -- (d) exactly-once under a broker leader kill -----------------------
    n_ticks = _pick(n_ticks, full, 24, 64)
    with tempfile.TemporaryDirectory() as tmp:
        pa, pb = _free_port(), _free_port()
        peers = [f"127.0.0.1:{pa}", f"127.0.0.1:{pb}"]
        plan = FaultPlan([FaultRule("append", "kill_server", partition=0,
                                    at_offset=n_ticks // 2)])
        a = BrokerServer(f"{tmp}/a", 1, port=pa, peers=peers, node_index=0,
                         replication=2, fault_plan=plan).start()
        srv_b = BrokerServer(f"{tmp}/b", 1, port=pb, peers=peers,
                             node_index=1, replication=2).start()
        bus = BrokerBus(peers, 0, retry_backoff_ms=0, seed=11)
        bus._sleep = lambda _s: None
        cont_b = RecordBuilder(GAUGE)
        cont_b.add({"_metric_": "r", RULE_LABEL: "g/r", "dc": "dc0"},
                   BASE, 1.0)
        frame = cont_b.build()
        expected = set()
        try:
            t0 = time.perf_counter()
            for k in range(n_ticks):
                pid = derive_pub_id("g/r", tick0 + k * 30_000, 0)
                expected.add(pid)
                bus.publish_with_id(frame, pid)
            # crash recovery: re-drive EVERY tick under the same ids
            for k in range(n_ticks):
                bus.publish_with_id(
                    frame, derive_pub_id("g/r", tick0 + k * 30_000, 0))
            soak_s = time.perf_counter() - t0
            logged = [pid for _off, pid in srv_b._journals[0].items()]
        finally:
            bus.close()
            with contextlib.suppress(Exception):
                a.stop()
            srv_b.stop()
    emit("rules", "soak_frames_published", 2 * n_ticks, "frames")
    emit("rules", "soak_leader_kills", len(plan.fired), "kills")
    emit("rules", "soak_lost", len(expected - set(logged)), "frames")
    emit("rules", "soak_duplicated", len(logged) - len(set(logged)),
         "frames")
    emit("rules", "soak_wall_s", soak_s, "s")


def bench_elastic(full: bool, device=None, *, n_rows=None,
                  n_frames=None) -> None:
    """Elastic cluster: (a) kill-a-node soak — ingest and queries continue
    with a bounded gap while the survivor warms the dead node's shard from
    the durable ring at bit parity with the pre-kill oracle; (b) live shard
    rebalance under publish load at bit parity with the arithmetic oracle;
    (c) split-brain zero-duplicate audit — an epoch-fenced leader killed
    mid-window, the failed-over client claims a new epoch, and the
    acked-id ledger reconciles against the survivor's journal with zero
    lost / zero duplicated. The nodes' shards live on ``device``."""
    import tempfile
    import urllib.error
    import urllib.request

    from ..config import Config
    from ..core.diststore import StoreServer
    from ..core.record import RecordBuilder
    from ..core.schemas import GAUGE
    from ..ingest.broker import BrokerBus, BrokerServer
    from ..ingest.faults import FaultPlan, FaultRule
    from ..standalone import FiloServer

    dev = resolve_device(device)
    # ---- (a)+(b): two standalone nodes over a shared ring + broker -----
    tmp = tempfile.mkdtemp(prefix="filodb-elastic-")
    store = StoreServer(tmp + "/ring").start()
    broker = BrokerServer(tmp + "/broker", 2).start()
    reg = tmp + "/members"

    def node(name):
        return FiloServer(Config({
            "num_shards": 2, "bus_addr": f"127.0.0.1:{broker.port}",
            "http": {"port": 0},
            "store_nodes": [f"127.0.0.1:{store.port}"],
            "store_replication": 1,
            "cluster": {"registrar": reg, "self_addr": name,
                        # stale_after must clear scheduling hiccups under
                        # load: a survivor that misses its OWN beat past it
                        # self-quarantines (the double-ownership guard)
                        "heartbeat_interval": "200ms", "stale_after": "5s",
                        "min_members": 2, "join_timeout": "20s",
                        "shard_fencing": True},
            "store": {"max_series_per_shard": 64, "samples_per_series": 512,
                      "flush_batch_size": 10**9},
        }), device=dev)

    servers: dict = {}
    starters = Workers()
    for n in ("elastic-a:1", "elastic-b:1"):
        starters.start(lambda n=n: servers.update({n: node(n).start()}))
    try:
        starters.join(timeout=40)
    except BaseException:
        for srv in servers.values():
            srv.shutdown()
        broker.stop()
        store.stop()
        raise
    n_rows = _pick(n_rows, full, 800, 4000)
    stop_pub = threading.Event()
    published = {"n": 0}
    query_errors = {"n": 0, "ok": 0}
    try:
        a, b = servers["elastic-a:1"], servers["elastic-b:1"]
        b_shard = a.manager.shards_of_node("prometheus", "elastic-b:1")[0]
        prod = BrokerBus(f"127.0.0.1:{broker.port}", b_shard,
                         publish_window=8)

        def load():
            i = 0
            while not stop_pub.is_set() and i < n_rows:
                bld = RecordBuilder(GAUGE)
                bld.add({"_metric_": "m", "host": f"h{i % 4}"},
                        BASE + i * 1000, float(i))
                prod.publish(bld.build())
                published["n"] += 1
                i += 1
                time.sleep(0.002)

        loader = Workers()
        loader_t = loader.start(load)
        deadline = time.time() + 60
        while published["n"] < 50 and loader_t.is_alive() \
                and time.time() < deadline:
            time.sleep(0.05)
        if published["n"] < 50:
            raise RuntimeError("elastic: publish load never ramped")
        # pre-kill oracle on the owner (node b)
        eng_b = b.engines["prometheus"]
        deadline = time.time() + 20
        oracle_n = 0
        while time.time() < deadline:
            r = eng_b.query_instant("count(m)", BASE + n_rows * 1000)
            if r.matrix.num_series:
                oracle_n = float(_values(r)[0, -1])
                if oracle_n == 4.0:
                    break
            time.sleep(0.1)
        # KILL node b; survivor must take over its shard and keep serving
        t_kill = time.perf_counter()
        b.shutdown()
        eng_a = a.engines["prometheus"]

        def probe_queries():
            while not stop_pub.is_set():
                try:
                    eng_a.query_instant("count(m)", BASE + n_rows * 1000)
                    query_errors["ok"] += 1
                except Exception:  # noqa: BLE001 — continuity accounting
                    query_errors["n"] += 1
                time.sleep(0.05)

        prober = Workers()
        prober.start(probe_queries)
        deadline = time.time() + 30
        while time.time() < deadline:
            if a.manager.node_of("prometheus", b_shard) == "elastic-a:1" \
                    and b_shard in a._running:
                break
            time.sleep(0.1)
        takeover_s = time.perf_counter() - t_kill
        loader.join(timeout=60)
        stop_pub.set()
        prober.join(timeout=10)
        prod.close()
        total = published["n"]
        # continuity + parity: every published row served by the survivor
        want = float(sum(range(total)))
        got = -1.0
        deadline = time.time() + 30
        while time.time() < deadline:
            r = eng_a.query_instant("sum(sum_over_time(m[2h]))",
                                    BASE + n_rows * 1000)
            if r.matrix.num_series:
                got = float(_values(r)[0, -1])
                if got == want:
                    break
            time.sleep(0.2)
        emit("elastic", "kill_node_takeover_s", takeover_s, "s")
        emit("elastic", "kill_node_rows_published", total, "rows")
        emit("elastic", "kill_node_rows_lost",
             0 if got == want else abs(want - got), "rows")
        emit("elastic", "kill_node_query_errors_during_takeover",
             query_errors["n"], "queries")
        emit("elastic", "kill_node_queries_served", query_errors["ok"],
             "queries")
        emit("elastic", "kill_node_warm_parity", float(got == want), "bool")

        # ---- (b) live rebalance back to a fresh node under load --------
        c = node("elastic-c:1")         # joins the established cluster
        servers["elastic-c:1"] = c
        c.start()
        stop_pub.clear()
        published2 = {"n": 0}
        prod2 = BrokerBus(f"127.0.0.1:{broker.port}", b_shard,
                          publish_window=8)

        def load2():
            i = 0
            while not stop_pub.is_set() and i < (n_rows // 2):
                bld = RecordBuilder(GAUGE)
                bld.add({"_metric_": "reb", "host": f"h{i % 4}"},
                        BASE + i * 1000, float(i))
                prod2.publish(bld.build())
                published2["n"] += 1
                i += 1
                time.sleep(0.002)

        loader2 = Workers()
        loader2_t = loader2.start(load2)
        deadline = time.time() + 60
        while published2["n"] < 25 and loader2_t.is_alive() \
                and time.time() < deadline:
            time.sleep(0.05)
        if published2["n"] < 25:
            raise RuntimeError("elastic: rebalance load never ramped")
        t_move = time.perf_counter()
        # the new node's HTTP endpoint reaches the owner with its first
        # registrar heartbeats: until then the owner answers 422 "no HTTP
        # endpoint known" and the move is asked again (any other refusal
        # fails the suite with the owner's reason)
        deadline = time.time() + 20
        while True:
            req = urllib.request.Request(
                f"http://127.0.0.1:{a.http.port}/api/v1/cluster/rebalance"
                f"?dataset=prometheus&shard={b_shard}&to=elastic-c:1",
                method="POST", data=b"")
            try:
                with urllib.request.urlopen(req, timeout=90.0) as r:
                    r.read()
                break
            except urllib.error.HTTPError as e:
                body = e.read().decode(errors="replace")
                if "no HTTP endpoint known" not in body \
                        or time.time() > deadline:
                    raise RuntimeError(
                        f"elastic: rebalance refused ({e.code}): {body}") \
                        from e
                time.sleep(0.1)
        move_s = time.perf_counter() - t_move
        loader2.join(timeout=60)
        stop_pub.set()
        prod2.close()
        total2 = published2["n"]
        want2 = float(sum(range(total2)))
        got2 = -1.0
        eng_c = c.engines["prometheus"]
        deadline = time.time() + 30
        while time.time() < deadline:
            r = eng_c.query_instant("sum(sum_over_time(reb[2h]))",
                                    BASE + n_rows * 1000)
            if r.matrix.num_series:
                got2 = float(_values(r)[0, -1])
                if got2 == want2:
                    break
            time.sleep(0.2)
        emit("elastic", "rebalance_cutover_s", move_s, "s")
        emit("elastic", "rebalance_rows_under_load", total2, "rows")
        emit("elastic", "rebalance_parity", float(got2 == want2), "bool")
    finally:
        stop_pub.set()
        for srv in servers.values():
            with contextlib.suppress(Exception):
                srv.shutdown()
        broker.stop()
        store.stop()

    # ---- (c) split-brain zero-duplicate audit (epoch-fenced brokers) ---
    n_frames = _pick(n_frames, full, 3000, 12000)
    kill_at = n_frames // 3
    tmp2 = tempfile.mkdtemp(prefix="filodb-splitbrain-")
    pa, pb = _free_port(), _free_port()
    peers = [f"127.0.0.1:{pa}", f"127.0.0.1:{pb}"]
    plan = FaultPlan([FaultRule("append", "kill_server", partition=0,
                                at_offset=kill_at)])
    ba = BrokerServer(tmp2 + "/a", 1, port=pa, peers=peers, node_index=0,
                      replication=2, fault_plan=plan,
                      epoch_fencing=True).start()
    bb = BrokerServer(tmp2 + "/b", 1, port=pb, peers=peers, node_index=1,
                      replication=2, epoch_fencing=True).start()
    bus = BrokerBus(peers, 0, publish_window=32, retry_backoff_ms=1,
                    seed=12, track_acks=True, epoch_fencing=True)
    try:
        t0 = time.perf_counter()
        bld = RecordBuilder(GAUGE)
        bld.add({"_metric_": "sb", "host": "h"}, BASE, 1.0)
        frame = bld.build()
        for _ in range(n_frames):
            bus.publish_async(frame)
        bus.flush_publishes()
        soak_s = time.perf_counter() - t0
        logged = [pid for _off, pid in bb._journals[0].items() if pid]
        acked = set(bus.acked_ids)
        end = bb._parts[0].end_offset
        epoch, _owner = bb.epochs.get(0)
    finally:
        bus.close()
        with contextlib.suppress(Exception):
            ba.stop()
        bb.stop()
    emit("elastic", "splitbrain_frames", n_frames, "frames")
    emit("elastic", "splitbrain_leader_kills", len(plan.fired), "kills")
    emit("elastic", "splitbrain_survivor_epoch", epoch, "epoch")
    emit("elastic", "splitbrain_lost", len(acked - set(logged)), "frames")
    emit("elastic", "splitbrain_duplicated",
         len(logged) - len(set(logged)), "frames")
    emit("elastic", "splitbrain_log_dense", float(end == len(set(logged))),
         "bool")
    emit("elastic", "splitbrain_rate", n_frames / soak_s, "frames/s")


def bench_dashboard_soak(full: bool, device=None, *, n_series=None,
                         refreshes=None) -> None:
    """Incremental serving at a realistic 15 s refresh mix. A 4h/2m-step
    dashboard re-asks its sliding window every 15 s while the scrape
    stream lands one new sample per series between ANY two refreshes — so
    some shard epoch moves every refresh and the all-or-nothing result
    cache never hits (emitted as baseline_result_cache_hits). With the
    fragment cache, 7 of 8 refreshes are pure per-step cache hits (the
    appended samples are provably newer than every cached step — the epoch
    log proves it) and only the step-completing refresh computes ONE new
    step. Measured: effective qps of the delta path vs the serving stack
    re-executing the full range, at bit parity of the rendered series on
    every refresh. The port serves in its default fused mode (the hand
    kernel), where the reference forces its xla variant (SUBSTITUTED)."""
    from ..core.memstore import StoreConfig, TimeSeriesMemStore
    from ..core.record import RecordBuilder
    from ..core.schemas import PROM_COUNTER
    from ..query.engine import QueryConfig, QueryEngine

    dev = resolve_device(device)
    n_series = _pick(n_series, full, 4096, 4096)
    iv = 15_000                              # scrape interval == refresh
    step = 120_000                           # Grafana-style 4h/120-point
    steps_per_panel = 120
    # 24 refreshes = 3 step completions
    refreshes = _pick(refreshes, full, 24, 24)
    per_step = step // iv
    rng = np.random.default_rng(14)
    cfg = StoreConfig(max_series_per_shard=n_series, samples_per_series=1024,
                      flush_batch_size=10**9, dtype="float32")
    ms = TimeSeriesMemStore(device=dev)
    ms.setup("soak", PROM_COUNTER, 0, cfg)
    state = np.zeros(n_series)
    t_cells = steps_per_panel * per_step + 24

    def ingest_cells(c0, n_cells):
        nonlocal state
        for s in range(n_series):
            b = RecordBuilder(PROM_COUNTER)
            inc = np.cumsum(rng.exponential(5.0, n_cells))
            for i in range(n_cells):
                b.add({"_metric_": "request_total", "job": f"J{s % 4}",
                       "instance": f"i{s}"},
                      BASE + (c0 + i) * iv, float(state[s] + inc[i]))
            state[s] += inc[-1]
            ms.ingest("soak", 0, b.build())
        ms.flush_all()

    ingest_cells(0, t_cells)
    panels = ['sum(rate(request_total[2m]))',
              'sum by (job) (rate(request_total[2m]))']
    delta = QueryEngine(ms, "soak", device=dev,
                        config=QueryConfig(fragment_cache_size=64))
    # the baseline is the serving stack: full re-execution behind the
    # watermark-equality result cache (which this mix voids every refresh)
    base = QueryEngine(ms, "soak", device=dev,
                       config=QueryConfig(result_cache_size=64))

    def window_of(lead_cell: int):
        end = (BASE + lead_cell * iv) // step * step
        return end - (steps_per_panel - 1) * step, end

    # prime: run the full shapes, seed the fragments, run the extension
    # shapes — the measured mix is the warmed steady state
    cursor = t_cells
    s0, e0 = window_of(cursor - 1)
    for q in panels:
        base.query_range(q, s0, e0, step)
        delta.query_range(q, s0, e0, step)
    ingest_cells(cursor, per_step)
    cursor += per_step
    s0, e0 = window_of(cursor - 1)
    for q in panels:
        delta.query_range(q, s0, e0, step)

    # the refresh mix: ONE scrape lands before every refresh, a new step
    # completes every 8th refresh. Both engines serve EVERY refresh
    # back-to-back against the same store state, and every refresh must
    # render bit-identically across the engines.
    t_delta = t_base = 0.0
    delta_out, base_out = [], []
    for _ in range(refreshes):
        ingest_cells(cursor, 1)
        cursor += 1
        start, end = window_of(cursor - 1)
        for q in panels:
            for eng, out in ((delta, delta_out), (base, base_out)):
                t0 = time.perf_counter()
                r = eng.query_range(q, start, end, step)
                dt = time.perf_counter() - t0
                if eng is delta:
                    t_delta += dt
                else:
                    t_base += dt
                m = r.matrix.to_host()
                # f64 cast before compare: the delta path serves stitched
                # f64 columns, the full path native f32 — the cast is exact
                out.append(sorted(
                    (k_.labels, ts.tobytes(), np.asarray(v, np.float64))
                    for k_, ts, v in m.iter_series()))

    def same(a, b, exact):
        return len(a) == len(b) and all(
            ka == kb and ta == tb and (np.array_equal(va, vb) if exact
                                       else _within_bar(va, vb))
            for (ka, ta, va), (kb, tb, vb) in zip(a, b))
    parity = float(all(same(d, b, True) for d, b in zip(delta_out, base_out)))
    # the fused kernel on the card groups its fold by launch shape, which
    # follows the steps a query runs: an extension's steps may differ from
    # the full range's in the last bits, never beyond the bar
    assert all(same(d, b, False) for d, b in zip(delta_out, base_out)), \
        "the incremental answer diverged from the full re-execution"
    n_q = refreshes * len(panels)
    st = delta.fragment_cache.stats()
    emit("dashboard_soak", "panels", len(panels), "count")
    emit("dashboard_soak", "refreshes", refreshes, "count")
    emit("dashboard_soak", "steps_per_panel", steps_per_panel, "steps")
    emit("dashboard_soak", "series", n_series, "count")
    emit("dashboard_soak", "effective_qps_delta", n_q / t_delta, "queries/s")
    emit("dashboard_soak", "effective_qps_full", n_q / t_base, "queries/s")
    emit("dashboard_soak", "delta_speedup", t_base / t_delta, "x")
    emit("dashboard_soak", "bit_parity", parity, "bool")
    emit("dashboard_soak", "baseline_result_cache_hits",
         base.result_cache.stats()["hits"], "count")
    emit("dashboard_soak", "fragment_extensions", st["extensions"], "count")
    emit("dashboard_soak", "fragment_hits", st["hits"], "count")
    emit("dashboard_soak", "fragment_bytes", st["bytes"], "bytes")


def bench_observability(full: bool, device=None, *, n_series=None) -> None:
    """Tracing + per-query-stats overhead on the query hot path. Exactly
    the query_hicard workload (same fixture, same query), measured with
    tracing OFF (one flag check per root span; QueryStats accounting is
    always on), SAMPLED at 0.01, and FULL — so ``query_p50_off`` is
    directly comparable to ``query_hicard.sum_rate_p50`` (the <2%
    tracing-off acceptance bar)."""
    from ..core.memstore import StoreConfig, TimeSeriesMemStore
    from ..core.schemas import PROM_COUNTER
    from ..query.engine import QueryEngine
    from ..utils.tracing import SPAN_QUERY, tracer

    dev = resolve_device(device)
    n_series = _pick(n_series, full, 2000, 8000)
    n_samples = 90                       # 15 minutes @ 10s
    cfg = StoreConfig(max_series_per_shard=n_series, samples_per_series=128,
                      flush_batch_size=10**9, dtype="float32")
    ms = TimeSeriesMemStore(device=dev)
    ms.setup("bench", PROM_COUNTER, 0, cfg)
    for c in hicard_containers(n_series, seed=11, n_samples=n_samples):
        ms.ingest("bench", 0, c)
    ms.flush_all()
    eng = QueryEngine(ms, "bench", device=dev)
    start, end = BASE + 300_000, BASE + (n_samples - 1) * IV

    def q():
        eng.query_range('sum(rate(request_total{job="J0"}[1m]))',
                        start, end, 60_000)

    modes = (("off", False, 1.0), ("sampled_1pct", True, 0.01),
             ("full", True, 1.0))
    was = (tracer.enabled, tracer.sample_rate)
    runs: dict[str, list[float]] = {m: [] for m, _, _ in modes}
    spans_full = iters_full = 0
    try:
        for _ in range(5):
            q()                          # warm: caches settled
        # INTERLEAVE modes across rounds and take each mode's best run:
        # machine noise between rounds would otherwise swamp a few-percent
        # overhead (the thing this suite exists to measure)
        for _ in range(3):
            for mode, enabled, rate in modes:
                tracer.enabled, tracer.sample_rate = enabled, rate
                tracer.drain()
                dt, it = timed(q, max_iters=30)
                runs[mode].append(dt / it * 1000)
                if mode == "full":
                    # +1: timed() runs one warmup call before the clock
                    spans_full, iters_full = len(tracer.drain()), it + 1
    finally:
        tracer.enabled, tracer.sample_rate = was
    p50 = {m: min(v) for m, v in runs.items()}
    for mode in p50:
        emit("observability", f"query_p50_{mode}", p50[mode], "ms")
    spans_per_query = spans_full / max(iters_full, 1)
    emit("observability", "spans_per_query_full", spans_per_query, "spans")
    emit("observability", "overhead_sampled_vs_off",
         p50["sampled_1pct"] / p50["off"] - 1, "x")
    emit("observability", "overhead_full_vs_off",
         p50["full"] / p50["off"] - 1, "x")

    # tight-loop span cost: the wall-clock A/B above carries run-to-run
    # noise, so also publish the per-span cost and the overhead it implies
    # at this query shape
    def span_cost_us(n: int = 20000) -> float:
        with tracer.span(SPAN_QUERY):      # warm the per-thread rng
            pass
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with tracer.span(SPAN_QUERY):
                pass
        return (time.perf_counter_ns() - t0) / n / 1000.0
    try:
        tracer.enabled = False
        off_us = span_cost_us()
        emit("observability", "span_cost_us_off", off_us, "us")
        tracer.enabled, tracer.sample_rate = True, 1.0
        full_us = span_cost_us()
        emit("observability", "span_cost_us_full", full_us, "us")
    finally:
        tracer.enabled, tracer.sample_rate = was
        tracer.drain()
    emit("observability", "est_overhead_off_pct",
         spans_per_query * off_us / (p50["off"] * 1000) * 100, "%")
    emit("observability", "est_overhead_full_pct",
         spans_per_query * full_us / (p50["off"] * 1000) * 100, "%")


SUITES = {
    "mesh_query": bench_mesh_query,
    "dashboard_soak": bench_dashboard_soak,
    "elastic": bench_elastic,
    "rules": bench_rules,
    "fused_resident": bench_fused_resident,
    "ingestion": bench_ingestion,
    "serving": bench_serving,
    "observability": bench_observability,
    "ingest": bench_ingest,
    "ingest_soak": bench_ingest_soak,
    "odp": bench_odp,
    "retention": bench_retention,
    "count_values": bench_count_values,
    "narrow_resident": bench_narrow_resident,
    "scalar_residency": bench_scalar_residency,
    "hist_retention": bench_hist_retention,
    "encoding": bench_encoding,
    "partkey_index": bench_partkey_index,
    "hist_ingest": bench_hist_ingest,
    "hist_query": bench_hist_query,
    "query_hicard": bench_query_hicard,
    "query_ingest": bench_query_ingest,
    "gateway": bench_gateway,
}


def session(dev: torch.device) -> None:
    """The card line, then the per-run floors, one shared definition with
    the port's bench.py: ``session_rt_floor_ms`` (a trivial op and its host
    copy, the round trip every blocking query pays at least once) and
    ``device_dispatch_floor_ms`` (the op and a synchronise, no host copy:
    the enqueue cost a pipelined dispatch pays)."""
    from .. import bench
    print(bench.card_line() if dev.type == "cuda" else str(dev), flush=True)
    emit("session", "rt_floor_ms", bench.session_floor_ms(dev), "ms")
    emit("session", "device_dispatch_floor_ms",
         bench.device_dispatch_floor_ms(dev), "ms")
    emit("session", "backend", float(dev.type == "cuda"), "is_cuda")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--suite", choices=sorted(SUITES), action="append",
                    help="run only these suites (default: all)")
    ap.add_argument("--full", action="store_true",
                    help="reference-scale sizes (1M index keys, 8000 series, ...)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the stores live and the kernels run "
                         "(default cuda; raises without a card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        from ..ops import kernels
        kernels.build()          # nvcc before the suites, not inside a timing
    session(dev)
    for name in (args.suite or sorted(SUITES)):
        t0 = time.perf_counter()
        SUITES[name](args.full, dev)
        print(f"bench_suite: {name} {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
        gc.collect()     # release the suite's device stores before the next
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
