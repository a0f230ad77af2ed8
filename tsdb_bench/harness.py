"""One run of one cell: build the configuration from the seed, warm the
cell's query shapes, drive its traffic against
``QueryEngine.query_range`` for the window, then judge every answer of
the window against the plain reference and report the cell's metrics.

Everything a cell needs is found by name: ``BENCHMARK.json`` names the
configuration's file, the traffic mix (``traffic/<mix>.json``) and the
per-layer metrics (``metrics/<metric>.py``); the configuration names its
data generator (``data/<data>.py``) and its install (``deploy/<builder>.py``).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import random
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from . import trace
from .reference import plain
from .stats import percentile

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
# loaded in the process that prints a result, each is a fault
FORBIDDEN = ("jax", "jaxlib", "flax", "filodb_tpu")
DRAIN_TIMEOUT_S = 120.0


# ---- the specification ------------------------------------------------------

def load_bench() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_config(bench: dict, name: str) -> dict:
    entry = by_name(bench["configs"], name, "configuration")
    with open(ROOT / entry["file"]) as f:
        return json.load(f)


def load_traffic(name: str) -> dict:
    with open(PKG / "traffic" / f"{name}.json") as f:
        return json.load(f)


def quantity(name: str) -> str:
    """What a metric measures: its name up to the first dot. A quantity
    split by the cells' end-to-end metrics (``leaf_ms.hist`` beside
    ``leaf_ms``) is measured alike under each name."""
    return name.split(".", 1)[0]


def metric_reader(name: str):
    """``read(run) -> float | None`` of ``metrics/<name>.py``, or of the
    quantity's ``metrics/<quantity>.py`` where the name has no file."""
    path = PKG / "metrics" / f"{name}.py"
    if not path.exists():
        path = PKG / "metrics" / f"{quantity(name)}.py"
    spec = importlib.util.spec_from_file_location(
        f"tsdb_bench.metrics.{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics the cell reports: those
    that list it, or list no cells; a per-layer metric that lists none
    only where the cell reports the end-to-end metric it moves."""
    out = [m for m in bench[kind]
           if "workloads" not in m or cell in m["workloads"]]
    if kind == "per_layer":
        e2e = {m["name"] for m in cell_metrics(bench, cell, "end_to_end")}
        out = [m for m in out if "workloads" in m or m["moves"] in e2e]
    return out


# ---- traffic ----------------------------------------------------------------

def schedule(traffic: dict, seed: int) -> list[tuple[int, int]]:
    """Every (query, range) pair ``weight`` times, in an order drawn from
    the seed: every seed sends the same set of queries."""
    n_ranges = traffic["ranges"]["count"]
    pairs = [(qi, ri) for qi, q in enumerate(traffic["queries"])
             for _ in range(int(q["weight"])) for ri in range(n_ranges)]
    random.Random(seed).shuffle(pairs)
    return pairs


@dataclass
class Request:
    query: str
    range_idx: int
    t_send: float
    t_done: float
    ok: bool
    stage_ms: dict = field(default_factory=dict)
    answer: object = None             # the host ResultMatrix
    error: str | None = None

    @property
    def latency_ms(self) -> float:
        return (self.t_done - self.t_send) * 1000 if self.ok else math.inf


def run_query(engine, q: dict, rng: tuple[int, int, int]):
    """One request as a client sends it: the answer on the host."""
    r = engine.query_range(q["promql"], *rng)
    return r.matrix.to_host(), dict(r.stats.stage_ms) if r.stats else {}


def drive(engine, traffic: dict, ranges: list, seed: int, seconds: float,
          on_open=None, on_tick=None):
    """The closed loop: ``clients`` threads, each sending its next request
    when its last is answered. Before the window each client sends one
    request (its warm-up); the window then opens for all at once, and a
    client sends no request after it closes. Returns (requests sent in the
    window, window start, window end) on the host clock."""
    order = schedule(traffic, seed)
    L, C = len(order), int(traffic["clients"])
    queries = traffic["queries"]
    logs: list[list[Request]] = [[] for _ in range(C)]
    errors: list[str] = []
    warm = threading.Barrier(C + 1)
    start = threading.Event()
    bounds = {}

    def client(c: int) -> None:
        pos = c * L // C
        try:
            qi, ri = order[pos % L]
            run_query(engine, queries[qi], ranges[ri])
        except Exception as e:          # the warm-up is no request: record
            errors.append(f"client {c} warm-up: {e!r}")
        pos += 1
        warm.wait()
        start.wait()
        end = bounds["end"]
        while True:
            t_send = time.perf_counter()
            if t_send >= end:
                return
            qi, ri = order[pos % L]
            pos += 1
            q = queries[qi]
            try:
                ans, stage = run_query(engine, q, ranges[ri])
                logs[c].append(Request(q["name"], ri, t_send,
                                       time.perf_counter(), True, stage, ans))
            except Exception as e:      # a failed request is counted, not fatal
                logs[c].append(Request(q["name"], ri, t_send,
                                       time.perf_counter(), False,
                                       error=repr(e)))

    threads = [threading.Thread(target=client, args=(c,), daemon=True,
                                name=f"tsdb-bench-client-{c}")
               for c in range(C)]
    for t in threads:
        t.start()
    warm.wait()
    if errors:
        raise RuntimeError("; ".join(errors[:4]))
    if on_open is not None:
        on_open()
    t0 = time.perf_counter()
    bounds["end"] = t0 + seconds
    start.set()
    deadline = bounds["end"] + DRAIN_TIMEOUT_S
    for t in threads:
        while t.is_alive() and time.perf_counter() < deadline:
            t.join(0.05)
            if on_tick is not None:
                on_tick()
    if any(t.is_alive() for t in threads):
        raise TimeoutError(f"requests still open {DRAIN_TIMEOUT_S:.0f} s "
                           "after the window closed")
    reqs = sorted((r for log in logs for r in log), key=lambda r: r.t_send)
    return reqs, t0, bounds["end"]


def warm_up(engine, traffic: dict, ranges: list) -> None:
    """Every (query, range) pair of the mix once, in order: the cell's own
    shapes and nothing else (the clients' first requests follow in
    :func:`drive`)."""
    for q in traffic["queries"]:
        for rng in ranges:
            run_query(engine, q, rng)


# ---- counters of the program ------------------------------------------------

def counters(dep) -> dict:
    """The program's own counters that the per-layer metrics difference
    across the window."""
    from filodb_tpu_torch.ops import fusedgrid, fusedresident, segfold
    return {
        "shard_lock_contentions": sum(s.lock.contentions for s in dep.shards),
        "k1_launches": fusedgrid.fused_grid_kernel.launches,
        "k2_launches": fusedresident.fused_hist_kernel.launches,
        "segfold_launches": segfold.segment_fold_kernel.launches,
    }


# ---- judging ----------------------------------------------------------------

def to_answer(matrix, rows_of) -> plain.Answer:
    vals = np.asarray(matrix.values, np.float64)
    rows = None
    if matrix.keys and rows_of is not None:
        rows = [rows_of(k.as_dict()) for k in matrix.keys]
        if any(r is None for r in rows):
            rows = None
    return plain.Answer(np.asarray(matrix.out_ts), vals, rows)


def judge(cfg: dict, traffic: dict, seed: int, device, reqs) -> dict:
    """{"<query>.<number>": {"value", "limit"}} over every answer of the
    window: each number is the worst over the answers of its query."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pairs = sorted({(r.query, r.range_idx) for r in reqs if r.ok})
    fams = plain.evaluate(cfg, traffic, seed, device, torch.float64, pairs)
    label = cfg.get("label")
    row_map: dict = {}

    def rows_of(key: dict):
        if label not in key:
            return None
        if not row_map:
            row_map.update({v: i for i, v in enumerate(
                plain.data_module(cfg).labels(cfg))})
        return row_map.get(key[label])

    worst: dict = {}
    for r in reqs:
        if not r.ok:
            continue
        nums = fams[(r.query, r.range_idx)].judge(to_answer(r.answer, rows_of))
        for n, v in nums.items():
            k = f"{r.query}.{n}"
            worst[k] = max(worst.get(k, 0.0), v)
    checks = {}
    for q in traffic["queries"]:
        for n, limit in q["limits"].items():
            k = f"{q['name']}.{n}"
            checks[k] = {"value": worst.get(k), "limit": limit}
    return checks


def checks_pass(checks: dict) -> bool:
    return all(c["value"] is not None and c["limit"] is not None
               and c["value"] <= c["limit"] for c in checks.values())


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that a run may not load, compared
    whole (``filodb_tpu_torch`` is not ``filodb_tpu``)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def finite(v):
    return v if v is not None and math.isfinite(v) else None


# ---- one run ----------------------------------------------------------------

def run_cell(bench: dict, cell_name: str, seed: int, seconds: float,
             traced: bool, device="cuda", t_start: float | None = None,
             cfg_override: dict | None = None, log=None,
             stages: dict | None = None) -> dict:
    """One run; returns the result line's object (``checks`` last).
    ``t_start`` is when the process started, ``stages`` the seconds of the
    set-up stages before this call (imports)."""
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    t_start = time.perf_counter() if t_start is None else t_start
    stages = dict(stages or {})
    cell = by_name(bench["workloads"], cell_name, "workload")
    cfg = load_config(bench, cell["config"])
    cfg.update(cfg_override or {})
    traffic = load_traffic(cell["traffic"])
    ranges = plain.ranges_of(cfg, traffic)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    builder = importlib.import_module(f"tsdb_bench.deploy.{cfg['builder']}")
    t0 = time.perf_counter()
    if on_card:
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
    stages["cuda_init_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dep = builder.build(cfg, seed, dev)
    stages.update(dep.stages)
    stages["build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    warm_up(dep.engine, traffic, ranges)
    if on_card:
        torch.cuda.synchronize(dev)
    stages["warm_up_s"] = time.perf_counter() - t0

    tr = trace.Collector(dev) if traced else None
    before = {}

    def on_open():
        # the clients' first requests are answered: the window opens
        before.update(counters(dep))
        stages["clients_warm_s"] = time.perf_counter() - t_warm
        if tr is not None:
            tr.open()

    t_warm = time.perf_counter()
    reqs, w0, w1 = drive(dep.engine, traffic, ranges, seed, seconds,
                         on_open=on_open, on_tick=tr.tick if tr else None)
    # set-up ends where the window opens: imports, build, warm-up, the
    # clients' first requests (and with --trace 1 the profiler's start)
    setup_s = w0 - t_start
    if on_card:
        torch.cuda.synchronize(dev)
    device_trace = tr.finish() if tr else None
    after = counters(dep)
    memory_peak = torch.cuda.max_memory_allocated(dev) if on_card else None

    done_in_window = sum(1 for r in reqs if r.ok and r.t_done <= w1)
    failed = sum(1 for r in reqs if not r.ok)
    for r in reqs:
        if not r.ok:
            log(f"failed request {r.query} range {r.range_idx}: {r.error}")
            break
    lat = [r.latency_ms for r in reqs]
    e2e = {
        "queries_per_s": done_in_window / seconds,
        "query_p95_ms": percentile(lat, 95),
        "resident_bytes_per_sample": (
            dep.resident_bytes / dep.samples
            if dep.resident_bytes is not None else None),
        "setup_s": setup_s,
    }
    log(f"set-up stages (s): { {k: round(v, 3) for k, v in stages.items()} }")
    log(f"window {seconds} s: {len(reqs)} requests sent, {done_in_window} "
        f"answered inside it, {failed} failed; program resident sample "
        f"bytes {dep.program_resident_bytes} "
        f"({dep.program_resident_bytes / dep.samples:.4f} B/sample); "
        f"allocator {dep.resident_bytes}")

    metrics = {}
    if traced:
        run = trace.RunView(cell=cell_name, cfg=cfg, traffic=traffic,
                            ranges=ranges, requests=reqs, window=(w0, w1),
                            counters={k: after[k] - before[k] for k in after},
                            device=device_trace)
        for m in cell_metrics(bench, cell_name, "per_layer"):
            v = metric_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell_metrics(bench, cell_name, "end_to_end"):
            metrics[m["name"]] = {"value": finite(e2e[quantity(m["name"])]),
                                  "unit": m["unit"]}

    # the program's state goes before the reference runs on the same card
    del dep
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checks = judge(cfg, traffic, seed, dev, reqs)
    log(f"reference and comparison: {time.perf_counter() - t0:.3f} s")

    device_info = {"platform": "gpu" if on_card else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if on_card
                   else "cpu",
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": memory_peak}
    out = {"correct": bool(reqs) and failed == 0 and checks_pass(checks),
           "attempted": len(reqs), "failed": failed, "metrics": metrics,
           "device": device_info}
    if device_trace is not None:
        device_info["busy_s"] = device_trace.busy_s
        device_info["window_s"] = device_trace.window_s
        out["breakdown"] = device_trace.breakdown()
    out["checks"] = {k: {"value": finite(c["value"]), "limit": c["limit"]}
                     for k, c in checks.items()}
    return out
