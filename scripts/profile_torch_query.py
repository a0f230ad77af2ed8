#!/usr/bin/env python3
"""Where one query of the PyTorch/CUDA port spends its time, at bench.py's
shape (2^20 series x 720 samples) on one card: ``sum(rate(m[5m]))`` unless
other queries are named.

    python3 scripts/profile_torch_query.py [--queries 5] [--out DIR]
                                           [--residency off|gauge]
                                           [--mesh]
                                           [--query PROMQL ...]
                                           [--instant PROMQL ...]

``--query`` (repeatable) profiles a range query over the full 2 h range at
bench.py's step, ``--instant`` (repeatable) an instant query at the store's
last sample, each in turn on the one engine.

Builds the same engine as chip_smoke.py's scale phase
(``filodb_tpu_torch.bench.build_engine``) — with ``--residency gauge`` its
narrow scale phase's delta8 store instead: counters compressed
by the shard's flush to i8 deltas, one row in 16 in the raw f32 cohort
pool — warms it, then:

  1. times each query on the host clock, and with CUDA events recorded
     around it on the current stream;
  2. runs the queries under ``torch.profiler`` (CPU + CUDA activities) and
     prints the device kernels by total time, the device time per query
     and its share of the host p50 of step 1;
  3. runs them under cProfile and prints the host functions by cumulative
     time.

Prints the card (name, power limit) first. Writes the profiler table and the
cProfile listing to ``--out`` (default ``chiprun_out/``), in
``profile_torch_query.txt`` or, with ``--residency gauge``,
``profile_torch_query_gauge.txt``. Needs a CUDA card. Named queries write
their timings, tables and listings, in turn, to
``profile_torch_query_general.txt``.

``--mesh`` builds chip_smoke.py phase 11b's store instead (the same shape
split over 8 shards of 2^17 series, raw f32) and profiles each query twice,
through ``QueryEngine(mesh=["cuda"])`` and through the host loop (the
engine without a mesh), into ``profile_torch_query_mesh.txt``.
"""

import argparse
import cProfile
import io
import os
import pstats
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--queries", type=int, default=5)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out"))
    ap.add_argument("--residency", choices=("off", "gauge"), default="off")
    ap.add_argument("--mesh", action="store_true")
    ap.add_argument("--query", action="append", default=[])
    ap.add_argument("--instant", action="append", default=[])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_query: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    import chip_smoke as cs
    from filodb_tpu_torch import bench
    from filodb_tpu_torch.ops import fusedgrid as fg

    card = bench.card_line()
    print(f"card: {card}", flush=True)
    if args.mesh:
        return profile_mesh(args, torch, np, cs, fg, card)
    engine, shard, _ = bench.build_engine("cuda", residency=args.residency)
    if args.residency == "gauge":
        cs.install_narrow_scale(torch, shard, "delta8", "cuda")
        shard.flush()
        kind, _ops, ok = shard.store.narrow_operands()
        print(f"store: {kind}, {int((~ok).sum())} pool rows, resident sample "
              f"bytes {shard.store.resident_sample_bytes() / 1e9:.3f} GB",
              flush=True)
    # per-series answers over the whole store (chip_smoke.py phase 10's
    # Q3: 159,687 series) are profiled too
    engine.config.sample_limit = max(engine.config.sample_limit,
                                     shard.num_series * 64)
    start = cs.BASE_TS + cs.WINDOW_MS
    end = cs.BASE_TS + cs.NUM_SAMPLES * cs.INTERVAL_MS
    t_last = int(shard.store.last_ts.max())
    named = ([(q, False) for q in args.query]
             + [(q, True) for q in args.instant])
    report = [f"card: {card}"]
    for q, instant in named or [("sum(rate(m[5m]))", False)]:
        report += profile_query(args, torch, np, cs, fg, card, engine, q,
                                instant, start, end, t_last)
    os.makedirs(args.out, exist_ok=True)
    name = ("profile_torch_query_general.txt" if named
            else "profile_torch_query.txt" if args.residency == "off"
            else f"profile_torch_query_{args.residency}.txt")
    with open(os.path.join(args.out, name), "w") as f:
        f.write("\n".join(report) + "\n")
    return 0


def profile_mesh(args, torch, np, cs, fg, card) -> int:
    """Each query through the mesh route and through the host loop on
    phase 11b's 8-shard store."""
    from filodb_tpu_torch.core.memstore import StoreConfig, TimeSeriesMemStore
    from filodb_tpu_torch.core.record import RecordBuilder
    from filodb_tpu_torch.core.schemas import GAUGE
    from filodb_tpu_torch.query.engine import QueryEngine
    ms, shards, _ = cs.build_mesh_scale(
        torch, np, (StoreConfig, TimeSeriesMemStore, RecordBuilder, GAUGE,
                    QueryEngine))
    start, end = cs.range_variants(shards[0])[0]
    report = [f"card: {card}"]
    for q in args.query or ["sum(rate(m[5m]))"]:
        for tag, engine in (("mesh", QueryEngine(ms, "meshq", mesh=["cuda"])),
                            ("host loop", QueryEngine(ms, "meshq"))):
            print(f"engine: {tag}", flush=True)
            report += [f"engine: {tag}"] + profile_query(
                args, torch, np, cs, fg, card, engine, q, False, start, end,
                None)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile_torch_query_mesh.txt"),
              "w") as f:
        f.write("\n".join(report) + "\n")
    return 0


def profile_query(args, torch, np, cs, fg, card, engine, q, instant, start,
                  end, t_last) -> list[str]:
    """Steps 1-3 for one query; returns the table and listing to keep."""
    def run():
        if instant:
            engine.query_instant(q, t_last)
        else:
            engine.query_range(q, start, end, cs.STEP_MS)

    what = f"{'instant ' if instant else ''}{q}"
    print(f"query: {what}", flush=True)
    for _ in range(3):
        run()
    torch.cuda.synchronize()

    # 1. host clock per query, and CUDA events around the same query
    host, dev = [], []
    for _ in range(args.queries):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        run()
        b.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        dev.append(a.elapsed_time(b))
    timed = (f"[{card}] query host ms p50 {np.percentile(host, 50):.3f}; "
             f"events around the query p50 {np.percentile(dev, 50):.3f} ms")
    print(timed, flush=True)

    # 2. torch.profiler: device time per query by kernel; the busy share is
    # that time over the unprofiled host p50 above (the profiled window's
    # wall clock includes the profiler's own start-up)
    from torch.profiler import ProfilerActivity, profile
    cs.reset_k1(fg)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.queries):
            run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    # device rows only: an aten op's row repeats its kernels' time
    dev_ms = sum(e.self_device_time_total for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.is_user_annotation) / 1e3 / args.queries
    table = events.table(sort_by="self_device_time_total", row_limit=15)
    print(table, flush=True)
    busy = (f"[{card}] device time per query {dev_ms:.3f} ms over "
            f"{args.queries} profiled queries, busy share of the host p50 "
            f"{dev_ms / np.percentile(host, 50):.3f}; K1 launches "
            f"{fg.fused_grid_kernel.launches_by_kind}")
    print(busy, flush=True)

    # 3. cProfile: host functions by cumulative time
    pr = cProfile.Profile()
    pr.enable()
    for _ in range(args.queries):
        run()
    pr.disable()
    buf = io.StringIO()
    pstats.Stats(pr, stream=buf).sort_stats("cumulative").print_stats(30)
    print(buf.getvalue(), flush=True)
    return [f"query: {what}", timed, busy, table, buf.getvalue()]


if __name__ == "__main__":
    sys.exit(main())
