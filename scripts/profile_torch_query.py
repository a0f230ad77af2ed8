#!/usr/bin/env python3
"""Where one ``sum(rate(m[5m]))`` query of the PyTorch/CUDA port spends its
time, at bench.py's shape (2^20 series x 720 samples) on one card.

    python3 scripts/profile_torch_query.py [--queries 5] [--out DIR]
                                           [--residency off|gauge]

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
``profile_torch_query_gauge.txt``. Needs a CUDA card.
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
    engine, shard, _ = bench.build_engine("cuda", residency=args.residency)
    if args.residency == "gauge":
        cs.install_narrow_scale(torch, shard, "delta8", "cuda")
        shard.flush()
        kind, _ops, ok = shard.store.narrow_operands()
        print(f"store: {kind}, {int((~ok).sum())} pool rows, resident sample "
              f"bytes {shard.store.resident_sample_bytes() / 1e9:.3f} GB",
              flush=True)
    start = cs.BASE_TS + cs.WINDOW_MS
    end = cs.BASE_TS + cs.NUM_SAMPLES * cs.INTERVAL_MS
    q = "sum(rate(m[5m]))"

    def run():
        engine.query_range(q, start, end, cs.STEP_MS)

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
    print(f"[{card}] query host ms p50 {np.percentile(host, 50):.3f}; "
          f"events around the query p50 {np.percentile(dev, 50):.3f} ms",
          flush=True)

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
    print(f"[{card}] device time per query {dev_ms:.3f} ms over "
          f"{args.queries} profiled queries, busy share of the host p50 "
          f"{dev_ms / np.percentile(host, 50):.3f}; K1 launches "
          f"{fg.fused_grid_kernel.launches_by_kind}", flush=True)

    # 3. cProfile: host functions by cumulative time
    pr = cProfile.Profile()
    pr.enable()
    for _ in range(args.queries):
        run()
    pr.disable()
    buf = io.StringIO()
    pstats.Stats(pr, stream=buf).sort_stats("cumulative").print_stats(30)
    print(buf.getvalue(), flush=True)

    os.makedirs(args.out, exist_ok=True)
    name = ("profile_torch_query.txt" if args.residency == "off"
            else f"profile_torch_query_{args.residency}.txt")
    with open(os.path.join(args.out, name), "w") as f:
        f.write(f"card: {card}\n{table}\n{buf.getvalue()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
