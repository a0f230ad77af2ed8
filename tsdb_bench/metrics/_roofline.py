"""The share of a hand-written kernel's roofline over a traced window: the
least time the kernel's launches could take (the bytes each needs, from
``tsdb_bench/roofline``, over the card's published HBM peak) divided by
the profiler's device time of those launches, in %."""

from __future__ import annotations

import importlib
import sys

from tsdb_bench.reference.plain import steps_of
from tsdb_bench.roofline import peaks
from tsdb_bench.stats import kernel_family


def share(run, kernel: str, counter: str):
    tr = run.device
    if tr is None or not tr.kernels:
        return None
    ns = sum(e - s for (_n, s, e), fam in zip(tr.kernels, tr.families)
             if fam == kernel)
    launches = sum(1 for n, _s, _e in tr.kernels
                   if kernel_family(n) == kernel)
    count = importlib.import_module(f"tsdb_bench.roofline.{kernel}")
    queries = {q["name"]: q for q in run.traffic["queries"]}
    total, expect = 0, 0
    for r in run.requests:
        for launch in queries[r.query].get("kernels", {}).get(kernel, ()):
            total += count.query_bytes(run.cfg, steps_of(run.ranges[r.range_idx]),
                                       launch)
            expect += 1
    # the mix says which launches each query makes; the program's own
    # launch count and the trace's must both agree with it
    if not ns or expect == 0 or launches != expect \
            or run.counters.get(counter) != expect:
        print(f"{kernel}_roofline: {launches} launches traced, "
              f"{run.counters.get(counter)} counted, {expect} expected: "
              "not read", file=sys.stderr)
        return None
    import torch
    least_s = total / peaks.bytes_per_s(torch.cuda.get_device_name())
    return 100.0 * least_s / (ns / 1e9)
