"""The readings a cell's limits are set from (PERF.md gives them beside
each limit):

- the program's: the numbers its runs print, one short window at the
  cell's own load and size a seed, each seed's run in this one process;
- the control's: the plain reference computed in the nearest precision
  below the configuration's (bfloat16 for its float32 samples), put in the
  program's place at the cell's size, and judged like the program.

    python3 -m tsdb_bench.readings --workload <cell> --seeds 1,2,3 \
        --seconds 8 --control-seeds 4,5,6 [--out FILE]

Prints one JSON line a seed as it goes and the worst reading of each
number over the seeds last.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import harness
from .reference import plain

CONTROL_DTYPE = torch.bfloat16


def control_readings(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """{"<query>.<number>": value} of the control over every (query, range)
    pair of the mix."""
    truth = plain.evaluate(cfg, traffic, seed, device, torch.float64)
    low = plain.evaluate(cfg, traffic, seed, device, CONTROL_DTYPE)
    out: dict = {}
    for (name, _ri), fam in truth.items():
        for n, v in fam.judge(low[(name, _ri)].answer()).items():
            k = f"{name}.{n}"
            out[k] = max(out.get(k, 0.0), v)
    return out


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m tsdb_bench.readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    return p.parse_args(argv)


def seeds_of(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s.strip()]


def main(argv=None) -> int:
    args = parse(argv)
    bench = harness.load_bench()
    cell = harness.by_name(bench["workloads"], args.workload, "workload")
    cfg = harness.load_config(bench, cell["config"])
    traffic = harness.load_traffic(cell["traffic"])
    dev = torch.device(args.device)
    lines, worst = [], {"program": {}, "control": {}}

    def emit(kind, seed, nums, extra=None):
        line = {"kind": kind, "seed": seed, "numbers": nums, **(extra or {})}
        lines.append(line)
        print(json.dumps(line), flush=True)
        for k, v in nums.items():
            if v is not None:
                worst[kind][k] = max(worst[kind].get(k, 0.0), v)

    for seed in seeds_of(args.seeds):
        t0 = time.perf_counter()
        out = harness.run_cell(bench, args.workload, seed, args.seconds,
                               False, dev)
        emit("program", seed, {k: c["value"] for k, c in
                               out["checks"].items()},
             {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"],
              "seconds": time.perf_counter() - t0})
    for seed in seeds_of(args.control_seeds):
        t0 = time.perf_counter()
        emit("control", seed, control_readings(cfg, traffic, seed, dev),
             {"seconds": time.perf_counter() - t0})
    summary = {"kind": "worst", "workload": args.workload, **worst}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for line in lines + [summary]:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
