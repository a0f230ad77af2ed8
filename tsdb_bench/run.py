"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m tsdb_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for. The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: every number compared beside its
limit); the same numbers end standard error. Exits 2, printing no result,
without the cards or the program, 3 when a module of JAX or of the JAX
package is loaded once the window has closed, and 1 on any other fault
(a request still open two minutes after the window, an error at set-up).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache at a fixed path inside the checkout: only a
# checkout's first run builds (the port's own kernels build into
# filodb_tpu_torch/_build/, also inside it)
CACHE = ROOT / ".bench_cache"
CACHE_ENV = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
             "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda"}


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else out.stderr.strip()


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m tsdb_bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in CACHE_ENV.items():
        os.environ[var] = str(CACHE / sub)
    import torch
    stages = {"import_torch_s": time.perf_counter() - T_START}
    from . import harness
    bench = harness.load_bench()
    cell = harness.by_name(bench["workloads"], args.workload, "workload")
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    try:
        import filodb_tpu_torch.query.engine  # noqa: F401
    except ImportError as e:
        print(f"the program under test is missing: {e}", file=sys.stderr)
        return 2
    stages["import_program_s"] = time.perf_counter() - t0
    out = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", T_START, stages=stages)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in this process, which a run may not load: {bad}",
              file=sys.stderr)
        return 3
    card = card_line()
    out = {**{k: v for k, v in out.items() if k != "checks"}, "card": card,
           "checks": out["checks"]}
    print(f"card: {card}", file=sys.stderr)
    print(f"correct {out['correct']}: attempted {out['attempted']}, failed "
          f"{out['failed']}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
