"""What every soak shares: its command line, its report, K1's counts."""

from __future__ import annotations

import argparse
import inspect
import json
import sys

import numpy as np

from ..ops import fusedgrid


def k1_raw_launches() -> int:
    """K1 raw's launch count so far (the wrapper counts only launches of
    the kernel itself, so it stays 0 on the CPU)."""
    return fusedgrid.fused_grid_kernel.launches_by_kind["raw"]


def percentiles(lat_ms: list) -> dict:
    a = np.asarray(lat_ms, np.float64)
    if not len(a):
        return {"p50_ms": None, "p99_ms": None}
    return {"p50_ms": float(np.percentile(a, 50)),
            "p99_ms": float(np.percentile(a, 99))}


def finish(report: dict, checks: dict) -> dict:
    """The report with its checks and ``ok``: every check held."""
    report["checks"] = {k: bool(v) for k, v in checks.items()}
    report["ok"] = all(report["checks"].values())
    return report


def json_safe(x):
    """``x`` with every non-finite float as None (a strict JSON line)."""
    if isinstance(x, dict):
        return {k: json_safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [json_safe(v) for v in x]
    if isinstance(x, float) and not np.isfinite(x):
        return None
    return x


def cli(main, doc: str, argv=None) -> int:
    """Run ``main`` from a command line: the positional integers of the
    reference soak (``main``'s parameters with integer defaults, in order)
    and ``--device``. Prints the report as one JSON line; the exit code
    is 0 only when every check held."""
    ap = argparse.ArgumentParser(description=doc.strip().split("\n")[0])
    for name, p in inspect.signature(main).parameters.items():
        if name != "device":
            ap.add_argument(name, type=int, nargs="?", default=p.default)
    ap.add_argument("--device", default="cuda",
                    help="where the stores live: cuda (default) or cpu")
    report = main(**vars(ap.parse_args(argv)))
    print(json.dumps(json_safe(report)), flush=True)
    return 0 if report["ok"] else 1


def run(main, doc: str) -> None:
    sys.exit(cli(main, doc))
