"""Raw-vs-downsample consistency validator over a live server's HTTP API.

The port's counterpart of ``scripts/downsample_validator.py`` (after the
reference's GaugeDownsampleValidator.scala and doc/downsampling.md
"Validation"): query the raw dataset with min/max/avg/count_over_time at
downsample-bucket granularity and compare against the downsample
family's dMin/dMax/dAvg/dCount columns; any mismatch is a correctness
bug in the downsample pipeline.

Alignment: downsample records carry bucket-end timestamps
((b+1)*res - 1) and the engine's range windows include both endpoints, so
a [res-1 ms] window evaluated at those timestamps covers
[b*res, (b+1)*res - 1]: exactly the bucket's samples, and exactly one
downsample record on the family's side. The comparison is exact; the
tolerance covers only float accumulation-order differences. Each column
is read through its own window function over one bucket (e.g.
``min_over_time(m::dMin[59999ms])``), not an instant selector: staleness
lookback would carry a missing bucket's predecessor forward and mask
gaps.

It speaks HTTP only and computes nothing on a device, so it takes no
``--device``: it checks a deployment from any host, with a card or not.

Usage:
    python -m filodb_tpu_torch.scripts.downsample_validator \\
        --url http://127.0.0.1:8080 --dataset prometheus --resolution 1m \\
        --metric m --start 1700000000 --end 1700000600 [--rtol 1e-6]

Prints a JSON report; exit code 0 iff every comparison passed.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import urllib.parse
import urllib.request

from ..core.downsample import ds_family

# (downsample column, raw range function, family-side range function)
CHECKS = (
    ("dMin", "min_over_time", "min_over_time"),
    ("dMax", "max_over_time", "max_over_time"),
    ("dAvg", "avg_over_time", "avg_over_time"),
    ("dCount", "count_over_time", "sum_over_time"),
)


def _res_ms(resolution: str) -> int:
    m = re.fullmatch(r"(\d+)(ms|[smh])?", resolution)
    if not m:
        raise ValueError(f"bad resolution {resolution!r}")
    mult = {"ms": 1, None: 60_000, "s": 1000, "m": 60_000, "h": 3_600_000}
    return int(m.group(1)) * mult[m.group(2)]


def _query_range(url: str, dataset: str, promql: str, start_ms: int,
                 end_ms: int, step_ms: int, timeout_s: float = 30.0) -> dict:
    params = urllib.parse.urlencode({
        "query": promql, "start": start_ms / 1000.0, "end": end_ms / 1000.0,
        "step": f"{step_ms}ms"})
    full = f"{url}/promql/{dataset}/api/v1/query_range?{params}"
    with urllib.request.urlopen(full, timeout=timeout_s) as r:
        payload = json.load(r)
    if payload.get("status") != "success":
        raise RuntimeError(f"query failed: {payload}")
    out = {}
    for series in payload["data"]["result"]:
        metric = dict(series["metric"])
        metric.pop("__name__", None)
        key = tuple(sorted(metric.items()))
        out[key] = {int(float(t) * 1000): float(v)
                    for t, v in series["values"]}
    return out


def compare_results(raw: dict, ds: dict, rtol: float) -> dict:
    """Compare two {series_key: {ts: value}} maps: mismatches over shared
    timestamps, raw series entirely missing from ds, and interior gaps —
    raw buckets between a ds series' first and last emitted bucket with no
    ds point are lost downsample data. Raw points after the ds series'
    last bucket are expected lag (an open bucket, the serving refresh)
    and are not failures."""
    c = {"series_raw": len(raw), "series_ds": len(ds), "compared": 0,
         "mismatches": 0, "max_rel_err": 0.0, "missing_ds_series": 0,
         "missing_ds_points": 0}
    for key, raw_pts in raw.items():
        ds_pts = ds.get(key)
        if ds_pts is None:
            c["missing_ds_series"] += 1
            continue
        lo, hi = min(ds_pts), max(ds_pts)
        for t in sorted(raw_pts):
            b = ds_pts.get(t)
            if b is None:
                if lo < t < hi:
                    c["missing_ds_points"] += 1   # interior gap: lost bucket
                continue
            a = raw_pts[t]
            denom = max(abs(a), abs(b), 1e-12)
            rel = abs(a - b) / denom
            c["max_rel_err"] = max(c["max_rel_err"], rel)
            c["compared"] += 1
            if rel > rtol:
                c["mismatches"] += 1
    return c


def validate(url: str, dataset: str, resolution: str, metric: str,
             start_ms: int, end_ms: int, rtol: float = 1e-6,
             selector: str = "") -> dict:
    """Compare raw against downsampled aggregates; returns a report dict
    with per-check pass/fail counts and the worst relative error seen."""
    res = _res_ms(resolution)
    ds_dataset = ds_family(dataset, res)
    # evaluate at bucket-end timestamps ((b+1)*res - 1): exact bucket cover
    first = (start_ms // res + 1) * res - 1
    url = url.rstrip("/")
    report = {"dataset": dataset, "ds_dataset": ds_dataset,
              "resolution_ms": res, "checks": {}, "checked": 0, "failed": 0}
    w = res - 1      # inclusive-endpoint window == one bucket exactly
    for col, raw_fn, ds_fn in CHECKS:
        raw = _query_range(url, dataset,
                           f"{raw_fn}({metric}{selector}[{w}ms])",
                           first, end_ms, res)
        ds = _query_range(url, ds_dataset,
                          f"{ds_fn}({metric}::{col}{selector}[{w}ms])",
                          first, end_ms, res)
        c = compare_results(raw, ds, rtol)
        report["checks"][col] = c
        report["checked"] += c["compared"]
        report["failed"] += (c["mismatches"] + c["missing_ds_series"]
                             + c["missing_ds_points"])
    report["ok"] = report["failed"] == 0 and report["checked"] > 0
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--url", required=True)
    ap.add_argument("--dataset", default="prometheus")
    ap.add_argument("--resolution", default="1m")
    ap.add_argument("--metric", required=True)
    ap.add_argument("--selector", default="",
                    help='optional PromQL matcher block, e.g. {dc="east"}')
    ap.add_argument("--start", type=float, required=True,
                    help="range start, unix seconds")
    ap.add_argument("--end", type=float, required=True)
    ap.add_argument("--rtol", type=float, default=1e-6)
    a = ap.parse_args(argv)
    report = validate(a.url, a.dataset, a.resolution, a.metric,
                      int(a.start * 1000), int(a.end * 1000), a.rtol,
                      a.selector)
    print(json.dumps(report, indent=2))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
