"""The arithmetic the metric readers share: a percentile over all requests,
the busy time of a device as a union of intervals, and the names of the
port's hand-written kernels as the profiler prints them."""

from __future__ import annotations

import math
import re

# kernel families of filodb_tpu_torch/ops/csrc, matched in the profiler's
# (demangled) kernel names
HANDWRITTEN = {
    "k1": re.compile(r"\bfused_grid_map(_ring)?<"),
    "k2": re.compile(r"\bfused_hist_map\b"),
    "k2_fold": re.compile(r"\bfold_steps\b"),
    "fold": re.compile(r"\bfold_chunks\b"),
    "segfold": re.compile(r"\bsegfold<"),
    "k3": re.compile(r"\bstream_(map|fold)\b"),
}
# a ``fold_chunks`` launch folds the block partials of the map kernel that
# came before it
MAPS = ("k1", "k2")


def percentile(values, q: float) -> float:
    """Nearest-rank percentile (``q`` in 0..100) of every value; a failed
    request enters as inf, so it counts against the tail."""
    vals = sorted(values)
    if not vals:
        return math.nan
    k = max(math.ceil(q / 100.0 * len(vals)) - 1, 0)
    return vals[k]


def merged(intervals) -> list[tuple[int, int]]:
    """The union of ``(start, end)`` intervals as disjoint sorted ones."""
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_ns(intervals) -> int:
    """Nanoseconds covered by the union of ``(start, end)`` intervals."""
    return sum(e - s for s, e in merged(intervals))


def kernel_family(name: str) -> str | None:
    for fam, rx in HANDWRITTEN.items():
        if rx.search(name):
            return fam
    return None


def attribute(kernels) -> list[str | None]:
    """Each kernel's hand-written family, with every ``fold_chunks`` given
    to the map kernel (K1 or K2) that started last before it; None for the
    kernels the port does not write by hand."""
    out, last_map = [], None
    for name, _s, _e in kernels:
        fam = kernel_family(name)
        if fam in MAPS:
            last_map = fam
        elif fam == "fold":
            fam = last_map or "fold"
        elif fam == "k2_fold":
            fam = "k2"
        out.append(fam)
    return out
