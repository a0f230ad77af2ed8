"""k2_roofline: K2's share of its roofline (ops/fusedresident.py,
ops/csrc/fusedhist.cu: ``fused_hist_map`` and its ``fold_steps``), in %."""

from tsdb_bench.metrics._roofline import share


def read(run):
    return share(run, "k2", "k2_launches")
