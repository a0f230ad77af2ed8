"""k1_roofline: K1's share of its roofline (ops/fusedgrid.py,
ops/csrc/fusedgrid.cu: ``fused_grid_map<K>`` / ``fused_grid_map_ring<K>``
and the ``fold_chunks`` of block partials that follows each), in %."""

from tsdb_bench.metrics._roofline import share


def read(run):
    return share(run, "k1", "k1_launches")
