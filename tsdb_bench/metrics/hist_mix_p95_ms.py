"""hist_mix_p95_ms: the p95 of every request of the traced window
(``_tail``): the tail of the histogram mix, which swings run to run by
more than an end-to-end bound can hold."""

from tsdb_bench.metrics._tail import read  # noqa: F401
