"""sum_rate_p95_ms: the p95 of every request of the traced window
(``_tail``): the host-paced tail of the dashboard cell, whose card idles
while the host selects 2^20 rows."""

from tsdb_bench.metrics._tail import read  # noqa: F401
