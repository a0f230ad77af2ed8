"""quantile_p95_ms: the p95 of every request of the traced window
(``_tail``): the tail of the SLO dashboard cell, whose closed loop keeps
the card saturated, so that its tail is the queue's."""

from tsdb_bench.metrics._tail import read  # noqa: F401
