"""Sizes a CPU test run can hold: each configuration cut in its number of
series only (every width, sample count and range as configured)."""

SMALL = {
    "prom_counters_1m": {"series": 512, "registration_batch": 512,
                         "data_batch": 192},
    "prom_hist_131k": {"series": 64, "registration_batch": 64,
                       "data_batch": 24},
}
