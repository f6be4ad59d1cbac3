"""The 95th percentile over every pair of the window of the time from its
call's start to its fields on the host (ms), host clock
(records.pair_p95_ms)."""

from flowbench import records


def read(rec):
    return records.pair_p95_ms(rec)
