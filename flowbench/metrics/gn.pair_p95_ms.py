"""``pair_p95_ms`` (records.pair_p95_ms) of the GN cells: a metric of its
own because a bound is one per metric and GN's runs spread more than the
FOTO cells' (the host does half of a GN pair's work)."""

from flowbench import records


def read(rec):
    return records.pair_p95_ms(rec)
