"""``device.idle_pct`` (records.idle_pct) of the GN cells: a name of its
own because a per-layer metric moves one end-to-end metric that each of
its cells reports, and the GN cells report ``gn.pairs_per_s``."""

from flowbench import records


def read(rec):
    return records.idle_pct(rec)
