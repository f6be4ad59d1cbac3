"""Device (one H100): 100 x (1 - the union of device activity over the
traced sub-window's wall), from the profiler's trace."""

from flowbench import records


def read(rec):
    return records.idle_pct(rec)
