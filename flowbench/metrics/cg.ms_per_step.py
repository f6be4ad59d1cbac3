"""GN + CG (solvers/gn.py, solvers/cg.py): the calls' walls, summed, over
the CG steps the program reports (cg.iterations), summed (ms)."""

from flowbench import records


def read(rec):
    return records.span_ms_per(rec, "steps")
