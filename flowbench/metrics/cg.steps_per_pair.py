"""GN + CG: the mean of the CG steps the program reports per pair
(cg.iterations), a guard."""

from flowbench import records


def read(rec):
    return records.mean_per_pair(rec, "steps")
