"""Sinkhorn loop: the mean over the window's pairs of the iterations each
pair's call ran (the change of the program's counter
``sinkhorn.iterations``: every rung, solve and stabilizer), a guard: a
change of speed should leave it alone."""

from flowbench import records


def read(rec):
    return records.mean_per_pair(rec, "iters")
