"""WFR ALG2 loop: the mean of the iterations the program reports per pair
(state.iteration), a guard: a change of speed should leave it alone."""

from flowbench import records


def read(rec):
    return records.mean_per_pair(rec, "iters")
