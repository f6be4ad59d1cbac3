"""ALG2 loop (solvers/foto.py): the calls' walls over the window, summed,
over the ALG2 iterations the program reports (state.iteration), summed
(ms); cells of one pair a call."""

from flowbench import records


def read(rec):
    return records.span_ms_per(rec, "iters")
