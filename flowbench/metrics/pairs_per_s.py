"""Pairs whose fields reached the host in the window, over the window's
seconds (a batch of B counts B), host clock (records.pairs_per_s)."""

from flowbench import records


def read(rec):
    return records.pairs_per_s(rec)
