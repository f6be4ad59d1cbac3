"""Sinkhorn loop: the share of the window's pairs that the ``auto``
stabilizer solved again with the exact softmin (%; the change of the
program's counter ``sinkhorn.escalations`` over each call)."""

from flowbench import records


def read(rec):
    share = records.mean_per_pair(rec, "escalated")
    return None if share is None else 100.0 * share
