"""Lockstep batch: the pairs' own iterations, summed, over B times each
batch's lockstep iterations, summed (%): the share of the batch's work
spent on pairs that had not stopped."""

from flowbench import records


def read(rec):
    counts = [c for c in records.counter(rec, "iters") if c]
    slots = sum(len(c) * max(c) for c in counts)
    if records.single(rec) or slots == 0:
        return None
    return 100.0 * sum(sum(c) for c in counts) / slots
