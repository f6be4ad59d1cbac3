"""Lockstep batch (solvers/lockstep.py, parallel/sweep.py): the batch
calls' walls, summed, over the batches' lockstep iterations (each batch's
largest pair iteration count), summed (ms)."""

from flowbench import records


def read(rec):
    counts = records.counter(rec, "iters")
    total = sum(max(c) for c in counts if c)
    if records.single(rec) or total == 0:
        return None
    return 1e3 * sum(c["end"] - c["start"] for c in rec["calls"]) / total
