"""Kernel #1 (ops/kernels/fused_pointwise.py, csrc/fused_pointwise.cu) on
one pair: its least time at the cell's shape (bytes-bound, relaxed k = 2,
flowbench/roofline.py) over the mean device time of one launch in the
traced sub-window, in % (records.fused_pointwise_share)."""

from flowbench import records


def read(rec):
    if not records.single(rec):
        return None
    return records.fused_pointwise_share(rec, 1)
