"""Kernel #1's lockstep form, one launch for a batch of B pairs: its least
time at (B, 3, Nt, Ny, Nx) over the mean device time of one launch in the
traced sub-window, in % (records.fused_pointwise_share)."""

from flowbench import records


def read(rec):
    if records.single(rec):
        return None
    return records.fused_pointwise_share(rec, rec["traffic"]["batch"])
