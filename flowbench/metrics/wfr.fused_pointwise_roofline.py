"""Kernel #1 at k = 3 (four components: rho, m1, m2 and the source) on one
pair of a WFR cell: its least time at the cell's shape (bytes-bound,
relaxed, ``roofline.fused_pointwise(..., ncomp=4)``) over the mean device
time of one launch in the traced sub-window, the mean recorded
``fused_pointwise_kernel`` plus the mean recorded
``reduce_partials_kernel``, in %."""

from flowbench import roofline, trace


def read(rec):
    prof = rec["profile"]
    if prof is None or rec["traffic"]["batch"] != 1:
        return None
    n_main, s_main = trace.records(prof, trace.FUSED_KERNEL)
    n_red, s_red = trace.records(prof, trace.FUSED_REDUCE)
    if n_main == 0 or n_red == 0:
        return None
    t = rec["traffic"]
    points = rec["config"]["Nt"] * t["height"] * t["width"]
    nbytes, ops = roofline.fused_pointwise(points, 1, ncomp=4)
    least = roofline.bound_s(nbytes, ops, rec["device_kind"])
    return 100.0 * least / (s_main / n_main + s_red / n_red)
