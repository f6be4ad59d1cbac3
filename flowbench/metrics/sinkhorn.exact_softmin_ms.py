"""Sinkhorn's exact softmin on the card (ops/kernels/exact_softmin.py,
csrc/exact_softmin.cu): the device time of one softmin in the traced
sub-window (ms), the sum over its kernels (names holding
``exact_softmin``, not the statistics' ``exact_stats``) of each kernel's
recorded seconds over its record count, a mean because the profiler can
drop records.  None where no such kernel was recorded (a program that
runs the softmin as eager torch ops)."""


def read(rec):
    prof = rec["profile"]
    if prof is None:
        return None
    means = [sec / count for name, (count, sec) in prof["kernels"].items()
             if "exact_softmin" in name and "exact_stats" not in name
             and count]
    return 1e3 * sum(means) if means else None
