"""The yardstick's table of peaks and the operations and bytes of the
port's kernels, counted from their shapes.

Peaks are NVIDIA's data-sheet rates of the H100 SXM at its 700 W power
limit (dense, without sparsity): 3.35 TB/s of HBM3, 67 TFLOP/s in float32
outside the tensor cores, 495 TFLOP/s in TF32.  A share is stated against
these whatever power limit the card was set to; the run prints the card's
limit beside it.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"mem_bw": 3.35e12, "f32": 67e12,
                              "tf32": 495e12},
}


def bound_s(nbytes: float, ops: float, kind: str) -> float:
    """The least time of a kernel: the larger of its bytes over the memory
    rate and its operations over the float32 rate (KeyError for a card
    the table lacks)."""
    p = PEAKS[kind]
    return max(nbytes / p["mem_bw"], ops / p["f32"])


def fused_pointwise(points: int, pairs: int = 1, relaxed: bool = True,
                    ncomp: int = 3):
    """(bytes, operations) of one launch of kernel #1 (stepB + stepC +
    criterion) over ``pairs`` pairs of ``points`` space-time points with
    ``ncomp`` components.

    Bytes: each input field read once (grad phi, mu and, relaxed, the
    previous q), q and the new mu written once, float32.  Operations, from
    the kernel source per point: 3 a component for the relaxation, 2 for
    x + mu/r, 2k+2 for |b|^2 and the membership test, 10 for stepC and 10
    for the criterion; the cubic root that points outside the paraboloid
    add depends on the data and is not counted, so the count is a least
    one."""
    k = ncomp - 1
    fields = (3 if relaxed else 2) + 2
    nbytes = fields * ncomp * points * pairs * 4
    per_point = (3 * ncomp if relaxed else 0) + 2 * ncomp + 2 * k + 2 + 20
    return nbytes, per_point * points * pairs
