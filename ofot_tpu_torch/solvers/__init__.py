"""Solvers (counterpart of ofot_tpu.solvers): matrix-free CG, GN/HS
variational flow, FOTO ALG2 transport, WFR unbalanced transport, entropic
(Sinkhorn) OT, spectral (DCT) solves, the pyramid, implicit
differentiation and differentiable OT values (otgrad)."""

from ofot_tpu_torch.solvers import (  # noqa: F401
    cg, gn, hs, foto, flow_extract, dct, pyramid, implicit, sinkhorn,
    wfr, otgrad)
