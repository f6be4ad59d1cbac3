"""Horn–Schunck optical flow (GN without the luminosity unknown).

Counterpart of ``ofot_tpu.solvers.hs`` (a framework extension with no
reference equivalent): the classic 2-unknown variational problem

    min  (fx u + fy v + ft)^2 + alpha (|grad u|^2 + |grad v|^2)

discretized identically to the GN solver (same fx/fy/ft, same
``-grad_forward^T grad_forward`` Laplacian) and solved matrix-free with
the same spectral or Jacobi preconditioned CG.  Setting the GN system's
third row and column to zero recovers exactly this system.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ofot_tpu_torch.ops import operators
from ofot_tpu_torch.solvers.cg import CGResult, cg
from ofot_tpu_torch.solvers.gn import (_lap_diag, image_gradients,
                                       make_jacobi_block_preconditioner,
                                       make_spectral_block_preconditioner)


class HSResult(NamedTuple):
    u: torch.Tensor
    v: torch.Tensor
    cg: CGResult


def solve_fields(f1, f2, alpha=0.1, rtol=1e-10, maxiter=5000,
                 precond="spectral", loop="auto"):
    """Solve Horn–Schunck on the device of ``f1``/``f2``; returns the
    (u, v) fields and the CG diagnostics.  ``loop``: the CG's loop
    (``cg.cg``)."""
    fx, fy = image_gradients(f2)
    ft = f2 - f1
    g = torch.stack([fx, fy])

    def A(x):
        smooth = torch.stack([-alpha * operators.lap_gn(x[0]),
                              -alpha * operators.lap_gn(x[1])])
        return smooth + g * (g[0] * x[0] + g[1] * x[1])[None]

    Ny, Nx = f2.shape
    if precond == "spectral":
        M = make_spectral_block_preconditioner(g, (alpha, alpha))
    else:
        ld = _lap_diag(Ny, Nx, f2.dtype, f2.device)
        M = make_jacobi_block_preconditioner(
            g, torch.stack([alpha * ld, alpha * ld]))

    b = torch.stack([-fx * ft, -fy * ft])
    res = cg(A, b, rtol=rtol, maxiter=maxiter, M=M, loop=loop,
             key=("hs", float(alpha), precond), bound=(g, *M.tensors))
    return HSResult(u=res.x[0], v=res.x[1], cg=res)
