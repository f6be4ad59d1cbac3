"""WFR (unbalanced) ALG2 on spatial tiles, one tile per rank.

Counterpart of ``ofot_tpu.parallel.wfr_sharded``: ``parallel/gspmd.py``'s
tiled solve running the port's ``wfr.alg2_loop`` with the ``cg`` set on
the tiled form (``halo.Tiled``), as ``parallel/foto_sharded.py`` does.
The 4-component (rho, m1, m2, sigma) fields tile like the balanced ones
(the source channel is pointwise, so it adds no halo traffic); halos move
between neighbouring ranks and the CG and criterion reductions are
all-reduced, so every rank reaches the same stop decision.  On one card, ranks share ``cuda:0`` over gloo through host
memory (NCCL refuses two ranks on one device).

Correctness contract (tests/test_torch_parallel.py): tiled == whole-grid
WFR solve with the CG stepA, to fp tolerance.
"""

from __future__ import annotations

from ofot_tpu_torch.parallel import gspmd
from ofot_tpu_torch.parallel.mesh import Mesh
from ofot_tpu_torch.solvers import foto


def solve_potential_tiled(rho0, rhoT, Nt: int, mesh: Mesh, *,
                          delta=10.0, r=1.0, convergence_tol=0.3,
                          reg_epsilon=1e-3, max_it=100, cg_rtol=1e-6,
                          cg_maxiter=1000, admm_alpha=1.0, auto_r=False):
    """Unbalanced ALG2 with (y, x) spatial tiling: CG stepA on halo
    stencils (``gspmd.solve_wfr_sharded`` with the ``cg`` set).
    Collective, on the full frames; returns the whole state on every
    rank."""
    return gspmd.solve_wfr_sharded(
        rho0, rhoT, Nt, mesh, ops=foto.DEFAULT_OPS, delta=delta, r=r,
        convergence_tol=convergence_tol, reg_epsilon=reg_epsilon,
        max_it=max_it, cg_rtol=cg_rtol, cg_maxiter=cg_maxiter,
        admm_alpha=admm_alpha, auto_r=auto_r)
