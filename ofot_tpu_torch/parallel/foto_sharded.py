"""FOTO ALG2 on spatial tiles, one tile per rank.

Counterpart of ``ofot_tpu.parallel.foto_sharded``.  Every rank of a
(y, x) mesh (``parallel/mesh.py``) runs the port's own
``foto.alg2_loop`` on its (Nt, Ny/py, Nx/px) tile of every field, with
the ``cg`` set on the tiled form (``halo.Tiled``): stencil halos move
between neighbouring ranks, and the CG dot products, the criterion sums and
``auto_r``'s peak density are all-reduced.  Every rank therefore reaches
the same stop decision, from the same all-reduced values, and no rank
decides alone.  JAX runs the same loop inside ``shard_map``; here it is
``parallel/gspmd.py``'s tiled solve with the ``cg`` set, the one
implementation of every tiled ALG2 solve.

On one card, a world of more than one rank shares ``cuda:0`` over gloo,
staging the halos and reductions through host memory (NCCL refuses two
ranks on one device).

Correctness contract (tests/test_torch_parallel.py, as
tests/test_parallel.py holds JAX's): the tiled solve equals the
single-device solve to fp tolerance.
"""

from __future__ import annotations

from ofot_tpu_torch.parallel import gspmd
from ofot_tpu_torch.parallel.mesh import Mesh
from ofot_tpu_torch.solvers import foto


def solve_potential_tiled(rho0, rhoT, Nt: int, mesh: Mesh, *,
                          r=1.0, convergence_tol=0.3, reg_epsilon=1e-3,
                          max_it=100, cg_rtol=1e-6, cg_maxiter=1000,
                          admm_alpha=1.0, auto_r=False) -> foto.FotoState:
    """ALG2 with (y, x) spatial tiling: CG stepA on halo stencils
    (``gspmd.solve_foto_sharded`` with the ``cg`` set).

    Collective: every rank of the mesh calls it with the full (Ny, Nx)
    frames ``rho0``/``rhoT``; Ny, Nx must divide by the mesh's y/x sizes,
    with local tiles >= 2 along split axes.  Returns the whole state on
    every rank."""
    return gspmd.solve_foto_sharded(
        rho0, rhoT, Nt, mesh, ops=foto.DEFAULT_OPS, r=r,
        convergence_tol=convergence_tol, reg_epsilon=reg_epsilon,
        max_it=max_it, cg_rtol=cg_rtol, cg_maxiter=cg_maxiter,
        admm_alpha=admm_alpha, auto_r=auto_r)
