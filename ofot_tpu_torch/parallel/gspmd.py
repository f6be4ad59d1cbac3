"""Spatially tiled solves for every ops set: the counterpart of the JAX
package's GSPMD path (``ofot_tpu.parallel.gspmd``).

JAX places the frames with a (y, x)-tiled sharding and jits the ordinary
solve, and XLA's SPMD partitioner turns the stencils into halo exchanges
and the reductions into all-reduces.  torch has no SPMD partitioner, so
here every rank of a (y, x) mesh runs the ordinary ALG2 loop on its tile
with the ops set given to the solve built on the tiled form
(:func:`sharded_ops`, ``halo.Tiled``, which decides all that follows):

  * the stencils, the pointwise passes and the reductions run tiled
    (``parallel/halo.py``), so every rank reaches the same stop decision;
  * the ``cg`` set keeps its CG stepA, on halo stencils with all-reduced
    dots (the tiled path of ``parallel/foto_sharded.py``);
  * the spectral stepA sets (``dct``, ``dct-refined``, ``dct-fused``,
    ``pallas``) solve a *global* transform: each rank all-gathers F
    ((16, 240, 320) float32 is 4.9 MB), solves it whole with the set's own
    solve (kernel #2 for ``dct-fused``) and keeps its own tile (the
    "gather route");
  * ``pallas``'s fused stepB + stepC + criterion pass (kernel #1) runs
    tile-local on each rank's tile, with its ``num``/``den`` sums
    all-reduced; its stencil kernels (S1, S2) give way to the halo
    stencils;
  * ``cg-pallas`` keeps its CG stepA as the ``cg`` set does, and its SpMV
    is the tile form of kernel #4 (``cg_operator_tile``): each CG step
    brings in the four lines next to the rank's tile in one exchange round
    (``halo.edge_lines``) and launches the kernel once on the tile.  XLA
    partitions (or gathers around) the Pallas call instead; the result is
    the same.

GN's spectral preconditioner is a global transform too and takes the
gather route; its Jacobi one is tile-local.  On one card, a world of more
than one rank shares ``cuda:0`` over gloo, staging through host memory
(NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import torch

from ofot_tpu_torch.parallel import gn_sharded
from ofot_tpu_torch.parallel.halo import Tiled
from ofot_tpu_torch.parallel.mesh import Mesh, shard_pair
from ofot_tpu_torch.solvers import foto, gn, wfr


def gather_state(state: foto.FotoState, mesh: Mesh) -> foto.FotoState:
    """A tiled solve's state with its fields gathered whole (every rank
    gets all of it, as JAX's global arrays read); the scalars are the
    same on every rank already."""
    return state._replace(mu=mesh.gather(state.mu), q=mesh.gather(state.q),
                          phi=mesh.gather(state.phi))


def sharded_ops(ops, mesh: Mesh):
    """The tiled form of the single-pair ops set ``ops`` on ``mesh`` (its
    own settings carried over, with plans of its own)."""
    if ops.form.name != foto.SINGLE.name:
        raise ValueError(f"{type(ops).__name__} on the {ops.form.name} "
                         "form is not a single-pair ops set")
    return ops.with_form(Tiled(mesh))


def _run_tiled(loop, rho0, rhoT, Nt: int, mesh: Mesh, ops, **kw):
    """``loop`` on this rank's tiles of the full frames with the tiled
    form of ``ops``, the state gathered whole at the end."""
    tile0, tileT = shard_pair(rho0, rhoT, mesh)
    state = loop(tile0, tileT, Nt, ops=sharded_ops(ops, mesh), **kw)
    return gather_state(state, mesh)


def solve_foto_sharded(rho0, rhoT, Nt: int, mesh: Mesh, *,
                       ops=foto.DEFAULT_OPS, **kw) -> foto.FotoState:
    """FOTO ALG2 with the space-time fields tiled over the mesh's (y, x)
    axes, for any single-pair ops set (default: the ``cg`` set, as
    ``foto.solve_potential``'s).  Collective, on the full frames; returns
    the whole state on every rank."""
    return _run_tiled(foto.alg2_loop, rho0, rhoT, Nt, mesh, ops, **kw)


def solve_wfr_sharded(rho0, rhoT, Nt: int, mesh: Mesh, *, ops=None, **kw):
    """Unbalanced (WFR) ALG2 with (y, x)-tiled fields; ``ops`` defaults to
    a fresh ``dct`` set, as ``wfr.solve_potential``'s (the gather
    route)."""
    ops = foto.stepA_ops("dct") if ops is None else ops
    return _run_tiled(wfr.alg2_loop, rho0, rhoT, Nt, mesh, ops, **kw)


def solve_gn_sharded(f1, f2, mesh: Mesh, alpha=0.1, lambda_=0.2,
                     rtol=1e-10, maxiter=5000, precond="spectral"):
    """GN solve with (y, x)-tiled fields, as ``gn.solve_fields``: the
    spectral preconditioner (the default) applied whole to the
    all-gathered residual, or the tile-local Jacobi one.  Collective, on
    the full frames; returns the whole fields on every rank."""
    M = None
    if precond == "spectral":
        M_whole = gn.make_spectral_preconditioner(
            torch.as_tensor(f2).to(mesh.device), alpha, lambda_)

        def M(rhs):
            return mesh.tile(M_whole(mesh.gather(rhs)))
    elif precond != "jacobi":
        raise ValueError(f"unknown precond {precond!r} (spectral or jacobi)")
    return gn_sharded.solve_fields_tiled(f1, f2, mesh, alpha, lambda_, rtol,
                                         maxiter, M=M)
