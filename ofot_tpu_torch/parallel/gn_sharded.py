"""GN variational solve on spatial tiles, one tile per rank.

Counterpart of ``ofot_tpu.parallel.gn_sharded``.  The GN block operator
tiles cleanly: the smoothness Laplacian ``-grad_forward^T grad_forward``
becomes halo stencils (``parallel/halo.py``), the rank-1 data term and the
Sherman–Morrison block-Jacobi preconditioner are pointwise (tile-local),
and the CG dot products are all-reduced, so that every rank stops CG on
the same step.  The spectral (DCT) preconditioner is a *global* transform,
so the tiled path uses the Jacobi preconditioner, as JAX's does; the
spectral one runs on the gather route of ``parallel/gspmd.py``, which
passes it to :func:`solve_fields_tiled` as ``M``.  On one card, ranks
share ``cuda:0`` over gloo through host memory (NCCL refuses two ranks on
one device).

Tile-vs-whole equivalence is held in tests/test_torch_parallel.py.
"""

from __future__ import annotations

import torch

from ofot_tpu_torch.parallel import halo
from ofot_tpu_torch.parallel.mesh import Mesh, shard_pair
from ofot_tpu_torch.solvers import gn
from ofot_tpu_torch.solvers.cg import cg


def _lap_gn_halo(u, mesh: Mesh):
    gx = halo.grad_forward_halo(u, 1.0, "N", -1, mesh, "x")
    gy = halo.grad_forward_halo(u, 1.0, "N", -2, mesh, "y")
    return -(halo.grad_forward_adjoint_halo(gx, 1.0, "N", -1, mesh, "x")
             + halo.grad_forward_adjoint_halo(gy, 1.0, "N", -2, mesh, "y"))


def _lap_diag_tile(shape, mesh: Mesh, dtype, device):
    """Per-tile diagonal of -lap_gn: 2 per axis interior, 1 on the lines
    that are *globally* first/last along that axis."""
    def axis_diag(n, name):
        d = torch.full((n,), 2.0, dtype=dtype, device=device)
        if halo._is_first(mesh, name):
            d[0] = 1.0
        if halo._is_last(mesh, name):
            d[-1] = 1.0
        return d

    ny, nx = shape
    return axis_diag(nx, "x")[None, :] + axis_diag(ny, "y")[:, None]


def tile_solve(f1, f2, mesh: Mesh, alpha, lambda_, rtol, maxiter,
               M=None) -> gn.GNResult:
    """GN on this rank's (ny, nx) tiles, preconditioned by ``M`` (an
    action on (3, ny, nx) tiles; default: the block Jacobi one)."""
    fx = halo.grad_central_halo(f2, 1.0, "N", -1, mesh, "x")
    fy = halo.grad_central_halo(f2, 1.0, "N", -2, mesh, "y")
    ft = f2 - f1
    g = torch.stack([fx, fy, -f2], dim=-3)
    g0, g1, g2 = g.unbind(-3)

    def A(x):
        u, v, m = x.unbind(-3)
        smooth = torch.stack([
            -alpha * _lap_gn_halo(u, mesh),
            -alpha * _lap_gn_halo(v, mesh),
            -lambda_ * _lap_gn_halo(m, mesh),
        ], dim=-3)
        return smooth + g * (g0 * u + g1 * v + g2 * m).unsqueeze(-3)

    if M is None:
        ld = _lap_diag_tile(f2.shape, mesh, f2.dtype, f2.device)
        d = torch.stack([alpha * ld, alpha * ld, lambda_ * ld])
        M = gn.make_jacobi_block_preconditioner(g, d)
    b = torch.stack([-fx * ft, -fy * ft, f2 * ft], dim=-3)
    res = cg(A, b, rtol=rtol, maxiter=maxiter, M=M,
             dot=lambda p, q: mesh.all_reduce(torch.sum(p * q)),
             loop="host")
    u, v, m = res.x.unbind(-3)
    return gn.GNResult(u=u, v=v, m=m, cg=res)


def gather_result(res: gn.GNResult, mesh: Mesh) -> gn.GNResult:
    """A tiled GN result with its fields gathered whole on every rank."""
    x = mesh.gather(res.cg.x)
    u, v, m = x.unbind(-3)
    return gn.GNResult(u=u, v=v, m=m, cg=res.cg._replace(x=x))


def solve_fields_tiled(f1, f2, mesh: Mesh, alpha=0.1, lambda_=0.2,
                       rtol=1e-10, maxiter=5000, M=None) -> gn.GNResult:
    """GN solve with the grid tiled over the mesh's (y, x) axes,
    preconditioned by ``M`` (an action on (3, ny, nx) tiles; default: the
    block Jacobi one, as JAX's).  Collective, on the full frames; returns
    the whole fields on every rank."""
    t1, t2 = shard_pair(f1, f2, mesh)
    res = tile_solve(t1, t2, mesh, alpha, lambda_, rtol, maxiter, M)
    return gather_result(res, mesh)
