"""Halo-exchange stencils on spatial tiles.

Counterpart of ``ofot_tpu.parallel.halo``.  Each rank of a (y, x) mesh
(``parallel/mesh.py``) owns an (..., Ny/py, Nx/px) tile of every field,
and the one-line stencil halos travel between neighbouring ranks as
non-blocking ``isend``/``irecv`` pairs (``batch_isend_irecv``), where JAX
moves them with ``lax.ppermute``.  A rank with no neighbour on a side
receives zeros, which is the zero ghost of the truncated stencils at the
global edge.  On one card, a world of more than one rank exchanges over
gloo through host memory (``Mesh.staged``); NCCL refuses two ranks on
one device.

Boundary-condition quirks are *global*: a tile's edge rows get the special
'N'/'weird' treatment only when the tile sits on the global grid boundary,
which each rank knows from its mesh coordinate.  A size-1 axis is not
split and uses the port's ``stencils._shifted``, as JAX's does.

Requires local tile extents >= 2 along split axes (the boundary formulas
touch the first two / last two lines, which are then tile-local).

:class:`Tiled` is the form of every ops set on one rank's tile (a form
supplies what is the same across sets, ``solvers/foto.py``): halo
stencils, sums and maxima all-reduced over the plane (so every rank
reaches the same stop decision), the tile-local projection, stepA's CG
with those stencils and all-reduced dot products, and a spectral stepA
solved whole on the gathered right-hand side.  Of a set's kernels it runs
no stencil kernel, the fused pass (#1) tile-local with its sums
all-reduced, and the tile form of #4, whose four neighbouring lines
:func:`edge_lines` brings in one exchange round.
"""

from __future__ import annotations

import functools

import torch

from ofot_tpu_torch.ops import stencils
from ofot_tpu_torch.ops.kernels.cg_operator import cg_operator_tile
from ofot_tpu_torch.ops.stencils import _index, _set
from ofot_tpu_torch.parallel.mesh import Mesh
from ofot_tpu_torch.solvers.foto import Kernels, Single


def _halo_shifts(f, offsets, axis: int, mesh: Mesh, name: str):
    """``out[i] = f_global[i + offset]`` on the local tile for each offset
    in ``offsets`` (each +1 or -1), with every line the shifts need
    exchanged in one batch of non-blocking sends and receives."""
    if mesh.size(name) == 1:
        return [stencils._shifted(f, off, axis) for off in offsets]
    n = f.shape[axis]
    sends, recvs = [], []
    for off in offsets:
        if off not in (1, -1):
            raise ValueError(f"halo shift only supports |offset| == 1, "
                             f"got {off}")
        # +1: my first line goes to the rank before me, and I receive the
        # first line of the rank after me (zeros past the global edge)
        to, frm = mesh.neighbour(name, -off), mesh.neighbour(name, off)
        edge = f.narrow(axis, 0 if off == 1 else n - 1, 1)
        if to is not None:
            sends.append((to, edge))
        if frm is not None:
            recvs.append((frm, edge))
    got = iter(mesh.exchange(sends, recvs))
    out = []
    for off in offsets:
        frm = mesh.neighbour(name, off)
        edge = torch.zeros_like(f.narrow(axis, 0, 1)) if frm is None \
            else next(got)
        if off == 1:
            out.append(torch.cat([f.narrow(axis, 1, n - 1), edge], axis))
        else:
            out.append(torch.cat([edge, f.narrow(axis, 0, n - 1)], axis))
    return out


def edge_lines(f, mesh: Mesh):
    """The four lines next to this rank's tile of ``f`` (..., ty, tx), as
    the tile form of kernel #4 takes them: (up, down, left, right), the
    row above and the row below the tile, the column left and the column
    right of it, each contiguous, or None on the global edge.

    Each is a neighbour's edge line (up is the last row of the rank above
    it): all of them move in one exchange round, the x-lines (strided in
    the tile) made contiguous before the send.  Bitwise the lines
    ``_halo_shifts`` brings in at the tile's edges."""
    sides = (("y", -1), ("y", 1), ("x", -1), ("x", 1))
    peers = [None if mesh.size(name) == 1 else mesh.neighbour(name, step)
             for name, step in sides]
    sends, recvs = [], []
    for (name, step), peer in zip(sides, peers):
        if peer is not None:
            # my line facing that neighbour goes to it, and its line facing
            # me (of the same shape) comes back
            line = f.select(-2 if name == "y" else -1,
                            0 if step == -1 else -1).contiguous()
            sends.append((peer, line))
            recvs.append((peer, line))
    got = iter(mesh.exchange(sends, recvs))
    return tuple(None if peer is None else next(got) for peer in peers)


def _halo_shift(f, offset: int, axis: int, mesh: Mesh, name: str):
    """``out[i] = f_global[i + offset]`` on the local tile (|offset| = 1)."""
    return _halo_shifts(f, (offset,), axis, mesh, name)[0]


def _is_first(mesh: Mesh, name: str) -> bool:
    return mesh.index(name) == 0


def _is_last(mesh: Mesh, name: str) -> bool:
    return mesh.index(name) == mesh.size(name) - 1


def _masked_boundary_set(out, axis, mesh: Mesh, name: str, lo_val, hi_val):
    """Overwrite the global-first/global-last line of ``out`` (a fresh
    tensor) along ``axis`` with lo_val/hi_val, only on the tiles owning
    those global lines."""
    if _is_first(mesh, name):
        _set(out, 0, axis, lo_val)
    if _is_last(mesh, name):
        _set(out, -1, axis, hi_val)
    return out


def lap1d_halo(f, h, bc, axis, mesh: Mesh, name: str):
    """Distributed ``stencils.lap1d`` (3-point Laplacian with 'N'/'D' rows
    at the *global* boundary)."""
    h2 = h * h
    up, down = _halo_shifts(f, (1, -1), axis, mesh, name)
    out = (up - 2.0 * f + down) / h2
    if bc == "N":
        lo = (-_index(f, 0, axis) + _index(f, 1, axis)) / h2
        hi = (-_index(f, -1, axis) + _index(f, -2, axis)) / h2
        out = _masked_boundary_set(out, axis, mesh, name, lo, hi)
    return out


def grad_central_weird_halo(f, h, bc, axis, mesh: Mesh, name: str):
    """Distributed ``stencils.grad_central_weird`` (unscaled one-sided
    global-boundary rows for 'N')."""
    up, down = _halo_shifts(f, (1, -1), axis, mesh, name)
    out = (up - down) / (2.0 * h)
    if bc == "N":
        lo = _index(f, 1, axis) - _index(f, 0, axis)
        hi = _index(f, -1, axis) - _index(f, -2, axis)
        out = _masked_boundary_set(out, axis, mesh, name, lo, hi)
    return out


def grad_central_halo(f, h, bc, axis, mesh: Mesh, name: str):
    """Distributed ``stencils.grad_central`` (zeroed global-boundary rows
    for 'N')."""
    up, down = _halo_shifts(f, (1, -1), axis, mesh, name)
    out = (up - down) / (2.0 * h)
    if bc == "N":
        out = _masked_boundary_set(out, axis, mesh, name, 0.0, 0.0)
    return out


def grad_forward_halo(f, h, bc, axis, mesh: Mesh, name: str):
    """Distributed ``stencils.grad_forward`` ('N': global-last row zero)."""
    out = (_halo_shift(f, 1, axis, mesh, name) - f) / h
    if bc == "N" and _is_last(mesh, name):
        _set(out, -1, axis, 0.0)
    return out


def grad_forward_adjoint_halo(f, h, bc, axis, mesh: Mesh, name: str):
    """Distributed ``stencils.grad_forward_adjoint``."""
    if bc == "N" and _is_last(mesh, name):
        f = f.clone()
        _set(f, -1, axis, 0.0)
    return (_halo_shift(f, -1, axis, mesh, name) - f) / h


class Tiled(Single):
    """The form of an ops set on one rank's (y, x) tile, in place of the
    single-pair form (component axis 0): halo stencils, ``sum`` and
    ``max`` all-reduced over the plane (``max`` gives ``auto_r`` the
    global peak density, as JAX's ``pmax`` does), the tile-local
    projection, and the set's CG stepA, whose operator then runs the halo
    Laplacian and whose dot products are the all-reduced sum.  A spectral
    stepA is solved whole on the all-gathered F, this rank keeping its
    tile.  ``foto.alg2_loop`` or ``wfr.alg2_loop`` run it on tiles
    (``parallel/gspmd.py``).  Its loops stay host loops (``host_only``):
    the collectives cannot be captured in a graph."""
    name = "tiled"
    host_only = True

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def grad_st(self, phi, dt=1.0, dx=1.0, dy=1.0, bc="N"):
        gt = stencils.grad_central_weird(phi, dt, bc, axis=-3)
        gx = grad_central_weird_halo(phi, dx, bc, -1, self.mesh, "x")
        gy = grad_central_weird_halo(phi, dy, bc, -2, self.mesh, "y")
        return torch.stack([gt, gx, gy])

    def div_st(self, mu, dt=1.0, dx=1.0, dy=1.0, bc="N"):
        return (stencils.grad_central_weird(mu[0], dt, bc, axis=-3)
                + grad_central_weird_halo(mu[1], dx, bc, -1, self.mesh, "x")
                + grad_central_weird_halo(mu[2], dy, bc, -2, self.mesh, "y"))

    def laplacian_st(self, phi, dt=1.0, dx=1.0, dy=1.0, bc="N"):
        return (stencils.lap1d(phi, dt, bc, axis=-3)
                + lap1d_halo(phi, dx, bc, -1, self.mesh, "x")
                + lap1d_halo(phi, dy, bc, -2, self.mesh, "y"))

    def sum(self, x):
        return self.mesh.all_reduce(torch.sum(x))

    def max(self, x):
        """Global max over the full field: a tile-local max would give
        each rank a different ``auto_r`` penalty."""
        return self.mesh.all_reduce(torch.max(x),
                                    op=torch.distributed.ReduceOp.MAX)

    def hooks(self, kernels: Kernels) -> Kernels:
        """No stencil kernel (they would need halos): #1 on the tile with
        its criterion sums all-reduced, #4 in its tile form."""
        fused, spmv = kernels.fused_pointwise, kernels.cg_operator
        return Kernels(
            fused_pointwise=(None if fused is None else
                             functools.partial(self._fused, fused[0])),
            cg_operator=None if spmv is None else self._cg_operator_tile)

    def _fused(self, fused, grad_phi, mu, r, alpha=None, q_prev=None):
        q, mu, num, den = fused(grad_phi, mu, r, alpha, q_prev)
        return q, mu, self.mesh.all_reduce(num), self.mesh.all_reduce(den)

    def _cg_operator_tile(self, phi, r, reg_epsilon):
        """#4's tile form: one exchange round and one launch a CG step."""
        return cg_operator_tile(phi, edge_lines(phi, self.mesh), r,
                                reg_epsilon)

    def stepA(self, ops, F, *args, **kw):
        if not ops.spectral:
            return ops.solve(F, *args, **kw)
        phi, n = ops.solve(self.mesh.gather(F), *args, **kw)
        return self.mesh.tile(phi), n
