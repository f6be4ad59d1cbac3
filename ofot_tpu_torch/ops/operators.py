"""Matrix-free 2-D and space-time (3-D) differential operators on tensors.

Counterpart of ``ofot_tpu.ops.operators``, with the same layout as the
reference's flat row-major indexing (reference operators.py:114-191):

  * spatial fields are ``(Ny, Nx)``: x (image column) on axis -1, y (image
    row) on axis -2;
  * space-time fields are ``(Nt, Ny, Nx)`` with time on axis -3;
  * vector fields carry the component axis first: ``(2, Ny, Nx)`` or
    ``(3, Nt, Ny, Nx)``.

``grad_st``/``div_st`` use the ``grad_central_weird`` stencil like the
reference, and ``laplacian_st`` is the independently-built 7-point
Laplacian — deliberately NOT ``div_st @ grad_st`` (SURVEY.md §2 quirk 3).
"""

from __future__ import annotations

import torch

from ofot_tpu_torch.ops import stencils

_AX_X = -1   # image column
_AX_Y = -2   # image row
_AX_T = -3   # time (space-time fields only)


# --------------------------------------------------------------------------
# spatial (2-D) operators — reference operators.py:160-191
# --------------------------------------------------------------------------

def grad2d(f, dx=1.0, dy=1.0, bc="N"):
    """Central-difference spatial gradient -> (2, ..., Ny, Nx) = (d/dx, d/dy).

    With bc='N' the boundary rows are zero, so the gradient vanishes on the
    image border (SURVEY.md §2 quirk 2)."""
    gx = stencils.grad_central(f, dx, bc, axis=_AX_X)
    gy = stencils.grad_central(f, dy, bc, axis=_AX_Y)
    return torch.stack([gx, gy])


def grad_forward2d(f, dx=1.0, dy=1.0, bc="N"):
    """Forward-difference spatial gradient -> (2, ..., Ny, Nx)
    (reference ``operators.grad_forward``, operators.py:171-180)."""
    gx = stencils.grad_forward(f, dx, bc, axis=_AX_X)
    gy = stencils.grad_forward(f, dy, bc, axis=_AX_Y)
    return torch.stack([gx, gy])


def div2d(u, v, dx=1.0, dy=1.0, bc="N"):
    """Central-difference divergence of (u, v) -> (..., Ny, Nx)
    (reference ``operators.div``, operators.py:182-191)."""
    return (stencils.grad_central(u, dx, bc, axis=_AX_X)
            + stencils.grad_central(v, dy, bc, axis=_AX_Y))


def div_forward_adjoint2d(u, v, dx=1.0, dy=1.0, bc="N"):
    """``div = -grad_forward^T`` applied to (u, v), as the GN solver builds it
    (reference classical.py:102-103)."""
    return -(stencils.grad_forward_adjoint(u, dx, bc, axis=_AX_X)
             + stencils.grad_forward_adjoint(v, dy, bc, axis=_AX_Y))


def lap_gn(f, dx=1.0, dy=1.0, bc="N"):
    """GN smoothness Laplacian ``lap = div @ grad = -grad_forward^T
    grad_forward`` (reference classical.py:102-104), applied matrix-free."""
    gx = stencils.grad_forward(f, dx, bc, axis=_AX_X)
    gy = stencils.grad_forward(f, dy, bc, axis=_AX_Y)
    return div_forward_adjoint2d(gx, gy, dx, dy, bc)


# --------------------------------------------------------------------------
# space-time (3-D) operators — reference operators.py:114-157
# --------------------------------------------------------------------------

def grad_st(phi, dt=1.0, dx=1.0, dy=1.0, bc="N", dim=0):
    """Space-time gradient -> (3, Nt, Ny, Nx) = (d/dt, d/dx, d/dy), all three
    with the ``central_weird`` stencil (reference operators.py:124-127).
    ``dim``: the component axis of the result (1 for a (B, Nt, Ny, Nx)
    batch of potentials, giving (B, 3, Nt, Ny, Nx))."""
    gt = stencils.grad_central_weird(phi, dt, bc, axis=_AX_T)
    gx = stencils.grad_central_weird(phi, dx, bc, axis=_AX_X)
    gy = stencils.grad_central_weird(phi, dy, bc, axis=_AX_Y)
    return torch.stack([gt, gx, gy], dim=dim)


def div_st(mu, dt=1.0, dx=1.0, dy=1.0, bc="N", dim=0):
    """Space-time divergence of ``mu = (rho, m1, m2)`` -> (Nt, Ny, Nx).
    ``dim``: the component axis of ``mu`` (1 for a batch).

    The reference's independently-built ``div_st`` (operators.py:129-142),
    which is *not* ``-grad_st^T`` (SURVEY.md §2 quirk 3)."""
    rho, m1, m2 = (mu.select(dim, i) for i in range(3))
    return (stencils.grad_central_weird(rho, dt, bc, axis=_AX_T)
            + stencils.grad_central_weird(m1, dx, bc, axis=_AX_X)
            + stencils.grad_central_weird(m2, dy, bc, axis=_AX_Y))


def laplacian_st(phi, dt=1.0, dx=1.0, dy=1.0, bc="N"):
    """7-point space-time Laplacian ``Lt + Lx + Ly`` -> (Nt, Ny, Nx)
    (reference operators.py:144-157)."""
    return (stencils.lap1d(phi, dt, bc, axis=_AX_T)
            + stencils.lap1d(phi, dx, bc, axis=_AX_X)
            + stencils.lap1d(phi, dy, bc, axis=_AX_Y))
