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


def div2d(u, v, dx=1.0, dy=1.0, bc="N"):
    """Central-difference divergence of (u, v) -> (..., Ny, Nx)
    (reference ``operators.div``, operators.py:182-191)."""
    return (stencils.grad_central(u, dx, bc, axis=_AX_X)
            + stencils.grad_central(v, dy, bc, axis=_AX_Y))


# --------------------------------------------------------------------------
# space-time (3-D) operators — reference operators.py:114-157
# --------------------------------------------------------------------------

def grad_st(phi, dt=1.0, dx=1.0, dy=1.0, bc="N"):
    """Space-time gradient -> (3, Nt, Ny, Nx) = (d/dt, d/dx, d/dy), all three
    with the ``central_weird`` stencil (reference operators.py:124-127)."""
    gt = stencils.grad_central_weird(phi, dt, bc, axis=_AX_T)
    gx = stencils.grad_central_weird(phi, dx, bc, axis=_AX_X)
    gy = stencils.grad_central_weird(phi, dy, bc, axis=_AX_Y)
    return torch.stack([gt, gx, gy])


def div_st(mu, dt=1.0, dx=1.0, dy=1.0, bc="N"):
    """Space-time divergence of ``mu = (rho, m1, m2)`` -> (Nt, Ny, Nx).

    The reference's independently-built ``div_st`` (operators.py:129-142),
    which is *not* ``-grad_st^T`` (SURVEY.md §2 quirk 3)."""
    rho, m1, m2 = mu[0], mu[1], mu[2]
    return (stencils.grad_central_weird(rho, dt, bc, axis=_AX_T)
            + stencils.grad_central_weird(m1, dx, bc, axis=_AX_X)
            + stencils.grad_central_weird(m2, dy, bc, axis=_AX_Y))


def laplacian_st(phi, dt=1.0, dx=1.0, dy=1.0, bc="N"):
    """7-point space-time Laplacian ``Lt + Lx + Ly`` -> (Nt, Ny, Nx)
    (reference operators.py:144-157)."""
    return (stencils.lap1d(phi, dt, bc, axis=_AX_T)
            + stencils.lap1d(phi, dx, bc, axis=_AX_X)
            + stencils.lap1d(phi, dy, bc, axis=_AX_Y))
