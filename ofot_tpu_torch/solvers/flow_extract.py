"""Flow extraction: potential -> displacement field via trajectory integration.

Counterpart of ``ofot_tpu.solvers.flow_extract`` (reference
``utils.opticalflow_from_benamoubrenier``, utils.py:148-183, and
``reconstructTrajectory``, utils.py:44-99):

  * per-time-slice spatial velocities (un, vn) = grad phi_n with the
    central/'N' scheme whose boundary rows are zero (quirk 2); the last
    time slice stays zero (the reference loop runs n in [0, Nt-1));
  * forward-Euler trajectory integration over Nt-1 steps with bilinear
    velocity sampling, for all Ny*Nx start pixels at once;
  * luminosity m = -div((u, v)) with the *Dirichlet* central scheme
    (reference benamou_brenier.py:270 builds div with bc='D').

The cell index is ``int(x)`` — truncation toward zero — then clamped to
[0, N-2], and the fractional offsets are taken w.r.t. the *clamped* corner
(reference utils.py:64-71), so they may fall outside [0, 1) near the
border; the bilinear weights use them as-is.
"""

from __future__ import annotations

import torch

from ofot_tpu_torch.ops import operators


def velocities_from_potential(phi: torch.Tensor):
    """Per-slice spatial gradient of phi -> (un, vn), each (Nt, Ny, Nx);
    slice Nt-1 is zero (reference utils.py:162-168)."""
    g = operators.grad2d(phi, bc="N")     # fresh tensor, batched over time
    g[:, -1] = 0.0
    return g[0], g[1]


def integrate_trajectories(un: torch.Tensor, vn: torch.Tensor):
    """Forward-Euler particle trajectories from every pixel -> displacement
    (u, v), each (Ny, Nx)."""
    Nt, Ny, Nx = un.shape
    dtype, device = un.dtype, un.device
    x0 = torch.arange(Nx, dtype=dtype, device=device)[None, :].expand(Ny, Nx)
    y0 = torch.arange(Ny, dtype=dtype, device=device)[:, None].expand(Ny, Nx)

    x, y = x0, y0
    for n in range(Nt - 1):
        # int() truncates toward zero, then clamp to [0, N-2]
        tx = torch.clamp(torch.trunc(x).long(), 0, Nx - 2)
        ty = torch.clamp(torch.trunc(y).long(), 0, Ny - 2)
        dx = x - tx.to(dtype)
        dy = y - ty.to(dtype)

        w1 = (1.0 - dy) * (1.0 - dx)
        w2 = dx * (1.0 - dy)
        w3 = dy * dx
        w4 = (1.0 - dx) * dy

        def sample(f):
            return (w1 * f[ty, tx] + w2 * f[ty, tx + 1]
                    + w3 * f[ty + 1, tx + 1] + w4 * f[ty + 1, tx])

        x, y = x + sample(un[n]), y + sample(vn[n])
    return x - x0, y - y0


def flow_from_potential(phi: torch.Tensor):
    """phi (Nt, Ny, Nx) -> (u, v, m) displacement + luminosity fields."""
    un, vn = velocities_from_potential(phi)
    u, v = integrate_trajectories(un, vn)
    m = -operators.div2d(u, v, bc="D")
    return u, v, m
