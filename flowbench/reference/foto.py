"""Plain reference of FOTO: Benamou–Brenier dynamic optimal transport by
ALG2 (ADMM), its stopping rule and the flow extraction.

Written from the equations of the reference implementation
(``benamou_brenier.py``, ``operators.py``, ``utils.py`` of the original
code, as ``SURVEY.md`` §2 describes them), in plain torch and by default
in float64; it imports nothing of the program.  On a (Nt, Ny, Nx) grid
with dt = dx = dy = 1:

* stepA solves ``(-r L + r eps I) phi = div(mu - r q)`` plus the Neumann
  time-boundary terms that inject rho0 and rhoT, where ``L`` is the 7-point
  Neumann Laplacian; its orthonormal DCT-II basis diagonalises it, so the
  solve is exact: transform, divide by the spectrum, transform back;
* stepB projects ``x + mu / r`` pointwise onto the paraboloid
  ``a + |b|^2 / 2 <= 0``, with ``x = alpha grad phi + (1 - alpha) q``
  (over-relaxed ADMM);
* stepC is ``mu += r (x - q)``, the density clamped at 0;
* the criterion is ``sqrt(sum rho |g_t + |g_xy|^2 / 2| / (sum rho
  |g_xy|^2 + 1e-10))`` on the true gradient; a pair stops when it is at
  most ``tol``, when it moved by less than ``STALL`` = 1e-5 from the
  previous one, or when it is NaN, or after ``max_it`` iterations;
* the flow follows particles from every pixel by forward Euler over Nt - 1
  steps through the per-slice velocities ``grad phi`` (central, zero on the
  border, the last slice zero), sampled bilinearly; the luminosity is
  ``-div(u, v)`` with zero outside the frame.

``tf32=True`` runs the transforms' products in TF32 on the card: with
float32 data, that is the control one precision step below the
configuration's.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


# ------------------------------------------------------------- stencils

def _shift(f, k: int, axis: int):
    """g[i] = f[i + k] along ``axis``, zero outside."""
    g = torch.zeros_like(f)
    n = f.shape[axis]
    if k > 0:
        g.narrow(axis, 0, n - k).copy_(f.narrow(axis, k, n - k))
    else:
        g.narrow(axis, -k, n + k).copy_(f.narrow(axis, 0, n + k))
    return g


def d_weird(f, axis: int):
    """Central difference whose two boundary rows are the one-sided
    differences f[1] - f[0] and f[n-1] - f[n-2]."""
    g = (_shift(f, 1, axis) - _shift(f, -1, axis)) / 2.0
    n = f.shape[axis]
    g.select(axis, 0).copy_(f.select(axis, 1) - f.select(axis, 0))
    g.select(axis, n - 1).copy_(f.select(axis, n - 1) - f.select(axis, n - 2))
    return g


def d_central_zero(f, axis: int):
    """Central difference with both boundary rows zero."""
    g = (_shift(f, 1, axis) - _shift(f, -1, axis)) / 2.0
    g.select(axis, 0).zero_()
    g.select(axis, f.shape[axis] - 1).zero_()
    return g


def d_central_dirichlet(f, axis: int):
    """Central difference with zero outside the domain."""
    return (_shift(f, 1, axis) - _shift(f, -1, axis)) / 2.0


# ------------------------------------------------------------ the solve

def dct_matrix(n: int, dtype, device):
    """Orthonormal DCT-II matrix (rows are frequencies)."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    c = np.sqrt(2.0 / n) * np.cos(np.pi * k * (2 * i + 1) / (2 * n))
    c[0] /= np.sqrt(2.0)
    return torch.as_tensor(c, dtype=dtype, device=device)


def neumann_eigenvalues(n: int):
    """Eigenvalues of the 1-D Neumann Laplacian in DCT-II order."""
    return 2.0 * np.cos(np.pi * np.arange(n) / n) - 2.0


class Spectral:
    """Exact solver of ``(-r L + r eps I) phi = F`` on one grid."""

    def __init__(self, shape, r, eps, dtype, device, tf32=False):
        self.mats = [dct_matrix(n, dtype, device) for n in shape]
        lt, ly, lx = (neumann_eigenvalues(n) for n in shape)
        spec = (-r * (lt[:, None, None] + ly[None, :, None]
                      + lx[None, None, :]) + r * eps)
        self.spec = torch.as_tensor(spec, dtype=dtype, device=device)
        self.tf32 = tf32

    def _apply(self, x, inverse: bool):
        for axis, c in zip((-3, -2, -1), self.mats):
            m = c if inverse else c.T
            x = torch.matmul(x.movedim(axis, -1), m).movedim(-1, axis)
        return x

    def solve(self, F):
        flag = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        try:
            return self._apply(self._apply(F, False) / self.spec, True)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = flag


def project_paraboloid(a, b1, b2):
    """Euclidean projection of (a, b) onto ``a + |b|^2 / 2 <= 0``.

    Outside, the nearest point is (a - (s - 1), b / s) with s >= 1 the root
    of ``s^3 - (a + 1) s^2 - |b|^2 / 2 = 0`` (the multiplier's stationarity
    condition): closed form by Cardano or the trigonometric method, then
    three Newton steps on the cubic, increasing and convex on s >= 1."""
    rho2 = b1 * b1 + b2 * b2
    outside = a + 0.5 * rho2 > 0
    c = a + 1.0
    # depressed cubic y^3 + P y + Q = 0 with s = y + c / 3
    P = -c * c / 3.0
    Q = -2.0 * c ** 3 / 27.0 - 0.5 * rho2
    disc = 0.25 * Q * Q + P ** 3 / 27.0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    u = -0.5 * Q + sq
    v = -0.5 * Q - sq
    y_one = (torch.sign(u) * torch.abs(u) ** (1.0 / 3.0)
             + torch.sign(v) * torch.abs(v) ** (1.0 / 3.0))
    m = torch.sqrt(torch.clamp(-P / 3.0, min=0.0))
    arg = torch.where(m > 0, -0.5 * Q / torch.clamp(m ** 3, min=1e-300), 0.0)
    y_three = 2.0 * m * torch.cos(torch.acos(torch.clamp(arg, -1.0, 1.0))
                                  / 3.0)
    s = torch.where(disc > 0, y_one, y_three) + c / 3.0
    s = torch.maximum(s, torch.maximum(torch.ones_like(c), c))
    for _ in range(3):
        f = s * s * (s - c) - 0.5 * rho2
        df = s * (3.0 * s - 2.0 * c)
        s = s - f / df
    a_out = torch.where(outside, a - (s - 1.0), a)
    b1_out = torch.where(outside, b1 / s, b1)
    b2_out = torch.where(outside, b2 / s, b2)
    return a_out, b1_out, b2_out


def grad_st(phi):
    """(d/dt, d/dx, d/dy) of phi, each the central difference with
    one-sided boundary rows."""
    return torch.stack([d_weird(phi, -3), d_weird(phi, -1), d_weird(phi, -2)])


def div_st(mu):
    """d rho/dt + d m1/dx + d m2/dy, the same stencil."""
    return d_weird(mu[0], -3) + d_weird(mu[1], -1) + d_weird(mu[2], -2)


class Alg2Run(NamedTuple):
    """What :func:`alg2` ran: ``stop`` the iterations at its stopping
    rule, ``phi_stop`` the potential there, ``phi_read`` the potential
    after exactly ``read_at`` iterations (None if not asked), ``crits``
    the criterion after each iteration run (``crits[j - 1]`` after j)."""
    stop: int
    phi_stop: torch.Tensor
    phi_read: torch.Tensor | None
    crits: list


def alg2(rho0, rhoT, Nt, *, r, reg_epsilon, convergence_tol, max_it,
         admm_alpha, read_at=None, tf32=False) -> Alg2Run:
    """ALG2 from the interpolated density until its stop, and on to
    ``read_at`` iterations (0 included) if that lies beyond it."""
    dtype, device = rho0.dtype, rho0.device
    Ny, Nx = rho0.shape
    w = torch.arange(Nt, dtype=dtype, device=device)[:, None, None] / (Nt - 1)
    mu = torch.zeros((3, Nt, Ny, Nx), dtype=dtype, device=device)
    mu[0] = (1.0 - w) * rho0 + w * rhoT
    q = torch.zeros_like(mu)
    solver = Spectral((Nt, Ny, Nx), r, reg_epsilon, dtype, device, tf32)
    crits, stop, phi_at_stop = [], None, None
    # the potential before the first iteration is 0
    extra = torch.zeros((Nt, Ny, Nx), dtype=dtype, device=device) \
        if read_at == 0 else None
    last = max_it if read_at is None else max(max_it, read_at)
    for it in range(1, last + 1):
        F = div_st(mu - r * q)
        F[0] -= rho0 - mu[0, 0] + r * q[0, 0]
        F[-1] += rhoT - mu[0, -1] + r * q[0, -1]
        phi = solver.solve(F)
        g = grad_st(phi)
        x = admm_alpha * g + (1.0 - admm_alpha) * q
        p = x + mu / r
        q = torch.stack(project_paraboloid(p[0], p[1], p[2]))
        mu = mu + r * (x - q)
        mu[0].clamp_(min=0.0)
        speed2 = g[1] ** 2 + g[2] ** 2
        num = torch.sum(mu[0] * torch.abs(g[0] + 0.5 * speed2))
        den = torch.sum(mu[0] * speed2)
        crits.append(float(torch.sqrt(num / (den + 1e-10))))
        if stop is None and (stopped(crits, convergence_tol)
                             or it == max_it):
            stop, phi_at_stop = it, phi
        if read_at is not None and it == read_at:
            extra = phi
        if stop is not None and (read_at is None or it >= read_at):
            break
    return Alg2Run(stop, phi_at_stop, extra, crits)


STALL = 1e-5


def stopped(crits, tol) -> bool:
    """The stopping rule after the last of ``crits``: at most ``tol``, NaN,
    or within ``STALL`` of the one before."""
    c = crits[-1]
    return (c <= tol or math.isnan(c)
            or (len(crits) > 1 and abs(crits[-2] - c) < STALL))


def stop_miss(crits, k: int, tol: float, max_it: int) -> float:
    """By how much the criterion ``crits`` misses the stopping rule after
    ``k`` iterations: 0 where it holds or ``k`` is ``max_it``, else the
    smaller of ``crit - tol`` and ``|crit - previous| - STALL`` (only the
    first after one iteration)."""
    if k >= max_it:
        return 0.0
    k = max(k, 1)
    c = crits[k - 1]
    miss = c - tol
    if k > 1:
        miss = min(miss, abs(c - crits[k - 2]) - STALL)
    return max(miss, 0.0) if math.isfinite(miss) else math.inf


def flow(phi):
    """(u, v, m) from the potential: forward-Euler particle paths through
    the per-slice velocities, bilinear sampling, luminosity -div(u, v)."""
    Nt, Ny, Nx = phi.shape
    un = d_central_zero(phi, -1)
    vn = d_central_zero(phi, -2)
    x0 = torch.arange(Nx, dtype=phi.dtype, device=phi.device)[None, :].expand(
        Ny, Nx)
    y0 = torch.arange(Ny, dtype=phi.dtype, device=phi.device)[:, None].expand(
        Ny, Nx)
    x, y = x0, y0
    for n in range(Nt - 1):
        # the cell: the position truncated toward zero, kept inside the
        # frame; the offsets are taken from that cell and used as they are
        ix = torch.clamp(torch.trunc(x), 0, Nx - 2).long()
        iy = torch.clamp(torch.trunc(y), 0, Ny - 2).long()
        fx = x - ix.to(phi.dtype)
        fy = y - iy.to(phi.dtype)

        def at(f):
            return ((1 - fy) * ((1 - fx) * f[iy, ix] + fx * f[iy, ix + 1])
                    + fy * ((1 - fx) * f[iy + 1, ix] + fx * f[iy + 1, ix + 1]))

        x, y = x + at(un[n]), y + at(vn[n])
    u, v = x - x0, y - y0
    m = -(d_central_dirichlet(u, -1) + d_central_dirichlet(v, -2))
    return u, v, m
