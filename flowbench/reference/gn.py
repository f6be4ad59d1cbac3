"""Plain reference of GN: Gennert–Negahdaripour optical flow with a
luminosity field, solved by preconditioned conjugate gradients.

Written from the equations of the reference implementation
(``classical.GLLOpticalFlow``, as ``SURVEY.md`` §2 describes it), in
plain torch and by default in float64; it imports nothing of the program.
Unknowns (u, v, m) on the (Ny, Nx) grid; with ``fx``, ``fy`` the central
differences of frame 2 (zero on the border), ``ft = f2 - f1``, the
per-pixel data direction ``g = (fx, fy, -f2)`` and ``L = -D^T D`` the
Laplacian of forward differences (the last difference of each line zero):

    A x = (-alpha L u, -alpha L v, -lambda L m) + g (g . x)
    b   = (-fx ft, -fy ft, f2 ft)

CG starts from 0 and stops when ``|r| <= rtol |b|`` (scipy's rule) or
after ``maxiter`` steps.  The preconditioner is the exact inverse of the
smoothness part plus the mean data diagonal of each component, in the
orthonormal 2-D DCT-II basis that diagonalises ``L``.  ``tf32=True`` runs
the transforms' products in TF32 on the card: with float32 data, the
control one precision step below the configuration's.
"""

from __future__ import annotations

import torch

from flowbench.reference.foto import (_shift, d_central_zero, dct_matrix,
                                      neumann_eigenvalues)


def forward_diff(f, axis: int):
    """f[i+1] - f[i], the last row zero."""
    g = _shift(f, 1, axis) - f
    g.select(axis, f.shape[axis] - 1).zero_()
    return g


def forward_diff_adjoint(f, axis: int):
    """D^T f for the forward difference above: f[i-1] - f[i] with the last
    entry of f taken as 0."""
    f = f.clone()
    f.select(axis, f.shape[axis] - 1).zero_()
    return _shift(f, -1, axis) - f


def laplacian(f):
    """L f = -D^T D f over x and y."""
    return -(forward_diff_adjoint(forward_diff(f, -1), -1)
             + forward_diff_adjoint(forward_diff(f, -2), -2))


class System:
    """The GN system of one pair and its spectral preconditioner."""

    def __init__(self, f1, f2, alpha, lambda_, tf32=False):
        fx, fy = d_central_zero(f2, -1), d_central_zero(f2, -2)
        ft = f2 - f1
        self.g = torch.stack([fx, fy, -f2])
        self.coef = torch.tensor([alpha, alpha, lambda_], dtype=f2.dtype,
                                 device=f2.device)[:, None, None]
        self.b = torch.stack([-fx * ft, -fy * ft, f2 * ft])
        Ny, Nx = f2.shape
        self.cy = dct_matrix(Ny, f2.dtype, f2.device)
        self.cx = dct_matrix(Nx, f2.dtype, f2.device)
        neg_l = -(neumann_eigenvalues(Ny)[:, None]
                  + neumann_eigenvalues(Nx)[None, :])
        neg_l = torch.as_tensor(neg_l, dtype=f2.dtype, device=f2.device)
        spec = self.coef * neg_l + torch.mean(self.g ** 2, dim=(-2, -1))[
            :, None, None]
        self.spec = torch.where(spec == 0, torch.ones_like(spec), spec)
        self.tf32 = tf32

    def apply(self, x):
        smooth = -self.coef * torch.stack([laplacian(c) for c in x])
        return smooth + self.g * torch.sum(self.g * x, dim=0)

    def precondition(self, r):
        flag = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        try:
            y = self.cy @ r @ self.cx.T
            return self.cy.T @ (y / self.spec) @ self.cx
        finally:
            torch.backends.cuda.matmul.allow_tf32 = flag

    def residual(self, x):
        """|b - A x| / |b|."""
        return float(torch.linalg.vector_norm(self.b - self.apply(x))
                     / torch.linalg.vector_norm(self.b))


def cg(system: System, rtol: float, maxiter: int):
    """Preconditioned CG from 0 -> (x, steps)."""
    b = system.b
    x = torch.zeros_like(b)
    r = b.clone()
    z = system.precondition(r)
    p = z
    rz = torch.sum(r * z)
    thresh2 = float(rtol * rtol * torch.sum(b * b))
    k = 0
    while k < maxiter and float(torch.sum(r * r)) > thresh2:
        q = system.apply(p)
        alpha = rz / torch.sum(p * q)
        x = x + alpha * p
        r = r - alpha * q
        z = system.precondition(r)
        rz_new = torch.sum(r * z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
    return x, k


def solve(f1, f2, *, alpha, lambda_, rtol, maxiter, tf32=False):
    """(u, v, m, steps, system) of one pair."""
    system = System(f1, f2, alpha, lambda_, tf32)
    x, steps = cg(system, rtol, maxiter)
    return x[0], x[1], x[2], steps, system

