"""Gennert–Negahdaripour (GN) variational optical flow with luminosity.

Counterpart of ``ofot_tpu.solvers.gn`` (reference
``classical.GLLOpticalFlow``, classical.py:25-130).  The reference
assembles a 3(wh) x 3(wh) sparse block system and solves it with a direct
sparse LU; here the same normal-equations operator is applied matrix-free
(two stencils and nine pointwise products per application) and solved
with preconditioned CG (``solvers/cg.py``, whose loop runs on the host and
reads the residual once per step).

System (SURVEY.md §2 C5), unknowns x = (u, v, m), each (Ny, Nx):

    [ -a*L + fx^2    fx*fy         -fx*f2  ] [u]   [ -fx*ft ]
    [ fy*fx          -a*L + fy^2   -fy*f2  ] [v] = [ -fy*ft ]
    [ -f2*fx         -f2*fy        -l*L+f2^2] [m]  [  f2*ft ]

with L = div @ grad = -grad_forward^T grad_forward (Neumann), fx/fy interior
central differences of **f2** with zeroed borders (classical.py:90-98), and
ft = f2 - f1 (classical.py:100).  The operator is symmetric positive
definite: the data part is the rank-1 outer product g g^T with
g = (fx, fy, -f2), the smoothness part a*G^T G (+ l*G^T G).

Preconditioners: the exact per-pixel 3x3 block of the operator's diagonal,
inverted in closed form (Sherman–Morrison), or the spectral one, the exact
inverse of the smoothness operator plus the mean data diagonal in the 2-D
DCT-II basis (``solvers/dct.py``).  No TPU kernel lies on this path in the
JAX package, and none does here.

(B, Ny, Nx) frames solve a lockstep batch (JAX's ``vmap`` of
``solve_fields``): the unknowns are (B, 3, Ny, Nx), the component axis is
-3 throughout, each pair has its own gradients, operator and
preconditioner coefficients, and the masked batched CG
(``cg.cg_batched``) stops each pair on its own residual.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ofot_tpu_torch.ops import operators, stencils
from ofot_tpu_torch.solvers import dct
from ofot_tpu_torch.solvers.cg import CGResult, cg, cg_batched


class GNResult(NamedTuple):
    u: torch.Tensor
    v: torch.Tensor
    m: torch.Tensor
    cg: CGResult


def image_gradients(f2: torch.Tensor):
    """fx, fy: interior central differences of f2, zero on the border —
    identical in action to reference classical.py:90-98."""
    fx = stencils.grad_central(f2, 1.0, "N", axis=-1)
    fy = stencils.grad_central(f2, 1.0, "N", axis=-2)
    return fx, fy


def _lap_diag(Ny: int, Nx: int, dtype, device) -> torch.Tensor:
    """Diagonal of ``-lap_gn`` = diag(G^T G) for the forward/'N' gradient:
    2 per axis in the interior, 1 on the first/last line of that axis."""
    dx = torch.full((Nx,), 2.0, dtype=dtype, device=device)
    dy = torch.full((Ny,), 2.0, dtype=dtype, device=device)
    dx[0] = dx[-1] = 1.0
    dy[0] = dy[-1] = 1.0
    return dx[None, :] + dy[:, None]


def make_operator(f2, alpha, lambda_):
    """Returns (A, M): the block operator action on (3, Ny, Nx) tensors
    ((B, 3, Ny, Nx) for (B, Ny, Nx) frames) and its Sherman–Morrison
    block-Jacobi preconditioner."""
    fx, fy = image_gradients(f2)
    # rank-1 data direction per pixel
    g = torch.stack([fx, fy, -f2], dim=-3)
    g0, g1, g2 = g.unbind(-3)

    def A(x):
        u, v, m = x.unbind(-3)
        smooth = torch.stack([
            -alpha * operators.lap_gn(u),
            -alpha * operators.lap_gn(v),
            -lambda_ * operators.lap_gn(m),
        ], dim=-3)
        data = g * (g0 * u + g1 * v + g2 * m).unsqueeze(-3)
        return smooth + data

    Ny, Nx = f2.shape[-2:]
    ld = _lap_diag(Ny, Nx, f2.dtype, f2.device)
    d = torch.stack([alpha * ld, alpha * ld, lambda_ * ld])
    return A, make_jacobi_block_preconditioner(g, d)


def make_jacobi_block_preconditioner(g, d):
    """Pointwise Sherman–Morrison block-Jacobi preconditioner shared by the
    GN and Horn–Schunck solvers: per pixel, the exact inverse of
    ``diag(d) + g g^T`` (k x k, rank-1 data block on the smoothness
    diagonal ``d``).  The component axis is -3 (a leading batch axis
    rides along)."""
    dinv = 1.0 / d
    denom = 1.0 + torch.sum(g * g * dinv, dim=-3)

    def M(rhs):
        # (D + g g^T)^-1 = D^-1 - D^-1 g g^T D^-1 / (1 + g^T D^-1 g)
        t = torch.sum(g * dinv * rhs, dim=-3)
        return dinv * rhs - dinv * g * (t / denom).unsqueeze(-3)

    return M


def make_spectral_block_preconditioner(g, coefs):
    """k-component spectral (DCT) preconditioner shared by the GN and
    Horn–Schunck solvers: per component i, the exact inverse of
    ``coefs[i] * (-L) + mean(g_i^2) * I`` in the 2-D DCT-II basis.

    ``g`` is the (k, Ny, Nx) per-pixel data direction ((B, k, Ny, Nx) for
    a lockstep batch, whose pairs each get their own mean data diagonal);
    ``coefs`` the k smoothness weights.  Entries where the spectrum is exactly zero — the
    DC mode of a component whose data term vanishes identically, e.g.
    fx == 0 for frames constant along x — act as identity instead of
    producing 0/0 = NaN (the operator itself is singular there and the
    corresponding rhs component is zero, so CG never excites the mode)."""
    Ny, Nx = g.shape[-2:]
    # the transform routes are resolved once, for both the spectrum and
    # the transforms, so that their frequency orders cannot disagree
    transform = dct.SeparableDCT((Ny, Nx), g.dtype, g.device)
    np_dtype = torch.empty((), dtype=g.dtype).numpy().dtype
    lam = torch.as_tensor(dct.neg_lap2d_spectrum_solve(
        Ny, Nx, np_dtype, modes=transform.modes), device=g.device)
    coef = torch.tensor(coefs, dtype=g.dtype, device=g.device)
    c = torch.mean(g * g, dim=(-2, -1))            # mean data diagonal
    spec = coef[:, None, None] * lam[None] + c[..., None, None]
    spec = torch.where(spec == 0, torch.ones((), dtype=g.dtype,
                                             device=g.device), spec)

    def M(rhs):
        return transform.inverse(transform.forward(rhs) / spec)

    return M


def make_spectral_preconditioner(f2, alpha, lambda_):
    """Spectral (DCT) preconditioner: exact inverse of the smoothness
    operator plus the *mean* data diagonal, per component.

    ``-lap_gn`` is diagonal in the 2-D DCT-II basis (``solvers/dct.py``),
    so M^-1 = blockdiag over components of ``(alpha_i * (-L) + c_i I)^-1``
    costs four matrix products per component and removes the Laplacian's
    long-wavelength ill-conditioning that the pointwise block-Jacobi
    preconditioner cannot touch."""
    fx, fy = image_gradients(f2)
    g = torch.stack([fx, fy, -f2], dim=-3)
    return make_spectral_block_preconditioner(g, (alpha, alpha, lambda_))


def solve_fields(f1, f2, alpha=0.1, lambda_=0.2, rtol=1e-10, maxiter=5000,
                 precond="spectral"):
    """Solve the GN system on the device of ``f1``/``f2``; returns a
    GNResult of (Ny, Nx) fields.  (B, Ny, Nx) frames solve a lockstep batch
    and return (B, Ny, Nx) fields and a CGResult of (B,) tensors.

    ``precond``: "spectral" (DCT inverse of smoothness + mean data — a few
    dozen CG steps) or "jacobi" (pointwise Sherman–Morrison 3x3 blocks)."""
    fx, fy = image_gradients(f2)
    ft = f2 - f1

    A, M_jac = make_operator(f2, alpha, lambda_)
    M = (make_spectral_preconditioner(f2, alpha, lambda_)
         if precond == "spectral" else M_jac)
    b = torch.stack([-fx * ft, -fy * ft, f2 * ft], dim=-3)

    solver = cg_batched if f2.dim() == 3 else cg
    res = solver(A, b, rtol=rtol, maxiter=maxiter, M=M)
    u, v, m = res.x.unbind(-3)
    return GNResult(u=u, v=v, m=m, cg=res)


class GLLOpticalFlow:
    """The reference class's API (reference classical.py:25-130):
    ``assemble(f1, f2)`` then ``process() -> [u, v, m]`` on flat arrays.
    The solve runs on ``device`` (the card unless the caller asks for the
    CPU), at the arrays' floating dtype."""

    NAME = "GLL"
    LUMINOSITY = True

    def __init__(self, w=0, h=0, device="cuda"):
        self.w = w
        self.h = h
        self.device = torch.device(device)
        self.alpha = 0.1
        self.lambdap = 0.2

    def setAlpha(self, alpha):
        self.alpha = alpha

    def setLambda(self, lambdap):
        self.lambdap = lambdap

    def _field(self, f):
        return torch.as_tensor(np.asarray(f), device=self.device).reshape(
            self.h, self.w)

    def assemble(self, f1, f2):
        self._f1 = self._field(f1)
        self._f2 = self._field(f2)
        return self

    def process(self):
        r = solve_fields(self._f1, self._f2, self.alpha, self.lambdap)
        return [r.u.cpu().numpy().ravel(), r.v.cpu().numpy().ravel(),
                r.m.cpu().numpy().ravel()]
