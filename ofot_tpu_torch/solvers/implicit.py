"""Implicit differentiation through the GN solve.

Counterpart of ``ofot_tpu.solvers.implicit``.  The GN solution is defined
by the SPD linear system ``A(theta) x = b(theta)``; the implicit-function
theorem gives the exact adjoint without differentiating through the CG
iterations:

    dL/dtheta = - (d r / d theta)^T w,   with  A^T w = dL/dx,  A^T = A

so the backward pass is one more preconditioned CG solve plus a
vector-Jacobian product of the residual ``r(theta) = A(theta) x -
b(theta)`` at the fixed primal solution.  The JAX ``custom_vjp`` is a
``torch.autograd.Function`` here; the residual's VJP is
``torch.autograd.grad`` through the port's ``gn.make_operator`` and
``gn.image_gradients``, which are plain torch ops (no host reads), so
autograd goes through them.
"""

from __future__ import annotations

import torch

from ofot_tpu_torch.solvers import gn
from ofot_tpu_torch.solvers.cg import cg


def _rhs(f1, f2):
    """b(theta) of the GN system (``solvers/gn.py``)."""
    fx, fy = gn.image_gradients(f2)
    ft = f2 - f1
    return torch.stack([-fx * ft, -fy * ft, f2 * ft])


def _solve(f1, f2, alpha, lambda_, rhs, rtol, maxiter):
    """CG on the GN operator with the spectral preconditioner, which only
    steers CG and so takes the parameters' values."""
    A, _ = gn.make_operator(f2, alpha, lambda_)
    M = gn.make_spectral_preconditioner(
        f2, *(float(torch.as_tensor(p).detach()) for p in (alpha, lambda_)))
    return cg(A, rhs, rtol=rtol, maxiter=maxiter, M=M).x


def _residual(theta, x):
    f1, f2, alpha, lambda_ = theta
    A, _ = gn.make_operator(f2, alpha, lambda_)
    return A(x) - _rhs(f1, f2)


class _GNSolveImplicit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f1, f2, alpha, lambda_, rtol, maxiter):
        x = _solve(f1, f2, alpha, lambda_, _rhs(f1, f2), rtol, maxiter)
        params = [torch.as_tensor(p, dtype=f2.dtype, device=f2.device)
                  for p in (alpha, lambda_)]
        ctx.save_for_backward(f1, f2, *params, x)
        ctx.solve = (rtol, maxiter)
        ctx.param_is_tensor = [isinstance(p, torch.Tensor)
                               for p in (alpha, lambda_)]
        return x

    @staticmethod
    def backward(ctx, g):
        f1, f2, alpha, lambda_, x = ctx.saved_tensors
        rtol, maxiter = ctx.solve
        w = _solve(f1, f2, alpha, lambda_, g, rtol, maxiter)   # A SPD
        with torch.enable_grad():
            theta = [t.detach().requires_grad_(True)
                     for t in (f1, f2, alpha, lambda_)]
            r = _residual(theta, x.detach())
            grads = torch.autograd.grad(r, theta, grad_outputs=-w)
        d_f1, d_f2, d_alpha, d_lambda = grads
        return (d_f1, d_f2,
                d_alpha if ctx.param_is_tensor[0] else None,
                d_lambda if ctx.param_is_tensor[1] else None,
                None, None)


def gn_solve_implicit(f1, f2, alpha, lambda_, rtol=1e-10, maxiter=5000):
    """Differentiable GN solve -> x = (u, v, m) stacked (3, Ny, Nx), on the
    device and at the dtype of the frames.

    Gradients w.r.t. the frames and w.r.t. ``alpha``/``lambda_`` (when
    they are tensors, e.g. 0-d tensors that require grad) flow through the
    implicit adjoint."""
    return _GNSolveImplicit.apply(f1, f2, alpha, lambda_, rtol, maxiter)
