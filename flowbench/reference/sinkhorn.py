"""Plain reference of static entropic optimal transport between two frames
(Sinkhorn), its debiased barycentric flow and the luminosity the sweep
ships with it.

Written from Cuturi, "Sinkhorn distances: lightspeed computation of
optimal transport" (NeurIPS 2013), in its log-domain form, and Schmitzer,
"Stabilized sparse scaling algorithms for entropy regularized transport
problems" (SIAM J. Sci. Comput. 41, 2019) for the eps-scaling, in plain
torch and by default in float64; it imports nothing of the program, and
of ``flowbench/reference/foto.py`` only the central difference (and
of ``wfr.py`` its switch of the TF32 flags).  Each
density is normalised to unit mass; the ground cost is ``C = (y - y')^2 +
(x - x')^2`` in px^2 and the plan ``P_ij = exp((f_i + g_j - C_ij) /
eps)``:

* the softmin ``S(h)(y, x) = eps log sum_{y', x'} exp((h(y', x') -
  C) / eps)`` exact per output entry: the cost is separable, so it is two
  ``torch.logsumexp`` stages, ``L(y', x) = logsumexp_x' (h(y', x') - (x -
  x')^2) / eps`` and ``S = eps logsumexp_y' (L(y', x) - (y - y')^2 /
  eps)``, each with its own maximum per output entry, in blocks;
* the dual updates, over-relaxed by theta: ``f <- (1 - theta) f + theta
  (eps log a - S(g))``, then ``g`` the same from the new ``f``;
* the marginal error, the larger L1 error of the plan's two marginals,
  ``sum |exp((f + S(g)) / eps) - a|`` and ``sum |exp((g + S(f)) / eps) -
  b|``, read every 25 iterations and at the last of a stage's budget; a
  stage stops at the first read that is not above ``tol`` (NaN included)
  or at its budget;
* the eps ladder: from ``eps0 = (max(Ny, Nx) / 2)^2`` divided by 4 while
  above ``1.0001 eps``, a rung of at most 50 iterations each, every rung
  starting from the last one's potentials, then the final stage at eps
  with the budget ``max_it``;
* the flow, the plan's barycentric projection ``T(i) = sum_j P_ij (y'_j,
  x'_j) / sum_j P_ij`` (f cancels), by the law of total expectation over
  the two stages (softmax weights of x' given y', then of y'), debiased
  by the self-plan's: ``(u, v) = T_ab - T_aa``, zero where the first
  density is below ``support_floor`` times its largest value;
* ``m = -div(u, v)``, central differences with zero outside the frame.

Departures from the published description, each the sweep's own: the
log of a zero density is floored at the dtype's smallest normal number
(the potential there would be -inf, and ``(1 - theta) f`` undefined);
the marginal error is read every 25 iterations, the stop is the first
such read within ``tol``, and the ladder's factor, rung budget and start
are the port's defaults (the papers iterate each scale to convergence);
the papers define no flow: the debiasing by ``T_aa`` and the 'D'
divergence are what the sweep writes.

The read rule of FOTO's reference: every rung runs to its own stop; the
final stage is read after exactly ``read_at`` iterations, the program's
own count, whether that lies before its own stop or beyond it.
:func:`stop_miss` is the float64 marginal error there less ``tol``.

The control, one precision step below the configuration's, is
:func:`solve_auto` at float32 with ``tf32=True`` (the plain two-stage
shifted matmul softmin with TF32 products) and ``bf16_sums=True`` (the
exact softmin's exponent sums in bfloat16); otherwise both TF32 flags
are off for the whole run.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from flowbench.reference.foto import d_central_dirichlet
from flowbench.reference.wfr import _Tf32

CHECK_EVERY = 25
RUNG_ITERS = 50
RUNG_FACTOR = 4.0
BLOCK = 1 << 23        # elements of one block's (rows, N, N) temporary


def _d2(n, dtype, device):
    i = torch.arange(n, dtype=dtype, device=device)
    return (i[:, None] - i[None, :]) ** 2


def _lse(x, bf16_sums: bool):
    """logsumexp over the last axis; with ``bf16_sums`` the exponentials
    and their sum in bfloat16."""
    if not bf16_sums:
        return torch.logsumexp(x, dim=-1)
    m = torch.amax(x, dim=-1)
    s = torch.exp(x - m[..., None]).to(torch.bfloat16).sum(
        dim=-1, dtype=torch.bfloat16)
    return m + torch.log(s.to(x.dtype))


def _rows(n_rows, width):
    """Rows a block takes so that its (rows, width, width) temporary holds
    about BLOCK elements."""
    return max(1, min(n_rows, BLOCK // (width * width)))


def softmin_exact(h, eps, bf16_sums=False):
    """S(h), each entry its own logsumexp over the whole grid."""
    Ny, Nx = h.shape
    d2x, d2y = _d2(Nx, h.dtype, h.device), _d2(Ny, h.dtype, h.device)
    L = torch.empty_like(h)                       # L[y', x]
    step = _rows(Ny, Nx)
    for r in range(0, Ny, step):
        A = (h[r:r + step, None, :] - d2x[None, :, :]) / eps
        L[r:r + step] = _lse(A, bf16_sums)
    S = torch.empty_like(h)
    Lt = L.T                                      # [x, y']
    step = _rows(Nx, Ny)
    for c in range(0, Nx, step):
        B = Lt[c:c + step, None, :] - d2y[None, :, :] / eps
        S[:, c:c + step] = _lse(B, bf16_sums).T
    return eps * S


def softmin_matmul(h, eps):
    """S(h) in two matrix products: the x' contraction shifted by each
    row's largest h, the y' contraction by each column's largest stage-1
    value (the products' TF32 follows the caller's flags)."""
    Ny, Nx = h.shape
    Kx = torch.exp(-_d2(Nx, h.dtype, h.device) / eps)
    Ky = torch.exp(-_d2(Ny, h.dtype, h.device) / eps)
    tiny = torch.finfo(h.dtype).tiny
    m1 = torch.amax(h, dim=1, keepdim=True)
    s1 = torch.exp((h - m1) / eps) @ Kx
    L1 = m1 + eps * torch.log(torch.clamp(s1, min=tiny))
    m2 = torch.amax(L1, dim=0, keepdim=True)
    s2 = Ky @ torch.exp((L1 - m2) / eps)
    return m2 + eps * torch.log(torch.clamp(s2, min=tiny))


def marginal_error(a, b, f, g, eps, softmin):
    """The larger L1 error of the plan's two marginals."""
    ea = torch.sum(torch.abs(torch.exp((f + softmin(g)) / eps) - a))
    eb = torch.sum(torch.abs(torch.exp((g + softmin(f)) / eps) - b))
    return float(torch.maximum(ea, eb))


def ladder(shape, epsilon):
    """The eps-scaling rungs above ``epsilon``, largest first."""
    e, out = (max(shape) / 2.0) ** 2, []
    while e > epsilon * 1.0001:
        out.append(e)
        e /= RUNG_FACTOR
    return out


class Solve(NamedTuple):
    """One solve: the potentials read, the marginal error there, the
    iterations of the final stage at the read, its own stop (None where
    it had not stopped by the read) and the final stage's reads
    [(iteration, error)]."""
    f: torch.Tensor
    g: torch.Tensor
    error: float
    iters: int
    stop: int | None
    reads: list


def stage(a, b, eps, f, g, *, budget, tol, theta, softmin, read_at=None):
    la = eps * torch.log(torch.clamp(a, min=torch.finfo(a.dtype).tiny))
    lb = eps * torch.log(torch.clamp(b, min=torch.finfo(b.dtype).tiny))
    last = budget if read_at is None else read_at
    stop, reads, err = None, [], math.nan
    for it in range(1, last + 1):
        f = (1.0 - theta) * f + theta * (la - softmin(g))
        g = (1.0 - theta) * g + theta * (lb - softmin(f))
        if it % CHECK_EVERY == 0 or it == budget or it == last:
            err = marginal_error(a, b, f, g, eps, softmin)
            reads.append((it, err))
            if stop is None and (it % CHECK_EVERY == 0 or it == budget) \
                    and not err > tol:
                stop = it
                if read_at is None:
                    break
    return Solve(f, g, err, it, stop, reads)


def solve(a, b, epsilon, *, max_it, tol, theta, read_at=None,
          softmin=None):
    """The annealed solve of ``a`` to ``b`` (unit masses taken here):
    every rung to its own stop, the final stage to its own stop or, with
    ``read_at``, read after exactly that many iterations.  ``softmin``:
    ``h, eps -> S(h)`` (default :func:`softmin_exact`)."""
    softmin = softmin or softmin_exact
    a, b = a / a.sum(), b / b.sum()
    f, g = torch.zeros_like(a), torch.zeros_like(a)
    for e in ladder(a.shape, epsilon):
        st = stage(a, b, e, f, g, budget=RUNG_ITERS, tol=tol, theta=theta,
                    softmin=lambda h, e=e: softmin(h, e))
        f, g = st.f, st.g
    return stage(a, b, epsilon, f, g, budget=max_it, tol=tol, theta=theta,
                  softmin=lambda h: softmin(h, epsilon), read_at=read_at)


def barycentre(g, eps):
    """(T_y, T_x): each source pixel's plan-conditional mean target, exact
    per entry (f cancels in the ratio)."""
    Ny, Nx = g.shape
    d2x, d2y = _d2(Nx, g.dtype, g.device), _d2(Ny, g.dtype, g.device)
    xs = torch.arange(Nx, dtype=g.dtype, device=g.device)
    ys = torch.arange(Ny, dtype=g.dtype, device=g.device)
    L = torch.empty_like(g)                        # L[y', x]
    Ex = torch.empty_like(g)                       # E[x' | y', x]
    step = _rows(Ny, Nx)
    for r in range(0, Ny, step):
        A = (g[r:r + step, None, :] - d2x[None, :, :]) / eps
        L[r:r + step] = torch.logsumexp(A, dim=-1)
        Ex[r:r + step] = torch.softmax(A, dim=-1) @ xs
    Ty, Tx = torch.empty_like(g), torch.empty_like(g)
    step = _rows(Nx, Ny)
    for c in range(0, Nx, step):
        W = torch.softmax(L.T[c:c + step, None, :] - d2y[None, :, :] / eps,
                          dim=-1)                  # [x, y, y']
        Ty[:, c:c + step] = (W @ ys).T
        Tx[:, c:c + step] = torch.einsum(
            "xyk,kx->xy", W, Ex[:, c:c + step]).T
    return Ty, Tx


def fields(a, g_ab, g_aa, epsilon, support_floor=1e-3):
    """(u, v, m) from the a->b and a->a potentials g."""
    ty, tx = barycentre(g_ab, epsilon)
    y0, x0 = barycentre(g_aa, epsilon)
    support = a > support_floor * torch.max(a)
    u = torch.where(support, tx - x0, 0.0)
    v = torch.where(support, ty - y0, 0.0)
    m = -(d_central_dirichlet(u, -1) + d_central_dirichlet(v, -2))
    return u, v, m


def stop_miss(error: float, k: int, tol: float, max_it: int) -> float:
    """By how much the marginal error ``error`` after ``k`` final-stage
    iterations misses the tolerance: 0 where it holds or ``k`` is
    ``max_it``, infinity where it is NaN."""
    if k >= max_it:
        return 0.0
    miss = error - tol
    return max(miss, 0.0) if math.isfinite(miss) else math.inf


class Auto(NamedTuple):
    """The ``auto`` stabilizer's answer: (u, v, m), the final stages'
    counts a->b and a->a and the stabilizer that gave it."""
    u: torch.Tensor
    v: torch.Tensor
    m: torch.Tensor
    iters_ab: int
    iters_aa: int
    stabilizer: str


def solve_auto(a, b, epsilon, *, max_it, tol, theta, tf32=False,
               bf16_sums=False) -> Auto:
    """The ``auto`` stabilizer written out: both solves with the matmul
    softmin, their final marginals verified with the exact one, and both
    solved again with the exact softmin where that error is not within
    ``tol``."""
    exact = (lambda h, e: softmin_exact(h, e, bf16_sums))
    with _Tf32(tf32):
        runs = [solve(a, t, epsilon, max_it=max_it, tol=tol, theta=theta,
                      softmin=softmin_matmul) for t in (b, a)]
        errs = [marginal_error(a / a.sum(), t / t.sum(), r.f, r.g,
                               epsilon, lambda h: exact(h, epsilon))
                for r, t in zip(runs, (b, a))]
        stab = "matmul"
        if not all(e <= tol for e in (*errs, *(r.error for r in runs))):
            stab = "exact"
            runs = [solve(a, t, epsilon, max_it=max_it, tol=tol,
                          theta=theta, softmin=exact) for t in (b, a)]
        u, v, m = fields(a / a.sum(), runs[0].g, runs[1].g, epsilon)
    return Auto(u, v, m, runs[0].iters, runs[1].iters, stab)
