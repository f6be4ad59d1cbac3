"""Entropic optimal transport (Sinkhorn) on image grids.

Counterpart of ``ofot_tpu.solvers.sinkhorn``: static entropic OT between
two grid densities, its cost, the debiased Sinkhorn divergence and the
barycentric optical flow of the entropic plan.  For densities on a regular
(Ny, Nx) grid with quadratic ground cost the Gibbs kernel factorizes over
axes,

    K[(y,x),(y',x')] = exp(-((y-y')^2 + (x-x')^2) / eps) = Ky ⊗ Kx,

so one Sinkhorn update is two small dense matmuls (``Ky @ W @ Kx^T``)
instead of an O((NyNx)^2) kernel product.

The iteration runs in the log domain (potentials f, g) with a two-stage
stabilized softmin: per-row shifts for the x contraction, per-column
shifts for the y contraction, both still matmuls.  The ``exact``
stabilizer (:func:`_exact_stats`) shifts per output entry instead and has
no float32 envelope, at several times the cost per iteration.

Precision envelope of the matmul softmin (measured by the JAX package,
tests/test_sinkhorn.py): float64 is exact down to eps = 1; float32 is
validated for eps >= 3 on 48x48 blobs, and the envelope scales with the
domain (eps >= ~50 on 240x320 frames; the annealed ladder holds a 1e-4
marginal error down to eps = 100).  That envelope assumes true float32
products: TF32's 10-bit mantissa in the Gibbs products would floor the
marginal error far above 1e-4.  Every product of this module therefore
runs inside :func:`_f32_matmul`, which turns TF32 off on cuda for the
duration of the call and restores the caller's settings after it, so the
result does not depend on which module was imported first.

``solve(..., verify=True)`` (the default) recomputes the final marginals
once with the exact softmin, so that a silent matmul-softmin failure past
the envelope shows up as ``marginal_error >> tol``.  Convergence at frame
scale needs epsilon annealing (:func:`solve_annealed`, the default in
:func:`flow`).

The JAX solver runs ``check_every`` iterations in a ``fori_loop`` inside a
``while_loop``; here the loop runs on the host and reads the marginal
error once per block of ``check_every`` iterations (one device-to-host
copy a block), with the last block capped at the remaining budget so that
``max_iter`` is a hard ceiling.  ``flow`` is eager (``jax.jit`` with a
static epsilon in JAX), so ``theta`` is always range-checked.

``solve``, ``solve_annealed`` and ``flow`` also take (B, Ny, Nx) stacks: a
lockstep batch (JAX's ``vmap`` of them).  Every product, softmin and
reduction then runs over the batch at once, each pair keeps its own
normalization, marginal error and stopping block (a pair that has stopped
keeps its potentials through a select, and the loop reads one "all pairs
done" flag per block), and ``iterations``, ``marginal_error`` and the
costs are (B,) tensors.  The annealing ladder depends only on (Ny, Nx,
epsilon), so the pairs share it.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import NamedTuple

import torch


class SinkhornResult(NamedTuple):
    cost: torch.Tensor            # entropic OT cost <P, C> (pixel^2 units)
    f: torch.Tensor               # (Ny, Nx) dual potential for a
    g: torch.Tensor               # (Ny, Nx) dual potential for b
    marginal_error: torch.Tensor  # L1 error of P's marginals (0-d)
    iterations: int               # (B,) tensors in a batch, as above


class FlowResult(NamedTuple):
    """Optical flow from the static entropic plan (see :func:`flow`)."""
    u: torch.Tensor               # (Ny, Nx) x-displacement
    v: torch.Tensor               # (Ny, Nx) y-displacement
    marginal_error: torch.Tensor
    iterations: int
    # entropic costs <P, C> of the solves flow() runs anyway, so that the
    # debiased W2 needs only the missing b->b self-solve; cost_aa is NaN
    # when debias=False (no self-solve was run)
    cost_ab: torch.Tensor
    cost_aa: torch.Tensor


class DivergenceResult(NamedTuple):
    """Debiased divergence (or its sqrt) plus the worst marginal error and
    the largest iteration count of the three underlying solves."""
    value: torch.Tensor
    marginal_error: torch.Tensor
    iterations: int


@contextmanager
def _f32_matmul(device):
    """True float32 matmuls on ``device`` inside the block (cuBLAS' TF32
    off), the caller's setting restored after it.  Only the cuda matmul
    flag is read and written: the process-wide precision
    (``torch.get_float32_matmul_precision``) raises once a caller has
    mixed it with the flag, and writing it back would mix them for the
    caller.  A no-op on the CPU, whose matmuls are full precision."""
    if torch.device(device).type != "cuda":
        yield
        return
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


def _matmul(x, y):
    """Every product of the module goes through here (inside
    :func:`_f32_matmul`)."""
    return torch.matmul(x, y)


def _gibbs_1d(n: int, epsilon, dtype, device) -> torch.Tensor:
    """(n, n) one-axis Gibbs kernel exp(-(i-j)^2 / eps) (symmetric)."""
    i = torch.arange(n, device=device)
    d2 = ((i[:, None] - i[None, :]) ** 2).to(dtype)
    return torch.exp(-d2 / epsilon)


def _grid_sum(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """The sum over the (Ny, Nx) grid: 0-d for one field, (B,) (or
    (B, 1, 1) with ``keepdim``) for a batch."""
    if x.dim() == 2:
        return torch.sum(x)
    return torch.sum(x, dim=(-2, -1), keepdim=keepdim)


def _larger(x, y):
    """The larger of two iteration counts (ints, or (B,) tensors)."""
    return torch.maximum(x, y) if isinstance(x, torch.Tensor) else max(x, y)


def _tiny(dtype, device) -> torch.Tensor:
    return torch.tensor(torch.finfo(dtype).tiny, dtype=dtype, device=device)


def _den_floor(dtype, device) -> torch.Tensor:
    """Smallest trustworthy stabilized denominator: a comfortable margin
    above the dtype's underflow threshold, below which the num/den ratio
    is denormal noise rather than a conditional mean."""
    return _tiny(dtype, device) * 1e8


def _exact_stats(h: torch.Tensor, eps, *, want_means: bool,
                 chunk: int = 64):
    """Exactly-stabilized softmin (and optional plan-row statistics) with
    per-output-entry max-plus shifts.

    Stage 1 contracts x' with the true shift
    ``M1[y',x] = max_x' (h[y',x'] - (x-x')^2)/eps`` (a 1-D max-plus
    transform: the largest term is exactly 1, smaller ones underflow only
    when genuinely negligible), and stage 2 contracts y' the same way; the
    stages chain exactly through log-space partial results.  With
    ``want_means`` the same pass also returns the plan-row conditional
    means E[y'], E[x'] and E[C] via the law of total expectation, all
    ratios of same-shift sums, so the stabilization cancels identically.

    Work is chunked over output columns (``chunk``) to bound the
    broadcast temporaries at (Ny, Nx, chunk); the last chunk is short
    where ``chunk`` does not divide Nx (the JAX version pads it with
    clamped duplicate columns and drops them, which gives the same
    values).  Returns S, or (S, ty, tx, ec), each (Ny, Nx) ((B, Ny, Nx)
    for a (B, Ny, Nx) batch, which stays in front of every temporary).
    """
    dtype, device = h.dtype, h.device
    Ny, Nx = h.shape[-2:]
    eps = torch.as_tensor(eps, dtype=dtype, device=device)
    ixp = torch.arange(Nx, dtype=dtype, device=device)     # source x'
    iyp = torch.arange(Ny, dtype=dtype, device=device)     # source y'
    cs = min(chunk, Nx)
    d2y = (iyp[:, None] - iyp[None, :]) ** 2              # (Ny', Ny)
    parts = []
    for start in range(0, Nx, cs):
        xs = ixp[start:start + cs]                          # output cols
        d2x_c = (ixp[:, None] - xs[None, :]) ** 2           # (Nx', cs)
        A = (h[..., :, :, None] - d2x_c[None, :, :]) / eps  # (Ny', Nx', cs)
        M1 = torch.amax(A, dim=-2)                          # (Ny', cs)
        E1 = torch.exp(A - M1[..., :, None, :])
        den1 = torch.sum(E1, dim=-2)                        # >= 1
        L1 = M1 + torch.log(den1)                           # nats
        B = L1[..., :, None, :] - d2y[:, :, None] / eps     # (Ny', Ny, cs)
        M2 = torch.amax(B, dim=-3)                          # (Ny, cs)
        E2 = torch.exp(B - M2[..., None, :, :])
        den2 = torch.sum(E2, dim=-3)
        S = eps * (M2 + torch.log(den2))                    # softmin chunk
        if not want_means:
            parts.append((S,))
            continue
        ex1 = torch.sum(E1 * ixp[None, :, None], dim=-2) / den1  # E[x'|y',x]
        ec1 = torch.sum(E1 * d2x_c[None, :, :], dim=-2) / den1   # E[(x-x')^2]
        w = E2 / den2[..., None, :, :]
        ty = torch.sum(w * iyp[:, None, None], dim=-3)
        tx = torch.sum(w * ex1[..., :, None, :], dim=-3)
        ec = (torch.sum(w * d2y[:, :, None], dim=-3)
              + torch.sum(w * ec1[..., :, None, :], dim=-3))
        parts.append((S, ty, tx, ec))
    outs = tuple(torch.cat(p, dim=-1) for p in zip(*parts))
    return outs if want_means else outs[0]


def _plan_row_stats(g, eps, Ky, Kx, pairs, tiny):
    """Stabilized row sums of the transport plan against separable weights.

    For each pair ``(Ay, Ax)`` with ``Ay = Ky * Wy`` and ``Ax = Kx * Wx``
    (entrywise weightings of the one-axis Gibbs kernels), returns

        num_i = sum_j e^{(g_j - C_ij)/eps} * Wy[iy,jy] * Wx[ix,jx]

    alongside ``den_i = sum_j e^{(g_j - C_ij)/eps}``, so ``num/den`` is the
    plan's row-conditional mean of the weight, independent of the f
    potential and of any constant offset of g.  Two-stage per-row /
    per-column shifts keep every exp argument <= 0.
    """
    # stage 1 over x' (per-y'-row shifts)
    m1 = torch.amax(g, dim=-1, keepdim=True)
    w1 = torch.exp((g - m1) / eps)
    P1 = _matmul(w1, Kx.T)                                 # at (y', x)
    S1 = m1 + eps * torch.log(torch.maximum(P1, tiny))
    # stage 2 over y' (per-x-column shifts); e2 = exp((S1 - m2)/eps) <= 1
    m2 = torch.amax(S1, dim=-2, keepdim=True)
    e2 = torch.exp((S1 - m2) / eps)
    den = _matmul(Ky, e2)
    nums = []
    for Ay, Ax in pairs:
        if Ax is Kx:
            q = e2
        else:
            # the weighted stage-1 sum recombined in log space under the
            # same m2 shift: bounded, where the algebraically equal
            # scale * P1w form can overflow for rows whose P1 is tiny
            P1w = _matmul(w1, Ax.T)
            S1w = m1 + eps * torch.log(torch.maximum(P1w, tiny))
            q = torch.exp((S1w - m2) / eps)
        nums.append(_matmul(Ay, q))
    return den, nums


def _check_theta(theta) -> float:
    theta = float(theta)
    if not 0.0 < theta < 2.0:
        raise ValueError(f"sinkhorn theta={theta} outside the "
                         "convergent range (0, 2)")
    return theta


def solve(a: torch.Tensor, b: torch.Tensor, epsilon=4.0, *,
          max_iter: int = 500, tol=1e-4, check_every: int = 25,
          init_f: torch.Tensor | None = None,
          init_g: torch.Tensor | None = None,
          theta: float = 1.0,
          stabilizer: str = "matmul",
          verify: bool = True) -> SinkhornResult:
    """Entropic OT between grid densities ``a`` and ``b`` (both (Ny, Nx),
    nonnegative; normalized to unit mass internally), on their device and
    at their dtype.

    Returns the entropic cost ``<P, C>`` with C the squared pixel
    distance.  ``epsilon`` is the entropic regularization in px^2.
    Convergence is the L1 error of both plan marginals, read every
    ``check_every`` iterations; ``max_iter`` is a hard ceiling.

    ``init_f``/``init_g`` warm-start the dual potentials (the mechanism
    behind :func:`solve_annealed`).  ``theta`` over-relaxes the dual
    updates, ``f <- (1-theta) f + theta (la - softmin(g))``; theta = 1 is
    the classical iteration, and every theta in (0, 2) has the same fixed
    point.  A theta outside that range diverges to NaN potentials, which
    would pass every ``err > tol`` check vacuously, so it raises.
    """
    theta = _check_theta(theta)
    if stabilizer not in ("matmul", "exact"):
        raise ValueError(f"unknown stabilizer {stabilizer!r} "
                         "(expected 'matmul' or 'exact')")
    with _f32_matmul(a.device):
        return _solve_impl(a, b, epsilon, max_iter=max_iter, tol=tol,
                           check_every=check_every, init_f=init_f,
                           init_g=init_g, theta=theta,
                           stabilizer=stabilizer, verify=verify)


def _solve_impl(a, b, epsilon, *, max_iter, tol, check_every, init_f,
                init_g, theta, stabilizer, verify) -> SinkhornResult:
    dtype, device = a.dtype, a.device
    eps = torch.as_tensor(epsilon, dtype=dtype, device=device)
    Ny, Nx = a.shape[-2:]
    a = a / _grid_sum(a, keepdim=True)
    b = b / _grid_sum(b, keepdim=True)
    Ky = _gibbs_1d(Ny, eps, dtype, device)
    Kx = _gibbs_1d(Nx, eps, dtype, device)
    tiny = _tiny(dtype, device)
    la = eps * torch.log(torch.maximum(a, tiny))
    lb = eps * torch.log(torch.maximum(b, tiny))

    def softmin_matmul(h):
        """eps * log(sum_{y',x'} exp((h[y',x'] - Cy - Cx)/eps)) as a field
        over (y, x), in two stabilized stages: per-y'-row shifts for the
        x' contraction, then per-x-column shifts for the y' contraction.
        K is symmetric, so the same form serves both marginals."""
        m1 = torch.amax(h, dim=-1, keepdim=True)                 # (Ny, 1)
        s1 = _matmul(torch.exp((h - m1) / eps), Kx.T)
        S1 = m1 + eps * torch.log(torch.maximum(s1, tiny))       # (y', x)
        m2 = torch.amax(S1, dim=-2, keepdim=True)                # (1, Nx)
        s2 = _matmul(Ky, torch.exp((S1 - m2) / eps))
        return m2 + eps * torch.log(torch.maximum(s2, tiny))

    def softmin_exact(h):
        return _exact_stats(h, eps, want_means=False)

    softmin = softmin_matmul if stabilizer == "matmul" else softmin_exact
    th = torch.tensor(theta, dtype=dtype, device=device)

    f = torch.zeros_like(a) if init_f is None else init_f
    g = torch.zeros_like(a) if init_g is None else init_g
    pairs = a.shape[:-2]      # () for one pair, (B,) for a batch
    err = torch.full(pairs, float("inf"), dtype=dtype, device=device)
    # each pair's count, and which pairs have stopped
    its = torch.zeros(pairs, dtype=torch.int64, device=device)
    done = torch.zeros(pairs, dtype=torch.bool, device=device)
    it = 0
    while it < max_iter:
        # the last block capped at the remaining budget
        n = min(check_every, max_iter - it)
        f_new, g_new = f, g
        for _ in range(n):
            f_new = (1.0 - th) * f_new + th * (la - softmin(g_new))
            g_new = (1.0 - th) * g_new + th * (lb - softmin(f_new))
        # both plan marginals: the over-relaxed iteration can satisfy a
        # and miss b
        err_a = _grid_sum(torch.abs(
            torch.exp((f_new + softmin(g_new)) / eps) - a))
        err_b = _grid_sum(torch.abs(
            torch.exp((g_new + softmin(f_new)) / eps) - b))
        it += n
        # a pair that stopped at an earlier block keeps its state
        run = ~done
        keep = run.view(*pairs, 1, 1)
        f = torch.where(keep, f_new, f)
        g = torch.where(keep, g_new, g)
        err = torch.where(run, torch.maximum(err_a, err_b), err)
        its = torch.where(run, it, its)
        done = done | ~(err > tol)
        # the one read of a block: the JAX while_loop's condition
        if bool(done.all()):
            break

    # entropic cost <P, C>, gauge-free: sum_i a_i E_i with E_i the plan
    # row's conditional mean cost (the f potential and every offset of g
    # cancel in the ratio)
    if stabilizer == "exact":
        _, _, _, E = _exact_stats(g, eps, want_means=True)
    else:
        i_y = torch.arange(Ny, device=device)
        i_x = torch.arange(Nx, device=device)
        KyD = Ky * ((i_y[:, None] - i_y[None, :]) ** 2).to(dtype)
        KxD = Kx * ((i_x[:, None] - i_x[None, :]) ** 2).to(dtype)
        den, (numCy, numCx) = _plan_row_stats(
            g, eps, Ky, Kx, [(KyD, Kx), (Ky, KxD)], tiny)
        # rows whose stabilized denominator underflowed carry no usable
        # information; a bare den > 0 test let denormal ratios blow the
        # sum up to inf
        E = torch.where(den > _den_floor(dtype, device),
                        (numCy + numCx) / torch.maximum(den, tiny), 0.0)
    cost = _grid_sum(a * E)
    if stabilizer == "matmul" and verify:
        # the final marginals once more with the exactly-shifted softmin,
        # so that a silent matmul-softmin failure (a small iteration error
        # for a garbage plan past the exp window) surfaces as
        # marginal_error >> tol
        err_a = _grid_sum(torch.abs(torch.exp(
            (f + _exact_stats(g, eps, want_means=False)) / eps) - a))
        err_b = _grid_sum(torch.abs(torch.exp(
            (g + _exact_stats(f, eps, want_means=False)) / eps) - b))
        err = torch.maximum(err, torch.maximum(err_a, err_b))
    return SinkhornResult(cost=cost, f=f, g=g, marginal_error=err,
                          iterations=its if pairs else int(its))


def solve_annealed(a: torch.Tensor, b: torch.Tensor, epsilon=4.0, *,
                   max_iter: int = 500, tol=1e-4, check_every: int = 25,
                   anneal_from: float | None = None,
                   anneal_factor: float = 4.0,
                   stage_iters: int = 50,
                   theta: float = 1.0,
                   stabilizer: str = "matmul",
                   verify: bool = True) -> SinkhornResult:
    """Epsilon-annealed Sinkhorn (Schmitzer's eps-scaling).

    Plain Sinkhorn's contraction rate degrades with ``osc(C)/eps``, and at
    frame-scale domains the plain iteration stalls.  Annealing runs a
    geometric ladder of stages from ``anneal_from`` (default
    ``(max(Ny, Nx)/2)^2``) down to ``epsilon``, each of at most
    ``stage_iters`` iterations, warm-starting each stage's potentials from
    the previous one; only the final stage's marginal error is verified
    and reported.
    """
    # an unbounded ladder otherwise
    if not anneal_factor > 1.0:
        raise ValueError(f"anneal_factor={anneal_factor} must be > 1")
    if not float(epsilon) > 0.0:
        raise ValueError(f"epsilon={epsilon} must be > 0")
    Ny, Nx = a.shape[-2:]
    eps0 = float(anneal_from if anneal_from is not None
                 else (max(Ny, Nx) / 2.0) ** 2)
    ladder = []
    e = eps0
    while e > float(epsilon) * 1.0001:
        ladder.append(e)
        e /= anneal_factor
    f = g = None
    for e in ladder:
        res = solve(a, b, e, max_iter=stage_iters, tol=tol,
                    check_every=min(check_every, stage_iters),
                    init_f=f, init_g=g, theta=theta, stabilizer=stabilizer,
                    verify=False)
        f, g = res.f, res.g
    return solve(a, b, epsilon, max_iter=max_iter, tol=tol,
                 check_every=check_every, init_f=f, init_g=g, theta=theta,
                 stabilizer=stabilizer, verify=verify)


def flow(a: torch.Tensor, b: torch.Tensor, epsilon=4.0, *,
         max_iter: int = 500, tol=1e-4, check_every: int = 25,
         support_floor=1e-3, debias: bool = True,
         anneal: bool = True, theta: float = 1.0,
         stabilizer: str = "matmul") -> FlowResult:
    """Optical flow as the barycentric projection of the entropic plan:
    every source pixel maps to its plan-conditional mean target position,

        T(i) = E_{j ~ P(· | i)} [ (y'_j, x'_j) ],    (u, v) = T(i) - i.

    Both components come from the same gauge-free two-stage matmul ratio
    as the cost (:func:`_plan_row_stats`).  Displacement is zeroed where
    the source density is below ``support_floor * max(a)`` or where the
    stabilized denominator underflowed.

    ``debias=True`` subtracts the self-plan's barycentric map ``T_aa``
    instead of the raw grid, which cancels the entropic blur's contraction
    toward the mass center to first order.  ``iterations`` is the larger
    of the a->b and a->a solves' counts.
    """
    dtype, device = a.dtype, a.device
    eps = torch.as_tensor(epsilon, dtype=dtype, device=device)
    Ny, Nx = a.shape[-2:]
    an = a / _grid_sum(a, keepdim=True)
    _solve = solve_annealed if anneal else solve
    kw = dict(max_iter=max_iter, tol=tol, check_every=check_every,
              theta=theta, stabilizer=stabilizer)
    with _f32_matmul(device):
        res = _solve(a, b, epsilon, **kw)
        Ky = _gibbs_1d(Ny, eps, dtype, device)
        Kx = _gibbs_1d(Nx, eps, dtype, device)
        tiny = _tiny(dtype, device)
        # target-coordinate weights: Wy = y' (on the y axis), Wx = x'
        jy = torch.arange(Ny, dtype=dtype, device=device)[None, :]
        jx = torch.arange(Nx, dtype=dtype, device=device)[None, :]
        pairs = [(Ky * jy, Kx), (Ky, Kx * jx)]

        def bary(g):
            if stabilizer == "exact":
                # well-defined for every row (the nearest mass dominates)
                _, ty, tx, _ = _exact_stats(g, eps, want_means=True)
                return ty, tx, torch.ones_like(ty, dtype=torch.bool)
            den, (numY, numX) = _plan_row_stats(g, eps, Ky, Kx, pairs, tiny)
            safe = torch.maximum(den, tiny)
            # den underflow: the ratio there is denormal noise up to inf
            ok = den > _den_floor(dtype, device)
            return numY / safe, numX / safe, ok

        ty, tx, ok = bary(res.g)
        if debias:
            self_res = _solve(a, a, epsilon, **kw)
            y0, x0, ok0 = bary(self_res.g)
            ok = ok & ok0
            err = torch.maximum(res.marginal_error, self_res.marginal_error)
            its = _larger(res.iterations, self_res.iterations)
            cost_aa = self_res.cost
        else:
            y0 = torch.arange(Ny, dtype=dtype, device=device)[:, None] \
                .expand(Ny, Nx)
            x0 = torch.arange(Nx, dtype=dtype, device=device)[None, :] \
                .expand(Ny, Nx)
            err, its = res.marginal_error, res.iterations
            cost_aa = torch.full(a.shape[:-2], float("nan"), dtype=dtype,
                                 device=device)
        support = (an > support_floor * torch.amax(
            an, dim=(-2, -1), keepdim=True)) & ok
        u = torch.where(support, tx - x0, 0.0)
        v = torch.where(support, ty - y0, 0.0)
    return FlowResult(u=u, v=v, marginal_error=err, iterations=its,
                      cost_ab=res.cost, cost_aa=cost_aa)


def sinkhorn_divergence(a: torch.Tensor, b: torch.Tensor, epsilon=4.0,
                        full: bool = False, anneal: bool = True, **kw):
    """Debiased Sinkhorn divergence
    ``S = OT_eps(a,b) - (OT_eps(a,a) + OT_eps(b,b)) / 2``, which removes
    the entropic blur bias so that sqrt(S) tracks the true W2.

    ``full=True`` returns a :class:`DivergenceResult` carrying the worst
    ``marginal_error`` of the three solves, so that callers can detect a
    max_iter exit."""
    _solve = solve_annealed if anneal else solve
    ab = _solve(a, b, epsilon, **kw)
    aa = _solve(a, a, epsilon, **kw)
    bb = _solve(b, b, epsilon, **kw)
    value = ab.cost - 0.5 * (aa.cost + bb.cost)
    if not full:
        return value
    return DivergenceResult(
        value=value,
        marginal_error=torch.maximum(ab.marginal_error, torch.maximum(
            aa.marginal_error, bb.marginal_error)),
        iterations=max(ab.iterations, aa.iterations, bb.iterations))


def wasserstein2_entropic(a: torch.Tensor, b: torch.Tensor, epsilon=4.0,
                          full: bool = False, **kw):
    """sqrt of the debiased Sinkhorn divergence: a static-OT estimate of
    W2 in pixel units.  ``full=True`` returns a :class:`DivergenceResult`
    with convergence diagnostics."""
    res = sinkhorn_divergence(a, b, epsilon, full=full, **kw)
    if not full:
        return torch.sqrt(torch.clamp(res, min=0.0))
    return res._replace(value=torch.sqrt(torch.clamp(res.value, min=0.0)))
