"""FOTO — Benamou–Brenier dynamic optimal transport via ALG2/ADMM, in torch.

Counterpart of ``ofot_tpu.solvers.foto`` (reference
benamou_brenier.py:151-271).  One ALG2 iteration is stepA (a Poisson-like
solve for the potential), stepB (pointwise paraboloid projection), stepC
(dual ascent) and the Hamilton–Jacobi convergence criterion, on
(3, Nt, Ny, Nx) tensors.  The JAX version runs the loop as a
``lax.while_loop`` on the device; here the loop runs on the host and reads
the ``done`` flag once per iteration (one device-to-host copy).

Algorithm parity notes (SURVEY.md §2 C6):
  * grid spacings dt = dx = dy = 1 (reference benamou_brenier.py:185-187);
  * ``A = -r * L_st + r * eps * I`` with the independently-built 7-point
    space-time Laplacian, NOT div_st @ grad_st (quirk 3);
  * stepA RHS gets non-homogeneous Neumann time-boundary corrections
    injecting rho0 / rhoT (reference benamou_brenier.py:72-82);
  * inner CG: rtol=1e-6, maxiter=1000, scipy convergence test
    (reference benamou_brenier.py:85);
  * stepC clamps the density channel at 0 (reference benamou_brenier.py:232);
  * stopping: crit <= tol, or stagnation |crit_prev - crit| < 1e-5 once a
    previous criterion exists (reference benamou_brenier.py:254-258), or a
    NaN criterion (divergence guard).

Ops sets (``stepA_ops``), named as the JAX CLI names them:
  * ``cg``: matrix-free CG stepA and the unfused stepB/stepC/criterion;
  * ``dct``: exact spectral stepA (``solvers/dct.py``), unfused rest;
  * ``pallas``: spectral stepA plus the fused stepB + stepC + criterion
    pass, which on CUDA tensors is the hand-written kernel
    (``ops/kernels/fused_pointwise.py``).  The name is the JAX flag value,
    kept so that run scripts work unchanged.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ofot_tpu_torch.ops import operators
from ofot_tpu_torch.ops.kernels.fused_pointwise import fused_pointwise
from ofot_tpu_torch.ops.projection import project_paraboloid
from ofot_tpu_torch.solvers import cg as cg_mod
from ofot_tpu_torch.solvers import dct, flow_extract


class _DefaultOps:
    """Space-time operator set: plain torch stencils, CG stepA."""
    grad_st = staticmethod(operators.grad_st)
    div_st = staticmethod(operators.div_st)
    laplacian_st = staticmethod(operators.laplacian_st)
    sum = staticmethod(torch.sum)
    max = staticmethod(torch.max)
    project = staticmethod(project_paraboloid)

    def cg_operator(self, r, reg_epsilon):
        """The stepA system operator A = -r*L_st + r*eps*I as a callable."""
        return lambda phi: (-r * self.laplacian_st(phi, bc="N")
                            + (r * reg_epsilon) * phi)

    def stepA_solve(self, F, r, reg_epsilon, cg_rtol, cg_maxiter):
        """Solve A phi = F; returns (phi, inner_iterations).  Default:
        matrix-free CG with the reference's scipy-cg semantics."""
        res = cg_mod.cg(self.cg_operator(r, reg_epsilon), F, rtol=cg_rtol,
                        maxiter=cg_maxiter, dot=lambda a, b: self.sum(a * b))
        return res.x, res.iterations


class DCTOps(_DefaultOps):
    """Spectral stepA: six full-float32 matrix products and a pointwise
    divide instead of hundreds of CG iterations.  Each instance keeps the
    transform matrices and spectrum of the systems it has solved, so one
    solve builds them once."""

    def __init__(self):
        self._plans = {}

    def stepA_solve(self, F, r, reg_epsilon, cg_rtol, cg_maxiter):
        key = (tuple(F.shape), F.dtype, F.device, float(r),
               float(reg_epsilon))
        plan = self._plans.get(key)
        if plan is None:
            plan = self._plans[key] = dct.StepAPlan(
                F.shape, float(r), float(reg_epsilon), F.dtype, F.device)
        return plan.solve(F), 1


class PallasOps(DCTOps):
    """Spectral stepA plus the fused stepB + stepC + criterion pass (one
    kernel launch per ALG2 iteration on CUDA tensors)."""
    fused_pointwise = staticmethod(fused_pointwise)


DEFAULT_OPS = _DefaultOps()

_OPS = {"cg": _DefaultOps, "dct": DCTOps, "pallas": PallasOps}
_LATER = {
    "dct-refined": "the refined spectral stepA is not ported yet (it waits "
                   "for the later slice that ports the dct fold/FFT/refined "
                   "routes)",
    "dct-fused": "the dct-fused stepA needs the dct_solve kernel, which the "
                 "next slice of the port brings",
    "cg-pallas": "the cg-pallas stepA needs the CG operator kernels, which "
                 "a later slice of the port brings",
}


def resolve_stepA_solver(solver: str, device) -> str:
    """Resolve the user-facing stepA solver name for a device.

    ``auto``: ``pallas`` (spectral stepA + the fused CUDA pass) on CUDA,
    reference-faithful ``cg`` on the CPU (as the JAX package resolves
    cpu/gpu)."""
    if solver == "auto":
        return "pallas" if torch.device(device).type == "cuda" else "cg"
    return solver


def stepA_ops(solver: str):
    """A fresh ops set for a resolved solver name (ValueError on an unknown
    or not yet ported name)."""
    if solver in _LATER:
        raise ValueError(f"stepA_solver {solver!r}: {_LATER[solver]}")
    try:
        return _OPS[solver]()
    except KeyError:
        raise ValueError(f"unknown stepA_solver {solver!r}") from None


class FotoState(NamedTuple):
    """Carry of the ALG2 loop — also the checkpointable solver state."""
    mu: torch.Tensor        # (3, Nt, Ny, Nx)  density + momenta
    q: torch.Tensor         # (3, Nt, Ny, Nx)  auxiliary (a, b1, b2)
    phi: torch.Tensor       # (Nt, Ny, Nx)     potential
    crit: torch.Tensor      # 0-d, -1 before the first iteration
    prev_crit: torch.Tensor
    iteration: int
    cg_iterations: int      # cumulative inner stepA iterations
    done: torch.Tensor      # 0-d bool


class FotoResult(NamedTuple):
    u: torch.Tensor        # (Ny, Nx) displacement x
    v: torch.Tensor        # (Ny, Nx) displacement y
    m: torch.Tensor        # (Ny, Nx) luminosity = -div(u, v)
    state: FotoState


def init_state(rho0: torch.Tensor, rhoT: torch.Tensor, Nt: int) -> FotoState:
    """Initial ALG2 state: density channel linearly interpolated in time
    between rho0 and rhoT, momenta and duals zero
    (reference benamou_brenier.py:191-194)."""
    dtype, device = rho0.dtype, rho0.device
    w = torch.arange(Nt, dtype=dtype, device=device)[:, None, None] / (Nt - 1)
    rho_init = (1.0 - w) * rho0[None] + w * rhoT[None]
    zero = torch.zeros_like(rho_init)
    mu = torch.stack([rho_init, zero, zero])
    minus_one = torch.full((), -1.0, dtype=dtype, device=device)
    return FotoState(
        mu=mu, q=torch.zeros_like(mu), phi=zero,
        crit=minus_one, prev_crit=minus_one.clone(),
        iteration=0, cg_iterations=0,
        done=torch.zeros((), dtype=torch.bool, device=device))


def _stepA(mu, q, rho0, rhoT, r, reg_epsilon, cg_rtol, cg_maxiter,
           ops=DEFAULT_OPS):
    """Solve A phi = div_st(mu - r q) + time-BC terms
    (reference benamou_brenier.py:26-91)."""
    dt = 1.0
    F = ops.div_st(mu - r * q, bc="N")
    rho, a = mu[0], q[0]
    g0 = rho0 - rho[0] + r * a[0]
    gN = rhoT - rho[-1] + r * a[-1]
    # F is a fresh tensor: add the boundary slices in place
    F[0] += -(1.0 / dt) * g0
    F[-1] += (1.0 / dt) * gN
    return ops.stepA_solve(F, r, reg_epsilon, cg_rtol, cg_maxiter)


def alg2_iteration(state: FotoState, rho0, rhoT, *, r, reg_epsilon,
                   convergence_tol, cg_rtol=1e-6, cg_maxiter=1000,
                   verbose=False, max_it=100, ops=DEFAULT_OPS,
                   admm_alpha=1.0) -> FotoState:
    """One full ALG2 iteration: stepA + stepB + stepC + criterion.

    ``admm_alpha``: ADMM over-relaxation — stepB/stepC act on
    ``alpha*grad_phi + (1-alpha)*q_prev`` instead of ``grad_phi``
    (alpha = 1.0 is the reference's exact iteration).  Must be a Python
    float."""
    mu, q_prev = state.mu, state.q

    phi, cg_iters = _stepA(mu, q_prev, rho0, rhoT, r, reg_epsilon,
                           cg_rtol, cg_maxiter, ops)

    grad_phi = ops.grad_st(phi, bc="N")
    fused = getattr(ops, "fused_pointwise", None)
    if fused is not None and admm_alpha == 1.0:
        q, mu, num, denom = fused(grad_phi, mu, r)
    elif fused is not None:
        # the pass builds alpha*grad_phi + (1-alpha)*q_prev itself and keeps
        # the criterion on the true grad_phi
        q, mu, num, denom = fused(grad_phi, mu, r, admm_alpha, q_prev)
    else:
        relaxed = (grad_phi if admm_alpha == 1.0 else
                   admm_alpha * grad_phi + (1.0 - admm_alpha) * q_prev)
        q = ops.project(relaxed + mu / r)
        mu = mu + r * (relaxed - q)
        mu[0].clamp_(min=0.0)        # density positivity; mu is fresh

        # Hamilton–Jacobi residual criterion
        # (reference benamou_brenier.py:246-251)
        res = grad_phi[0] + 0.5 * (grad_phi[1] ** 2 + grad_phi[2] ** 2)
        num = ops.sum(mu[0] * torch.abs(res))
        denom = ops.sum(mu[0] * (grad_phi[1] ** 2 + grad_phi[2] ** 2))
    crit = torch.sqrt(num / (denom + 1e-10))

    prev_crit = state.crit
    done = (crit <= convergence_tol) | (
        (prev_crit >= 0) & (torch.abs(prev_crit - crit) < 1e-5))
    done = done | torch.isnan(crit)

    if verbose:
        print(f"{crit.item()} ({state.iteration + 1}/{max_it})")

    return FotoState(mu=mu, q=q, phi=phi, crit=crit, prev_crit=prev_crit,
                     iteration=state.iteration + 1,
                     cg_iterations=state.cg_iterations + cg_iters,
                     done=done)


def scale_invariant_r(rho0, rhoT, r=1.0, ops=DEFAULT_OPS):
    """ADMM penalty matched to the data scale: ``r * max(rho)`` (0-d).

    ALG2 is invariant under ``(mu, rho, r) -> (c*mu, c*rho, c*r)``, so the
    ratio r/peak-density governs convergence, not r itself; see the JAX
    twin's docstring for the derivation."""
    return r * torch.maximum(ops.max(rho0), ops.max(rhoT))


def alg2_loop(rho0, rhoT, Nt, *, r=1.0, convergence_tol=0.3,
              reg_epsilon=1e-3, max_it=100, cg_rtol=1e-6,
              cg_maxiter=1000, verbose=False, ops=DEFAULT_OPS,
              admm_alpha=1.0, auto_r=False,
              init: FotoState | None = None) -> FotoState:
    """Run ALG2 until done or ``max_it``; ``init`` resumes a saved state."""
    if auto_r:
        r = float(scale_invariant_r(rho0, rhoT, r, ops=ops))
    state = init_state(rho0, rhoT, Nt) if init is None else init
    while state.iteration < max_it and not bool(state.done):
        state = alg2_iteration(
            state, rho0, rhoT, r=r, reg_epsilon=reg_epsilon,
            convergence_tol=convergence_tol, cg_rtol=cg_rtol,
            cg_maxiter=cg_maxiter, verbose=verbose, max_it=max_it, ops=ops,
            admm_alpha=admm_alpha)
    return state


solve_potential = alg2_loop


def solve_potential_with_history(rho0, rhoT, Nt, iterations, *, r=1.0,
                                 reg_epsilon=1e-3, cg_rtol=1e-6,
                                 cg_maxiter=1000, ops=DEFAULT_OPS,
                                 admm_alpha=1.0):
    """Exactly ``iterations`` ALG2 iterations (no stopping rule), returning
    ``(final_state, {"crit": (iterations,), "cg": (iterations,)})`` — the
    convergence trajectory, with crit kept on the device until the end."""
    state = init_state(rho0, rhoT, Nt)
    crits, cgs = [], []
    for _ in range(iterations):
        state = alg2_iteration(state, rho0, rhoT, r=r,
                               reg_epsilon=reg_epsilon, convergence_tol=0.0,
                               cg_rtol=cg_rtol, cg_maxiter=cg_maxiter,
                               ops=ops, admm_alpha=admm_alpha)
        crits.append(state.crit)
        cgs.append(state.cg_iterations)
    return state, {"crit": torch.stack(crits),
                   "cg": torch.tensor(cgs, dtype=torch.int32)}


def kinetic_action(mu: torch.Tensor, rho_floor: float = 1e-12):
    """Discrete Benamou–Brenier kinetic action: the time-trapezoid sum of
    ``|m|^2 / rho`` over the grid; cells with ``rho <= rho_floor`` give 0."""
    rho, m1, m2 = mu[0], mu[1], mu[2]
    speed2 = m1 * m1 + m2 * m2
    safe = torch.clamp(rho, min=rho_floor)
    dens = torch.where(rho > rho_floor, speed2 / safe, 0.0)
    Nt = mu.shape[-3]
    w = torch.ones(Nt, dtype=dens.dtype, device=dens.device)
    w[0] = w[-1] = 0.5
    return torch.sum(w[:, None, None] * dens)


def wasserstein2(state: FotoState):
    """W2(rho0, rhoT) between the normalized densities, in pixels:
    ``sqrt((Nt - 1) * kinetic_action / per-slice mass)``."""
    Nt = state.mu.shape[-3]
    total_mass = torch.sum(state.mu[0]) / Nt
    return torch.sqrt((Nt - 1.0) * kinetic_action(state.mu) / total_mass)


def solve(rho0, rhoT, Nt, *, r=1.0, convergence_tol=0.3, reg_epsilon=1e-3,
          max_it=100, cg_rtol=1e-6, cg_maxiter=1000, verbose=False,
          ops=DEFAULT_OPS, admm_alpha=1.0, auto_r=False,
          init: FotoState | None = None) -> FotoResult:
    """Full FOTO solve: ALG2 on the potential, then flow extraction
    (trajectory integration + luminosity), the reference's
    ``benamou_brenier.solve`` -> (u, v, m) contract."""
    state = solve_potential(
        rho0, rhoT, Nt, r=r, convergence_tol=convergence_tol,
        reg_epsilon=reg_epsilon, max_it=max_it, cg_rtol=cg_rtol,
        cg_maxiter=cg_maxiter, verbose=verbose, ops=ops,
        admm_alpha=admm_alpha, auto_r=auto_r, init=init)
    u, v, m = flow_extract.flow_from_potential(state.phi)
    return FotoResult(u=u, v=v, m=m, state=state)
