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
  * ``dct-refined``: spectral stepA whose transforms run in TF32 on cuda,
    plus three steps of float32 iterative refinement, unfused rest;
  * ``pallas``: spectral stepA plus the fused stepB + stepC + criterion
    pass, which on CUDA tensors is the hand-written kernel
    (``ops/kernels/fused_pointwise.py``).  The name is the JAX flag value,
    kept so that run scripts work unchanged;
  * ``dct-fused``: spectral stepA whose per-slice body is the hand-written
    kernel of ``ops/kernels/dct_solve.py``, unfused rest;
  * ``cg-pallas``: CG stepA whose operator is the hand-written stencil
    kernel of ``ops/kernels/cg_operator.py``, unfused rest.

On CPU tensors every kernel wrapper runs its plain torch version.

Lockstep batches (JAX's ``vmap`` mode): :func:`solve_potential_batched`
runs B pairs of (B, Ny, Nx) frames as one ALG2 loop on (B, 3, Nt, Ny, Nx)
state, each pair stopping on its own rule (``solvers/lockstep.py``).  The
iteration code is the single-pair code: ``lockstep_ops`` gives every ops
set a form whose component axis is 1 (``cax``), whose ``sum`` and ``max``
reduce per pair, whose CG is the masked batched CG and whose fused pass
and kernels take the whole batch in one launch; ``auto_r`` gives each pair
its own ``r`` (a ``lockstep.PerPair``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ofot_tpu_torch.ops import operators
from ofot_tpu_torch.ops.kernels import projection as projection_kernel
from ofot_tpu_torch.ops.kernels.cg_operator import cg_operator_blocked
from ofot_tpu_torch.ops.kernels.dct_solve import dct_solve
from ofot_tpu_torch.ops.kernels.fused_pointwise import (
    fused_pointwise, fused_pointwise_batched)
from ofot_tpu_torch.ops.projection import (project_paraboloid,
                                           project_paraboloid_nd)
from ofot_tpu_torch.solvers import cg as cg_mod
from ofot_tpu_torch.solvers import dct, flow_extract, lockstep
from ofot_tpu_torch.solvers.lockstep import PerPair, kernel_r


class _DefaultOps:
    """Space-time operator set: plain torch stencils, CG stepA."""
    cax = 0    # the component axis of mu, q and grad_phi
    cg_solve = staticmethod(cg_mod.cg)
    grad_st = staticmethod(operators.grad_st)
    div_st = staticmethod(operators.div_st)
    laplacian_st = staticmethod(operators.laplacian_st)
    sum = staticmethod(torch.sum)
    max = staticmethod(torch.max)
    project = staticmethod(project_paraboloid)
    # k-beta-component projection for the source-extended (WFR) stepB
    project_nd = staticmethod(project_paraboloid_nd)

    def cg_operator(self, r, reg_epsilon):
        """The stepA system operator A = -r*L_st + r*eps*I as a callable."""
        return lambda phi: (-r * self.laplacian_st(phi, bc="N")
                            + (r * reg_epsilon) * phi)

    def stepA_solve(self, F, r, reg_epsilon, cg_rtol, cg_maxiter):
        """Solve A phi = F; returns (phi, inner_iterations).  Default:
        matrix-free CG with the reference's scipy-cg semantics."""
        res = self.cg_solve(self.cg_operator(r, reg_epsilon), F,
                            rtol=cg_rtol, maxiter=cg_maxiter,
                            dot=lambda a, b: self.sum(a * b))
        return res.x, res.iterations


class DCTOps(_DefaultOps):
    """Spectral stepA: six full-float32 matrix products and a pointwise
    divide instead of hundreds of CG iterations.  Each instance keeps the
    transform matrices and spectrum of the systems it has solved, so one
    solve builds them once."""

    def __init__(self):
        self._plans = {}

    def _plan(self, F, r, reg_epsilon):
        # a per-pair r keys on its values: one plan per solve, not per
        # iteration
        r = r if isinstance(r, PerPair) else float(r)
        key = (tuple(F.shape), F.dtype, F.device,
               r.values if isinstance(r, PerPair) else r,
               float(reg_epsilon))
        plan = self._plans.get(key)
        if plan is None:
            plan = self._plans[key] = dct.StepAPlan(
                F.shape, r, float(reg_epsilon), F.dtype, F.device)
        return plan

    def stepA_solve(self, F, r, reg_epsilon, cg_rtol, cg_maxiter):
        return self._plan(F, r, reg_epsilon).solve(F), 1


class DCTRefinedOps(DCTOps):
    """Spectral stepA with low-precision transforms (TF32 on cuda) plus
    ``refine`` steps of full-precision iterative refinement
    (``dct.StepAPlan.solve_refined``); each step is one stencil residual
    and one more low-precision solve, so a stepA counts ``1 + refine``
    inner iterations."""

    def __init__(self, refine: int = 3):
        super().__init__()
        self.refine = int(refine)

    def stepA_solve(self, F, r, reg_epsilon, cg_rtol, cg_maxiter):
        phi = self._plan(F, r, reg_epsilon).solve_refined(F, self.refine)
        return phi, 1 + self.refine


class DCTFusedOps(DCTOps):
    """Spectral stepA whose per-slice body (y/x transforms, divide, inverse
    transforms) is the hand-written kernel of ``ops/kernels/dct_solve.py``
    (one launch per solve on CUDA tensors); the t-axis products stay
    ``torch.matmul``.  The kernel module keeps the matrices of each system
    it has solved."""

    def stepA_solve(self, F, r, reg_epsilon, cg_rtol, cg_maxiter):
        return dct_solve(F, kernel_r(r), reg_epsilon), 1


class PallasOps(DCTOps):
    """Spectral stepA plus the fused stepB + stepC + criterion pass (one
    kernel launch per ALG2 iteration on CUDA tensors).  ``project`` and
    ``project_nd`` are the standalone projection kernel, which reads the
    component count from the array; no ALG2 path calls them, since the
    fused pass does the projection."""
    fused_pointwise = staticmethod(fused_pointwise)
    project = staticmethod(projection_kernel.project_paraboloid)
    project_nd = project


class PallasCGOps(_DefaultOps):
    """Reference-faithful CG stepA whose operator is the hand-written
    stencil kernel of ``ops/kernels/cg_operator.py`` (one launch per CG
    step on CUDA tensors).  Same CG semantics as the ``cg`` set."""

    def cg_operator(self, r, reg_epsilon):
        r = kernel_r(r)
        return lambda phi: cg_operator_blocked(phi, r, reg_epsilon)


DEFAULT_OPS = _DefaultOps()


def _per_pair_sum(x):
    return torch.sum(x.flatten(1), dim=1)


def _per_pair_max(x):
    return torch.amax(x.flatten(1), dim=1)


class _Lockstep:
    """Mixin giving an ops set its lockstep-batch form: fields carry the
    pair axis first and the component axis second ((B, 3, Nt, Ny, Nx)),
    ``sum`` and ``max`` reduce per pair to (B,), stepA's CG is the masked
    batched CG, and the stencils, spectral solves and kernels act on the
    whole batch (the kernel wrappers take (B, ...) fields)."""
    cax = 1
    cg_solve = staticmethod(cg_mod.cg_batched)
    sum = staticmethod(_per_pair_sum)
    max = staticmethod(_per_pair_max)

    @staticmethod
    def grad_st(phi, bc="N"):
        return operators.grad_st(phi, bc=bc, dim=1)

    @staticmethod
    def div_st(mu, bc="N"):
        return operators.div_st(mu, bc=bc, dim=1)

    def project(self, p):
        return super().project(p.transpose(0, 1)).transpose(0, 1)

    def project_nd(self, p):
        return super().project_nd(p.transpose(0, 1)).transpose(0, 1)


def _fused_batched(grad_phi, mu, r, alpha=None, q_prev=None):
    return fused_pointwise_batched(grad_phi, mu, kernel_r(r), alpha, q_prev)


@functools.cache
def _lockstep_class(cls):
    attrs = {}
    if hasattr(cls, "fused_pointwise"):
        attrs["fused_pointwise"] = staticmethod(_fused_batched)
    return type(f"Lockstep{cls.__name__}", (_Lockstep, cls), attrs)


def lockstep_ops(ops):
    """The lockstep-batch form of the ops set ``ops`` (its own state, such
    as ``DCTRefinedOps.refine``, carried over; ``ops`` itself if it is one
    already)."""
    if isinstance(ops, _Lockstep):
        return ops
    batched = object.__new__(_lockstep_class(type(ops)))
    batched.__dict__.update(vars(ops))
    if hasattr(batched, "_plans"):
        batched._plans = {}
    return batched

_OPS = {"cg": _DefaultOps, "dct": DCTOps, "dct-refined": DCTRefinedOps,
        "pallas": PallasOps, "dct-fused": DCTFusedOps,
        "cg-pallas": PallasCGOps}


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
    name)."""
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
    (reference benamou_brenier.py:191-194).

    (B, Ny, Nx) frames give a lockstep batch's state: fields (B, ...) with
    the components on axis 1, and (B,) criteria, counters and flags."""
    dtype, device = rho0.dtype, rho0.device
    pairs = rho0.shape[:-2]
    w = torch.arange(Nt, dtype=dtype, device=device)[:, None, None] / (Nt - 1)
    rho_init = (1.0 - w) * rho0.unsqueeze(-3) + w * rhoT.unsqueeze(-3)
    zero = torch.zeros_like(rho_init)
    mu = torch.stack([rho_init, zero, zero], dim=len(pairs))
    minus_one = torch.full(pairs, -1.0, dtype=dtype, device=device)
    count = (torch.zeros(pairs, dtype=torch.int64, device=device)
             if pairs else 0)
    return FotoState(
        mu=mu, q=torch.zeros_like(mu), phi=zero,
        crit=minus_one, prev_crit=minus_one.clone(),
        iteration=count, cg_iterations=count,
        done=torch.zeros(pairs, dtype=torch.bool, device=device))


def _stepA(mu, q, rho0, rhoT, r, reg_epsilon, cg_rtol, cg_maxiter,
           ops=DEFAULT_OPS):
    """Solve A phi = div_st(mu - r q) + time-BC terms
    (reference benamou_brenier.py:26-91)."""
    dt = 1.0
    F = ops.div_st(mu - r * q, bc="N")
    rho, a = mu.select(ops.cax, 0), q.select(ops.cax, 0)
    _add_time_boundary(F, rho, a, rho0, rhoT, r, dt)
    return ops.stepA_solve(F, r, reg_epsilon, cg_rtol, cg_maxiter)


def _add_time_boundary(F, rho, a, rho0, rhoT, r, dt):
    """Add the non-homogeneous Neumann time-boundary terms that inject
    rho0 / rhoT into F's first and last time planes, in place (F is a
    fresh tensor); the t axis is -3, also in a batch."""
    g0 = rho0 - rho.select(-3, 0) + r * a.select(-3, 0)
    gN = rhoT - rho.select(-3, -1) + r * a.select(-3, -1)
    F.select(-3, 0).add_(-(1.0 / dt) * g0)
    F.select(-3, -1).add_((1.0 / dt) * gN)


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
        # density positivity; mu is fresh
        mu.select(ops.cax, 0).clamp_(min=0.0)

        # Hamilton–Jacobi residual criterion
        # (reference benamou_brenier.py:246-251)
        g0, g1, g2 = (grad_phi.select(ops.cax, i) for i in range(3))
        rho = mu.select(ops.cax, 0)
        res = g0 + 0.5 * (g1 ** 2 + g2 ** 2)
        num = ops.sum(rho * torch.abs(res))
        denom = ops.sum(rho * (g1 ** 2 + g2 ** 2))
    crit = torch.sqrt(num / (denom + 1e-10))

    prev_crit = state.crit
    done = (crit <= convergence_tol) | (
        (prev_crit >= 0) & (torch.abs(prev_crit - crit) < 1e-5))
    done = done | torch.isnan(crit)

    if verbose:
        print(f"{_shown(crit)} ({_shown(state.iteration + 1)}/{max_it})")

    return FotoState(mu=mu, q=q, phi=phi, crit=crit, prev_crit=prev_crit,
                     iteration=state.iteration + 1,
                     cg_iterations=state.cg_iterations + cg_iters,
                     done=done)


def _shown(x):
    """A criterion or count as the verbose line prints it (a list for a
    batch)."""
    return x.tolist() if isinstance(x, torch.Tensor) else x


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


def lockstep_r(rho0, rhoT, r, ops, auto_r):
    """The penalty of a lockstep batch: ``r`` itself, or with ``auto_r``
    each pair's own ``scale_invariant_r`` as a ``PerPair`` (its float, as a
    single pair's solve takes it)."""
    if not auto_r:
        return r
    return PerPair(scale_invariant_r(rho0, rhoT, r, ops=ops).tolist(), rho0)


def alg2_loop_batched(rho0, rhoT, Nt, *, r=1.0, convergence_tol=0.3,
                      reg_epsilon=1e-3, max_it=100, cg_rtol=1e-6,
                      cg_maxiter=1000, verbose=False, ops=DEFAULT_OPS,
                      admm_alpha=1.0, auto_r=False,
                      init: FotoState | None = None) -> FotoState:
    """ALG2 on a lockstep batch: ``rho0``/``rhoT`` are (B, Ny, Nx), every
    pair runs the iteration of :func:`alg2_loop` in one loop, and each
    stops on its own rule (its fields, criteria and counters then stay as
    they were).  Returns a FotoState with a leading batch axis and (B,)
    counters, as JAX's ``vmap`` of ``solve_potential`` does."""
    ops = lockstep_ops(ops)
    r = lockstep_r(rho0, rhoT, r, ops, auto_r)
    state = init_state(rho0, rhoT, Nt) if init is None else init
    return lockstep.run(state, lambda s: alg2_iteration(
        s, rho0, rhoT, r=r, reg_epsilon=reg_epsilon,
        convergence_tol=convergence_tol, cg_rtol=cg_rtol,
        cg_maxiter=cg_maxiter, verbose=verbose, max_it=max_it, ops=ops,
        admm_alpha=admm_alpha), max_it)


solve_potential_batched = alg2_loop_batched


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
