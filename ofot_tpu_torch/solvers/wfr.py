"""Unbalanced dynamic optimal transport — Wasserstein–Fisher–Rao (WFR), in
torch.

Counterpart of ``ofot_tpu.solvers.wfr``.  WFR extends the Benamou–Brenier
problem that ``foto`` solves with a source term, so mass can be created or
destroyed at a cost (illumination change):

    min_{rho, m, zeta}  integral ( |m|^2 + delta^2 * zeta^2 ) / (2 rho)
    s.t.  dt rho + div m = zeta,   rho(0) = rho0,  rho(1) = rhoT.

``delta`` is the transport/growth trade-off length.  ALG2 carries over with
the FOTO machinery (Chizat, Peyré, Schmitzer, Vialard):

  * the extended "gradient" is ``G phi = (grad_st phi, +phi/delta)`` and
    ``G^T G = -L_st + I/delta^2``, so stepA is the balanced stepA operator
    with reg_epsilon shifted by ``1/delta^2``: every FOTO ops set solves it
    (``foto.stepA_ops``);
  * stepB projects (a, b1, b2, c) onto the same paraboloid with a
    3-component beta (``ops.project_nd``, or the fused pass at 4
    components);
  * stepC and the Hamilton–Jacobi criterion extend with the c-component.

These are the source term of FOTO's own iteration body
(``foto._iteration`` with ``delta``), which this module's
:func:`alg2_iteration` runs; stepA's right-hand side is the set's plain
one with the source, never the S2 kernel.

State: ``foto.FotoState`` with mu, q of shape (4, Nt, Ny, Nx) — components
(rho, m1, m2, sigma) where sigma = delta * zeta is the scaled source; the
.npz checkpoint layout is unchanged.  The loop is FOTO's
(``foto.run_loop``, which calls this module's :func:`alg2_iteration`): on
the device loop on cuda for the sets whose stepA has no inner loop, the
k=3 fused pass and ``delta`` baked into the captured graph, else on the
host with one ``done`` read per iteration.  :func:`solve_potential_batched`
runs a lockstep batch of pairs, as ``foto.solve_potential_batched`` does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ofot_tpu_torch.solvers import flow_extract, foto
from ofot_tpu_torch.solvers.flow_extract import flow_from_potential  # noqa: F401
from ofot_tpu_torch.utils import trace


class WfrResult(NamedTuple):
    u: torch.Tensor        # (Ny, Nx) displacement x
    v: torch.Tensor        # (Ny, Nx) displacement y
    m: torch.Tensor        # (Ny, Nx) luminosity = -div(u, v) (reference
    #                        convention, comparable with foto.solve)
    growth: torch.Tensor   # (Ny, Nx) integrated relative source along the
    #                        time axis: multiplicative brightness change - 1
    source: torch.Tensor   # (Nt, Ny, Nx) zeta = sigma / delta
    state: foto.FotoState
    m_combined: torch.Tensor  # (Ny, Nx) luminosity with the growth
    #                        composed into the -div dilution correction,
    #                        1 + m_combined = (1 + growth)(1 + m): the
    #                        field the CLI ships in the ``m`` slot


def resolve_stepA_solver(solver: str, device) -> str:
    """Resolve the user-facing stepA solver name for a device.

    ``auto``: ``pallas`` on CUDA (spectral stepA plus the fused CUDA pass
    at 4 components, as the port's FOTO resolves), ``dct`` on the CPU (the
    JAX package's choice on every platform: WFR has no reference twin to
    stay CG-faithful to, and the spectral solve is exact)."""
    if solver == "auto":
        return "pallas" if torch.device(device).type == "cuda" else "dct"
    return solver


def init_state(rho0, rhoT, Nt: int) -> foto.FotoState:
    """Balanced init extended with a zero source channel."""
    st = foto.init_state(rho0, rhoT, Nt)
    cax = rho0.dim() - 2        # 1 for a (B, Ny, Nx) batch
    # as the JAX package: NaN density stays NaN
    zero = st.mu.narrow(cax, 0, 1) * 0.0
    return st._replace(mu=torch.cat([st.mu, zero], dim=cax),
                       q=torch.cat([st.q, zero], dim=cax))


def G_st(phi, delta, ops=foto.DEFAULT_OPS):
    """(grad_st phi, +phi/delta): the unbalanced space-time 'gradient'.

    The + sign of the source component is the one for which stationarity
    of <mu, G phi> in phi reproduces ``dt rho + div m = +zeta``."""
    return foto._grad(phi, ops, delta)


def _ops(ops):
    """``ops``, or the JAX package's default: a fresh ``dct`` set."""
    return foto.stepA_ops("dct") if ops is None else ops


def alg2_iteration(state: foto.FotoState, rho0, rhoT, *, r, delta,
                   reg_epsilon, convergence_tol, cg_rtol=1e-6,
                   cg_maxiter=1000, verbose=False, max_it=100,
                   ops=None, admm_alpha=1.0,
                   loop="auto") -> foto.FotoState:
    """One unbalanced ALG2 iteration: FOTO's with the source term (stepA
    on ``-G^T`` with ``reg_epsilon + 1/delta^2``, since G^T G = -L_st +
    I/delta^2; the 4-component stepB/stepC; the extended Hamilton–Jacobi
    criterion).  ``ops`` defaults to a fresh ``dct`` set, the JAX
    package's default.

    ``admm_alpha``: ADMM over-relaxation, as in
    :func:`foto.alg2_iteration` — stepB/stepC act on
    ``alpha*G(phi) + (1-alpha)*q_prev``.  Must be a Python float.
    ``loop``: how a CG stepA runs its loop."""
    return foto._iteration(
        state, rho0, rhoT, delta, r=r, reg_epsilon=reg_epsilon,
        convergence_tol=convergence_tol, cg_rtol=cg_rtol,
        cg_maxiter=cg_maxiter, verbose=verbose, max_it=max_it,
        ops=_ops(ops), admm_alpha=admm_alpha, loop=loop)


def alg2_loop(rho0, rhoT, Nt, *, delta=10.0, r=1.0, convergence_tol=0.3,
              reg_epsilon=1e-3, max_it=100, cg_rtol=1e-6, cg_maxiter=1000,
              verbose=False, ops=None, admm_alpha=1.0, auto_r=False,
              init: foto.FotoState | None = None,
              loop: str = "auto") -> foto.FotoState:
    """Run unbalanced ALG2 until done or ``max_it``; ``init`` resumes a
    saved state.  ``ops`` defaults to a fresh ``dct`` set.  ``auto_r``
    rescales the ADMM penalty to the data scale (the WFR action and every
    ALG2 update are jointly 1-homogeneous in (rho, m, zeta, r), as in the
    balanced case; see :func:`foto.scale_invariant_r`).  ``loop`` as in
    :func:`foto.alg2_loop`."""
    return foto.run_loop(
        "wfr", alg2_iteration, init_state, rho0, rhoT, Nt, init,
        batched=False, ops=_ops(ops), r=r, auto_r=auto_r, max_it=max_it,
        verbose=verbose, loop=loop, delta=delta, reg_epsilon=reg_epsilon,
        convergence_tol=convergence_tol, cg_rtol=cg_rtol,
        cg_maxiter=cg_maxiter, admm_alpha=admm_alpha)


solve_potential = alg2_loop


def alg2_loop_batched(rho0, rhoT, Nt, *, delta=10.0, r=1.0,
                      convergence_tol=0.3, reg_epsilon=1e-3, max_it=100,
                      cg_rtol=1e-6, cg_maxiter=1000, verbose=False, ops=None,
                      admm_alpha=1.0, auto_r=False,
                      init: foto.FotoState | None = None,
                      loop: str = "auto") -> foto.FotoState:
    """Unbalanced ALG2 on a lockstep batch of (B, Ny, Nx) frames, each
    pair stopping on its own rule, as ``foto.alg2_loop_batched`` runs the
    balanced one.  ``ops`` defaults to a fresh ``dct`` set."""
    return foto.run_loop(
        "wfr", alg2_iteration, init_state, rho0, rhoT, Nt, init,
        batched=True, ops=_ops(ops), r=r, auto_r=auto_r, max_it=max_it,
        verbose=verbose, loop=loop, delta=delta, reg_epsilon=reg_epsilon,
        convergence_tol=convergence_tol, cg_rtol=cg_rtol,
        cg_maxiter=cg_maxiter, admm_alpha=admm_alpha)


solve_potential_batched = alg2_loop_batched


def solve(rho0, rhoT, Nt, *, delta=10.0, r=1.0, convergence_tol=0.3,
          reg_epsilon=1e-3, max_it=100, cg_rtol=1e-6, cg_maxiter=1000,
          verbose=False, ops=None, admm_alpha=1.0, auto_r=False,
          init: foto.FotoState | None = None,
          loop: str = "auto") -> WfrResult:
    """Full unbalanced solve: potential -> (u, v, m) displacement flow plus
    the source/growth fields balanced OT cannot represent.  Span
    ``wfr.solve`` around ``alg2.loop`` and ``wfr.extract`` (the flow,
    growth, source and ``m_combined``)."""
    with trace.annotate("wfr.solve"):
        state = solve_potential(rho0, rhoT, Nt, delta=delta, r=r,
                                convergence_tol=convergence_tol,
                                reg_epsilon=reg_epsilon, max_it=max_it,
                                cg_rtol=cg_rtol, cg_maxiter=cg_maxiter,
                                verbose=verbose, ops=ops,
                                admm_alpha=admm_alpha, auto_r=auto_r,
                                init=init, loop=loop)
        with trace.annotate("wfr.extract"):
            u, v, m, growth, source = _postprocess(state, delta)
            m_combined = combined_luminosity(m, growth)
        return WfrResult(u=u, v=v, m=m, growth=growth, source=source,
                         state=state, m_combined=m_combined)


def _postprocess(state: foto.FotoState, delta):
    """Flow extraction plus the growth and source fields."""
    u, v, m = flow_extract.flow_from_potential(state.phi)
    growth = growth_from_state(state, delta)
    return u, v, m, growth, state.mu[3] / delta


def combined_luminosity(m_div: torch.Tensor,
                        growth: torch.Tensor) -> torch.Tensor:
    """The WFR luminosity field: the advective dilution correction
    ``1 + m_div`` (m_div = -div(u, v)) composed with the source growth
    multiplier ``1 + g``:  ``1 + m = (1 + g) * (1 + m_div)``."""
    return (1.0 + growth) * (1.0 + m_div) - 1.0


def growth_from_state(state: foto.FotoState, delta) -> torch.Tensor:
    """(Ny, Nx) integrated multiplicative brightness change - 1.

    Relative growth rate g = zeta / rho; the brightness multiplier over the
    horizon is exp(integral g dt) (trapezoid).  A relative floor
    (1e-6 * max rho) zeroes vacuum cells, where zeta/rho is noise."""
    zeta = state.mu[3] / delta
    rho = state.mu[0]
    floor = 1e-6 * torch.max(rho)
    rate = torch.where(rho > floor, zeta / torch.maximum(rho, floor), 0.0)
    w = torch.ones(state.mu.shape[-3], dtype=rho.dtype, device=rho.device)
    w[0] = w[-1] = 0.5
    return torch.exp(torch.tensordot(w, rate, dims=1)) - 1.0


def total_created_mass(state: foto.FotoState, delta: float) -> torch.Tensor:
    """Space-time integral of the source zeta: the net mass the solution
    creates (positive) or destroys (negative)."""
    return torch.sum(state.mu[3]) / delta


def kinetic_action(mu: torch.Tensor, rho_floor: float = 1e-12):
    """Unbalanced kinetic action: time-trapezoid sum of
    ``(|m|^2 + sigma^2) / rho``; cells with ``rho <= rho_floor`` give 0."""
    rho = mu[0]
    speed2 = mu[1] ** 2 + mu[2] ** 2 + mu[3] ** 2
    safe = torch.clamp(rho, min=rho_floor)
    dens = torch.where(rho > rho_floor, speed2 / safe, 0.0)
    Nt = mu.shape[-3]
    w = torch.ones(Nt, dtype=dens.dtype, device=dens.device)
    w[0] = w[-1] = 0.5
    return torch.sum(w[:, None, None] * dens)


def wfr_distance(state: foto.FotoState):
    """WFR(rho0, rhoT) in pixel units from the state's action: the
    unbalanced analogue of ``foto.wasserstein2``."""
    Nt = state.mu.shape[-3]
    total_mass = torch.sum(state.mu[0]) / Nt
    return torch.sqrt((Nt - 1.0) * kinetic_action(state.mu) / total_mass)
