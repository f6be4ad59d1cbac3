"""Plain reference of WFR: the dynamic Wasserstein–Fisher–Rao problem
(unbalanced optimal transport with a source term) by ALG2 (ADMM), its
stopping rule, the flow extraction, the growth and the luminosity the
sweep ships.

Written from the equations of Chizat, Peyré, Schmitzer and Vialard, "An
interpolating distance between optimal transport and Fisher–Rao metrics"
(Found. Comput. Math. 18, 2018) and "Unbalanced optimal transport: dynamic
and Kantorovich formulations" (J. Funct. Anal. 274, 2018):

    min  integral (|m|^2 + delta^2 zeta^2) / (2 rho)
    s.t. dt rho + div m = zeta,  rho(0) = rho0,  rho(1) = rhoT,

in plain torch and by default in float64; it imports nothing of the
program, and of ``flowbench/reference/foto.py`` only the stencils, the
exact spectral solve, the stopping rule and the flow extraction.  The
state is (rho, m1, m2, sigma) with sigma = delta zeta; the dual
constraint is ``dt phi + (|grad phi|^2 + phi^2 / delta^2) / 2 <= 0``, so
with ``G phi = (grad_st phi, phi / delta)``:

* stepA solves ``r (G^T G + eps I) phi = -G^T (mu - r q)`` plus the
  Neumann time-boundary terms that inject rho0 and rhoT; ``G^T G =
  -L + I / delta^2`` and ``-G^T x = div(x[:3]) - x[3] / delta``, so it is
  FOTO's spectral solve with eps + 1 / delta^2;
* stepB projects ``x + mu / r`` pointwise onto the paraboloid ``a + (b1^2
  + b2^2 + b3^2) / 2 <= 0`` (three components of b), with ``x = alpha G
  phi + (1 - alpha) q``;
* stepC is ``mu += r (x - q)``, the density clamped at 0;
* the criterion is ``sqrt(sum rho |g_t + s / 2| / (sum rho s + 1e-10))``
  with ``s = g_x^2 + g_y^2 + (phi / delta)^2`` on the true G phi, and the
  rule FOTO's (at most ``tol``, within 1e-5 of the previous, NaN, or
  ``max_it``);
* the flow is FOTO's extraction from phi; the growth is ``exp(trapezoid
  integral of zeta / rho dt) - 1`` where rho exceeds 1e-6 max rho (0
  elsewhere); the luminosity is ``(1 + growth)(1 + m) - 1`` with m =
  -div(u, v).

Departures from the published description, each the sweep's own: a
collocated (Nt, Ny, Nx) grid with dt = dx = dy = 1 and the reference
code's central differences with one-sided boundary rows (not a staggered
grid on [0, 1]; delta is in pixels); stepA regularised by ``eps I``;
over-relaxed ADMM (alpha 1.7, not 1); the stopping rule on the
Hamilton–Jacobi residual above, with its stall test; and the growth and
composed luminosity, which the papers do not define: they are what the
sweep writes into the luminosity slot.

``tf32=True`` runs the products in TF32 on the card (with float32 data,
the control one precision step below the configuration's); otherwise
both TF32 flags are off for the whole run.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from flowbench.reference.foto import (Spectral, d_weird, flow, grad_st,
                                      stopped)


def project_paraboloid(a, b):
    """Euclidean projection of (a, b) onto ``a + |b|^2 / 2 <= 0``, ``b``
    of any number of components on its first axis.

    Outside, the nearest point is (a - (s - 1), b / s) with s >= 1 the root
    of ``s^3 - (a + 1) s^2 - |b|^2 / 2 = 0``: closed form by Cardano or the
    trigonometric method, then three Newton steps on the cubic, increasing
    and convex on s >= 1."""
    rho2 = torch.sum(b * b, dim=0)
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
    b_out = torch.where(outside, b / s, b)
    return torch.cat([a_out[None], b_out])


def G(phi, delta):
    """(d/dt, d/dx, d/dy, 1/delta) of phi."""
    return torch.cat([grad_st(phi), (phi / delta)[None]])


class State(NamedTuple):
    """After an iteration: ``mu`` and ``q`` (4, Nt, Ny, Nx), the potential
    ``phi`` and the criterion ``crit``."""
    mu: torch.Tensor
    q: torch.Tensor
    phi: torch.Tensor
    crit: float


def init(rho0, rhoT, Nt) -> State:
    """The density interpolated in time, momenta, source and duals zero,
    the potential 0 and no criterion yet (-1)."""
    Ny, Nx = rho0.shape
    w = torch.arange(Nt, dtype=rho0.dtype, device=rho0.device)[
        :, None, None] / (Nt - 1)
    mu = torch.zeros((4, Nt, Ny, Nx), dtype=rho0.dtype, device=rho0.device)
    mu[0] = (1.0 - w) * rho0 + w * rhoT
    return State(mu, torch.zeros_like(mu), torch.zeros_like(mu[0]), -1.0)


def iterate(st: State, rho0, rhoT, solver: Spectral, *, r, delta,
            admm_alpha) -> State:
    """One ALG2 iteration; ``solver`` solves ``(-r L + r (eps + 1 /
    delta^2) I) phi = F``."""
    mu, q = st.mu, st.q
    x = mu - r * q
    F = (d_weird(x[0], -3) + d_weird(x[1], -1) + d_weird(x[2], -2)
         - x[3] / delta)
    F[0] -= rho0 - mu[0, 0] + r * q[0, 0]
    F[-1] += rhoT - mu[0, -1] + r * q[0, -1]
    phi = solver.solve(F)
    g = G(phi, delta)
    x = admm_alpha * g + (1.0 - admm_alpha) * q
    p = x + mu / r
    q = project_paraboloid(p[0], p[1:])
    mu = mu + r * (x - q)
    mu[0].clamp_(min=0.0)
    speed2 = g[1] ** 2 + g[2] ** 2 + g[3] ** 2
    num = torch.sum(mu[0] * torch.abs(g[0] + 0.5 * speed2))
    den = torch.sum(mu[0] * speed2)
    return State(mu, q, phi, float(torch.sqrt(num / (den + 1e-10))))


class Alg2Run(NamedTuple):
    """What :func:`alg2` ran: ``stop`` the iterations at its stopping rule,
    ``at_stop`` the state there, ``at_read`` the state after exactly
    ``read_at`` iterations (None if not asked), ``crits`` the criterion
    after each iteration run (``crits[j - 1]`` after j)."""
    stop: int
    at_stop: State
    at_read: State | None
    crits: list


class _Tf32:
    """Both TF32 flags set to ``on`` inside the block, restored after."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.was = (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.on
        torch.backends.cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.was
        return False


def alg2(rho0, rhoT, Nt, *, r, delta, reg_epsilon, convergence_tol, max_it,
         admm_alpha, read_at=None, tf32=False) -> Alg2Run:
    """ALG2 from the interpolated density until its stop, and on to
    ``read_at`` iterations (0 included) if that lies beyond it."""
    with _Tf32(tf32):
        solver = Spectral((Nt, *rho0.shape), r,
                          reg_epsilon + 1.0 / (delta * delta), rho0.dtype,
                          rho0.device, tf32)
        st = init(rho0, rhoT, Nt)
        crits, stop, at_stop = [], None, None
        at_read = st if read_at == 0 else None
        last = max_it if read_at is None else max(max_it, read_at)
        for it in range(1, last + 1):
            st = iterate(st, rho0, rhoT, solver, r=r, delta=delta,
                         admm_alpha=admm_alpha)
            crits.append(st.crit)
            if stop is None and (stopped(crits, convergence_tol)
                                 or it == max_it):
                stop, at_stop = it, st
            if read_at is not None and it == read_at:
                at_read = st
            if stop is not None and (read_at is None or it >= read_at):
                break
    return Alg2Run(stop, at_stop, at_read, crits)


def growth(mu, delta):
    """(Ny, Nx) brightness multiplier over the horizon less 1: ``exp`` of
    the trapezoid integral over t (dt = 1) of zeta / rho, zeta = sigma /
    delta, where rho exceeds 1e-6 of its largest value (0 elsewhere)."""
    rho, zeta = mu[0], mu[3] / delta
    floor = 1e-6 * torch.max(rho)
    rate = torch.where(rho > floor, zeta / torch.maximum(rho, floor), 0.0)
    integral = rate.sum(dim=0) - 0.5 * (rate[0] + rate[-1])
    return torch.exp(integral) - 1.0


def fields(st: State, delta):
    """(u, v, m, growth) of a state: the flow and -div(u, v) of FOTO's
    extraction, and ``m`` the luminosity the sweep ships, ``(1 + growth)
    (1 + m_div) - 1``."""
    u, v, m_div = flow(st.phi)
    g = growth(st.mu, delta)
    return u, v, (1.0 + g) * (1.0 + m_div) - 1.0, g
