"""FOTO — Benamou–Brenier dynamic optimal transport via ALG2/ADMM, in torch.

Counterpart of ``ofot_tpu.solvers.foto`` (reference
benamou_brenier.py:151-271).  One ALG2 iteration is stepA (a Poisson-like
solve for the potential), stepB (pointwise paraboloid projection), stepC
(dual ascent) and the Hamilton–Jacobi convergence criterion, on
(3, Nt, Ny, Nx) tensors.  The JAX version runs the loop as a
``lax.while_loop`` on the device.  Here ``loop="device"`` (the default on
cuda) runs it on the device loop of ``solvers/device_loop.py``: replays of
a captured graph of K iterations, one ``done`` read per replay, bitwise
the host loop.  That covers the sets whose stepA has no data-dependent
inner loop (``dct``, ``dct-refined``, ``pallas``, ``dct-fused``); for
``cg`` and ``cg-pallas`` the ALG2 level stays a host loop around the
device-loop CG.  ``loop="host"`` (the default on the CPU) reads ``done``
once per iteration.

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
    (``ops/kernels/fused_pointwise.py``), with ``grad_st`` and stepA's
    right-hand side the stencil kernels of ``ops/kernels/stencil_st.py``
    (bitwise the plain stencils).  The name is the JAX flag value, kept
    so that run scripts work unchanged;
  * ``dct-fused``: spectral stepA whose per-slice body is the hand-written
    kernel of ``ops/kernels/dct_solve.py``, unfused rest;
  * ``cg-pallas``: CG stepA whose operator is the hand-written stencil
    kernel of ``ops/kernels/cg_operator.py``, unfused rest.

On CPU tensors every kernel wrapper runs its plain torch version.

Forms.  A set is built on a form, which supplies what is the same for
every set: the component axis ``cax``, ``sum`` and ``max``, the plain
stencils, the CG, the projection's axes, ``host_only`` and how stepA is
solved.  :class:`Single` is one pair; :class:`Lockstep` is JAX's ``vmap``
mode, B pairs of (B, Ny, Nx) frames as one ALG2 loop on (B, 3, Nt, Ny,
Nx) state, each pair stopping on its own rule (``solvers/lockstep.py``),
``auto_r`` giving each pair its own ``r`` (a ``lockstep.PerPair``);
``parallel.halo.Tiled`` is one rank's spatial tile.  Each set names its
kernels once, in its :class:`Kernels` table (each hook's single-pair and
batched form), and the form picks the column it runs: ``Single`` the
single kernels, ``Lockstep`` the batched ones, ``Tiled`` no stencil
kernel, #1 tile-local with its sums all-reduced and #4's tile form.  A
hook with no kernel runs the form's plain stencil or the unfused pass.
:func:`lockstep_ops` and ``parallel.gspmd.sharded_ops`` build a set on
another form.

One ALG2 iteration serves FOTO and WFR (``solvers/wfr.py``): WFR's
source term (``delta``) adds a component to the gradient and to stepB,
shifts stepA's ``eps`` by ``1/delta^2`` and takes ``x[3]/delta`` off
stepA's right-hand side, which then never runs S2.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ofot_tpu_torch.ops import operators
from ofot_tpu_torch.ops.kernels import projection as projection_kernel
from ofot_tpu_torch.ops.kernels.cg_operator import cg_operator_blocked
from ofot_tpu_torch.ops.kernels import dct_solve as dct_solve_kernel
from ofot_tpu_torch.ops.kernels.dct_solve import dct_solve
from ofot_tpu_torch.ops.kernels.fused_pointwise import (
    fused_pointwise, fused_pointwise_batched)
from ofot_tpu_torch.ops.kernels import stencil_st
from ofot_tpu_torch.ops.projection import (project_paraboloid,
                                           project_paraboloid_nd)
from ofot_tpu_torch.solvers import cg as cg_mod
from ofot_tpu_torch.solvers import dct, device_loop, flow_extract, lockstep
from ofot_tpu_torch.solvers.lockstep import PerPair, kernel_r
from ofot_tpu_torch.utils import trace


def r_key(r):
    """``r`` as a graph cache key: its float, or a batch's per-pair
    values (a captured graph bakes the penalty in)."""
    return r.values if isinstance(r, PerPair) else float(r)


class Kernels(NamedTuple):
    """A set's hand-written kernels, each hook as (single-pair form,
    lockstep form), each taking ``r`` as ``lockstep.kernel_r`` gives it;
    None runs the form's plain stencil, the unfused stepB + stepC +
    criterion, or the plain stepA operator."""
    grad_st: tuple | None = None           # S1
    stepA_rhs: tuple | None = None         # S2, only where there is no source
    fused_pointwise: tuple | None = None   # #1
    cg_operator: tuple | None = None       # #4


def _per_pair_sum(x):
    return torch.sum(x.flatten(1), dim=1)


def _per_pair_max(x):
    return torch.amax(x.flatten(1), dim=1)


class Single:
    """The single-pair form: fields (3, Nt, Ny, Nx) with the component axis
    first, whole-field sums, the plain stencils, the CG on the device loop
    or the host loop, and each hook's single-pair kernel."""
    name = "single"
    cax = 0
    host_only = False
    cg_solve = staticmethod(cg_mod.cg)
    grad_st = staticmethod(operators.grad_st)
    div_st = staticmethod(operators.div_st)
    laplacian_st = staticmethod(operators.laplacian_st)
    sum = staticmethod(torch.sum)
    max = staticmethod(torch.max)

    def hooks(self, kernels: Kernels) -> Kernels:
        """The kernels of a set's table this form runs."""
        return Kernels(*(None if k is None else k[0] for k in kernels))

    def projection(self, project: Callable) -> Callable:
        """A set's projection (components on axis 0) on this form's
        fields."""
        return project

    def stepA(self, ops, F, *args, **kw):
        """Solve A phi = F with the set's own ``solve``."""
        return ops.solve(F, *args, **kw)


class Lockstep(Single):
    """The lockstep-batch form: fields carry the pair axis first and the
    component axis second ((B, 3, Nt, Ny, Nx)), ``sum`` and ``max`` reduce
    per pair to (B,), stepA's CG is the masked batched CG, and the
    stencils, spectral solves and each hook's batched kernel act on the
    whole batch."""
    name = "lockstep"
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

    def hooks(self, kernels: Kernels) -> Kernels:
        return Kernels(*(None if k is None else k[1] for k in kernels))

    def projection(self, project: Callable) -> Callable:
        # contiguous: the device loop latches a stopped pair's fields as
        # contiguous segments (solvers/device_loop.py)
        return lambda p: project(p.transpose(0, 1)).transpose(0, 1) \
            .contiguous()


SINGLE, LOCKSTEP = Single(), Lockstep()


class _DefaultOps:
    """The ``cg`` set: matrix-free CG stepA, no kernel.  Every set takes
    its component axis, reductions, plain stencils and CG from its form
    (``form``, default :data:`SINGLE`), and ``hooks``, the kernels of its
    ``kernels`` table that the form runs."""
    kernels = Kernels()
    # stepA is a spectral solve with no data-dependent inner loop: the
    # ALG2 loop can run on the device loop, and a tiled form solves it
    # whole on the gathered F
    spectral = False
    projection = staticmethod(project_paraboloid)
    # k-beta-component projection for the source-extended (WFR) stepB
    projection_nd = staticmethod(project_paraboloid_nd)

    def __init__(self, form: Single = SINGLE):
        self.form = form
        self.hooks = form.hooks(self.kernels)
        self.cax, self.host_only, self.cg_solve = (form.cax, form.host_only,
                                                   form.cg_solve)
        self.sum, self.max = form.sum, form.max
        self.grad_st = self.hooks.grad_st or form.grad_st
        self.div_st, self.laplacian_st = form.div_st, form.laplacian_st
        self.fused_pointwise = self.hooks.fused_pointwise
        self.project = form.projection(self.projection)
        self.project_nd = form.projection(self.projection_nd)

    @property
    def key(self):
        """The set, its form and its own settings, as every graph cache
        key of its loops names them."""
        return (type(self), self.form.name, getattr(self, "refine", None))

    def with_form(self, form: Single):
        """This set, its own settings carried over, on ``form`` (with
        plans of its own)."""
        return type(self)(form=form)

    def cg_operator(self, r, reg_epsilon):
        """The stepA system operator A = -r*L_st + r*eps*I as a callable:
        the set's kernel, else the form's Laplacian (its scalars formed
        once: a per-pair ``r``'s arithmetic makes a new tensor on the
        device, which a captured CG step must not)."""
        kernel = self.hooks.cg_operator
        if kernel is not None:
            r = kernel_r(r)
            return lambda phi: kernel(phi, r, reg_epsilon)
        neg_r, reps = -r, r * reg_epsilon
        return lambda phi: (neg_r * self.laplacian_st(phi, bc="N")
                            + reps * phi)

    def stepA_rhs(self, mu, q, rho0, rhoT, r, delta=None):
        """stepA's right-hand side -G^T(mu - r q) plus the time-boundary
        terms injecting rho0 / rhoT (reference benamou_brenier.py:26-82).
        G is grad_st; with a source (WFR's ``delta``) it is (grad_st,
        +1/delta), so -G^T x = div_st(x[:3]) - x[3]/delta.  The set's
        kernel runs only where there is no source."""
        kernel = self.hooks.stepA_rhs
        if kernel is not None and delta is None:
            return kernel(mu, q, rho0, rhoT, kernel_r(r))
        dt = 1.0
        if delta is None:
            F = self.div_st(mu - r * q, bc="N")
        else:
            x = mu - r * q
            F = (self.div_st(x.narrow(self.cax, 0, 3), bc="N")
                 - x.select(self.cax, 3) / delta)
        rho, a = mu.select(self.cax, 0), q.select(self.cax, 0)
        operators.add_time_boundary(F, rho, a, rho0, rhoT, r, dt)
        return F

    def stepA_solve(self, F, r, reg_epsilon, cg_rtol, cg_maxiter,
                    loop="auto"):
        """Solve A phi = F -> (phi, inner_iterations): the set's
        :meth:`solve` as its form runs it."""
        return self.form.stepA(self, F, r, reg_epsilon, cg_rtol, cg_maxiter,
                               loop=loop)

    def solve(self, F, r, reg_epsilon, cg_rtol, cg_maxiter, loop="auto"):
        """Matrix-free CG with the reference's scipy-cg semantics, on the
        device loop or the host loop (``loop``); its graph is cached under
        the set and the scalars its operator closes over."""
        res = self.cg_solve(self.cg_operator(r, reg_epsilon), F,
                            rtol=cg_rtol, maxiter=cg_maxiter,
                            dot=lambda a, b: self.sum(a * b), loop=loop,
                            key=(self.key, r_key(r), float(reg_epsilon)))
        return res.x, res.iterations


class DCTOps(_DefaultOps):
    """Spectral stepA: six full-float32 matrix products and a pointwise
    divide instead of hundreds of CG iterations.  Each instance keeps the
    transform matrices and spectrum of the systems it has solved, so one
    solve builds them once."""
    spectral = True

    def __init__(self, form: Single = SINGLE):
        super().__init__(form)
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

    def solve(self, F, r, reg_epsilon, cg_rtol, cg_maxiter, loop="auto"):
        return self._plan(F, r, reg_epsilon).solve(F), 1


class DCTRefinedOps(DCTOps):
    """Spectral stepA with low-precision transforms (TF32 on cuda) plus
    ``refine`` steps of full-precision iterative refinement
    (``dct.StepAPlan.solve_refined``); each step is one stencil residual
    and one more low-precision solve, so a stepA counts ``1 + refine``
    inner iterations."""

    def __init__(self, refine: int = 3, form: Single = SINGLE):
        super().__init__(form)
        self.refine = int(refine)

    def with_form(self, form: Single):
        return type(self)(self.refine, form=form)

    def solve(self, F, r, reg_epsilon, cg_rtol, cg_maxiter, loop="auto"):
        phi = self._plan(F, r, reg_epsilon).solve_refined(F, self.refine)
        return phi, 1 + self.refine


class DCTFusedOps(DCTOps):
    """Spectral stepA whose per-slice body (y/x transforms, divide, inverse
    transforms) is the hand-written kernel of ``ops/kernels/dct_solve.py``
    (one launch per solve on CUDA tensors); the t-axis products stay
    ``torch.matmul``.  The kernel module keeps the matrices of each system
    it has solved; the set holds the plans it has used too, so that a
    captured graph that baked them in keeps them alive."""

    def solve(self, F, r, reg_epsilon, cg_rtol, cg_maxiter, loop="auto"):
        r = kernel_r(r)
        plan = dct_solve_kernel.plan_for(F, r, reg_epsilon)
        self._plans[("kernel", id(plan))] = plan
        return dct_solve(F, r, reg_epsilon), 1


class PallasOps(DCTOps):
    """Spectral stepA plus the fused stepB + stepC + criterion pass (#1,
    one kernel launch per ALG2 iteration on CUDA tensors), with
    ``grad_st`` (S1) and stepA's right-hand side (S2) each one launch of
    the stencil kernels of ``ops/kernels/stencil_st.py`` (bitwise the
    plain stencils).  ``project`` and ``project_nd`` are the standalone
    projection kernel, which reads the component count from the array; no
    ALG2 path calls them, since the fused pass does the projection."""
    kernels = Kernels(
        grad_st=(stencil_st.grad_st, stencil_st.grad_st_batched),
        stepA_rhs=(stencil_st.stepA_rhs, stencil_st.stepA_rhs_batched),
        fused_pointwise=(fused_pointwise, fused_pointwise_batched))
    projection = staticmethod(projection_kernel.project_paraboloid)
    projection_nd = projection


class PallasCGOps(_DefaultOps):
    """Reference-faithful CG stepA whose operator is the hand-written
    stencil kernel of ``ops/kernels/cg_operator.py`` (#4, one launch per
    CG step on CUDA tensors).  Same CG semantics as the ``cg`` set."""
    kernels = Kernels(cg_operator=(cg_operator_blocked, cg_operator_blocked))


DEFAULT_OPS = _DefaultOps()
# the JAX module's ready sets; each keeps the plans of the systems it has
# solved across calls, as DEFAULT_OPS keeps its CG graphs
DCT_OPS = DCTOps()
PALLAS_OPS = PallasOps()


def lockstep_ops(ops):
    """The lockstep-batch form of the ops set ``ops`` (its own settings,
    such as ``DCTRefinedOps.refine``, carried over; ``ops`` itself if it is
    one already)."""
    return ops if isinstance(ops.form, Lockstep) else ops.with_form(LOCKSTEP)


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


def _grad(phi, ops, delta):
    """grad_st phi; with a source (``delta``) G phi = (grad_st phi,
    +phi/delta), WFR's space-time 'gradient'."""
    g = ops.grad_st(phi, bc="N")
    if delta is None:
        return g
    return torch.cat([g, (phi / delta).unsqueeze(ops.cax)], dim=ops.cax)


def alg2_iteration(state: FotoState, rho0, rhoT, *, r, reg_epsilon,
                   convergence_tol, cg_rtol=1e-6, cg_maxiter=1000,
                   verbose=False, max_it=100, ops=DEFAULT_OPS,
                   admm_alpha=1.0, loop="auto") -> FotoState:
    """One full ALG2 iteration: stepA + stepB + stepC + criterion.

    ``admm_alpha``: ADMM over-relaxation — stepB/stepC act on
    ``alpha*grad_phi + (1-alpha)*q_prev`` instead of ``grad_phi``
    (alpha = 1.0 is the reference's exact iteration).  Must be a Python
    float.  ``loop``: how a CG stepA runs its loop."""
    return _iteration(state, rho0, rhoT, None, r=r, reg_epsilon=reg_epsilon,
                      convergence_tol=convergence_tol, cg_rtol=cg_rtol,
                      cg_maxiter=cg_maxiter, verbose=verbose, max_it=max_it,
                      ops=ops, admm_alpha=admm_alpha, loop=loop)


def _iteration(state: FotoState, rho0, rhoT, delta, *, r, reg_epsilon,
               convergence_tol, cg_rtol, cg_maxiter, verbose, max_it, ops,
               admm_alpha, loop) -> FotoState:
    """The ALG2 iteration of FOTO (``delta`` None) and of WFR (a source
    term with length ``delta``: k = 3 beta components instead of 2, stepA
    with ``reg_epsilon + 1/delta^2``)."""
    mu, q_prev = state.mu, state.q

    # stepA (reference benamou_brenier.py:26-91); its right-hand side is
    # freed before the rest of the iteration allocates
    eps = reg_epsilon if delta is None else reg_epsilon + 1.0 / (delta * delta)
    phi, cg_iters = ops.stepA_solve(
        ops.stepA_rhs(mu, q_prev, rho0, rhoT, r, delta), r, eps, cg_rtol,
        cg_maxiter, loop=loop)

    grad_phi = _grad(phi, ops, delta)
    fused = ops.fused_pointwise
    if fused is not None:
        # the pass reads the component count from the arrays (its speed^2
        # spans every beta component, the source dual included), builds
        # alpha*grad_phi + (1-alpha)*q_prev itself and keeps the criterion
        # on the true grad_phi
        relax = () if admm_alpha == 1.0 else (admm_alpha, q_prev)
        q, mu, num, denom = fused(grad_phi, mu, kernel_r(r), *relax)
    else:
        relaxed = (grad_phi if admm_alpha == 1.0 else
                   admm_alpha * grad_phi + (1.0 - admm_alpha) * q_prev)
        project = ops.project if delta is None else ops.project_nd
        q = project(relaxed + mu / r)
        mu = mu + r * (relaxed - q)
        # density positivity; mu is fresh
        mu.select(ops.cax, 0).clamp_(min=0.0)

        # Hamilton–Jacobi residual criterion (reference
        # benamou_brenier.py:246-251), with the source: dt phi +
        # (|grad phi|^2 + phi^2/delta^2) / 2 = 0 on the support of rho
        g = [grad_phi.select(ops.cax, i)
             for i in range(grad_phi.shape[ops.cax])]
        rho = mu.select(ops.cax, 0)
        speed2 = g[1] ** 2 + g[2] ** 2
        if delta is not None:
            speed2 = speed2 + g[3] ** 2
        res = g[0] + 0.5 * speed2
        num = ops.sum(rho * torch.abs(res))
        denom = ops.sum(rho * speed2)
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


def loop_mode(loop, ops, device) -> str:
    """The resolved ``loop=`` of a solve with ``ops``: a tiled set keeps
    its loops on the host (its collectives stage through host memory)."""
    if ops.host_only:
        return "host"
    return device_loop.resolve(loop, device)


def _verbose_lines(verbose, max_it) -> dict:
    """The loops' ``trace``/``show`` that print, after each block of the
    device loop (each iteration of a lockstep host loop), the lines
    :func:`alg2_iteration` prints under ``verbose`` (none without it): the
    carried criterion and count, a stopped pair's as they stay."""
    if not verbose:
        return {}
    return dict(trace=lambda old, new: (new.crit, new.iteration),
                show=lambda crit, it: print(f"{crit} ({it}/{max_it})"))


def _key(name, ops, r, params):
    """The graph cache key of an ALG2 loop: the solver (``foto`` or
    ``wfr``), the set with its form, and what its iteration bakes in."""
    return (name, ops.key, r_key(r), tuple(sorted(params.items())))


def run_loop(name, iteration, init_state, rho0, rhoT, Nt, init, *, batched,
             ops, r, auto_r, max_it, verbose, loop, **params):
    """The ALG2 loop of FOTO or WFR (``name``) from ``init`` or
    ``init_state``'s state: ``iteration`` (the solver module's own
    ``alg2_iteration``, as it stands when the solve starts) with
    ``params``, until done or ``max_it``.

    One pair: with ``loop`` "device" and a spectral set, the device loop,
    its graph cached under the loop's key, the counters int64 tensors
    during the loop and ints after it, and the verbose lines printed from
    each block's records; otherwise one ``done`` read per iteration (a CG
    stepA's own loop on ``loop``).  Span ``alg2.loop``, ended by the
    counters' read.  ``batched``: a lockstep batch through
    ``lockstep.run``, on the device loop likewise."""
    if batched:
        ops = lockstep_ops(ops)
        if auto_r:
            r = PerPair(scale_invariant_r(rho0, rhoT, r, ops=ops).tolist(),
                        rho0)
    elif auto_r:
        r = float(scale_invariant_r(rho0, rhoT, r, ops=ops))
    state = init_state(rho0, rhoT, Nt) if init is None else init
    key = _key(name, ops, r, params)
    mode = loop_mode(loop, ops, rho0.device)
    on_device = mode == "device" and ops.spectral

    def iterate(s, a, b, inner=mode, show=False):
        return iteration(s, a, b, r=r, max_it=max_it, verbose=show, ops=ops,
                         loop=inner, **params)

    if batched:
        return lockstep.run(state, iterate, max_it, (rho0, rhoT),
                            loop="device" if on_device else "host", key=key,
                            **_verbose_lines(verbose, max_it))
    with trace.annotate("alg2.loop"):
        if not on_device:
            while state.iteration < max_it and not bool(state.done):
                state = iterate(state, rho0, rhoT, show=verbose)
            return state

        def count(n):
            return torch.tensor(n, dtype=torch.int64, device=rho0.device)

        state = state._replace(iteration=count(state.iteration),
                               cg_iterations=count(state.cg_iterations))
        state = device_loop.while_loop(
            iterate, lambda s, a, b: ~s.done & (s.iteration < max_it),
            state, (rho0, rhoT), key=(key, max_it),
            **_verbose_lines(verbose, max_it))
        it, cg = torch.stack([state.iteration, state.cg_iterations]).tolist()
        return state._replace(iteration=it, cg_iterations=cg)


def alg2_loop(rho0, rhoT, Nt, *, r=1.0, convergence_tol=0.3,
              reg_epsilon=1e-3, max_it=100, cg_rtol=1e-6,
              cg_maxiter=1000, verbose=False, ops=DEFAULT_OPS,
              admm_alpha=1.0, auto_r=False,
              init: FotoState | None = None,
              loop: str = "auto") -> FotoState:
    """Run ALG2 until done or ``max_it``; ``init`` resumes a saved state.

    ``loop``: "device" (the device loop; for the ``cg`` sets the CG's
    loop), "host" or "auto" ("device" on cuda, "host" on the CPU)."""
    return run_loop(
        "foto", alg2_iteration, init_state, rho0, rhoT, Nt, init,
        batched=False, ops=ops, r=r, auto_r=auto_r, max_it=max_it,
        verbose=verbose, loop=loop, reg_epsilon=reg_epsilon,
        convergence_tol=convergence_tol, cg_rtol=cg_rtol,
        cg_maxiter=cg_maxiter, admm_alpha=admm_alpha)


solve_potential = alg2_loop


def alg2_loop_batched(rho0, rhoT, Nt, *, r=1.0, convergence_tol=0.3,
                      reg_epsilon=1e-3, max_it=100, cg_rtol=1e-6,
                      cg_maxiter=1000, verbose=False, ops=DEFAULT_OPS,
                      admm_alpha=1.0, auto_r=False,
                      init: FotoState | None = None,
                      loop: str = "auto") -> FotoState:
    """ALG2 on a lockstep batch: ``rho0``/``rhoT`` are (B, Ny, Nx), every
    pair runs the iteration of :func:`alg2_loop` in one loop, and each
    stops on its own rule (its fields, criteria and counters then stay as
    they were).  Returns a FotoState with a leading batch axis and (B,)
    counters, as JAX's ``vmap`` of ``solve_potential`` does.  ``loop`` as
    in :func:`alg2_loop`, through ``lockstep.run``; with ``auto_r`` each
    pair has its own ``scale_invariant_r`` (a ``PerPair``)."""
    return run_loop(
        "foto", alg2_iteration, init_state, rho0, rhoT, Nt, init,
        batched=True, ops=ops, r=r, auto_r=auto_r, max_it=max_it,
        verbose=verbose, loop=loop, reg_epsilon=reg_epsilon,
        convergence_tol=convergence_tol, cg_rtol=cg_rtol,
        cg_maxiter=cg_maxiter, admm_alpha=admm_alpha)


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
          init: FotoState | None = None, loop: str = "auto") -> FotoResult:
    """Full FOTO solve: ALG2 on the potential, then flow extraction
    (trajectory integration + luminosity), the reference's
    ``benamou_brenier.solve`` -> (u, v, m) contract.  Span ``foto.solve``
    around ``alg2.loop`` and ``foto.extract``."""
    with trace.annotate("foto.solve"):
        state = solve_potential(
            rho0, rhoT, Nt, r=r, convergence_tol=convergence_tol,
            reg_epsilon=reg_epsilon, max_it=max_it, cg_rtol=cg_rtol,
            cg_maxiter=cg_maxiter, verbose=verbose, ops=ops,
            admm_alpha=admm_alpha, auto_r=auto_r, init=init, loop=loop)
        with trace.annotate("foto.extract"):
            u, v, m = flow_extract.flow_from_potential(state.phi)
        return FotoResult(u=u, v=v, m=m, state=state)
