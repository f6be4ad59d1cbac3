"""The ops sets on their forms, and the one ALG2 iteration of FOTO and WFR.

Every set (``cg``, ``dct``, ``dct-refined``, ``pallas``, ``dct-fused``,
``cg-pallas``) runs on three forms: one pair (``foto.SINGLE``), a lockstep
batch (``foto.LOCKSTEP``) and one rank's spatial tile (``halo.Tiled``, here
on tests/test_torch_cg_operator_tile.py's mesh of one rank).  A set names its kernels once, in its ``kernels``
table, and the form picks the ones it runs.  Held here on the CPU:

  * the iteration body is bitwise the iteration code it replaced, for
    every set on every form, FOTO and WFR, at float32 and float64, with
    and without over-relaxation: frozen copies of ``foto.alg2_iteration``,
    ``wfr.alg2_iteration`` and ``wfr._stepA`` as they stood before the two
    shared one body run beside the new entries;
  * each (set, form) resolves to the callables it ran before: the
    stencils, the right-hand side, the fused pass, the CG and its operator;
  * the right-hand side with a source never runs the set's S2 kernel;
  * graph cache keys never collide, across (set, form) pairs and between
    FOTO and WFR loops (on the CPU no graph is cached, so a collision
    would pass every other test here).

On CPU tensors every kernel wrapper runs its plain version, so the bitwise
cases hold the body and the forms; which kernel runs where is held by the
table cases, and on the card by tests/test_torch_kernels_cuda.py.
"""

import functools
import itertools

import numpy as np
import pytest
import torch

from ofot_tpu_torch.ops import operators
from ofot_tpu_torch.ops.kernels import stencil_st as ss
from ofot_tpu_torch.ops.kernels.cg_operator import cg_operator_blocked
from ofot_tpu_torch.ops.kernels.fused_pointwise import (
    fused_pointwise, fused_pointwise_batched)
from ofot_tpu_torch.parallel import gspmd
from ofot_tpu_torch.parallel.halo import Tiled
from ofot_tpu_torch.solvers import cg as cg_mod
from ofot_tpu_torch.solvers import device_loop, foto, wfr
from ofot_tpu_torch.solvers.lockstep import PerPair, kernel_r
from test_torch_cg_operator_tile import _LoneMesh

SETS = ["cg", "dct", "dct-refined", "pallas", "dct-fused", "cg-pallas"]
FORMS = ["single", "lockstep", "tiled"]
DTYPES = [torch.float32, torch.float64]
NT = 4
DELTA = 2.5
RNG = np.random.default_rng(61)


def _on_form(solver, form):
    ops = foto.stepA_ops(solver)
    if form == "lockstep":
        return foto.lockstep_ops(ops)
    if form == "tiled":
        return gspmd.sharded_ops(ops, _LoneMesh())
    return ops


# ------------------------------------------- the code the body replaced

def _old_fused_batched(grad_phi, mu, r, alpha=None, q_prev=None):
    """The lockstep form's fused pass before the body took ``r`` through
    ``kernel_r`` itself."""
    return fused_pointwise_batched(grad_phi, mu, kernel_r(r), alpha, q_prev)


def _old_foto_stepA(mu, q, rho0, rhoT, r, reg_epsilon, cg_rtol, cg_maxiter,
                    ops, loop="auto"):
    F = ops.stepA_rhs(mu, q, rho0, rhoT, r)
    return ops.stepA_solve(F, r, reg_epsilon, cg_rtol, cg_maxiter,
                           loop=loop)


def _old_foto_iteration(state, rho0, rhoT, *, r, reg_epsilon,
                        convergence_tol, cg_rtol=1e-6, cg_maxiter=1000,
                        verbose=False, max_it=100, ops=foto.DEFAULT_OPS,
                        admm_alpha=1.0, loop="auto"):
    """``foto.alg2_iteration`` as it stood before the shared body, word
    for word."""
    mu, q_prev = state.mu, state.q

    phi, cg_iters = _old_foto_stepA(mu, q_prev, rho0, rhoT, r, reg_epsilon,
                                    cg_rtol, cg_maxiter, ops, loop)

    grad_phi = ops.grad_st(phi, bc="N")
    fused = getattr(ops, "fused_pointwise", None)
    if fused is not None and admm_alpha == 1.0:
        q, mu, num, denom = fused(grad_phi, mu, r)
    elif fused is not None:
        q, mu, num, denom = fused(grad_phi, mu, r, admm_alpha, q_prev)
    else:
        relaxed = (grad_phi if admm_alpha == 1.0 else
                   admm_alpha * grad_phi + (1.0 - admm_alpha) * q_prev)
        q = ops.project(relaxed + mu / r)
        mu = mu + r * (relaxed - q)
        mu.select(ops.cax, 0).clamp_(min=0.0)

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

    return foto.FotoState(mu=mu, q=q, phi=phi, crit=crit,
                          prev_crit=prev_crit,
                          iteration=state.iteration + 1,
                          cg_iterations=state.cg_iterations + cg_iters,
                          done=done)


def _old_wfr_stepA(mu, q, rho0, rhoT, r, reg_epsilon, delta, cg_rtol,
                   cg_maxiter, ops, loop="auto"):
    """``wfr._stepA`` as it stood before the shared right-hand side."""
    dt = 1.0
    x = mu - r * q
    F = (ops.div_st(x.narrow(ops.cax, 0, 3), bc="N")
         - x.select(ops.cax, 3) / delta)
    rho, a = mu.select(ops.cax, 0), q.select(ops.cax, 0)
    operators.add_time_boundary(F, rho, a, rho0, rhoT, r, dt)

    eps_eff = reg_epsilon + 1.0 / (delta * delta)
    return ops.stepA_solve(F, r, eps_eff, cg_rtol, cg_maxiter, loop=loop)


def _old_wfr_iteration(state, rho0, rhoT, *, r, delta, reg_epsilon,
                       convergence_tol, cg_rtol=1e-6, cg_maxiter=1000,
                       verbose=False, max_it=100, ops=None, admm_alpha=1.0,
                       loop="auto"):
    """``wfr.alg2_iteration`` as it stood before the shared body."""
    mu, q_prev = state.mu, state.q

    phi, cg_iters = _old_wfr_stepA(mu, q_prev, rho0, rhoT, r, reg_epsilon,
                                   delta, cg_rtol, cg_maxiter, ops, loop)
    gphi = torch.cat([ops.grad_st(phi, bc="N"),
                      (phi / delta).unsqueeze(ops.cax)], dim=ops.cax)

    fused = getattr(ops, "fused_pointwise", None)
    if fused is not None and admm_alpha == 1.0:
        q, mu, num, denom = fused(gphi, mu, r)
    elif fused is not None:
        q, mu, num, denom = fused(gphi, mu, r, admm_alpha, q_prev)
    else:
        relaxed = (gphi if admm_alpha == 1.0 else
                   admm_alpha * gphi + (1.0 - admm_alpha) * q_prev)
        q = ops.project_nd(relaxed + mu / r)
        mu = mu + r * (relaxed - q)
        mu.select(ops.cax, 0).clamp_(min=0.0)

        g0, g1, g2, g3 = (gphi.select(ops.cax, i) for i in range(4))
        rho = mu.select(ops.cax, 0)
        speed2 = g1 ** 2 + g2 ** 2 + g3 ** 2
        res = g0 + 0.5 * speed2
        num = ops.sum(rho * torch.abs(res))
        denom = ops.sum(rho * speed2)
    crit = torch.sqrt(num / (denom + 1e-10))

    prev_crit = state.crit
    done = (crit <= convergence_tol) | (
        (prev_crit >= 0) & (torch.abs(prev_crit - crit) < 1e-5))
    done = done | torch.isnan(crit)

    return foto.FotoState(mu=mu, q=q, phi=phi, crit=crit,
                          prev_crit=prev_crit,
                          iteration=state.iteration + 1,
                          cg_iterations=state.cg_iterations + cg_iters,
                          done=done)


# ------------------------------------------------------------ bitwise

def _frames(form, dtype):
    a = torch.from_numpy(RNG.uniform(0.1, 0.9, (3, 8, 10))).to(dtype)
    b = torch.roll(a, (1, 2), dims=(1, 2))
    b[1] = torch.roll(a[1], (-2, 1), dims=(0, 1))
    if form == "lockstep":
        return a, b, PerPair([0.8, 1.0, 1.3], a)
    return a[0], b[0], 0.9


def _same_state(got, want):
    for x, y in zip(got, want):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert torch.equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("admm_alpha", [1.0, 1.7])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("solver", SETS)
@pytest.mark.parametrize("algo", ["foto", "wfr"])
def test_the_body_is_bitwise_the_iteration_it_replaced(algo, solver, form,
                                                       dtype, admm_alpha):
    """Three iterations (the second and third relax against a q of their
    own and test the stagnation rule) of the new entry and of the frozen
    code, each with a set of its own: the same state, bit for bit."""
    a, b, r = _frames(form, dtype)
    new, old = _on_form(solver, form), _on_form(solver, form)
    if form == "lockstep" and old.fused_pointwise is not None:
        old.fused_pointwise = _old_fused_batched
    kw = dict(r=r, reg_epsilon=1e-2, convergence_tol=0.01,
              admm_alpha=admm_alpha, loop="host")
    if algo == "wfr":
        mod, frozen, kw["delta"] = wfr, _old_wfr_iteration, DELTA
    else:
        mod, frozen = foto, _old_foto_iteration
    got = want = mod.init_state(a, b, NT)
    for _ in range(3):
        got = mod.alg2_iteration(got, a, b, ops=new, **kw)
        want = frozen(want, a, b, ops=old, **kw)
        _same_state(got, want)
    assert all(t.is_contiguous() for t in (got.mu, got.q, got.phi))


# -------------------------------------------------------------- tables

def _plain(f):
    """A resolved hook as the table names it: a bound method's function,
    a partial's function and arguments."""
    if isinstance(f, functools.partial):
        return (_plain(f.func),) + f.args
    return getattr(f, "__func__", f)


# (set, form) -> grad_st, stepA_rhs kernel, fused pass, stepA operator
# kernel: what each ran before the forms were declared
_PLAIN = {"single": operators.grad_st, "lockstep": foto.Lockstep.grad_st,
          "tiled": Tiled.grad_st}
_PARENT = {(s, f): (_PLAIN[f], None, None, None)
           for s in SETS for f in FORMS}
_PARENT.update({
    ("pallas", "single"): (ss.grad_st, ss.stepA_rhs, fused_pointwise, None),
    ("pallas", "lockstep"): (ss.grad_st_batched, ss.stepA_rhs_batched,
                             fused_pointwise_batched, None),
    ("pallas", "tiled"): (Tiled.grad_st, None,
                          (Tiled._fused, fused_pointwise), None),
    ("cg-pallas", "single"): (operators.grad_st, None, None,
                              cg_operator_blocked),
    ("cg-pallas", "lockstep"): (foto.Lockstep.grad_st, None, None,
                                cg_operator_blocked),
    ("cg-pallas", "tiled"): (Tiled.grad_st, None, None,
                             Tiled._cg_operator_tile),
})
_FORM_PARTS = {  # div_st, sum, cg_solve, cax, host_only
    "single": (operators.div_st, torch.sum, cg_mod.cg, 0, False),
    "lockstep": (foto.Lockstep.div_st, foto._per_pair_sum, cg_mod.cg_batched,
                 1, False),
    "tiled": (Tiled.div_st, Tiled.sum, cg_mod.cg, 0, True),
}


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("solver", SETS)
def test_each_set_and_form_resolves_to_the_parents_callables(solver, form):
    ops = _on_form(solver, form)
    got = (_plain(ops.grad_st), _plain(ops.hooks.stepA_rhs),
           _plain(ops.fused_pointwise), _plain(ops.hooks.cg_operator))
    assert got == _PARENT[(solver, form)]
    parts = (_plain(ops.div_st), _plain(ops.sum), ops.cg_solve, ops.cax,
             ops.host_only)
    assert parts == _FORM_PARTS[form]
    assert ops.spectral == (solver not in ("cg", "cg-pallas"))
    assert type(ops) is type(foto.stepA_ops(solver))


def test_forms_carry_the_sets_own_settings_and_keep_plans_of_their_own():
    ops = foto.DCTRefinedOps(refine=5)
    ops._plans["seen"] = None
    for other in (foto.lockstep_ops(ops), gspmd.sharded_ops(ops, None)):
        assert other.refine == 5 and other._plans == {}
    lock = foto.lockstep_ops(ops)
    assert foto.lockstep_ops(lock) is lock
    with pytest.raises(ValueError, match="not a single-pair"):
        gspmd.sharded_ops(lock, None)


@pytest.mark.parametrize("form", ["single", "lockstep"])
def test_the_right_hand_side_with_a_source_never_runs_the_kernel(form):
    """S2 serves FOTO's right-hand side; WFR's (a source) is the plain
    one, on the form's stencils."""
    ops = _on_form("pallas", form)
    calls = []
    kernel = ops.hooks.stepA_rhs
    ops.hooks = ops.hooks._replace(
        stepA_rhs=lambda *a: calls.append(1) or kernel(*a))
    a, b, r = _frames(form, torch.float64)
    st = wfr.init_state(a, b, NT)
    plain = _on_form("dct", form)
    assert torch.equal(ops.stepA_rhs(st.mu, st.q, a, b, r, DELTA),
                       plain.stepA_rhs(st.mu, st.q, a, b, r, DELTA))
    assert calls == []
    st = foto.init_state(a, b, NT)
    ops.stepA_rhs(st.mu, st.q, a, b, r)
    assert calls == [1]


# ---------------------------------------------------------------- keys

def test_ops_keys_are_pairwise_distinct():
    keys = [_on_form(s, f).key for s in SETS for f in FORMS]
    keys.append(foto.DCTRefinedOps(refine=5).key)
    assert len(set(keys)) == len(keys)


def test_loop_keys_never_collide(monkeypatch):
    """Every graph key that FOTO's and WFR's loops hand the device loop,
    single-pair and lockstep, for every set (the CG sets' through their
    CG): no key of one (algo, set, form) is a key of another."""
    real = device_loop.while_loop
    seen = []

    def recording(*args, key=None, **kw):
        seen.append(key)
        return real(*args, key=key, **kw)

    monkeypatch.setattr(device_loop, "while_loop", recording)
    a, b, _ = _frames("lockstep", torch.float64)
    keys = {}
    for algo, solver, form in itertools.product(("foto", "wfr"), SETS,
                                                ("single", "lockstep")):
        mod = foto if algo == "foto" else wfr
        kw = dict(r=1.0, reg_epsilon=1e-2, convergence_tol=0.01, max_it=2,
                  ops=foto.stepA_ops(solver), loop="device")
        if algo == "wfr":
            kw["delta"] = DELTA
        seen.clear()
        if form == "lockstep":
            mod.alg2_loop_batched(a, b, NT, **kw)
        else:
            mod.alg2_loop(a[0], b[0], NT, **kw)
        assert seen and None not in seen
        keys[(algo, solver, form)] = set(seen)
    for (p, kp), (q, kq) in itertools.combinations(keys.items(), 2):
        assert not kp & kq, (p, q)
