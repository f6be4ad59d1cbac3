"""Faults planted in the program's timed path, each a change that a later
version of the program could make to run faster or that breaks it, and
that the check must find: ``correct`` comes out false.

``flowbench/tests/test_flowbench_faults.py`` plants them on the CPU at a
small size (with pytest's ``monkeypatch.setattr``);
``flowbench/readings.py --fault <name>`` plants them on the card at the
cell's own size (with the builtin ``setattr``), where they give the upper
readings of the numbers that the control does not move (PERF.md §2).
Each fault is ``plant(set_attr, **options)``; the program is imported
only when one is planted.
"""

from __future__ import annotations

import torch


def foto_keeps_state(set_attr):
    """An ALG2 iteration that returns its state unchanged but counted."""
    from ofot_tpu_torch.solvers import foto

    def unchanged(state, *args, **kw):
        return state._replace(iteration=state.iteration + 1)

    set_attr(foto, "alg2_iteration", unchanged)


def foto_answer_altered(set_attr, px=0.5):
    """The flow extraction's u moved by ``px`` at one pixel."""
    from ofot_tpu_torch.solvers import flow_extract
    real = flow_extract.flow_from_potential

    def altered(phi):
        u, v, m = real(phi)
        u = u.clone()
        u[..., 5, 7] += px
        return u, v, m

    set_attr(flow_extract, "flow_from_potential", altered)


def _foto_params(set_attr, **override):
    """FOTO's single-pair and lockstep loops run with ``override`` in
    place of the caller's keyword arguments (a cut max_it, a loosened
    tolerance)."""
    from ofot_tpu_torch.solvers import foto
    for name in ("solve_potential", "solve_potential_batched"):
        real = getattr(foto, name)

        def changed(*args, _real=real, **kw):
            return _real(*args, **dict(kw, **override))

        set_attr(foto, name, changed)


def foto_early_stop(set_attr, max_it=20):
    """ALG2 cut to ``max_it`` iterations, whatever the configuration says."""
    _foto_params(set_attr, max_it=max_it)


def foto_loose_tol(set_attr, tol=0.1):
    """ALG2's tolerance loosened to ``tol``."""
    _foto_params(set_attr, convergence_tol=tol)


def lockstep_half_batch(set_attr, rest="copies"):
    """Only the first half of each lockstep batch is solved; the rest get
    the first half's answers (``copies``) or keep their initial state
    (``initial``)."""
    from ofot_tpu_torch.solvers import foto
    real = foto.solve_potential_batched

    def half(rho0, rhoT, Nt, **kw):
        keep = len(rho0) // 2
        st = real(rho0[:keep], rhoT[:keep], Nt, **kw)
        other = (st if rest == "copies" else
                 foto.init_state(rho0[keep:], rhoT[keep:], Nt))
        return type(st)(*(torch.cat([a, b[:len(rho0) - keep]])
                          if isinstance(a, torch.Tensor) and a.dim() else a
                          for a, b in zip(st, other)))

    set_attr(foto, "solve_potential_batched", half)


def lockstep_no_freeze(set_attr):
    """A lockstep batch without its per-pair freeze: every pair steps
    while any pair runs, and counts the batch's iterations as its own."""
    from ofot_tpu_torch.solvers import device_loop, lockstep
    real_select, real_pairs = device_loop.select, lockstep.select_pairs

    def select(run, new, old):
        return real_select(run.any().expand_as(run), new, old)

    def select_pairs(keep, new, old):
        return real_pairs(keep.any().expand_as(keep), new, old)

    set_attr(device_loop, "select", select)
    set_attr(lockstep, "select_pairs", select_pairs)


def gn_keeps_state(set_attr):
    """A CG solve that returns its start (0) as the answer."""
    from ofot_tpu_torch.solvers import gn
    from ofot_tpu_torch.solvers.cg import CGResult

    def unchanged(A, b, *, maxiter, **kw):
        return CGResult(x=torch.zeros_like(b), iterations=maxiter,
                        residual=torch.linalg.vector_norm(b),
                        converged=False)

    set_attr(gn, "cg", unchanged)


def gn_answer_altered(set_attr, dm=0.05):
    """GN's m moved by ``dm`` at one pixel."""
    from ofot_tpu_torch.solvers import gn
    real = gn.solve_fields

    def altered(*args, **kw):
        res = real(*args, **kw)
        m = res.m.clone()
        m[..., 3, 4] += dm
        return res._replace(m=m)

    set_attr(gn, "solve_fields", altered)


def gn_cg_loose(set_attr, rtol=1e-3):
    """GN's CG stopped at ``rtol`` instead of the configuration's."""
    from ofot_tpu_torch.solvers import gn
    real = gn.cg

    def loose(A, b, **kw):
        return real(A, b, **dict(kw, rtol=rtol))

    set_attr(gn, "cg", loose)


FAULTS = {f.__name__: f for f in (
    foto_keeps_state, foto_answer_altered, foto_early_stop, foto_loose_tol,
    lockstep_half_batch, lockstep_no_freeze, gn_keeps_state,
    gn_answer_altered, gn_cg_loose)}
