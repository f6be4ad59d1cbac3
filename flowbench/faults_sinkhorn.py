"""Faults planted in the Sinkhorn cells' timed path
(``sinkhorn.solve_fields``), each a change that a later version of the
program could make to run faster or that breaks it, and that the check
must find: ``correct`` comes out false.  They are ``plant(set_attr,
**options)`` as in ``flowbench/faults.py``, and the program is imported
only when one is planted.

``flowbench/tests/test_flowbench_sinkhorn.py`` plants them on the CPU at
a small size; on the card, at the cell's own size, they give the upper
readings of ``flowbench/limits/sinkhorn_mb1_320.json``:

    python3 flowbench/faults_sinkhorn.py --workload sinkhorn_mb1_320 \\
        --seeds 1,2,3 --fault sinkhorn_no_anneal [--seconds 3] [--calls 8]

(``flowbench/readings.py`` with these faults among its own.)
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch


def sinkhorn_no_anneal(set_attr):
    """The eps ladder dropped: every solve at the configuration's eps from
    zero potentials."""
    from ofot_tpu_torch.solvers import sinkhorn
    set_attr(sinkhorn, "solve_annealed", sinkhorn.solve)


def sinkhorn_no_debias(set_attr):
    """The flow without its debiasing: the raw grid subtracted from the
    a->b map in place of the self-plan's map."""
    from ofot_tpu_torch.solvers import sinkhorn
    real = sinkhorn._flow_extract

    def biased(a, res, self_res, *args, **kw):
        return real(a, res, None, *args, **kw)

    set_attr(sinkhorn, "_flow_extract", biased)


def _fields_params(set_attr, **override):
    """``solve_fields`` runs with ``override`` in place of the caller's
    keyword arguments."""
    from ofot_tpu_torch.solvers import sinkhorn
    real = sinkhorn.solve_fields

    def changed(*args, **kw):
        return real(*args, **dict(kw, **override))

    set_attr(sinkhorn, "solve_fields", changed)


def sinkhorn_no_escalation(set_attr):
    """``auto`` without its re-solve: the matmul softmin's answer shipped
    whatever its verified marginal error."""
    _fields_params(set_attr, stabilizer="matmul")


def sinkhorn_early_stop(set_attr, max_iter=100):
    """Every stage cut to ``max_iter`` iterations at most, whatever the
    configuration says."""
    _fields_params(set_attr, max_iter=max_iter)


def sinkhorn_loose_tol(set_attr, tol=1e-2):
    """The marginal tolerance loosened to ``tol``."""
    _fields_params(set_attr, tol=tol)


def sinkhorn_keeps_state(set_attr):
    """A dual update that returns both potentials unchanged."""
    from ofot_tpu_torch.solvers import sinkhorn

    def unchanged(f, g, *args):
        return f, g

    set_attr(sinkhorn, "iteration", unchanged)


def sinkhorn_answer_altered(set_attr, du=0.5):
    """u moved by ``du`` px where it is produced, at the first frame's
    largest density."""
    from ofot_tpu_torch.solvers import sinkhorn
    real = sinkhorn._flow_extract

    def altered(a, *args, **kw):
        res = real(a, *args, **kw)
        u = res.u.clone()
        u.view(-1)[torch.argmax(a)] += du
        return res._replace(u=u)

    set_attr(sinkhorn, "_flow_extract", altered)


FAULTS = {f.__name__: f for f in (
    sinkhorn_no_anneal, sinkhorn_no_debias, sinkhorn_no_escalation,
    sinkhorn_early_stop, sinkhorn_loose_tol, sinkhorn_keeps_state,
    sinkhorn_answer_altered)}


def main(argv=None) -> int:
    """``flowbench/readings.py``, with these faults among its own."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from flowbench import faults, readings
    faults.FAULTS.update(FAULTS)
    return readings.main(argv)


if __name__ == "__main__":
    sys.exit(main())
