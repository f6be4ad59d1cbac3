"""Faults planted in the WFR cells' timed path (``wfr.solve``), each a
change that a later version of the program could make to run faster or
that breaks it, and that the check must find: ``correct`` comes out
false.  They are ``plant(set_attr, **options)`` as in
``flowbench/faults.py``, and the program is imported only when one is
planted.

``flowbench/tests/test_flowbench_wfr.py`` plants them on the CPU at a
small size; on the card, at the cell's own size, they give the upper
readings of ``flowbench/limits/wfr_mb1_320.json``:

    python3 flowbench/faults_wfr.py --workload wfr_mb1_320 \\
        --seeds 1,2,3 --fault wfr_no_source [--seconds 3] [--calls 8]

(``flowbench/readings.py`` with these faults among its own.)
"""

from __future__ import annotations

import math
import sys
from pathlib import Path

import torch


def wfr_keeps_state(set_attr):
    """An unbalanced ALG2 iteration that returns its state unchanged but
    counted."""
    from ofot_tpu_torch.solvers import wfr

    def unchanged(state, *args, **kw):
        return state._replace(iteration=state.iteration + 1)

    set_attr(wfr, "alg2_iteration", unchanged)


def _wfr_params(set_attr, **override):
    """The WFR loop runs with ``override`` in place of the caller's
    keyword arguments."""
    from ofot_tpu_torch.solvers import wfr
    real = wfr.solve_potential

    def changed(*args, **kw):
        return real(*args, **dict(kw, **override))

    set_attr(wfr, "solve_potential", changed)


def wfr_early_stop(set_attr, max_it=20):
    """The loop cut to ``max_it`` iterations, whatever the configuration
    says."""
    _wfr_params(set_attr, max_it=max_it)


def wfr_loose_tol(set_attr, tol=0.1):
    """The loop's tolerance loosened to ``tol``."""
    _wfr_params(set_attr, convergence_tol=tol)


def wfr_no_source(set_attr):
    """The source dropped (delta -> infinity): the balanced solve in WFR's
    place, the fourth component and so the growth left at 0."""
    _wfr_params(set_attr, delta=math.inf)


def wfr_answer_altered(set_attr, dg=0.05):
    """The growth moved by ``dg`` where it is produced, at the brightest
    pixel of the first frame."""
    from ofot_tpu_torch.solvers import wfr
    real = wfr.growth_from_state

    def altered(state, *args, **kw):
        g = real(state, *args, **kw).clone()
        first = state.mu[0, 0]
        g.view(-1)[torch.argmax(first)] += dg
        return g

    set_attr(wfr, "growth_from_state", altered)


def wfr_no_growth(set_attr):
    """``m`` shipped without the growth: -div(u, v) alone in the
    luminosity slot."""
    from ofot_tpu_torch.solvers import wfr

    def div_only(m_div, growth):
        return m_div

    set_attr(wfr, "combined_luminosity", div_only)


FAULTS = {f.__name__: f for f in (
    wfr_keeps_state, wfr_early_stop, wfr_loose_tol, wfr_no_source,
    wfr_answer_altered, wfr_no_growth)}


def main(argv=None) -> int:
    """``flowbench/readings.py``, with these faults among its own."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from flowbench import faults, readings
    faults.FAULTS.update(FAULTS)
    return readings.main(argv)


if __name__ == "__main__":
    sys.exit(main())
