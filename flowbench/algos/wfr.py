"""WFR cells: the port's unbalanced solve (``ofot_tpu_torch.solvers.wfr.
solve``) driven pair by pair, each call ended by the device-to-host copy of
(u, v, m_combined), the fields the CLI writes; and the check of its
answers against the plain reference (``flowbench/reference/wfr.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from flowbench.algos import common
from flowbench.reference import foto as bb
from flowbench.reference import wfr as ref

COUNTER = "iters"


def _params(config):
    return dict(r=config["r"], delta=config["delta"],
                convergence_tol=config["convergence_tol"],
                reg_epsilon=config["reg_epsilon"], max_it=config["max_it"],
                admm_alpha=config["admm_alpha"])


class Program:
    """The timed path of a WFR cell on ``device`` (one pair a call)."""

    def __init__(self, config, traffic, device):
        from ofot_tpu_torch.solvers import foto, wfr
        if traffic["batch"] != 1:
            raise ValueError("the WFR cells solve one pair a call")
        self.config, self.wfr = config, wfr
        self.ops = foto.stepA_ops(wfr.resolve_stepA_solver(
            config["stepA_solver"], device))

    def __call__(self, frames):
        """``frames``: [(f1, f2)], one pair of device tensors ->
        [((u, v, m_combined) numpy, {"iters": n})]."""
        (f1, f2), = frames
        cfg = self.config
        res = self.wfr.solve(f1, f2, cfg["Nt"], ops=self.ops, **_params(cfg))
        host = tuple(t.cpu().numpy() for t in (res.u, res.v, res.m_combined))
        return [(host, {COUNTER: int(res.state.iteration)})]


def control(config, f1, f2):
    """The reference in the program's place, one precision step below the
    configuration's (``config["control"]``: float32 data, TF32 products):
    its own stop and its fields, as the program's call gives them."""
    low = config["control"]
    dtype = getattr(torch, low["dtype"])
    run = ref.alg2(f1.to(dtype), f2.to(dtype), config["Nt"],
                   tf32=low["tf32"], **_params(config))
    u, v, m, _ = ref.fields(run.at_stop, config["delta"])
    return ((u.float().cpu().numpy(), v.float().cpu().numpy(),
             m.float().cpu().numpy()), {COUNTER: run.stop})


def check(config, sample, device):
    """Numbers of the comparison over ``sample`` [(pair, (u, v,
    m_combined), counters)]: each pair's reference in float64 runs to its
    own stop and on to the program's iteration count k if that lies
    beyond.

    ``flow_gap_px``: the largest |u| or |v| gap to the reference read
    after k iterations (the iterations and the flow extraction);
    ``lum_frame_gap``: the largest gap of ``m_combined f1``, the change of
    brightness that the sweep's warp applies to the first frame (``f1 <-
    (1 + m) f1``, frames of largest value 1): the growth, its composition
    and -div(u, v) where the frame has content; ``field_rel``: the largest
    relative L2 gap of u, v or ``m_combined f1``; ``lum_gap``: the largest
    |m_combined| gap at any pixel, reported and not limited: where the
    density is near the growth's vacuum floor (1e-6 of its largest value,
    the dark border a motion leaves), zeta / rho is float32's rounding
    over a density of 1e-6 and the growth differs by up to 0.1 with no
    fault (32x24 frames on the CPU); ``stop_miss``: the most by which the
    reference's criterion misses the stopping rule after k iterations
    (``stop_miss`` of ``flowbench/reference/foto.py``: a stop the rule
    does not call for, as a loosened tolerance or a cut max_it makes);
    each the worst over the sample."""
    # common.field_gaps' lum_gap is taken of m_combined f1 here
    out = dict(field_rel=0.0, flow_gap_px=0.0, lum_gap=0.0, stop_miss=0.0)
    any_pixel = 0.0
    for pair, (u, v, m), counters in sample:
        a, b = (torch.as_tensor(f, dtype=torch.float64, device=device)
                for f in (pair.f1, pair.f2))
        k = counters[COUNTER]
        # a pair reported to have run no iteration is read after one
        run = ref.alg2(a, b, config["Nt"], read_at=max(k, 1),
                       **_params(config))
        wu, wv, wm = (t.cpu().numpy()
                      for t in ref.fields(run.at_read, config["delta"])[:3])
        f1 = np.asarray(pair.f1, np.float64)
        common.field_gaps(out, (u, v, m * f1), (wu, wv, wm * f1))
        any_pixel = common.worst(any_pixel, float(np.max(np.abs(
            np.asarray(m, np.float64) - wm))))
        out["stop_miss"] = common.worst(out["stop_miss"], bb.stop_miss(
            run.crits, k, config["convergence_tol"], config["max_it"]))
    out["lum_frame_gap"], out["lum_gap"] = out["lum_gap"], any_pixel
    return out
