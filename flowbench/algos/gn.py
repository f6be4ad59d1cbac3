"""GN cells: the port's GN solve (``ofot_tpu_torch.solvers.gn.solve_fields``)
driven pair by pair, each call ended by the device-to-host copy of
(u, v, m); and the check of its answers against the plain reference
(``flowbench/reference/gn.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from flowbench.algos import common
from flowbench.reference import gn as ref

COUNTER = "steps"


def _params(config):
    return dict(alpha=config["alpha"], lambda_=config["lambda"],
                rtol=config["rtol"], maxiter=config["maxiter"])


class Program:
    """The timed path of a GN cell on ``device`` (one pair a call)."""

    def __init__(self, config, traffic, device):
        from ofot_tpu_torch.solvers import gn
        if traffic["batch"] != 1:
            raise ValueError("the GN cells solve one pair a call")
        self.config, self.gn = config, gn

    def __call__(self, frames):
        (f1, f2), = frames
        res = self.gn.solve_fields(f1, f2, precond=self.config["precond"],
                                   **_params(self.config))
        host = tuple(t.cpu().numpy() for t in (res.u, res.v, res.m))
        return [(host, {COUNTER: int(res.cg.iterations)})]


def control(config, f1, f2):
    """The reference in the program's place, one precision step below the
    configuration's (``config["control"]``: bfloat16 throughout)."""
    low = config["control"]
    dtype = getattr(torch, low["dtype"])
    u, v, m, steps, _ = ref.solve(f1.to(dtype), f2.to(dtype),
                                  tf32=low["tf32"], **_params(config))
    return (tuple(t.float().cpu().numpy() for t in (u, v, m)),
            {COUNTER: steps})


def check(config, sample, device):
    """Numbers of the comparison over ``sample`` [(pair, (u, v, m),
    counters)] against the float64 reference solved to the configuration's
    rtol.

    ``flow_gap_px``, ``lum_gap``, ``field_rel`` as for FOTO; ``residual``:
    the largest |b - A x| / |b| of the program's own answer, the system
    built again by the reference in float64; ``steps_log``: the largest
    |ln(program's CG steps / the reference's)|, as wide for a CG stopped
    early as for one that runs long."""
    out = dict(flow_gap_px=0.0, lum_gap=0.0, field_rel=0.0, residual=0.0,
               steps_log=0.0)
    for pair, fields, counters in sample:
        a, b = (torch.as_tensor(f, dtype=torch.float64, device=device)
                for f in (pair.f1, pair.f2))
        u, v, m, steps, system = ref.solve(a, b, **_params(config))
        want = [t.cpu().numpy() for t in (u, v, m)]
        common.field_gaps(out, fields, want)
        got = torch.as_tensor(np.stack(fields), dtype=torch.float64,
                              device=device)
        out["residual"] = common.worst(out["residual"], system.residual(got))
        out["steps_log"] = common.worst(out["steps_log"], abs(math.log(
            max(counters[COUNTER], 1e-300) / max(steps, 1))))
    return out
