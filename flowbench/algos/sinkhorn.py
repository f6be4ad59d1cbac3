"""Sinkhorn cells: the port's static entropic solve
(``ofot_tpu_torch.solvers.sinkhorn.solve_fields``, the ``auto``
stabilizer) driven pair by pair, each call ended by the device-to-host
copy of (u, v, m), the fields the CLI writes; and the check of its answers
against the plain reference (``flowbench/reference/sinkhorn.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from flowbench.algos import common
from flowbench.reference import sinkhorn as ref

COUNTER = "iters"
# the program's counters whose change over a call a pair's counters give
COUNTERS = {"iters": "sinkhorn.iterations",
            "exact_iters": "sinkhorn.exact_iterations",
            "escalated": "sinkhorn.escalations"}


def _params(config):
    return dict(max_it=config["max_it"], tol=config["tol"],
                theta=config["theta"])


class Program:
    """The timed path of a Sinkhorn cell on ``device`` (one pair a call).
    Set-up solves a pair of blobs of the cell's shape once with the exact
    softmin, so that its graphs are captured before the window as the
    harness's warm-up captures the matmul softmin's."""

    def __init__(self, config, traffic, device):
        from ofot_tpu_torch.solvers import sinkhorn
        from ofot_tpu_torch.utils import trace
        if traffic["batch"] != 1:
            raise ValueError("the Sinkhorn cells solve one pair a call")
        self.config, self.sinkhorn, self.trace = config, sinkhorn, trace
        h, w = traffic["height"], traffic["width"]
        y, x = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                           device=device),
                              torch.arange(w, dtype=torch.float32,
                                           device=device), indexing="ij")
        blobs = [torch.exp(-((y - h * cy) ** 2 + (x - w * cx) ** 2)
                           / (0.02 * h * w)) for cy, cx in ((0.4, 0.4),
                                                            (0.6, 0.55))]
        self._solve(*blobs, stabilizer="exact",
                    max_iter=config["check_every"])

    def _solve(self, f1, f2, **kw):
        cfg = self.config
        kw = dict(dict(stabilizer=cfg["stabilizer"],
                       max_iter=cfg["max_it"]), **kw)
        return self.sinkhorn.solve_fields(f1, f2, cfg["epsilon"],
                                          tol=cfg["tol"],
                                          theta=cfg["theta"], **kw)

    def __call__(self, frames):
        """``frames``: [(f1, f2)], one pair of device tensors ->
        [((u, v, m) numpy, counters)]: the change of each ``COUNTERS``
        counter over the call and the final stages' own counts."""
        (f1, f2), = frames
        before = self.trace.counts()
        res = self._solve(f1, f2)
        host = tuple(t.cpu().numpy() for t in (res.u, res.v, res.m))
        after = self.trace.counts()
        counters = {k: after.get(n, 0) - before.get(n, 0)
                    for k, n in COUNTERS.items()}
        counters.update(final_ab=int(res.iterations_ab),
                        final_aa=int(res.iterations_aa))
        return [(host, counters)]


def control(config, f1, f2):
    """The reference's ``auto`` in the program's place, one precision step
    below the configuration's (``config["control"]``: float32 data, TF32
    products in the matmul softmin, bfloat16 exponent sums in the exact
    one): its own stops and its fields, as the program's call gives
    them."""
    low = config["control"]
    dtype = getattr(torch, low["dtype"])
    out = ref.solve_auto(f1.to(dtype), f2.to(dtype), config["epsilon"],
                         tf32=low["tf32"], bf16_sums=low["bf16_sums"],
                         **_params(config))
    host = tuple(t.float().cpu().numpy() for t in (out.u, out.v, out.m))
    return host, {COUNTER: out.iters_ab + out.iters_aa,
                  "final_ab": out.iters_ab, "final_aa": out.iters_aa,
                  "escalated": int(out.stabilizer == "exact")}


def check(config, sample, device):
    """Numbers of the comparison over ``sample`` [(pair, (u, v, m),
    counters)]: each pair's float64 reference, the a->b and the a->a
    solves each with every rung to its own stop and the final stage read
    at the program's own count of that solve.

    ``flow_gap_px``: the largest |u| or |v| gap; ``m_gap``: the largest
    |m| gap; ``field_rel``: the largest relative L2 gap of u, v or m;
    ``stop_miss``: the most by which the float64 marginal error at the
    program's count misses tol (0 at max_it: a stop the tolerance does not
    call for, as a loosened tol or a cut max_it makes); each the worst
    over the sample."""
    out = dict(field_rel=0.0, flow_gap_px=0.0, lum_gap=0.0, stop_miss=0.0)
    kw = _params(config)
    for pair, fields, counters in sample:
        a, b = (torch.as_tensor(f, dtype=torch.float64, device=device)
                for f in (pair.f1, pair.f2))
        runs = [ref.solve(a, t, config["epsilon"], read_at=max(k, 1), **kw)
                for t, k in ((b, counters["final_ab"]),
                             (a, counters["final_aa"]))]
        want = [t.cpu().numpy() for t in ref.fields(
            a / a.sum(), runs[0].g, runs[1].g, config["epsilon"],
            config["support_floor"])]
        common.field_gaps(out, fields, want)
        for run in runs:
            out["stop_miss"] = common.worst(out["stop_miss"], ref.stop_miss(
                run.error, run.iters, config["tol"], config["max_it"]))
    out["m_gap"] = out.pop("lum_gap")
    return out
