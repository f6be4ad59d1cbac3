"""FOTO cells: the port's FOTO solve driven pair by pair
(``ofot_tpu_torch.solvers.foto.solve``) or as a lockstep batch
(``ofot_tpu_torch.parallel.sweep.solve_batch_full(..., batch_mode="vmap")``),
each call ended by the device-to-host copy of (u, v, m); and the check of
its answers against the plain reference (``flowbench/reference/foto.py``).
"""

from __future__ import annotations

import torch

from flowbench.algos import common
from flowbench.reference import foto as ref

COUNTER = "iters"


def _params(config):
    return dict(r=config["r"], convergence_tol=config["convergence_tol"],
                reg_epsilon=config["reg_epsilon"], max_it=config["max_it"],
                admm_alpha=config["admm_alpha"])


class Program:
    """The timed path of a FOTO cell on ``device``."""

    def __init__(self, config, traffic, device):
        from ofot_tpu_torch.solvers import foto
        self.config, self.device = config, device
        self.batch = traffic["batch"]
        self.foto = foto
        self.ops = foto.stepA_ops(foto.resolve_stepA_solver(
            config["stepA_solver"], device))

    def __call__(self, frames):
        """``frames``: [(f1, f2)] device tensors, one pair or a batch ->
        [((u, v, m) numpy, {"iters": n})] per pair."""
        cfg = self.config
        if self.batch == 1:
            (f1, f2), = frames
            res = self.foto.solve(f1, f2, cfg["Nt"], ops=self.ops,
                                  **_params(cfg))
            host = tuple(t.cpu().numpy() for t in (res.u, res.v, res.m))
            return [(host, {COUNTER: int(res.state.iteration)})]
        from ofot_tpu_torch.parallel import sweep
        f1s = torch.stack([f for f, _ in frames])
        f2s = torch.stack([f for _, f in frames])
        params = dict(_params(cfg), Nt=cfg["Nt"],
                      stepA_solver=cfg["stepA_solver"])
        u, v, m, diag = sweep.solve_batch_full(
            "foto", f1s, f2s, foto_params=params, batch_mode="vmap",
            device=self.device)
        u, v, m = (t.cpu().numpy() for t in (u, v, m))
        return [((u[i], v[i], m[i]), {COUNTER: int(diag["iterations"][i])})
                for i in range(len(frames))]


def control(config, f1, f2):
    """The reference in the program's place, one precision step below the
    configuration's (``config["control"]``: float32 data, TF32 products):
    its own stop and its fields, as the program's call gives them."""
    low = config["control"]
    dtype = getattr(torch, low["dtype"])
    run = ref.alg2(f1.to(dtype), f2.to(dtype), config["Nt"],
                   tf32=low["tf32"], **_params(config))
    return (tuple(t.float().cpu().numpy() for t in ref.flow(run.phi_stop)),
            {COUNTER: run.stop})


def check(config, sample, device):
    """Numbers of the comparison over ``sample`` [(pair, (u, v, m),
    counters)]: each pair's reference in float64 runs to its own stop and
    on to the program's iteration count k if that lies beyond.

    ``flow_gap_px``, ``lum_gap``: the largest |u| or |v| and |m| gaps to
    the reference read after k iterations (the iterations and the flow
    extraction); ``field_rel`` the largest relative L2 gap of one field
    there; ``stop_miss``: the most by which the reference's criterion
    misses the stopping rule after k iterations (``ref.stop_miss``: a stop
    the rule does not call for, as a loosened tolerance or a cut max_it
    makes); ``stop_overrun``: the most iterations the program ran past the
    reference's own stop (a pair that went on after its rule fired, as a
    lockstep batch without its per-pair freeze makes); each the worst over
    the sample, each lockstep pair on its own count."""
    out = dict(field_rel=0.0, flow_gap_px=0.0, lum_gap=0.0, stop_miss=0.0,
               stop_overrun=0.0)
    for pair, fields, counters in sample:
        a, b = (torch.as_tensor(f, dtype=torch.float64, device=device)
                for f in (pair.f1, pair.f2))
        k = counters[COUNTER]
        # a pair reported to have run no iteration is read after one
        run = ref.alg2(a, b, config["Nt"], read_at=max(k, 1),
                       **_params(config))
        common.field_gaps(out, fields, [t.cpu().numpy()
                                        for t in ref.flow(run.phi_read)])
        out["stop_miss"] = common.worst(out["stop_miss"], ref.stop_miss(
            run.crits, k, config["convergence_tol"], config["max_it"]))
        out["stop_overrun"] = common.worst(out["stop_overrun"],
                                           float(max(k - run.stop, 0)))
    return out
