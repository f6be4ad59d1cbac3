"""Unbalanced OT (WFR) vs balanced FOTO on a brightness-changing scene.

A moving blob that also BRIGHTENS 40%.  Balanced OT must explain the
brightening as mass transported from elsewhere; WFR routes it to the
source/growth channel and reconstructs with the composed luminosity
``1+m = (1+g)(1+m_div)``.  WFR's stepA set is the one ``auto`` resolves
to: ``dct`` on the CPU, as the JAX example runs, and ``pallas`` on the
card, one launch of the fused stepB/stepC/criterion kernel an iteration.
The twin of the JAX package's ``examples/unbalanced_flow.py``.

Run: python -m ofot_tpu_torch.examples.unbalanced_flow [--platform cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ofot_tpu_torch.examples import parse
from ofot_tpu_torch.solvers import foto, wfr
from ofot_tpu_torch.utils import metrics, warp


def main(argv=None) -> dict:
    dev = parse(argv, __doc__).device

    ny, nx, shift, gain = 48, 64, 3.0, 1.4
    y, x = np.mgrid[0:ny, 0:nx].astype(np.float32)

    def blob(cy, cx):
        return np.exp(-(((y - cy) / 6.0) ** 2 + ((x - cx) / 6.0) ** 2))

    f1 = 0.5 * blob(ny / 2, nx / 2 - shift / 2)
    f2 = 0.5 * gain * blob(ny / 2, nx / 2 + shift / 2)   # moved AND brighter
    a, b = torch.as_tensor(f1, device=dev), torch.as_tensor(f2, device=dev)
    out = {}

    def report(name, key, u, v, m):
        rec = np.clip(warp.apply_flow(a, u, v, m).cpu().numpy(), 0, 1)
        ie = metrics.IE(nx, ny, rec, f2)
        mean_u = float(u.abs().mean())
        print(f"  {name:<28} IE = {ie:6.3f}   mean|u| = {mean_u:.3f}")
        out.update({f"{key}_IE": ie, f"{key}_mean_u": mean_u})

    print(f"== blob shifted {shift} px and brightened x{gain} ==")
    fr = foto.solve(a, b, 8, r=1.0, reg_epsilon=1e-2, convergence_tol=0.01,
                    max_it=150, ops=foto.DCT_OPS, admm_alpha=1.7,
                    auto_r=True)
    report("FOTO (balanced)", "foto", fr.u, fr.v, fr.m)

    # WFR's stepA set as the port's CLI resolves ``auto``: ``dct`` on the
    # CPU (the JAX example's default set), ``pallas`` on the card
    wr = wfr.solve(a, b, 8, delta=5.0, r=1.0, reg_epsilon=1e-2,
                   convergence_tol=0.01, max_it=150, admm_alpha=1.7,
                   auto_r=True, ops=foto.stepA_ops(
                       wfr.resolve_stepA_solver("auto", dev)))
    m_combined = wfr.combined_luminosity(wr.m, wr.growth)
    report("WFR (growth + dilution m)", "wfr", wr.u, wr.v, m_combined)
    out.update(foto_iterations=int(fr.state.iteration),
               wfr_iterations=int(wr.state.iteration),
               created=float(wfr.total_created_mass(wr.state, 5.0)),
               true_gain=float(f2.sum() - f1.sum()),
               peak_growth=float(wr.growth.max()))
    print(f"  WFR created mass = {out['created']:.4f} "
          f"(true mass gain = {out['true_gain']:.4f}); "
          f"peak growth = {out['peak_growth']:.2f} "
          f"(true brightening - 1 = {gain - 1:.2f})")
    return out


if __name__ == "__main__":
    main()
