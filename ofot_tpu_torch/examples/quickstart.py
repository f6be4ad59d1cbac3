"""Quickstart: solve a synthetic pair with both solvers and inspect results.

A bright square moved by 4 pixels, solved by FOTO with the spectral stepA
set (``foto.DCT_OPS``) and by GN, each flow warped back onto the second
frame and scored by IE.  The twin of the JAX package's
``examples/quickstart.py``.

Run: python -m ofot_tpu_torch.examples.quickstart [--platform cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ofot_tpu_torch.examples import parse
from ofot_tpu_torch.solvers import foto, gn
from ofot_tpu_torch.utils import metrics, warp


def main(argv=None) -> dict:
    dev = parse(argv, __doc__).device

    # a bright square translating by 4 pixels
    n = 48
    f1 = np.zeros((n, n), np.float32)
    f2 = np.zeros((n, n), np.float32)
    f1[8:24, 8:24] = 1.0
    f2[12:28, 12:28] = 1.0
    a, b = torch.as_tensor(f1, device=dev), torch.as_tensor(f2, device=dev)

    print("== FOTO (Benamou-Brenier optimal transport) ==")
    res = foto.solve(a, b, Nt=8, r=1.0, convergence_tol=0.05,
                     reg_epsilon=1e-2, max_it=60, ops=foto.DCT_OPS)
    rec = np.clip(warp.apply_flow(a, res.u, res.v, res.m).cpu().numpy(),
                  0, 1)
    out = dict(foto_iterations=int(res.state.iteration),
               foto_crit=float(res.state.crit),
               foto_IE=metrics.IE(n, n, rec, f2),
               foto_mean_u=float(res.u.abs().mean()))
    print(f"  iterations={out['foto_iterations']} "
          f"crit={out['foto_crit']:.4f} "
          f"IE={out['foto_IE']:.3f} "
          f"mean|u|={out['foto_mean_u']:.2f}")

    print("== GN (Gennert-Negahdaripour variational) ==")
    r = gn.solve_fields(a, b, 0.1, 0.2)
    rec = np.clip(warp.apply_flow(a, r.u, r.v, r.m).cpu().numpy(), 0, 1)
    out.update(gn_cg_iterations=int(r.cg.iterations),
               gn_IE=metrics.IE(n, n, rec, f2))
    print(f"  cg_iterations={out['gn_cg_iterations']} "
          f"IE={out['gn_IE']:.3f}")
    return out


if __name__ == "__main__":
    main()
