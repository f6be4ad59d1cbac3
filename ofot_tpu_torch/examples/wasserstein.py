"""Wasserstein-2 distances three ways (the reference solver computes the
underlying objects but never exposes a distance):

  1. dynamic  — FOTO/Benamou-Brenier kinetic action -> foto.wasserstein2
  2. entropic — debiased Sinkhorn divergence ->
     sinkhorn.wasserstein2_entropic
  3. exact    — the known closed form for a pure translation (= the shift)

The twin of the JAX package's ``examples/wasserstein.py``.

Run: python -m ofot_tpu_torch.examples.wasserstein [--platform cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ofot_tpu_torch.examples import parse
from ofot_tpu_torch.solvers import foto, sinkhorn


def main(argv=None) -> dict:
    dev = parse(argv, __doc__).device

    # unit-mass Gaussian blob translated by 4 px: W2 == 4 exactly
    ny = nx = 48
    shift = 4.0
    y, x = np.mgrid[0:ny, 0:nx].astype(np.float32)

    def blob(cy, cx):
        return np.exp(-(((y - cy) / 6.0) ** 2 + ((x - cx) / 6.0) ** 2))

    a = blob(24, 22)
    b = blob(24, 22 + shift)
    a, b = a / a.sum(), b / b.sum()

    print("== dynamic W2 (Benamou-Brenier ALG2) ==")
    s = max(a.max(), b.max())
    st, _ = foto.solve_potential_with_history(
        torch.as_tensor(a / s, device=dev),
        torch.as_tensor(b / s, device=dev), 8, 300,
        r=0.1, reg_epsilon=1e-3, ops=foto.DCT_OPS)
    w2_dyn = float(foto.wasserstein2(st))
    print(f"  W2 = {w2_dyn:.4f} px   (kinetic action over the "
          f"transport path)")

    print("== entropic W2 (debiased Sinkhorn, static OT) ==")
    res = sinkhorn.wasserstein2_entropic(
        torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev),
        epsilon=2.0, max_iter=2000, full=True)
    out = dict(dynamic=w2_dyn, entropic=float(res.value),
               marginal_error=float(res.marginal_error),
               iterations=int(res.iterations))
    print(f"  W2 = {out['entropic']:.4f} px   "
          f"(marginal_error={out['marginal_error']:.2e}, "
          f"{out['iterations']} iterations)")

    print(f"== ground truth ==\n  W2 = {shift:.4f} px (pure translation)")
    for name in ("dynamic", "entropic"):
        err = abs(out[name] - shift) / shift
        print(f"  {name}: relative error {err:.2%}")
    return out


if __name__ == "__main__":
    main()
