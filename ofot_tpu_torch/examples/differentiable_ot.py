"""Differentiable OT values: torch.autograd through the Sinkhorn divergence.

The converged dual potentials ARE the density gradients (envelope
theorem, solvers/otgrad.py) — no differentiation through the iteration,
zero backward cost.  Here: one value-and-gradient call and two
mirror-descent steps moving a blob toward its target.  The twin of the
JAX package's ``examples/differentiable_ot.py``, with ``torch.autograd``
through ``otgrad``'s ``autograd.Function`` where JAX calls
``jax.value_and_grad``.

Run: python -m ofot_tpu_torch.examples.differentiable_ot [--platform cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ofot_tpu_torch.examples import parse
from ofot_tpu_torch.solvers import otgrad


def main(argv=None) -> dict:
    dev = parse(argv, __doc__).device

    n = 40
    y, x = np.mgrid[0:n, 0:n].astype(np.float64)

    def blob(cy, cx):
        return np.exp(-((y - cy) ** 2 + (x - cx) ** 2) / 22) + 1e-4

    a = torch.as_tensor(blob(14, 14).astype(np.float32), device=dev)
    b = torch.as_tensor(blob(26, 23).astype(np.float32), device=dev)
    kw = (("max_iter", 600), ("tol", 1e-6))
    S = otgrad.sinkhorn_divergence_dual

    val, g = otgrad.value_and_grad(S, a, b, 4.0, kw)
    out = dict(S=float(val), grad_min=float(g.min()),
               grad_max=float(g.max()), steps=[])
    print(f"S(a, b) = {out['S']:.4f}   sqrt = {float(torch.sqrt(val)):.3f} "
          f"px (true W2 of the (12, 9) shift = 15.0)")

    # (central-difference validation lives in
    # tests/test_torch_otgrad_implicit.py, in f64 — FD at f32 would be
    # rounding noise at any usable step size)
    print(f"grad field: shape {tuple(g.shape)}, range "
          f"[{out['grad_min']:+.3f}, {out['grad_max']:+.3f}]")

    # two mirror-descent steps (mass-conserving, positivity-preserving)
    mass = float(torch.sum(a))
    for t in range(2):
        if t:      # step 0 reuses the (val, g) already computed above
            val, g = otgrad.value_and_grad(S, a, b, 4.0, kw)
        a = a * torch.exp(-0.6 * g / torch.max(torch.abs(g)))
        a = a * mass / torch.sum(a)
        out["steps"].append(float(val))
        print(f"descent step {t}: S = {float(val):.4f}")
    out["after"] = float(S(a, b, 4.0, kw))
    print(f"after: S = {out['after']:.4f}")
    return out


if __name__ == "__main__":
    main()
