"""W2 gradient-flow demo: morph a density toward a target by descending
the differentiable Sinkhorn divergence (``solvers/otgrad.py``).

Mirror descent keeps the density positive and mass-conserving:
    a <- a * exp(-eta * dS/da),  renormalized to the original mass.
Each step costs three annealed Sinkhorn solves forward and NOTHING
backward (envelope gradients from the converged dual potentials, through
``otgrad``'s ``torch.autograd.Function``).  The twin of the JAX package's
``tools/w2_gradient_flow.py``.

Run:  python -m ofot_tpu_torch.tools.w2_gradient_flow [--steps 12]
      [--out-dir DIR] [--platform cpu]
Prints the divergence trajectory (strictly decreasing) and, with
--out-dir, saves the density frames as PNGs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ofot_tpu_torch.parallel.sweep import torch_device
from ofot_tpu_torch.solvers import otgrad


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    p.add_argument("--size", type=int, default=48)
    p.add_argument("--steps", type=int, default=12)
    p.add_argument("--eta", type=float, default=0.6,
                   help="mirror-descent step, applied to the gradient "
                        "normalized by its max magnitude (keeps the "
                        "multiplicative update in a stable range)")
    p.add_argument("--epsilon", type=float, default=4.0)
    p.add_argument("--out-dir")
    p.add_argument("--platform", choices=["cuda", "cpu"], default="cuda",
                   help="torch device to run on (default cuda; no card "
                        "raises)")
    args = p.parse_args(argv)
    device = torch_device(args.platform)

    n = args.size
    y, x = np.mgrid[0:n, 0:n].astype(np.float64)

    def blob(cy, cx, s):
        return np.exp(-((y - cy) ** 2 + (x - cx) ** 2) / s) + 1e-4

    a = torch.tensor(blob(n * 0.3, n * 0.3, 24), dtype=torch.float32,
                     device=device)
    # target: two modes — the flow must split mass, not just translate
    b = torch.tensor(blob(n * 0.7, n * 0.6, 18)
                     + 0.6 * blob(n * 0.35, n * 0.75, 14),
                     dtype=torch.float32, device=device)
    mass = float(torch.sum(a))
    kw = (("max_iter", 800), ("tol", 1e-6))

    traj = []
    frames = [a.cpu().numpy()]
    for t in range(args.steps):
        val, g = otgrad.value_and_grad(otgrad.sinkhorn_divergence_dual, a,
                                       b, args.epsilon, kw)
        traj.append(float(val))
        g = g / torch.max(torch.abs(g))       # scale-free descent direction
        a = a * torch.exp(-args.eta * g)
        a = a * mass / torch.sum(a)
        frames.append(a.cpu().numpy())
        print(f"step {t:2d}: S = {float(val):.5f}", flush=True)
    final = float(otgrad.sinkhorn_divergence_dual(a, b, args.epsilon, kw))
    traj.append(final)
    print(f"final:   S = {final:.5f} "
          f"({traj[0] / max(final, 1e-12):.0f}x reduction)")

    if args.out_dir:
        from ofot_tpu_torch.utils import image
        os.makedirs(args.out_dir, exist_ok=True)
        for i, f in enumerate(frames):
            image.save_grayscale(f / f.max(),
                                 os.path.join(args.out_dir, f"a_{i:02d}.png"))
        bt = b.cpu().numpy()
        image.save_grayscale(bt / bt.max(),
                             os.path.join(args.out_dir, "target.png"))
    print(json.dumps({"tool": "w2_gradient_flow", "steps": args.steps,
                      "S_trajectory": [round(v, 5) for v in traj]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
