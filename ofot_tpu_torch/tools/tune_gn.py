"""Gradient-tune GN's (alpha, lambda) against ground-truth EPE.

The differentiable layer end to end: the GN solve is differentiated
IMPLICITLY (``solvers/implicit.py``: one extra CG solve for the adjoint
instead of backprop through hundreds of iterations), and Adam
(``torch.optim.Adam``, optax's defaults) steps (log alpha, log lambda)
over a Middlebury-2 layout of frames and ``.flo`` ground truth.  The twin
of the JAX package's ``tools/tune_gn.py``: the same flags, lines and
float64 arithmetic; sequences are grouped by shape as there, and each
group's pairs solve one after another where JAX vmaps them.

    python -m ofot_tpu_torch.tools.tune_gn [--steps 40] [--data-root data]
        [--platform cpu]

Prints the default-parameter EE (alpha=0.1, lambda=0.2 — the reference's
canonical values) vs the tuned EE, both computed with the benchmark's own
EE metric (outlier-dropping, ``utils/metrics.py``) for comparability.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ofot_tpu_torch.parallel.sweep import torch_device
from ofot_tpu_torch.solvers.implicit import gn_solve_implicit
from ofot_tpu_torch.utils import flo, image, metrics


def load_groups(root: str, device):
    """The sequences of ``root`` that have a ground truth, grouped by
    frame shape -> (names in order, groups)."""
    seq_root = os.path.join(root, "other-data-gray")
    by_shape: dict = {}
    names = []
    for name in sorted(os.listdir(seq_root)):
        gt = os.path.join(root, "other-gt-flow", name, "flow10.flo")
        if not os.path.isfile(gt):
            continue
        f1, w, h = image.open_grayscale(
            os.path.join(seq_root, name, "frame10.png"))
        f2, _, _ = image.open_grayscale(
            os.path.join(seq_root, name, "frame11.png"))
        _, _, uGT, vGT = flo.read_flo(gt)
        names.append(name)
        by_shape.setdefault((h, w), []).append(
            (name, f1.reshape(h, w), f2.reshape(h, w),
             np.stack([uGT.reshape(h, w), vGT.reshape(h, w)])))
    groups = []
    for (h, w), items in sorted(by_shape.items()):
        gts = torch.as_tensor(np.stack([g for _, _, _, g in items]),
                              dtype=torch.float64, device=device)
        groups.append(dict(
            names=[n for n, _, _, _ in items], h=h, w=w,
            f1s=torch.as_tensor(np.stack([a for _, a, _, _ in items]),
                                device=device),
            f2s=torch.as_tensor(np.stack([b for _, _, b, _ in items]),
                                device=device),
            gts=gts,
            # unknown-flow pixels (sentinel >= 1e9) excluded from the loss
            valid=torch.all(gts.abs() < 1e9, dim=1)))
    return names, groups


def solve(g, alpha, lambda_):
    """The group's flows, (B, 3, Ny, Nx), pair by pair."""
    return torch.stack([gn_solve_implicit(a, b, alpha, lambda_, rtol=1e-8,
                                          maxiter=4000)
                        for a, b in zip(g["f1s"], g["f2s"])])


def smooth_epe(groups, log_alpha, log_lambda):
    """Differentiable surrogate of the EE benchmark metric: mean
    sqrt(|flow - gt|^2 + eps) over valid pixels across all shape groups
    (the benchmark's outlier drop is non-differentiable; outliers this
    size do not occur on these pairs)."""
    tot = cnt = 0.0
    for g in groups:
        x = solve(g, torch.exp(log_alpha), torch.exp(log_lambda))
        d2 = ((x[:, 0] - g["gts"][:, 0]) ** 2
              + (x[:, 1] - g["gts"][:, 1]) ** 2)
        epe = torch.sqrt(d2 + 1e-12)
        tot = tot + torch.sum(torch.where(g["valid"], epe, 0.0))
        cnt = cnt + torch.sum(g["valid"])
    return tot / cnt


def benchmark_ee(groups, names, alpha, lambda_):
    """The real (outlier-dropping) EE metric, per sequence, in the global
    ``names`` order."""
    ees = {}
    with torch.no_grad():
        for g in groups:
            x = solve(g, float(alpha), float(lambda_)).cpu().numpy()
            gts = g["gts"].cpu().numpy()
            for i, n in enumerate(g["names"]):
                ee, _ = metrics.EE(g["w"], g["h"], x[i, 0].ravel(),
                                   x[i, 1].ravel(), gts[i, 0].ravel(),
                                   gts[i, 1].ravel())
                ees[n] = ee
    return [ees[n] for n in names]


def tune(groups, names, steps: int, lr: float, device) -> dict:
    """Adam on (log alpha, log lambda) from the reference defaults, then
    the EE table -> the tuned parameters, the losses and both EE lists."""
    theta = torch.tensor([np.log(0.1), np.log(0.2)], dtype=torch.float64,
                         device=device, requires_grad=True)
    opt = torch.optim.Adam([theta], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    losses = []
    t0 = time.time()
    for step in range(steps):
        opt.zero_grad()
        loss = smooth_epe(groups, theta[0], theta[1])
        loss.backward()
        g = theta.grad.detach().clone()
        opt.step()
        losses.append(float(loss.detach()))
        if step % 5 == 0 or step == steps - 1:
            a, l = np.exp(theta.detach().cpu().numpy())
            print(f"step {step:3d}  epe {losses[-1]:.5f}  "
                  f"alpha {a:.5f}  lambda {l:.5f}  "
                  f"|g| {float(g.abs().max()):.3g}", file=sys.stderr)
    a_t, l_t = (float(v) for v in np.exp(theta.detach().cpu().numpy()))
    tuned_s = time.time() - t0
    print(f"tuned in {tuned_s:.1f}s", file=sys.stderr)
    return dict(alpha=a_t, lambda_=l_t, losses=losses, tuned_s=tuned_s,
                ee_default=benchmark_ee(groups, names, 0.1, 0.2),
                ee_tuned=benchmark_ee(groups, names, a_t, l_t))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    p.add_argument("--data-root", default="data")
    p.add_argument("--dataset", default="middlebury-2")
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--lr", type=float, default=0.15)
    p.add_argument("--platform", choices=["cuda", "cpu"], default="cuda",
                   help="torch device to run on (default cuda; no card "
                        "raises); the solves run at float64 on either, "
                        "as the implicit adjoint's rtol=1e-8 CG wants")
    args = p.parse_args(argv)
    device = torch_device(args.platform)

    names, groups = load_groups(os.path.join(args.data_root, args.dataset),
                                device)
    if not names:
        print("no ground-truth sequences found", file=sys.stderr)
        return 1
    print(f"{len(names)} sequences in {len(groups)} shape group(s): "
          f"{', '.join(names)}", file=sys.stderr)

    report(names, tune(groups, names, args.steps, args.lr, device))
    return 0


def report(names, res: dict) -> None:
    """The EE table of :func:`tune`'s result, default against tuned."""
    a_t, l_t = res["alpha"], res["lambda_"]
    print(f"{'sequence':<12} {'EE default(0.1,0.2)':>20} "
          f"{'EE tuned({:.4f},{:.4f})'.format(a_t, l_t):>24}")
    for n, d, t in zip(names, res["ee_default"], res["ee_tuned"]):
        print(f"{n:<12} {d:>20.4f} {t:>24.4f}")
    print(f"{'MEAN':<12} {np.mean(res['ee_default']):>20.4f} "
          f"{np.mean(res['ee_tuned']):>24.4f}")


if __name__ == "__main__":
    sys.exit(main())
