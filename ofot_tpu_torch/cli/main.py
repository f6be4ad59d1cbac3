"""CLI entry point of the PyTorch/CUDA port.

The parser is ``ofot_tpu.cli.main.build_parser()``'s, so run scripts
written for the reference or the JAX package work unchanged, including
``--lambda=...`` resolving to ``--lambdaa`` via argparse prefix matching
(SURVEY.md §2 quirk 4).  ``--platform`` picks the torch device, ``cuda``
(default) or ``cpu``; without a card, ``cuda`` raises instead of falling
back.

The port runs:

  * ``--algo=foto`` and ``--algo=WFR`` with every stepA solver (``cg``,
    ``dct``, ``dct-refined``, ``pallas``, ``dct-fused``, ``cg-pallas`` and
    ``auto``), ``--checkpoint`` and ``--resume``;
  * ``--algo=GN`` and ``--algo=HS`` (m = 0), each single-level or
    coarse-to-fine with ``--pyramid-levels > 1``.  They run no CUDA kernel,
    so ``--precision=f64`` works on cuda too.

``--algo=sinkhorn`` and the JAX-only outputs (``--profile``,
``--log-jsonl``, ``--save-flow-viz``, ``--save-density-frames``) exit
with code 2 and name the slice that brings them.  After the solve the CLI
prints a ``solver:`` line and the launches of every CUDA kernel on one
``kernel_launches=`` line.

Usage:  python -m ofot_tpu_torch.cli.main f0.pgm f1.pgm --algo=foto --Nt=16 ...
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="sample argument parser")
    p.add_argument("f0", help="first frame")
    p.add_argument("f1", help="second frame")
    p.add_argument("--out", nargs="?", help="optical flow output")
    p.add_argument("--ground-truth", nargs="?", help="optical flow ground truth")
    p.add_argument("--save-benchmark", nargs="?", help="file output of benchmark")
    p.add_argument("--save-reconstruction", nargs="?",
                   help="file output of reconstruction")
    p.add_argument("--save-lum", nargs="?", help="file output of luminosity")
    # Model parameters (reference defaults)
    p.add_argument("--algo", nargs="?", help="Algorithm")
    p.add_argument("--Nt", nargs="?", type=int, default=4,
                   help="Discretization in time")
    p.add_argument("--r", nargs="?", type=float, default=1.0,
                   help="augmented langrangian parameter")
    p.add_argument("--convergence-tol", nargs="?", type=float, default=0.1,
                   help="Stopping threshold")
    p.add_argument("--reg-epsilon", nargs="?", type=float, default=1e-3,
                   help="Regularization for the step 1 of Benamou-Brenier")
    p.add_argument("--max-it", nargs="?", type=int, default=100,
                   help="Maximal number of iteration")
    p.add_argument("--normalize", action=argparse.BooleanOptionalAction,
                   help="normalize the input images if enabled")
    p.add_argument("--alpha", nargs="?", type=float, default=0.1,
                   help="Horn-Schunck alpha")
    p.add_argument("--lambdaa", nargs="?", type=float, default=0.2,
                   help="Horn-Schunck lambda")
    # --- framework extensions (the JAX CLI's surface) ---
    p.add_argument("--precision", choices=["f32", "f64"], default="f32",
                   help="compute precision")
    p.add_argument("--platform", choices=["cuda", "cpu"], default="cuda",
                   help="torch device to run on (default cuda)")
    p.add_argument("--save-flow-viz", nargs="?",
                   help="Middlebury color-wheel PNG of the flow (not ported)")
    p.add_argument("--checkpoint", nargs="?",
                   help="save final FOTO/WFR solver state here (.npz)")
    p.add_argument("--resume", nargs="?",
                   help="resume FOTO/WFR from a saved state (.npz)")
    p.add_argument("--profile", nargs="?",
                   help="profiler trace directory (not ported)")
    p.add_argument("--quiet", action="store_true",
                   help="suppress per-iteration solver prints")
    p.add_argument("--stepA-solver",
                   choices=["cg", "dct", "dct-refined", "pallas",
                            "dct-fused", "cg-pallas", "auto"],
                   default="auto",
                   help="stepA backend: cg = reference-faithful "
                        "iterative solve; dct = exact spectral solve; "
                        "dct-refined = TF32 spectral solve (on cuda) + 3 "
                        "steps of fp32 iterative refinement; pallas = dct + the fused stepB/stepC/criterion "
                        "CUDA kernel; dct-fused = dct with the per-slice "
                        "transforms in a CUDA kernel; cg-pallas = cg with "
                        "the operator in a CUDA kernel; auto (default) = "
                        "pallas on cuda, cg (foto) or dct (WFR) on cpu")
    p.add_argument("--admm-alpha", type=float, default=1.0,
                   help="ADMM over-relaxation factor for FOTO (1.0 = exact "
                        "reference iteration; 1.5-1.8 typically converges "
                        "in fewer iterations to the same fixed point)")
    p.add_argument("--log-jsonl", nargs="?",
                   help="structured solver-summary log (not ported)")
    p.add_argument("--wfr-delta", type=float, default=10.0,
                   help="WFR transport/growth trade-off length (--algo=WFR)")
    p.add_argument("--auto-r", action="store_true",
                   help="rescale the ADMM penalty r to the data scale "
                        "(r * max density)")
    p.add_argument("--sinkhorn-epsilon", type=float, default=4.0,
                   help="entropic regularization (--algo=sinkhorn)")
    p.add_argument("--sinkhorn-tol", type=float, default=1e-4,
                   help="marginal tolerance (--algo=sinkhorn)")
    p.add_argument("--pyramid-levels", type=int, default=1,
                   help="coarse-to-fine levels (--algo=GN/HS)")
    p.add_argument("--sinkhorn-stabilizer",
                   choices=["auto", "matmul", "exact"], default="auto",
                   help="softmin stabilization (--algo=sinkhorn)")
    p.add_argument("--sinkhorn-theta", type=float, default=1.0,
                   help="Sinkhorn over-relaxation (--algo=sinkhorn)")
    p.add_argument("--save-growth", nargs="?",
                   help="file output of the WFR growth field")
    p.add_argument("--save-density-frames", nargs="?",
                   help="directory for the density trajectory (not ported)")
    return p


# outputs of the JAX CLI that this slice does not produce, and where they go
_NOT_PORTED_FLAGS = {
    "profile": "--profile (a later slice maps it to torch.profiler)",
    "log_jsonl": "--log-jsonl (the trace/logging slice of the port)",
    "save_flow_viz": "--save-flow-viz (the colorwheel slice of the port)",
    "save_density_frames": "--save-density-frames (the trace/logging "
                           "slice of the port)",
}
_LATER_ALGOS = {"sinkhorn": "the Sinkhorn slice"}
# stepA sets that run a float32-only CUDA kernel on cuda
_FLOAT32_KERNEL_SETS = ("pallas", "dct-fused", "cg-pallas")


def _device(platform: str) -> torch.device:
    if platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--platform=cuda (the default) but torch sees no "
                           "CUDA device; pass --platform=cpu to run on the "
                           "CPU")
    return torch.device(platform)


def _print_launches(kernels, before) -> None:
    launched = kernels.launch_counts()
    print("kernel_launches=" + ",".join(
        f"{k}:{launched[k] - before[k]}" for k in launched))


def _print_header(args) -> None:
    names = {"foto": "FOTO", "WFR": "WFR (unbalanced optimal transport)"}
    print(f" - algorithm: {names.get(args.algo, args.algo)}")
    if args.algo in ("GN", "HS"):
        print(f"\t - alpha={args.alpha}")
        if args.algo == "GN":
            print(f"\t - lambda={args.lambdaa}")
        if args.pyramid_levels > 1:
            print(f"\t - pyramid_levels={args.pyramid_levels}")
        return
    print(f"\t - Nt={args.Nt}")
    print(f"\t - r={args.r}")
    if args.algo == "WFR":
        print(f"\t - delta={args.wfr_delta}")
    print(f"\t - convergence_tol={args.convergence_tol}")
    print(f"\t - reg_epsilon={args.reg_epsilon}")
    print(f"\t - max_it={args.max_it}")


def _solve_ot(args, rho1_d, rho2_d, ops):
    """The FOTO and WFR solves -> (result, m): the luminosity slot of WFR
    composes the growth the source term modelled with the advective
    dilution correction -div(u, v)."""
    from ofot_tpu_torch.solvers import foto, wfr
    from ofot_tpu_torch.utils import checkpoint

    init = (checkpoint.load_state(args.resume, rho1_d.device, rho1_d.dtype)
            if args.resume else None)
    common = dict(r=args.r, convergence_tol=args.convergence_tol,
                  reg_epsilon=args.reg_epsilon, max_it=args.max_it,
                  verbose=not args.quiet, init=init, ops=ops,
                  admm_alpha=args.admm_alpha, auto_r=args.auto_r)
    if args.algo == "foto":
        result = foto.solve(rho1_d, rho2_d, args.Nt, **common)
        return result, result.m
    result = wfr.solve(rho1_d, rho2_d, args.Nt, delta=args.wfr_delta,
                       **common)
    return result, result.m_combined


def _report_ot(args, result, solver, w, h) -> None:
    """After the timed solve: the solver line, W2 or the WFR distance, the
    checkpoint and the growth field."""
    from ofot_tpu_torch.solvers import foto, wfr
    from ofot_tpu_torch.utils import checkpoint, image

    state = result.state
    print(f"solver: iterations={state.iteration} "
          f"inner_iterations={state.cg_iterations} "
          f"crit={float(state.crit)} stepA_solver={solver}")
    if not args.quiet and args.algo == "foto":
        w2 = float(foto.wasserstein2(state))
        print(f"W2(rho0, rhoT) = {w2:.6g} px")
    elif not args.quiet:
        dist = float(wfr.wfr_distance(state))
        created = float(wfr.total_created_mass(state, args.wfr_delta))
        print(f"WFR(rho0, rhoT) = {dist:.6g} px, "
              f"created mass = {created:.6g}")
    if args.checkpoint:
        checkpoint.save_state(args.checkpoint, state)
    if args.algo == "WFR" and args.save_growth:
        growth = result.growth.cpu().numpy()
        image.save_grayscale(np.clip((growth + 1) / 2, 0, 1).reshape(h, w),
                             args.save_growth)


def _solve_variational(args, rho1_d, rho2_d):
    """The GN and HS solves -> (u, v, m, solver line); m = 0 for HS.  With
    ``--pyramid-levels > 1`` the coarse-to-fine solve: the linearized
    solvers only capture a few px of motion, so the pyramid solves
    residual flows at halved scales (for GN, m is solved at the finest
    level around the final warp)."""
    from ofot_tpu_torch.solvers import gn, hs, pyramid

    if args.pyramid_levels > 1:
        steps = []
        if args.algo == "GN":
            u, v, m = pyramid.solve_gn_pyramid(
                rho1_d, rho2_d, args.alpha, args.lambdaa,
                levels=args.pyramid_levels, cg_log=steps)
        else:
            u, v = pyramid.solve_hs_pyramid(
                rho1_d, rho2_d, args.alpha, levels=args.pyramid_levels,
                cg_log=steps)
            m = torch.zeros_like(u)
        return u, v, m, (
            f"pyramid_levels={args.pyramid_levels} "
            f"inner_iterations={sum(r.iterations for r in steps)} "
            f"converged={all(r.converged for r in steps)}")
    if args.algo == "GN":
        res = gn.solve_fields(rho1_d, rho2_d, args.alpha, args.lambdaa)
        m = res.m
    else:
        res = hs.solve_fields(rho1_d, rho2_d, args.alpha)
        m = torch.zeros_like(res.u)
    return res.u, res.v, m, (
        f"inner_iterations={res.cg.iterations} "
        f"residual={float(res.cg.residual)} converged={res.cg.converged}")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    for attr, what in _NOT_PORTED_FLAGS.items():
        if getattr(args, attr):
            print(f"ERROR: {what} is not ported yet", file=sys.stderr)
            return 2
    if args.algo not in ("foto", "WFR", "GN", "HS"):
        later = _LATER_ALGOS.get(args.algo)
        if later is None:
            print(f"ERROR: unknown --algo '{args.algo}' (expected foto, GN, "
                  "HS, WFR, or sinkhorn)", file=sys.stderr)
        else:
            print(f"ERROR: --algo={args.algo} is not ported yet; {later} "
                  "brings it", file=sys.stderr)
        return 2

    from ofot_tpu_torch.ops import kernels
    from ofot_tpu_torch.solvers import foto, wfr
    from ofot_tpu_torch.utils import flo, image, metrics, warp

    ot = args.algo in ("foto", "WFR")
    if ot:
        resolve = (foto.resolve_stepA_solver if args.algo == "foto"
                   else wfr.resolve_stepA_solver)
        solver = resolve(args.stepA_solver, args.platform)
        ops = foto.stepA_ops(solver)
        if solver in _FLOAT32_KERNEL_SETS and args.platform == "cuda" \
                and args.precision == "f64":
            print(f"ERROR: the {solver} stepA set runs a CUDA kernel that "
                  "is float32 only; use --precision=f32, another "
                  "--stepA-solver, or --platform=cpu", file=sys.stderr)
            return 2

    device = _device(args.platform)
    dtype = torch.float64 if args.precision == "f64" else torch.float32

    f1, w, h = image.open_grayscale(args.f0)
    f2, w, h = image.open_grayscale(args.f1)

    print("***********************************")
    print("Input images: ")
    print(" - f0 = " + str(args.f0) + " / total mass = " + str(np.sum(f1)))
    print(" - f1 = " + str(args.f1) + " / total mass = " + str(np.sum(f2)))
    if args.normalize is True:
        print(" - normalize input images")
        rho1, rho2 = image.mass_normalize(f1, f2)
    else:
        rho1 = f1
        rho2 = f2

    rho1_d = torch.as_tensor(rho1, dtype=dtype, device=device)
    rho2_d = torch.as_tensor(rho2, dtype=dtype, device=device)

    _print_header(args)
    launches_before = kernels.launch_counts()
    start_time = time.time()
    if ot:
        result, m_d = _solve_ot(args, rho1_d, rho2_d, ops)
        u_d, v_d = result.u, result.v
    else:
        u_d, v_d, m_d, stats = _solve_variational(args, rho1_d, rho2_d)
    u, v, m = u_d.cpu().numpy(), v_d.cpu().numpy(), m_d.cpu().numpy()
    solve_end = time.time()
    if ot:
        _report_ot(args, result, solver, w, h)
    else:
        print("solver: " + stats)
    _print_launches(kernels, launches_before)
    timer = solve_end - start_time

    # Benchmark (reference main.py:107-134)
    print("Benchmark:")
    rec = warp.apply_flow(torch.as_tensor(f1, dtype=dtype, device=device),
                          u_d, v_d, m_d).cpu().numpy()
    rec = np.clip(rec, 0, 1)
    IE = metrics.IE(w, h, rec, f2)
    print(" - time: " + str(timer) + "s")
    print(" - IE: " + str(IE))

    if args.ground_truth:
        wGT, hGT, uGT, vGT = flo.read_flo(args.ground_truth)
        if (wGT, hGT) != (w, h):
            raise ValueError(f"ground truth is {wGT}x{hGT}, frames {w}x{h}")
        AEE, SDEE = metrics.EE(w, h, u.ravel(), v.ravel(), uGT, vGT)
        AAE, SDAE = metrics.AE(w, h, u.ravel(), v.ravel(), uGT, vGT)
        print(" - EE-mean: " + str(AEE))
        print(" - EE-stddev: " + str(SDEE))
        print(" - AE-mean: " + str(AAE))
        print(" - AE-stddev: " + str(SDAE))

    if args.save_benchmark:
        with open(args.save_benchmark, "w") as f:
            if args.ground_truth:
                f.write("EE-mean: " + str(AEE) + "\n")
                f.write("EE-stddev: " + str(SDEE) + "\n")
                f.write("AE-mean: " + str(AAE) + "\n")
                f.write("AE-stddev: " + str(SDAE) + "\n")
            f.write("IE: " + str(IE) + "\n")
            f.write("time: " + str(timer) + "s")

    if args.out:
        print("saving flo file...")
        flo.write_flo(w, h, u.ravel(), v.ravel(), args.out)

    if args.save_reconstruction:
        print("saving reconstruction...")
        image.save_grayscale(rec.reshape(h, w), args.save_reconstruction)

    if args.save_lum:
        print("saving luminosity...")
        image.save_grayscale(((m + 1) / 2).reshape(h, w), args.save_lum)

    print("***********************************")
    return 0


if __name__ == "__main__":
    sys.exit(main())
