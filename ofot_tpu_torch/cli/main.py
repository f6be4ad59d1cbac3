"""CLI entry point of the PyTorch/CUDA port.

The parser is ``ofot_tpu.cli.main.build_parser()``'s, so run scripts
written for the reference or the JAX package work unchanged, including
``--lambda=...`` resolving to ``--lambdaa`` via argparse prefix matching
(SURVEY.md §2 quirk 4).  ``--platform`` picks the torch device, ``cuda``
(default) or ``cpu``; without a card, ``cuda`` raises instead of falling
back.

The port runs everything the JAX CLI runs:

  * ``--algo=foto`` and ``--algo=WFR`` with every stepA solver (``cg``,
    ``dct``, ``dct-refined``, ``pallas``, ``dct-fused``, ``cg-pallas`` and
    ``auto``), ``--checkpoint`` and ``--resume``; FOTO writes its density
    trajectory with ``--save-density-frames``;
  * ``--algo=GN`` and ``--algo=HS`` (m = 0), each single-level or
    coarse-to-fine with ``--pyramid-levels > 1``;
  * ``--algo=sinkhorn``: static entropic OT and its barycentric flow, with
    the ``auto`` stabilizer (matmul softmin first, an exactly-stabilized
    re-solve when the marginal error misses the tolerance);
  * the outputs ``--log-jsonl`` (one ``solve`` record with the JAX CLI's
    keys), ``--profile`` (a torch.profiler trace), ``--save-flow-viz``
    (the Middlebury color wheel as PNG) beside the reference's.

GN, HS and Sinkhorn run no CUDA kernel, so ``--precision=f64`` works on
cuda for them.  After the solve the CLI prints a ``solver:`` line and the
launches of every CUDA kernel on one ``kernel_launches=`` line.

Usage:  python -m ofot_tpu_torch.cli.main f0.pgm f1.pgm --algo=foto --Nt=16 ...
"""

from __future__ import annotations

import argparse
import os
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
                   help="Middlebury color-wheel PNG of the flow")
    p.add_argument("--checkpoint", nargs="?",
                   help="save final FOTO/WFR solver state here (.npz)")
    p.add_argument("--resume", nargs="?",
                   help="resume FOTO/WFR from a saved state (.npz)")
    p.add_argument("--profile", nargs="?",
                   help="write a torch.profiler trace to this directory")
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
                   help="append a structured solver-summary record here")
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
                   help="directory for the FOTO density trajectory rho_n "
                        "as PNGs")
    return p


_ALGOS = ("foto", "WFR", "GN", "HS", "sinkhorn")
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
    names = {"foto": "FOTO", "WFR": "WFR (unbalanced optimal transport)",
             "sinkhorn": "sinkhorn (static entropic OT)"}
    print(f" - algorithm: {names.get(args.algo, args.algo)}")
    if args.algo in ("GN", "HS"):
        print(f"\t - alpha={args.alpha}")
        if args.algo == "GN":
            print(f"\t - lambda={args.lambdaa}")
        if args.pyramid_levels > 1:
            print(f"\t - pyramid_levels={args.pyramid_levels}")
        return
    if args.algo == "sinkhorn":
        print(f"\t - epsilon={args.sinkhorn_epsilon}")
        print(f"\t - tol={args.sinkhorn_tol}")
        print(f"\t - max_it={args.max_it}")
        return
    print(f"\t - Nt={args.Nt}")
    print(f"\t - r={args.r}")
    if args.algo == "WFR":
        print(f"\t - delta={args.wfr_delta}")
    print(f"\t - convergence_tol={args.convergence_tol}")
    print(f"\t - reg_epsilon={args.reg_epsilon}")
    print(f"\t - max_it={args.max_it}")


def _check_sinkhorn_args(args) -> None:
    """The f32 envelope warning and the theta guard of the JAX CLI."""
    if (args.sinkhorn_epsilon < 3 and args.precision != "f64"
            and args.sinkhorn_stabilizer == "matmul"):
        # the measured f32 envelope of the matmul softmin
        # (solvers/sinkhorn.py); only when matmul is pinned: with auto the
        # final-marginal verification surfaces a below-envelope failure
        # and the exact re-solve handles it, and exact has no envelope
        print(f"WARNING: --sinkhorn-epsilon={args.sinkhorn_epsilon} is "
              "below the matmul softmin's f32 envelope (eps >= 3); "
              "results may be degraded — drop the pinned "
              "--sinkhorn-stabilizer=matmul, or use --precision=f64 "
              "or a larger eps", file=sys.stderr)
    if not 0.0 < args.sinkhorn_theta < 2.0:
        # theta >= 2 diverges to NaN potentials, which would otherwise
        # come back as a plausible all-zero flow
        raise SystemExit(f"--sinkhorn-theta={args.sinkhorn_theta} "
                         "outside the convergent range (0, 2)")


def _host(fields):
    """The fields on the host (the solve's end: its device-to-host copy)."""
    return tuple(t.cpu().numpy() for t in fields)


def _run_ot(args, rho1_d, rho2_d, ops, solver, w, h):
    """FOTO and WFR -> (device fields, host fields, solve end, stats).
    The luminosity slot of WFR composes the growth the source term
    modelled with the advective dilution correction -div(u, v).  After
    the timed solve: the solver line, W2 or the WFR distance (printed
    unless --quiet, logged with --log-jsonl), the checkpoint, the growth
    field and the FOTO density frames."""
    from ofot_tpu_torch.solvers import foto, wfr
    from ofot_tpu_torch.utils import checkpoint, image

    init = (checkpoint.load_state(args.resume, rho1_d.device, rho1_d.dtype)
            if args.resume else None)
    common = dict(r=args.r, convergence_tol=args.convergence_tol,
                  reg_epsilon=args.reg_epsilon, max_it=args.max_it,
                  verbose=not args.quiet, init=init, ops=ops,
                  admm_alpha=args.admm_alpha, auto_r=args.auto_r)
    if args.algo == "foto":
        result = foto.solve(rho1_d, rho2_d, args.Nt, **common)
        fields = (result.u, result.v, result.m)
    else:
        result = wfr.solve(rho1_d, rho2_d, args.Nt, delta=args.wfr_delta,
                           **common)
        fields = (result.u, result.v, result.m_combined)
    host = _host(fields)
    solve_end = time.time()

    state = result.state
    print(f"solver: iterations={state.iteration} "
          f"inner_iterations={state.cg_iterations} "
          f"crit={float(state.crit)} stepA_solver={solver}")
    report = not args.quiet or args.log_jsonl
    if args.algo == "foto":
        stats = {"iterations": int(state.iteration),
                 "inner_iterations": int(state.cg_iterations),
                 "crit": float(state.crit), "stepA_solver": solver}
        if report:
            w2 = float(foto.wasserstein2(state))
            stats["wasserstein2"] = w2
            if not args.quiet:
                print(f"W2(rho0, rhoT) = {w2:.6g} px")
    else:
        stats = {"iterations": int(state.iteration),
                 "crit": float(state.crit), "delta": args.wfr_delta,
                 "stepA_solver": solver}
        if report:
            dist = float(wfr.wfr_distance(state))
            created = float(wfr.total_created_mass(state, args.wfr_delta))
            stats["wfr_distance"] = dist
            stats["created_mass"] = created
            if not args.quiet:
                print(f"WFR(rho0, rhoT) = {dist:.6g} px, "
                      f"created mass = {created:.6g}")
    if args.checkpoint:
        checkpoint.save_state(args.checkpoint, state)
    if args.algo == "WFR" and args.save_growth:
        growth = result.growth.cpu().numpy()
        image.save_grayscale(np.clip((growth + 1) / 2, 0, 1).reshape(h, w),
                             args.save_growth)
    if args.algo == "foto" and args.save_density_frames:
        os.makedirs(args.save_density_frames, exist_ok=True)
        rho = state.mu[0].cpu().numpy()                 # (Nt, Ny, Nx)
        for n in range(rho.shape[0]):
            image.save_grayscale(
                w * h * rho[n],
                os.path.join(args.save_density_frames, f"rho-{n}.png"))
    return fields, host, solve_end, stats


def _run_variational(args, rho1_d, rho2_d):
    """GN and HS -> (device fields, host fields, solve end, stats); m = 0
    for HS.  With ``--pyramid-levels > 1`` the coarse-to-fine solve: the
    linearized solvers only capture a few px of motion, so the pyramid
    solves residual flows at halved scales (for GN, m is solved at the
    finest level around the final warp).  The solver line also gives the
    pyramid's CG steps, which the JAX CLI's record has not."""
    from ofot_tpu_torch.solvers import gn, hs, pyramid

    if args.pyramid_levels > 1:
        steps = []
        if args.algo == "GN":
            fields = pyramid.solve_gn_pyramid(
                rho1_d, rho2_d, args.alpha, args.lambdaa,
                levels=args.pyramid_levels, cg_log=steps)
        else:
            u, v = pyramid.solve_hs_pyramid(
                rho1_d, rho2_d, args.alpha, levels=args.pyramid_levels,
                cg_log=steps)
            fields = (u, v, torch.zeros_like(u))
        host = _host(fields)
        solve_end = time.time()
        print(f"solver: pyramid_levels={args.pyramid_levels} "
              f"inner_iterations={sum(r.iterations for r in steps)} "
              f"converged={all(r.converged for r in steps)}")
        return fields, host, solve_end, {
            "pyramid_levels": args.pyramid_levels}
    if args.algo == "GN":
        res = gn.solve_fields(rho1_d, rho2_d, args.alpha, args.lambdaa)
        fields = (res.u, res.v, res.m)
    else:
        res = hs.solve_fields(rho1_d, rho2_d, args.alpha)
        fields = (res.u, res.v, torch.zeros_like(res.u))
    host = _host(fields)
    solve_end = time.time()
    stats = {"inner_iterations": res.cg.iterations,
             "residual": float(res.cg.residual),
             "converged": res.cg.converged}
    print("solver: " + " ".join(f"{k}={v}" for k, v in stats.items()))
    return fields, host, solve_end, stats


def _run_sinkhorn(args, rho1_d, rho2_d):
    """Static entropic OT -> (device fields, host fields, solve end,
    stats): one annealed Sinkhorn solve and its debiased barycentric
    flow, with m = -div(u, v) ('D' boundary), the convention of the
    dynamic extraction.  The ``auto`` stabilizer solves with the matmul
    softmin first and re-solves with the exactly-stabilized one when the
    (verified) marginal error misses the tolerance; the negated
    ``<=`` test also catches a NaN error.  After the solve: the max-it
    warning and, unless --quiet or with --log-jsonl, the debiased W2 from
    one more annealed b->b self-solve."""
    from ofot_tpu_torch.ops import operators
    from ofot_tpu_torch.solvers import sinkhorn

    eps, tol = args.sinkhorn_epsilon, args.sinkhorn_tol
    kw = dict(max_iter=args.max_it, tol=tol, theta=args.sinkhorn_theta)
    stab = "exact" if args.sinkhorn_stabilizer == "exact" else "matmul"
    res = sinkhorn.flow(rho1_d, rho2_d, eps, stabilizer=stab, **kw)
    me_matmul = None
    if args.sinkhorn_stabilizer == "auto" and not bool(
            res.marginal_error <= tol):
        print(f"  marginal error {float(res.marginal_error):.3g} > "
              f"tol {tol:g} on the matmul-softmin path "
              "— re-solving with the exactly-stabilized softmin",
              flush=True)
        me_matmul = float(res.marginal_error)
        stab = "exact"
        res = sinkhorn.flow(rho1_d, rho2_d, eps, stabilizer=stab, **kw)
    fields = (res.u, res.v, -operators.div2d(res.u, res.v, bc="D"))
    host = _host(fields)
    solve_end = time.time()

    stats = {"iterations": res.iterations,
             "marginal_error": float(res.marginal_error),
             "epsilon": eps, "stabilizer": stab}
    if me_matmul is not None:
        stats["marginal_error_matmul"] = me_matmul
    print(f"solver: iterations={res.iterations} "
          f"marginal_error={stats['marginal_error']} stabilizer={stab}")
    if not bool(res.marginal_error <= tol):
        # a max_iter exit returns a biased flow
        print(f"WARNING: sinkhorn hit max-it={args.max_it} with "
              f"marginal error {float(res.marginal_error):.3g} > "
              f"tol {tol:g}; flow may be biased — raise --max-it",
              file=sys.stderr)
    if not args.quiet or args.log_jsonl:
        # the costs of flow()'s a->b and a->a solves plus one b->b
        # self-solve, annealed like them, with the same theta and
        # stabilizer
        bb = sinkhorn.solve_annealed(rho2_d, rho2_d, eps, stabilizer=stab,
                                     **kw)
        div = res.cost_ab - 0.5 * (res.cost_aa + bb.cost)
        w2 = float(torch.sqrt(torch.clamp(div, min=0.0)))
        stats["wasserstein2"] = w2
        stats["w2_marginal_error"] = float(bb.marginal_error)
        if not bool(bb.marginal_error <= tol):
            print("WARNING: the b->b self-solve behind W2_entropic "
                  f"exited at marginal error "
                  f"{float(bb.marginal_error):.3g} > tol {tol:g}; the "
                  "reported W2 may be biased", file=sys.stderr)
        if not args.quiet:
            print(f"W2_entropic(rho0, rhoT) = {w2:.6g} px")
    return fields, host, solve_end, stats


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.algo not in _ALGOS:
        print(f"ERROR: unknown --algo '{args.algo}' (expected foto, GN, HS, "
              "WFR, or sinkhorn)", file=sys.stderr)
        return 2

    from ofot_tpu_torch.ops import kernels
    from ofot_tpu_torch.solvers import foto, wfr
    from ofot_tpu_torch.utils import colorwheel, flo, image, metrics, trace
    from ofot_tpu_torch.utils import warp

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
    if args.algo == "sinkhorn":
        _check_sinkhorn_args(args)

    device = _device(args.platform)
    dtype = torch.float64 if args.precision == "f64" else torch.float32
    logger = trace.JsonlLogger(args.log_jsonl)

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
    # the trace spans the solve and its diagnostics, as the JAX CLI's
    # start_trace/stop_trace do
    with trace.profile(args.profile):
        start_time = time.time()
        if ot:
            run = _run_ot(args, rho1_d, rho2_d, ops, solver, w, h)
        elif args.algo == "sinkhorn":
            run = _run_sinkhorn(args, rho1_d, rho2_d)
        else:
            run = _run_variational(args, rho1_d, rho2_d)
    (u_d, v_d, m_d), (u, v, m), solve_end, solver_stats = run
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
    logger.log("solve", algo=args.algo, f0=args.f0, f1=args.f1,
               w=w, h=h, wall_s=timer, IE=IE, **solver_stats)

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

    if args.save_flow_viz:
        print("saving flow visualization...")
        rgb, _, _ = colorwheel.motion_to_color(u.reshape(h, w),
                                               v.reshape(h, w))
        image.save_rgb(rgb, args.save_flow_viz)

    print("***********************************")
    return 0


if __name__ == "__main__":
    sys.exit(main())
