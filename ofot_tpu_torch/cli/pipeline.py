"""Benchmark pipeline — Python re-implementation of the reference's run.sh.

Counterpart of ``ofot_tpu.cli.pipeline`` on the PyTorch port: the same
subcommands, flags, artifacts and ``manifest.json`` keys, with every solve
run by the port's CLI (``ofot_tpu_torch.cli.main``) on the card unless
``--platform=cpu`` asks for the CPU.  Covers the full dataset lifecycle
and sweep (reference run.sh:3-157) with no bash/ImageMagick/wget
dependency:

  * ``download``: fetch + unpack the Middlebury-1 eval-gray-twoframes zip
    (or unpack a local zip in zero-egress environments), then resize 50%
    (Pillow's LANCZOS, the port's one use of Pillow), build the
    illumination-augmented ``middlebury-1-lum`` variant (seeded), and
    mass-normalize both datasets;
  * ``run``: per-sequence sweep of the algorithms with the reference's
    canonical parameters (GN: alpha=0.1 lambda=0.2, run.sh:103; FOTO: r=1
    tol=0.01 eps=1e-2 Nt=16 max_it=200, run.sh:114), producing the same
    artifact set (diff.png, {gn,foto}.{flo,benchmark.txt,rec.png,lum.png,
    png}) with the same ``.out.<algo>.sucess`` flag-file resume semantics
    [sic — the reference's spelling], plus a structured ``manifest.json``;
    ``run --batch`` solves each dataset's same-shape sequences through
    ``parallel.sweep.solve_batch_full``: in ``map`` mode (the default; one
    pair after another on the device, bitwise the per-sequence solves) or,
    with ``--batch-mode=vmap``, as one lockstep batch;
  * ``restart``: wipe results and re-run;
  * ``merge-manifests``: merge the per-host manifest shards.

Frames are PNG, read without Pillow (``utils.image.read_png``).  The flow
visualizations are the port's ``colorwheel.flow_to_png``.

Usage: python -m ofot_tpu_torch.cli.pipeline {download,run,restart,merge-manifests} [options]
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
import zipfile
from pathlib import Path

MIDDLEBURY_URL = ("https://vision.middlebury.edu/flow/data/comp/zip/"
                  "eval-gray-twoframes.zip")
MIDDLEBURY2_DATA_URL = ("https://vision.middlebury.edu/flow/data/comp/zip/"
                        "other-gray-twoframes.zip")
MIDDLEBURY2_GT_URL = ("https://vision.middlebury.edu/flow/data/comp/zip/"
                      "other-gt-flow.zip")

# The sweep's canonical solve arguments, copies of ofot_tpu.cli.pipeline's
# (whose comments argue each choice): GN as reference run.sh:103; FOTO as
# run.sh:114 with over-relaxed ADMM (--admm-alpha=1.7, the same fixed
# point in fewer iterations); WFR with FOTO's budget and delta 2.5 px;
# Sinkhorn (static entropic OT) at the frame-scale epsilon of the matmul
# softmin, with the CLI's auto stabilizer re-solving a missed tolerance
# with the exact softmin on the same device.
GN_ARGS = ["--algo=GN", "--alpha=0.1", "--lambda=0.2"]
WFR_ARGS = ["--algo=WFR", "--r=1", "--convergence-tol=0.01",
            "--reg-epsilon=1e-2", "--Nt=16", "--max-it=200",
            "--wfr-delta=2.5", "--admm-alpha=1.7"]
FOTO_ARGS = ["--algo=foto", "--r=1", "--convergence-tol=0.01",
             "--reg-epsilon=1e-2", "--Nt=16", "--max-it=200",
             "--admm-alpha=1.7"]
SINKHORN_ARGS = ["--algo=sinkhorn", "--sinkhorn-epsilon=100.0",
                 "--max-it=1000"]


def _data_subdir(dataset_dir: Path) -> str:
    """middlebury-1 uses eval-data-gray; middlebury-2 uses other-data-gray
    with ground truth in other-gt-flow (reference README.md:41-48)."""
    if (dataset_dir / "other-data-gray").is_dir():
        return "other-data-gray"
    return "eval-data-gray"


def _sequences(dataset_dir: Path):
    root = dataset_dir / _data_subdir(dataset_dir)
    if not root.is_dir():
        return []
    return sorted(p for p in root.iterdir() if p.is_dir())


def _ground_truth_flo(dataset_dir: Path, seq_name: str) -> Path | None:
    gt = dataset_dir / "other-gt-flow" / seq_name / "flow10.flo"
    return gt if gt.exists() else None


def color_flow(flo_path: Path, png_path: Path,
               maxmotion: float | None = None) -> None:
    """Colorize a .flo with the port's Middlebury color wheel.

    ``maxmotion`` pins the color scale — used for the middlebury-2
    ground-truth-normalized visualizations (reference README.md:146: "Ground
    truth normalization is computed and applied only when ground truth .flo
    files exist"), so computed and GT flows share a comparable color wheel.
    """
    from ofot_tpu_torch.utils.colorwheel import flow_to_png
    flow_to_png(str(flo_path), str(png_path), maxmotion=maxmotion)


def _gt_maxmotion(gt_flo: Path) -> float:
    """Max motion radius of a ground-truth flow (unknown pixels excluded)."""
    import numpy as np
    from ofot_tpu_torch.utils import flo as flo_mod
    from ofot_tpu_torch.utils.colorwheel import UNKNOWN_FLOW_THRESH

    w, h, u, v = flo_mod.read_flo(str(gt_flo))
    known = (np.abs(u) < UNKNOWN_FLOW_THRESH) & (np.abs(v) < UNKNOWN_FLOW_THRESH)
    if not known.any():
        return 1.0
    return float(np.sqrt(u[known] ** 2 + v[known] ** 2).max())


# ---------------------------------------------------------------- download

def cmd_download(args) -> int:
    data = Path(args.data_root)
    mb1 = data / "middlebury-1"
    if mb1.exists():
        shutil.rmtree(mb1)
    mb1.mkdir(parents=True)

    zip_path = args.local_zip
    if not zip_path:
        zip_path = str(data / "eval-gray-twoframes.zip")
        import urllib.request
        print(f"downloading {MIDDLEBURY_URL} ...")
        try:
            urllib.request.urlretrieve(MIDDLEBURY_URL, zip_path)
        except OSError as e:
            print(f"download failed ({e}); in offline environments fetch "
                  f"{MIDDLEBURY_URL} elsewhere and pass --local-zip",
                  file=sys.stderr)
            return 1
    with zipfile.ZipFile(zip_path) as z:
        members = [m for m in z.namelist() if m.startswith("eval-data-gray/")]
        z.extractall(mb1, members=members)

    _resize_dataset(mb1, args.resize_percent)
    _create_lum_dataset(data, seed=args.lum_seed)
    _normalize_dataset(data / "middlebury-1")
    _normalize_dataset(data / "middlebury-1-lum")

    if args.with_middlebury2 or args.local_zip_mb2_data:
        _download_middlebury2(data, args.local_zip_mb2_data,
                              args.local_zip_mb2_gt)
    return 0


def _download_middlebury2(data: Path, local_data_zip=None,
                          local_gt_zip=None) -> None:
    """Middlebury-2: other-data-gray frames + other-gt-flow ground truth
    (reference README.md:41-48).  Kept at native resolution — resizing
    would invalidate the GT flow fields."""
    mb2 = data / "middlebury-2"
    if mb2.exists():
        shutil.rmtree(mb2)
    mb2.mkdir(parents=True)
    import urllib.request
    for url, local, subdir in (
            (MIDDLEBURY2_DATA_URL, local_data_zip, "other-data-gray"),
            (MIDDLEBURY2_GT_URL, local_gt_zip, "other-gt-flow")):
        zip_path = local
        if not zip_path:
            zip_path = str(data / url.rsplit("/", 1)[1])
            print(f"downloading {url} ...")
            urllib.request.urlretrieve(url, zip_path)
        with zipfile.ZipFile(zip_path) as z:
            members = [m for m in z.namelist() if m.startswith(subdir + "/")]
            z.extractall(mb2, members=members)


def _resize_dataset(dataset_dir: Path, percent: int = 50) -> None:
    """50% downscale of both frames in place (run.sh:18-30 equivalent),
    with Pillow's LANCZOS filter, as the JAX pipeline resizes: host-side
    data preparation, the port's one use of Pillow."""
    from PIL import Image
    print("Resizing datasets")
    for seq in _sequences(dataset_dir):
        for name in ("frame10.png", "frame11.png"):
            p = seq / name
            im = Image.open(p)
            im = im.resize((im.width * percent // 100,
                            im.height * percent // 100), Image.LANCZOS)
            im.save(p)


def _create_lum_dataset(data: Path, seed: int = 12345) -> None:
    """Build middlebury-1-lum: copy frame10, augment frame11 with seeded
    random illumination artifacts (run.sh:32-48 equivalent).  Per-sequence
    seeds are drawn from one seeded RNG, mirroring the bash ``$RANDOM``
    chain seeded once at 12345."""
    import random as _random
    from ofot_tpu_torch.cli import create_lum_dataset as lum

    print("Adding random artifical illumination")
    src = data / "middlebury-1"
    dst = data / "middlebury-1-lum"
    (dst / "eval-data-gray").mkdir(parents=True, exist_ok=True)
    seq_rng = _random.Random(seed)
    from ofot_tpu_torch.utils import image as img
    for seq in _sequences(src):
        out_seq = dst / "eval-data-gray" / seq.name
        out_seq.mkdir(exist_ok=True)
        shutil.copy(seq / "frame10.png", out_seq / "frame10.png")
        f, w, h = img.open_grayscale(str(seq / "frame11.png"))
        f = lum.augment(f, w, h, seq_rng.randint(0, 32767))
        img.save_grayscale(f, str(out_seq / "frame11.png"))


def _normalize_dataset(dataset_dir: Path) -> None:
    """Mass-normalize both frames of every sequence (run.sh:50-70)."""
    from ofot_tpu_torch.utils import image as img
    print("Normalizing datasets")
    for seq in _sequences(dataset_dir):
        f1, w, h = img.open_grayscale(str(seq / "frame10.png"))
        f2, w, h = img.open_grayscale(str(seq / "frame11.png"))
        f1, f2 = img.mass_normalize_pair_common_max(f1, f2)
        img.save_grayscale(f1, str(seq / "frame10.png"))
        img.save_grayscale(f2, str(seq / "frame11.png"))


# ---------------------------------------------------------------- run

_SINKHORN_TOL_DEFAULT = 1e-4     # cli/main.py --sinkhorn-tol default


def _algo_argv(algo: str, frame10: Path, frame11: Path, out_dir: Path,
               extra_cli: list[str],
               ground_truth: Path | None = None) -> tuple[list, Path]:
    """The cli/main.py argv for one sequence/algorithm (shared by the
    per-sequence runner and the f64 escalation re-run)."""
    stats_path = out_dir / f"{algo.lower()}.stats.jsonl"
    argv = [str(frame10), str(frame11),
            f"--out={out_dir}/{algo.lower()}.flo",
            f"--save-benchmark={out_dir}/{algo.lower()}.benchmark.txt",
            f"--save-reconstruction={out_dir}/{algo.lower()}.rec.png",
            f"--save-lum={out_dir}/{algo.lower()}.lum.png",
            f"--log-jsonl={stats_path}",
            "--quiet"]
    if ground_truth is not None:
        argv.append(f"--ground-truth={ground_truth}")
    argv += {"GN": GN_ARGS, "foto": FOTO_ARGS, "WFR": WFR_ARGS,
             "sinkhorn": SINKHORN_ARGS}[algo]
    if algo == "WFR":
        argv.append(f"--save-growth={out_dir}/wfr.growth.png")
    argv += extra_cli
    return argv, stats_path


def _sinkhorn_tol(argv: list) -> float:
    tol = _SINKHORN_TOL_DEFAULT
    for tok in argv:
        if tok.startswith("--sinkhorn-tol="):
            tol = float(tok.split("=", 1)[1])
    return tol


def _argv_precision(argv: list) -> str | None:
    """Last-wins --precision value from an argv, accepting both the
    '--precision=f64' and the space-separated '--precision f64' forms
    (argparse takes either)."""
    toks = [str(t) for t in argv]
    val = None
    for i, t in enumerate(toks):
        if t.startswith("--precision="):
            val = t.split("=", 1)[1]
        elif t == "--precision" and i + 1 < len(toks):
            val = toks[i + 1]
    return val


def _fold_stats(res: dict, stats_path: Path) -> None:
    """Fold the solver's own diagnostics (iterations, crit, W2, ...) into
    the manifest entry, matching the batched path's per-sequence diag."""
    try:
        recs = [json.loads(line) for line in
                stats_path.read_text().splitlines()]
        solve = [r for r in recs if r.get("event") == "solve"][-1]
        res.update({k: v for k, v in solve.items()
                    if isinstance(v, (int, float)) and not isinstance(v, bool)
                    and k not in ("ts", "wall_s", "w", "h")})
        # the solve event's own wall is the SOLVER time (no I/O, no viz)
        # — kept under its own key so manifest consumers can separate
        # solver time from the full-invocation wall_s, which also holds
        # frame I/O, the warp, the outputs and, on a process's first
        # solve, the card's set-up
        if isinstance(solve.get("wall_s"), (int, float)):
            res["solver_wall_s"] = solve["wall_s"]
        for key in ("stabilizer", "stepA_solver"):
            if isinstance(solve.get(key), str):
                res[key] = solve[key]
    except (OSError, IndexError, ValueError) as e:
        # the manifest's per-sequence diagnostics depend on this file; a
        # silent pass here makes '—' columns in sweep summaries
        # undiagnosable
        print(f"note: could not fold {stats_path.name} diagnostics into "
              f"the manifest ({type(e).__name__}: {e})", file=sys.stderr)


def _rerun_cli(argv: list, *overrides: str) -> bool:
    """Re-run one solve through the port's CLI in process, on the device
    the argv names (the sweep's own; argparse last-wins, so the appended
    overrides win), overwriting the sequence's artifacts -> success."""
    from ofot_tpu_torch.cli import main as cli_main

    try:
        return cli_main.main([str(x) for x in argv] + list(overrides)) == 0
    except SystemExit as e:      # argparse/validation exits
        return e.code in (0, None)


def _escalate_sinkhorn_f64(argv: list) -> bool:
    """Re-run an f32 sinkhorn solve that plateaued above tolerance at f64,
    in process on the sweep's own device.

    The -lum sequences that exit at max-it sit on an f32 precision
    floor (the JAX package's BENCHMARKS.md: f32 plateaus at the same
    marginal error with a 6x budget, f64 reaches 1e-4 in ~325
    iterations), so the pipeline escalates instead of shipping
    known-biased flows.  The card runs Sinkhorn at f64, and torch's dtype
    is per call, so the re-solve stays on the card (the JAX pipeline
    leaves for a CPU subprocess: the TPU has no f64 and x64 is a
    process-wide switch there).  Any exception of the re-solve fails the
    escalation, not the sweep, as the JAX subprocess's rc != 0 does."""
    try:
        ok = _rerun_cli(argv, "--precision=f64")
    except Exception as e:      # the sweep goes on; the row records it
        print(f"note: f64 re-solve raised {type(e).__name__}: {e}",
              file=sys.stderr)
        ok = False
    if not ok:
        print("note: f64 escalation failed", file=sys.stderr)
    return ok


def _escalate_sinkhorn_inprocess(argv: list) -> bool:
    """Re-run a flagged batch-mode sinkhorn solve per-sequence IN PROCESS
    with the exactly-stabilized softmin on the same device, which lifts
    the matmul path's f32 exp-window floor without leaving the card
    (solvers/sinkhorn.py _exact_stats).  The exact stabilizer is forced
    directly: the matmul path already failed in the batch, and re-running
    the CLI's full annealed ladder first would double the escalation
    cost."""
    return _rerun_cli(argv, "--sinkhorn-stabilizer=exact")


def _maybe_escalate_sinkhorn(res: dict, argv: list, stats_path: Path,
                             wall0: float) -> None:
    """If the folded diagnostics show a marginal error above tolerance
    (or NaN) and the solve was not already f64, escalate and re-fold.

    Two rungs: (1) batch-mode solves (which run the matmul softmin with
    no in-solve retry) re-run per-sequence in process, where the CLI's
    auto stabilizer converges the -lum regime in f32 ON DEVICE; (2) only
    if the exactly-stabilized f32 path also misses tol does the f64
    re-solve fire, on the same device (per-sequence solves arrive here
    with rung 1 already exhausted by the CLI itself — visible as
    ``marginal_error_matmul``)."""
    me = res.get("marginal_error")
    if me is None or _argv_precision(argv) == "f64":
        return
    tol = _sinkhorn_tol(argv)
    if me <= tol:
        return
    already_exact = any(str(t) == "--sinkhorn-stabilizer=exact"
                        for t in argv)
    if (res.get("batched") and "marginal_error_matmul" not in res
            and not already_exact):
        print(f"  sinkhorn marginal error {me:.3g} > tol {tol:g} in the "
              "f32 batch — re-solving per-sequence with the "
              "exactly-stabilized softmin (on device)", flush=True)
        t0 = time.time()
        ok = _escalate_sinkhorn_inprocess(argv)
        wall0 += time.time() - t0     # rung-1 cost counts even if rung 2
        res["wall_s"] = wall0         # runs next (manifest wall honesty)
        if ok:
            res["marginal_error_batch"] = me
            _fold_stats(res, stats_path)
            me = res.get("marginal_error")
            if me is not None and me <= tol:
                # only a CONVERGED exact re-solve earns the marker — an
                # above-tol exact exit falls through to rung 2 with its
                # error recorded
                res["escalated_exact"] = True
                return
            res["marginal_error_exact"] = me
    print(f"  sinkhorn marginal error {me:.3g} > tol {tol:g} at f32 — "
          "escalating to f64", flush=True)
    t0 = time.time()
    ok = _escalate_sinkhorn_f64(argv)
    # both outcomes account the attempt's wall
    res["wall_s"] = wall0 + (time.time() - t0)
    if ok:
        res["escalated_f64"] = True
        res["marginal_error_f32"] = me
        _fold_stats(res, stats_path)     # last record is the f64 solve
    else:
        # the shipped artifacts are the known-biased f32 flow; mark the
        # manifest entry so sweep summaries can surface it (the .sucess
        # resume flag will still be touched by the caller)
        res["escalation_failed"] = True


def _run_algo(algo: str, frame10: Path, frame11: Path, out_dir: Path,
              extra_cli: list[str], ground_truth: Path | None = None,
              maxmotion: float | None = None,
              first_of_program: bool = False) -> dict:
    """One main.py invocation's worth of work, in-process."""
    from ofot_tpu_torch.cli import main as cli_main

    flag = out_dir / f".out.{algo.lower()}.sucess"     # [sic]
    if flag.exists():
        return {"algo": algo, "status": "cached"}
    argv, stats_path = _algo_argv(algo, frame10, frame11, out_dir,
                                  extra_cli, ground_truth)
    t0 = time.time()
    rc = cli_main.main(argv)
    wall = time.time() - t0
    if rc != 0:
        return {"algo": algo, "status": "failed", "rc": rc}
    res = {"algo": algo, "status": "ok", "wall_s": wall}
    if first_of_program:
        # the first solve of an (algo, frame size) in this process: its
        # walls hold the kernel library's load and cuBLAS's first-call
        # set-up on the card; peer rows are the solve-time samples
        res["first_of_program"] = True
    _fold_stats(res, stats_path)
    if algo == "sinkhorn":
        _maybe_escalate_sinkhorn(res, argv, stats_path, wall)
    color_flow(out_dir / f"{algo.lower()}.flo",
               out_dir / f"{algo.lower()}.png", maxmotion)
    flag.touch()
    return res


def cmd_run(args) -> int:
    if getattr(args, "batch", False):
        return cmd_run_batch(args)
    from ofot_tpu_torch.cli import data_diff
    from ofot_tpu_torch.parallel.multihost import partition_keys
    from ofot_tpu_torch.utils.image import png_size

    data = Path(args.data_root)
    results = Path(args.results)
    manifest_name = ("manifest.json" if args.host_count == 1
                     else f"manifest.{args.host_id}.json")
    manifest_path = results / manifest_name
    manifest = (json.loads(manifest_path.read_text())
                if manifest_path.exists() else {})
    algos = _validate_algos(args.algos)
    extra = []
    if args.platform:
        extra.append(f"--platform={args.platform}")
    if args.precision:
        extra.append(f"--precision={args.precision}")
    if args.extra_args:
        extra += args.extra_args.split()
    seen_programs: set = set()   # (algo, frame size) combos already solved

    for ds_name in args.datasets.split(","):
        ds = data / ds_name
        out_root = results / ds_name
        out_root.mkdir(parents=True, exist_ok=True)
        seqs = _sequences(ds)
        if args.host_count > 1:      # DP over hosts: disjoint sequence sets
            mine = set(partition_keys([s.name for s in seqs],
                                      args.host_id, args.host_count))
            seqs = [s for s in seqs if s.name in mine]
        for seq in seqs:
            out_dir = out_root / seq.name
            out_dir.mkdir(exist_ok=True)
            frame10 = seq / "frame10.png"
            frame11 = seq / "frame11.png"
            if not (out_dir / "diff.png").exists():   # resume-cached
                data_diff.main([str(frame10), str(frame11),
                                str(out_dir / "diff.png")])
            gt = _ground_truth_flo(ds, seq.name)
            maxmotion = _gt_maxmotion(gt) if gt is not None else None
            if gt is not None and not (out_dir / "flow10.png").exists():
                color_flow(gt, out_dir / "flow10.png", maxmotion)
            entry = manifest.setdefault(f"{ds_name}/{seq.name}", {})
            try:
                frame_size = png_size(str(frame10))
            except (OSError, ValueError):
                # size probe only; an unreadable frame still fails loudly
                # inside the solve itself (pre-existing sweep semantics)
                frame_size = None
            for algo in algos:
                print(f"== {ds_name}/{seq.name} [{algo}] ==", flush=True)
                pkey = (algo, frame_size)
                res = _run_algo(algo, frame10, frame11, out_dir,
                                extra, ground_truth=gt,
                                maxmotion=maxmotion,
                                first_of_program=pkey not in seen_programs)
                if res.get("status") == "ok":
                    seen_programs.add(pkey)
                # a cached re-run must not clobber the original entry's
                # status/wall_s data
                if res.get("status") != "cached" or algo not in entry:
                    entry[algo] = res
                manifest_path.write_text(json.dumps(manifest, indent=1))
    return 0


def _validate_algos(algos_csv: str) -> list[str]:
    """The sweep runs the reference run.sh's two algorithms plus the
    framework's WFR extension (opt-in via --algos GN,foto,WFR); anything
    else must fail loudly instead of silently running as one of them
    (single-pair runs of other solvers go through cli/main.py)."""
    algos = algos_csv.split(",")
    bad = [a for a in algos if a not in ("GN", "foto", "WFR", "sinkhorn")]
    if bad:
        raise SystemExit(f"unknown --algos entries {bad}; the sweep runs "
                         "'GN', 'foto' (reference run.sh:81-157) and/or "
                         "the framework extensions 'WFR' and 'sinkhorn'")
    return algos


def _batched_params(extra: str):
    """Parse the CLI overrides that apply to batched solves.

    Keys match with argparse-style unambiguous prefixes so e.g.
    ``--lambda=0.4`` reaches ``lambdaa`` exactly like the per-sequence
    path's argparse does (SURVEY.md §2 quirk 4).  An override that the
    batched path cannot honor raises instead of being silently dropped."""
    foto_params = dict(Nt=16, r=1.0, convergence_tol=0.01,
                       reg_epsilon=1e-2, max_it=200, admm_alpha=1.7)
    gn_params = dict(alpha=0.1, lambda_=0.2)
    wfr_params = dict(Nt=16, delta=2.5, r=1.0, convergence_tol=0.01,
                      reg_epsilon=1e-2, max_it=200, admm_alpha=1.7,
                      stepA_solver="auto")
    sinkhorn_params = dict(epsilon=100.0, max_iter=1000, tol=1e-4)
    key_map = {"Nt": ("foto", "Nt", int), "r": ("foto", "r", float),
               "convergence-tol": ("foto", "convergence_tol", float),
               "reg-epsilon": ("foto", "reg_epsilon", float),
               "max-it": ("foto", "max_it", int),
               "alpha": ("gn", "alpha", float),
               "lambdaa": ("gn", "lambda_", float),
               "admm-alpha": ("foto", "admm_alpha", float),
               "stepA-solver": ("foto", "stepA_solver", str),
               "wfr-delta": ("wfr", "delta", float),
               "sinkhorn-epsilon": ("sinkhorn", "epsilon", float),
               "sinkhorn-tol": ("sinkhorn", "tol", float),
               "sinkhorn-theta": ("sinkhorn", "theta", float),
               "sinkhorn-stabilizer": ("sinkhorn", "stabilizer", str)}
    by_which = {"foto": foto_params, "gn": gn_params, "wfr": wfr_params,
                "sinkhorn": sinkhorn_params}
    # flags the per-sequence path honors that are handled by the batch
    # runner itself (cmd_run_batch applies platform/precision globally) or
    # are no-ops here — matched with the same unambiguous-prefix rule as
    # the solve knobs so one --extra-args string serves both modes
    passthrough = ("quiet", "platform", "precision")
    passthrough_vals: dict[str, str] = {}

    def passthrough_match(k):
        if not k:
            return None
        hits = [p for p in passthrough if p == k or p.startswith(k)]
        if len(hits) > 1:
            raise SystemExit(f"--extra-args flag '--{k}' is ambiguous "
                             f"({'/'.join(hits)}) for the batched sweep")
        return hits[0] if hits else None

    for tok in (extra or "").split():
        if not tok.startswith("--"):
            continue
        k, v = (tok[2:].split("=", 1) + [None])[:2] if "=" in tok \
            else (tok[2:], None)
        if v is None:
            if k == "auto-r":      # store_true flag, scale-invariant ADMM
                foto_params["auto_r"] = True
                wfr_params["auto_r"] = True
                continue
            if passthrough_match(k):
                continue
            raise SystemExit(f"--extra-args flag '--{k}' is not supported "
                             "by the batched sweep (drop --batch to run "
                             "it per-sequence)")
        p = passthrough_match(k)
        if p is not None:
            # valued forms (--platform=cpu, --precision=f64): surfaced to
            # cmd_run_batch, which applies them like its own
            # --platform/--precision flags, so --batch runs f64 where the
            # per-sequence path does
            passthrough_vals[p] = v
            continue
        matches = ([k] if k in key_map else
                   [key for key in key_map if key.startswith(k)])
        if len(matches) != 1:
            raise SystemExit(
                f"--extra-args override '--{k}={v}' is "
                + ("ambiguous" if matches else "unknown")
                + " for the batched sweep; batched solves accept "
                + ", ".join(sorted(key_map)) + " (drop --batch to run "
                "other flags per-sequence)")
        which, name, cast = key_map[matches[0]]
        by_which[which][name] = cast(v)
        # the FOTO solve knobs apply to the unbalanced sweep too
        if which == "foto" and name in wfr_params:
            wfr_params[name] = cast(v)
        if name == "max_it":       # shared iteration budget
            sinkhorn_params["max_iter"] = cast(v)
    # validate theta before any group solves, mirroring the cli/main.py
    # SystemExit check — a divergent theta yields NaN potentials and a
    # plausible all-zero flow
    th = sinkhorn_params.get("theta")
    if th is not None and not 0.0 < th < 2.0:
        raise SystemExit(f"--sinkhorn-theta={th} outside the convergent "
                         "range (0, 2)")
    # same eager treatment for the stabilizer: a bad value would
    # otherwise surface as a raw ValueError mid-sweep, after other
    # algorithms' groups have already burned compute
    stab = sinkhorn_params.get("stabilizer")
    if stab is not None and stab not in ("matmul", "exact"):
        raise SystemExit(
            f"--sinkhorn-stabilizer={stab} is not a batch solver mode "
            "(use 'matmul' or 'exact'; 'auto' is the per-sequence CLI's "
            "retry policy — the batched sweep's escalation provides it)")
    return (foto_params, gn_params, wfr_params, sinkhorn_params,
            passthrough_vals)


def cmd_run_batch(args) -> int:
    """Batched sweep: all same-shape sequences of a dataset solved by one
    ``sweep.solve_batch_full`` call — in ``map`` mode the pairs one after
    another on the device, bitwise the per-sequence solves; in ``vmap``
    mode one lockstep batch — with the frames, warps and metrics of the
    whole group handled together.  ``--data-parallel N`` splits each
    group's pairs over N ranks (``sweep.DataParallel``)."""
    import numpy as np
    import torch

    from ofot_tpu_torch.parallel import sweep as sweep_mod

    if args.data_parallel < 1:
        print(f"ERROR: --data-parallel={args.data_parallel} must be >= 1",
              file=sys.stderr)
        return 2
    foto_params, gn_params, wfr_params, sinkhorn_params, passthrough = \
        _batched_params(args.extra_args)
    # --platform/--precision given via --extra-args behave like the
    # pipeline's own flags (the explicit flag wins on conflict)
    platform = args.platform or passthrough.get("platform")
    precision = args.precision or passthrough.get("precision")
    device = sweep_mod.torch_device(platform or "cuda")
    dtype = np.float64 if precision == "f64" else np.float32
    algos = _validate_algos(args.algos)
    # every algo's float32-only kernel set at f64 on cuda is refused
    # before any solve runs, as the per-sequence CLI refuses it
    params = {"foto": foto_params, "WFR": wfr_params}
    for algo in algos:
        try:
            sweep_mod.check_kernel_dtype(
                algo, params.get(algo), device,
                torch.float64 if precision == "f64" else torch.float32)
        except ValueError as e:
            print(f"ERROR: {e}; use --precision=f32, another "
                  "--stepA-solver, or --platform=cpu", file=sys.stderr)
            return 2

    solve_kw = dict(foto_params=foto_params, gn_params=gn_params,
                    wfr_params=wfr_params, sinkhorn_params=sinkhorn_params,
                    batch_mode=args.batch_mode, device=device)
    if args.data_parallel == 1:
        return _run_batches(args, algos, device, dtype, precision, solve_kw)
    # the batch axis over a `data` mesh of N ranks: this process is rank 0
    # and starts the others, once per run; a rank that fails fails the run
    with sweep_mod.DataParallel(args.data_parallel, device.type) as dp:
        return _run_batches(args, algos, device, dtype, precision, solve_kw,
                            dp)


def _run_batches(args, algos, device, dtype, precision, solve_kw,
                 dp=None) -> int:
    """``cmd_run_batch``'s sweep: each dataset's same-shape groups solved
    with ``solve_kw`` by ``solve_batch_full``, or over the ranks of ``dp``
    (a ``sweep.DataParallel``; each group padded to a multiple of its
    ranks, the duplicates dropped)."""
    import time as _time

    import numpy as np
    import torch

    from ofot_tpu_torch.cli import data_diff
    from ofot_tpu_torch.parallel import sweep as sweep_mod
    from ofot_tpu_torch.parallel.multihost import partition_keys
    from ofot_tpu_torch.utils import image as img, flo as flo_mod, metrics, warp

    data = Path(args.data_root)
    results = Path(args.results)
    # same per-host shard naming as the per-sequence path (cmd_run), so
    # two hosts batching the same results dir never clobber one manifest;
    # merge with `pipeline merge-manifests`
    manifest_name = ("manifest.json" if args.host_count == 1
                     else f"manifest.{args.host_id}.json")
    manifest_path = results / manifest_name
    manifest = (json.loads(manifest_path.read_text())
                if manifest_path.exists() else {})

    for ds_name in args.datasets.split(","):
        ds = data / ds_name
        out_root = results / ds_name
        out_root.mkdir(parents=True, exist_ok=True)
        loaded = []
        gts = {}
        seqs = _sequences(ds)
        if args.host_count > 1:      # DP over hosts: disjoint sequence sets
            mine = set(partition_keys([s.name for s in seqs],
                                      args.host_id, args.host_count))
            seqs = [s for s in seqs if s.name in mine]
        for seq in seqs:
            out_dir = out_root / seq.name
            out_dir.mkdir(exist_ok=True)
            f1, w, h = img.open_grayscale(str(seq / "frame10.png"))
            f2, w, h = img.open_grayscale(str(seq / "frame11.png"))
            data_diff.main([str(seq / "frame10.png"),
                            str(seq / "frame11.png"),
                            str(out_dir / "diff.png")])
            gt = _ground_truth_flo(ds, seq.name)
            if gt is not None:
                maxmotion = _gt_maxmotion(gt)
                if not (out_dir / "flow10.png").exists():
                    color_flow(gt, out_dir / "flow10.png", maxmotion)
                _, _, uGT, vGT = flo_mod.read_flo(str(gt))
                gts[seq.name] = (maxmotion, uGT, vGT)
            loaded.append((seq.name, f1.astype(dtype), f2.astype(dtype)))

        for algo in algos:
            pending = [(k, a, b) for k, a, b in loaded
                       if not (out_root / k /
                               f".out.{algo.lower()}.sucess").exists()]
            for shape, group in sweep_mod.group_by_shape(pending).items():
                keys = [k for k, _, _ in group]
                f1s = np.stack([a for _, a, _ in group])
                f2s = np.stack([b for _, _, b in group])
                n = len(keys)
                print(f"== batch {ds_name} [{algo}] shape={shape} "
                      f"n={n} ==", flush=True)
                t0 = _time.time()
                if dp is None:
                    u_d, v_d, m_d, diag = sweep_mod.solve_batch_full(
                        algo, f1s, f2s, None, **solve_kw)
                else:
                    u_d, v_d, m_d, diag = dp.solve(
                        algo, sweep_mod._pad_batch(f1s, dp.n)[0],
                        sweep_mod._pad_batch(f2s, dp.n)[0], **solve_kw)
                # the solve ends with the flows on the host, as the
                # per-sequence CLI's time does
                u, v = u_d.cpu().numpy(), v_d.cpu().numpy()
                wall = _time.time() - t0
                f1s_d = torch.as_tensor(f1s, device=device)
                rec = np.clip(np.stack([
                    warp.apply_flow(f1s_d[i], u_d[i], v_d[i], m_d[i])
                    .cpu().numpy() for i in range(n)]), 0, 1)
                m = m_d.cpu().numpy()

                for i, key in enumerate(keys):
                    out_dir = out_root / key
                    h, w = shape
                    pre = out_dir / algo.lower()
                    flo_mod.write_flo(w, h, u[i].ravel(), v[i].ravel(),
                                      f"{pre}.flo")
                    ie = metrics.IE(w, h, rec[i], f2s[i])
                    gt = gts.get(key)
                    with open(f"{pre}.benchmark.txt", "w") as f:
                        if gt is not None:
                            # same layout as main.py / reference
                            # main.py:125-134
                            maxmotion, uGT, vGT = gt
                            aee, sdee = metrics.EE(w, h, u[i].ravel(),
                                                   v[i].ravel(), uGT, vGT)
                            aae, sdae = metrics.AE(w, h, u[i].ravel(),
                                                   v[i].ravel(), uGT, vGT)
                            f.write("EE-mean: " + str(aee) + "\n")
                            f.write("EE-stddev: " + str(sdee) + "\n")
                            f.write("AE-mean: " + str(aae) + "\n")
                            f.write("AE-stddev: " + str(sdae) + "\n")
                        f.write("IE: " + str(ie) + "\n")
                        f.write("time: " + str(wall / n) + "s")
                    img.save_grayscale(rec[i], f"{pre}.rec.png")
                    img.save_grayscale((m[i] + 1) / 2, f"{pre}.lum.png")
                    color_flow(Path(f"{pre}.flo"), Path(f"{pre}.png"),
                               gt[0] if gt is not None else None)
                    entry = manifest.setdefault(f"{ds_name}/{key}", {})
                    entry[algo] = {"algo": algo, "status": "ok",
                                   "wall_s": wall / n, "batched": True,
                                   "batch_size": int(n),
                                   "batch_mode": args.batch_mode,
                                   # the group's first-call set-up (kernel
                                   # library load, cuBLAS) is amortized
                                   # into every row's wall_s
                                   "wall_includes_compile": True}
                    # per-sequence solver diagnostics (convergence is
                    # otherwise invisible in batch mode)
                    for dk, dv in diag.items():
                        dv = np.asarray(dv)
                        entry[algo][dk] = (
                            float(dv[i]) if dv.ndim else float(dv))
                    if algo == "sinkhorn" and precision != "f64":
                        # f32-floor escalation, batch form: the flagged
                        # sequence re-solves per sequence with the exact
                        # stabilizer, then at f64, on the batch's device
                        # (same remedy as the per-sequence path; see
                        # _maybe_escalate_sinkhorn).  Skipped when the
                        # whole batch already ran f64 — a re-solve would
                        # reproduce the same result
                        sp = solve_kw["sinkhorn_params"]
                        esc = [f"--platform={device.type}",
                               f"--sinkhorn-epsilon={sp['epsilon']}",
                               f"--sinkhorn-tol={sp['tol']}",
                               f"--max-it={sp['max_iter']}"]
                        if "theta" in sp:
                            esc.append(f"--sinkhorn-theta={sp['theta']}")
                        if "stabilizer" in sp:
                            # a pinned batch stabilizer rides along so
                            # rung 1 can see it (exact pin -> skip the
                            # redundant identical re-solve; matmul pin is
                            # still overridden by the escalation — the
                            # safety net outranks the pin, and the rung-1
                            # message says so)
                            esc.append("--sinkhorn-stabilizer="
                                       f"{sp['stabilizer']}")
                        seq_dir = ds / _data_subdir(ds) / key
                        argv, stats_path = _algo_argv(
                            algo, seq_dir / "frame10.png",
                            seq_dir / "frame11.png", out_dir, esc,
                            _ground_truth_flo(ds, key))
                        _maybe_escalate_sinkhorn(entry[algo], argv,
                                                 stats_path, wall / n)
                        if entry[algo].get("escalated_f64") or \
                                entry[algo].get("escalated_exact"):
                            color_flow(Path(f"{pre}.flo"), Path(f"{pre}.png"),
                                       gt[0] if gt is not None else None)
                    # resume flag only after any escalation completed: a
                    # flag touched before it would mark an interrupted
                    # escalation's biased f32 flow as done forever
                    (out_dir / f".out.{algo.lower()}.sucess").touch()
                manifest_path.write_text(json.dumps(manifest, indent=1))
    return 0


def cmd_merge_manifests(args) -> int:
    from ofot_tpu_torch.parallel.multihost import merge_manifests
    results = Path(args.results)
    shards = sorted(results.glob("manifest.*.json"))
    merge_manifests(shards, str(results / "manifest.json"))
    print(f"merged {len(shards)} shards")
    return 0


def cmd_restart(args) -> int:
    results = Path(args.results)
    if results.exists():
        shutil.rmtree(results)
    return cmd_run(args)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="ofot_tpu_torch benchmark pipeline")
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("download", help="fetch + prepare datasets")
    d.add_argument("--data-root", default="data")
    d.add_argument("--local-zip", help="use a local eval-gray-twoframes.zip "
                   "(zero-egress environments)")
    d.add_argument("--resize-percent", type=int, default=50)
    d.add_argument("--lum-seed", type=int, default=12345)
    d.add_argument("--with-middlebury2", action="store_true",
                   help="also fetch middlebury-2 data + ground-truth flows")
    d.add_argument("--local-zip-mb2-data",
                   help="local other-gray-twoframes.zip")
    d.add_argument("--local-zip-mb2-gt", help="local other-gt-flow.zip")
    d.set_defaults(fn=cmd_download)

    for name, fn in (("run", cmd_run), ("restart", cmd_restart)):
        r = sub.add_parser(name, help=f"{name} the sweep")
        r.add_argument("--data-root", default="data")
        r.add_argument("--results", default="results")
        r.add_argument("--datasets", default="middlebury-1,middlebury-1-lum")
        r.add_argument("--algos", default="GN,foto")
        r.add_argument("--platform", choices=["cuda", "cpu"],
                       help="torch device of every solve (the port's CLI "
                            "default, cuda, when absent)")
        r.add_argument("--precision", choices=["f32", "f64"])
        r.add_argument("--extra-args", default="",
                       help="extra CLI args appended to every solve "
                            "(later flags override the canonical ones)")
        r.add_argument("--host-id", type=int, default=0,
                       help="this host's index for DP sequence sharding")
        r.add_argument("--host-count", type=int, default=1,
                       help="total hosts sweeping in parallel")
        r.add_argument("--batch", action="store_true",
                       help="solve all same-shape sequences of a dataset "
                            "as one batch instead of per-sequence")
        r.add_argument("--data-parallel", type=int, default=1,
                       help="split the batch axis over this many ranks "
                            "(batch mode): this process starts the other "
                            "N-1, each on cuda:{rank %% cards}, or the "
                            "CPU with --platform=cpu")
        r.add_argument("--batch-mode", choices=["map", "vmap"],
                       default="map",
                       help="batch execution: 'map' solves the pairs one "
                            "after another on the device (default); "
                            "'vmap' solves them as one lockstep batch")
        r.set_defaults(fn=fn)

    m = sub.add_parser("merge-manifests",
                       help="merge per-host manifest shards")
    m.add_argument("--results", default="results")
    m.set_defaults(fn=cmd_merge_manifests)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
