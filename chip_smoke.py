#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ofot_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py              # from the repository root

Phases, each printed with its elapsed seconds:

1. device: the card's name and power limit (nvidia-smi); no card, no run;
2. build: one ``nvcc`` per ``ofot_tpu_torch/csrc/*.cu`` source, all
   started together, then one link into ``ofot_tpu_torch/_build/``
   (plain C interface, loaded with ctypes);
3. kernel vs plain: the fused stepB/stepC/criterion kernel against its
   plain torch version on the same CUDA tensors, at (3|4, 16, 240, 320),
   alpha 1 and 1.7, with repeat launches bitwise-equal in the criterion
   sums; times of both beside the kernel's bound;
4. main path: the port's CLI runs the sweep's FOTO solve (FOTO_ARGS,
   320x240, Nt=16, stepA auto -> the fused kernel) on a seeded textured
   pair, and must launch the kernel once per ALG2 iteration, reduce IE
   below the identity warp's and write a 320x240 .flo;
5. card vs CPU: 20 fixed ALG2 iterations at full size on the card (kernel)
   and on the CPU (plain version), crit trajectory and phi compared;
6. profile: a torch.profiler window of ALG2 iterations on the card (kernel
   time by name, the device's busy share) and the CLI's solve again, warm;
7. kernels vs plain: the spectral stepA kernel (dct_solve), the standalone
   projection and the stepA operator (both entry points) against their
   plain torch versions at the sweep shape and at tile-edge shapes, repeat
   launches bitwise-equal, with times beside each kernel's bound (for
   dct_solve both the float32 bound and the bound of the TF32 tensor cores
   its 3xTF32 design runs on) and, where one PyTorch call computes the
   same function, that call's time; dct_solve and its float32 plain
   version each against the float64 solve at the sweep shape, over seeds;
8. paths: the CLI at 320x240 on the same pair, each path with every launch
   count set to 0 just before it and read just after: FOTO with
   ``--stepA-solver=dct-fused``, FOTO with ``cg-pallas`` (``--max-it`` cut),
   WFR at WFR_ARGS with ``auto`` (the fused kernel at 4 components) and with
   ``dct-fused``.  Each must launch its kernel once per ALG2 iteration (or
   CG step), end without NaN and reduce IE below the identity warp's;
9. WFR card vs CPU: 20 fixed WFR iterations, as phase 5;
10. new-path profile: torch.profiler windows of the phase-8 paths (device
   busy share, kernel time by name) and warm solves, WFR ``auto`` and
   ``dct`` side by side;
11. gn/hs paths: the CLI at 320x240 on the same pair, with the launch
   counts set to 0 just before each and read just after: GN at GN_ARGS,
   GN with ``--pyramid-levels=4``, HS, and FOTO with
   ``--stepA-solver=dct-refined``.  None launches a kernel; each must
   report convergence (FOTO: end on the criterion before max-it), end
   without NaN, write a 320x240 .flo and reduce IE below the identity
   warp's;
12. gn card vs cpu: GN ``solve_fields`` and one GN pyramid solve at
   float32 on the card and on the CPU, CG steps and fields compared;
   warm solves and profiler windows (device busy share, kernel time by
   name) of the phase-11 paths;
13. sinkhorn and outputs: the CLI on the same pair, the launch counts set
   to 0 just before each run and read just after: Sinkhorn at the sweep's
   SINKHORN_ARGS with the ``auto`` stabilizer (as the pipeline runs it,
   ``--quiet --log-jsonl``) and again with ``--sinkhorn-stabilizer=exact``;
   each must converge to the tolerance, write a finite 320x240 .flo,
   reduce IE below the identity warp's, log a ``solve`` record with the
   JAX CLI's Sinkhorn keys and launch no kernel.  Then FOTO ``auto`` with
   ``--max-it`` cut, writing every new output: the 16 density frames and
   the flow visualization as PNG (header and decompressed length checked,
   no Pillow), a profiler trace that names the fused kernel, and a JSONL
   record with the JAX CLI's FOTO keys;
14. sinkhorn card vs cpu, float32: fixed-iteration solves with both
   stabilizers, the exact softmin statistics against the CPU's float64
   ones, the flow at SINKHORN_ARGS, the envelope gradients of the
   debiased divergence and the implicit GN gradient w.r.t. alpha, and the
   device color wheel against numpy's; the TF32 settings around a solve;
   profiler windows of a matmul and an exact check block (ms and device
   ms per Sinkhorn iteration, launches per iteration, idle share);
15. pipeline: the port's sweep (``cli/pipeline.py``) in process, on
   Middlebury-layout data written here as PNG without Pillow, as
   ``download`` lays it out: 3 middlebury-1 sequences (seeded textured
   pairs at 320x240 moved by integer shifts), the middlebury-1-lum set
   made from them by the pipeline's illumination augmentation, both
   mass-normalized by the pipeline, and 2 middlebury-2 sequences at
   Middlebury's native 584x388 and 640x480 with a constant ground-truth
   flow.  ``run`` over GN, foto, WFR and sinkhorn with the launch counts
   set to 0 just before and read just after: every artifact and manifest
   key, finite flows of each frame size, well-formed PNGs, FOTO and WFR
   on the fused kernel (``pallas``), Sinkhorn to its tolerance in
   float32 on the card (a float64 re-solve or a failed escalation fails
   the phase), IE below each sequence's identity warp's, GN's EE below
   the zero flow's, and ``fused_pointwise`` launched once per FOTO and
   WFR ALG2 iteration; ``run`` again solves nothing (0 launches, the
   manifest unchanged); ``run --batch`` (map mode, one group per dataset
   and frame size) with the same checks, its flows within AEPE 1e-4 of
   the per-sequence flows with the same iteration counts; then
   ``parallel.sweep.solve_batch_full`` on the middlebury-1 pairs bitwise
   against single-pair solves.  Prints per algo and frame size the
   median wall, solver wall and time outside the solve.
16. lockstep: the lockstep batch (``batch_mode="vmap"``).  Kernels #1
   (k = 2/3, alpha 1/1.7), #2 and #4 in their batched forms at 8 pairs x
   (16, 240, 320) with a per-pair r, each against its plain version and
   against 8 single-pair launches (bitwise: #1's fields and sums, #2's
   slice kernel, #4), timed beside 8x the single-pair bound and beside the
   8 single launches.  ``solve_batch_full`` on 8 seeded textured 320x240
   pairs with distinct shifts at the pipeline's parameters, in map mode
   and in lockstep, for foto, WFR (``auto``), GN and sinkhorn: each pair
   stops before its cap, its IE lies below the identity warp's and within
   0.5% of map mode's, and where its count equals map mode's its flow lies
   within AEPE 1e-3; ``fused_pointwise`` launched once per lockstep
   iteration (the slowest pair's count) for foto and WFR, no kernel for GN
   and Sinkhorn.  FOTO ``dct-fused`` and ``cg-pallas`` (``--max-it`` cut
   to LOCKSTEP_CG_PALLAS_MAX_IT) at 4 pairs: ``dct_solve`` once per
   lockstep iteration, ``cg_operator_blocked`` once per lockstep CG step;
   FOTO with ``auto_r`` at 8 pairs.  A profiler window of lockstep FOTO
   iterations (device idle share), map against lockstep wall / n per
   algo, ms per lockstep iteration and peak memory.  Then ``run --batch
   --batch-mode=vmap`` on phase 15's data with phase 15's checks, each
   row's IE within 0.5% of the map batch's.  The batched #4's 39 MB
   operand fits the L2, so it is timed cold too (rotating sets, as #3).
17. bench: the port's bench (``ofot_tpu_torch.bench``, in process) at its
   defaults (320x240, Nt=16, 200 fixed iterations, best of 5, the GN, WFR
   and Sinkhorn families), then with ``--ops dct-fused`` and with
   ``--batch 8`` (families off, best of 2); each JSON line logged, every value
   finite, no ``families_error``; with the launch counts set to 0 just
   before each run and read just after, ``fused_pointwise`` launched once
   per ALG2 iteration of the ``auto`` (``pallas``) and batch runs (the WFR
   family's iterations included) and ``dct_solve`` once per stepA solve of
   the ``dct-fused`` run.
18. distribution, every leg at 320x240, Nt=16: (a) this process as a world
   of one rank on NCCL with a (1, 1) mesh: the tiled FOTO (cg set) and the
   tiled GN (Jacobi) bitwise the single-device solves with the same method;
   (b) four processes sharing the card on a gloo 2x2 mesh: tiled FOTO, WFR
   and GN against the whole solves at float64 (atol 1e-8), the GSPMD route
   with the ``pallas`` and ``dct-fused`` sets at float32 to their stopping
   rule against the whole solve with the same set per solve (IE within
   0.5%), the fused kernel (``pallas``, on the rank's tile) or the stepA
   solve (``dct-fused``, on the gathered F) launched once per iteration on
   every rank; the world's start-up logged apart from its cases; (c) ``run
   --batch --data-parallel 2``, then 4, on phase 15's middlebury-1 data
   against the one-process map batch (AEPE < 1e-4); (d) two
   ``multihost_worker`` processes with ``--platform cuda``, each leg's wall
   logged.  Cuts: the tiled FOTO and WFR run DIST_MAX_IT iterations, the
   tiled GN at most DIST_GN_MAXITER CG steps, the workers' FOTO
   DIST_WORKER_ITERS iterations.  Each leg's wall is logged.
19. device loops: every solver loop at 320x240 on the host loop
   (``loop="host"``) and on the device loop (``loop="device"``, captured
   graphs of K iterations, ``solvers/device_loop.py``) in one call, the
   device loop twice (cold: it captures; warm: it replays the cached
   graph): FOTO ``pallas``, ``dct``, ``dct-fused``, ``dct-refined`` and
   ``cg-pallas`` (max-it cut to DEVICE_LOOP_CG_PALLAS_MAX_IT), WFR
   ``pallas`` and ``dct-fused``, GN, the 4-level GN pyramid, HS, the
   Sinkhorn flow (``auto`` and ``exact``) and the lockstep FOTO at 8
   pairs.  Each must give the host loop's fields bitwise, its iterations
   and CG steps, and the launch relation (below); the phase logs warm
   walls and ms per iteration (CG step) of both loops, capture ms, K and
   replays, a profiler window's idle share and the peak memory of each,
   then sweeps K over DEVICE_LOOP_BLOCKS on FOTO ``pallas``.
20. examples and tools: the five examples (``ofot_tpu_torch.examples``:
   quickstart, unbalanced_flow, wasserstein, differentiable_ot,
   sharded_solve) with ``--platform cuda``, and the two tools of the
   differentiable layer: ``w2_gradient_flow`` at its defaults (48, 12
   steps; S strictly decreasing; the CPU run its first W2_CPU_STEPS
   steps) and ``tune_gn`` at float64 on a
   Middlebury-2 layout written here (TUNE_SHIFTS: seeded textures at
   320x240 with a constant ground truth as ``.flo``; TUNE_STEPS Adam
   steps).  Each run with the launch counts set to 0 just before and
   read just after, then each again on the CPU (three processes at
   once, CPU_GROUPS): every returned number within
   EXAMPLE_TOLERANCES / TOOL_RTOL of the CPU run (the CPU tests'
   bounds; tune_gn's parameters and EE 1e-6), ``fused_pointwise``
   launched by unbalanced_flow's WFR (``auto`` = ``pallas``) by the
   replay relation, no kernel elsewhere (sharded_solve's one rank
   reports its own counts, a 1x1 mesh on the card, a 2x2 gloo world of
   4 ranks on the CPU).  Each run's card and CPU seconds, launches and
   peak memory are logged; #1's record gains ``examples_launches``.

On the card every solver loop runs on the device loop by default, so
wherever a phase held a kernel's launches to the iterations (phases 4, 8,
13, 15, 16, 17 and 19), ``check_launches`` holds the replay relation
instead: launches = warm-up launches (one iteration a capture) + replayed
launches, replayed launches = the iteration slots of the replays that
launched the kernel (replays x K), and iterations <= slots <= iterations
+ (K - 1) a loop.  Host loops (phase 17's ``--loop host`` run, phase 19's
host runs, the tiled and GSPMD loops of phase 18) keep launches =
iterations.

Kernel #3's working set (29-39 MB) fits the card's 50 MB L2, so phase 7
times it a second time cold, rotating over four input and output sets
(118-157 MB), and states its share of the bound from the cold device
time.  Kernel #1's smallest working set (59 MB) already exceeds L2.

Kernel times (``ms``, ``plain_ms``, ``library_ms``) are CUDA-event times of
back-to-back calls (``cuda_time_ms``), as every earlier run of this script
took them.  The device time of the same calls (``device_time_ms``: the
kernels' own run time on the card, from the profiler, without the gaps in
which the card waits for the host) stands beside each under
``device_ms``, ``plain_device_ms`` and ``library_device_ms``.

The last two lines are the kernels' JSON record and the result line
``{"ok": true, "device": {...}}``.  Any failure raises, so the exit code is
not 0 and no result line is printed.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import io
import json
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np
import torch

import ofot_tpu_torch.ops.kernels.fused_pointwise as fp
from ofot_tpu_torch.cli import main as cli
from ofot_tpu_torch.ops import kernels
from ofot_tpu_torch.ops.kernels import _build
from ofot_tpu_torch.ops.kernels import cg_operator as cgk
from ofot_tpu_torch.ops.kernels import dct_solve as ds
from ofot_tpu_torch.ops.kernels import projection as pk
from ofot_tpu_torch.ops import operators
from ofot_tpu_torch.solvers import (dct, device_loop, foto, gn, hs, pyramid,
                                    sinkhorn, wfr)
from ofot_tpu_torch.utils import flo, image, metrics

SEED = 0
SHAPE = (16, 240, 320)                     # (Nt, Ny, Nx) of the sweep
FOTO_ARGS = ["--algo=foto", "--r=1", "--convergence-tol=0.01",
             "--reg-epsilon=1e-2", "--Nt=16", "--max-it=200",
             "--admm-alpha=1.7"]           # ofot_tpu/cli/pipeline.py:61-63
WFR_ARGS = ["--algo=WFR", "--r=1", "--convergence-tol=0.01",
            "--reg-epsilon=1e-2", "--Nt=16", "--max-it=200",
            "--wfr-delta=2.5", "--admm-alpha=1.7"]  # pipeline.py:58-60
GN_ARGS = ["--algo=GN", "--alpha=0.1", "--lambda=0.2"]  # pipeline.py:40
HS_ARGS = ["--algo=HS", "--alpha=0.1"]
SINKHORN_ARGS = ["--algo=sinkhorn", "--sinkhorn-epsilon=100.0",
                 "--max-it=1000"]          # pipeline.py:75-76
SINKHORN_EPS, SINKHORN_TOL = 100.0, 1e-4
PYRAMID_LEVELS = 4
ADMM_ALPHA = 1.7
WFR_DELTA = 2.5
CARD_VS_CPU_ITERATIONS = 20
PROFILE_ITERATIONS = 10
# The cg-pallas path runs hundreds of CG steps per ALG2 iteration, and the
# port's CG syncs once per step: FOTO_ARGS' max-it is cut to this many
# ALG2 iterations so that the path stays under about 20 s (234 CG steps
# and 80 ms per ALG2 iteration on an H100 SXM at 700 W, 20-iteration run).
CG_PALLAS_MAX_IT = 100

# Kernel vs plain version, float32 on the card.  The kernel takes
# cbrtf/acosf where the plain version takes the Pallas kernel's exp/log and
# Newton forms, and nvcc fuses multiply-adds: elementwise agreement to a
# few hundred ulps of O(1) values; the criterion sums (1.2M float32
# products, summed in another order) to 1e-5 relative.  The standalone
# projection is held to the same elementwise bound.
KERNEL_ATOL, KERNEL_RTOL, SUM_RTOL = 2e-5, 1e-5, 1e-5
# The spectral solve: relative to max|phi|, tests/test_pallas.py's bound for
# the Pallas solve (the same float32 products summed in another order, then
# divided by eigenvalues down to r*eps).  The stepA operator: absolute,
# tests/test_pallas.py's bound for the Pallas operator.
DCT_RTOL, CG_ATOL = 5e-6, 1e-5
# Card vs CPU after 20 float32 ALG2 iterations: about 70x the float32 vs
# float64 drift of the same run at 80x60 (1.5e-5 on crit, 1.2e-6 of
# max|phi| on phi) — the products and sums of each iteration round
# differently on the two devices, and ADMM carries that forward.
CRIT_RTOL, PHI_RTOL = 1e-3, 1e-4
# GN card vs CPU, both float32, CG to rtol 1e-10: fields relative to their
# max, CG steps per solve.  On this pair the float32 solve on the CPU lies
# 5-7e-7 from the float64 one (single level) and up to 4.5e-6 (the pyramid's
# m), and takes 2 more CG steps (65 against 63); the card differs from the
# CPU only in summation order, so 1e-4 is ~20-150x what rounding gives.
GN_FIELD_RTOL, GN_STEP_SLACK = 1e-4, 3
# Sinkhorn card vs CPU, both float32, on the pair at eps 100.  On the CPU
# the float32 results lie this far from the float64 ones: 100 matmul-softmin
# iterations, f and g within 6.2e-7 and 7.6e-6 of their max, the cost
# 1.9e-8 relative; 10 exact-softmin iterations, 1.5e-7, 1.9e-6 and 2.8e-8
# (an exact softmin takes 0.15-0.25 s on the CPU, hence 10 there); the exact
# statistics 9.1e-7 of their max (S; the means 2.9-4.2e-7); the flow at
# SINKHORN_ARGS 5.1e-4 px, the same 250 iterations; the divergence's
# gradient 1.7e-5 of its max and its value 2.6e-4 absolute (a difference of
# two ~97 px^2 costs); the implicit alpha gradient 8.5e-7 relative.  The
# card differs from the CPU in summation order and in its exp/log, about as
# float32 differs from float64, so each bound is ~20-50x that drift.
SK_MATMUL_ITERS, SK_EXACT_ITERS = 100, 10
SK_POT_RTOL, SK_COST_RTOL = 2e-4, 1e-6
SK_STATS_RTOL = 2e-5
SK_FLOW_ATOL, SK_ITER_SLACK = 1e-2, 25
SK_GRAD_RTOL, SK_VALUE_ATOL = 5e-4, 5e-3
IMPLICIT_RTOL = 2e-5
SINKHORN_KEYS = {"ts", "event", "algo", "f0", "f1", "w", "h", "wall_s", "IE",
                 "iterations", "marginal_error", "epsilon", "stabilizer",
                 "wasserstein2", "w2_marginal_error"}
FOTO_KEYS = {"ts", "event", "algo", "f0", "f1", "w", "h", "wall_s", "IE",
             "iterations", "inner_iterations", "crit", "stepA_solver",
             "wasserstein2"}
OUTPUTS_MAX_IT = 20
# The card's L2 (H100 SXM: 50 MB); cold timings rotate over enough buffer
# sets to pass it several times
L2_BYTES = 50e6

# Memory bytes/s and float32 FLOP/s outside the tensor cores of the H100
# SXM, and its dense TF32 tensor-core rate (NVIDIA's data sheet, 700 W
# power limit)
H100_SXM = "NVIDIA H100 80GB HBM3"
MEM_BW, F32_RATE, TF32_RATE = 3.35e12, 67e12, 495e12


def _log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.time()
        _log(f"== phase {self.name}")
        return self

    def __exit__(self, exc_type, exc, tb):
        state = "done" if exc_type is None else "FAILED"
        _log(f"== phase {self.name} {state} in "
             f"{time.time() - self.t0:.2f} s")
        return False


def nvidia_smi_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True)
    return proc.stdout.strip().splitlines()[0]


def card_rates(name: str):
    if name != H100_SXM:
        raise RuntimeError(f"no memory/compute rates known for {name!r}")
    return MEM_BW, F32_RATE


def cuda_time_ms(fn, samples: int = 20, calls: int = 10) -> float:
    """Event time of one ``fn()``: the median over ``samples`` samples of
    the mean of ``calls`` back-to-back calls between two CUDA events, after
    3 warm-up calls.  Where the host takes longer to enqueue a call than
    the card to run it (kernels of a few microseconds), this measures the
    host."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def device_time_ms(fn, calls: int = 20, windows: int = 5) -> float:
    """Device time of one ``fn()``: the run time of the kernels it launches
    on the card (torch.profiler's CUDA activity), summed over ``calls``
    back-to-back calls and divided by ``calls``; the median of ``windows``
    windows, after 3 warm-up calls.  Gaps in which the card waits for the
    host are not counted.  A window in which the profiler recorded no
    device activity at all (seen once on an H100, in a window whose
    neighbours recorded the same launches) is taken again, up to three
    times the windows; if none records any, this raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(3 * windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            times.append(us / 1e3 / calls)
        if len(times) == windows:
            break
    if len(times) < windows:
        _log(f"  the profiler recorded device activity in {len(times)} of "
             f"{3 * windows} windows")
    if not times:
        raise RuntimeError("the profiler recorded no device activity")
    return statistics.median(times)


def bound(nbytes: float, ops: float, mem_bw: float, f32_rate: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the float32 rate."""
    t_bytes, t_ops = nbytes / mem_bw, ops / f32_rate
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def _timing_line(label, rec, bound_ms, bound_by, nbytes, ops, extra=""):
    ms, dev = rec["ms"], rec["device_ms"]
    _log(f"  {label} timing: kernel {ms:.4f} ms by events, {dev:.4f} ms "
         f"device{extra}; plain {rec['plain_ms']:.4f} ms by events, "
         f"{rec['plain_device_ms']:.4f} ms device; bound {bound_ms:.4f} ms "
         f"({bound_by}: {nbytes / 1e6:.1f} MB, {ops / 1e6:.1f} Mop), kernel "
         f"at {100 * bound_ms / ms:.1f}% of bound by events, "
         f"{100 * bound_ms / dev:.1f}% by device time")


def time_kernel(enqueue, plain, library=None, plain_calls=None):
    """Event and device times of a kernel's enqueue closure, of its plain
    version and of the library call.  ``plain_calls``: time the plain
    version over this many calls a sample and window (5 samples, 3
    windows) instead of the kernel's 200 and 100, for a plain version of
    tens of milliseconds."""
    if plain_calls is None:
        plain_ms, plain_dev = cuda_time_ms(plain), device_time_ms(plain)
    else:
        plain_ms = cuda_time_ms(plain, samples=5, calls=plain_calls)
        plain_dev = device_time_ms(plain, calls=plain_calls, windows=3)
    return dict(ms=cuda_time_ms(enqueue), device_ms=device_time_ms(enqueue),
                plain_ms=plain_ms, plain_device_ms=plain_dev,
                library_ms=None if library is None else cuda_time_ms(library),
                library_device_ms=None if library is None
                else device_time_ms(library))


# ------------------------------------------------------- kernel vs plain

def kernel_inputs(ncomp: int, relaxed: bool, device, seed: int = SEED):
    rng = np.random.default_rng(seed)
    full = (ncomp,) + SHAPE
    g = rng.uniform(-2, 2, full).astype(np.float32)
    m = rng.uniform(-1, 2, full).astype(np.float32)
    qp = rng.uniform(-2, 1, full).astype(np.float32) if relaxed else None
    return [None if a is None else torch.from_numpy(a).to(device)
            for a in (g, m, qp)]


def fused_pointwise_bound(g, m, r, alpha, qp, mem_bw, f32_rate):
    """(bound_ms, bound_by, bytes, operations) of one fused pass on these
    inputs.  Bytes: every input plane read once, q and mu' written once.
    Operations, counted from the kernel source per point: 3 a component
    for the relaxation, 2 for x + mu/r, 2k+2 for |b|^2 and the membership
    test, 10 for stepC and 10 for the criterion; points outside K add
    ~35 for the cubic root and the rescale."""
    ncomp = g.shape[0]
    k = ncomp - 1
    L = g[0].numel()
    n_in = 3 if qp is not None else 2
    nbytes = (n_in + 2) * g.numel() * g.element_size()
    x = g if qp is None else alpha * g + (1 - alpha) * qp
    p = x + m / r
    outside = int((2 * p[0] + (p[1:] ** 2).sum(0) > 0).sum())
    per_point = (3 * ncomp if qp is not None else 0) + 2 * ncomp \
        + 2 * k + 2 + 10 + 10
    ops = L * per_point + 35 * outside
    return (*bound(nbytes, ops, mem_bw, f32_rate), nbytes, ops)


def check_kernel(device, mem_bw, f32_rate):
    """Phase 3: every (ncomp, alpha) case checked against the plain
    version; returns the largest elementwise error and the timings by
    (ncomp, alpha)."""
    r = 1.0
    worst = 0.0
    timings = {}
    for ncomp in (3, 4):
        for alpha in (None, ADMM_ALPHA):
            g, m, qp = kernel_inputs(ncomp, alpha is not None, device)
            got = fp.fused_pointwise(g, m, r, alpha=alpha, q_prev=qp)
            again = fp.fused_pointwise(g, m, r, alpha=alpha, q_prev=qp)
            want = fp.fused_pointwise_reference(g, m, r, alpha, qp)
            torch.cuda.synchronize()
            case = f"ncomp={ncomp} alpha={alpha or 1.0}"
            for a, b, name in zip(got[:2], want[:2], ("q", "mu")):
                err = (a - b).abs()
                bad = int((err > KERNEL_ATOL + KERNEL_RTOL * b.abs()).sum())
                worst = max(worst, float(err.max()))
                _log(f"  {case} {name}: max |kernel - plain| = "
                     f"{float(err.max()):.3e}, outside tolerance: {bad}")
                if bad:
                    raise AssertionError(f"{case}: {name} disagrees with the "
                                         f"plain version at {bad} points")
            for a, b, name in zip(got[2:], want[2:], ("num", "den")):
                rel = abs(float(a) - float(b)) / abs(float(b))
                _log(f"  {case} {name}: kernel {float(a):.9g} plain "
                     f"{float(b):.9g} rel {rel:.3e}")
                if rel > SUM_RTOL:
                    raise AssertionError(f"{case}: {name} relative error "
                                         f"{rel:.3e} > {SUM_RTOL}")
            for i, name in enumerate(("q", "mu", "num", "den")):
                if not torch.equal(got[i], again[i]):
                    raise AssertionError(f"{case}: repeat launch changed "
                                         f"{name}")
            enqueue, _ = fp.prepare_launch(g, m, r, alpha, qp)
            rec = time_kernel(enqueue, lambda: fp.fused_pointwise_reference(
                g, m, r, alpha, qp))
            wrapper_ms = cuda_time_ms(lambda: fp.fused_pointwise(
                g, m, r, alpha=alpha, q_prev=qp))
            bound_ms, bound_by, nbytes, ops = fused_pointwise_bound(
                g, m, r, alpha, qp, mem_bw, f32_rate)
            timings[(ncomp, alpha)] = dict(rec, bound_ms=bound_ms,
                                           bound_by=bound_by)
            _timing_line(case, rec, bound_ms, bound_by, nbytes, ops,
                         f" (through the wrapper {wrapper_ms:.4f} ms a call "
                         "by events)")
            del g, m, qp, got, again, want
    return worst, timings


def _random(shape, device, seed, low=None, high=None):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(shape) if low is None
         else rng.uniform(low, high, shape))
    return torch.from_numpy(a.astype(np.float32)).to(device)


def check_dct_solve(device, mem_bw, f32_rate):
    """Phase 7, kernel #2: the whole solve against its plain version at
    three shapes and two (r, eps); the per-slice kernel timed alone through
    its enqueue closure, the plain slice body beside it, and the whole
    dct-fused stepA beside the port's cuBLAS spectral stepA.  Its bound is
    that of the units it runs on: three TF32 tensor-core products for each
    float32 product (3xTF32); the float32 bound is printed and kept beside
    it."""
    worst = 0.0
    for shape in (SHAPE, (5, 17, 23), (3, 63, 129)):
        for r, eps in ((1.0, 1e-2), (0.3, 1e-3)):
            F = _random(shape, device, SEED + 1)
            got = ds.dct_solve(F, r, eps)
            again = ds.dct_solve(F, r, eps)
            want = ds.dct_solve_reference(F, r, eps)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            rel = err / float(want.abs().max())
            worst = max(worst, err)
            _log(f"  dct_solve {shape} r={r} eps={eps}: max |kernel - "
                 f"plain| = {err:.3e}, / max|phi| = {rel:.3e}")
            if not rel <= DCT_RTOL:
                raise AssertionError(f"dct_solve {shape}: relative error "
                                     f"{rel:.3e} > {DCT_RTOL}")
            if not torch.equal(got, again):
                raise AssertionError(f"dct_solve {shape}: repeat launch "
                                     "changed phi")
    r, eps = 1.0, 1e-2
    F = _random(SHAPE, device, SEED + 1)
    p = ds.plan(SHAPE, F.dtype, F.device, r, eps)
    Fz = ds.t_forward(F, p)
    enqueue, _ = ds.prepare_launch(Fz, p)
    fused_ops, dct_ops = foto.stepA_ops("dct-fused"), foto.stepA_ops("dct")
    rec = time_kernel(enqueue, lambda: ds.slice_solve_reference(Fz, p),
                      lambda: dct_ops.stepA_solve(F, r, eps, 0, 0))

    def stepA():
        return fused_ops.stepA_solve(F, r, eps, 0, 0)

    stepA_ms, stepA_device_ms = cuda_time_ms(stepA), device_time_ms(stepA)
    Nt, Ny, Nx = SHAPE
    n = Nt * Ny * Nx
    # four contractions of depth Ny, Nx, Ny, Nx, and 5 operations a point
    # to assemble the divisor and divide
    mm_ops = 2 * n * (2 * Ny + 2 * Nx)
    ops = mm_ops + 5 * n
    # the slices in and out once; Cy, CyT, Cx, CxT and the eigenvalues once
    nbytes = 4 * (2 * n + 2 * Ny * Ny + 2 * Nx * Nx + Nt + Ny + Nx)
    f32_bound_ms, _ = bound(nbytes, ops, mem_bw, f32_rate)
    bound_ms = 1e3 * max(nbytes / mem_bw, 3 * mm_ops / TF32_RATE
                         + 5 * n / f32_rate)
    bound_by = "bytes" if nbytes / mem_bw >= 3 * mm_ops / TF32_RATE \
        else "operations"
    ms, dev = rec["ms"], rec["device_ms"]
    _timing_line("dct_solve (16, 240, 320)", rec, bound_ms, bound_by, nbytes,
                 3 * mm_ops + 5 * n,
                 f" ({ops / dev / 1e9:.2f} float32 TFLOP/s by device time)")
    _log(f"  dct_solve bounds: 3xTF32 on the tensor cores {bound_ms:.4f} ms "
         f"(kernel at {100 * bound_ms / ms:.1f}% by events, "
         f"{100 * bound_ms / dev:.1f}% by device time), float32 outside "
         f"them {f32_bound_ms:.4f} ms (kernel at "
         f"{100 * f32_bound_ms / ms:.1f}% by events, "
         f"{100 * f32_bound_ms / dev:.1f}% by device time)")
    _log(f"  stepA solve: dct-fused (t products + kernel) {stepA_ms:.4f} "
         f"ms by events, {stepA_device_ms:.4f} ms device; dct (six cuBLAS "
         f"fp32 matmuls) {rec['library_ms']:.4f} ms by events, "
         f"{rec['library_device_ms']:.4f} ms device")
    return dict(rec, max_abs_err=worst, bound_ms=bound_ms,
                bound_by=bound_by, f32_bound_ms=f32_bound_ms,
                stepA_ms=stepA_ms, stepA_device_ms=stepA_device_ms,
                f64=check_dct_solve_f64(device))


def check_dct_solve_f64(device, seeds: int = 4):
    """Phase 7, kernel #2 against the float64 solve: at the sweep shape,
    both (r, eps) and ``seeds`` seeds, the error of the kernel and that of
    the float32 plain version, each relative to max|phi| of the float64
    solve.  The kernel must stay within DCT_RTOL; both spreads are
    printed and returned as {(r, eps): {"kernel": [...], "plain": [...]}}.
    """
    errs = {}
    for r, eps in ((1.0, 1e-2), (0.3, 1e-3)):
        errs[(r, eps)] = {"kernel": [], "plain": []}
        for seed in range(seeds):
            F = _random(SHAPE, device, SEED + 10 + seed)
            exact = ds.dct_solve_reference(F.double(), r, eps)
            scale = float(exact.abs().max())
            for name, got in (("kernel", ds.dct_solve(F, r, eps)),
                              ("plain", ds.dct_solve_reference(F, r, eps))):
                errs[(r, eps)][name].append(
                    float((got.double() - exact).abs().max()) / scale)
        k, pl = errs[(r, eps)]["kernel"], errs[(r, eps)]["plain"]
        _log(f"  dct_solve vs float64 r={r} eps={eps}, {seeds} seeds, / "
             f"max|phi|: kernel {min(k):.3e}-{max(k):.3e} (median "
             f"{statistics.median(k):.3e}), float32 plain "
             f"{min(pl):.3e}-{max(pl):.3e} (median "
             f"{statistics.median(pl):.3e}); kernel / plain "
             f"{max(k) / max(pl):.2f} at the worst seed")
        if not max(k) <= DCT_RTOL:
            raise AssertionError(f"dct_solve r={r} eps={eps}: {max(k):.3e} "
                                 f"of max|phi| off the float64 solve > "
                                 f"{DCT_RTOL}")
    return {f"r={r},eps={eps}": v for (r, eps), v in errs.items()}


def check_projection(device, mem_bw, f32_rate):
    """Phase 7, kernel #3, at (3|4, 16, 240, 320); returns the largest
    error and the timings by component count."""
    worst, timings = 0.0, {}
    for ncomp in (3, 4):
        p = _random((ncomp,) + SHAPE, device, SEED + 2, -4.0, 3.0)
        got = pk.project_paraboloid(p)
        again = pk.project_paraboloid(p)
        want = pk.project_paraboloid_reference(p)
        torch.cuda.synchronize()
        err = (got - want).abs()
        bad = int((err > KERNEL_ATOL + KERNEL_RTOL * want.abs()).sum())
        worst = max(worst, float(err.max()))
        _log(f"  project_paraboloid ncomp={ncomp}: max |kernel - plain| = "
             f"{float(err.max()):.3e}, outside tolerance: {bad}")
        if bad or not torch.equal(got, again):
            raise AssertionError(f"project_paraboloid ncomp={ncomp}: "
                                 f"{bad} points off, or repeats differ")
        enqueue, _ = pk.prepare_launch(p)
        rec = time_kernel(enqueue,
                          lambda: pk.project_paraboloid_reference(p))
        k, L = ncomp - 1, p[0].numel()
        outside = int((2 * p[0] + (p[1:] ** 2).sum(0) > 0).sum())
        # per point 2k+2 for |b|^2 and the membership test; points outside
        # K add ~35 for the cubic root and the rescale
        ops = L * (2 * k + 2) + 35 * outside
        nbytes = 2 * p.numel() * p.element_size()
        bound_ms, bound_by = bound(nbytes, ops, mem_bw, f32_rate)
        _timing_line(f"project_paraboloid ncomp={ncomp}", rec, bound_ms,
                     bound_by, nbytes, ops)
        cold = cold_times(lambda i: pk.prepare_launch(_random(
            p.shape, device, SEED + 20 + i, -4.0, 3.0))[0], nbytes)
        _log(f"  project_paraboloid ncomp={ncomp} cold: "
             f"{cold['cold_ms']:.4f} ms by events, "
             f"{cold['cold_device_ms']:.4f} ms device over "
             f"{cold['cold_sets']} rotating sets; kernel at "
             f"{100 * bound_ms / cold['cold_device_ms']:.1f}% of bound by "
             "cold device time")
        timings[ncomp] = dict(rec, bound_ms=bound_ms, bound_by=bound_by,
                              **cold)
    return worst, timings


def cold_times(make_enqueue, nbytes):
    """Event and device times of a kernel whose working set (``nbytes``)
    fits in L2, measured cold: each call takes the next of enough input
    and output sets (``make_enqueue(i)`` binds set i) that the data moved
    between two uses of one set exceeds the L2 at least twice over."""
    sets = max(4, int(3 * L2_BYTES // nbytes) + 1)
    enqueues = [make_enqueue(i) for i in range(sets)]
    turn = [0]

    def fn():
        enqueues[turn[0] % sets]()
        turn[0] += 1

    return dict(cold_ms=cuda_time_ms(fn),
                cold_device_ms=device_time_ms(fn, calls=5 * sets),
                cold_sets=sets)


def _conv3d_operator(r, eps, device):
    """One PyTorch call computing the stepA operator: a 3x3x3 convolution
    (7-point stencil) with replicate padding, whose replicated halo gives
    exactly the 'N' rows (x[-1] = x0: x[-1] - 2x0 + x1 = -x0 + x1)."""
    conv = torch.nn.Conv3d(1, 1, 3, padding=1, padding_mode="replicate",
                           bias=False).to(device)
    w = torch.zeros(3, 3, 3)
    w[1, 1, 1] = 6.0 * r + r * eps
    for idx in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0),
                (1, 1, 2)):
        w[idx] = -r
    with torch.no_grad():
        conv.weight.copy_(w[None, None])
    conv.requires_grad_(False)
    return lambda x: conv(x[None, None])[0, 0]


def check_cg_operator(device, mem_bw, f32_rate):
    """Phase 7, kernels #4 and #5 (one CUDA kernel behind two entry
    points) at two shapes; timings at the sweep shape, with a replicate-
    padded conv3d as the library call (TF32 off)."""
    torch.backends.cudnn.allow_tf32 = False
    r, eps = 1.0, 1e-2
    worst, out = 0.0, {}
    for shape in (SHAPE, (5, 17, 23), (17, 33, 131)):
        x = _random(shape, device, SEED + 3)
        want = cgk.cg_operator_reference(x, r, eps)
        for name, fn in (("cg_operator", cgk.cg_operator),
                         ("cg_operator_blocked", cgk.cg_operator_blocked)):
            got, again = fn(x, r, eps), fn(x, r, eps)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            worst = max(worst, err)
            _log(f"  {name} {shape}: max |kernel - plain| = {err:.3e}")
            if not err < CG_ATOL or not torch.equal(got, again):
                raise AssertionError(f"{name} {shape}: error {err:.3e} or "
                                     "repeats differ")
    x = _random(SHAPE, device, SEED + 3)
    conv = _conv3d_operator(r, eps, device)
    conv_err = float((conv(x) - cgk.cg_operator_reference(x, r, eps)
                      ).abs().max())
    enqueue, _ = cgk.prepare_launch(x, r, eps)
    rec = time_kernel(enqueue, lambda: cgk.cg_operator_reference(x, r, eps),
                      lambda: conv(x))
    # per point: 3 axes x 3 (two adds, one multiply), 2 adds, 3 for the axpy
    ops = 14 * x.numel()
    nbytes = 2 * x.numel() * x.element_size()
    bound_ms, bound_by = bound(nbytes, ops, mem_bw, f32_rate)
    _timing_line("cg_operator (16, 240, 320)", rec, bound_ms, bound_by,
                 nbytes, ops)
    _log(f"  library: replicate-padded conv3d {rec['library_ms']:.4f} ms by "
         f"events, {rec['library_device_ms']:.4f} ms device (max |conv - "
         f"plain| = {conv_err:.3e})")
    for name in ("cg_operator", "cg_operator_blocked"):
        out[name] = dict(rec, bound_ms=bound_ms, bound_by=bound_by)
    return worst, out


# ------------------------------------------------------------ main path

def textured_pair(h: int, w: int, shift=(2, 3), seed: int = SEED,
                  sigma: float = 3.0):
    """A smooth random texture in [0.1, 0.9] and the same texture moved by
    ``shift`` = (dy, dx) pixels (float64; writing them as PGM quantizes
    them to 8 bits)."""
    rng = np.random.default_rng(seed)
    pad = 16
    H, W = h + 2 * pad, w + 2 * pad
    ky = np.fft.fftfreq(H)[:, None]
    kx = np.fft.fftfreq(W)[None, :]
    tex = np.fft.ifft2(np.fft.fft2(rng.standard_normal((H, W))) * np.exp(
        -2 * (np.pi * sigma) ** 2 * (kx ** 2 + ky ** 2))).real
    tex = 0.1 + 0.8 * (tex - tex.min()) / (tex.max() - tex.min())
    dy, dx = shift
    f0 = tex[pad:pad + h, pad:pad + w]
    f1 = tex[pad - dy:pad - dy + h, pad - dx:pad - dx + w]
    return f0, f1


def write_pair(workdir: Path):
    """The seeded pair as PGM files, and the 8-bit frames read back."""
    _, h, w = SHAPE
    f0, f1 = textured_pair(h, w)
    p0, p1 = workdir / "f0.pgm", workdir / "f1.pgm"
    image.save_grayscale(f0, str(p0))
    image.save_grayscale(f1, str(p1))
    g0, _, _ = image.open_grayscale(str(p0))
    g1, _, _ = image.open_grayscale(str(p1))
    return p0, p1, (g0, g1)


def run_cli_path(workdir: Path, label: str, args, expect):
    """The CLI on the pair with every launch count set to 0 just before and
    read just after; ``expect(iterations, cg_steps)`` gives the launches
    each kernel must show.  Returns the run's record."""
    p0, p1 = workdir / "f0.pgm", workdir / "f1.pgm"
    d = workdir / label
    d.mkdir()
    out, bench, state = d / "flow.flo", d / "bench.txt", d / "state.npz"
    argv = [str(p0), str(p1), *args, f"--out={out}",
            f"--save-benchmark={bench}", f"--checkpoint={state}", "--quiet"]
    reset_counts()
    rc = cli.main(argv)
    launches = kernels.launch_counts()
    if rc != 0:
        raise AssertionError(f"{label}: CLI exited with {rc}")
    with np.load(state) as z:
        iterations, crit = int(z["iteration"]), float(z["crit"])
        cg_steps = int(z["cg_iterations"])
    ie, solve_s, ie_identity = check_cli_outputs(workdir, label, d)
    _log(f"  {label}: iterations={iterations} cg_steps={cg_steps} "
         f"crit={crit:.6g} launches={launches} solve_s={solve_s:.4f} "
         f"ms_per_alg2_iteration={1e3 * solve_s / max(iterations, 1):.4f} "
         f"IE={ie:.6g} IE_identity={ie_identity:.6g}")
    if not iterations > 0:
        raise AssertionError(f"{label}: no ALG2 iteration ran")
    check_launches(label, launches, expect(iterations, cg_steps),
                   loops=device_loop.stats)
    if not np.isfinite(crit):
        raise AssertionError(f"{label}: the solve ended on a NaN criterion")
    return dict(iterations=iterations, cg_steps=cg_steps, crit=crit,
                launches=launches, solve_s=solve_s, ie=ie,
                ie_identity=ie_identity)


def reset_counts() -> None:
    """Every kernel's launch count and the device loop's statistics set
    to 0."""
    kernels.reset_launch_counts()
    device_loop.reset_stats()


def check_launches(label, launches, expect, loops=None):
    """``expect`` gives, per kernel, the launches of the host loop: the
    iterations (or CG steps) that launch it once each; every other kernel
    must launch 0 times.  With ``loops`` (the device loop's statistics of
    the run), a kernel that captured graphs launched is held to the replay
    relation instead: launches = warm-up launches + replayed launches,
    replayed launches = the iteration slots of the replays that launched
    it (replays x K), and iterations <= slots <= iterations + (K - 1) a
    loop."""
    want = {k: 0 for k in kernels.KERNELS}
    want.update(expect)
    replayed = {} if loops is None else loops.graph_launches
    bad = []
    for k, n in want.items():
        if not replayed.get(k):
            if launches[k] != n:
                bad.append(f"{k}: {launches[k]} launches, expected {n}")
            continue
        eager, graph = loops.eager_launches.get(k, 0), replayed[k]
        slots, spare = loops.kernel_slots[k], loops.kernel_spare.get(k, 0)
        if not (launches[k] == eager + graph and graph == slots
                and eager <= loops.captures and n <= slots <= n + spare):
            bad.append(f"{k}: {launches[k]} launches = {eager} eager + "
                       f"{graph} replayed over {slots} slots (spare "
                       f"{spare}, {loops.captures} captures), for {n} "
                       "iterations")
    if bad:
        raise AssertionError(f"{label}: {'; '.join(bad)}")


def check_cli_outputs(workdir: Path, label: str, d: Path):
    """IE below the identity warp's and a finite 320x240 .flo; returns
    (IE, solve seconds, identity IE)."""
    _, h, w = SHAPE
    lines = dict(ln.split(": ", 1) for ln in
                 (d / "bench.txt").read_text().splitlines())
    ie, solve_s = float(lines["IE"]), float(lines["time"].rstrip("s"))
    g0, _, _ = image.open_grayscale(str(workdir / "f0.pgm"))
    g1, _, _ = image.open_grayscale(str(workdir / "f1.pgm"))
    ie_identity = metrics.IE(w, h, g0, g1)
    fw, fh, u, v = flo.read_flo(str(d / "flow.flo"))
    if not (np.isfinite(ie) and ie < ie_identity):
        raise AssertionError(f"{label}: IE {ie} not below the identity "
                             f"warp's {ie_identity}")
    if (fw, fh) != (w, h) or not (np.isfinite(u).all()
                                  and np.isfinite(v).all()):
        raise AssertionError(f"{label}: .flo is {fw}x{fh} or not finite")
    return ie, solve_s, ie_identity


def run_main_path(workdir: Path):
    """Phase 4: the CLI's FOTO solve with the fused kernel."""
    return run_cli_path(workdir, "foto-auto", FOTO_ARGS,
                        lambda it, cg: {"fused_pointwise": it})


def _wfr_history(a, b, n, ops):
    """n fixed WFR iterations (no stopping rule) -> (state, crit trace)."""
    state = wfr.init_state(a, b, SHAPE[0])
    crits = []
    for _ in range(n):
        state = wfr.alg2_iteration(state, a, b, r=1.0, delta=WFR_DELTA,
                                   reg_epsilon=1e-2, convergence_tol=0.0,
                                   ops=ops, admm_alpha=ADMM_ALPHA)
        crits.append(state.crit)
    return state, torch.stack(crits)


def _foto_history(a, b, n, ops):
    st, hist = foto.solve_potential_with_history(
        a, b, SHAPE[0], n, r=1.0, reg_epsilon=1e-2, admm_alpha=ADMM_ALPHA,
        ops=ops)
    return st, hist["crit"]


def card_vs_cpu(rho, history=_foto_history):
    """Phases 5 and 9: CARD_VS_CPU_ITERATIONS fixed ALG2 iterations on the
    card and on the CPU, same inputs, with the pallas ops set."""
    n = CARD_VS_CPU_ITERATIONS
    runs = {}
    for dev in ("cuda", "cpu"):
        a, b = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                for x in rho)
        t0 = time.time()
        st, crit = history(a, b, n, foto.stepA_ops("pallas"))
        crit = crit.cpu().double()
        phi = st.phi.cpu().double()
        el = time.time() - t0
        _log(f"  {dev}: {n} iterations in {el:.3f} s ({1e3 * el / n:.3f} ms "
             f"each, no per-iteration sync), crit {float(crit[0]):.6g} -> "
             f"{float(crit[-1]):.6g}")
        runs[dev] = (crit, phi)
    (c0, p0), (c1, p1) = runs["cuda"], runs["cpu"]
    crit_dev = float(((c0 - c1).abs() / c1.abs()).max())
    phi_dev = float((p0 - p1).abs().max() / p1.abs().max())
    _log(f"  max crit deviation (relative) {crit_dev:.3e} (tol "
         f"{CRIT_RTOL}), max phi deviation / max|phi| {phi_dev:.3e} (tol "
         f"{PHI_RTOL})")
    if not (crit_dev <= CRIT_RTOL and phi_dev <= PHI_RTOL):
        raise AssertionError("card and CPU trajectories disagree")
    return crit_dev, phi_dev


def profile_window(label: str, run, n: int, top: int = 15,
                   unit: str = "ALG2 iterations"):
    """Kernel time by name over ``run(n)`` on the card, and the device's
    busy share of the window's wall time; per-``unit`` figures divide by
    ``n``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run(n)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.time() - t0)
    events = prof.key_averages()
    device = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                    key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in device)
    _log(f"  {label} window: {n} {unit}, wall "
         f"{wall_us / 1e3:.3f} ms ({wall_us / 1e3 / n:.3f} ms each), device "
         f"busy {busy_us / 1e3:.3f} ms = {100 * busy_us / wall_us:.1f}% "
         f"(idle {100 - 100 * busy_us / wall_us:.1f}%), "
         f"{sum(e.count for e in device)} kernel launches")
    for e in device[:top]:
        _log(f"  {e.self_device_time_total / n:9.1f} us/iter "
             f"{e.count // n:4d}x  {e.key[:90]}")
    return events, busy_us / 1e3, wall_us / 1e3


def profile_alg2(rho):
    """Phase 6: kernel time by name over PROFILE_ITERATIONS ALG2 iterations
    on the card, the device's busy share of the window's wall time, and the
    CLI's solve again, warm."""
    from torch.autograd import DeviceType
    n = PROFILE_ITERATIONS
    a, b = (torch.as_tensor(x, dtype=torch.float32, device="cuda")
            for x in rho)
    kw = dict(r=1.0, reg_epsilon=1e-2, admm_alpha=ADMM_ALPHA,
              ops=foto.stepA_ops("pallas"))
    foto.solve_potential_with_history(a, b, SHAPE[0], 2, **kw)
    events, _, _ = profile_window("foto pallas", lambda k: (
        foto.solve_potential_with_history(a, b, SHAPE[0], k, **kw)), n)
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    for e in host[:10]:
        _log(f"  host {e.self_cpu_time_total / n:9.1f} us/iter "
             f"{e.count // n:4d}x  {e.key[:80]}")
    # the CLI's solve again, warm: stopping rule, one sync per iteration
    t0 = time.time()
    res = foto.solve(a, b, SHAPE[0], convergence_tol=0.01, max_it=200, **kw)
    res.u.cpu()
    el = time.time() - t0
    _log(f"  warm solve: {res.state.iteration} iterations in {el:.4f} s "
         f"({1e3 * el / res.state.iteration:.4f} ms each)")


# ------------------------------------------------------------ new paths

def run_paths(workdir: Path):
    """Phase 8: the four new paths through the CLI."""
    cut = [a for a in FOTO_ARGS if not a.startswith("--max-it")]
    _log(f"  cg-pallas cut: --max-it={CG_PALLAS_MAX_IT} (FOTO_ARGS has "
         "200)")
    return {
        "foto-dct-fused": run_cli_path(
            workdir, "foto-dct-fused",
            [*FOTO_ARGS, "--stepA-solver=dct-fused"],
            lambda it, cg: {"dct_solve": it}),
        "foto-cg-pallas": run_cli_path(
            workdir, "foto-cg-pallas",
            [*cut, f"--max-it={CG_PALLAS_MAX_IT}", "--stepA-solver=cg-pallas"],
            lambda it, cg: {"cg_operator_blocked": cg}),
        "wfr-auto": run_cli_path(
            workdir, "wfr-auto", WFR_ARGS,
            lambda it, cg: {"fused_pointwise": it}),
        "wfr-dct-fused": run_cli_path(
            workdir, "wfr-dct-fused",
            [*WFR_ARGS, "--stepA-solver=dct-fused"],
            lambda it, cg: {"dct_solve": it}),
    }


def profile_paths(rho):
    """Phase 10: profiler windows of the new paths and warm solves."""
    n = PROFILE_ITERATIONS
    a, b = (torch.as_tensor(x, dtype=torch.float32, device="cuda")
            for x in rho)
    foto_kw = dict(r=1.0, reg_epsilon=1e-2, admm_alpha=ADMM_ALPHA)
    wfr_kw = dict(foto_kw, delta=WFR_DELTA)
    for solver in ("dct-fused", "cg-pallas"):
        ops = foto.stepA_ops(solver)
        k = 1 if solver == "cg-pallas" else n
        foto.solve_potential_with_history(a, b, SHAPE[0], 1, ops=ops,
                                          **foto_kw)
        profile_window(f"foto {solver}", lambda m: (
            foto.solve_potential_with_history(a, b, SHAPE[0], m, ops=ops,
                                              **foto_kw)), k, top=8)
    for solver in ("pallas", "dct-fused"):
        ops = foto.stepA_ops(solver)
        _wfr_history(a, b, 1, ops)
        profile_window(f"wfr {solver}", lambda m: _wfr_history(a, b, m, ops),
                       n, top=8)
    # warm solves under the stopping rule, one sync per iteration
    runs = [("foto", s, foto.solve, foto_kw) for s in ("dct", "dct-fused")]
    runs += [("wfr", s, wfr.solve, wfr_kw)
             for s in ("pallas", "dct", "dct-fused")]
    for algo, solver, solve, kw in runs:
        ops = foto.stepA_ops(solver)
        solve(a, b, SHAPE[0], convergence_tol=0.01, max_it=2, ops=ops, **kw)
        torch.cuda.synchronize()
        t0 = time.time()
        res = solve(a, b, SHAPE[0], convergence_tol=0.01, max_it=200,
                    ops=ops, **kw)
        res.u.cpu()
        el = time.time() - t0
        _log(f"  warm {algo} {solver}: {res.state.iteration} iterations in "
             f"{el:.4f} s ({1e3 * el / res.state.iteration:.4f} ms each), "
             f"crit {float(res.state.crit):.6g}")


# ------------------------------------------------------ GN, HS, pyramid

def run_variational_path(workdir: Path, label: str, args):
    """Phase 11: a GN or HS path through the CLI, the launch counts set to
    0 just before and read just after; the CLI's ``solver:`` line gives the
    CG steps and convergence."""
    p0, p1 = workdir / "f0.pgm", workdir / "f1.pgm"
    d = workdir / label
    d.mkdir()
    argv = [str(p0), str(p1), *args, f"--out={d / 'flow.flo'}",
            f"--save-benchmark={d / 'bench.txt'}", "--quiet"]
    out = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    launches = kernels.launch_counts()
    if rc != 0:
        raise AssertionError(f"{label}: CLI exited with {rc}")
    line = [ln for ln in out.getvalue().splitlines()
            if ln.startswith("solver: ")][0]
    stats = dict(kv.split("=") for kv in line[len("solver: "):].split())
    ie, solve_s, ie_identity = check_cli_outputs(workdir, label, d)
    steps = int(stats["inner_iterations"])
    _log(f"  {label}: {line} launches={launches} solve_s={solve_s:.4f} "
         f"ms_per_cg_step={1e3 * solve_s / max(steps, 1):.4f} IE={ie:.6g} "
         f"IE_identity={ie_identity:.6g}")
    check_launches(label, launches, {})
    if stats["converged"] != "True":
        raise AssertionError(f"{label}: CG did not converge ({line})")
    return dict(cg_steps=steps, solve_s=solve_s, ie=ie, launches=launches,
                ie_identity=ie_identity)


def run_gn_hs_paths(workdir: Path):
    """Phase 11: GN, GN pyramid, HS and FOTO dct-refined through the CLI;
    none launches a kernel."""
    paths = {
        "gn": run_variational_path(workdir, "gn", GN_ARGS),
        "gn-pyramid": run_variational_path(
            workdir, "gn-pyramid",
            [*GN_ARGS, f"--pyramid-levels={PYRAMID_LEVELS}"]),
        "hs": run_variational_path(workdir, "hs", HS_ARGS),
        "foto-dct-refined": run_cli_path(
            workdir, "foto-dct-refined",
            [*FOTO_ARGS, "--stepA-solver=dct-refined"], lambda it, cg: {}),
    }
    refined = paths["foto-dct-refined"]
    max_it = int([a for a in FOTO_ARGS if a.startswith("--max-it")][0]
                 .split("=")[1])
    if not refined["iterations"] < max_it:
        raise AssertionError(f"foto-dct-refined ran to max-it {max_it} "
                             f"(crit {refined['crit']}) instead of ending on "
                             "the criterion")
    if refined["cg_steps"] != 4 * refined["iterations"]:
        raise AssertionError("foto-dct-refined: inner iterations are not "
                             "1 + refine = 4 per ALG2 iteration")
    return paths


def _rel_gap(a, b):
    """max |a - b| / max |b|, in float64 on the host."""
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return float((a - b).abs().max() / b.abs().max())


def _relative_gaps(card, cpu, names):
    return {k: _rel_gap(a, b) for k, a, b in zip(names, card, cpu)}


def gn_card_vs_cpu(rho):
    """Phase 12: GN solve_fields and one GN pyramid solve at float32 on
    the card and on the CPU: CG steps within GN_STEP_SLACK a solve, fields
    within GN_FIELD_RTOL of their max."""
    runs = {}
    for dev in ("cuda", "cpu"):
        a, b = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                for x in rho)
        t0 = time.time()
        single = gn.solve_fields(a, b)
        single.u.cpu()
        t1 = time.time()
        log = []
        pyr = pyramid.solve_gn_pyramid(a, b, levels=PYRAMID_LEVELS,
                                       cg_log=log)
        pyr[0].cpu()
        t2 = time.time()
        _log(f"  {dev}: GN {single.cg.iterations} CG steps in {t1 - t0:.4f} "
             f"s (converged {single.cg.converged}); pyramid CG steps "
             f"{[r.iterations for r in log]} in {t2 - t1:.4f} s")
        runs[dev] = (single, pyr, log)
    (s0, p0, l0), (s1, p1, l1) = runs["cuda"], runs["cpu"]
    gaps = _relative_gaps((s0.u, s0.v, s0.m), (s1.u, s1.v, s1.m), "uvm")
    pgaps = _relative_gaps(p0, p1, "uvm")
    steps = [(s0.cg.iterations, s1.cg.iterations)] + [
        (a.iterations, b.iterations) for a, b in zip(l0, l1)]
    _log(f"  max |card - cpu| / max|cpu|: GN {gaps}, pyramid {pgaps} (tol "
         f"{GN_FIELD_RTOL}); CG steps card/cpu {steps} (slack "
         f"{GN_STEP_SLACK})")
    if not (s0.cg.converged and s1.cg.converged):
        raise AssertionError("GN did not converge on both devices")
    if len(l0) != len(l1) or not all(r.converged for r in l0 + l1):
        raise AssertionError("a pyramid level did not converge")
    if any(abs(a - b) > GN_STEP_SLACK for a, b in steps):
        raise AssertionError(f"CG step counts differ: {steps}")
    if not max(*gaps.values(), *pgaps.values()) <= GN_FIELD_RTOL:
        raise AssertionError("card and CPU GN fields disagree")
    return dict(single=gaps, pyramid=pgaps, steps=steps)


def _gn_solve(a, b):
    r = gn.solve_fields(a, b)
    return [r.cg], r.u


def _gn_pyramid_solve(a, b):
    log = []
    u, _, _ = pyramid.solve_gn_pyramid(a, b, levels=PYRAMID_LEVELS,
                                       cg_log=log)
    return log, u


def _hs_solve(a, b):
    r = hs.solve_fields(a, b)
    return [r.cg], r.u


def profile_gn_hs_paths(rho):
    """Phase 12: warm solves and profiler windows of the phase-11 paths:
    one GN, GN pyramid and HS solve, and 10 FOTO dct-refined iterations."""
    a, b = (torch.as_tensor(x, dtype=torch.float32, device="cuda")
            for x in rho)
    for label, solve in (("gn", _gn_solve), ("gn-pyramid", _gn_pyramid_solve),
                         ("hs", _hs_solve)):
        solve(a, b)
        torch.cuda.synchronize()
        t0 = time.time()
        cgs, u = solve(a, b)
        u.cpu()
        el = time.time() - t0
        steps = sum(r.iterations for r in cgs)
        _log(f"  warm {label}: {steps} CG steps in {el:.4f} s "
             f"({1e3 * el / steps:.4f} ms each)")
        _, busy_ms, _ = profile_window(label, lambda n: solve(a, b), 1,
                                       top=10, unit="solve")
        _log(f"  {label}: device {busy_ms / steps:.4f} ms per CG step")
    ops = foto.stepA_ops("dct-refined")
    kw = dict(r=1.0, reg_epsilon=1e-2, admm_alpha=ADMM_ALPHA, ops=ops)
    foto.solve_potential_with_history(a, b, SHAPE[0], 1, **kw)
    profile_window("foto dct-refined", lambda m: (
        foto.solve_potential_with_history(a, b, SHAPE[0], m, **kw)),
        PROFILE_ITERATIONS, top=10)
    torch.cuda.synchronize()
    t0 = time.time()
    res = foto.solve(a, b, SHAPE[0], convergence_tol=0.01, max_it=200, **kw)
    res.u.cpu()
    el = time.time() - t0
    _log(f"  warm foto dct-refined: {res.state.iteration} iterations in "
         f"{el:.4f} s ({1e3 * el / res.state.iteration:.4f} ms each), crit "
         f"{float(res.state.crit):.6g}")
    refined_vs_exact(a, b)


def refined_vs_exact(a, b):
    """The refined stepA on one ALG2 right-hand side: its error against the
    float64 solve by refine steps, beside the exact float32 solve's, and
    its device time beside the exact solve's.  Refine 3 must be within
    DCT_RTOL of the float64 solve, and the TF32 setting off again."""
    F = operators.div_st(foto.init_state(a, b, SHAPE[0]).mu, bc="N")
    plan = dct.StepAPlan(F.shape, 1.0, 1e-2, F.dtype, F.device)
    exact64 = dct.solve_stepA_dct(F.double(), 1.0, 1e-2)
    scale = float(exact64.abs().max())
    errs = {}
    for refine in range(4):
        got = plan.solve_refined(F, refine)
        errs[refine] = float((got.double() - exact64).abs().max()) / scale
    fp32 = float((plan.solve(F).double() - exact64).abs().max()) / scale
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 left on after a refined solve")
    refined_ms = device_time_ms(lambda: plan.solve_refined(F, 3))
    exact_ms = device_time_ms(lambda: plan.solve(F))
    _log(f"  refined stepA vs float64 / max|phi|: "
         + ", ".join(f"refine {k} {v:.3e}" for k, v in errs.items())
         + f"; exact float32 {fp32:.3e}; device {refined_ms:.4f} ms "
         f"(refine 3) against {exact_ms:.4f} ms (exact)")
    if not errs[3] <= DCT_RTOL:
        raise AssertionError(f"refined stepA (refine 3) {errs[3]:.3e} of "
                             f"max|phi| off the float64 solve > {DCT_RTOL}")


# ---------------------------------------------- Sinkhorn and the outputs

def _read_record(path: Path):
    lines = path.read_text().splitlines()
    if len(lines) != 1:
        raise AssertionError(f"{path}: {len(lines)} JSONL records, expected 1")
    return json.loads(lines[0])


def run_sinkhorn_path(workdir: Path, label: str, extra):
    """Phase 13: Sinkhorn through the CLI as the pipeline runs it (quiet,
    with a JSONL record), the launch counts set to 0 just before and read
    just after; none may launch."""
    p0, p1 = workdir / "f0.pgm", workdir / "f1.pgm"
    d = workdir / label
    d.mkdir()
    argv = [str(p0), str(p1), *SINKHORN_ARGS, *extra, "--quiet",
            f"--out={d / 'flow.flo'}", f"--save-benchmark={d / 'bench.txt'}",
            f"--log-jsonl={d / 'log.jsonl'}"]
    reset_counts()
    rc = cli.main(argv)
    launches = kernels.launch_counts()
    if rc != 0:
        raise AssertionError(f"{label}: CLI exited with {rc}")
    ie, solve_s, ie_identity = check_cli_outputs(workdir, label, d)
    rec = _read_record(d / "log.jsonl")
    _log(f"  {label}: iterations={rec['iterations']} marginal_error="
         f"{rec['marginal_error']} stabilizer={rec['stabilizer']} "
         f"W2={rec['wasserstein2']} w2_marginal_error="
         f"{rec['w2_marginal_error']} launches={launches} "
         f"solve_s={solve_s:.4f} IE={ie:.6g} IE_identity={ie_identity:.6g}")
    check_launches(label, launches, {})
    if set(rec) != SINKHORN_KEYS:
        raise AssertionError(f"{label}: record keys {sorted(rec)}")
    if not (rec["marginal_error"] <= SINKHORN_TOL
            and np.isfinite(rec["wasserstein2"])):
        raise AssertionError(f"{label}: marginal error "
                             f"{rec['marginal_error']} or W2 "
                             f"{rec['wasserstein2']}")
    _, _, u, v = flo.read_flo(str(d / "flow.flo"))
    return dict(rec, ie=ie, solve_s=solve_s, launches=launches, u=u, v=v)


def png_info(path: Path):
    """(w, h, channels) of an 8-bit gray or RGB PNG, after checking its
    signature and that its pixel data inflates to h rows of 1 + w *
    channels bytes."""
    data = path.read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: not a PNG")
    pos, idat, header = 8, b"", None
    while pos < len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            header = struct.unpack(">IIBB", body[:10])
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, color = header
    channels = {0: 1, 2: 3}[color]
    if depth != 8 or len(zlib.decompress(idat)) != h * (1 + w * channels):
        raise AssertionError(f"{path}: depth {depth} or pixel data length")
    return w, h, channels


def run_outputs_path(workdir: Path):
    """Phase 13: FOTO auto with --max-it cut, writing every new output."""
    d = workdir / "outputs"
    cut = [a for a in FOTO_ARGS if not a.startswith("--max-it")]
    run = run_cli_path(workdir, "foto-outputs", [
        *cut, f"--max-it={OUTPUTS_MAX_IT}", f"--log-jsonl={d}.jsonl",
        f"--save-density-frames={d}", f"--save-flow-viz={d}.png",
        f"--profile={d}-trace"], lambda it, cg: {"fused_pointwise": it})
    if run["iterations"] != OUTPUTS_MAX_IT:
        raise AssertionError(f"foto-outputs: {run['iterations']} iterations")
    _, h, w = SHAPE
    frames = sorted(d.glob("rho-*.png"))
    want = {f"rho-{n}.png" for n in range(SHAPE[0])}
    if {p.name for p in frames} != want or any(
            png_info(p) != (w, h, 1) for p in frames):
        raise AssertionError(f"density frames: {[p.name for p in frames]}")
    if png_info(Path(f"{d}.png")) != (w, h, 3):
        raise AssertionError("flow visualization is not a 320x240 RGB PNG")
    traces = list(Path(f"{d}-trace").glob("*.pt.trace.json"))
    named = [p for p in traces if "fused_pointwise" in p.read_text()]
    rec = _read_record(Path(f"{d}.jsonl"))
    _log(f"  foto-outputs: {len(frames)} density frames, flow viz "
         f"{w}x{h} RGB, traces {[p.name for p in traces]} "
         f"({sum(p.stat().st_size for p in traces) / 1e6:.1f} MB, "
         f"{len(named)} naming fused_pointwise), record keys "
         f"{sorted(rec)}")
    if len(traces) != 1 or not named:
        raise AssertionError("no profiler trace naming fused_pointwise")
    if set(rec) != FOTO_KEYS or rec["iterations"] != OUTPUTS_MAX_IT:
        raise AssertionError(f"foto-outputs record: {rec}")
    return run


def _check_gap(label, gap, tol):
    _log(f"  {label}: {gap:.3e} (tol {tol:g})")
    if not gap <= tol:
        raise AssertionError(f"{label}: {gap:.3e} > {tol:g}")


def sinkhorn_card_vs_cpu(rho):
    """Phase 14: float32 Sinkhorn on the card against the CPU."""
    from ofot_tpu_torch.solvers import otgrad, sinkhorn
    from ofot_tpu_torch.solvers.implicit import gn_solve_implicit
    kw = (("max_iter", 1000), ("tol", SINKHORN_TOL))
    runs = {}
    for dev in ("cuda", "cpu"):
        a, b = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                for x in rho)
        t0 = time.time()
        mm = sinkhorn.solve(a, b, SINKHORN_EPS, max_iter=SK_MATMUL_ITERS,
                            tol=0.0)
        ex = sinkhorn.solve(a, b, SINKHORN_EPS, max_iter=SK_EXACT_ITERS,
                            check_every=SK_EXACT_ITERS, tol=0.0,
                            stabilizer="exact")
        fl = sinkhorn.flow(a, b, SINKHORN_EPS, max_iter=1000,
                           tol=SINKHORN_TOL)
        fl.u.cpu()
        t1 = time.time()
        at = a.clone().requires_grad_(True)
        div = otgrad.sinkhorn_divergence_dual(at, b, SINKHORN_EPS, kw)
        div.backward()
        alpha = torch.tensor(0.1, device=dev, requires_grad=True)
        x = gn_solve_implicit(a, b, alpha, 0.2)
        torch.sum(x[0] ** 2 + x[1] ** 2).backward()
        t2 = time.time()
        _log(f"  {dev}: solves and flow {t1 - t0:.3f} s (flow "
             f"{fl.iterations} iterations, marginal error "
             f"{float(fl.marginal_error):.4g}), gradients {t2 - t1:.3f} s")
        runs[dev] = dict(mm=mm, ex=ex, fl=fl, div=div.detach(),
                         div_grad=at.grad, alpha_grad=alpha.grad)
    card, cpu = runs["cuda"], runs["cpu"]
    for k, name in (("mm", "matmul"), ("ex", "exact")):
        c, p = card[k], cpu[k]
        _check_gap(f"{name} solve ({c.iterations} iterations) f, g / max",
                   max(_rel_gap(c.f, p.f), _rel_gap(c.g, p.g)), SK_POT_RTOL)
        _check_gap(f"{name} solve cost (card {float(c.cost):.9g}, cpu "
                   f"{float(p.cost):.9g}) relative",
                   abs(float(c.cost) / float(p.cost) - 1), SK_COST_RTOL)
    h64 = sinkhorn.solve(*(torch.as_tensor(x, dtype=torch.float64)
                           for x in rho), SINKHORN_EPS,
                         max_iter=SK_MATMUL_ITERS, tol=0.0).f
    want = sinkhorn._exact_stats(h64, SINKHORN_EPS, want_means=True)
    got = sinkhorn._exact_stats(h64.float().cuda(), SINKHORN_EPS,
                                want_means=True)
    _check_gap("exact stats (S, E[y'], E[x'], E[C]) card f32 vs cpu f64 / "
               "max", max(_rel_gap(x, y) for x, y in zip(got, want)),
               SK_STATS_RTOL)
    fc, fp = card["fl"], cpu["fl"]
    px = max(float((fc.u.cpu() - fp.u).abs().max()),
             float((fc.v.cpu() - fp.v).abs().max()))
    zero_c = ((fc.u == 0) & (fc.v == 0)).cpu()
    zero_p = (fp.u == 0) & (fp.v == 0)
    _log(f"  flow: iterations card {fc.iterations} cpu {fp.iterations}; "
         f"pixels with zero flow on one side only: "
         f"{int((zero_c != zero_p).sum())} (zero on both: "
         f"{int((zero_c & zero_p).sum())})")
    _check_gap("flow u, v |card - cpu| px", px, SK_FLOW_ATOL)
    if abs(fc.iterations - fp.iterations) > SK_ITER_SLACK:
        raise AssertionError("flow iterations differ by more than a block")
    _check_gap("divergence value |card - cpu| "
               f"({float(card['div']):.6g}, {float(cpu['div']):.6g})",
               abs(float(card["div"]) - float(cpu["div"])), SK_VALUE_ATOL)
    _check_gap("divergence gradient / max",
               _rel_gap(card["div_grad"], cpu["div_grad"]), SK_GRAD_RTOL)
    _check_gap(f"implicit d/dalpha ({float(card['alpha_grad']):.8g}, "
               f"{float(cpu['alpha_grad']):.8g}) relative",
               _rel_gap(card["alpha_grad"], cpu["alpha_grad"]),
               IMPLICIT_RTOL)
    check_color_wheel(fc)
    return dict(flow_px=px, iterations=(fc.iterations, fp.iterations))


def check_color_wheel(fl):
    """Phase 14: compute_color_torch on the card against numpy's
    compute_color on the normalized flow: bitwise given numpy's float32
    hue; with the card's own hue, off by one level only at pixels where
    the two atan2 implementations round the hue differently."""
    from ofot_tpu_torch.utils import colorwheel
    u, v = fl.u.double(), fl.v.double()
    maxrad = float(torch.sqrt(u * u + v * v).max())
    un, vn = (u / maxrad).cpu().numpy(), (v / maxrad).cpu().numpy()
    want = colorwheel.compute_color(un, vn)
    u32, v32 = un.astype(np.float32), vn.astype(np.float32)
    rad_np = np.sqrt(u32 * u32 + v32 * v32)
    hue_np = np.arctan2(-v32, -u32) / np.pi
    given = colorwheel._wheel_color(torch.from_numpy(rad_np).cuda(),
                                    torch.from_numpy(hue_np).cuda())
    ut, vt = torch.from_numpy(un).cuda(), torch.from_numpy(vn).cuda()
    got = colorwheel.compute_color_torch(ut, vt).cpu().numpy()
    hue_card = (torch.atan2(-vt.float(), -ut.float()) / np.pi).cpu().numpy()
    diff = np.abs(got.astype(int) - want.astype(int))
    off = diff.any(-1)
    _log(f"  color wheel on the card: bitwise given numpy's hue: "
         f"{bool((given.cpu().numpy() == want).all())}; own hue: "
         f"{int(off.sum())} of {off.size} pixels differ (max "
         f"{int(diff.max())} level), hues differ at "
         f"{int((hue_card != hue_np).sum())} pixels")
    if not (given.cpu().numpy() == want).all():
        raise AssertionError("compute_color_torch differs given the hue")
    if diff.max() > 1 or (off & (hue_card == hue_np)).any():
        raise AssertionError("compute_color_torch differs beyond the hue")


def sinkhorn_tf32_guard(rho):
    """Phase 14: every Sinkhorn product runs with TF32 off, also inside
    dct._tf32_matmul, whose settings are restored after it; the results
    are bitwise-equal either way."""
    from ofot_tpu_torch.solvers import sinkhorn
    a, b = (torch.as_tensor(x, dtype=torch.float32, device="cuda")
            for x in rho)
    seen, real = [], sinkhorn._matmul

    def recording(x, y):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(x, y)

    sinkhorn._matmul = recording
    try:
        kw = dict(max_iter=25, tol=0.0, verify=False)
        before = sinkhorn.solve(a, b, SINKHORN_EPS, **kw)
        with dct._tf32_matmul(a.device):
            inside_on = torch.backends.cuda.matmul.allow_tf32
            inside = sinkhorn.solve(a, b, SINKHORN_EPS, **kw)
        after = sinkhorn.solve(a, b, SINKHORN_EPS, **kw)
    finally:
        sinkhorn._matmul = real
    restored = (torch.backends.cuda.matmul.allow_tf32 is False
                and torch.get_float32_matmul_precision() == "highest")
    same = all(torch.equal(x.f, y.f) for x, y in ((before, inside),
                                                  (before, after)))
    _log(f"  TF32 guard: {len(seen)} products, TF32 on in {sum(seen)}; "
         f"TF32 on inside dct._tf32_matmul: {inside_on}; restored after: "
         f"{restored}; potentials bitwise-equal: {same}")
    if any(seen) or not inside_on or not restored or not same:
        raise AssertionError("TF32 reached a Sinkhorn product or was not "
                             "restored")


def profile_sinkhorn(rho):
    """Phase 14: one matmul and one exact check block (25 iterations) on
    the card, warm by the host clock and in a profiler window."""
    from torch.autograd import DeviceType
    from ofot_tpu_torch.solvers import sinkhorn
    a, b = (torch.as_tensor(x, dtype=torch.float32, device="cuda")
            for x in rho)
    warm = sinkhorn.solve_annealed(a, b, SINKHORN_EPS, max_iter=1000,
                                   verify=False)
    out = {}
    for stab in ("matmul", "exact"):
        def block(n, stab=stab):
            r = sinkhorn.solve(a, b, SINKHORN_EPS, max_iter=n, tol=0.0,
                               check_every=n, init_f=warm.f, init_g=warm.g,
                               stabilizer=stab, verify=False)
            return r.f
        block(25).cpu()
        t0 = time.time()
        block(25).cpu()
        ms = 1e3 * (time.time() - t0) / 25
        events, busy_ms, _ = profile_window(
            f"sinkhorn {stab} block", block, 25, top=8,
            unit="Sinkhorn iterations")
        launches = sum(e.count for e in events
                       if e.device_type == DeviceType.CUDA)
        _log(f"  sinkhorn {stab}: warm {ms:.4f} ms per iteration (host "
             f"clock, check included), device {busy_ms / 25:.4f} ms per "
             f"iteration, {launches / 25:.1f} launches per iteration")
        out[stab] = dict(ms=ms, device_ms=busy_ms / 25)
    return out


# ------------------------------------------------------------- pipeline

# The sweep's data (phase 15), in the layout and at the frame sizes of a
# real sweep: middlebury-1 holds seeded textured pairs at 320x240 (the eval
# frames after the pipeline's 50% resize), each moved by an integer
# (dy, dx); middlebury-1-lum is made from it by the pipeline's own seeded
# illumination augmentation, and both are mass-normalized by the
# pipeline's own step, in the order `download` runs them; middlebury-2
# keeps two of Middlebury's native other-data sizes (584x388 as
# Dimetrodon, 640x480 as Grove2) and carries each shift as a constant
# ground-truth flow (u = dx, v = dy)
SWEEP_MB1 = ((240, 320), [(2, 3), (-3, 1), (1, -2)])
SWEEP_MB2 = [((388, 584), (2, -1)), ((480, 640), (-1, 2))]
SWEEP_DATASETS = ("middlebury-1", "middlebury-1-lum", "middlebury-2")
SWEEP_ALGOS = ("GN", "foto", "WFR", "sinkhorn")
# Manifest keys of a per-sequence row: the pipeline's own, then the keys it
# folds from the CLI's --log-jsonl solve record, by algorithm; a row may
# add first_of_program and, for Sinkhorn, the escalation's keys
SWEEP_KEYS = {"status", "algo", "wall_s", "solver_wall_s", "IE"}
SWEEP_FOLDED = {
    "GN": {"inner_iterations", "residual"},
    "foto": {"iterations", "inner_iterations", "crit", "wasserstein2",
             "stepA_solver"},
    "WFR": {"iterations", "crit", "delta", "wfr_distance", "created_mass",
            "stepA_solver"},
    "sinkhorn": {"iterations", "marginal_error", "epsilon", "stabilizer",
                 "wasserstein2", "w2_marginal_error"}}
SWEEP_OPTIONAL = {"first_of_program", "marginal_error_matmul",
                  "marginal_error_batch", "marginal_error_exact",
                  "escalated_exact"}
# a row that needed the float64 re-solve, or whose escalation failed, fails
# the phase: the card's float32 solves (matmul, then exact) must converge
SWEEP_REFUSED = {"escalated_f64", "marginal_error_f32", "escalation_failed"}
BATCH_KEYS = {"status", "algo", "wall_s", "batched", "batch_size",
              "batch_mode", "wall_includes_compile"}
BATCH_DIAG = {"GN": {"inner_iterations", "converged"},
              "foto": {"iterations", "inner_iterations", "crit"},
              "WFR": {"iterations", "crit"},
              "sinkhorn": {"iterations", "marginal_error"}}
# batch flows against per-sequence flows (tests/test_batch_sweep.py's bound)
SWEEP_BATCH_AEPE = 1e-4


def write_sweep_data(root: Path):
    """The phase-15 datasets, made as the pipeline's ``download`` makes
    them -> {"<dataset>/<seq>": (shift, frame dir, (h, w))}."""
    from ofot_tpu_torch.cli import pipeline
    seqs, seed = {}, SEED

    def write(ds, sub, name, shape, shift):
        nonlocal seed
        seed += 1
        d = root / ds / sub / name
        d.mkdir(parents=True)
        f0, f1 = textured_pair(*shape, shift=shift, seed=seed)
        image.save_grayscale(f0, str(d / "frame10.png"))
        image.save_grayscale(f1, str(d / "frame11.png"))
        seqs[f"{ds}/{name}"] = (shift, d, shape)

    shape, shifts = SWEEP_MB1
    for i, shift in enumerate(shifts):
        write("middlebury-1", "eval-data-gray", f"seq{i}", shape, shift)
    with contextlib.redirect_stdout(io.StringIO()):
        pipeline._create_lum_dataset(root)
        for ds in ("middlebury-1", "middlebury-1-lum"):
            pipeline._normalize_dataset(root / ds)
    for i, shift in enumerate(shifts):
        seqs[f"middlebury-1-lum/seq{i}"] = (
            shift, root / "middlebury-1-lum" / "eval-data-gray" / f"seq{i}",
            shape)
    for i, ((h, w), shift) in enumerate(SWEEP_MB2):
        write("middlebury-2", "other-data-gray", f"seq{i}", (h, w), shift)
        g = root / "middlebury-2" / "other-gt-flow" / f"seq{i}"
        g.mkdir(parents=True)
        flo.write_flo(w, h, np.full(w * h, float(shift[1])),
                      np.full(w * h, float(shift[0])), str(g / "flow10.flo"))
    return seqs


def run_sweep(data: Path, results: Path, *extra):
    """The port's pipeline in process, every launch count set to 0 just
    before and read just after -> (manifest, launches, seconds).  The
    solves' own prints are kept, and shown only when the run fails."""
    from ofot_tpu_torch.cli import pipeline
    argv = ["run", "--data-root", str(data), "--results", str(results),
            "--datasets", ",".join(SWEEP_DATASETS), "--algos",
            ",".join(SWEEP_ALGOS), *extra]
    out = io.StringIO()
    reset_counts()
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(out):
            rc = pipeline.main(argv)
    except BaseException:
        _log(out.getvalue()[-4000:])
        raise
    seconds = time.time() - t0
    launches = kernels.launch_counts()
    if rc != 0:
        _log(out.getvalue()[-4000:])
        raise AssertionError(f"pipeline {' '.join(argv)} exited with {rc}")
    manifest = json.loads((results / "manifest.json").read_text())
    return manifest, launches, seconds


def _bench_lines(path: Path):
    return dict(ln.split(": ", 1) for ln in path.read_text().splitlines())


def check_sweep(label, seqs, results: Path, manifest, launches, batch,
                lockstep=False):
    """Every artifact, manifest key and bound of one sweep; the fused
    kernel launched once per FOTO and WFR ALG2 iteration, no other (a
    lockstep batch: once per iteration of each group's slowest pair)."""
    if sorted(manifest) != sorted(seqs):
        raise AssertionError(f"{label}: manifest rows {sorted(manifest)}")
    alg2_iterations, ees, escalated = 0, {}, []
    group_iterations = {}
    for key, (shift, frames, (h, w)) in seqs.items():
        out = results / key
        gt = key.startswith("middlebury-2")
        # the batch writes no growth map (as in JAX)
        names = (["diff.png"] + ([] if batch else ["wfr.growth.png"])
                 + (["flow10.png"] if gt else []))
        for algo in SWEEP_ALGOS:
            a = algo.lower()
            names += [f"{a}.flo", f"{a}.benchmark.txt", f"{a}.rec.png",
                      f"{a}.lum.png", f"{a}.png", f".out.{a}.sucess"]
        missing = [n for n in names if not (out / n).exists()]
        if missing:
            raise AssertionError(f"{label} {key}: missing {missing}")
        rgb = {"flow10.png"} | {f"{a.lower()}.png" for a in SWEEP_ALGOS}
        for p in out.glob("*.png"):
            want = (w, h, 3 if p.name in rgb else 1)
            if png_info(p) != want or image.read_png(str(p)).shape != (h, w):
                raise AssertionError(f"{label} {key}: {p.name} is not a "
                                     f"well-formed {want} PNG")
        g0, _, _ = image.open_grayscale(str(frames / "frame10.png"))
        g1, _, _ = image.open_grayscale(str(frames / "frame11.png"))
        ie_identity = metrics.IE(w, h, g0, g1)
        ee_zero = float(np.hypot(*shift))
        for algo in SWEEP_ALGOS:
            row = manifest[key][algo]
            keys = set(row)
            want = (BATCH_KEYS | BATCH_DIAG[algo] if batch
                    else SWEEP_KEYS | SWEEP_FOLDED[algo])
            if batch and row.get("escalated_exact"):
                # re-solved per sequence: the CLI's solve record is folded in
                want |= SWEEP_KEYS | SWEEP_FOLDED[algo]
            if row.get("status") != "ok" or keys & SWEEP_REFUSED or not (
                    want <= keys <= want | SWEEP_OPTIONAL):
                raise AssertionError(f"{label} {key} {algo}: row {row}")
            if keys & {"escalated_exact", "marginal_error_matmul"}:
                escalated.append(f"{key} {algo}")
            fw, fh, u, v = flo.read_flo(str(out / f"{algo.lower()}.flo"))
            if (fw, fh) != (w, h) or not (np.isfinite(u).all()
                                          and np.isfinite(v).all()):
                raise AssertionError(f"{label} {key} {algo}: .flo {fw}x{fh} "
                                     "or not finite")
            bench = _bench_lines(out / f"{algo.lower()}.benchmark.txt")
            ie = float(bench["IE"])
            if not ie < ie_identity:
                raise AssertionError(f"{label} {key} {algo}: IE {ie} not "
                                     f"below the identity's {ie_identity}")
            if gt:
                ee = float(bench["EE-mean"])
                ees.setdefault(algo, []).append(f"{ee:.4f}/{ee_zero:.4f}")
                # the dynamic-OT flows of these dense frames stay near zero
                # (the luminosity term carries the change), so only GN's
                # EE must beat the zero flow's
                if not np.isfinite(ee) or (algo == "GN" and not ee < ee_zero):
                    raise AssertionError(f"{label} {key} {algo}: EE {ee} "
                                         f"against the zero flow's {ee_zero}")
            if algo in ("foto", "WFR"):
                alg2_iterations += int(row["iterations"])
                group = (algo, key.split("/")[0], (h, w))
                group_iterations[group] = max(group_iterations.get(group, 0),
                                              int(row["iterations"]))
                if not batch and row["stepA_solver"] != "pallas":
                    raise AssertionError(f"{label} {key} {algo}: stepA "
                                         f"{row['stepA_solver']}")
            if algo == "sinkhorn" and not row["marginal_error"] <= \
                    SINKHORN_TOL:
                raise AssertionError(f"{label} {key}: Sinkhorn marginal "
                                     f"error {row['marginal_error']}")
    _log(f"  {label}: EE / zero flow's EE on the ground-truth sequences "
         f"{ees}; re-solved with the exact softmin: {escalated}")
    if lockstep:
        alg2_iterations = sum(group_iterations.values())
    check_launches(label, launches, {"fused_pointwise": alg2_iterations},
                   loops=device_loop.stats)
    return alg2_iterations


def sweep_times(manifest, seqs, seconds, batch):
    """Phase 15's printed times: per algo and frame size the median wall_s
    and, per sequence, solver_wall_s and the time outside the solve, and
    the first_of_program row's wall (a batch row has its group's wall / n
    only)."""
    for algo in SWEEP_ALGOS:
        for shape in sorted({sh for _, _, sh in seqs.values()}):
            rows = [manifest[k][algo] for k, (_, _, sh) in seqs.items()
                    if sh == shape]
            walls = [r["wall_s"] for r in rows]
            size = f"{shape[1]}x{shape[0]}"
            if batch:
                _log(f"  batch {algo} {size}: median wall_s "
                     f"{statistics.median(walls):.4f} s over {len(rows)} "
                     "sequences")
                continue
            solver = [r["solver_wall_s"] for r in rows]
            outside = [r["wall_s"] - r["solver_wall_s"] for r in rows]
            first = [r["wall_s"] for r in rows if r.get("first_of_program")]
            _log(f"  sweep {algo} {size}: median wall_s "
                 f"{statistics.median(walls):.4f} s, solver_wall_s "
                 f"{statistics.median(solver):.4f} s, outside the solve "
                 f"{statistics.median(outside):.4f} s over {len(rows)} "
                 f"sequences; first_of_program wall "
                 f"{first[0] if first else float('nan'):.4f} s")
    _log(f"  {'batch' if batch else 'sweep'} seconds {seconds:.2f}")


def run_pipeline_phase(workdir: Path):
    """Phase 15: the port's sweep per sequence, resumed, and in map-mode
    batch, then solve_batch_full against single-pair solves."""
    from ofot_tpu_torch.parallel import sweep
    data = workdir / "sweep-data"
    seqs = write_sweep_data(data)
    per_seq = workdir / "sweep"
    manifest, launches, seconds = run_sweep(data, per_seq)
    alg2 = check_sweep("sweep", seqs, per_seq, manifest, launches, False)
    _log(f"  sweep: {len(seqs)} sequences x {len(SWEEP_ALGOS)} algorithms, "
         f"launches {launches} (FOTO + WFR ALG2 iterations {alg2})")
    sweep_times(manifest, seqs, seconds, False)

    again, launches, seconds = run_sweep(data, per_seq)
    _log(f"  resume: {seconds:.2f} s, launches {launches}")
    check_launches("resume", launches, {})
    if again != manifest:
        raise AssertionError("resume changed the manifest")

    batched = workdir / "sweep-batch"
    bman, launches, seconds = run_sweep(data, batched, "--batch")
    alg2 = check_sweep("batch", seqs, batched, bman, launches, True)
    worst = 0.0
    for key in seqs:
        for algo in SWEEP_ALGOS:
            count = ("inner_iterations" if algo == "GN" else "iterations")
            if bman[key][algo][count] != manifest[key][algo][count]:
                raise AssertionError(f"batch {key} {algo}: {count} "
                                     f"{bman[key][algo][count]} against "
                                     f"{manifest[key][algo][count]}")
            _, _, u1, v1 = flo.read_flo(str(per_seq / key /
                                            f"{algo.lower()}.flo"))
            _, _, u2, v2 = flo.read_flo(str(batched / key /
                                            f"{algo.lower()}.flo"))
            worst = max(worst, float(np.hypot(u1 - u2, v1 - v2).mean()))
    _log(f"  batch: {seconds:.2f} s, launches {launches} (FOTO + WFR ALG2 "
         f"iterations {alg2}); worst AEPE against per-sequence {worst:.3g} "
         f"(tol {SWEEP_BATCH_AEPE:g})")
    if not worst < SWEEP_BATCH_AEPE:
        raise AssertionError(f"batch flows {worst} px from per-sequence")
    sweep_times(bman, seqs, seconds, True)

    # solve_batch_full on the middlebury-1 pairs against single-pair solves
    # of the same arrays, bitwise
    frames = [d for k, (_, d, _) in seqs.items()
              if k.split("/")[0] == "middlebury-1"]
    f1s = np.stack([image.open_grayscale(str(d / "frame10.png"))[0]
                    for d in frames]).astype(np.float32)
    f2s = np.stack([image.open_grayscale(str(d / "frame11.png"))[0]
                    for d in frames]).astype(np.float32)
    Nt = SHAPE[0]
    params = dict(r=1.0, convergence_tol=0.01, reg_epsilon=1e-2, max_it=200,
                  admm_alpha=ADMM_ALPHA)
    u, v, m, diag = sweep.solve_batch_full(
        "foto", f1s, f2s, foto_params=dict(params, Nt=Nt), device="cuda")
    for i in range(len(frames)):
        a = torch.as_tensor(f1s[i], device="cuda")
        b = torch.as_tensor(f2s[i], device="cuda")
        one = foto.solve(a, b, Nt, **params, ops=foto.stepA_ops("pallas"))
        if not (torch.equal(u[i], one.u) and torch.equal(v[i], one.v)
                and torch.equal(m[i], one.m)
                and diag["iterations"][i] == one.state.iteration):
            raise AssertionError(f"solve_batch_full pair {i} is not the "
                                 "single-pair solve bitwise")
    _log(f"  solve_batch_full(foto) on {len(frames)} pairs: bitwise the "
         f"single-pair solves, iterations {diag['iterations'].tolist()}")
    return seqs


# ------------------------------------------------------------ lockstep

# Phase 16: a lockstep batch of middlebury-1's real group size, on CARD
# (a CPU rehearsal of the solves sets it to "cpu").
CARD = "cuda"
LOCKSTEP_B = 8
LOCKSTEP_SETS_B = 4
LOCKSTEP_SHIFTS = [(2, 3), (-3, 1), (1, -2), (0, 2), (3, 0), (-2, -2),
                   (1, 1), (-1, 3)]
# The cg-pallas run is cut to this many ALG2 iterations (about 230 lockstep
# CG steps each); every other run keeps the pipeline's max-it.
LOCKSTEP_CG_PALLAS_MAX_IT = 10
# Each pair against map mode: IE within 0.5%; where the iteration counts
# agree, flows within AEPE 1e-3 (the CPU tests' bound against JAX).  The
# stepA's products are batched in lockstep, and cuBLAS may round a batched
# product differently from a single one, which can move a stagnation stop.
LOCKSTEP_IE_RTOL, LOCKSTEP_AEPE = 5e-3, 1e-3


def _uniform(shape, device, seed, low, high):
    """Seeded uniform float32 values made on the device (a (8, 4) + SHAPE
    field is 39M values: too many to draw on the host in time)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(shape, generator=gen, device=device) * (high - low) \
        + low


def lockstep_inputs(ncomp, relaxed, device):
    """(LOCKSTEP_B, ncomp) + SHAPE fused-pass inputs with kernel_inputs'
    ranges."""
    full = (LOCKSTEP_B, ncomp) + SHAPE
    return [_uniform(full, device, SEED, -2, 2),
            _uniform(full, device, SEED + 1, -1, 2),
            _uniform(full, device, SEED + 2, -2, 1) if relaxed else None]


def _pair_r(device):
    """Per-pair penalties, as auto_r gives them: one float32 a pair."""
    return torch.tensor([0.6 + 0.1 * i for i in range(LOCKSTEP_B)],
                        dtype=torch.float32, device=device)


def _singles_ms(enqueues):
    """Event time of B single-pair launches back to back."""
    def run():
        for e in enqueues:
            e()
    return cuda_time_ms(run), device_time_ms(run)


def lockstep_fused_pointwise(device, mem_bw, f32_rate):
    """Kernel #1 on (8, 1+k) + SHAPE with a per-pair r: against its plain
    version, and against 8 single-pair launches bitwise (fields and sums);
    timed at alpha 1.7 beside 8x the single-pair bound."""
    r = _pair_r(device)
    worst, recs = 0.0, {}
    for ncomp in (3, 4):
        for alpha in (None, ADMM_ALPHA):
            g, m, qp = lockstep_inputs(ncomp, alpha is not None, device)
            got = fp.fused_pointwise_batched(g, m, r, alpha, qp)
            want = fp.fused_pointwise_batched_reference(g, m, r, alpha, qp)
            torch.cuda.synchronize()
            case = f"B={LOCKSTEP_B} ncomp={ncomp} alpha={alpha or 1.0}"
            for a, b, name in zip(got[:2], want[:2], ("q", "mu")):
                err = (a - b).abs()
                bad = int((err > KERNEL_ATOL + KERNEL_RTOL * b.abs()).sum())
                worst = max(worst, float(err.max()))
                if bad:
                    raise AssertionError(f"{case}: {name} disagrees with the "
                                         f"plain version at {bad} points")
            rel = max(float(((a - b).abs() / b.abs()).max())
                      for a, b in zip(got[2:], want[2:]))
            if rel > SUM_RTOL:
                raise AssertionError(f"{case}: per-pair sums relative "
                                     f"error {rel:.3e} > {SUM_RTOL}")
            for i in range(LOCKSTEP_B):
                one = fp.fused_pointwise(g[i], m[i], float(r[i]), alpha,
                                         None if qp is None else qp[i])
                if not all(torch.equal(a[i], b) for a, b in zip(got, one)):
                    raise AssertionError(f"{case}: pair {i} is not its "
                                         "single-pair launch bitwise")
            _log(f"  fused_pointwise {case}: max |kernel - plain| "
                 f"{float(max((a - b).abs().max() for a, b in zip(got[:2], want[:2]))):.3e}"
                 f", sums rel {rel:.3e}; each pair bitwise its single "
                 "launch")
            if alpha is not None:
                enqueue, _ = fp.prepare_launch(g, m, r, alpha, qp,
                                               batched=True)
                rec = time_kernel(enqueue, lambda: (
                    fp.fused_pointwise_batched_reference(g, m, r, alpha,
                                                         qp)), plain_calls=2)
                singles = [fp.prepare_launch(g[i], m[i], float(r[i]), alpha,
                                             qp[i])[0]
                           for i in range(LOCKSTEP_B)]
                single_ms, single_dev = _singles_ms(singles)
                parts = [fused_pointwise_bound(g[i], m[i], float(r[i]),
                                               alpha, qp[i], mem_bw,
                                               f32_rate)
                         for i in range(LOCKSTEP_B)]
                nbytes = sum(p[2] for p in parts)
                ops = sum(p[3] for p in parts)
                bound_ms, bound_by = bound(nbytes, ops, mem_bw, f32_rate)
                recs[ncomp] = dict(rec, bound_ms=bound_ms, bound_by=bound_by,
                                   singles_ms=single_ms,
                                   singles_device_ms=single_dev)
                _timing_line(f"fused_pointwise {case}", rec, bound_ms,
                             bound_by, nbytes, ops,
                             f"; {LOCKSTEP_B} single launches {single_ms:.4f}"
                             f" ms by events, {single_dev:.4f} ms device")
            del g, m, qp, got, want
    return worst, recs


def lockstep_dct_solve(device, mem_bw, f32_rate):
    """Kernel #2 on 8 x SHAPE (128 slices) with a per-pair r: the whole
    solve against its plain version; the slice kernel against 8
    single-pair launches on the same t-transformed slices, bitwise; the
    whole solve against 8 single-pair solves (the t products batched);
    timed beside 8x the single-pair bound."""
    eps = 1e-2
    r = _pair_r(device)
    F = _uniform((LOCKSTEP_B,) + SHAPE, device, SEED + 1, -2, 2)
    got = ds.dct_solve(F, r, eps)
    want = ds.dct_solve_reference(F, r, eps)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = err / float(want.abs().max())
    if not rel <= DCT_RTOL:
        raise AssertionError(f"batched dct_solve: relative error {rel:.3e} "
                             f"> {DCT_RTOL}")
    p = ds.plan_for(F, r, eps)
    Fz = ds.t_forward(F, p)
    enqueue, out = ds.prepare_launch(Fz, p, r)
    enqueue()
    singles, whole_gap = [], 0.0
    for i in range(LOCKSTEP_B):
        pi = ds.plan(SHAPE, F.dtype, F.device, float(r[i]), eps)
        e, o = ds.prepare_launch(Fz[i].contiguous(), pi)
        e()
        singles.append(e)
        if not torch.equal(o, out[i]):
            raise AssertionError(f"batched dct_solve slice kernel: pair {i} "
                                 "is not its single-pair launch bitwise")
        whole_gap = max(whole_gap, float(
            (ds.dct_solve(F[i], float(r[i]), eps) - got[i]).abs().max()))
    _log(f"  dct_solve B={LOCKSTEP_B} x {SHAPE}: max |kernel - plain| "
         f"{err:.3e}, / max|phi| {rel:.3e}; slice kernel bitwise the single "
         f"launches; whole solve against single solves max |diff| "
         f"{whole_gap:.3e} (batched t products)")
    # the library call, as for the single-pair kernel: the port's cuBLAS
    # spectral stepA (``dct``), here on the batch with per-pair spectra
    from ofot_tpu_torch.solvers.lockstep import PerPair
    rp = PerPair(r.tolist(), F)
    dct_ops = foto.lockstep_ops(foto.stepA_ops("dct"))
    fused_ops = foto.lockstep_ops(foto.stepA_ops("dct-fused"))
    rec = time_kernel(enqueue, lambda: ds.slice_solve_reference(Fz, p, r),
                      lambda: dct_ops.stepA_solve(F, rp, eps, 0, 0))

    def stepA():
        return fused_ops.stepA_solve(F, rp, eps, 0, 0)

    stepA_ms, stepA_device_ms = cuda_time_ms(stepA), device_time_ms(stepA)
    single_ms, single_dev = _singles_ms(singles)
    Nt, Ny, Nx = SHAPE
    n = LOCKSTEP_B * Nt * Ny * Nx
    mm_ops = 2 * n * (2 * Ny + 2 * Nx)
    nbytes = 4 * (2 * n + LOCKSTEP_B * (2 * Ny * Ny + 2 * Nx * Nx + Nt
                                        + Ny + Nx))
    bound_ms = 1e3 * max(nbytes / mem_bw, 3 * mm_ops / TF32_RATE
                         + 5 * n / f32_rate)
    bound_by = "bytes" if nbytes / mem_bw >= 3 * mm_ops / TF32_RATE \
        else "operations"
    _timing_line(f"dct_solve B={LOCKSTEP_B}", rec, bound_ms, bound_by,
                 nbytes, 3 * mm_ops + 5 * n,
                 f"; {LOCKSTEP_B} single launches {single_ms:.4f} ms by "
                 f"events, {single_dev:.4f} ms device")
    _log(f"  lockstep stepA solve: dct-fused (t products + kernel) "
         f"{stepA_ms:.4f} ms by events, {stepA_device_ms:.4f} ms device; "
         f"dct (cuBLAS fp32 matmuls) {rec['library_ms']:.4f} ms by events, "
         f"{rec['library_device_ms']:.4f} ms device")
    return dict(rec, max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by,
                singles_ms=single_ms, singles_device_ms=single_dev,
                stepA_ms=stepA_ms, stepA_device_ms=stepA_device_ms)


def lockstep_cg_operator(device, mem_bw, f32_rate):
    """Kernel #4 on 8 x SHAPE with a per-pair r: against its plain version
    (the 'N' time rows at each pair's own first and last plane) and against
    8 single-pair launches bitwise; timed beside 8x the single bound."""
    eps = 1e-2
    r = _pair_r(device)
    x = _uniform((LOCKSTEP_B,) + SHAPE, device, SEED + 3, -2, 2)
    # extreme first and last planes: a stencil reading across pairs shows
    x[:, 0] += 50.0
    x[:, -1] -= 50.0
    got = cgk.cg_operator_blocked(x, r, eps)
    want = cgk.cg_operator_reference(x, r, eps)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not err < CG_ATOL * 50:
        raise AssertionError(f"batched cg_operator: error {err:.3e}")
    singles = []
    for i in range(LOCKSTEP_B):
        e, o = cgk.prepare_launch(x[i], float(r[i]), eps)
        e()
        singles.append(e)
        if not torch.equal(o, got[i]):
            raise AssertionError(f"batched cg_operator: pair {i} is not its "
                                 "single-pair launch bitwise")
    _log(f"  cg_operator B={LOCKSTEP_B} x {SHAPE} (planes 0 and Nt-1 at "
         f"+-50): max |kernel - plain| {err:.3e} (tol {CG_ATOL * 50:g}, "
         "50x the operand scale); each pair bitwise its single launch")
    enqueue, _ = cgk.prepare_launch(x, r, eps)
    rec = time_kernel(enqueue, lambda: cgk.cg_operator_reference(x, r, eps),
                      plain_calls=2)
    single_ms, single_dev = _singles_ms(singles)
    ops = 14 * x.numel()
    nbytes = 2 * x.numel() * x.element_size()
    bound_ms, bound_by = bound(nbytes, ops, mem_bw, f32_rate)
    _timing_line(f"cg_operator B={LOCKSTEP_B}", rec, bound_ms, bound_by,
                 nbytes, ops,
                 f"; {LOCKSTEP_B} single launches {single_ms:.4f} ms by "
                 f"events, {single_dev:.4f} ms device")
    # the 39 MB operand fits the L2: time it cold too, as phase 7 times #3
    cold = cold_times(lambda i: cgk.prepare_launch(_uniform(
        x.shape, device, SEED + 40 + i, -2, 2), r, eps)[0], nbytes)
    _log(f"  cg_operator B={LOCKSTEP_B} cold: {cold['cold_ms']:.4f} ms by "
         f"events, {cold['cold_device_ms']:.4f} ms device over "
         f"{cold['cold_sets']} rotating sets; kernel at "
         f"{100 * bound_ms / cold['cold_device_ms']:.1f}% of bound by cold "
         "device time")
    return dict(rec, max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by,
                singles_ms=single_ms, singles_device_ms=single_dev, **cold)


def lockstep_pairs(B=LOCKSTEP_B):
    """B seeded textured 320x240 pairs, pair i moved by LOCKSTEP_SHIFTS[i],
    as float32 (B, 240, 320) stacks."""
    _, h, w = SHAPE
    pairs = [textured_pair(h, w, shift=s, seed=SEED + 10 + i)
             for i, s in enumerate(LOCKSTEP_SHIFTS[:B])]
    return (np.stack([a for a, _ in pairs]).astype(np.float32),
            np.stack([b for _, b in pairs]).astype(np.float32))


def _ies(f1s, f2s, u, v, m):
    """Per pair (IE of the warp, IE of the identity warp)."""
    from ofot_tpu_torch.utils import warp
    _, h, w = SHAPE
    out = []
    for i in range(len(f1s)):
        a = torch.as_tensor(f1s[i], device=CARD)
        rec = np.clip(warp.apply_flow(a, u[i], v[i], m[i]).cpu().numpy(),
                      0, 1)
        out.append((metrics.IE(w, h, rec, f2s[i]),
                    metrics.IE(w, h, f1s[i], f2s[i])))
    return out


def _timed_batch(algo, f1s, f2s, kw, mode):
    """solve_batch_full on the card, every launch count set to 0 just
    before and read just after -> (u, v, m, diag, seconds, launches)."""
    from ofot_tpu_torch.parallel import sweep
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    u, v, m, diag = sweep.solve_batch_full(algo, f1s, f2s, batch_mode=mode,
                                           device=CARD, **kw)
    u.cpu()
    seconds = time.time() - t0
    return u, v, m, diag, seconds, kernels.launch_counts()


def _batch_kw(algo, **changes):
    """The pipeline's canonical batch parameters for ``algo``."""
    from ofot_tpu_torch.cli import pipeline
    fp_, gp, wp, sp, _ = pipeline._batched_params("")
    key, params = {"foto": ("foto_params", fp_), "WFR": ("wfr_params", wp),
                   "GN": ("gn_params", gp),
                   "sinkhorn": ("sinkhorn_params", sp)}[algo]
    return {key: dict(params, **changes)}


def lockstep_solves():
    """Each algo at the pipeline's parameters on the 8 pairs, in map mode
    and in lockstep; per pair the stop, IE against the identity warp's and
    map mode's, AEPE where the iterations agree; launches of the lockstep
    run; map against lockstep wall / n and peak memory."""
    f1s, f2s = lockstep_pairs()
    out = {}
    for algo in ("foto", "WFR", "GN", "sinkhorn"):
        kw = _batch_kw(algo)
        um, vm, mm, dm, map_s, _ = _timed_batch(algo, f1s, f2s, kw, "map")
        torch.cuda.reset_peak_memory_stats()
        u, v, m, d, lock_s, launches = _timed_batch(algo, f1s, f2s, kw,
                                                    "vmap")
        peak = torch.cuda.max_memory_allocated()
        count = "inner_iterations" if algo == "GN" else "iterations"
        its, map_its = d[count].tolist(), dm[count].tolist()
        if algo in ("foto", "WFR"):
            check_launches(f"lockstep {algo}", launches,
                           {"fused_pointwise": max(its)},
                           loops=device_loop.stats)
            cap = kw[f"{'foto' if algo == 'foto' else 'wfr'}_params"][
                "max_it"]
        else:
            check_launches(f"lockstep {algo}", launches, {})
            cap = 5000 if algo == "GN" else kw["sinkhorn_params"]["max_iter"]
        ies, map_ies = _ies(f1s, f2s, u, v, m), _ies(f1s, f2s, um, vm, mm)
        worst_aepe, ie_gaps = 0.0, []
        for i in range(LOCKSTEP_B):
            (ie, ident), (ie_map, _) = ies[i], map_ies[i]
            gap = abs(ie - ie_map) / ie_map
            ie_gaps.append(gap)
            if not its[i] < cap or (algo == "GN" and not d["converged"][i]):
                raise AssertionError(f"lockstep {algo} pair {i}: did not "
                                     f"stop before {cap} ({its[i]})")
            if not ie < ident:
                raise AssertionError(f"lockstep {algo} pair {i}: IE {ie} "
                                     f"not below the identity's {ident}")
            if not gap <= LOCKSTEP_IE_RTOL:
                raise AssertionError(f"lockstep {algo} pair {i}: IE {ie} "
                                     f"against map mode's {ie_map}")
            if its[i] == map_its[i]:
                aepe = float(torch.hypot(u[i] - um[i], v[i] - vm[i]).mean())
                worst_aepe = max(worst_aepe, aepe)
                if not aepe < LOCKSTEP_AEPE:
                    raise AssertionError(f"lockstep {algo} pair {i}: AEPE "
                                         f"{aepe} against map mode")
        n = LOCKSTEP_B
        per_it = (f", {1e3 * lock_s / max(its):.4f} ms per lockstep "
                  f"iteration ({max(its)} iterations)"
                  if algo in ("foto", "WFR") else "")
        _log(f"  lockstep {algo}: {count} lockstep {its} / map {map_its}; "
             f"launches {launches}; worst IE gap to map "
             f"{max(ie_gaps):.3e}, worst AEPE where the counts agree "
             f"{worst_aepe:.3e}")
        _log(f"  lockstep {algo} B={n}: wall / n {lock_s / n:.4f} s against "
             f"map mode's {map_s / n:.4f} s ({map_s / lock_s:.2f}x){per_it};"
             f" peak memory {peak / 2**30:.3f} GiB; IE "
             f"{[round(x[0], 5) for x in ies]}")
        out[algo] = dict(iterations=its, map_iterations=map_its,
                         launches=launches, seconds=lock_s, map_seconds=map_s,
                         peak=peak)
    return out


def lockstep_other_sets():
    """FOTO dct-fused and cg-pallas (max-it cut) at B = 4, and FOTO with
    auto_r at B = 8: dct_solve once per lockstep iteration,
    cg_operator_blocked once per lockstep CG step (counted by wrapping the
    batched CG), fused_pointwise once per lockstep iteration."""
    from ofot_tpu_torch.solvers import cg as cg_mod
    f1s, f2s = lockstep_pairs()
    a, b = f1s[:LOCKSTEP_SETS_B], f2s[:LOCKSTEP_SETS_B]
    out = {}
    _, h, w = SHAPE

    def check(label, u, v, m, d, f1, f2, cap):
        its = d["iterations"].tolist()
        for i, (ie, ident) in enumerate(_ies(f1, f2, u, v, m)):
            if not (np.isfinite(ie) and ie < ident):
                raise AssertionError(f"{label} pair {i}: IE {ie} against "
                                     f"the identity's {ident}")
        if cap is not None and not max(its) < cap:
            raise AssertionError(f"{label}: iterations {its} reach {cap}")
        return its

    kw = _batch_kw("foto", stepA_solver="dct-fused")
    u, v, m, d, s, launches = _timed_batch("foto", a, b, kw, "vmap")
    its = check("lockstep dct-fused", u, v, m, d, a, b, 200)
    check_launches("lockstep dct-fused", launches, {"dct_solve": max(its)},
                   loops=device_loop.stats)
    _log(f"  lockstep foto dct-fused B={LOCKSTEP_SETS_B}: iterations {its}, "
         f"launches {launches}, {s:.4f} s")
    out["dct-fused"] = dict(iterations=its, launches=launches, seconds=s)

    steps = []
    real = foto._Lockstep.cg_solve

    def counted(*args, **kwargs):
        res = real(*args, **kwargs)
        # the lockstep loop runs until its slowest pair stops
        steps.append(int(res.iterations.max()))
        return res

    foto._Lockstep.cg_solve = staticmethod(counted)
    try:
        kw = _batch_kw("foto", stepA_solver="cg-pallas",
                       max_it=LOCKSTEP_CG_PALLAS_MAX_IT)
        u, v, m, d, s, launches = _timed_batch("foto", a, b, kw, "vmap")
    finally:
        foto._Lockstep.cg_solve = staticmethod(real)
    its = check("lockstep cg-pallas", u, v, m, d, a, b, None)
    check_launches("lockstep cg-pallas", launches,
                   {"cg_operator_blocked": sum(steps)},
                   loops=device_loop.stats)
    _log(f"  lockstep foto cg-pallas B={LOCKSTEP_SETS_B}, max-it cut to "
         f"{LOCKSTEP_CG_PALLAS_MAX_IT} (the pipeline's 200): iterations "
         f"{its}, per-pair CG steps {d['inner_iterations'].tolist()}, "
         f"lockstep CG steps {sum(steps)}, launches {launches}, {s:.4f} s "
         f"({1e3 * s / max(sum(steps), 1):.4f} ms per lockstep CG step)")
    out["cg-pallas"] = dict(iterations=its, launches=launches, seconds=s,
                            steps=sum(steps))

    kw = _batch_kw("foto", auto_r=True)
    u, v, m, d, s, launches = _timed_batch("foto", f1s, f2s, kw, "vmap")
    its = check("lockstep auto_r", u, v, m, d, f1s, f2s, None)
    check_launches("lockstep auto_r", launches,
                   {"fused_pointwise": max(its)}, loops=device_loop.stats)
    _log(f"  lockstep foto auto_r B={LOCKSTEP_B}: iterations {its}, "
         f"launches {launches}, {s:.4f} s")
    out["auto_r"] = dict(iterations=its, launches=launches, seconds=s)
    return out


def _timed(fn, *args):
    """``fn(*args)``, its seconds printed."""
    t0 = time.time()
    out = fn(*args)
    _log(f"  ({fn.__name__} {time.time() - t0:.2f} s)")
    return out


def lockstep_single_pair():
    """A lockstep batch of one pair against the single-pair solve, FOTO at
    the pipeline's parameters, each warm, twice in turns: what the
    lockstep loop's own work (the select of every field, the per-pair
    counters) costs where no pair shares a launch."""
    f1s, f2s = lockstep_pairs(1)
    kw = _batch_kw("foto")
    times = {"map": [], "vmap": []}
    for mode in ("map", "vmap", "vmap", "map"):
        _, _, _, d, s, _ = _timed_batch("foto", f1s, f2s, kw, mode)
        times[mode].append(s)
    _log(f"  one pair, FOTO ({int(d['iterations'][0])} iterations): "
         f"lockstep {[round(t, 4) for t in times['vmap']]} s, map "
         f"{[round(t, 4) for t in times['map']]} s")


def profile_lockstep():
    """Device busy share over a window of lockstep FOTO iterations at B=8
    (pallas set, no stop)."""
    f1s, f2s = lockstep_pairs()
    a, b = (torch.as_tensor(x, device=CARD) for x in (f1s, f2s))
    kw = dict(r=1.0, reg_epsilon=1e-2, admm_alpha=ADMM_ALPHA,
              convergence_tol=0.0, ops=foto.stepA_ops("pallas"))
    foto.solve_potential_batched(a, b, SHAPE[0], max_it=2, **kw)
    profile_window(f"lockstep foto pallas B={LOCKSTEP_B}", lambda k: (
        foto.solve_potential_batched(a, b, SHAPE[0], max_it=k, **kw)),
        PROFILE_ITERATIONS, top=8, unit="lockstep ALG2 iterations")


def run_lockstep_pipeline(workdir: Path, seqs):
    """``run --batch --batch-mode=vmap`` on phase 15's data with phase 15's
    checks; each row's IE against the map-mode batch's."""
    data, batched = workdir / "sweep-data", workdir / "sweep-batch"
    results = workdir / "sweep-vmap"
    man, launches, seconds = run_sweep(data, results, "--batch",
                                       "--batch-mode=vmap")
    alg2 = check_sweep("vmap batch", seqs, results, man, launches, True,
                       lockstep=True)
    mman = json.loads((batched / "manifest.json").read_text())
    gaps, moved = [], []
    for key in seqs:
        for algo in SWEEP_ALGOS:
            if man[key][algo]["batch_mode"] != "vmap":
                raise AssertionError(f"vmap batch {key} {algo}: row "
                                     f"{man[key][algo]}")
            ie = float(_bench_lines(results / key /
                                    f"{algo.lower()}.benchmark.txt")["IE"])
            ie_map = float(_bench_lines(batched / key /
                                        f"{algo.lower()}.benchmark.txt")["IE"])
            gaps.append(abs(ie - ie_map) / ie_map)
            if not gaps[-1] <= LOCKSTEP_IE_RTOL:
                raise AssertionError(f"vmap batch {key} {algo}: IE {ie} "
                                     f"against the map batch's {ie_map}")
            count = "inner_iterations" if algo == "GN" else "iterations"
            if man[key][algo][count] != mman[key][algo][count]:
                moved.append(f"{key} {algo} {man[key][algo][count]}/"
                             f"{mman[key][algo][count]}")
    _log(f"  vmap batch: {seconds:.2f} s, launches {launches} (FOTO + WFR "
         f"lockstep iterations {alg2}); worst IE gap to the map batch "
         f"{max(gaps):.3e}; counts that differ from map (vmap/map): "
         f"{moved or 'none'}")
    sweep_times(man, seqs, seconds, True)


# ---------------------------------------------------------------- bench

# Phase 17: the port's bench (python -m ofot_tpu_torch.bench) in process,
# at its defaults (320x240, Nt=16, 200 iterations, best of 5, families
# on), then with --ops dct-fused and with --batch 8 (families off, best of
# 2: these two runs are there for their launch checks and readings).
BENCH_ITERS, BENCH_REPEATS, BENCH_SHORT_REPEATS = 200, 5, 2
BENCH_RUNS = (("auto", []),
              ("auto host", ["--loop", "host", "--no-families",
                             "--repeats", str(BENCH_SHORT_REPEATS)]),
              ("dct-fused", ["--ops", "dct-fused", "--no-families",
                             "--repeats", str(BENCH_SHORT_REPEATS)]),
              ("batch 8", ["--batch", "8", "--no-families",
                           "--repeats", str(BENCH_SHORT_REPEATS)]))


def bench_alg2_iterations(families: bool, repeats: int) -> int:
    """ALG2 iterations the bench runs with its primary ops set at
    ``repeats``: the timed call's first run and repeats, the 5x arm's
    first run and halved repeats (at least 2), and the WFR family's chain
    (n and 5n iterations, a first call and 3 repeats each)."""
    n = BENCH_ITERS
    count = n * (1 + repeats) + 5 * n * (1 + max(2, repeats // 2))
    if families:
        w = max(2, n // 5)
        count += 4 * w + 4 * 5 * w
    return count


def run_bench(label, extra):
    """``ofot_tpu_torch.bench.main`` in process, every launch count set to
    0 just before and read just after -> (JSON record, launches, s)."""
    from ofot_tpu_torch import bench
    out, err = io.StringIO(), io.StringIO()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = bench.main(extra)
    except BaseException:
        _log(err.getvalue()[-4000:])
        raise
    seconds = time.time() - t0
    launches = kernels.launch_counts()
    lines = out.getvalue().strip().splitlines()
    if rc != 0 or len(lines) != 1:
        _log(err.getvalue()[-4000:])
        raise AssertionError(f"bench {label}: rc {rc}, stdout {lines}")
    rec = json.loads(lines[0])
    for ln in err.getvalue().splitlines():
        if ln.startswith(("[", "kernel library", "  [", "device")):
            _log(f"  bench {label}: {ln.strip()}")
    _log(f"  bench {label} ({seconds:.2f} s): {json.dumps(rec)}")
    if "families_error" in rec:
        raise AssertionError(f"bench {label}: {rec['families_error']}")
    bad = [k for k, v in rec.items() if isinstance(v, float)
           and not np.isfinite(v)]
    if bad:
        raise AssertionError(f"bench {label}: non-finite {bad}")
    return rec, launches, seconds


def bench_phase():
    """Phase 17: the bench's JSON lines, and its kernel launches held
    against the ALG2 iterations (and stepA solves) it ran."""
    recs = {}
    for label, extra in BENCH_RUNS:
        rec, launches, _ = run_bench(label, extra)
        loops = device_loop.stats
        families = "--no-families" not in extra
        repeats = (BENCH_SHORT_REPEATS if "--repeats" in extra
                   else BENCH_REPEATS)
        want = bench_alg2_iterations(families, repeats)
        if rec["alg2_iterations"] != want:
            raise AssertionError(f"bench {label}: {rec['alg2_iterations']} "
                                 f"ALG2 iterations, expected {want}")
        kernel = "dct_solve" if rec["ops"] == "dct-fused" else \
            "fused_pointwise"
        expect = {kernel: want}
        check_launches(f"bench {label}", launches, expect, loops=loops)
        _log(f"  bench {label}: loop {rec['loop']}, ops {rec['ops']}, "
             f"{kernel} launched {launches[kernel]} times for its {want} "
             f"ALG2 iterations ({loops.eager_launches.get(kernel, 0)} "
             f"warm-up launches, {loops.replays} replays)"
             + (" (stepA solves)" if kernel == "dct_solve" else "")
             + (", the WFR family's included" if families else ""))
        recs[label] = dict(rec, launches=launches)
    if recs["auto"]["ops"] != "pallas":
        raise AssertionError(f"bench auto resolved {recs['auto']['ops']}")
    if recs["auto"]["loop"] != "device" or recs["auto host"]["loop"] != "host":
        raise AssertionError("bench loops: auto "
                             f"{recs['auto']['loop']}, host "
                             f"{recs['auto host']['loop']}")
    _log(f"  bench wall_ms_per_iter: device loop "
         f"{recs['auto']['wall_ms_per_iter']}, host loop "
         f"{recs['auto host']['wall_ms_per_iter']} (marginals "
         f"{recs['auto']['device_ms_per_iter_marginal']} and "
         f"{recs['auto host']['device_ms_per_iter_marginal']})")
    return recs


# --------------------------------------------------------- distribution

# Phase 18.  Full width (320x240, Nt=16) on every leg.  Cuts: the tiled
# FOTO and WFR (CG stepA, about 234 CG steps an ALG2 iteration, each with
# its halo exchanges and two all-reduces) run DIST_MAX_IT iterations; the
# tiled GN's Jacobi CG runs at most DIST_GN_MAXITER steps; the workers'
# tiled FOTO DIST_WORKER_ITERS iterations.
DIST_MAX_IT, DIST_GN_MAXITER, DIST_WORKER_ITERS = 5, 100, 5
# Tiled against whole at float64 on the card: the tests' (and
# tests/test_parallel.py's) whole-vs-tiled bound.  The GSPMD route with
# the pallas and dct-fused sets at float32 runs to its stopping rule and
# is compared per solve, as stepA sets are: IE within 0.5%.
DIST_ATOL, DIST_IE_RTOL = 1e-8, 5e-3
DIST_SECONDS = 600.0


def _foto_dist_kw(max_it):
    return dict(r=1.0, convergence_tol=0.01, reg_epsilon=1e-2,
                max_it=max_it, admm_alpha=ADMM_ALPHA)


def nccl_world_of_one(workdir: Path, rho):
    """(a) This process as a world of one rank on NCCL, a (1, 1) mesh: the
    tiled FOTO (cg set) and GN (Jacobi) bitwise the single-device solves
    with the same method."""
    import torch.distributed as dist
    from ofot_tpu_torch.parallel import (foto_sharded, gn_sharded,
                                         launch, mesh as mesh_mod, multihost)
    a, b = (torch.as_tensor(f, dtype=torch.float32, device=CARD)
            for f in rho)
    Nt, kw = SHAPE[0], _foto_dist_kw(DIST_MAX_IT)
    multihost.initialize(init_method=launch.rendezvous(workdir),
                         num_processes=1, process_id=0,
                         backend="nccl" if CARD == "cuda" else "gloo")
    try:
        mesh = mesh_mod.make_mesh({"y": 1, "x": 1}, platform=CARD)
        t0 = time.time()
        tiled = foto_sharded.solve_potential_tiled(a, b, Nt, mesh, **kw)
        t_tiled = time.time() - t0
        t0 = time.time()
        whole = foto.solve_potential(a, b, Nt, **kw)
        t_whole = time.time() - t0
        same = all(torch.equal(getattr(tiled, k), getattr(whole, k))
                   for k in ("mu", "q", "phi", "crit"))
        if not (same and tiled.iteration == whole.iteration
                and tiled.cg_iterations == whole.cg_iterations):
            raise AssertionError("NCCL (1, 1) tiled FOTO is not the "
                                 "single-device cg solve bitwise")
        gkw = dict(alpha=0.1, lambda_=0.2, maxiter=DIST_GN_MAXITER)
        t0 = time.time()
        gt = gn_sharded.solve_fields_tiled(a, b, mesh, **gkw)
        g_tiled = time.time() - t0
        t0 = time.time()
        gw = gn.solve_fields(a, b, precond="jacobi", **gkw)
        g_whole = time.time() - t0
        if not (all(torch.equal(getattr(gt, k), getattr(gw, k))
                    for k in "uvm")
                and gt.cg.iterations == gw.cg.iterations):
            raise AssertionError("NCCL (1, 1) tiled GN is not the "
                                 "single-device Jacobi solve bitwise")
        _log(f"  (a) NCCL world of 1, mesh (1, 1), {dist.get_backend()}: "
             f"FOTO cg set {tiled.iteration} iterations "
             f"({tiled.cg_iterations} CG steps) bitwise, {t_tiled:.2f} s "
             f"tiled against {t_whole:.2f} s whole; GN Jacobi "
             f"{gt.cg.iterations} CG steps bitwise, {g_tiled:.2f} s against "
             f"{g_whole:.2f} s")
    finally:
        dist.destroy_process_group()


def _ie(f0, f1, phi):
    """IE of the flow extracted from ``phi`` (warp of f0 against f1)."""
    from ofot_tpu_torch.solvers import flow_extract
    from ofot_tpu_torch.utils import warp
    _, h, w = SHAPE
    u, v, m = flow_extract.flow_from_potential(
        torch.as_tensor(phi, device=CARD))
    a = torch.as_tensor(f0, dtype=u.dtype, device=CARD)
    rec = np.clip(warp.apply_flow(a, u, v, m).cpu().numpy(), 0, 1)
    return metrics.IE(w, h, rec, np.asarray(f1, np.float64))


def four_rank_world(rho):
    """(b) Four processes sharing the card on a gloo 2x2 mesh: tiled FOTO,
    WFR and GN against the whole solves on the card at float64; the GSPMD
    route with the pallas and dct-fused sets at float32 to their stopping
    rule, per solve (IE); every rank the same result.  Returns the GSPMD
    kernels' launches summed over the ranks."""
    from ofot_tpu_torch.parallel import cases, launch
    f0, f1 = (np.asarray(f, np.float64) for f in rho)
    Nt, kw = SHAPE[0], _foto_dist_kw(DIST_MAX_IT)
    wkw = dict(kw, delta=WFR_DELTA)
    gkw = dict(alpha=0.1, lambda_=0.2, maxiter=DIST_GN_MAXITER)
    pkw = _foto_dist_kw(200)
    tiles = {"y": 2, "x": 2}
    # the GSPMD sets and the kernel each launches once an iteration on
    # every rank: pallas's fused pass on the rank's tile, dct-fused's
    # whole-field solve on the gathered F
    gspmd_sets = {"pallas": "fused_pointwise", "dct-fused": "dct_solve"}
    specs = [("foto", tiles, "foto_tiled", dict(f1=f0, f2=f1, Nt=Nt, **kw)),
             ("wfr", tiles, "wfr_tiled", dict(f1=f0, f2=f1, Nt=Nt, **wkw)),
             ("gn", tiles, "gn_tiled", dict(f1=f0, f2=f1, **gkw)),
             *[(ops, tiles, "foto_gspmd",
                dict(f1=f0.astype(np.float32), f2=f1.astype(np.float32),
                     Nt=Nt, ops=ops, **pkw)) for ops in gspmd_sets]]
    t0 = time.time()
    world = launch.run(cases.run_cases, 4, specs, CARD, threads=0,
                       seconds=DIST_SECONDS)
    wall = time.time() - t0
    started = max(r["started"] for r in world) - t0
    cases_s = sum(world[0][f"{name}_s"] for name, *_ in specs)
    _log(f"  (b) 4-rank world {wall:.2f} s: the last rank began its cases "
         f"{started:.2f} s after the spawn (process start-up and the "
         f"world's join), rank 0's cases took {cases_s:.2f} s")
    for name, *_ in specs:
        if any(r[name] != cases.digest(world[0][name]) for r in world[1:]):
            raise AssertionError(f"4-rank {name}: the ranks' results differ")
    got = {name: world[0][name] for name, *_ in specs}
    a, b = (torch.as_tensor(f, device=CARD) for f in (f0, f1))
    solves = {
        "foto": lambda: foto.solve_potential(a, b, Nt, **kw),
        "wfr": lambda: wfr.solve_potential(a, b, Nt, ops=foto.DEFAULT_OPS,
                                           **wkw),
        "gn": lambda: gn.solve_fields(a, b, precond="jacobi", **gkw)}
    for ops in gspmd_sets:
        solves[ops] = functools.partial(
            foto.solve_potential, a.float(), b.float(), Nt,
            ops=foto.stepA_ops(ops), **pkw)
    whole, secs = {}, {}
    for name, fn in solves.items():
        t0 = time.time()
        whole[name] = fn()
        torch.cuda.synchronize()
        secs[name] = time.time() - t0
    for name in ("foto", "wfr"):
        g, w_ = got[name], whole[name]
        gap = max(float(np.abs(g[k] - getattr(w_, k).cpu().numpy()).max())
                  for k in ("phi", "mu"))
        if not (gap < DIST_ATOL and int(g["iteration"]) == w_.iteration):
            raise AssertionError(f"4-rank tiled {name}: gap {gap:.3e}, "
                                 f"{g['iteration']} against {w_.iteration} "
                                 "iterations")
        _log(f"  (b) tiled {name} 2x2, float64, {w_.iteration} iterations "
             f"({int(g['cg_iterations'])} CG steps; whole "
             f"{w_.cg_iterations}): max |tiled - whole| {gap:.3e} (tol "
             f"{DIST_ATOL:g}); {world[0][name + '_s']:.2f} s tiled "
             f"against {secs[name]:.2f} s whole")
    g, w_ = got["gn"], whole["gn"]
    gap = max(float(np.abs(g[k] - getattr(w_, k).cpu().numpy()).max())
              for k in "uvm")
    if not gap < DIST_ATOL:
        raise AssertionError(f"4-rank tiled GN: gap {gap:.3e}")
    _log(f"  (b) tiled GN 2x2, float64, Jacobi, {int(g['iterations'])} CG "
         f"steps (whole {w_.cg.iterations}): max |tiled - whole| "
         f"{gap:.3e} (tol {DIST_ATOL:g}); {world[0]['gn_s']:.2f} s tiled "
         f"against {secs['gn']:.2f} s whole")
    launches = {}
    for ops, kernel in gspmd_sets.items():
        g, w_ = got[ops], whole[ops]
        for r in world:
            check_launches(f"GSPMD {ops} rank", r[f"{ops}_launches"],
                           {kernel: int(g["iteration"])})
        ie_t, ie_w = _ie(f0, f1, g["phi"]), _ie(f0, f1, w_.phi)
        gap = abs(ie_t - ie_w) / ie_w
        if not (gap <= DIST_IE_RTOL and int(g["iteration"]) < 200
                and w_.iteration < 200):
            raise AssertionError(f"GSPMD {ops}: IE {ie_t} against {ie_w}, "
                                 f"{g['iteration']} / {w_.iteration} "
                                 "iterations")
        _log(f"  (b) GSPMD route, {ops} set, float32, 2x2: "
             f"{int(g['iteration'])} iterations against {w_.iteration} "
             f"whole; IE {ie_t:.6f} against {ie_w:.6f} (gap {gap:.2e}, tol "
             f"{DIST_IE_RTOL:g}); {world[0][ops + '_s']:.2f} s against "
             f"{secs[ops]:.2f} s whole; {kernel} launched once an "
             "iteration on each rank")
        launches[kernel] = sum(r[f"{ops}_launches"][kernel] for r in world)
    return launches


def data_parallel_runs(workdir: Path, seqs):
    """(c) ``run --batch --data-parallel N`` (N = 2, then 4) on phase 15's
    middlebury-1 data against the one-process map batch: every flow within
    AEPE 1e-4."""
    from ofot_tpu_torch.cli import pipeline
    data, batched = workdir / "sweep-data", workdir / "sweep-batch"
    keys = [k for k in seqs if k.split("/")[0] == "middlebury-1"]
    for n in (2, 4):
        results = workdir / f"sweep-dp{n}"
        argv = ["run", "--batch", "--data-parallel", str(n), "--data-root",
                str(data), "--results", str(results), "--datasets",
                "middlebury-1", "--algos", ",".join(SWEEP_ALGOS),
                f"--platform={CARD}"]
        out = io.StringIO()
        t0 = time.time()
        try:
            with contextlib.redirect_stdout(out):
                rc = pipeline.main(argv)
        except BaseException:
            _log(out.getvalue()[-4000:])
            raise
        seconds = time.time() - t0
        if rc != 0:
            _log(out.getvalue()[-4000:])
            raise AssertionError(f"--data-parallel {n}: rc {rc}")
        man = json.loads((results / "manifest.json").read_text())
        worst = 0.0
        for key in keys:
            for algo in SWEEP_ALGOS:
                if man[key][algo]["status"] != "ok":
                    raise AssertionError(f"--data-parallel {n} {key} "
                                         f"{algo}: {man[key][algo]}")
                _, _, u1, v1 = flo.read_flo(str(batched / key /
                                                f"{algo.lower()}.flo"))
                _, _, u2, v2 = flo.read_flo(str(results / key /
                                                f"{algo.lower()}.flo"))
                worst = max(worst, float(np.hypot(u1 - u2, v1 - v2).mean()))
        if not worst < SWEEP_BATCH_AEPE:
            raise AssertionError(f"--data-parallel {n}: flows {worst} px "
                                 "from the one-process batch")
        _log(f"  (c) run --batch --data-parallel {n} (middlebury-1, "
             f"{len(keys)} sequences x {len(SWEEP_ALGOS)} algos, one card, "
             f"gloo): {seconds:.2f} s; worst AEPE against the one-process "
             f"map batch {worst:.3g} (tol {SWEEP_BATCH_AEPE:g})")


def two_workers(workdir: Path):
    """(d) Two ``multihost_worker`` processes with ``--platform cuda``: a
    world of 2 on the card (gloo), the all-reduce, the tiled FOTO at full
    width with the same fingerprint on both, the distributed checkpoint
    round trip, and the sweep partition (GN on middlebury-1) merged."""
    from ofot_tpu_torch.cli import pipeline
    from ofot_tpu_torch.parallel import launch
    root = workdir / "workers"
    root.mkdir()
    outs = [root / f"host{i}.json" for i in range(2)]
    _, h, w = SHAPE
    cmd = [sys.executable, "-m", "ofot_tpu_torch.parallel.multihost_worker",
           "--coordinator", launch.rendezvous(root), "--num-processes", "2",
           "--platform", CARD, "--foto-shape", f"{h}x{w}",
           "--foto-nt", str(SHAPE[0]), "--foto-iters",
           str(DIST_WORKER_ITERS), "--checkpoint-dir", str(root / "ckpt"),
           "--data-root", str(workdir / "sweep-data"),
           "--results", str(root / "results"), "--datasets", "middlebury-1",
           "--algos", "GN"]
    t0 = time.time()
    procs = [subprocess.Popen(cmd + ["--process-id", str(i),
                                     "--out", str(outs[i])],
                              cwd=Path(__file__).resolve().parent,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=DIST_SECONDS)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    seconds = time.time() - t0
    for p, log in zip(procs, logs):
        if p.returncode != 0:
            _log(log[-4000:])
            raise AssertionError(f"multihost worker: rc {p.returncode}")
    res = [json.loads(o.read_text()) for o in outs]
    for r in res:
        ok = (r["process_count"] == 2 and r["psum"] == r["psum_expected"]
              and r["device"].startswith(CARD) and r["sweep_rc"] == 0
              and r["ckpt_phi_l1"] == r["foto_phi_l1"]
              and r["ckpt_iteration"] == r["foto_iterations"])
        if not ok:
            raise AssertionError(f"multihost worker record {r}")
    keys = ("foto_crit", "foto_phi_l1", "foto_iterations")
    if any(res[0][k] != res[1][k] for k in keys) or \
            not res[0]["foto_iterations"] > 0 or \
            not np.isfinite(res[0]["foto_crit"]):
        raise AssertionError(f"multihost workers differ: {res}")
    with contextlib.redirect_stdout(io.StringIO()):
        pipeline.main(["merge-manifests", "--results", str(root / "results")])
    merged = json.loads((root / "results" / "manifest.json").read_text())
    if len(merged) != 3 or any(v["GN"]["status"] != "ok"
                               for v in merged.values()):
        raise AssertionError(f"multihost sweep manifest {merged}")
    _log(f"  (d) 2 multihost workers, --platform {CARD} ({res[0]['backend']}, "
         f"{res[0]['device']}): {seconds:.2f} s; tiled FOTO {h}x{w} "
         f"{res[0]['foto_iterations']} iterations, crit "
         f"{res[0]['foto_crit']:.6g} on both; checkpoint round trip exact; "
         "sweep partition merged (3 sequences); each worker's legs (s): "
         + "; ".join(json.dumps(r["leg_s"]) for r in res))


def distribution_phase(workdir: Path, rho, seqs):
    """Phase 18's four legs, each with its wall; returns the GSPMD
    route's kernel launches over its 4 ranks."""
    out = {}
    for label, fn, args in (("(a)", nccl_world_of_one, (workdir, rho)),
                            ("(b)", four_rank_world, (rho,)),
                            ("(c)", data_parallel_runs, (workdir, seqs)),
                            ("(d)", two_workers, (workdir,))):
        t0 = time.time()
        out[label] = fn(*args)
        _log(f"  {label} wall {time.time() - t0:.2f} s")
    return out["(b)"]


# --------------------------------------------------------- device loops

# Phase 19.  Every loop at 320x240 (Nt=16 for FOTO and WFR) on the host
# loop and on the device loop in one call: FOTO_ARGS' and WFR_ARGS'
# parameters (the cg-pallas set cut to DEVICE_LOOP_CG_PALLAS_MAX_IT ALG2
# iterations), GN_ARGS, HS_ARGS, the 4-level GN pyramid, the Sinkhorn flow
# at SINKHORN_ARGS (annealed, both stabilizers) and the lockstep FOTO at 8
# pairs; then the block size K swept on FOTO pallas.
DEVICE_LOOP_CG_PALLAS_MAX_IT = 20
DEVICE_LOOP_BLOCKS = (1, 4, 8, 16)


def _same_bits(a, b) -> bool:
    """Bitwise equality of two tensors (NaN included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        bits = {torch.float64: torch.int64, torch.float32: torch.int32}
        return torch.equal(a.view(bits[a.dtype]), b.view(bits[b.dtype]))
    return torch.equal(a, b)


def device_loop_paths(rho):
    """name -> (run(loop) -> (fields, iterations, CG steps), the kernel
    each iteration (or CG step) launches once, the unit it counts)."""
    a, b = (torch.as_tensor(x, dtype=torch.float32, device=CARD)
            for x in rho)
    Nt = SHAPE[0]
    alg2 = dict(r=1.0, convergence_tol=0.01, reg_epsilon=1e-2, max_it=200,
                admm_alpha=ADMM_ALPHA)
    f1s, f2s = (torch.as_tensor(x, device=CARD) for x in lockstep_pairs())

    def state(st):
        return ((st.mu, st.q, st.phi, st.crit),
                int(torch.as_tensor(st.iteration).max()), st.cg_iterations)

    def foto_path(solver, **kw):
        return lambda loop: state(foto.alg2_loop(
            a, b, Nt, ops=foto.stepA_ops(solver), loop=loop,
            **dict(alg2, **kw)))

    def wfr_path(solver):
        return lambda loop: state(wfr.alg2_loop(
            a, b, Nt, delta=WFR_DELTA, ops=foto.stepA_ops(solver), loop=loop,
            **alg2))

    def cg_path(solve):
        def run(loop):
            r = solve(a, b, loop)
            return (r.cg.x,), r.cg.iterations, r.cg.iterations
        return run

    def pyramid_path(loop):
        log = []
        u, v, m = pyramid.solve_gn_pyramid(a, b, 0.1, 0.2,
                                           levels=PYRAMID_LEVELS,
                                           cg_log=log, loop=loop)
        steps = sum(c.iterations for c in log)
        return (u, v, m), steps, steps

    def sinkhorn_path(stabilizer):
        def run(loop):
            res = sinkhorn.flow(a, b, SINKHORN_EPS, max_iter=1000,
                                tol=SINKHORN_TOL, stabilizer=stabilizer,
                                loop=loop)
            return (res.u, res.v, res.cost_ab), res.iterations, 0
        return run

    def lockstep_path(loop):
        return state(foto.alg2_loop_batched(
            f1s, f2s, Nt, ops=foto.stepA_ops("pallas"), loop=loop, **alg2))

    return {
        "foto pallas": (foto_path("pallas"), "fused_pointwise", "its"),
        "foto dct": (foto_path("dct"), None, "its"),
        "foto dct-fused": (foto_path("dct-fused"), "dct_solve", "its"),
        "foto dct-refined": (foto_path("dct-refined"), None, "its"),
        "wfr pallas": (wfr_path("pallas"), "fused_pointwise", "its"),
        "wfr dct-fused": (wfr_path("dct-fused"), "dct_solve", "its"),
        "gn": (cg_path(lambda p, q, loop: gn.solve_fields(
            p, q, 0.1, 0.2, loop=loop)), None, "CG steps"),
        "gn pyramid": (pyramid_path, None, "CG steps"),
        "hs": (cg_path(lambda p, q, loop: hs.solve_fields(
            p, q, 0.1, loop=loop)), None, "CG steps"),
        "foto cg-pallas": (foto_path(
            "cg-pallas", max_it=DEVICE_LOOP_CG_PALLAS_MAX_IT),
            "cg_operator_blocked", "CG steps"),
        "sinkhorn auto": (sinkhorn_path("matmul"), None, "its"),
        "sinkhorn exact": (sinkhorn_path("exact"), None, "its"),
        f"lockstep foto B={LOCKSTEP_B}": (lockstep_path, "fused_pointwise",
                                          "its"),
    }


def _loop_run(fn, loop):
    """One run of ``fn(loop)`` with the counts and the peak memory reset
    just before -> (result, seconds, launches, loop stats, peak bytes over
    the bytes held before)."""
    torch.cuda.synchronize()
    reset_counts()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn(loop)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return (out, seconds, kernels.launch_counts(),
            copy.deepcopy(device_loop.stats),
            torch.cuda.max_memory_allocated() - held)


def device_loop_phase(rho):
    """Phase 19: each path's host loop against its device loop (a cold run
    that captures, then a warm one that replays the cached graph): the
    same bits, iterations and CG steps, the launch relation, warm walls
    and ms per iteration, capture ms, K and replays, a profiler window's
    idle share and the peak memory; then the K sweep on FOTO pallas."""
    out = {}
    for name, (fn, kernel, unit) in device_loop_paths(rho).items():
        host = _loop_run(fn, "host")
        device_loop.clear_cache()        # the cold run captures afresh
        cold = _loop_run(fn, "device")
        warm = _loop_run(fn, "device")
        (hf, h_its, h_cg), host_s, host_l, _, host_peak = host
        n = max(int(h_cg if unit == "CG steps" else h_its), 1)
        expect = {kernel: n} if kernel else {}
        check_launches(f"host loop {name}", host_l, expect)
        for label, run in (("cold", cold), ("warm", warm)):
            (df, d_its, d_cg), _, launches, loops, _ = run
            if not (d_its == h_its and torch.equal(torch.as_tensor(d_cg),
                                                   torch.as_tensor(h_cg))
                    and all(map(_same_bits, hf, df))):
                raise AssertionError(
                    f"device loop {name} ({label}): {d_its} iterations "
                    f"against the host loop's {h_its}, or fields not "
                    "bitwise equal")
            check_launches(f"device loop {name} ({label})", launches, expect,
                           loops=loops)
        _, busy_ms, wall_ms = profile_window(
            f"device loop {name}", lambda k: fn("device"), n, top=5,
            unit=unit)
        rec = dict(iterations=h_its, unit=unit, count=n,
                   host_s=host_s, device_s=warm[1], cold_s=cold[1],
                   host_ms=1e3 * host_s / n, device_ms=1e3 * warm[1] / n,
                   capture_ms=cold[3].capture_ms, captures=cold[3].captures,
                   warm_captures=warm[3].captures,
                   warm_capture_ms=warm[3].capture_ms,
                   replays=warm[3].replays, block=device_loop.BLOCK,
                   idle=1.0 - busy_ms / wall_ms, device_busy_ms=busy_ms / n,
                   warm_busy=busy_ms / (1e3 * warm[1]),
                   host_peak=host_peak, device_peak=cold[4])
        _log(f"  {name}: {n} {unit}, bitwise; host loop {host_s:.4f} s "
             f"({rec['host_ms']:.4f} ms each), device loop warm "
             f"{warm[1]:.4f} s ({rec['device_ms']:.4f} ms each; "
             f"{rec['warm_captures']} captures in "
             f"{rec['warm_capture_ms']:.2f} ms), cold {cold[1]:.4f} s with "
             f"{rec['captures']} captures in {rec['capture_ms']:.2f} ms; "
             f"K={rec['block']}, {rec['replays']} replays; profiled idle "
             f"{100 * rec['idle']:.1f}% (device busy "
             f"{rec['device_busy_ms']:.4f} ms each = "
             f"{100 * rec['warm_busy']:.1f}% of the unprofiled warm wall); "
             "peak memory host "
             f"{host_peak / 2**20:.1f} MiB, device {cold[4] / 2**20:.1f} "
             "MiB")
        out[name] = rec

    fn, kernel, _ = device_loop_paths(rho)["foto pallas"]
    sweep, block = {}, device_loop.BLOCK
    try:
        for K in DEVICE_LOOP_BLOCKS:
            device_loop.BLOCK = K
            cold = _loop_run(fn, "device")
            warm = _loop_run(fn, "device")
            (_, its, _), seconds, launches, loops, _ = warm
            check_launches(f"K={K}", launches, {kernel: its}, loops=loops)
            sweep[K] = dict(ms=1e3 * seconds / its,
                            capture_ms=cold[3].capture_ms,
                            replays=loops.replays, slots=loops.slots)
            _log(f"  K sweep, foto pallas, K={K}: {its} iterations, warm "
                 f"{seconds:.4f} s ({sweep[K]['ms']:.4f} ms each), "
                 f"{loops.replays} replays ({loops.slots - its} masked "
                 f"iterations), capture {cold[3].capture_ms:.2f} ms")
    finally:
        device_loop.BLOCK = block
    out["K sweep"] = sweep
    return out


# ---------------------------------------------------- examples and tools

EXAMPLES = ("quickstart", "unbalanced_flow", "wasserstein",
            "differentiable_ot", "sharded_solve")
# card against CPU, per returned number: a relative tolerance, or
# ("count", n) for a count within n; the CPU tests' bounds
# (tests/test_torch_examples.py): 1e-3, WFR 2%, the float32 Sinkhorn
# regime's entropic W2 3% and descent S 1%, GN's float32 CG count 25
# (its spread on the CPU under one-ulp changes of the frames: 175-198)
EXAMPLE_TOLERANCES = {
    "quickstart": dict(foto_iterations=("count", 0), foto_crit=1e-3,
                       foto_IE=1e-3, foto_mean_u=1e-3,
                       gn_cg_iterations=("count", 25), gn_IE=1e-3),
    "unbalanced_flow": dict(foto_IE=1e-3, foto_mean_u=1e-3, wfr_IE=2e-2,
                            wfr_mean_u=2e-2, created=2e-2,
                            peak_growth=2e-2, true_gain=1e-6),
    "wasserstein": dict(dynamic=1e-3, entropic=3e-2),
    "differentiable_ot": dict(S=1e-4, grad_min=2e-3, grad_max=2e-3,
                              steps=1e-2, after=1e-2),
    "sharded_solve": dict(iterations=("count", 0), crit=1e-3),
}
# tune_gn's Middlebury-2 layout: sequence -> (dy, dx), at the sweep's
# 320x240; Adam steps
TUNE_SHIFTS = {"Drift": (1, 2), "Sway": (-2, 1), "Tilt": (2, -1)}
TUNE_STEPS = 3
TOOL_RTOL = {"w2_gradient_flow": 2e-4, "tune_gn": 1e-6}
# the CPU run of w2_gradient_flow takes its first W2_CPU_STEPS steps (the
# same iterates as the card's first steps: its float32 Sinkhorn solves
# are slow on a CPU, a minute for the 12 default steps)
W2_CPU_STEPS = 4


def _within(label, key, got, want, rule):
    """``got`` (card) against ``want`` (CPU) by ``rule``, item by item ->
    a description of the mismatch, or None."""
    for g, w in zip(np.atleast_1d(got), np.atleast_1d(want)):
        ok = (abs(g - w) <= rule[1] if isinstance(rule, tuple)
              else abs(g - w) <= rule * abs(w))
        if not (ok and np.isfinite(g)):
            return (f"{label}: {key} {got} on the card against {want} on "
                    f"the CPU ({rule})")
    return None


def _brief(res):
    """A run's numbers, unrounded, for the log."""
    if isinstance(res, dict):
        res = {k: v for k, v in res.items()
               if isinstance(v, (int, float, list))}
    return json.dumps(res)


def _measured(label, run, device):
    """``run()`` with the launch counts and the peak memory reset just
    before -> (result, seconds, launches, loop stats, peak MiB); its
    prints go to a buffer shown only on failure."""
    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
    reset_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            out = run()
    except Exception:
        print(buf.getvalue())
        raise
    if cuda:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = ((torch.cuda.max_memory_allocated() - held) / 2 ** 20 if cuda
            else 0.0)
    return (out, seconds, kernels.launch_counts(),
            copy.deepcopy(device_loop.stats), peak, buf.getvalue())


def write_tune_data(root: Path) -> Path:
    """A Middlebury-2 layout of seeded textures at 320x240, each moved by
    its TUNE_SHIFTS entry, with the constant ground truth as ``.flo``."""
    _, h, w = SHAPE
    for i, (name, (dy, dx)) in enumerate(TUNE_SHIFTS.items()):
        f0, f1 = textured_pair(h, w, shift=(dy, dx), seed=SEED + 40 + i)
        seq = root / "middlebury-2" / "other-data-gray" / name
        gt = root / "middlebury-2" / "other-gt-flow" / name
        seq.mkdir(parents=True)
        gt.mkdir(parents=True)
        image.save_grayscale(f0, str(seq / "frame10.png"))
        image.save_grayscale(f1, str(seq / "frame11.png"))
        flo.write_flo(w, h, np.full(h * w, float(dx)),
                      np.full(h * w, float(dy)), str(gt / "flow10.flo"))
    return root


def _w2_flow(platform, steps=()):
    from ofot_tpu_torch.tools import w2_gradient_flow
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        if w2_gradient_flow.main(["--platform", platform, *steps]) != 0:
            raise AssertionError("w2_gradient_flow exited with an error")
    print(out.getvalue(), end="")
    line = out.getvalue().strip().splitlines()[-1]
    return json.loads(line)["S_trajectory"]


def _tune(root: Path, platform):
    from ofot_tpu_torch.tools import tune_gn
    names, groups = tune_gn.load_groups(str(root / "middlebury-2"),
                                        platform)
    res = tune_gn.tune(groups, names, TUNE_STEPS, 0.15, platform)
    tune_gn.report(names, res)
    return res


def _phase20_runs(tune_root: Path) -> dict:
    """name -> (run(platform, *args) -> its numbers, tolerance)."""
    import importlib
    runs = {}
    for name in EXAMPLES:
        mod = importlib.import_module(f"ofot_tpu_torch.examples.{name}")
        runs[name] = (lambda p, mod=mod: mod.main(["--platform", p]),
                      EXAMPLE_TOLERANCES[name])
    runs["w2_gradient_flow"] = (_w2_flow, TOOL_RTOL["w2_gradient_flow"])
    runs["tune_gn"] = (lambda p: _tune(tune_root, p), TOOL_RTOL["tune_gn"])
    return runs


# phase 20's CPU runs, in three processes at once after the card runs
# (CPU runs take 3-30x the card's time: each is best on a few threads);
# sharded_solve starts its own four single-thread ranks
CPU_GROUPS = (("sharded_solve",),
              ("w2_gradient_flow", "differentiable_ot", "wasserstein"),
              ("tune_gn", "quickstart", "unbalanced_flow"))
CPU_GROUP_THREADS = 2
CPU_ARGS = {"w2_gradient_flow": (["--steps", str(W2_CPU_STEPS)],)}


def cpu_runs(names, tune_root: str, out: str) -> None:
    """The CPU runs of ``names`` in this process, saved to ``out`` as
    name -> (numbers, seconds)."""
    torch.set_num_threads(CPU_GROUP_THREADS)
    runs = _phase20_runs(Path(tune_root))
    done = {}
    for name in names:
        run = runs[name][0]
        res = _measured(name, lambda: run("cpu", *CPU_ARGS.get(name, ())),
                        "cpu")
        done[name] = res[:2]
    torch.save(done, out)


def _cpu_groups(tune_root: Path, workdir: Path) -> dict:
    """Every CPU run, CPU_GROUPS in processes of their own at once ->
    name -> (numbers, seconds)."""
    root = Path(__file__).resolve().parent
    procs = []
    for i, names in enumerate(CPU_GROUPS):
        out = workdir / f"cpu_runs{i}.pt"
        code = ("import sys; sys.path.insert(0, sys.argv[1]); "
                "import chip_smoke; chip_smoke.cpu_runs(sys.argv[2:-2], "
                "sys.argv[-2], sys.argv[-1])")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", code, str(root), *names, str(tune_root),
             str(out)], cwd=root, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), out))
    done = {}
    for proc, out in procs:
        text, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise AssertionError(f"phase 20 CPU runs failed:\n{text}")
        done.update(torch.load(out, weights_only=False))
    return done


def examples_phase(workdir: Path):
    """Phase 20: the port's five examples and its two tools on the card,
    then each again on the CPU (CPU_GROUPS at once), card against CPU;
    seconds, launches of each kernel and peak memory (over what was held
    before) of each card run.  Returns the card runs' launches of #1."""
    tune_root = write_tune_data(workdir / "tune")
    runs = _phase20_runs(tune_root)
    cards = {name: _measured(name, lambda: run(CARD), CARD)
             for name, (run, _) in runs.items()}
    t0 = time.perf_counter()
    cpus = _cpu_groups(tune_root, workdir)
    _log(f"  the CPU runs, {len(CPU_GROUPS)} processes at once: "
         f"{time.perf_counter() - t0:.2f} s")
    fused, bad = {}, []
    for name, (_, tol) in runs.items():
        res, seconds, launches, loops, peak, text = cards[name]
        cpu, cpu_s = cpus[name]
        if name == "sharded_solve":        # its one rank ran the solve
            launches, peak = res["launches"], res["peak_mib"] or 0.0
            loops = None
        expect = ({"fused_pointwise": res["wfr_iterations"]}
                  if name == "unbalanced_flow" else {})
        check_launches(f"example {name}", launches, expect, loops=loops)
        if name == "w2_gradient_flow":
            if not all(b < a for a, b in zip(res, res[1:])):
                bad.append(f"{name}: S not strictly decreasing: {res}")
            checks = [("S_trajectory", res[:len(cpu)], cpu, tol)]
        elif name == "tune_gn":
            checks = [(k, res[k], cpu[k], tol)
                      for k in ("alpha", "lambda_", "ee_default",
                                "ee_tuned")]
        else:
            checks = [(k, res[k], cpu[k], rule) for k, rule in tol.items()]
        bad += filter(None, (_within(name, *c) for c in checks))
        fused[name] = launches["fused_pointwise"]
        _log(f"  {name}: card {_brief(res)}; CPU {_brief(cpu)}")
        shown = {k: v for k, v in launches.items() if v}
        _log(f"  {name}: card {seconds:.2f} s, CPU {cpu_s:.2f} s; "
             f"launches {shown or 0} (fused_pointwise "
             f"{launches['fused_pointwise']}); peak memory "
             f"{peak:.1f} MiB; card lines: "
             + " | ".join(ln.strip() for ln in text.splitlines()[-3:]))
    if not fused["unbalanced_flow"] > 0:
        bad.append("unbalanced_flow launched no fused_pointwise on the "
                   "card")
    if bad:
        raise AssertionError("; ".join(bad))
    return fused


def main() -> int:
    t_start = time.time()

    with Phase("1 device"):
        if not torch.cuda.is_available():
            raise SystemExit("chip_smoke: torch.cuda.is_available() is "
                             "False; this smoke run needs a CUDA card")
        device = torch.device("cuda", 0)
        kind = torch.cuda.get_device_name(0)
        smi = nvidia_smi_line()
        mem_bw, f32_rate = card_rates(kind)
        _log(smi)
        _log(f"  torch {torch.__version__} cuda {torch.version.cuda}; "
             f"rates of {kind}: {mem_bw / 1e12} TB/s, "
             f"{f32_rate / 1e12} TFLOP/s float32")

    with Phase("2 build"):
        t0 = time.time()
        report = _build.build(extra_flags=("-Xptxas", "-v"))
        _log(f"  nvcc build of {len(_build.sources())} sources, one call "
             "each in parallel and a link, "
             f"{time.time() - t0:.2f} s -> {_build.library_path()}")
        for ln in report.splitlines():
            if "Compiling entry" in ln or "registers" in ln or "spill" in ln:
                _log(f"  {ln.strip()}")
        _build.load_library()

    with Phase("3 kernel vs plain"):
        worst, timings = check_kernel(device, mem_bw, f32_rate)

    with tempfile.TemporaryDirectory() as tmp:
        workdir = Path(tmp)
        _, _, rho = write_pair(workdir)

        with Phase("4 main path"):
            solve = run_main_path(workdir)

        with Phase("5 card vs cpu"):
            card_vs_cpu(rho)

        with Phase("6 profile"):
            profile_alg2(rho)

        with Phase("7 kernels vs plain"):
            dct_rec = check_dct_solve(device, mem_bw, f32_rate)
            proj_err, proj = check_projection(device, mem_bw, f32_rate)
            cg_err, cg_recs = check_cg_operator(device, mem_bw, f32_rate)

        with Phase("8 paths"):
            paths = run_paths(workdir)

        with Phase("9 wfr card vs cpu"):
            card_vs_cpu(rho, history=_wfr_history)

        with Phase("10 new-path profile"):
            profile_paths(rho)

        with Phase("11 gn/hs paths"):
            paths.update(run_gn_hs_paths(workdir))

        with Phase("12 gn card vs cpu"):
            gn_card_vs_cpu(rho)
            profile_gn_hs_paths(rho)

        with Phase("13 sinkhorn and outputs"):
            sk_auto = run_sinkhorn_path(workdir, "sinkhorn-auto", [])
            sk_exact = run_sinkhorn_path(workdir, "sinkhorn-exact",
                                         ["--sinkhorn-stabilizer=exact"])
            if sk_auto["stabilizer"] != "matmul" \
                    or sk_exact["stabilizer"] != "exact":
                raise AssertionError("sinkhorn stabilizers: "
                                     f"{sk_auto['stabilizer']}, "
                                     f"{sk_exact['stabilizer']}")
            gap = max(np.abs(sk_auto["u"] - sk_exact["u"]).max(),
                      np.abs(sk_auto["v"] - sk_exact["v"]).max())
            _log(f"  sinkhorn exact vs auto: {sk_exact['iterations']} "
                 f"against {sk_auto['iterations']} iterations, "
                 f"{sk_exact['solve_s']:.4f} against "
                 f"{sk_auto['solve_s']:.4f} s, max |flow gap| {gap:.4g} px")
            paths["foto-outputs"] = run_outputs_path(workdir)

        with Phase("14 sinkhorn card vs cpu"):
            sinkhorn_card_vs_cpu(rho)
            sinkhorn_tf32_guard(rho)
            profile_sinkhorn(rho)

        with Phase("15 pipeline"):
            seqs = run_pipeline_phase(workdir)

        with Phase("16 lockstep"):
            lock_worst, lock_fp = _timed(lockstep_fused_pointwise, device,
                                         mem_bw, f32_rate)
            lock_dct = _timed(lockstep_dct_solve, device, mem_bw, f32_rate)
            lock_cg = _timed(lockstep_cg_operator, device, mem_bw, f32_rate)
            lock_solves = _timed(lockstep_solves)
            lock_sets = _timed(lockstep_other_sets)
            _timed(lockstep_single_pair)
            _timed(profile_lockstep)
            _timed(run_lockstep_pipeline, workdir, seqs)

        with Phase("17 bench"):
            bench_recs = bench_phase()

        with Phase("18 distribution"):
            gspmd_launches = distribution_phase(workdir, rho, seqs)

        with Phase("19 device loops"):
            device_loop_phase(rho)

        with Phase("20 examples and tools"):
            example_launches = examples_phase(workdir)

    # launches: each kernel's count from the path that runs it; the
    # standalone projection and the whole-array operator are on no path
    every_run = [solve, *paths.values()]
    t = timings[(3, ADMM_ALPHA)]

    def entry(name, source, replaces, launches, err, rec):
        return {"name": name, "route": "cuda",
                "source": f"ofot_tpu_torch/csrc/{source}",
                "replaces": f"ofot_tpu/ops/pallas/kernels.py:{replaces}",
                "launches": launches, "max_abs_err": err, "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
                "device_ms": rec["device_ms"],
                "plain_device_ms": rec["plain_device_ms"],
                "library_device_ms": rec["library_device_ms"]}

    def lockstep_entry(e):
        rec = {"fused_pointwise_batched": lock_fp[3],
               "dct_solve_batched": lock_dct,
               "cg_operator_batched": lock_cg}[e["name"]]
        return dict(e, batch=LOCKSTEP_B, singles_ms=rec["singles_ms"],
                    singles_device_ms=rec["singles_device_ms"],
                    **{k: rec[k] for k in ("cold_ms", "cold_device_ms")
                       if k in rec})

    # this slice's paths: the bench (phase 17) and the GSPMD route
    # (phase 18, summed over its 4 ranks): pallas's tile-local fused pass
    # and dct-fused's solve of the gathered F
    bench_launches = {k: r["launches"] for k, r in bench_recs.items()}
    record = {"kernels": [
        dict(entry("fused_pointwise", "fused_pointwise.cu", 224,
                   solve["launches"]["fused_pointwise"], worst, t),
             bench_launches=bench_launches["auto"]["fused_pointwise"],
             gspmd_launches=gspmd_launches["fused_pointwise"],
             examples_launches=example_launches),
        # the library call is the port's whole cuBLAS stepA, so the whole
        # dct-fused stepA (t products + kernel) stands beside it
        dict(entry("dct_solve", "dct_solve.cu", 355,
                   paths["foto-dct-fused"]["launches"]["dct_solve"],
                   dct_rec["max_abs_err"], dct_rec),
             stepA_ms=dct_rec["stepA_ms"],
             stepA_device_ms=dct_rec["stepA_device_ms"],
             f32_bound_ms=dct_rec["f32_bound_ms"],
             err_vs_float64=dct_rec["f64"],
             bench_launches=bench_launches["dct-fused"]["dct_solve"],
             gspmd_launches=gspmd_launches["dct_solve"]),
        dict(entry("project_paraboloid", "projection.cu", 130,
                   sum(r["launches"]["project_paraboloid"]
                       for r in every_run), proj_err, proj[3]),
             cold_ms=proj[3]["cold_ms"],
             cold_device_ms=proj[3]["cold_device_ms"]),
        entry("cg_operator", "cg_operator.cu", 488,
              sum(r["launches"]["cg_operator"] for r in every_run),
              cg_err, cg_recs["cg_operator"]),
        entry("cg_operator_blocked", "cg_operator.cu", 528,
              paths["foto-cg-pallas"]["launches"]["cg_operator_blocked"],
              cg_err, cg_recs["cg_operator_blocked"]),
        # the lockstep forms (phase 16, B = 8 pairs a launch): launches
        # from the lockstep FOTO run at the pipeline's parameters and from
        # the lockstep dct-fused and cg-pallas runs (B = 4)
        dict(lockstep_entry(entry(
            "fused_pointwise_batched", "fused_pointwise.cu", 224,
            lock_solves["foto"]["launches"]["fused_pointwise"], lock_worst,
            lock_fp[3])),
            bench_launches=bench_launches["batch 8"]["fused_pointwise"]),
        dict(lockstep_entry(entry(
            "dct_solve_batched", "dct_solve.cu", 355,
            lock_sets["dct-fused"]["launches"]["dct_solve"],
            lock_dct["max_abs_err"], lock_dct)),
            stepA_ms=lock_dct["stepA_ms"],
            stepA_device_ms=lock_dct["stepA_device_ms"]),
        lockstep_entry(entry("cg_operator_batched", "cg_operator.cu", 528,
                             lock_sets["cg-pallas"]["launches"][
                                 "cg_operator_blocked"],
                             lock_cg["max_abs_err"], lock_cg)),
    ]}
    _log(f"chip_smoke wall {time.time() - t_start:.2f} s")
    _log(smi)
    _log(json.dumps(record))
    _log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
