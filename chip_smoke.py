#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ofot_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py              # from the repository root

Phases, each printed with its elapsed seconds:

1. device: the card's name and power limit (nvidia-smi); no card, no run;
2. build: ``nvcc`` compiles ``ofot_tpu_torch/csrc/*.cu`` into
   ``ofot_tpu_torch/_build/`` (plain C interface, loaded with ctypes);
3. kernel vs plain: the fused stepB/stepC/criterion kernel against its
   plain torch version on the same CUDA tensors, at (3|4, 16, 240, 320),
   alpha 1 and 1.7, with repeat launches bitwise-equal in the criterion
   sums; CUDA-event timings of both beside the kernel's bound;
4. main path: the port's CLI runs the sweep's FOTO solve (FOTO_ARGS,
   320x240, Nt=16, stepA auto -> the fused kernel) on a seeded textured
   pair, and must launch the kernel once per ALG2 iteration, reduce IE
   below the identity warp's and write a 320x240 .flo;
5. card vs CPU: 20 fixed ALG2 iterations at full size on the card (kernel)
   and on the CPU (plain version), crit trajectory and phi compared;
6. profile: a torch.profiler window of ALG2 iterations on the card (kernel
   time by name, the device's busy share) and the CLI's solve again, warm.

The last two lines are the kernels' JSON record and the result line
``{"ok": true, "device": {...}}``.  Any failure raises, so the exit code is
not 0 and no result line is printed.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import ofot_tpu_torch.ops.kernels.fused_pointwise as fp
from ofot_tpu_torch.cli import main as cli
from ofot_tpu_torch.ops.kernels import _build
from ofot_tpu_torch.solvers import foto
from ofot_tpu_torch.utils import flo, image, metrics

SEED = 0
SHAPE = (16, 240, 320)                     # (Nt, Ny, Nx) of the sweep
FOTO_ARGS = ["--algo=foto", "--r=1", "--convergence-tol=0.01",
             "--reg-epsilon=1e-2", "--Nt=16", "--max-it=200",
             "--admm-alpha=1.7"]           # ofot_tpu/cli/pipeline.py:61-63
ADMM_ALPHA = 1.7
CARD_VS_CPU_ITERATIONS = 20
PROFILE_ITERATIONS = 10

# Kernel vs plain version, float32 on the card.  The kernel takes
# cbrtf/acosf where the plain version takes the Pallas kernel's exp/log and
# Newton forms, and nvcc fuses multiply-adds: elementwise agreement to a
# few hundred ulps of O(1) values; the criterion sums (1.2M float32
# products, summed in another order) to 1e-5 relative.
KERNEL_ATOL, KERNEL_RTOL, SUM_RTOL = 2e-5, 1e-5, 1e-5
# Card vs CPU after 20 float32 ALG2 iterations: about 70x the float32 vs
# float64 drift of the same run at 80x60 (1.5e-5 on crit, 1.2e-6 of
# max|phi| on phi) — the products and sums of each iteration round
# differently on the two devices, and ADMM carries that forward.
CRIT_RTOL, PHI_RTOL = 1e-3, 1e-4

# Memory bytes/s and float32 FLOP/s outside the tensor cores of the H100
# SXM (NVIDIA's data sheet, dense rates, 700 W power limit)
H100_SXM = "NVIDIA H100 80GB HBM3"
MEM_BW, F32_RATE = 3.35e12, 67e12


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


def cuda_time_ms(fn) -> float:
    """Device time of one ``fn()``: the median over 20 samples of the mean
    of 10 back-to-back calls between two CUDA events, after 3 warm-up
    calls."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 10)
    return statistics.median(times)


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
    t_bytes, t_ops = nbytes / mem_bw, ops / f32_rate
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def check_kernel(device, mem_bw, f32_rate):
    """Phase 3: every (ncomp, alpha) case checked against the plain
    version; returns the largest elementwise error and, for ncomp = 3,
    the timings by alpha."""
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
            if ncomp == 3:
                enqueue, _ = fp.prepare_launch(g, m, r, alpha, qp)
                ms = cuda_time_ms(enqueue)
                wrapper_ms = cuda_time_ms(lambda: fp.fused_pointwise(
                    g, m, r, alpha=alpha, q_prev=qp))
                plain_ms = cuda_time_ms(lambda: fp.fused_pointwise_reference(
                    g, m, r, alpha, qp))
                bound_ms, bound_by, nbytes, ops = fused_pointwise_bound(
                    g, m, r, alpha, qp, mem_bw, f32_rate)
                timings[alpha] = dict(ms=ms, plain_ms=plain_ms,
                                      bound_ms=bound_ms, bound_by=bound_by)
                _log(f"  {case} timing: kernel {ms:.4f} ms (through the "
                     f"wrapper {wrapper_ms:.4f} ms a call), plain "
                     f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                     f"({bound_by}: {nbytes / 1e6:.1f} MB, "
                     f"{ops / 1e6:.1f} Mop), kernel at "
                     f"{100 * bound_ms / ms:.1f}% of bound")
            del g, m, qp, got, again, want
    return worst, timings


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


def run_main_path(workdir: Path):
    """Phase 4: the CLI on a textured pair; returns the solve's record."""
    _, h, w = SHAPE
    f0, f1 = textured_pair(h, w)
    p0, p1 = workdir / "f0.pgm", workdir / "f1.pgm"
    image.save_grayscale(f0, str(p0))
    image.save_grayscale(f1, str(p1))
    out, bench, state = (workdir / "flow.flo", workdir / "bench.txt",
                         workdir / "state.npz")
    argv = [str(p0), str(p1), *FOTO_ARGS, f"--out={out}",
            f"--save-benchmark={bench}", f"--checkpoint={state}", "--quiet"]
    fp.launches = 0
    rc = cli.main(argv)
    launches = fp.launches
    if rc != 0:
        raise AssertionError(f"CLI exited with {rc}")
    with np.load(state) as z:
        iterations, crit = int(z["iteration"]), float(z["crit"])
    lines = dict(ln.split(": ", 1) for ln in bench.read_text().splitlines())
    ie, solve_s = float(lines["IE"]), float(lines["time"].rstrip("s"))
    g0, _, _ = image.open_grayscale(str(p0))
    g1, _, _ = image.open_grayscale(str(p1))
    ie_identity = metrics.IE(w, h, g0, g1)
    fw, fh, u, v = flo.read_flo(str(out))
    _log(f"  iterations={iterations} crit={crit:.6g} launches={launches} "
         f"solve_s={solve_s:.4f} ms_per_alg2_iteration="
         f"{1e3 * solve_s / max(iterations, 1):.4f} IE={ie:.6g} "
         f"IE_identity={ie_identity:.6g}")
    if not iterations > 0:
        raise AssertionError("no ALG2 iteration ran")
    if launches != iterations:
        raise AssertionError(f"kernel launched {launches} times in "
                             f"{iterations} ALG2 iterations")
    if not (np.isfinite(ie) and ie < ie_identity):
        raise AssertionError(f"IE {ie} not below the identity warp's "
                             f"{ie_identity}")
    if (fw, fh) != (w, h) or not (np.isfinite(u).all()
                                  and np.isfinite(v).all()):
        raise AssertionError(f".flo is {fw}x{fh} or not finite")
    return dict(iterations=iterations, crit=crit, launches=launches,
                solve_s=solve_s, ie=ie, ie_identity=ie_identity,
                rho=(g0, g1))


def card_vs_cpu(rho):
    """Phase 5: CARD_VS_CPU_ITERATIONS fixed ALG2 iterations on the card and
    on the CPU, same inputs."""
    n = CARD_VS_CPU_ITERATIONS
    runs = {}
    for dev in ("cuda", "cpu"):
        a, b = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                for x in rho)
        t0 = time.time()
        st, hist = foto.solve_potential_with_history(
            a, b, SHAPE[0], n, r=1.0, reg_epsilon=1e-2,
            admm_alpha=ADMM_ALPHA, ops=foto.stepA_ops("pallas"))
        crit = hist["crit"].cpu().double()
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


def profile_alg2(rho):
    """Phase 6: kernel time by name over PROFILE_ITERATIONS ALG2 iterations
    on the card, the device's busy share of the window's wall time, and the
    CLI's solve again, warm."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    n = PROFILE_ITERATIONS
    a, b = (torch.as_tensor(x, dtype=torch.float32, device="cuda")
            for x in rho)
    kw = dict(r=1.0, reg_epsilon=1e-2, admm_alpha=ADMM_ALPHA,
              ops=foto.stepA_ops("pallas"))
    foto.solve_potential_with_history(a, b, SHAPE[0], 2, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        foto.solve_potential_with_history(a, b, SHAPE[0], n, **kw)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.time() - t0)
    events = prof.key_averages()
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in kernels)
    _log(f"  window: {n} ALG2 iterations, wall {wall_us / 1e3:.3f} ms "
         f"({wall_us / 1e3 / n:.3f} ms each), device busy "
         f"{busy_us / 1e3:.3f} ms = {100 * busy_us / wall_us:.1f}% (idle "
         f"{100 - 100 * busy_us / wall_us:.1f}%), "
         f"{sum(e.count for e in kernels)} kernel launches")
    for e in kernels[:15]:
        _log(f"  {e.self_device_time_total / n:9.1f} us/iter "
             f"{e.count // n:4d}x  {e.key[:90]}")
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
        _log(f"  nvcc build {time.time() - t0:.2f} s -> "
             f"{_build.library_path()}")
        for ln in report.splitlines():
            if "registers" in ln or "spill" in ln:
                _log(f"  {ln.strip()}")
        _build.load_library()

    with Phase("3 kernel vs plain"):
        worst, timings = check_kernel(device, mem_bw, f32_rate)

    with Phase("4 main path"), tempfile.TemporaryDirectory() as tmp:
        solve = run_main_path(Path(tmp))

    with Phase("5 card vs cpu"):
        card_vs_cpu(solve["rho"])

    with Phase("6 profile"):
        profile_alg2(solve["rho"])

    t = timings[ADMM_ALPHA]
    record = {"kernels": [{
        "name": "fused_pointwise",
        "route": "cuda",
        "source": "ofot_tpu_torch/csrc/fused_pointwise.cu",
        "replaces": "ofot_tpu/ops/pallas/kernels.py:224",
        "launches": solve["launches"],
        "max_abs_err": worst,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
    }]}
    _log(f"chip_smoke wall {time.time() - t_start:.2f} s")
    _log(smi)
    _log(json.dumps(record))
    _log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
