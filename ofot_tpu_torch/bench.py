"""Benchmark: FOTO ALG2 throughput at the reference's production config, on
the port.

    python -m ofot_tpu_torch.bench [--platform cuda|cpu] [--ops auto]
                                   [--loop auto|device|host] ...

Counterpart of the JAX package's ``bench.py``, with its workload and its
contract: it prints ONE JSON line last,

  {"metric": "foto_alg2_gridpoint_iters_per_s", "value": N, "unit": ...,
   "vs_baseline": N, "device_ms_per_iter_marginal": t,
   "wall_ms_per_iter": t, ...}

Workload: the run.sh production configuration (320x240 frames, Nt=16,
reference run.sh:114) on the JAX bench's mass-normalized blob pair — a
fixed number of full ALG2 iterations (``foto.alg2_iteration`` with
``convergence_tol=0.0``: stepA, stepB, stepC, HJ criterion), float32,
best of ``--repeats``.  ``--batch B`` runs B rolled copies of the pair as
one lockstep batch (``foto.lockstep_ops``), the criterion and the CG count
reduced with a max.

Metric: space-time grid-point iterations per second = Nt*Ny*Nx*iters*B /
best wall.  Baseline: the reference CPU measurement of 0.28 s per ALG2
iteration at 64x48, Nt=8 (BASELINE.md) = 24576 / 0.28 = 87,771
grid-point-iters/s, the JAX bench's ``BASELINE_PTS_PER_S``.

The timed loop reads nothing from the device (but the ``cg`` set's CG,
which reads its residual once a block of steps), the device is
synchronized once at the end, and the criterion and the CG count are read
after the clock stops.  ``--loop device`` (the default on cuda) replays a
captured graph of K iterations (``solvers/device_loop.fori_loop``, the
counterpart of the JAX bench's ``fori_loop`` program; the ``cg`` set keeps
its ALG2 loop on the host around the captured CG), so
``wall_ms_per_iter`` is the card's rate; ``--loop host`` enqueues the
iterations from the host one after another, the port's dispatch-bound
rate of earlier runs.  The JSON line names the loop (``loop``).
``device_ms_per_iter_marginal`` is the chain marginal of the JAX bench
((t_5N - t_N) / 4N, which cancels the per-call constant).  The
family keys (``gn_ms_device``, ``wfr_ms_per_iter_device``,
``sinkhorn_us_per_iter_device``) are the same chain marginals of a GN
solve, a WFR iteration (with the primary ops set) and a Sinkhorn
iteration; ``--algo GN`` times the full GN solve instead.  The JSON line
also names the device, the resolved ops set and the ALG2 iterations run
with it (``alg2_iterations``, FOTO and WFR together), so that a reader
can hold the kernel launches against them.

The JAX bench's persistent-compile-cache lines have no counterpart (there
is no XLA compile); the kernel library's build (or load) time is printed
instead.  It needs neither JAX nor Pillow.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

# reference CPU rate, grid-point iterations / second (BASELINE.md)
BASELINE_PTS_PER_S = 24576 / 0.28


def blob_pair(ny, nx, dtype):
    y, x = np.mgrid[0:ny, 0:nx].astype(dtype)

    def blob(cy, cx):
        return np.exp(-(((y - cy) / (ny / 6)) ** 2
                        + (((x - cx) / (nx / 6)) ** 2)))

    return (blob(ny / 2 - ny / 12, nx / 2 - nx / 12),
            blob(ny / 2 + ny / 12, nx / 2 + nx / 12))


def normalized_pair(ny, nx, dtype=np.float32):
    """The bench's FOTO pair: ``blob_pair`` mass-normalized (the OT
    problem's well-posed form, reference bin/normalize_image.py
    semantics), then scaled to a peak of 1."""
    f1, f2 = blob_pair(ny, nx, dtype)
    f1 = f1 / f1.sum()
    f2 = f2 / f2.sum()
    scale = max(f1.max(), f2.max())
    return f1 / scale, f2 / scale


def textured_pair(ny, nx):
    """GN's realistic regime (smooth blobs converge in a handful of PCG
    steps): the JAX bench's textured pair moved by (2, 3) px."""
    y, x = np.mgrid[0:ny, 0:nx].astype(np.float32)
    f1 = (np.sin(x / 7.0) + np.cos(y / 5.0) + np.sin((x + y) / 11.0) + 3) / 6
    return f1, np.roll(np.roll(f1, 2, axis=0), 3, axis=1)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ny", type=int, default=240)
    p.add_argument("--nx", type=int, default=320)
    p.add_argument("--Nt", type=int, default=16)
    p.add_argument("--iters", type=int, default=200,
                   help="ALG2 iterations per timed call (the reference's "
                        "production --max-it=200, run.sh:114)")
    p.add_argument("--repeats", type=int, default=5, help="best-of-N")
    p.add_argument("--platform", choices=["cuda", "cpu"], default="cuda",
                   help="torch device (cuda without a card raises)")
    p.add_argument("--cg-rtol", type=float, default=1e-6)
    p.add_argument("--cg-maxiter", type=int, default=1000)
    p.add_argument("--algo", choices=["foto", "GN"], default="foto",
                   help="GN benchmarks the full variational solve instead")
    p.add_argument("--ops", default="auto",
                   choices=["auto", "pallas", "dct", "dct-refined",
                            "dct-fused"],
                   help="stepA/pointwise ops set to time; auto resolves "
                        "by device (pallas on cuda: the fused kernel)")
    p.add_argument("--loop", choices=["auto", "device", "host"],
                   default="auto",
                   help="device: replay captured graphs of the iterations; "
                        "host: enqueue them one by one; auto: device on "
                        "cuda, host on the cpu")
    p.add_argument("--batch", type=int, default=1,
                   help="solve B rolled copies of the pair per call, as "
                        "one lockstep batch; throughput counts all B")
    p.add_argument("--no-families", action="store_true",
                   help="skip the GN/WFR/sinkhorn chain-marginal metrics")
    p.add_argument("--with-cg", action="store_true",
                   help="also time the reference-faithful CG stepA set "
                        "(stderr only)")
    return p.parse_args(argv)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Bench:
    """One bench run: its arguments, device, pair and the ALG2 iterations
    it has run with the primary ops set."""

    def __init__(self, args):
        from ofot_tpu_torch.parallel.sweep import torch_device
        from ofot_tpu_torch.solvers import device_loop, foto

        self.args = args
        self.device = torch_device(args.platform)
        self.solver = foto.resolve_stepA_solver(args.ops, self.device)
        self.loop = device_loop.resolve(args.loop, self.device)
        self.alg2_iterations = 0
        f1, f2 = normalized_pair(args.ny, args.nx)
        if args.batch > 1:
            # B shifted copies: independent problems of one shape
            f1 = np.stack([np.roll(f1, i, axis=1) for i in range(args.batch)])
            f2 = np.stack([np.roll(f2, i, axis=1) for i in range(args.batch)])
        self.rho0 = torch.as_tensor(f1, device=self.device)
        self.rhoT = torch.as_tensor(f2, device=self.device)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def primary_ops(self):
        from ofot_tpu_torch.solvers import foto

        ops = foto.stepA_ops(self.solver)
        return foto.lockstep_ops(ops) if self.args.batch > 1 else ops

    def iterations(self, module, state, rho0, rhoT, iters, ops, **kw):
        """``iters`` fixed iterations of ``module.alg2_iteration`` from
        ``state``: replays of a captured block (``--loop device``, the sets
        whose stepA has no inner loop), else enqueued one by one (the CG
        stepA's loop on ``self.loop``)."""
        from ofot_tpu_torch.solvers import device_loop

        a = self.args
        kw = dict(kw, reg_epsilon=1e-2, convergence_tol=0.0,
                  cg_rtol=a.cg_rtol, cg_maxiter=a.cg_maxiter, ops=ops,
                  loop=self.loop)

        def step(s, p, q):
            return module.alg2_iteration(s, p, q, r=1.0, **kw)

        if self.loop == "device" and ops.spectral:
            zero = torch.zeros((), dtype=torch.int64, device=self.device)
            if not isinstance(state.iteration, torch.Tensor):
                state = state._replace(iteration=zero, cg_iterations=zero)
            return device_loop.fori_loop(
                step, state, iters, (rho0, rhoT), key=(
                    "bench", module.__name__, ops.key,
                    tuple(sorted(kw.items(), key=str))))
        for _ in range(iters):
            state = step(state, rho0, rhoT)
        return state

    def make_run(self, ops, iters, count=True):
        """``iters`` ALG2 iterations from the initial state, without a
        device read -> (crit, cg count) on the device."""
        from ofot_tpu_torch.solvers import foto

        def run():
            st = self.iterations(
                foto, foto.init_state(self.rho0, self.rhoT, self.args.Nt),
                self.rho0, self.rhoT, iters, ops)
            if count:
                self.alg2_iterations += iters
            return torch.max(st.crit), st.cg_iterations
        return run

    def time_run(self, run, repeats):
        """First call, then best of ``repeats`` walls, each ended by one
        synchronize; crit and the CG count read after the clock stops."""
        t0 = time.perf_counter()
        run()
        self.sync()
        first = time.perf_counter() - t0
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            crit, inner = run()
            self.sync()
            best = min(best, time.perf_counter() - t0)
        inner = int(torch.max(torch.as_tensor(inner)))
        return best, float(crit), inner, first

    def marginal(self, make, n, reps=3, scale=1e3):
        """Chain marginal (t_5n - t_n) / 4n of ``make(k)``'s call."""
        best = {}
        for k in (n, 5 * n):
            fn = make(k)
            t0 = time.perf_counter()
            fn()
            self.sync()
            _log(f"    first call ({k} reps) "
                 f"{time.perf_counter() - t0:.2f}s")
            b = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                self.sync()
                b = min(b, time.perf_counter() - t0)
            best[k] = b
        return (best[5 * n] - best[n]) / (4 * n) * scale


def bench_families(b: Bench) -> dict:
    """Chain-marginal estimates for the other three solver families, as the
    JAX bench's: a chained GN solve (each input perturbed by the previous
    solution), a fixed-iteration WFR iteration at the sweep's delta=2.5
    with the primary ops set, and a fixed-iteration Sinkhorn iteration at
    the frame-scale eps=100."""
    from ofot_tpu_torch.solvers import gn, sinkhorn, wfr

    args = b.args
    rho0, rhoT = (b.rho0[0], b.rhoT[0]) if args.batch > 1 else (b.rho0,
                                                                 b.rhoT)
    results = {}
    t1, t2 = (torch.as_tensor(f, device=b.device)
              for f in textured_pair(args.ny, args.nx))

    def make_gn(reps):
        def run():
            u = torch.zeros_like(t1)
            for _ in range(reps):
                u = gn.solve_fields(t1 + 1e-6 * u, t2, 0.1, 0.2,
                                    rtol=1e-7, loop=b.loop).u
            return torch.sum(u)
        return run

    # chain lengths scale with --iters, as the JAX bench's (N=4/40/400 at
    # the default 200 iterations)
    _log("  [gn chain]")
    results["gn_ms_device"] = round(
        b.marginal(make_gn, max(2, args.iters // 50)), 4)

    from ofot_tpu_torch.solvers import foto
    wops = foto.stepA_ops(b.solver)

    def make_wfr(iters):
        def run():
            st = b.iterations(wfr, wfr.init_state(rho0, rhoT, args.Nt),
                              rho0, rhoT, iters, wops, delta=2.5)
            b.alg2_iterations += iters
            return st.crit
        return run

    _log("  [wfr iters]")
    results["wfr_ms_per_iter_device"] = round(
        b.marginal(make_wfr, max(2, args.iters // 5)), 4)

    def make_sk(iters):
        def run():
            return sinkhorn.solve(rho0, rhoT, 100.0, max_iter=iters, tol=0.0,
                                  check_every=iters, verify=False,
                                  loop=b.loop).marginal_error
        return run

    _log("  [sinkhorn iters]")
    results["sinkhorn_us_per_iter_device"] = round(
        b.marginal(make_sk, max(4, args.iters * 2), scale=1e6), 3)
    return results


def bench_gn(b: Bench) -> int:
    """Full GN solve vs the reference's measured 11.85 s (1.43 s assemble
    + 10.42 s spsolve, BASELINE.md), on the textured pair."""
    from ofot_tpu_torch.solvers import gn

    args = b.args
    BASELINE_GN_S = 1.43 + 10.42
    a, c = (torch.as_tensor(f, device=b.device)
            for f in textured_pair(args.ny, args.nx))
    t0 = time.perf_counter()
    r = gn.solve_fields(a, c, 0.1, 0.2, rtol=1e-7, loop=b.loop)
    b.sync()
    _log(f"first: {time.perf_counter() - t0:.2f}s  iters "
         f"{r.cg.iterations} converged {r.cg.converged}")
    best = float("inf")
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        gn.solve_fields(a, c, 0.1, 0.2, rtol=1e-7, loop=b.loop).u.cpu()
        best = min(best, time.perf_counter() - t0)
    _log(f"best wall: {best:.4f}s")
    # the reference baseline was measured at exactly 320x240; an
    # absolute-seconds metric at another shape must not claim its speedup
    at_baseline_shape = (args.ny, args.nx) == (240, 320)
    print(json.dumps({
        "metric": f"gn_solve_seconds_{args.nx}x{args.ny}",
        "value": round(best, 4),
        "unit": "s",
        "vs_baseline": (round(BASELINE_GN_S / best, 2)
                        if at_baseline_shape else None),
        "device": _device_name(b.device), "loop": b.loop,
        "cg_iterations": int(r.cg.iterations),
    }))
    return 0


def _device_name(device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def _load_kernels(device) -> None:
    """Build (if stale) and load the kernel library, and say how long it
    took: the port's counterpart of the JAX bench's compile-cache lines."""
    if device.type != "cuda":
        _log("kernels: none on the CPU (each wrapper runs its plain version)")
        return
    from ofot_tpu_torch.ops.kernels import _build

    stale = _build.is_stale()
    t0 = time.perf_counter()
    _build.load_library()
    _log(f"kernel library: {'built' if stale else 'loaded'} in "
         f"{time.perf_counter() - t0:.2f}s ({_build.library_path()})")


def main(argv=None) -> int:
    args = parse_args(argv)
    b = Bench(args)
    _log(f"device: {_device_name(b.device)} ({b.device}); torch "
         f"{torch.__version__}")
    _load_kernels(b.device)
    if args.algo == "GN":
        return bench_gn(b)

    iters = args.iters
    primary = b.primary_ops()
    best, crit, inner, first = b.time_run(b.make_run(primary, iters),
                                          args.repeats)
    _log(f"[{b.solver}] first {first:.2f}s  best {best:.3f}s "
         f"({best / iters * 1e3:.3f} ms/iter)  crit={crit:.6f}")
    if args.with_cg:
        from ofot_tpu_torch.solvers import foto
        cg_ops = foto.DEFAULT_OPS
        if args.batch > 1:
            cg_ops = foto.lockstep_ops(cg_ops)
        best_cg, crit_cg, inner_cg, first_cg = b.time_run(
            b.make_run(cg_ops, iters, count=False), args.repeats)
        _log(f"[cg ] first {first_cg:.2f}s  best {best_cg:.3f}s "
             f"({best_cg / iters * 1e3:.3f} ms/iter)  crit={crit_cg:.6f}"
             f"  cg_iters={inner_cg}")

    # the chain marginal: the same run at 5x the iterations cancels the
    # per-call constant; the long arm needs fewer repeats
    best5, _, _, _ = b.time_run(b.make_run(primary, 5 * iters),
                                max(2, args.repeats // 2))
    marginal_ms = (best5 - best) / (4 * iters) * 1e3
    _log(f"[{b.solver}] 5x-iters best {best5:.3f}s -> marginal "
         f"{marginal_ms:.4f} ms/iter (raw {best / iters * 1e3:.4f})")

    pts = args.Nt * args.ny * args.nx * iters * args.batch
    rate = pts / best
    out = {
        "metric": "foto_alg2_gridpoint_iters_per_s",
        "value": round(rate, 1),
        "unit": "grid-point-iterations/s",
        "vs_baseline": round(rate / BASELINE_PTS_PER_S, 2),
        "device_ms_per_iter_marginal": round(marginal_ms, 4),
        "wall_ms_per_iter": round(best / iters * 1e3, 4),
    }
    if not args.no_families:
        try:
            out.update(bench_families(b))
        except Exception as e:    # the primary line must survive; the
            # key says the families failed (chip_smoke.py fails on it)
            _log(f"bench_families failed: {type(e).__name__}: {e}")
            out["families_error"] = f"{type(e).__name__}: {e}"
    out.update({"device": _device_name(b.device), "loop": b.loop,
                "ops": b.solver,
                "batch": args.batch, "crit": crit, "cg_iterations": inner,
                "alg2_iterations": b.alg2_iterations})
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
