"""Entry hooks: one ALG2 step on a device, and a multi-rank dry run.

Counterpart of the repository's ``__graft_entry__.py``.

``entry()`` returns the forward step of the flagship model (one FOTO ALG2
iteration: CG stepA + paraboloid projection stepB + dual ascent stepC +
convergence criterion) with its example arguments on a device.  The step
is an ordinary eager callable.

``dryrun_multichip(n)`` starts a local world of n ranks
(``parallel.launch.run``) and runs on every rank the four legs of the JAX
dry run with its parameters and assertions: the tiled FOTO solve and the
GSPMD ``dct`` solve on a near-square (y, x) mesh of all n ranks, the tiled
WFR solve on the same mesh, and the data-parallel sweep (FOTO in ``map``
and ``vmap`` modes, then Sinkhorn) on a ``data`` mesh of n.  A leg that
fails its assertion fails the world (``launch.WorldError``).

Ranks run on ``cuda:{rank % cards}`` unless the CPU is asked for: NCCL
for a world of one on the card, gloo otherwise (NCCL refuses two ranks on
one device).  There is no fallback: ``cuda`` without a card raises.

Run: python -m ofot_tpu_torch.graft_entry [n] [--platform cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

NT_STEP = 8          # entry(): time steps of the ALG2 state
NT_DRYRUN = 4        # dryrun_multichip(): time steps of every leg
TILE = 8             # dryrun_multichip(): local tile edge of the spatial legs
DRYRUN_SECONDS = 600.0


def _example_pair(ny=32, nx=40, dtype=np.float32):
    y, x = np.mgrid[0:ny, 0:nx].astype(dtype)

    def blob(cy, cx):
        return np.exp(-(((y - cy) / (ny / 6)) ** 2
                        + ((x - cx) / (nx / 6)) ** 2))

    f1 = blob(ny / 2 - 2, nx / 2 - 2)
    f2 = blob(ny / 2 + 2, nx / 2 + 2)
    return f1 / f1.sum(), f2 / f2.sum()


def entry(device="cuda"):
    """(fn, example_args): one ALG2 forward step and its two float32
    frames, as tensors on ``device`` (``cuda`` without a card raises).

    ``fn(rho0, rhoT)`` runs ``foto.init_state`` with Nt = 8 and one
    ``foto.alg2_iteration`` with the default (``cg``) stepA set, CG capped
    at 50 steps, and returns (phi, crit)."""
    from ofot_tpu_torch.parallel import sweep
    from ofot_tpu_torch.solvers import foto

    device = sweep.torch_device(device)

    def step(rho0, rhoT):
        state = foto.init_state(rho0, rhoT, NT_STEP)
        state = foto.alg2_iteration(
            state, rho0, rhoT, r=1.0, reg_epsilon=1e-2,
            convergence_tol=0.01, cg_maxiter=50)
        return state.phi, state.crit

    return step, tuple(torch.as_tensor(f, device=device)
                       for f in _example_pair())


def _mesh_factors(n: int) -> tuple[int, int, int]:
    """Split n devices into (data, y, x), preferring a 2-D spatial tile."""
    if n == 1:
        return 1, 1, 1
    # spatial tile gets up to 4 devices (2x2), the rest go to data
    spatial = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    y = 2 if spatial >= 2 else 1
    x = spatial // y
    return n // spatial, y, x


def _spatial_factors(n: int) -> tuple[int, int]:
    """Split ALL n devices into a near-square (y, x) tile grid."""
    y = 1
    while (y * 2) * (y * 2) <= n * 2 and n % (y * 2) == 0:
        y *= 2
    return y, n // y


def _leg(run):
    """Run one leg -> (its result, its reading: wall seconds, the kernel
    launches in it and the device loop's statistics of it)."""
    from ofot_tpu_torch.ops import kernels
    from ofot_tpu_torch.solvers import device_loop

    kernels.reset_launch_counts()
    device_loop.reset_stats()
    t0 = time.perf_counter()
    out = run()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, {"wall_s": time.perf_counter() - t0,
                 "launches": kernels.launch_counts(),
                 "loops": dataclasses.asdict(device_loop.stats)}


def _state_reading(st) -> dict:
    return {"iterations": int(st.iteration), "crit": float(st.crit),
            "done": bool(st.done)}


def _dryrun_rank(platform: str) -> dict:
    """One rank's part of :func:`dryrun_multichip`: the four legs, each
    with JAX's parameters and assertions -> this rank's readings."""
    import torch.distributed as dist
    from ofot_tpu_torch.parallel import foto_sharded, gspmd, sweep
    from ofot_tpu_torch.parallel import wfr_sharded
    from ofot_tpu_torch.parallel.mesh import make_mesh
    from ofot_tpu_torch.solvers import foto

    n = dist.get_world_size()
    out = {}

    # 1. the tiled solver (halo stencils, all-reduced CG and criterion
    # sums), full ALG2 loop to its stopping rule, all n ranks on a
    # near-square (y, x) tile grid
    py, px = _spatial_factors(n)
    ny, nx = TILE * py, TILE * px
    mesh_yx = make_mesh({"y": py, "x": px}, platform=platform)
    a, b = _example_pair(ny, nx)
    f1, f2 = (torch.as_tensor(f, device=mesh_yx.device) for f in (a, b))
    kw = dict(r=1.0, reg_epsilon=1e-2, convergence_tol=0.05, max_it=150)
    st, out["tiled"] = _leg(lambda: foto_sharded.solve_potential_tiled(
        f1, f2, NT_DRYRUN, mesh_yx, cg_maxiter=40, **kw))
    assert st.phi.shape == (NT_DRYRUN, ny, nx)
    out["tiled"].update(_state_reading(st),
                        cg_iterations=int(st.cg_iterations))
    assert np.isfinite(out["tiled"]["crit"])
    assert bool(torch.isfinite(st.phi).all())
    # the solver's own stopping rule must fire, not the iteration budget
    assert bool(st.done), (
        f"tiled leg did not converge: crit={out['tiled']['crit']} "
        f"after {int(st.iteration)} iterations")

    # 2. the GSPMD path on the same tiling with the spectral (dct) stepA,
    # to the same convergence standard
    stg, out["gspmd"] = _leg(lambda: gspmd.solve_foto_sharded(
        f1, f2, NT_DRYRUN, mesh_yx, ops=foto.DCT_OPS, **kw))
    out["gspmd"].update(_state_reading(stg))
    assert np.isfinite(out["gspmd"]["crit"])
    assert bool(stg.done), (
        f"gspmd leg did not converge: crit={out['gspmd']['crit']} "
        f"after {int(stg.iteration)} iterations")

    # 2b. the unbalanced (WFR) tiled solver: the 4-component state on the
    # same halo machinery
    stw, out["wfr"] = _leg(lambda: wfr_sharded.solve_potential_tiled(
        f1, f2, NT_DRYRUN, mesh_yx, delta=10.0, cg_maxiter=40,
        **dict(kw, max_it=300)))
    out["wfr"].update(_state_reading(stw),
                      cg_iterations=int(stw.cg_iterations))
    crit_wfr = out["wfr"]["crit"]
    assert stw.mu.shape[0] == 4
    assert np.isfinite(crit_wfr)
    assert bool(torch.isfinite(stw.phi).all())
    # the solver's own stopping rule (crit <= tol or the stagnation
    # guard), not the iteration budget
    assert bool(stw.done) and crit_wfr < 0.2, (
        f"wfr tiled leg did not converge: crit={crit_wfr} "
        f"after {int(stw.iteration)} iterations")

    # 3. the data-parallel batched sweep, the batch axis over all n ranks
    # of a ``data`` mesh, in both batch modes, then Sinkhorn
    mesh_data = make_mesh({"data": n}, platform=platform)
    B = 2 * n
    rho0 = np.broadcast_to(a[:TILE, :TILE], (B, TILE, TILE)).copy()
    rhoT = np.broadcast_to(b[:TILE, :TILE], (B, TILE, TILE)).copy()
    fp = dict(Nt=NT_DRYRUN, r=1.0, reg_epsilon=1e-2, convergence_tol=0.05,
              max_it=4)
    (u, _, _, diag), out["map"] = _leg(lambda: sweep.solve_batch_full(
        "foto", rho0, rhoT, mesh_data, foto_params=fp, batch_mode="map"))
    assert u.shape == (B, TILE, TILE)
    assert bool(torch.isfinite(u).all())
    (uv, _, _, diagv), out["vmap"] = _leg(lambda: sweep.solve_batch_full(
        "foto", rho0, rhoT, mesh_data, foto_params=fp, batch_mode="vmap"))
    assert torch.allclose(u, uv, atol=1e-5), \
        "map/vmap batch modes disagree on the data mesh"
    for name, d in (("map", diag), ("vmap", diagv)):
        out[name].update(iterations=d["iterations"].tolist(),
                         crit=d["crit"].tolist())
    out["vmap"]["max_abs_gap"] = float((u - uv).abs().max())
    (us, _, _, sdiag), out["sinkhorn"] = _leg(
        lambda: sweep.solve_batch_full(
            "sinkhorn", rho0, rhoT, mesh_data,
            sinkhorn_params=dict(epsilon=4.0, max_iter=50, tol=1e-3)))
    assert us.shape == (B, TILE, TILE)
    assert bool(torch.isfinite(us).all())
    out["sinkhorn"].update(
        iterations=np.asarray(sdiag["iterations"]).tolist(),
        marginal_error=np.asarray(sdiag["marginal_error"]).tolist())
    out["mesh"] = {"y": py, "x": px, "data": n, "batch": B}
    return out


def dryrun_multichip(n_devices: int, platform: str = "cuda") -> dict:
    """Run the four legs on every rank of a fresh local world of
    ``n_devices`` ranks -> rank 0's readings per leg (iterations, CG steps
    where there are any, crit, ``done``, wall seconds, kernel launches and
    the device loop's statistics; the batch legs per pair), under ``"mesh"`` the meshes' sizes.

    ``platform``: ``cuda`` (each rank on ``cuda:{rank % cards}``; NCCL for
    one rank, gloo for more) or ``cpu`` (gloo).  ``cuda`` without a card
    raises; a leg that fails its assertion raises ``launch.WorldError``."""
    from ofot_tpu_torch import graft_entry
    from ofot_tpu_torch.parallel import launch
    from ofot_tpu_torch.parallel.mesh import rank_device

    rank_device(platform, 0)          # cuda without a card raises here
    cpu = platform == "cpu"
    backend = "nccl" if not cpu and n_devices == 1 else "gloo"
    # the function is named through the package, so that every rank
    # imports it by its module path
    res = launch.run(graft_entry._dryrun_rank, n_devices, platform,
                     backend=backend,
                     threads=launch.cpu_threads(n_devices) if cpu else 0,
                     seconds=DRYRUN_SECONDS)[0]
    m, t, g, w = res["mesh"], res["tiled"], res["gspmd"], res["wfr"]
    print(f"dryrun_multichip OK: tiled solve mesh(y={m['y']}, x={m['x']}) "
          f"converged crit={t['crit']:.4g} in {t['iterations']} its "
          f"(cg {t['cg_iterations']}); gspmd-dct converged crit="
          f"{g['crit']:.4g} in {g['iterations']} its; wfr tiled "
          f"converged crit={w['crit']:.4g} in {w['iterations']} its; "
          f"dp batch {m['batch']} over data={n_devices} (foto + sinkhorn)")
    return res


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        description="the multi-rank dry run of the port's solvers")
    p.add_argument("n", type=int, nargs="?", default=8,
                   help="ranks of the local world (default 8)")
    p.add_argument("--platform", choices=["cuda", "cpu"], default="cuda",
                   help="torch device of every rank (default cuda; no card "
                        "raises, there is no fallback to the CPU)")
    args = p.parse_args(argv)
    return dryrun_multichip(args.n, args.platform)


if __name__ == "__main__":
    main()
