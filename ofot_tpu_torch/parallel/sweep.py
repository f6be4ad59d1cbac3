"""Sequence sweeps: many frame pairs solved by one call.

Counterpart of ``ofot_tpu.parallel.sweep``.  The JAX package lifts a
per-pair solve to a batch with ``lax.map`` (pairs one after another inside
one jitted program) or ``vmap`` (one lockstep program), optionally with
the batch axis sharded over a ``data`` mesh.  The port's solvers are host
loops that read their stopping rule once per iteration, so:

  * ``map`` is a Python loop over the pairs on one device: each pair goes
    through the same functions, in the same order, as the CLI's solve
    (``ofot_tpu_torch.cli.main``), and its results equal the single-pair
    solve's bitwise;
  * ``vmap`` runs the lockstep solvers (``foto``/``wfr``
    ``solve_potential_batched``, and ``gn.solve_fields`` and
    ``sinkhorn.flow`` on (B, Ny, Nx) stacks): one loop for the whole
    batch, each kernel launched once per step for all pairs, each pair
    stopping on its own rule; the flow extraction then runs pair by pair.
    ``solve_foto_batch``, ``solve_gn_batch`` and ``sweep_foto`` are
    lockstep, as JAX's are.

With a mesh (``parallel/mesh.py``), the batch axis is block-split over the
``data`` axis: every rank of the mesh calls the function with the whole
batch (padded to a multiple of the ``data`` size with ``_pad_batch``),
solves its own contiguous block on its own device, and every rank gets the
gathered results, as JAX's ``shard_map`` over ``data`` returns them.
Ranks on the same ``data`` index solve the same block.  ``DataParallel``
runs such a mesh from one process: it starts the other ranks, which serve
its batches (``run --batch --data-parallel N``).  On one card, a world of
more than one rank shares ``cuda:0`` over gloo, staging through host
memory (NCCL refuses two ranks on one device).

Middlebury sequences come in a handful of distinct resolutions; padding a
pair would change the PDE domain, so heterogeneous inputs are *grouped by
shape* (``group_by_shape``) and each group is solved as one batch.
"""

from __future__ import annotations

import tempfile
from collections import defaultdict
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from ofot_tpu_torch.parallel import launch, multihost
from ofot_tpu_torch.parallel.mesh import make_mesh, rank_device
from ofot_tpu_torch.solvers import flow_extract, foto, gn, lockstep, wfr
from ofot_tpu_torch.solvers.cg import CGResult
from ofot_tpu_torch.utils import trace


def group_by_shape(pairs):
    """[(key, f1, f2), ...] -> {shape: [(key, f1, f2), ...]}."""
    groups = defaultdict(list)
    for key, f1, f2 in pairs:
        groups[tuple(np.shape(f1))].append((key, f1, f2))
    return dict(groups)


def _pad_batch(arr: np.ndarray, multiple: int) -> tuple[np.ndarray, int]:
    n = arr.shape[0]
    rem = (-n) % multiple
    if rem:
        arr = np.concatenate([arr, np.repeat(arr[-1:], rem, axis=0)])
    return arr, n


def torch_device(name) -> torch.device:
    """The torch device a sweep runs on; ``cuda`` without a card raises
    instead of falling back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} but torch sees no CUDA device; "
                           "ask for the CPU (--platform=cpu, device='cpu') "
                           "to run there")
    return device


def _check_mode(batch_mode: str) -> None:
    if batch_mode not in ("map", "vmap"):
        raise ValueError(f"unknown batch_mode {batch_mode!r} "
                         "(expected 'vmap' or 'map')")


def _block(mesh, *stacks):
    """This rank's contiguous block of each (B, ...) stack: the batch is
    split over the mesh's ``data`` axis (B must divide)."""
    dp = mesh.size("data")
    b = len(stacks[0])
    if b % dp:
        raise ValueError(f"batch of {b} pairs not divisible by data={dp} "
                         "(pad with _pad_batch first)")
    k, i = b // dp, mesh.index("data")
    return [x[i * k:(i + 1) * k] for x in stacks]


def _gather_blocks(mesh, t: torch.Tensor) -> torch.Tensor:
    """The (B, ...) stack whose blocks the ranks of this rank's ``data``
    line hold."""
    if "data" not in mesh.names:
        return t
    return torch.cat(mesh.all_gather(t, mesh.group("data")))


def _gather_diag(mesh, diag: dict) -> dict:
    """Per-pair numpy diagnostics gathered over the ``data`` line."""
    if "data" not in mesh.names:
        return diag
    parts = [None] * mesh.size("data")
    dist.all_gather_object(parts, diag, group=mesh.group("data"))
    return {k: np.concatenate([p[k] for p in parts]) for k in diag}


def _map_pairs(one, f1s, f2s):
    """``one(f1, f2) -> (u, v, m, diag)`` over the batch, pair by pair ->
    stacked (u, v, m) and each diagnostic as a (B,) numpy array."""
    outs = [one(a, b) for a, b in zip(f1s, f2s)]
    u, v, m = (torch.stack([o[i] for o in outs]) for i in range(3))
    diag = {k: np.asarray([o[3][k] for o in outs]) for k in outs[0][3]}
    return u, v, m, diag


def _flows(phi):
    """Flow extraction of a (B, Nt, Ny, Nx) potential, one call for the
    batch -> (u, v, m), each (B, Ny, Nx).  Span ``lockstep.extract``."""
    with trace.annotate("lockstep.extract"):
        return flow_extract.flow_from_potential(phi)


def _diag(**fields):
    """(B,) per-pair diagnostics as numpy arrays."""
    return {k: v.cpu().numpy() for k, v in fields.items()}


def _lockstep_full(algo, f1s, f2s, fp, wp, sp, gp):
    """``solve_batch_full``'s lockstep (vmap) mode on resolved params."""
    if algo == "foto":
        Nt = fp.pop("Nt")
        st = foto.solve_potential_batched(f1s, f2s, Nt, **fp)
        u, v, m = _flows(st.phi)
        return u, v, m, _diag(iterations=st.iteration,
                              inner_iterations=st.cg_iterations,
                              crit=st.crit)
    if algo == "WFR":
        Nt = wp.pop("Nt")
        st = wfr.solve_potential_batched(f1s, f2s, Nt, **wp)
        u, v, m = _flows(st.phi)
        g = torch.stack([wfr.growth_from_state(lockstep.pair(st, i),
                                               wp["delta"])
                         for i in range(len(f1s))])
        return u, v, wfr.combined_luminosity(m, g), _diag(
            iterations=st.iteration, crit=st.crit)
    if algo == "sinkhorn":
        from ofot_tpu_torch.ops import operators
        from ofot_tpu_torch.solvers import sinkhorn
        res = sinkhorn.flow(f1s, f2s, **sp)
        m = -operators.div2d(res.u, res.v, bc="D")
        return res.u, res.v, m, _diag(iterations=res.iterations,
                                      marginal_error=res.marginal_error)
    res = gn.solve_fields(f1s, f2s, **gp)
    return res.u, res.v, res.m, _diag(inner_iterations=res.cg.iterations,
                                      converged=res.cg.converged)


def _resolve(algo: str, solver: str, device) -> str:
    """FOTO's or WFR's stepA solver name resolved for ``device``."""
    module = foto if algo == "foto" else wfr
    return module.resolve_stepA_solver(solver, device)


# stepA sets that run a float32-only CUDA kernel on cuda
_FLOAT32_KERNEL_SETS = ("pallas", "dct-fused", "cg-pallas")


def check_kernel_dtype(algo: str, params: dict | None, device,
                       dtype) -> None:
    """Raise ``ValueError`` when ``algo``'s stepA set, resolved for
    ``device``, runs a float32-only CUDA kernel and ``dtype`` is float64
    (refused before the batch moves to the device, not inside the
    kernel).  ``solve_batch_full`` checks its own batch; a caller with
    several algos checks them all before any solve runs."""
    if algo not in ("foto", "WFR"):
        return
    solver = _resolve(algo, (params or {}).get("stepA_solver", "auto"),
                      device)
    if (solver in _FLOAT32_KERNEL_SETS and torch.device(device).type == "cuda"
            and dtype == torch.float64):
        raise ValueError(f"the {solver} stepA set of {algo} runs a CUDA "
                         "kernel that is float32 only")


def _resolved_ops(algo: str, params: dict, device):
    """Resolve ``params``' stepA solver for ``device`` (popping it) -> a
    fresh ops set."""
    return foto.stepA_ops(_resolve(algo, params.pop("stepA_solver", "auto"),
                                   device))


def solve_batch_full(algo: str, f1s, f2s, mesh=None,
                     foto_params: dict | None = None,
                     gn_params: dict | None = None,
                     wfr_params: dict | None = None,
                     sinkhorn_params: dict | None = None,
                     batch_mode: str = "map", *, device="cuda"):
    """Batched end-to-end solve of (B, Ny, Nx) frame stacks on ``device``
    -> stacked (u, v, m) tensors plus per-pair diagnostics, as (B,) numpy
    arrays.  ``batch_mode``: ``map`` (pair after pair, bitwise the
    single-pair solves) or ``vmap`` (the lockstep batch).

    ``auto`` stepA solvers resolve by device (``pallas`` on cuda, which
    launches the fused kernel once per ALG2 iteration), as the port's CLI
    resolves them.  Diagnostics: foto ``iterations``, ``inner_iterations``,
    ``crit``; WFR ``iterations``, ``crit`` (luminosity slot = growth
    composed with the dilution correction); sinkhorn ``iterations``,
    ``marginal_error`` (m = -div(u, v), 'D' boundary); GN
    ``inner_iterations``, ``converged``.

    With a ``mesh``: collective, every rank with the whole (padded) batch;
    each solves its ``data`` block on the mesh's device (``device`` is not
    read) and returns the whole batch's results.  Span ``sweep.batch``."""
    with trace.annotate("sweep.batch"):
        _check_mode(batch_mode)
        if mesh is not None:
            b1, b2 = _block(mesh, np.asarray(f1s), np.asarray(f2s))
            u, v, m, diag = solve_batch_full(
                algo, b1, b2, None, foto_params, gn_params, wfr_params,
                sinkhorn_params, batch_mode, device=mesh.device)
            return (*(_gather_blocks(mesh, t) for t in (u, v, m)),
                    _gather_diag(mesh, diag))
        if algo not in ("foto", "WFR", "sinkhorn", "GN"):
            # every algo must dispatch explicitly — an unknown name silently
            # falling through to GN would write wrong flows into <algo>.flo
            raise ValueError(f"unknown batch algo {algo!r} "
                             "(expected foto, GN, WFR, or sinkhorn)")
        sp = dict(sinkhorn_params or {})
        if algo == "sinkhorn":
            th = sp.get("theta")
            if th is not None and not 0.0 < float(th) < 2.0:
                raise ValueError(f"sinkhorn theta={th} outside the "
                                 "convergent range (0, 2)")
            stab = sp.get("stabilizer")
            if stab is not None and stab not in ("matmul", "exact"):
                # 'auto' is a CLI-level retry policy, not a solver mode —
                # in batch mode the pipeline's escalation IS the auto path
                raise ValueError(f"batch sinkhorn stabilizer={stab!r} must "
                                 "be 'matmul' or 'exact' (the pipeline's "
                                 "per-sequence escalation provides 'auto')")
        dev = torch_device(device)
        f1s = torch.as_tensor(f1s)
        check_kernel_dtype(algo, foto_params if algo == "foto" else wfr_params,
                           dev, f1s.dtype)
        f1s = f1s.to(dev)
        f2s = torch.as_tensor(f2s, device=dev)

        fp = dict(foto_params or {})
        wp = dict(wfr_params or {})
        gp = dict(gn_params or {})
        if algo == "foto":
            fp.setdefault("Nt", 16)
            fp["ops"] = _resolved_ops("foto", fp, dev)
        elif algo == "WFR":
            # resolve delta ONCE so the solve and the growth extraction can
            # never drift apart on the default
            wp.setdefault("delta", 10.0)
            wp.setdefault("Nt", 16)
            wp["ops"] = _resolved_ops("WFR", wp, dev)
        if batch_mode == "vmap":
            return _lockstep_full(algo, f1s, f2s, fp, wp, sp, gp)

        if algo == "foto":
            Nt = fp.pop("Nt")

            def one(p, q):
                st = foto.solve_potential(p, q, Nt, **fp)
                u, v, m = flow_extract.flow_from_potential(st.phi)
                return u, v, m, {"iterations": st.iteration,
                                 "inner_iterations": st.cg_iterations,
                                 "crit": float(st.crit)}
        elif algo == "WFR":
            Nt = wp.pop("Nt")

            def one(p, q):
                st = wfr.solve_potential(p, q, Nt, **wp)
                u, v, m = flow_extract.flow_from_potential(st.phi)
                g = wfr.growth_from_state(st, wp["delta"])
                return u, v, wfr.combined_luminosity(m, g), {
                    "iterations": st.iteration, "crit": float(st.crit)}
        elif algo == "sinkhorn":
            from ofot_tpu_torch.ops import operators
            from ofot_tpu_torch.solvers import sinkhorn

            def one(p, q):
                res = sinkhorn.flow(p, q, **sp)
                m = -operators.div2d(res.u, res.v, bc="D")
                return res.u, res.v, m, {
                    "iterations": res.iterations,
                    "marginal_error": float(res.marginal_error)}
        else:
            def one(p, q):
                res = gn.solve_fields(p, q, **gp)
                return res.u, res.v, res.m, {
                    "inner_iterations": res.cg.iterations,
                    "converged": res.cg.converged}
        return _map_pairs(one, f1s, f2s)


def solve_foto_batch(rho0s, rhoTs, Nt: int, mesh=None, *, device="cuda",
                     **kw):
    """Batched FOTO: rho0s/rhoTs are (B, Ny, Nx).  Returns a FotoState
    with a leading batch axis and (B,) counters, the pairs solved in
    lockstep (``foto.solve_potential_batched``).  With a mesh, each rank
    solves its ``data`` block in lockstep on the mesh's device and every
    rank gets the whole batch's state."""
    if mesh is not None:
        b0, bT = _block(mesh, torch.as_tensor(rho0s), torch.as_tensor(rhoTs))
        st = solve_foto_batch(b0, bT, Nt, device=mesh.device, **kw)
        return foto.FotoState(*(_gather_blocks(mesh, t) for t in st))
    dev = torch_device(device)
    return foto.solve_potential_batched(
        torch.as_tensor(rho0s, device=dev),
        torch.as_tensor(rhoTs, device=dev), Nt, **kw)


def solve_gn_batch(f1s, f2s, mesh=None, alpha=0.1, lambda_=0.2, *,
                   device="cuda", **kw):
    """Batched GN: (B, Ny, Nx) frame stacks -> batched GNResult, the pairs
    solved in lockstep (with a mesh, by ``data`` block, as
    ``solve_foto_batch``)."""
    if mesh is not None:
        b1, b2 = _block(mesh, torch.as_tensor(f1s), torch.as_tensor(f2s))
        res = solve_gn_batch(b1, b2, None, alpha, lambda_,
                             device=mesh.device, **kw)
        u, v, m = (_gather_blocks(mesh, t) for t in res[:3])
        return gn.GNResult(u=u, v=v, m=m, cg=CGResult(
            *(_gather_blocks(mesh, t) for t in res.cg)))
    dev = torch_device(device)
    return gn.solve_fields(torch.as_tensor(f1s, device=dev),
                           torch.as_tensor(f2s, device=dev), alpha, lambda_,
                           **kw)


def sweep_foto(pairs, Nt: int, mesh=None, *, device="cuda", **kw):
    """Full heterogeneous sweep: group by shape, batch-solve each group,
    return {key: FotoState-slice} in the input order of each group.  With
    a mesh, each group is padded to a multiple of the ``data`` size (the
    duplicates dropped on the way out)."""
    results = {}
    dp = mesh.size("data") if mesh is not None else 1
    for shape, group in group_by_shape(pairs).items():
        keys = [k for k, _, _ in group]
        r0, n = _pad_batch(np.stack([np.asarray(f1) for _, f1, _ in group]),
                           dp)
        rT, _ = _pad_batch(np.stack([np.asarray(f2) for _, _, f2 in group]),
                           dp)
        states = solve_foto_batch(r0, rT, Nt, mesh, device=device, **kw)
        for i, key in enumerate(keys[:n]):
            results[key] = lockstep.pair(states, i)
    return results


# the longest a rank of a DataParallel world waits for another: rank 0 does
# a group's warps and writes (and any Sinkhorn escalation) between batches
DATA_PARALLEL_TIMEOUT = timedelta(minutes=30)


def _serve(platform: str) -> None:
    """Ranks 1.. of a ``DataParallel`` world: solve the blocks of every
    batch rank 0 broadcasts, until it broadcasts None."""
    mesh = make_mesh({"data": dist.get_world_size()}, platform=platform,
                     timeout=DATA_PARALLEL_TIMEOUT)
    while True:
        req = [None]
        dist.broadcast_object_list(req, src=0)
        if req[0] is None:
            return
        algo, f1s, f2s, kw = req[0]
        solve_batch_full(algo, f1s, f2s, mesh, **kw)


class DataParallel:
    """A ``data`` mesh of ``n`` ranks run from this process, rank 0: the
    other ``n - 1`` ranks are started here and serve :meth:`solve`'s
    batches; :meth:`close` (or leaving the ``with`` block) stops and joins
    them.  ``platform``: each rank's device, ``cuda:{rank % cards}`` or
    the CPU.  A rank that fails or outlives the timeouts fails the run:
    the next collective, or :meth:`close`, raises."""

    def __init__(self, n: int, platform: str = "cuda"):
        rank_device(platform, 0)        # no card: refuse before starting
        if dist.is_initialized():
            raise RuntimeError("this process is in a process group "
                               "already")
        self.n = n
        self._tmp = tempfile.TemporaryDirectory()
        init = launch.rendezvous(self._tmp.name)
        # one card holds every rank here: NCCL refuses two ranks on one
        # device, so gloo unless each rank has a card of its own
        backend = multihost.default_backend(n)
        threads = launch.cpu_threads(n) if platform == "cpu" else 0
        self._threads = torch.get_num_threads()
        self.procs = launch.start(_serve, n, init, platform, backend=backend,
                                  threads=threads,
                                  timeout=DATA_PARALLEL_TIMEOUT)
        try:
            if threads:
                torch.set_num_threads(threads)
            multihost.initialize(init_method=init, num_processes=n,
                                 process_id=0, backend=backend,
                                 timeout=DATA_PARALLEL_TIMEOUT)
            self.mesh = make_mesh({"data": n}, platform=platform,
                                  timeout=DATA_PARALLEL_TIMEOUT)
        except BaseException:
            self._abort()
            raise

    def solve(self, algo, f1s, f2s, **kw):
        """``solve_batch_full(algo, f1s, f2s, mesh, **kw)`` over the world:
        (B, Ny, Nx) stacks, B a multiple of ``n``."""
        f1s, f2s = np.asarray(f1s), np.asarray(f2s)
        dist.broadcast_object_list([(algo, f1s, f2s, kw)], src=0)
        return solve_batch_full(algo, f1s, f2s, self.mesh, **kw)

    def _abort(self) -> None:
        """Kill the ranks still running and leave the world."""
        for p in self.procs:
            if p.is_alive():
                p.kill()
        if dist.is_initialized():
            dist.destroy_process_group()
        torch.set_num_threads(self._threads)
        self._tmp.cleanup()

    def close(self) -> None:
        """Stop the serving ranks and join them (``WorldError`` if one
        failed)."""
        try:
            dist.broadcast_object_list([None], src=0)
            launch.join(self.procs, 60.0)
        finally:
            self._abort()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:
            self._abort()
