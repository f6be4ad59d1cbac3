"""Cases of the distribution layer, run on every rank of a local world.

The tests (on the CPU, over gloo) and ``chip_smoke.py`` (on the card) hold
the tiled and data-parallel solves against whole solves by running
:func:`run_cases` on every rank of a world started by ``launch.run``: one
world serves many cases, each on a mesh of its own shape.  Rank 0
returns every case's result as numpy arrays, and every other rank the
:func:`digest` of its own, so that the caller can check that the ranks
agree bitwise without moving every rank's arrays; each rank adds the
case's wall seconds under ``"<name>_s"``, its kernel launches in it under
``"<name>_launches"``, and the Unix time at which it began its cases
under ``"started"`` (so that the caller can tell process start-up from
the cases).
"""

from __future__ import annotations

import hashlib
import time

import numpy as np
import torch
import torch.distributed as dist

from ofot_tpu_torch.ops import kernels
from ofot_tpu_torch.parallel import foto_sharded, gn_sharded, gspmd, halo
from ofot_tpu_torch.parallel import sweep, wfr_sharded
from ofot_tpu_torch.parallel.halo import Tiled
from ofot_tpu_torch.parallel.mesh import make_mesh
from ofot_tpu_torch.solvers import foto


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def state_arrays(st) -> dict:
    """A FotoState (or GNResult) as a dict of numpy arrays."""
    if hasattr(st, "cg"):
        return {"u": _np(st.u), "v": _np(st.v), "m": _np(st.m),
                "iterations": _np(st.cg.iterations),
                "residual": _np(st.cg.residual)}
    return {k: _np(v) for k, v in st._asdict().items()}


def stencils(mesh, phi, mu, x):
    """The halo stencils and the all-reduced sum, gathered whole."""
    sops = Tiled(mesh)
    t = mesh.tile
    return {"laplacian_st": _np(mesh.gather(sops.laplacian_st(t(phi)))),
            "grad_st": _np(mesh.gather(sops.grad_st(t(phi)))),
            "div_st": _np(mesh.gather(sops.div_st(t(mu)))),
            "sum": float(sops.sum(t(x) * t(x)))}


def foto_tiled(mesh, f1, f2, Nt, **kw):
    return state_arrays(foto_sharded.solve_potential_tiled(f1, f2, Nt, mesh,
                                                           **kw))


def wfr_tiled(mesh, f1, f2, Nt, **kw):
    return state_arrays(wfr_sharded.solve_potential_tiled(f1, f2, Nt, mesh,
                                                          **kw))


def gn_tiled(mesh, f1, f2, **kw):
    return state_arrays(gn_sharded.solve_fields_tiled(f1, f2, mesh, **kw))


def foto_gspmd(mesh, f1, f2, Nt, ops="cg", **kw):
    return state_arrays(gspmd.solve_foto_sharded(
        f1, f2, Nt, mesh, ops=foto.stepA_ops(ops), **kw))


def wfr_gspmd(mesh, f1, f2, Nt, ops="dct", **kw):
    return state_arrays(gspmd.solve_wfr_sharded(
        f1, f2, Nt, mesh, ops=foto.stepA_ops(ops), **kw))


def gn_gspmd(mesh, f1, f2, **kw):
    return state_arrays(gspmd.solve_gn_sharded(f1, f2, mesh, **kw))


def refusals(mesh, shape=(7, 8)):
    """The message of each tiled solve's refusal of ``shape`` frames."""
    z = np.zeros(shape)
    out = {}
    for name, call in (
            ("foto", lambda: foto_sharded.solve_potential_tiled(z, z, 4,
                                                                mesh)),
            ("wfr", lambda: wfr_sharded.solve_potential_tiled(z, z, 4,
                                                              mesh)),
            ("gn", lambda: gn_sharded.solve_fields_tiled(z, z, mesh))):
        try:
            call()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def edge_lines(mesh, field):
    """Each side's lines from ``halo.edge_lines`` on every rank's tile of
    ``field`` (Nt, Ny, Nx) beside the edge lines of ``_halo_shifts``'
    shifted tiles, each gathered over the plane (a row side as (Nt, py,
    Nx), a column side as (Nt, Ny, px); zeros where a side has no line),
    and which ranks had no line, as a (py, px) 0/1 field a side."""
    f = mesh.tile(field)
    lines = halo.edge_lines(f, mesh)
    y, x = (halo._halo_shifts(f, (-1, 1), axis, mesh, name)
            for axis, name in ((-2, "y"), (-1, "x")))
    shifts = {"up": y[0][..., :1, :], "down": y[1][..., -1:, :],
              "left": x[0][..., :1], "right": x[1][..., -1:]}
    out = {}
    for side, line in zip(("up", "down", "left", "right"), lines):
        like = shifts[side]
        got = torch.zeros_like(like) if line is None \
            else line.view(like.shape)
        out[side] = _np(mesh.gather(got))
        out[f"{side}_shift"] = _np(mesh.gather(like))
        out[f"{side}_none"] = _np(mesh.gather(torch.full(
            (1, 1), float(line is None), device=mesh.device)))
    return out


def checkpoint(mesh, path, f1, f2, Nt, **kw):
    """A tiled FOTO state saved by every rank, each its own tiles
    (``torch.distributed.checkpoint``), and restored onto the mesh."""
    from ofot_tpu_torch.utils import checkpoint as ckpt

    st = foto_sharded.solve_potential_tiled(f1, f2, Nt, mesh, **kw)
    tiles = st._replace(mu=mesh.tile(st.mu), q=mesh.tile(st.q),
                        phi=mesh.tile(st.phi))
    ckpt.save_state_dcp(path, tiles, mesh)
    back = ckpt.load_state_dcp(path, mesh=mesh)
    return {"saved": state_arrays(st),
            "restored": state_arrays(gspmd.gather_state(back, mesh))}


def foto_batch(mesh, r0, rT, Nt, **kw):
    return state_arrays(sweep.solve_foto_batch(r0, rT, Nt, mesh, **kw))


def gn_batch(mesh, f1s, f2s, **kw):
    return state_arrays(sweep.solve_gn_batch(f1s, f2s, mesh, **kw))


def sweep_foto(mesh, pairs, Nt, **kw):
    out = sweep.sweep_foto(pairs, Nt, mesh, **kw)
    return {k: state_arrays(v) for k, v in out.items()}


def batch_full(mesh, algo, f1s, f2s, **kw):
    u, v, m, diag = sweep.solve_batch_full(algo, f1s, f2s, mesh, **kw)
    return {"u": _np(u), "v": _np(v), "m": _np(m), "diag": diag}


def digest(result):
    """``result`` with each array (or number) replaced by its dtype, shape
    and the SHA-256 of its bytes: equal digests, bitwise-equal results."""
    if isinstance(result, dict):
        return {k: digest(v) for k, v in result.items()}
    a = np.ascontiguousarray(result)
    return (str(a.dtype), a.shape, hashlib.sha256(a.tobytes()).hexdigest())


def run_cases(cases, platform="cuda"):
    """Run ``cases`` — (name, mesh shape, function name in this module,
    keyword arguments) — on this rank, each on a mesh of its shape (made
    once per shape, in the same order on every rank), on ``platform``'s
    device (``cuda``, or ``cpu`` when asked for).  A rank outside a case's
    mesh records None for it."""
    meshes = {}
    out = {"started": time.time()}
    for name, shape, fn, kw in cases:
        key = tuple(shape.items())
        if key not in meshes:
            meshes[key] = make_mesh(shape, platform=platform)
        mesh = meshes[key]
        if mesh.coord is None:
            out[name] = None
            continue
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = globals()[fn](mesh, **kw)
        out[name] = res if dist.get_rank() == 0 else digest(res)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        out[f"{name}_s"] = time.perf_counter() - t0
        out[f"{name}_launches"] = kernels.launch_counts()
    return out
