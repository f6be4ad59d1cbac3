"""Coarse-to-fine (pyramid) estimation for large displacements.

Counterpart of ``ofot_tpu.solvers.pyramid`` (a framework extension with no
reference equivalent): the GN/HS solvers linearize the brightness
constraint around zero flow, so they only capture motions of a few
pixels; the pyramid solves at a coarse scale where the motion is small,
upsamples the flow, warps frame 1 toward frame 2 and solves for the
residual at the next scale.

The resize is ``jax.image.resize(..., "linear")``'s: bilinear with
half-pixel centres and a triangle filter widened by the scale when it
downsamples, which is ``F.interpolate(..., antialias=True)`` (without
``antialias`` a downsampled frame differs by up to 0.4 on a [0, 1] image).
The JAX module's ``*_jit`` entry points compile the level loop into one
XLA program; the port runs the loop eagerly and has no counterpart.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from ofot_tpu_torch.utils.warp import apply_flow


def _resize(f: torch.Tensor, shape) -> torch.Tensor:
    shape = tuple(int(n) for n in shape)
    if shape == tuple(f.shape):
        return f                           # the identity, as in JAX
    return F.interpolate(f[None, None], size=shape, mode="bilinear",
                         align_corners=False, antialias=True)[0, 0]


def _pyramid_shapes(shape, levels: int, scale: float, min_size: int):
    shapes = [tuple(shape)]
    for _ in range(levels - 1):
        ny, nx = shapes[-1]
        ny2, nx2 = int(round(ny * scale)), int(round(nx * scale))
        if min(ny2, nx2) < min_size:
            break
        shapes.append((ny2, nx2))
    return shapes                      # finest first


def solve_coarse_to_fine(f1, f2, solve_level: Callable, levels: int = 3,
                         scale: float = 0.5, min_size: int = 16):
    """Pyramid driver on the device of ``f1``/``f2``.

    ``solve_level(f1_warped, f2) -> (du, dv)`` is the per-level incremental
    solver (e.g. a lambda around ``hs.solve_fields`` or ``gn.solve_fields``).
    Returns the accumulated (u, v) at full resolution."""
    shapes = _pyramid_shapes(f1.shape, levels, scale, min_size)

    u = f1.new_zeros(shapes[-1])
    v = f1.new_zeros(shapes[-1])

    for lvl in range(len(shapes) - 1, -1, -1):     # coarsest -> finest
        shp = shapes[lvl]
        f1_l = _resize(f1, shp)
        f2_l = _resize(f2, shp)
        if tuple(u.shape) != shp:
            # upsample the flow and rescale its magnitude per axis
            u = _resize(u, shp) * (shp[1] / u.shape[1])
            v = _resize(v, shp) * (shp[0] / v.shape[0])
        f1_w = apply_flow(f1_l, u, v, None)
        du, dv = solve_level(f1_w, f2_l)
        u = u + du
        v = v + dv
    return u, v


def _level_solver(solve, cg_log, *args, **kw):
    """``(a, b) -> (u, v)`` around a GN/HS ``solve_fields``; appends each
    solve's CG result to ``cg_log`` when one is given."""
    def level(a, b):
        r = solve(a, b, *args, **kw)
        if cg_log is not None:
            cg_log.append(r.cg)
        return r.u, r.v
    return level


def solve_hs_pyramid(f1, f2, alpha=0.1, levels: int = 4, scale: float = 0.5,
                     cg_log: list | None = None, **hs_kw):
    """Pyramidal Horn–Schunck.  ``cg_log``, if given, receives each level's
    CG result (coarsest first)."""
    from ofot_tpu_torch.solvers import hs

    level = _level_solver(hs.solve_fields, cg_log, alpha, **hs_kw)
    return solve_coarse_to_fine(f1, f2, level, levels=levels, scale=scale)


def solve_gn_pyramid(f1, f2, alpha=0.1, lambda_=0.2, levels: int = 4,
                     scale: float = 0.5, cg_log: list | None = None,
                     **gn_kw):
    """Pyramidal GN: (u, v) coarse-to-fine, luminosity m solved at the
    finest level around the final warp.  ``cg_log``, if given, receives
    each level's CG result (coarsest first), then the m solve's."""
    from ofot_tpu_torch.solvers import gn

    level = _level_solver(gn.solve_fields, cg_log, alpha, lambda_, **gn_kw)
    u, v = solve_coarse_to_fine(f1, f2, level, levels=levels, scale=scale)
    r = gn.solve_fields(apply_flow(f1, u, v, None), f2, alpha, lambda_,
                        **gn_kw)
    if cg_log is not None:
        cg_log.append(r.cg)
    return u, v, r.m
