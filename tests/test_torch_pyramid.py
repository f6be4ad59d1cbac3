"""The port's coarse-to-fine solvers vs ofot_tpu.solvers.pyramid.

Tolerances:
  * ``_resize`` against ``jax.image.resize(..., "linear")``: 1e-12 at
    float64 (``F.interpolate`` with ``antialias=True`` computes the same
    triangle-filter weights);
  * the pyramid solves against JAX on ``big_shift_pair``: 1e-6 — each
    level's CG runs to rtol 1e-10 in another summation order, and the warp
    carries the flow's rounding into the next level.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from ofot_tpu.solvers import gn as jax_gn
from ofot_tpu.solvers import pyramid as jax_pyramid
from ofot_tpu_torch.solvers import hs, pyramid
from ofot_tpu_torch.utils import metrics, warp

from test_pyramid import big_shift_pair

RNG = np.random.default_rng(29)


@pytest.mark.parametrize("src,dst", [
    ((240, 320), (120, 160)), ((120, 160), (60, 80)), ((63, 81), (32, 41)),
    ((60, 80), (120, 160)), ((30, 40), (60, 80)), ((32, 41), (63, 81)),
    ((20, 24), (20, 12))])
def test_resize_matches_jax(src, dst):
    f = RNG.random(src)
    got = pyramid._resize(torch.from_numpy(f), dst)
    want = jax.image.resize(jnp.asarray(f), dst, "linear")
    assert tuple(got.shape) == dst
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)


def test_resize_to_own_shape_is_identity():
    f = torch.from_numpy(RNG.random((9, 7)))
    assert pyramid._resize(f, (9, 7)) is f


@pytest.mark.parametrize("shape,levels", [((240, 320), 4), ((20, 24), 3),
                                          ((63, 81), 5)])
def test_pyramid_shapes_match_jax(shape, levels):
    assert pyramid._pyramid_shapes(shape, levels, 0.5, 16) == \
        jax_pyramid._pyramid_shapes(shape, levels, 0.5, 16)


def test_hs_pyramid_matches_jax():
    f1, f2 = big_shift_pair()
    log = []
    u, v = pyramid.solve_hs_pyramid(torch.from_numpy(f1),
                                    torch.from_numpy(f2), alpha=0.1,
                                    levels=4, cg_log=log)
    uj, vj = jax_pyramid.solve_hs_pyramid(f1, f2, alpha=0.1, levels=4)
    np.testing.assert_allclose(u.numpy(), np.asarray(uj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(v.numpy(), np.asarray(vj), rtol=0, atol=1e-6)
    assert len(log) == 3 and all(r.converged for r in log)   # 64, 32, 16


def test_gn_pyramid_matches_jax():
    f1, f2 = big_shift_pair(48, 4)
    log = []
    u, v, m = pyramid.solve_gn_pyramid(torch.from_numpy(f1),
                                       torch.from_numpy(f2), levels=3,
                                       cg_log=log)
    uj, vj, mj = jax_pyramid.solve_gn_pyramid(f1, f2, levels=3)
    for a, b in ((u, uj), (v, vj), (m, mj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
    assert len(log) == 3 and all(r.converged for r in log)   # 48, 24, m
    # the per-level CG step counts are JAX's, within one
    jax_steps = []

    def level(a, b):
        r = jax_gn.solve_fields(a, b, 0.1, 0.2)
        jax_steps.append(int(r.cg.iterations))
        return r.u, r.v

    jax_pyramid.solve_coarse_to_fine(jnp.asarray(f1), jnp.asarray(f2), level,
                                     levels=3)
    assert all(abs(a.iterations - b) <= 1 for a, b in zip(log, jax_steps))


def _ie(f1, f2, u, v):
    rec = torch.clamp(warp.apply_flow(torch.from_numpy(f1), u, v), 0, 1)
    return metrics.IE(f1.shape[1], f1.shape[0], rec.numpy(), f2)


def test_pyramid_beats_single_level():
    f1, f2 = big_shift_pair()
    a, b = torch.from_numpy(f1), torch.from_numpy(f2)
    single = hs.solve_fields(a, b, 0.1)
    u, v = pyramid.solve_hs_pyramid(a, b, alpha=0.1, levels=4)
    ie_single = _ie(f1, f2, single.u, single.v)
    ie_pyr = _ie(f1, f2, u, v)
    assert ie_pyr < 0.5 * ie_single, (ie_single, ie_pyr)
    c = slice(28, 36)
    assert 3.0 < float(u[c, c].mean()) < 9.0
    assert 3.0 < float(v[c, c].mean()) < 9.0


def test_flow_is_rescaled_per_axis_on_upsampling():
    """A level solver that returns a flow of ones: upsampled from (8, 24)
    to (16, 48) the coarse flow doubles on both axes (plus the finest
    level's own 1); from (8, 24) to (15, 48) v is scaled by 15/8."""
    f = torch.zeros(16, 48, dtype=torch.float64)

    def level(a, b):
        return torch.ones_like(a), torch.ones_like(a)

    u, v = pyramid.solve_coarse_to_fine(f, f, level, levels=2, scale=0.5,
                                        min_size=8)
    assert torch.allclose(u, torch.full_like(u, 3.0))
    assert torch.allclose(v, torch.full_like(v, 3.0))
    u, v = pyramid.solve_coarse_to_fine(f[:15], f[:15], level, levels=2,
                                        scale=0.5, min_size=8)
    assert torch.allclose(v, torch.full_like(v, 1.0 + 15 / 8))
    assert torch.allclose(u, torch.full_like(u, 3.0))
