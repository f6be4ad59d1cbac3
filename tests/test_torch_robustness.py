"""Robustness of the port against the JAX package on the same inputs:
the cases of tests/test_robustness.py (float32 against float64, identical
and black frames, a NaN flow through the warp, every EE pixel an outlier),
each run through both packages on the CPU.

Tolerances: the float64 solves are the same iteration in both packages
(atol 1e-8, tests/test_parallel.py's whole-solve bound); the warp is the
same gathers and weights (atol 1e-12, tests/test_torch_solvers.py's), and
where JAX's result is NaN the port's must be NaN at the same pixels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofot_tpu.solvers import foto as jax_foto
from ofot_tpu.solvers import gn as jax_gn
from ofot_tpu.utils import metrics as jax_metrics
from ofot_tpu.utils import warp as jax_warp
from ofot_tpu_torch.solvers import foto, gn
from ofot_tpu_torch.utils import metrics, warp

import fixtures

RNG = np.random.default_rng(41)


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _close(got, want, atol=1e-8):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=atol)


def test_foto_fp32_close_to_fp64():
    f1, f2 = fixtures.translating_square(20)
    kw = dict(r=1.0, convergence_tol=0.1, reg_epsilon=1e-2, max_it=10)
    r64 = foto.solve(_t(f1), _t(f2), 4, **kw)
    r32 = foto.solve(_t(f1, torch.float32), _t(f2, torch.float32), 4, **kw)
    aepe = torch.sqrt((r32.u.double() - r64.u) ** 2
                      + (r32.v.double() - r64.v) ** 2).mean().item()
    assert aepe < 0.01, aepe
    j64 = jax_foto.solve(jnp.asarray(f1), jnp.asarray(f2), 4, **kw)
    assert r64.state.iteration == int(j64.state.iteration)
    _close(r64.u, j64.u)
    _close(r64.v, j64.v)


def test_foto_identical_frames():
    """No mass to move -> ~zero flow, solver stops early."""
    f1, _ = fixtures.smooth_blob_pair(16, 18)
    kw = dict(r=1.0, convergence_tol=0.05, reg_epsilon=1e-2, max_it=30)
    res = foto.solve(_t(f1), _t(f1), 4, **kw)
    assert res.u.abs().max().item() < 0.2
    assert torch.isfinite(res.u).all()
    want = jax_foto.solve(jnp.asarray(f1), jnp.asarray(f1), 4, **kw)
    assert res.state.iteration == int(want.state.iteration)
    _close(res.u, want.u)


def test_gn_identical_frames():
    f1, _ = fixtures.smooth_blob_pair(16, 18)
    r = gn.solve_fields(_t(f1), _t(f1))
    assert r.u.abs().max().item() < 1e-6
    assert r.m.abs().max().item() < 1e-6
    want = jax_gn.solve_fields(jnp.asarray(f1), jnp.asarray(f1))
    assert r.cg.iterations == int(want.cg.iterations)
    _close(r.u, want.u)
    _close(r.m, want.m)


def test_foto_black_frames():
    """All-zero densities: criterion hits 0/eps — must not NaN-loop."""
    z = np.zeros((12, 14))
    kw = dict(r=1.0, convergence_tol=0.1, reg_epsilon=1e-2, max_it=20)
    st = foto.solve_potential(_t(z), _t(z), 4, **kw)
    assert st.iteration <= 20
    assert torch.isfinite(st.phi).all()
    want = jax_foto.solve_potential(jnp.asarray(z), jnp.asarray(z), 4, **kw)
    assert st.iteration == int(want.iteration)
    _close(st.phi, want.phi)


def _warp_both(f1, u, v, m=None):
    got = warp.apply_flow(_t(f1), _t(u), _t(v),
                          None if m is None else _t(m)).numpy()
    want = np.asarray(jax_warp.apply_flow(
        jnp.asarray(f1), jnp.asarray(u), jnp.asarray(v),
        None if m is None else jnp.asarray(m)))
    return got, want


def _assert_warp_matches(got, want):
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    _close(got[~np.isnan(got)], want[~np.isnan(want)], atol=1e-12)


def test_warp_with_nan_flow_does_not_crash():
    """tests/test_robustness.py's input: an all-NaN flow gives JAX's NaN
    image (no out-of-range gather)."""
    f1, _ = fixtures.smooth_blob_pair(8, 8)
    u = np.full((8, 8), np.nan)
    got, want = _warp_both(f1, u, u)
    assert np.isnan(want).all()
    _assert_warp_matches(got, want)


@pytest.mark.parametrize("with_m", [False, True])
def test_warp_with_partly_nan_flow(with_m):
    h, w = 11, 14
    f1 = RNG.random((h, w))
    u = RNG.uniform(-3, 3, (h, w))
    v = RNG.uniform(-3, 3, (h, w))
    u[RNG.random((h, w)) < 0.2] = np.nan
    v[RNG.random((h, w)) < 0.2] = np.nan
    m = RNG.uniform(-0.5, 0.5, (h, w)) if with_m else None
    got, want = _warp_both(f1, u, v, m)
    assert np.isnan(want).any() and not np.isnan(want).all()
    _assert_warp_matches(got, want)


def test_warp_with_infinite_flow():
    h, w = 9, 10
    f1 = RNG.random((h, w))
    u = RNG.uniform(-2, 2, (h, w))
    v = RNG.uniform(-2, 2, (h, w))
    u[0, :5], u[3, 2:6] = np.inf, -np.inf
    v[5, :3], v[7, 4:] = -np.inf, np.inf
    got, want = _warp_both(f1, u, v)
    _assert_warp_matches(got, want)


def test_metrics_all_outliers():
    """Every pixel dropped by the EE>50 rule -> NaN mean and deviation,
    in both packages."""
    n = 16
    u = np.full(n, 100.0)
    z = np.zeros(n)
    got = metrics.EE(n, 1, u, z, z, z)
    want = jax_metrics.EE(n, 1, u, z, z, z)
    assert np.isnan(got).all() and np.isnan(want).all()
