"""The port's stencils, space-time operators and paraboloid projection vs
ofot_tpu on the same float64 inputs.

Tolerance 1e-12 at float64: both sides do the same arithmetic in the same
order, so only the last bits may differ (torch's ``s ** (1/3)`` against
jnp.cbrt in the projection)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ofot_tpu.ops import operators as jax_operators
from ofot_tpu.ops import projection as jax_projection
from ofot_tpu.ops import stencils as jax_stencils
from ofot_tpu_torch.ops import operators, projection, stencils

RNG = np.random.default_rng(11)
TOL = 1e-12


def _both(fn_name, module, jax_module, x, *args, **kw):
    got = getattr(module, fn_name)(torch.from_numpy(x), *args, **kw)
    want = getattr(jax_module, fn_name)(jnp.asarray(x), *args, **kw)
    return got.numpy(), np.asarray(want)


_STENCILS = ["grad_central", "lap1d", "grad_central_weird"]


@pytest.mark.parametrize("name", _STENCILS)
@pytest.mark.parametrize("bc", ["N", "D"])
@pytest.mark.parametrize("axis", [-1, -2, -3])
def test_stencil_matches_jax(name, bc, axis):
    x = RNG.standard_normal((5, 7, 6))
    got, want = _both(name, stencils, jax_stencils, x, 1.5, bc, axis=axis)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_stencil_rejects_unknown_bc():
    with pytest.raises(NotImplementedError):
        stencils.grad_central(torch.zeros(4), 1.0, "P")


def test_stencils_do_not_modify_their_input():
    x = torch.from_numpy(RNG.standard_normal((4, 5)))
    before = x.clone()
    for name in _STENCILS:
        getattr(stencils, name)(x, 1.0, "N", axis=-1)
    assert torch.equal(x, before)


def test_weird_boundary_rows_are_unscaled():
    """Quirk 1: the 'N' boundary rows of the weird stencil are one-sided
    differences not divided by h."""
    x = torch.tensor([1.0, 4.0, 9.0, 16.0], dtype=torch.float64)
    out = stencils.grad_central_weird(x, 2.0, "N")
    assert out[0] == 3.0 and out[-1] == 7.0
    assert out[1] == (9.0 - 1.0) / 4.0


def test_central_neumann_zeroes_boundary():
    """Quirk 2: central 'N' differences vanish on the boundary rows."""
    x = torch.from_numpy(RNG.standard_normal((6, 8)))
    g = operators.grad2d(x)
    assert torch.all(g[0][:, 0] == 0) and torch.all(g[0][:, -1] == 0)
    assert torch.all(g[1][0] == 0) and torch.all(g[1][-1] == 0)


@pytest.mark.parametrize("name", ["grad_st", "laplacian_st"])
@pytest.mark.parametrize("bc", ["N", "D"])
def test_space_time_scalar_operators(name, bc):
    x = RNG.standard_normal((4, 6, 9))
    got, want = _both(name, operators, jax_operators, x, bc=bc)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("bc", ["N", "D"])
def test_div_st(bc):
    mu = RNG.standard_normal((3, 4, 6, 9))
    got, want = _both("div_st", operators, jax_operators, mu, bc=bc)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_div_st_is_not_minus_grad_st_transpose():
    """Quirk 3: the reference's div_st is built independently and is not
    the negative adjoint of grad_st; the port keeps that."""
    Nt, Ny, Nx = 3, 4, 5
    n = Nt * Ny * Nx
    G = np.stack([operators.grad_st(torch.from_numpy(e.reshape(Nt, Ny, Nx)))
                  .numpy().ravel() for e in np.eye(n)], axis=1)
    D = np.stack([operators.div_st(torch.from_numpy(e.reshape(3, Nt, Ny, Nx)))
                  .numpy().ravel() for e in np.eye(3 * n)], axis=1)
    assert np.abs(D + G.T).max() > 0.1


@pytest.mark.parametrize("bc", ["N", "D"])
def test_grad2d_div2d(bc):
    f = RNG.standard_normal((2, 7, 8))
    got, want = _both("grad2d", operators, jax_operators, f, bc=bc)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    u, v = RNG.standard_normal((7, 8)), RNG.standard_normal((7, 8))
    got = operators.div2d(torch.from_numpy(u), torch.from_numpy(v), bc=bc)
    want = jax_operators.div2d(jnp.asarray(u), jnp.asarray(v), bc=bc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


def _points(ncomp, n=4000, scale=3.0):
    p = RNG.uniform(-scale, scale, (ncomp, n))
    # exercise the apex (rho = 0) and the branch boundary (alpha = -1)
    p[1:, :20] = 0.0
    p[0, 20:40] = -1.0
    return p


def test_project_paraboloid_matches_jax():
    p = _points(3)
    got, want = _both("project_paraboloid", projection, jax_projection, p)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("ncomp", [2, 3, 4])
def test_project_paraboloid_nd_matches_jax(ncomp):
    p = _points(ncomp)
    got, want = _both("project_paraboloid_nd", projection, jax_projection, p)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_project_paraboloid_float32():
    """float32 uses the 1e-20 floor; agreement is at float32 rounding."""
    p = _points(3).astype(np.float32)
    got, want = _both("project_paraboloid", projection, jax_projection, p)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-6)


def test_projection_lands_on_paraboloid_and_is_idempotent():
    p = torch.from_numpy(_points(3))
    q = projection.project_paraboloid(p)
    assert torch.all(2 * q[0] + q[1] ** 2 + q[2] ** 2 <= 1e-9)
    torch.testing.assert_close(projection.project_paraboloid(q), q,
                               rtol=0, atol=1e-9)


@pytest.mark.parametrize("dtype,eps", [(torch.float64, 1e-30),
                                       (torch.float32, 1e-20)])
def test_projection_eps_follows_dtype(dtype, eps):
    assert projection._proj_eps(dtype) == eps
