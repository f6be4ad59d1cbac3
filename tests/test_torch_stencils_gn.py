"""The port's forward/backward stencils, their adjoints and GN's 2-D
operators vs ofot_tpu on the same float64 inputs.

Tolerance 1e-12 at float64: both sides do the same arithmetic in the same
order.  The adjoints are also held to ``<D x, y> = <x, D^T y>`` at 1e-12
(sums of a few hundred O(1) products)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ofot_tpu.ops import operators as jax_operators
from ofot_tpu.ops import stencils as jax_stencils
from ofot_tpu_torch.ops import operators, stencils

import golden_ops as G

RNG = np.random.default_rng(13)
TOL = 1e-12

_GN_STENCILS = ["grad_forward", "grad_backward", "grad_forward_weird",
                "grad_backward_weird", "grad_forward_adjoint",
                "grad_central_adjoint"]


@pytest.mark.parametrize("name", _GN_STENCILS)
@pytest.mark.parametrize("bc", ["N", "D"])
@pytest.mark.parametrize("axis", [-1, -2, -3])
def test_gn_stencil_matches_jax(name, bc, axis):
    x = RNG.standard_normal((5, 7, 6))
    got = getattr(stencils, name)(torch.from_numpy(x), 1.5, bc, axis=axis)
    want = getattr(jax_stencils, name)(jnp.asarray(x), 1.5, bc, axis=axis)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("name", _GN_STENCILS)
def test_gn_stencils_do_not_modify_their_input(name):
    x = torch.from_numpy(RNG.standard_normal((4, 5)))
    before = x.clone()
    for bc in ("N", "D"):
        getattr(stencils, name)(x, 1.0, bc, axis=-1)
        getattr(stencils, name)(x, 1.0, bc, axis=0)
    assert torch.equal(x, before)


@pytest.mark.parametrize("forward,adjoint", [
    ("grad_forward", "grad_forward_adjoint"),
    ("grad_central", "grad_central_adjoint")])
@pytest.mark.parametrize("bc", ["N", "D"])
@pytest.mark.parametrize("axis", [-1, -2])
def test_adjoint_identity(forward, adjoint, bc, axis):
    """<D x, y> = <x, D^T y>."""
    x = torch.from_numpy(RNG.standard_normal((9, 11)))
    y = torch.from_numpy(RNG.standard_normal((9, 11)))
    Dx = getattr(stencils, forward)(x, 0.7, bc, axis=axis)
    DTy = getattr(stencils, adjoint)(y, 0.7, bc, axis=axis)
    assert abs(float(torch.sum(Dx * y)) - float(torch.sum(x * DTy))) < TOL


@pytest.mark.parametrize("bc", ["N", "D"])
def test_forward_stencils_match_dense_matrices(bc):
    n, h = 7, 1.3
    x = RNG.standard_normal(n)
    t = torch.from_numpy(x)
    np.testing.assert_allclose(stencils.grad_forward(t, h, bc).numpy(),
                               G.d_forward(n, h, bc) @ x, rtol=0, atol=TOL)
    np.testing.assert_allclose(stencils.grad_backward(t, h, bc).numpy(),
                               G.d_backward(n, h, bc) @ x, rtol=0, atol=TOL)
    np.testing.assert_allclose(
        stencils.grad_forward_weird(t, h, bc).numpy(),
        G.d_forward(n, h, bc, weird=True) @ x, rtol=0, atol=TOL)
    np.testing.assert_allclose(
        stencils.grad_backward_weird(t, h, bc).numpy(),
        G.d_backward(n, h, bc, weird=True) @ x, rtol=0, atol=TOL)
    np.testing.assert_allclose(
        stencils.grad_forward_adjoint(t, h, bc).numpy(),
        G.d_forward(n, h, bc).T @ x, rtol=0, atol=TOL)


def test_forward_neumann_zeroes_last_row():
    """'N' zeroes the last row of grad_forward; the weird variant keeps
    its unscaled one-sided difference there."""
    x = torch.tensor([1.0, 4.0, 9.0, 16.0], dtype=torch.float64)
    assert stencils.grad_forward(x, 2.0, "N")[-1] == 0.0
    assert stencils.grad_forward(x, 2.0, "D")[-1] == -8.0
    assert stencils.grad_forward_weird(x, 2.0, "N")[-1] == 7.0
    assert stencils.grad_backward_weird(x, 2.0, "D")[0] == 3.0


@pytest.mark.parametrize("bc", ["N", "D"])
def test_grad_forward2d_and_div_forward_adjoint2d(bc):
    f = RNG.standard_normal((7, 8))
    got = operators.grad_forward2d(torch.from_numpy(f), 1.0, 0.5, bc)
    want = jax_operators.grad_forward2d(jnp.asarray(f), 1.0, 0.5, bc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)
    u, v = RNG.standard_normal((7, 8)), RNG.standard_normal((7, 8))
    got = operators.div_forward_adjoint2d(torch.from_numpy(u),
                                          torch.from_numpy(v), bc=bc)
    want = jax_operators.div_forward_adjoint2d(jnp.asarray(u),
                                               jnp.asarray(v), bc=bc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("shape", [(6, 9), (2, 5, 7)])
def test_lap_gn_matches_jax(shape):
    f = RNG.standard_normal(shape)
    got = operators.lap_gn(torch.from_numpy(f))
    want = jax_operators.lap_gn(jnp.asarray(f))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


def test_lap_gn_matches_dense_operator():
    Ny, Nx = 5, 6
    f = RNG.standard_normal((Ny, Nx))
    got = operators.lap_gn(torch.from_numpy(f)).numpy().ravel()
    np.testing.assert_allclose(got, G.lap_gn_mat(Nx, Ny) @ f.ravel(),
                               rtol=0, atol=TOL)
