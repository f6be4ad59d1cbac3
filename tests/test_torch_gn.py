"""The port's GN solver vs ofot_tpu.solvers.gn on the same float64 inputs.

Tolerances:
  * the operator's action and both preconditioners: 1e-12 (the same
    stencils and products; the spectral one through the same cosine
    matrices);
  * ``solve_fields``: the same CG step count within one, and fields
    within 1e-8 — both run CG to rtol 1e-10, and their dot products sum in
    another order;
  * against the dense solve: tests/test_gn.py's AEPE < 1e-6 and 1e-5.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ofot_tpu.solvers import gn as jax_gn
from ofot_tpu_torch.solvers import gn

import fixtures
from test_gn import dense_gn_system

RNG = np.random.default_rng(17)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_image_gradients_and_lap_diag_match_jax():
    _, f2 = fixtures.smooth_blob_pair(10, 12)
    got = gn.image_gradients(torch.from_numpy(f2))
    want = jax_gn.image_gradients(jnp.asarray(f2))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12)
    np.testing.assert_array_equal(
        gn._lap_diag(6, 9, torch.float64, "cpu").numpy(),
        np.asarray(jax_gn._lap_diag(6, 9, jnp.float64)))


def test_operator_and_preconditioners_match_jax():
    _, f2 = fixtures.smooth_blob_pair(10, 12)
    x = RNG.standard_normal((3, 10, 12))
    A, M = gn.make_operator(torch.from_numpy(f2), 0.1, 0.2)
    Aj, Mj = jax_gn.make_operator(jnp.asarray(f2), 0.1, 0.2)
    for ours, theirs in ((A, Aj), (M, Mj)):
        np.testing.assert_allclose(ours(torch.from_numpy(x)).numpy(),
                                   np.asarray(theirs(jnp.asarray(x))),
                                   rtol=0, atol=1e-12)
    S = gn.make_spectral_preconditioner(torch.from_numpy(f2), 0.1, 0.2)
    Sj = jax_gn.make_spectral_preconditioner(jnp.asarray(f2), 0.1, 0.2)
    np.testing.assert_allclose(S(torch.from_numpy(x)).numpy(),
                               np.asarray(Sj(jnp.asarray(x))), rtol=0,
                               atol=1e-12)


def test_operator_action_matches_dense():
    f1, f2 = fixtures.smooth_blob_pair(10, 12)
    A, _ = gn.make_operator(torch.from_numpy(f2), 0.1, 0.2)
    Z, _ = dense_gn_system(f1, f2, 0.1, 0.2)
    x = RNG.standard_normal((3, 10, 12))
    np.testing.assert_allclose(A(torch.from_numpy(x)).numpy().ravel(),
                               Z @ x.ravel(), rtol=0, atol=1e-11)


def test_jacobi_preconditioner_inverts_the_block_diagonal():
    """Per pixel, M is the exact inverse of diag(d) + g g^T."""
    g = RNG.standard_normal((3, 4, 5))
    d = RNG.uniform(0.5, 2.0, (3, 4, 5))
    M = gn.make_jacobi_block_preconditioner(*_t(g, d))
    rhs = RNG.standard_normal((3, 4, 5))
    got = M(torch.from_numpy(rhs)).numpy()
    for i in range(4):
        for j in range(5):
            B = np.diag(d[:, i, j]) + np.outer(g[:, i, j], g[:, i, j])
            np.testing.assert_allclose(B @ got[:, i, j], rhs[:, i, j],
                                       rtol=0, atol=1e-12)


@pytest.mark.parametrize("precond", ["spectral", "jacobi"])
def test_solve_fields_matches_jax(precond):
    f1, f2 = fixtures.smooth_blob_pair(12, 14)
    ours = gn.solve_fields(*_t(f1, f2), 0.1, 0.2, precond=precond)
    theirs = jax_gn.solve_fields(jnp.asarray(f1), jnp.asarray(f2), 0.1, 0.2,
                                 precond=precond)
    assert abs(ours.cg.iterations - int(theirs.cg.iterations)) <= 1
    assert ours.cg.converged and bool(theirs.cg.converged)
    for k in ("u", "v", "m"):
        np.testing.assert_allclose(getattr(ours, k).numpy(),
                                   np.asarray(getattr(theirs, k)), rtol=0,
                                   atol=1e-8, err_msg=k)


def test_solution_matches_dense_solve():
    f1, f2 = fixtures.smooth_blob_pair(12, 14)
    Z, b = dense_gn_system(f1, f2, 0.1, 0.2)
    want = np.linalg.solve(Z, b).reshape(3, 12, 14)
    res = gn.solve_fields(*_t(f1, f2), 0.1, 0.2)
    got = np.stack([res.u.numpy(), res.v.numpy(), res.m.numpy()])
    aepe = np.sqrt((got[0] - want[0]) ** 2 + (got[1] - want[1]) ** 2).mean()
    assert aepe < 1e-6
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_float32_solve_converges_near_float64():
    f1, f2 = fixtures.smooth_blob_pair(16, 20)
    a = gn.solve_fields(*_t(f1.astype(np.float32), f2.astype(np.float32)))
    b = gn.solve_fields(*_t(f1, f2))
    assert a.u.dtype == torch.float32 and a.cg.converged
    for k in ("u", "v", "m"):
        x, y = getattr(a, k).double(), getattr(b, k)
        assert float((x - y).abs().max() / y.abs().max()) < 1e-4, k


def test_spectral_precond_handles_vanishing_gradients():
    """Frames constant along an axis give fx == 0, whose mean data diagonal
    is 0 — the DC mode of the spectral preconditioner must act as identity
    instead of dividing 0/0 into NaNs."""
    y = np.mgrid[0:16, 0:20][0].astype(np.float32)
    f1 = torch.from_numpy(np.sin(y / 3) * 0.25 + 0.5)
    r = gn.solve_fields(f1, f1 * 1.01)
    for field in (r.u, r.v, r.m):
        assert torch.isfinite(field).all()
    flat = torch.full((12, 14), 0.5, dtype=torch.float64)
    r2 = gn.solve_fields(flat, flat)
    assert torch.isfinite(r2.u).all() and r2.cg.iterations == 0


def test_class_api_matches_jax():
    f1, f2 = fixtures.smooth_blob_pair(8, 9)
    outs = []
    for cls, kw in ((gn.GLLOpticalFlow, {"device": "cpu"}),
                    (jax_gn.GLLOpticalFlow, {})):
        solver = cls(9, 8, **kw)
        solver.setAlpha(0.15)
        solver.setLambda(0.25)
        outs.append(solver.assemble(f1.ravel(), f2.ravel()).process())
    assert solver.NAME == gn.GLLOpticalFlow.NAME == "GLL"
    for a, b in zip(*outs):
        assert a.shape == b.shape == (72,)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-8)


def test_class_api_runs_on_the_card_unless_told():
    assert gn.GLLOpticalFlow(3, 2).device == torch.device("cuda")
