"""The port's spectral stepA, CG, flow extraction and warp vs ofot_tpu.

float64 inputs from a numpy seed go to both packages.  Tolerances:
  * DCT transforms and the spectral solve: 1e-10 absolute on O(1) fields —
    both multiply by the same cosine matrices, in a different summation
    order, and the solve divides by eigenvalues down to r*eps = 1e-2;
  * CG: the same step count, and 1e-9 absolute on the O(1) solution — the
    recurrence is the same, but the dot products sum in another order and
    CG's roundoff grows with the system's condition number (~1.2e3 at
    r*eps = 1e-2) and the number of steps;
  * flow extraction and warp: 1e-12 — the same gathers and weights.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ofot_tpu.ops import operators as jax_operators
from ofot_tpu.solvers import cg as jax_cg
from ofot_tpu.solvers import dct as jax_dct
from ofot_tpu.solvers import flow_extract as jax_flow
from ofot_tpu.utils import warp as jax_warp
from ofot_tpu_torch.ops import operators
from ofot_tpu_torch.solvers import cg, dct, flow_extract
from ofot_tpu_torch.utils import warp

RNG = np.random.default_rng(5)


def test_matmul_precision_is_full_float32():
    """DESIGN.md §6: no TF32 in the solver's products."""
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


@pytest.mark.parametrize("n", [1, 2, 7, 16])
def test_dct_matrix_and_eigenvalues_equal_jax(n):
    np.testing.assert_array_equal(dct._dct_matrix_np(n),
                                  jax_dct._dct_matrix_np(n))
    np.testing.assert_array_equal(dct._neumann_eigenvalues_np(n),
                                  jax_dct._neumann_eigenvalues_np(n))


def test_stepA_spectrum_equals_jax():
    np.testing.assert_array_equal(
        dct.stepA_spectrum(4, 5, 6, 1.3, 1e-2, np.float64),
        jax_dct.stepA_spectrum(4, 5, 6, 1.3, 1e-2, np.float64))


@pytest.mark.parametrize("shape", [(4, 6, 9), (16, 12, 10)])
def test_dct3_idct3_match_jax(shape):
    x = RNG.standard_normal(shape)
    got = dct.dct3(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_dct.dct3(jnp.asarray(x))),
                               rtol=0, atol=1e-10)
    back = dct.idct3(torch.from_numpy(got)).numpy()
    np.testing.assert_allclose(back, x, rtol=0, atol=1e-10)


@pytest.mark.parametrize("r,eps", [(1.0, 1e-2), (0.3, 1e-3)])
def test_solve_stepA_dct_matches_jax(r, eps):
    F = RNG.standard_normal((5, 8, 11))
    got = dct.solve_stepA_dct(torch.from_numpy(F), r=r, reg_epsilon=eps)
    want = jax_dct.solve_stepA_dct(jnp.asarray(F), r=r, reg_epsilon=eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-10)
    # and it solves the stencil system itself
    phi = got
    A_phi = -r * operators.laplacian_st(phi, bc="N") + r * eps * phi
    np.testing.assert_allclose(A_phi.numpy(), F, rtol=0, atol=1e-9)


def test_solve_stepA_dct_float32_close_to_float64():
    F = RNG.standard_normal((6, 10, 12))
    a = dct.solve_stepA_dct(torch.from_numpy(F.astype(np.float32)))
    b = dct.solve_stepA_dct(torch.from_numpy(F))
    assert a.dtype == torch.float32
    rel = (a.double() - b).abs().max() / b.abs().max()
    assert rel < 1e-5


def test_stepA_plan_reuse_is_exact():
    F = torch.from_numpy(RNG.standard_normal((4, 6, 5)))
    plan = dct.StepAPlan(F.shape, 1.0, 1e-2, F.dtype, F.device)
    torch.testing.assert_close(plan.solve(F), dct.solve_stepA_dct(F),
                               rtol=0, atol=0)


def _stepA_system(r, eps):
    def A_t(x):
        return -r * operators.laplacian_st(x, bc="N") + r * eps * x

    def A_j(x):
        return -r * jax_operators.laplacian_st(x, bc="N") + r * eps * x
    return A_t, A_j


@pytest.mark.parametrize("rtol,maxiter", [(1e-6, 1000), (1e-10, 1000),
                                          (1e-6, 3)])
def test_cg_matches_jax(rtol, maxiter):
    b = RNG.standard_normal((4, 7, 6))
    A_t, A_j = _stepA_system(1.0, 1e-2)
    ours = cg.cg(A_t, torch.from_numpy(b), rtol=rtol, maxiter=maxiter)
    theirs = jax_cg.cg(A_j, jnp.asarray(b), rtol=rtol, maxiter=maxiter)
    assert ours.iterations == int(theirs.iterations)
    assert ours.converged == bool(theirs.converged)
    np.testing.assert_allclose(ours.x.numpy(), np.asarray(theirs.x),
                               rtol=0, atol=1e-9)
    # the recurrence's residual near rtol=1e-10 is at its roundoff floor:
    # compare it on the scale of ||b||
    np.testing.assert_allclose(float(ours.residual), float(theirs.residual),
                               rtol=0, atol=1e-12 * np.linalg.norm(b))


def test_cg_with_preconditioner_and_x0_matches_jax():
    b = RNG.standard_normal((3, 5, 6))
    x0 = RNG.standard_normal((3, 5, 6))
    A_t, A_j = _stepA_system(0.7, 1e-1)
    ours = cg.cg(A_t, torch.from_numpy(b), rtol=1e-9,
                 x0=torch.from_numpy(x0), M=lambda v: 0.5 * v)
    theirs = jax_cg.cg(A_j, jnp.asarray(b), rtol=1e-9, x0=jnp.asarray(x0),
                       M=lambda v: 0.5 * v)
    assert ours.iterations == int(theirs.iterations)
    np.testing.assert_allclose(ours.x.numpy(), np.asarray(theirs.x),
                               rtol=0, atol=1e-9)


def test_cg_zero_rhs_takes_no_step():
    A_t, _ = _stepA_system(1.0, 1e-2)
    res = cg.cg(A_t, torch.zeros(2, 3, 4, dtype=torch.float64))
    assert res.iterations == 0 and res.converged


def _potential(Nt=5, Ny=9, Nx=12, amp=2.0):
    y, x = np.mgrid[0:Ny, 0:Nx].astype(np.float64)
    t = np.arange(Nt, dtype=np.float64)[:, None, None]
    phi = amp * (0.3 * x * (1 + 0.1 * t) - 0.2 * y + 0.05 * x * y / Nx)
    return phi + 0.1 * RNG.standard_normal((Nt, Ny, Nx))


@pytest.mark.parametrize("amp", [0.5, 2.0, 8.0])
def test_flow_from_potential_matches_jax(amp):
    """Trajectories that leave the grid exercise the truncate-then-clamp
    cell index; the last time slice's velocity is zero."""
    phi = _potential(amp=amp)
    got = flow_extract.flow_from_potential(torch.from_numpy(phi))
    want = jax_flow.flow_from_potential(jnp.asarray(phi))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-12)


def test_velocities_last_slice_zero():
    un, vn = flow_extract.velocities_from_potential(
        torch.from_numpy(_potential()))
    assert torch.all(un[-1] == 0) and torch.all(vn[-1] == 0)
    assert torch.any(un[0] != 0)


@pytest.mark.parametrize("spread", [0.7, 3.0, 20.0])
@pytest.mark.parametrize("with_m", [False, True])
def test_warp_matches_jax(spread, with_m):
    """Offsets are taken before the clamp, so flows that push the source
    outside the image test the border arithmetic."""
    h, w = 11, 14
    f1 = RNG.random((h, w))
    u = RNG.uniform(-spread, spread, (h, w))
    v = RNG.uniform(-spread, spread, (h, w))
    m = RNG.uniform(-0.5, 0.5, (h, w)) if with_m else None
    got = warp.apply_flow(torch.from_numpy(f1), torch.from_numpy(u),
                          torch.from_numpy(v),
                          None if m is None else torch.from_numpy(m))
    want = jax_warp.apply_flow(jnp.asarray(f1), jnp.asarray(u),
                               jnp.asarray(v),
                               None if m is None else jnp.asarray(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)


def test_warp_zero_flow_is_identity():
    f1 = torch.from_numpy(RNG.random((6, 7)))
    z = torch.zeros_like(f1)
    torch.testing.assert_close(warp.apply_flow(f1, z, z), f1, rtol=0, atol=0)
