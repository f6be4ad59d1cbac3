"""The port's FFT and fold transform routes, the 2-D transforms of GN's
preconditioner and the refined stepA solve, vs ofot_tpu and vs the dense
route, on the same float64 inputs.

Tolerances:
  * the FFT route against the dense route: 1e-11, tests/test_dct.py's
    bound (the FFT sums in another order);
  * a 3-D solve through the FFT or the fold route against JAX with the
    same override: 1e-10, the spectral solve's bound in
    tests/test_torch_solvers.py (division by eigenvalues down to r*eps);
  * the 2-D transforms and spectra: 1e-12 (the same products);
  * the refined solve against the exact one: 1e-10, as tests/test_dct.py
    holds JAX's (on the CPU the transforms are full precision).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ofot_tpu.solvers import dct as jax_dct
from ofot_tpu.solvers import foto as jax_foto
from ofot_tpu.solvers import gn as jax_gn
from ofot_tpu_torch.ops import operators
from ofot_tpu_torch.solvers import dct, foto, gn

RNG = np.random.default_rng(43)


@pytest.fixture
def fft_everywhere(monkeypatch):
    """Route every axis longer than 4 through the FFT, on both sides."""
    monkeypatch.setattr(dct, "_FFT_THRESHOLD", 4)
    monkeypatch.setattr(jax_dct, "_FFT_THRESHOLD", 4)


@pytest.fixture
def fold_enabled(monkeypatch):
    """Enable the (default-off) folded solve transforms, on both sides."""
    monkeypatch.setattr(dct, "_FOLD_MIN_N", 128)
    monkeypatch.setattr(jax_dct, "_FOLD_MIN_N", 128)


@pytest.mark.parametrize("n", [5, 16, 33, 1025])
def test_fft_route_matches_dense(n):
    C = dct._dct_matrix_np(n)
    x = RNG.standard_normal((3, n))
    np.testing.assert_allclose(dct._dct_fft_last(torch.from_numpy(x)).numpy(),
                               x @ C.T, rtol=0, atol=1e-11)
    y = RNG.standard_normal((3, n))
    np.testing.assert_allclose(
        dct._idct_fft_last(torch.from_numpy(y)).numpy(), y @ C, rtol=0,
        atol=1e-11)


def test_fft_route_float32_keeps_dtype():
    x = torch.from_numpy(RNG.standard_normal((2, 33)).astype(np.float32))
    y = dct._dct_fft_last(x)
    assert y.dtype == torch.float32
    np.testing.assert_allclose(dct._idct_fft_last(y).numpy(), x.numpy(),
                               rtol=0, atol=1e-5)


def test_routes_follow_the_device(monkeypatch):
    """1024 on the CPU, as JAX's CPU backend; never on cuda."""
    assert dct._axis_mode(1024, "cpu") == "dense"
    assert dct._axis_mode(1025, "cpu") == "fft"
    assert dct._axis_mode(1025, "cuda") == "dense"
    assert dct._axis_mode(4096, torch.device("cuda", 0)) == "dense"
    assert dct._solve_modes((16, 240, 320), "cuda") == ("dense",) * 3
    monkeypatch.setattr(dct, "_FFT_THRESHOLD", 8)
    assert dct._solve_modes((16, 7, 9), "cuda") == ("fft", "dense", "fft")


def test_fold_route_is_off_by_default():
    assert dct._axis_mode(256, "cpu") == "dense"


@pytest.mark.usefixtures("fold_enabled")
@pytest.mark.parametrize("n", [130, 256])
def test_folded_transform_matches_dense_permuted(n):
    assert dct._axis_mode(n, "cpu") == "fold"
    assert dct._axis_mode(n + 1, "cpu") == "dense"        # odd: no fold
    x = torch.from_numpy(RNG.standard_normal((3, n)))
    C = dct._dct_matrix_np(n)
    perm = np.concatenate([np.arange(0, n, 2), np.arange(1, n, 2)])
    got = dct._apply_axis_folded(x, n, -1, inverse=False)
    np.testing.assert_allclose(got.numpy(), (x.numpy() @ C.T)[:, perm],
                               rtol=0, atol=1e-11)
    back = dct._apply_axis_folded(got, n, -1, inverse=True)
    np.testing.assert_allclose(back.numpy(), x.numpy(), rtol=0, atol=1e-11)
    np.testing.assert_array_equal(dct._eigs_1d_np(n, "fold"),
                                  jax_dct._eigs_1d_np(n, "fold"))


def _stepA_vs_jax(shape, r=1.0, eps=1e-2):
    F = RNG.standard_normal(shape)
    got = dct.solve_stepA_dct(torch.from_numpy(F), r=r, reg_epsilon=eps)
    want = jax_dct.solve_stepA_dct(jnp.asarray(F), r=r, reg_epsilon=eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-10)
    residual = -r * operators.laplacian_st(got, bc="N") + r * eps * got \
        - torch.from_numpy(F)
    assert float(residual.abs().max()) < 1e-8


@pytest.mark.usefixtures("fft_everywhere")
def test_stepA_solve_through_fft_matches_jax():
    assert dct._solve_modes((4, 6, 10), "cpu") == ("dense", "fft", "fft")
    _stepA_vs_jax((4, 6, 10))


@pytest.mark.usefixtures("fold_enabled")
def test_stepA_solve_through_fold_matches_jax():
    assert dct._solve_modes((3, 130, 144), "cpu") == ("dense", "fold",
                                                       "fold")
    _stepA_vs_jax((3, 130, 144))


@pytest.mark.usefixtures("fft_everywhere")
def test_natural_transforms_through_fft_match_jax():
    x = RNG.standard_normal((5, 7, 11))
    got = dct.dct3(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_dct.dct3(
        jnp.asarray(x))), rtol=0, atol=1e-11)
    np.testing.assert_allclose(dct.idct3(got).numpy(), x, rtol=0,
                               atol=1e-11)


@pytest.mark.parametrize("shape", [(7, 11), (3, 12, 10)])
def test_dct2_idct2_match_jax(shape):
    x = RNG.standard_normal(shape)
    got = dct.dct2(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax_dct.dct2(jnp.asarray(x))),
                               rtol=0, atol=1e-12)
    y = RNG.standard_normal(shape)
    np.testing.assert_allclose(dct.idct2(torch.from_numpy(y)).numpy(),
                               np.asarray(jax_dct.idct2(jnp.asarray(y))),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(dct.idct2(got).numpy(), x, rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("modes", [None, ("dense", "fold"),
                                   ("fold", "fft")])
def test_neg_lap2d_spectra_match_jax(modes):
    Ny, Nx = 6, 8
    np.testing.assert_array_equal(dct.neg_lap2d_spectrum(Ny, Nx),
                                  jax_dct.neg_lap2d_spectrum(Ny, Nx))
    np.testing.assert_allclose(
        dct.neg_lap2d_spectrum_solve(Ny, Nx, np.float64, modes=modes),
        jax_dct.neg_lap2d_spectrum_solve(Ny, Nx, np.float64, modes=modes),
        rtol=0, atol=1e-12)


def test_neg_lap2d_spectrum_diagonalizes_lap_gn():
    Ny, Nx = 5, 7
    x = torch.from_numpy(RNG.standard_normal((Ny, Nx)))
    lam = torch.from_numpy(dct.neg_lap2d_spectrum(Ny, Nx))
    want = -operators.lap_gn(x)
    np.testing.assert_allclose(dct.idct2(dct.dct2(x) * lam).numpy(),
                               want.numpy(), rtol=0, atol=1e-12)


@pytest.mark.usefixtures("fold_enabled")
def test_spectral_preconditioner_folded_equals_natural():
    """GN's spectral preconditioner through the folded solve transforms ==
    the same operator through natural-order dct2, and == JAX's."""
    k, Ny, Nx = 3, 130, 144
    g = RNG.standard_normal((k, Ny, Nx))
    rhs = RNG.standard_normal((k, Ny, Nx))
    coefs = (0.1, 0.1, 0.2)
    M = gn.make_spectral_block_preconditioner(torch.from_numpy(g), coefs)
    lam = dct.neg_lap2d_spectrum(Ny, Nx)
    c = np.mean(g ** 2, axis=(-2, -1))
    spec = np.asarray(coefs)[:, None, None] * lam[None] + c[:, None, None]
    want = dct.idct2(dct.dct2(torch.from_numpy(rhs)) / torch.from_numpy(spec))
    got = M(torch.from_numpy(rhs))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-10)
    theirs = jax_gn.make_spectral_block_preconditioner(jnp.asarray(g), coefs)
    np.testing.assert_allclose(got.numpy(), np.asarray(theirs(
        jnp.asarray(rhs))), rtol=0, atol=1e-10)


@pytest.mark.parametrize("refine", [0, 1, 2])
def test_stepA_dct_refined_matches_exact(refine):
    F = torch.from_numpy(RNG.standard_normal((4, 12, 10)))
    want = dct.solve_stepA_dct(F, r=1.0, reg_epsilon=1e-2)
    got = dct.solve_stepA_dct_refined(F, r=1.0, reg_epsilon=1e-2,
                                      refine=refine)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-10)
    theirs = jax_dct.solve_stepA_dct_refined(jnp.asarray(F.numpy()), r=1.0,
                                             reg_epsilon=1e-2, refine=refine)
    np.testing.assert_allclose(got.numpy(), np.asarray(theirs), rtol=0,
                               atol=1e-10)


def test_stepA_refined_contracts_transform_error():
    """With a deliberately perturbed approximate inverse (standing in for
    low-precision transforms), each refinement step contracts the solve
    error at least tenfold."""
    Nt, Ny, Nx = 4, 10, 8
    r, eps = 1.0, 1e-2
    F = torch.from_numpy(RNG.standard_normal((Nt, Ny, Nx)))
    plan = dct.StepAPlan(F.shape, r, eps, F.dtype, F.device)
    exact = plan.solve(F)
    plan.spec = plan.spec * (1.0 + 1e-2)      # 1% multiplicative error
    errs = [float((plan.solve_refined(F, k) - exact).abs().max())
            for k in range(4)]
    for a, b in zip(errs, errs[1:]):
        assert b < 0.1 * a, errs


def test_tf32_context_restores_the_settings():
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.get_float32_matmul_precision())
    assert before == (False, "highest")
    with dct._tf32_matmul("cuda"):
        assert torch.backends.cuda.matmul.allow_tf32
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision()) == before
    with pytest.raises(RuntimeError):
        with dct._tf32_matmul(torch.device("cuda", 0)):
            raise RuntimeError("inside")
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision()) == before
    with dct._tf32_matmul("cpu"):
        assert not torch.backends.cuda.matmul.allow_tf32


def test_tf32_off_after_a_refined_solve():
    F = torch.from_numpy(RNG.standard_normal((3, 6, 5)))
    dct.solve_stepA_dct_refined(F)
    foto.stepA_ops("dct-refined").stepA_solve(F, 1.0, 1e-2, 1e-6, 10)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


@pytest.mark.parametrize("refine", [0, 3])
def test_refined_ops_count_inner_iterations(refine):
    F = torch.from_numpy(RNG.standard_normal((3, 6, 5)))
    ops = foto.DCTRefinedOps(refine=refine)
    phi, inner = ops.stepA_solve(F, 1.0, 1e-2, 1e-6, 10)
    assert inner == 1 + refine
    torch.testing.assert_close(phi, dct.solve_stepA_dct(F), rtol=0,
                               atol=1e-10)
    assert foto.stepA_ops("dct-refined").refine == 3


def test_foto_with_refined_ops_matches_jax():
    """Eight ALG2 iterations with the refined set: the JAX refined set's
    state, at the unfused sets' 1e-10."""
    import fixtures
    f1, f2 = fixtures.translating_square(20)
    kw = dict(r=1.0, convergence_tol=1e-6, reg_epsilon=1e-2, max_it=8)
    ours = foto.solve_potential(torch.from_numpy(f1), torch.from_numpy(f2),
                                4, ops=foto.stepA_ops("dct-refined"), **kw)
    theirs = jax_foto.solve_potential(jnp.asarray(f1), jnp.asarray(f2), 4,
                                      ops=jax_foto.DCTRefinedOps(), **kw)
    assert ours.iteration == int(theirs.iteration) == 8
    assert ours.cg_iterations == int(theirs.cg_iterations) == 32
    np.testing.assert_allclose(ours.phi.numpy(), np.asarray(theirs.phi),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(float(ours.crit), float(theirs.crit),
                               rtol=1e-10)


@pytest.mark.parametrize("modes", [("dense", "fold"), ("fft", "dense"),
                                   ("fold", "fft")])
def test_solve_path_transforms_match_jax(modes):
    """The solve-path transforms routed by the caller's modes (2-D, and
    3-D with a dense t axis) equal JAX's in the same coefficient order,
    and invert."""
    x2 = RNG.standard_normal((2, 10, 12))
    got = dct._dct2_solve(torch.from_numpy(x2), modes=modes)
    want = jax_dct._dct2_solve(jnp.asarray(x2), modes=modes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(dct._idct2_solve(got, modes=modes).numpy(),
                               x2, rtol=0, atol=1e-12)
    x3 = RNG.standard_normal((3, 10, 12))
    modes3 = ("dense",) + modes
    got = dct._dct3_solve(torch.from_numpy(x3), modes=modes3)
    want = jax_dct._dct3_solve(jnp.asarray(x3), modes=modes3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(dct._idct3_solve(got, modes=modes3).numpy(),
                               x3, rtol=0, atol=1e-12)
