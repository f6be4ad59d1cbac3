"""The spectral stepA solve with the per-slice kernel (``dct-fused``).

On the CPU: the plain version ``dct_solve_reference`` against the Pallas
function ``dct_solve_pallas`` in interpret mode (as tests/test_pallas.py
runs it), on float32 inputs from a numpy seed, at the relative error
(to max|phi|) of 5e-6 that tests/test_pallas.py holds the Pallas kernel to
against the XLA spectral solve: the same float32 products summed in another
order, then divided by eigenvalues down to r*eps.  At float64 the plain
version agrees with the port's own spectral solve (``StepAPlan``) to
1e-10, the bound tests/test_torch_solvers.py uses for the spectral solve.

A short ALG2 run under the port's ``dct-fused`` set is held against the JAX
package's ``DCTFusedOps`` (float32) to 2e-5 on phi and 1e-4 relative on
crit, the bounds tests/test_torch_foto.py holds the float32 fused set to.

The CUDA kernel itself is held against the plain version on the card in
tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl

from ofot_tpu.ops.pallas import kernels
from ofot_tpu.solvers import foto as jax_foto
from ofot_tpu_torch.ops.kernels import dct_solve as ds
from ofot_tpu_torch.solvers import dct, foto

import fixtures

RNG = np.random.default_rng(41)


@pytest.fixture
def _interpret_mode(monkeypatch):
    real_call = pl.pallas_call

    def patched(*a, **kw):
        kw.setdefault("interpret", True)
        return real_call(*a, **kw)

    monkeypatch.setattr(kernels.pl, "pallas_call", patched)


@pytest.mark.usefixtures("_interpret_mode")
@pytest.mark.parametrize("shape", [(4, 16, 24), (5, 17, 23), (8, 48, 64)])
@pytest.mark.parametrize("r,eps", [(1.0, 1e-2), (0.3, 1e-3)])
def test_reference_matches_pallas_interpret(shape, r, eps):
    F = RNG.standard_normal(shape).astype(np.float32)
    got = ds.dct_solve(torch.from_numpy(F), r, eps)
    want = np.asarray(jax.jit(kernels.dct_solve_pallas)(jnp.asarray(F), r,
                                                        eps))
    assert got.dtype == torch.float32 and got.shape == shape
    err = float(np.abs(got.numpy() - want).max() / np.abs(want).max())
    assert err < 5e-6, err


@pytest.mark.parametrize("shape", [(4, 6, 9), (5, 17, 23)])
def test_reference_matches_spectral_solve_float64(shape):
    F = torch.from_numpy(RNG.standard_normal(shape))
    got = ds.dct_solve_reference(F, 0.7, 1e-2)
    want = dct.solve_stepA_dct(F, 0.7, 1e-2)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-10)


def test_reference_solves_the_stepA_system():
    """A @ dct_solve(F) == F for A = -r L_st + r eps I (float64)."""
    from ofot_tpu_torch.ops import operators
    F = torch.from_numpy(RNG.standard_normal((4, 7, 9)))
    r, eps = 1.3, 1e-2
    phi = ds.dct_solve(F, r, eps)
    back = -r * operators.laplacian_st(phi, bc="N") + (r * eps) * phi
    torch.testing.assert_close(back, F, rtol=0, atol=1e-10)


def test_plan_is_built_once_per_system():
    a = ds.plan((4, 5, 6), torch.float32, torch.device("cpu"), 1.0, 1e-2)
    b = ds.plan((4, 5, 6), torch.float32, torch.device("cpu"), 1.0, 1e-2)
    c = ds.plan((4, 5, 6), torch.float32, torch.device("cpu"), 1.0, 1e-3)
    assert a is b and a is not c
    assert a.Cy.shape == (5, 5) and a.lx.shape == (6,)
    np.testing.assert_array_equal(a.Cx.numpy(),
                                  dct._dct_matrix_np(6).astype(np.float32))


def test_cpu_tensors_take_the_plain_version_without_counting():
    F = torch.from_numpy(RNG.standard_normal((3, 4, 5)).astype(np.float32))
    before = ds.launches
    torch.testing.assert_close(ds.dct_solve(F, 1.0, 1e-2),
                               ds.dct_solve_reference(F, 1.0, 1e-2),
                               rtol=0, atol=0)
    assert ds.launches == before


def test_other_devices_raise():
    F = torch.zeros(3, 4, 5, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ds.dct_solve(F, 1.0, 1e-2)


def test_dct_fused_ops_set_solves_with_the_kernel_module():
    ops = foto.stepA_ops("dct-fused")
    assert isinstance(ops, foto.DCTFusedOps)
    F = torch.from_numpy(RNG.standard_normal((4, 6, 7)))
    phi, n = ops.stepA_solve(F, 1.0, 1e-2, 1e-6, 1000)
    assert n == 1
    torch.testing.assert_close(phi, ds.dct_solve_reference(F, 1.0, 1e-2),
                               rtol=0, atol=0)


@pytest.mark.usefixtures("_interpret_mode")
def test_dct_fused_alg2_matches_jax():
    """A short ALG2 run under the port's dct-fused set tracks the JAX
    package's DCTFusedOps (as tests/test_pallas.py:115 runs it)."""
    f1, f2 = fixtures.smooth_blob_pair(24, 32, dtype=np.float32)
    kw = dict(r=1.0, reg_epsilon=1e-2, convergence_tol=0.0, max_it=8)
    ours = foto.solve_potential(torch.from_numpy(f1), torch.from_numpy(f2),
                                4, ops=foto.stepA_ops("dct-fused"), **kw)
    theirs = jax_foto.solve_potential(jnp.asarray(f1), jnp.asarray(f2), 4,
                                      ops=jax_foto.DCTFusedOps(), **kw)
    assert ours.iteration == int(theirs.iteration) == 8
    np.testing.assert_allclose(ours.phi.numpy(), np.asarray(theirs.phi),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(float(ours.crit), float(theirs.crit),
                               rtol=1e-4)
