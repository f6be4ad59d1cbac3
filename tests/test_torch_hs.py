"""The port's Horn–Schunck solver vs ofot_tpu.solvers.hs on the same
float64 inputs: the same CG step count within one and fields within 1e-8
(both run CG to rtol 1e-10; their dot products sum in another order), and
the dense solve at tests/test_hs.py's 1e-6."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ofot_tpu.solvers import hs as jax_hs
from ofot_tpu_torch.solvers import hs

import fixtures
from test_gn import dense_gn_system


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("precond", ["spectral", "jacobi"])
@pytest.mark.parametrize("pair", ["blob", "square"])
def test_solve_fields_matches_jax(precond, pair):
    f1, f2 = (fixtures.smooth_blob_pair(12, 14) if pair == "blob"
              else fixtures.translating_square(20))
    ours = hs.solve_fields(*_t(f1, f2), 0.1, precond=precond)
    theirs = jax_hs.solve_fields(jnp.asarray(f1), jnp.asarray(f2), 0.1,
                                 precond=precond)
    assert abs(ours.cg.iterations - int(theirs.cg.iterations)) <= 1
    assert ours.cg.converged and bool(theirs.cg.converged)
    for k in ("u", "v"):
        np.testing.assert_allclose(getattr(ours, k).numpy(),
                                   np.asarray(getattr(theirs, k)), rtol=0,
                                   atol=1e-8, err_msg=k)


def test_matches_dense_solve():
    f1, f2 = fixtures.smooth_blob_pair(12, 14)
    Z, b = dense_gn_system(f1, f2, 0.1, 1.0)
    n = 12 * 14
    want = np.linalg.solve(Z[:2 * n, :2 * n], b[:2 * n]).reshape(2, 12, 14)
    res = hs.solve_fields(*_t(f1, f2), 0.1)
    np.testing.assert_allclose(np.stack([res.u.numpy(), res.v.numpy()]),
                               want, atol=1e-6)


def test_preconditioners_agree():
    f1, f2 = fixtures.translating_square(20)
    a = hs.solve_fields(*_t(f1, f2), precond="spectral")
    b = hs.solve_fields(*_t(f1, f2), precond="jacobi")
    np.testing.assert_allclose(a.u.numpy(), b.u.numpy(), atol=1e-7)


def test_identical_frames_zero_flow():
    f1, _ = fixtures.smooth_blob_pair(10, 10)
    r = hs.solve_fields(*_t(f1, f1))
    assert float(r.u.abs().max()) < 1e-8


def test_hs_spectral_precond_handles_vanishing_gradients():
    y = np.mgrid[0:16, 0:20][0].astype(np.float32)
    f1 = torch.from_numpy(np.sin(y / 3) * 0.25 + 0.5)
    res = hs.solve_fields(f1, f1 * 1.01)
    assert torch.isfinite(res.u).all() and torch.isfinite(res.v).all()
