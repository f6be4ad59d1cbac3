"""The CG stepA operator ``-r*L_st(x) + r*eps*x`` and the ``cg-pallas``
set.

On the CPU both entry points, ``cg_operator`` and ``cg_operator_blocked``,
run the plain version; it is held against the Pallas kernels
``cg_operator_pallas`` and ``cg_operator_pallas_blocked`` in interpret mode
(as tests/test_pallas.py runs them) on float32 inputs from a numpy seed, to
1e-5 absolute (tests/test_pallas.py's bound: the same 7-point stencil, its
sums in another order).

A short ALG2 run under the port's ``cg-pallas`` set is held against the
JAX package's ``PallasCGOps`` at float64, with every CG solve run to its
tolerance: the state agrees to 1e-7 and the CG step counts to one step a
solve, the bounds tests/test_torch_foto.py holds the ``cg`` set to (CG's
dot products sum in another order, and a residual on the threshold may stop
one step apart).  A solve cut off by ``cg_maxiter`` is no test of the
operator: its iterate depends on roundoff far more than the solution does
(cut at 50 steps, the two packages' plain ``cg`` sets differ by 4e-5 after
one ALG2 iteration on this pair, against 1e-9 when run to tolerance).

The CUDA kernel itself is held against the plain version on the card in
tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl

from ofot_tpu.ops.pallas import kernels
from ofot_tpu.solvers import foto as jax_foto
from ofot_tpu_torch.ops.kernels import cg_operator as cgk
from ofot_tpu_torch.solvers import foto

import fixtures

RNG = np.random.default_rng(43)

ENTRIES = {
    "cg_operator": (cgk.cg_operator, lambda x, r, eps:
                    kernels.cg_operator_pallas(x, r=r, reg_epsilon=eps)),
    "cg_operator_blocked": (cgk.cg_operator_blocked,
                            kernels.cg_operator_pallas_blocked),
}


@pytest.fixture
def _interpret_mode(monkeypatch):
    real_call = pl.pallas_call

    def patched(*a, **kw):
        kw.setdefault("interpret", True)
        return real_call(*a, **kw)

    monkeypatch.setattr(kernels.pl, "pallas_call", patched)


@pytest.mark.usefixtures("_interpret_mode")
@pytest.mark.parametrize("entry", sorted(ENTRIES))
@pytest.mark.parametrize("shape", [(6, 16, 24), (5, 17, 23), (4, 48, 40)])
@pytest.mark.parametrize("r,eps", [(1.0, 1e-2), (0.7, 1e-3)])
def test_entry_matches_pallas_interpret(entry, shape, r, eps):
    ours, theirs = ENTRIES[entry]
    x = RNG.standard_normal(shape).astype(np.float32)
    got = ours(torch.from_numpy(x), r, eps)
    want = np.asarray(theirs(jnp.asarray(x), r, eps))
    assert got.dtype == torch.float32 and got.shape == shape
    assert float(np.abs(got.numpy() - want).max()) < 1e-5


def test_boundary_rows_are_the_reference_N_rows():
    """Row 0 of each axis is -x0 + x1 and the last -x_last + x_prev: on a
    field that varies along one axis only, the operator is that axis's 1-D
    'N' Laplacian (float64, exact arithmetic on small integers)."""
    v = torch.tensor([1.0, 4.0, 9.0, 16.0], dtype=torch.float64)
    lap = torch.tensor([3.0, 2.0, 2.0, -7.0], dtype=torch.float64)
    for axis in range(3):
        shape = [3, 3, 3]
        shape[axis] = 4
        view = [1, 1, 1]
        view[axis] = 4
        x = v.reshape(view).expand(shape).contiguous()
        got = cgk.cg_operator(x, 2.0, 0.5)
        want = (-2.0 * lap + 1.0 * v).reshape(view).expand(shape)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_version_without_counting():
    x = torch.from_numpy(RNG.standard_normal((3, 4, 5)).astype(np.float32))
    before = (cgk.launches, cgk.blocked_launches)
    a = cgk.cg_operator(x, 1.0, 1e-2)
    b = cgk.cg_operator_blocked(x, 1.0, 1e-2)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(a, cgk.cg_operator_reference(x, 1.0, 1e-2),
                               rtol=0, atol=0)
    assert (cgk.launches, cgk.blocked_launches) == before


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_other_devices_raise(entry):
    x = torch.zeros(3, 4, 5, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ENTRIES[entry][0](x, 1.0, 1e-2)


def test_cg_pallas_set_uses_the_blocked_entry(monkeypatch):
    calls = []
    real = cgk.cg_operator_blocked

    def spy(x, r, eps):
        calls.append((r, eps))
        return real(x, r, eps)

    # the set names the blocked entry in its kernel table, for the
    # single-pair and the lockstep form alike
    blocked = foto.PallasCGOps.kernels.cg_operator
    assert blocked == (cgk.cg_operator_blocked, cgk.cg_operator_blocked)
    monkeypatch.setattr(foto.PallasCGOps, "kernels",
                        foto.Kernels(cg_operator=(spy, spy)))
    ops = foto.stepA_ops("cg-pallas")
    F = torch.from_numpy(RNG.standard_normal((3, 4, 5)))
    phi, n = ops.stepA_solve(F, 1.0, 1e-2, 1e-6, 1000)
    assert isinstance(ops, foto.PallasCGOps)
    assert len(calls) == n > 0 and calls[0] == (1.0, 1e-2)
    torch.testing.assert_close(
        cgk.cg_operator_reference(phi, 1.0, 1e-2), F, rtol=0, atol=1e-5)


@pytest.mark.usefixtures("_interpret_mode")
def test_cg_pallas_alg2_matches_jax():
    """A short CG-stepA ALG2 run under the port's cg-pallas set tracks the
    JAX package's PallasCGOps (as tests/test_pallas.py:143 runs it)."""
    f1, f2 = fixtures.smooth_blob_pair(16, 24, dtype=np.float64)
    kw = dict(r=1.0, reg_epsilon=1e-2, convergence_tol=0.0, max_it=5,
              admm_alpha=1.7)
    ours = foto.solve_potential(torch.from_numpy(f1), torch.from_numpy(f2),
                                4, ops=foto.stepA_ops("cg-pallas"), **kw)
    theirs = jax_foto.solve_potential(jnp.asarray(f1), jnp.asarray(f2), 4,
                                      ops=jax_foto.stepA_ops("cg-pallas"),
                                      **kw)
    assert ours.iteration == int(theirs.iteration) == 5
    assert abs(ours.cg_iterations - int(theirs.cg_iterations)) <= 5
    for name in ("mu", "q", "phi"):
        np.testing.assert_allclose(getattr(ours, name).numpy(),
                                   np.asarray(getattr(theirs, name)),
                                   rtol=0, atol=1e-7, err_msg=name)
    np.testing.assert_allclose(float(ours.crit), float(theirs.crit),
                               rtol=1e-5)
