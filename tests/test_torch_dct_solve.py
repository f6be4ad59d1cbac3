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

The kernel computes by 3xTF32 on the tensor cores.  What of that the CPU
can check is held here: the plan's contiguous transposes, and a numpy
emulation of the kernel's slice body (both operands split into TF32 high
and low parts, round-to-nearest with ties away from zero as
``cvt.rna.tf32.f32``; each 32-deep k-tile summed as small@big + big@small +
big@big in float32 and added into the running sum) within the kernel's
5e-6 of the float32 plain version.  One TF32 pass is far outside it.
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


# ------------------------------------------------ 3xTF32 emulation

K_TILE = 32     # the kernel's k-tile: its partial sums are added in float32


def _rna_tf32_np(a):
    """numpy float32 -> TF32 values, to nearest, ties away from zero."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _split_np(a):
    big = _rna_tf32_np(a)
    return big, _rna_tf32_np(a - big)


def _mm_3xtf32(a, b):
    """The kernel's product of two float32 operands: both split, each
    k-tile summed as small@big + big@small + big@big, the k-tiles' sums
    added in float32."""
    acc = np.float32(0)
    for k0 in range(0, a.shape[-1], K_TILE):
        (ab, as_), (bb, bs) = (_split_np(a[..., k0:k0 + K_TILE]),
                               _split_np(b[..., k0:k0 + K_TILE, :]))
        part = np.matmul(as_, bb)
        part = part + np.matmul(ab, bs)
        acc = acc + (part + np.matmul(ab, bb))
    return acc


def _mm_1xtf32(a, b):
    """One TF32 pass: big@big alone."""
    return np.matmul(_rna_tf32_np(a), _rna_tf32_np(b))


def _emulated_slice_body(Fz, p, mm):
    """The kernel's four contractions and divide, with ``mm`` for each
    product."""
    r, eps = p.r, p.reg_epsilon
    Cy, CyT, Cx, CxT = (getattr(p, n).numpy() for n in ds.KERNEL_MATRICES)
    lt, ly, lx = p.lt.numpy(), p.ly.numpy(), p.lx.numpy()
    sb = np.float32(-r) * (ly[:, None] + lx[None, :]) + np.float32(r * eps)
    div = sb + (np.float32(-r) * lt)[:, None, None]
    t2 = mm(mm(Cy, Fz.numpy()), CxT) / div
    return mm(mm(CyT, t2), Cx)


def test_plan_stores_contiguous_transposes():
    for dtype in (torch.float32, torch.float64):
        p = ds.plan((3, 7, 12), dtype, torch.device("cpu"), 1.0, 1e-2)
        for name, mat in (("CyT", p.Cy), ("CxT", p.Cx)):
            t = getattr(p, name)
            assert t.is_contiguous() and t.dtype == dtype
            torch.testing.assert_close(t, mat.T, rtol=0, atol=0)


def test_emulated_tf32_rounding_is_cvt_rna():
    """The emulation rounds as cvt.rna.tf32.f32: 10 mantissa bits kept, to
    nearest, ties away from zero; the split reconstructs to 2^-21."""
    bits = np.array([0x3F801000, 0xBF801000, 0x3F800FFF, 0x3F803000,
                     0x00000000, 0x80000000], dtype=np.uint32)
    want = np.array([0x3F802000, 0xBF802000, 0x3F800000, 0x3F804000,
                     0x00000000, 0x80000000], dtype=np.uint32)
    np.testing.assert_array_equal(
        _rna_tf32_np(bits.view(np.float32)).view(np.uint32), want)
    a = RNG.standard_normal(1000).astype(np.float32)
    big, small = _split_np(a)
    for part in (big, small):
        assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()
    rebuilt = big.astype(np.float64) + small.astype(np.float64)
    assert (np.abs(rebuilt - a) <= 2.0 ** -21 * np.abs(a)).all()


@pytest.mark.parametrize("r,eps", [(1.0, 1e-2), (0.3, 1e-3)])
def test_3xtf32_slice_body_emulation_is_within_kernel_tolerance(r, eps):
    """The kernel's arithmetic, emulated, against the float32 plain version
    of the slice body, at the kernel's tolerance (5e-6 of max|phi|)."""
    shape = (8, 48, 64)
    F = torch.from_numpy(RNG.standard_normal(shape).astype(np.float32))
    p = ds.plan(shape, torch.float32, torch.device("cpu"), r, eps)
    Fz = ds.t_forward(F, p)
    want = ds.slice_solve_reference(Fz, p).numpy()
    errs = {}
    for name, mm in (("3xtf32", _mm_3xtf32), ("1xtf32", _mm_1xtf32)):
        got = _emulated_slice_body(Fz, p, mm)
        assert got.dtype == np.float32
        errs[name] = float(np.abs(got - want).max() / np.abs(want).max())
    assert errs["3xtf32"] < 5e-6, errs
    # one TF32 pass is far outside it: the split is what keeps float32
    assert errs["1xtf32"] > 5e-5, errs
