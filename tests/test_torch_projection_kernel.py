"""The standalone paraboloid projection kernel's module.

On the CPU: the plain version ``project_paraboloid_reference`` against the
Pallas kernel ``project_paraboloid_pallas`` in interpret mode (as
tests/test_pallas.py runs it), for k = 2 and 3, on float32 inputs from a
numpy seed, at tests/test_pallas.py's atol 2e-6 / rtol 1e-5 (float32
rounding of the same arithmetic).  At float64 the plain version agrees
with ``ops/projection.py``'s direct cbrt/acos forms to 1e-12.

The CUDA kernel itself is held against the plain version on the card in
tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl

from ofot_tpu.ops.pallas import kernels
from ofot_tpu_torch.ops.kernels import projection as pk
from ofot_tpu_torch.ops.projection import (project_paraboloid,
                                           project_paraboloid_nd)
from ofot_tpu_torch.solvers import foto

RNG = np.random.default_rng(47)


@pytest.fixture
def _interpret_mode(monkeypatch):
    real_call = pl.pallas_call

    def patched(*a, **kw):
        kw.setdefault("interpret", True)
        return real_call(*a, **kw)

    monkeypatch.setattr(kernels.pl, "pallas_call", patched)


@pytest.mark.usefixtures("_interpret_mode")
@pytest.mark.parametrize("ncomp", [3, 4])
# (8, 16, 24): L = 3072, the Pallas kernel's exact tiling; (8, 15, 6): its
# padded chunk
@pytest.mark.parametrize("shape", [(8, 16, 24), (8, 15, 6)])
def test_reference_matches_pallas_interpret(ncomp, shape):
    p = RNG.uniform(-4, 3, (ncomp,) + shape).astype(np.float32)
    got = pk.project_paraboloid(torch.from_numpy(p))
    want = np.asarray(kernels.project_paraboloid_pallas(jnp.asarray(p)))
    assert got.dtype == torch.float32 and got.shape == p.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("ncomp,direct", [(3, project_paraboloid),
                                          (4, project_paraboloid_nd)])
def test_reference_matches_direct_forms_float64(ncomp, direct):
    p = torch.from_numpy(RNG.uniform(-4, 3, (ncomp, 5, 6, 7)))
    torch.testing.assert_close(pk.project_paraboloid_reference(p),
                               direct(p), rtol=0, atol=1e-12)


def test_points_inside_are_left_alone():
    p = torch.tensor([[-1.0, -3.0, 0.0], [0.5, 1.0, 0.0],
                      [0.5, -2.0, 0.0]])          # a + |b|^2/2 <= 0
    torch.testing.assert_close(pk.project_paraboloid(p), p, rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_version_without_counting():
    p = torch.from_numpy(RNG.uniform(-4, 3, (4, 3, 5)).astype(np.float32))
    before = pk.launches
    torch.testing.assert_close(pk.project_paraboloid(p),
                               pk.project_paraboloid_reference(p),
                               rtol=0, atol=0)
    assert pk.launches == before


def test_bad_component_count_raises():
    with pytest.raises(ValueError, match="k in"):
        pk.project_paraboloid(torch.zeros(5, 3, 4))


def test_other_devices_raise():
    with pytest.raises(ValueError, match="cuda or cpu"):
        pk.project_paraboloid(torch.zeros(3, 4, 5, device="meta"))


def test_ops_sets_wire_the_projections():
    """pallas projects with the kernel module (both component counts, as
    the JAX PallasOps does); the other sets with ops/projection.py."""
    pallas = foto.stepA_ops("pallas")
    assert pallas.project is pk.project_paraboloid
    assert pallas.project_nd is pk.project_paraboloid
    for name in ("cg", "dct", "dct-fused", "cg-pallas"):
        ops = foto.stepA_ops(name)
        assert ops.project is project_paraboloid
        assert ops.project_nd is project_paraboloid_nd
