"""The fused stepB + stepC + criterion pass of the port.

On the CPU: the plain version ``fused_pointwise_reference`` against the
Pallas kernel ``fused_pointwise_pallas`` in interpret mode (as
tests/test_pallas.py runs it), for k = 2 and 3 and alpha in {1, 1.7}, on
float32 inputs from a numpy seed.  Tolerances: elementwise atol 2e-6 /
rtol 1e-5 (tests/test_pallas.py's, float32 rounding of the same
arithmetic); the criterion sums rtol 1e-5 — the same float32 products
summed in another order (tile partials against torch's pairwise sum).

The CUDA kernel itself is held against the plain version on the card in
tests/test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl

from ofot_tpu.ops.pallas import kernels
from ofot_tpu_torch.ops.kernels import _build
from ofot_tpu_torch.ops.kernels import fused_pointwise as fp
from ofot_tpu_torch.ops.projection import project_paraboloid_nd

RNG = np.random.default_rng(31)


@pytest.fixture
def _interpret_mode(monkeypatch):
    """Run pallas_call in interpreter mode on CPU."""
    real_call = pl.pallas_call

    def patched(*a, **kw):
        kw.setdefault("interpret", True)
        return real_call(*a, **kw)

    monkeypatch.setattr(kernels.pl, "pallas_call", patched)


def _inputs(ncomp, shape=(4, 10, 18), relaxed=False, dtype=np.float32):
    full = (ncomp,) + shape
    g = RNG.uniform(-2, 2, full).astype(dtype)
    m = RNG.uniform(-1, 2, full).astype(dtype)
    qp = RNG.uniform(-2, 1, full).astype(dtype) if relaxed else None
    return g, m, qp


def _assert_fields(got, want, atol, rtol):
    for a, b, name in zip(got[:2], want[:2], ("q", "mu")):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                                   rtol=rtol, err_msg=name)
    for a, b, name in zip(got[2:], want[2:], ("num", "den")):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5,
                                   err_msg=name)


@pytest.mark.usefixtures("_interpret_mode")
@pytest.mark.parametrize("ncomp", [3, 4])
@pytest.mark.parametrize("alpha", [None, 1.7])
@pytest.mark.parametrize("r", [1.0, 1.3])
def test_reference_matches_pallas_interpret(ncomp, alpha, r):
    g, m, qp = _inputs(ncomp, relaxed=alpha is not None)
    t = [None if a is None else torch.from_numpy(a) for a in (g, m, qp)]
    got = fp.fused_pointwise(t[0], t[1], r, alpha=alpha, q_prev=t[2])
    want = kernels.fused_pointwise_pallas(
        jnp.asarray(g), jnp.asarray(m), r, alpha=alpha,
        q_prev=None if qp is None else jnp.asarray(qp))
    assert got[0].dtype == torch.float32 and got[0].shape == g.shape
    _assert_fields([x.numpy() for x in got], want, atol=2e-6, rtol=1e-5)


@pytest.mark.usefixtures("_interpret_mode")
def test_reference_matches_pallas_at_padded_length():
    """L = 64000 takes the Pallas kernel's padded chunking."""
    g, m, _ = _inputs(3, shape=(16, 80, 50))
    got = fp.fused_pointwise(torch.from_numpy(g), torch.from_numpy(m), 1.0)
    want = kernels.fused_pointwise_pallas(jnp.asarray(g), jnp.asarray(m), 1.0)
    _assert_fields([x.numpy() for x in got], want, atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("ncomp", [3, 4])
def test_reference_matches_unfused_float64(ncomp):
    """At float64 the plain version agrees with the unfused stepB/stepC/
    criterion of foto.alg2_iteration (exp/log and Newton forms against
    the direct cbrt/acos forms of ops/projection.py)."""
    g, m, qp = _inputs(ncomp, relaxed=True, dtype=np.float64)
    g, m, qp = map(torch.from_numpy, (g, m, qp))
    r, alpha = 1.3, 1.7
    q, mu, num, den = fp.fused_pointwise(g, m, r, alpha=alpha, q_prev=qp)
    x = alpha * g + (1 - alpha) * qp
    q_want = project_paraboloid_nd(x + m / r)
    mu_want = m + r * (x - q_want)
    mu_want[0].clamp_(min=0.0)
    speed2 = (g[1:] ** 2).sum(0)
    torch.testing.assert_close(q, q_want, rtol=0, atol=1e-12)
    torch.testing.assert_close(mu, mu_want, rtol=0, atol=1e-12)
    torch.testing.assert_close(
        num, torch.sum(mu_want[0] * torch.abs(g[0] + 0.5 * speed2)),
        rtol=1e-12, atol=0)
    torch.testing.assert_close(den, torch.sum(mu_want[0] * speed2),
                               rtol=1e-12, atol=0)


def test_alpha_without_q_prev_raises():
    g = torch.zeros(3, 2, 3, 4)
    with pytest.raises(ValueError, match="alpha given without q_prev"):
        fp.fused_pointwise(g, g, 1.0, alpha=1.7)


def test_q_prev_without_alpha_raises():
    g = torch.zeros(3, 2, 3, 4)
    with pytest.raises(ValueError, match="q_prev given without alpha"):
        fp.fused_pointwise(g, g, 1.0, q_prev=g)


def test_cpu_tensors_take_the_plain_version_without_counting():
    g, m, _ = _inputs(3)
    before = fp.launches
    fp.fused_pointwise(torch.from_numpy(g), torch.from_numpy(m), 1.0)
    assert fp.launches == before


def test_other_devices_raise():
    g = torch.zeros(3, 2, 3, 4, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fp.fused_pointwise(g, g, 1.0)


def test_build_command_is_plain_nvcc_for_sm90a():
    assert _build.NVCC_FLAGS[:2] == ("-gencode",
                                     "arch=compute_90a,code=sm_90a")
    assert "-shared" in _build.NVCC_FLAGS
    assert [s.name for s in _build.sources()] == ["fused_pointwise.cu"]
    assert _build.BUILD_DIR.name == "_build"
    src = (_build.SRC_DIR / "fused_pointwise.cu").read_text()
    assert "torch/" not in src and 'extern "C"' in src
