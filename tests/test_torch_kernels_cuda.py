"""The fused stepB/stepC/criterion CUDA kernel against its plain torch
version, on the card (marker ``cuda``; skipped without one).

This file imports neither JAX nor ``ofot_tpu``, so it runs where the card
is, without the repository's conftest (which sets JAX up):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

The kernel takes cbrtf/acosf where the plain version takes the Pallas
kernel's exp/log and Newton forms, and nvcc fuses multiply-adds, so
elementwise agreement is atol 2e-5 / rtol 1e-5 (a few hundred float32 ulps
on O(1) values) and the criterion sums agree to rtol 1e-5 (the same
float32 products summed in another order).
"""

import numpy as np
import pytest
import torch

from ofot_tpu_torch.ops.kernels import fused_pointwise as fp

RNG = np.random.default_rng(37)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(ncomp, shape, relaxed, device):
    full = (ncomp,) + shape
    arrs = [RNG.uniform(-2, 2, full), RNG.uniform(-1, 2, full),
            RNG.uniform(-2, 1, full) if relaxed else None]
    return [None if a is None else
            torch.from_numpy(a.astype(np.float32)).to(device) for a in arrs]


def _assert_close(got, want):
    for a, b, name in zip(got[:2], want[:2], ("q", "mu")):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=1e-5, msg=name)
    for a, b, name in zip(got[2:], want[2:], ("num", "den")):
        torch.testing.assert_close(a, b, atol=0, rtol=1e-5, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("ncomp", [3, 4])
@pytest.mark.parametrize("alpha", [None, 1.7])
def test_kernel_matches_plain_version_on_card(cuda_device, ncomp, alpha):
    t = _inputs(ncomp, (16, 48, 64), alpha is not None, cuda_device)
    before = fp.launches
    got = fp.fused_pointwise(t[0], t[1], 1.3, alpha=alpha, q_prev=t[2])
    again = fp.fused_pointwise(t[0], t[1], 1.3, alpha=alpha, q_prev=t[2])
    torch.cuda.synchronize()
    assert fp.launches == before + 2
    want = fp.fused_pointwise_reference(t[0], t[1], 1.3, alpha, t[2])
    _assert_close(got, want)
    # the two-stage reduction is deterministic
    assert torch.equal(got[2], again[2]) and torch.equal(got[3], again[3])


@pytest.mark.cuda
def test_kernel_rejects_bad_operands_on_card(cuda_device):
    g = torch.zeros(3, 4, 5, 6, device=cuda_device)
    with pytest.raises(TypeError):
        fp.fused_pointwise(g.double(), g.double(), 1.0)
    with pytest.raises(ValueError):
        fp.fused_pointwise(g, g.transpose(-1, -2).contiguous().transpose(
            -1, -2), 1.0)
    with pytest.raises(ValueError):
        fp.fused_pointwise(torch.zeros(2, 4, device=cuda_device),
                           torch.zeros(2, 4, device=cuda_device), 1.0)
