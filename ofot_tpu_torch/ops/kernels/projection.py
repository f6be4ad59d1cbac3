"""Standalone paraboloid projection: CUDA kernel and plain version.

Counterpart of ``project_paraboloid_pallas`` (ofot_tpu/ops/pallas/
kernels.py:193, kernel body :130, points :95 and :113).
``project_paraboloid`` launches the CUDA kernel of
``ofot_tpu_torch/csrc/projection.cu`` on CUDA tensors and runs
``project_paraboloid_reference``, the plain torch version, on CPU tensors;
any other device, dtype or layout raises.

No ALG2 path of the port calls it, as none of the JAX package's does: the
``pallas`` ops set, whose ``project``/``project_nd`` it is, always takes
the fused pass instead.

``launches`` counts the kernel's launches in this process; only the CUDA
branch of the wrapper changes it.
"""

from __future__ import annotations

import torch

from ofot_tpu_torch.ops.kernels import _build
from ofot_tpu_torch.ops.kernels.fused_pointwise import (
    _EPS, _project_core, _project_point_nd)

launches = 0


def _project_point(alpha, beta1, beta2):
    """The Pallas kernel's k = 2 point (kernels.py:95-110): the projected
    betas are ``rho_h`` times the unit direction (cos, sin)."""
    rho2 = beta1 * beta1 + beta2 * beta2
    rho = torch.sqrt(rho2)
    safe_rho = torch.clamp(rho, min=_EPS)
    cos_t = torch.where(rho > 0, beta1 / safe_rho, 1.0)
    sin_t = torch.where(rho > 0, beta2 / safe_rho, 0.0)
    inside, alpha_h, rho_h = _project_core(alpha, rho2)
    return (torch.where(inside, alpha, alpha_h),
            torch.where(inside, beta1, rho_h * cos_t),
            torch.where(inside, beta2, rho_h * sin_t))


def project_paraboloid_reference(p: torch.Tensor) -> torch.Tensor:
    """Plain torch version, in the Pallas kernel's arithmetic: the cos/sin
    form for k = 2, the rescaled-betas form for k = 3."""
    if p.shape[0] == 3:
        return torch.stack(_project_point(p[0], p[1], p[2]))
    alpha, betas = _project_point_nd(p[0], p[1:])
    return torch.cat([alpha[None], betas])


def prepare_launch(p: torch.Tensor):
    """Check a CUDA operand and allocate the output of one launch.

    Returns ``(enqueue, out)``; ``enqueue()`` puts the kernel on the current
    stream, raises on a launch error and does not count launches."""
    _build.check_cuda(p, "project_paraboloid")
    _build.check_operand("p", p, p)
    L = p.numel() // p.shape[0] if p.dim() >= 2 else 0
    if p.shape[0] not in (3, 4) or L == 0:
        raise ValueError("p must be (1+k, ...) with k in {2, 3} and at least "
                         f"one point, got shape {tuple(p.shape)}")
    lib = _build.load_library()
    out = torch.empty_like(p)
    args = (p.data_ptr(), out.data_ptr(), p.shape[0], L, _build.stream_of(p))

    def enqueue():
        _build.check_launch(lib, lib.ofot_project_paraboloid(*args),
                            "project_paraboloid")

    enqueue.buffers = (p, out)
    return enqueue, out


def project_paraboloid(p: torch.Tensor) -> torch.Tensor:
    """Project every point of ``p`` (1+k, ...) with k = 2 or 3 onto
    ``a + |b|^2 / 2 <= 0``; returns the same shape.

    CUDA tensors go to the kernel (float32, contiguous, else it raises);
    CPU tensors to :func:`project_paraboloid_reference`."""
    if p.device.type == "cpu":
        if p.shape[0] not in (3, 4):
            raise ValueError("p must be (1+k, ...) with k in {2, 3}, got "
                             f"shape {tuple(p.shape)}")
        return project_paraboloid_reference(p)
    global launches
    enqueue, out = prepare_launch(p)
    enqueue()
    launches += 1
    return out
