"""The CG stepA operator ``-r*L_st(x) + r*eps*x``: CUDA kernel and plain
version.

Counterpart of both TPU forms of the operator: ``cg_operator_pallas``
(ofot_tpu/ops/pallas/kernels.py:495, body :488) and
``cg_operator_pallas_blocked`` (:589, body :528).  On the card one kernel
(``ofot_tpu_torch/csrc/cg_operator.cu``: four consecutive x points a
thread from 16-byte loads where Nx % 4 == 0 and the field is 16-byte
aligned, one point a thread otherwise) serves both entry points; the
blocked form's zero-padded copy, 8-row halo and 8/128 rounding are TPU
tiling rules with no counterpart here.  CPU tensors run
``cg_operator_reference``; any other device, dtype or layout raises.

``launches`` and ``blocked_launches`` count the kernel's launches through
:func:`cg_operator` and :func:`cg_operator_blocked` in this process; only
the CUDA branch of each wrapper changes its count.
"""

from __future__ import annotations

import torch

from ofot_tpu_torch.ops import operators
from ofot_tpu_torch.ops.kernels import _build

launches = 0
blocked_launches = 0


def cg_operator_reference(x: torch.Tensor, r, reg_epsilon) -> torch.Tensor:
    """Plain torch version: the 7-point 'N' space-time Laplacian of
    ``ops/operators.py`` and the axpy."""
    return -r * operators.laplacian_st(x, bc="N") + (r * reg_epsilon) * x


def prepare_launch(x: torch.Tensor, r, reg_epsilon):
    """Check a CUDA operand and allocate the output of one launch.

    Returns ``(enqueue, y)``; ``enqueue()`` puts the kernel on the current
    stream, raises on a launch error and does not count launches."""
    _build.check_cuda(x, "cg_operator")
    _build.check_operand("x", x, x)
    if x.dim() != 3 or min(x.shape) < 2:
        raise ValueError("x must be (Nt, Ny, Nx) with every extent >= 2, got "
                         f"shape {tuple(x.shape)}")
    Nt, Ny, Nx = x.shape
    lib = _build.load_library()
    y = torch.empty_like(x)
    args = (x.data_ptr(), y.data_ptr(), Nt, Ny, Nx, float(r),
            float(r) * float(reg_epsilon), _build.stream_of(x))

    def enqueue():
        _build.check_launch(lib, lib.ofot_cg_operator(*args), "cg_operator")

    enqueue.buffers = (x, y)
    return enqueue, y


def cg_operator(x: torch.Tensor, r=1.0, reg_epsilon=1e-2) -> torch.Tensor:
    """``-r * laplacian_st(x, bc='N') + r*eps*x`` on an (Nt, Ny, Nx) field:
    the counterpart of the whole-array ``cg_operator_pallas``."""
    if x.device.type == "cpu":
        return cg_operator_reference(x, r, reg_epsilon)
    global launches
    enqueue, y = prepare_launch(x, r, reg_epsilon)
    enqueue()
    launches += 1
    return y


def cg_operator_blocked(x: torch.Tensor, r=1.0,
                        reg_epsilon=1e-2) -> torch.Tensor:
    """The same operator, counterpart of ``cg_operator_pallas_blocked``,
    the SpMV of the ``cg-pallas`` stepA set."""
    if x.device.type == "cpu":
        return cg_operator_reference(x, r, reg_epsilon)
    global blocked_launches
    enqueue, y = prepare_launch(x, r, reg_epsilon)
    enqueue()
    blocked_launches += 1
    return y
