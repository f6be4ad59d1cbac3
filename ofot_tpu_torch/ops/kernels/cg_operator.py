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

Both entry points also take a lockstep batch, a (B, Nt, Ny, Nx) field
with ``r`` one float or a (B,) tensor of per-pair penalties: one launch
for the whole batch, with the 'N' time rows at each pair's own first and
last plane.

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
    ``ops/operators.py`` and the axpy, on one field or a batch."""
    r, reps = _build.pair_scalars(r, reg_epsilon, x)
    if isinstance(r, torch.Tensor):
        r, reps = r.view(-1, 1, 1, 1), reps.view(-1, 1, 1, 1)
    return -r * operators.laplacian_st(x, bc="N") + reps * x


def prepare_launch(x: torch.Tensor, r, reg_epsilon):
    """Check a CUDA operand ((Nt, Ny, Nx), or a (B, Nt, Ny, Nx) batch) and
    allocate the output of one launch.

    Returns ``(enqueue, y)``; ``enqueue()`` puts the kernel on the current
    stream, raises on a launch error and does not count launches."""
    _build.check_cuda(x, "cg_operator")
    _build.check_operand("x", x, x)
    if x.dim() not in (3, 4) or min(x.shape[-3:]) < 2 or x.numel() == 0:
        raise ValueError("x must be (Nt, Ny, Nx) or (B, Nt, Ny, Nx) with "
                         f"every extent >= 2, got shape {tuple(x.shape)}")
    batch = x.shape[0] if x.dim() == 4 else 1
    Nt, Ny, Nx = x.shape[-3:]
    r, reps = _build.pair_scalars(r, reg_epsilon, x)
    pairs = isinstance(r, torch.Tensor)
    if pairs:
        r, reps = r.contiguous(), reps.contiguous()
    lib = _build.load_library()
    y = torch.empty_like(x)
    args = (x.data_ptr(), y.data_ptr(), batch, Nt, Ny, Nx,
            1.0 if pairs else float(r), 1.0 if pairs else float(reps),
            r.data_ptr() if pairs else None,
            reps.data_ptr() if pairs else None, _build.stream_of(x))

    def enqueue():
        _build.check_launch(lib, lib.ofot_cg_operator(*args), "cg_operator")

    enqueue.buffers = (x, y, r, reps)
    return enqueue, y


def cg_operator(x: torch.Tensor, r=1.0, reg_epsilon=1e-2) -> torch.Tensor:
    """``-r * laplacian_st(x, bc='N') + r*eps*x`` on an (Nt, Ny, Nx) field
    or a (B, Nt, Ny, Nx) batch: the counterpart of the whole-array
    ``cg_operator_pallas``."""
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
