"""Exact spectral stepA solve with a hand-written per-slice kernel: CUDA
kernel and plain version.

Counterpart of ``dct_solve_pallas`` (ofot_tpu/ops/pallas/kernels.py:383,
per-slice body ``_dct_solve_slice_kernel`` :355): solves
``(-r*L_st + r*eps*I) phi = F`` on an (Nt, Ny, Nx) field.  As in the JAX
function, the two t-axis contractions with the DCT-II matrix Ct (depth Nt)
are plain matrix products outside the kernel; the per-slice body (y and x
forward transforms, the spectral divide, y and x inverse transforms) is the
CUDA kernel of ``ofot_tpu_torch/csrc/dct_solve.cu`` on CUDA tensors and
``slice_solve_reference`` on CPU tensors.  Any other device, dtype or
layout raises.

The transform matrices and the 1-D eigenvalue vectors are built once per
``(shape, dtype, device, r, eps)`` (:func:`plan`), as ``solvers/dct.py``'s
``StepAPlan`` is.  The divisor is assembled from the 1-D vectors at each
use, as the JAX function does, so no (Nt, Ny, Nx) spectrum exists.  The
plan also holds the contiguous transposes ``CyT`` and ``CxT``, so that the
kernel's four contractions are plain row-major products; the kernel
computes them at float32 accuracy on the tensor cores by 3xTF32.

A lockstep batch, a (B, Nt, Ny, Nx) field with ``r`` one float or a (B,)
tensor of per-pair penalties, is one call over its B*Nt slices: the
t-axis products are batched ``torch.matmul`` and slice ``s`` of the kernel
reads ``lt[s % Nt]`` and pair ``s // Nt``'s r.

``launches`` counts the kernel's launches in this process, one per solve
(the wrapper's one call into the library, which runs the four contractions
as four launches of one GEMM kernel); only the CUDA branch of
:func:`dct_solve` changes it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ofot_tpu_torch.ops.kernels import _build
from ofot_tpu_torch.solvers import dct

launches = 0


# The y/x matrices the kernel takes, in the order of its arguments.
KERNEL_MATRICES = ("Cy", "CyT", "Cx", "CxT")


class Plan(NamedTuple):
    """Everything of one stepA system that does not depend on F."""
    Ct: torch.Tensor    # (Nt, Nt) DCT-II analysis matrices (rows = freqs)
    Cy: torch.Tensor    # (Ny, Ny)
    Cx: torch.Tensor    # (Nx, Nx)
    lt: torch.Tensor    # (Nt,) Neumann eigenvalues in DCT-II order
    ly: torch.Tensor    # (Ny,)
    lx: torch.Tensor    # (Nx,)
    CyT: torch.Tensor   # contiguous Cy.T
    CxT: torch.Tensor   # contiguous Cx.T
    r: float
    reg_epsilon: float


@functools.lru_cache(maxsize=16)
def plan(shape, dtype, device, r: float, reg_epsilon: float) -> Plan:
    """The matrices and eigenvalues of the system ``(-r L_st + r eps I)``
    on an (Nt, Ny, Nx) grid, built once per key."""
    device = torch.device(device)
    Ct, Cy, Cx = (dct._matrix(n, dtype, device) for n in shape)
    eigs = [torch.as_tensor(dct._neumann_eigenvalues_np(n), dtype=dtype,
                            device=device) for n in shape]
    return Plan(Ct, Cy, Cx, *eigs, CyT=Cy.T.contiguous(),
                CxT=Cx.T.contiguous(), r=float(r),
                reg_epsilon=float(reg_epsilon))


def _per_pair(r):
    """``r`` if it is a (B,) tensor of per-pair penalties, else None."""
    return r if isinstance(r, torch.Tensor) and r.dim() > 0 else None


def plan_for(F: torch.Tensor, r, reg_epsilon) -> Plan:
    if F.dim() not in (3, 4):
        raise ValueError(f"F must be (Nt, Ny, Nx) or (B, Nt, Ny, Nx), got "
                         f"shape {tuple(F.shape)}")
    # a per-pair r travels beside the plan (the matrices do not depend on
    # r); the plan then keeps r = 1
    r = 1.0 if _per_pair(r) is not None else float(r)
    return plan(tuple(F.shape[-3:]), F.dtype, F.device, r,
                float(reg_epsilon))


def t_forward(F, p: Plan):
    """``Ct @ F`` along t: the t-axis DCT, outside the kernel."""
    Nt = F.shape[-3]
    return (p.Ct @ F.reshape(*F.shape[:-3], Nt, -1)).reshape(F.shape)


def t_inverse(X, p: Plan):
    """``Ct^T @ X`` along t: the inverse t-axis DCT."""
    Nt = X.shape[-3]
    return (p.Ct.T @ X.reshape(*X.shape[:-3], Nt, -1)).reshape(X.shape)


def slice_solve_reference(Fz: torch.Tensor, p: Plan,
                          r=None) -> torch.Tensor:
    """Plain torch version of the per-slice body: ``Cy @ S @ Cx^T``, the
    divide by ``sb[y, x] + (-r lt[t])``, then ``Cy^T @ (.) @ Cx``.  ``r``:
    a (B,) tensor of per-pair penalties for a (B, Nt, Ny, Nx) batch (None:
    the plan's r for every slice)."""
    if r is None:
        r, reps, rt = p.r, p.r * p.reg_epsilon, p.r
    else:
        r, reps = _build.pair_scalars(r, p.reg_epsilon, Fz)
        rt = r.view(-1, 1)
        r, reps = r.view(-1, 1, 1, 1), reps.view(-1, 1, 1, 1)
    t2 = (p.Cy @ Fz) @ p.Cx.T
    sb = -r * (p.ly[:, None] + p.lx[None, :]) + reps
    t2 = t2 / (sb + (-rt * p.lt)[..., :, None, None])
    return (p.Cy.T @ t2) @ p.Cx


def dct_solve_reference(F: torch.Tensor, r, reg_epsilon) -> torch.Tensor:
    """Plain torch version of :func:`dct_solve`: the t-forward product, the
    per-slice body with ``torch.matmul``, the t-inverse product.  A batch
    on the CPU goes pair by pair, each pair as a single solve, so that it
    gets a single solve's bits (``solvers/dct.py:_transform`` says why)."""
    if F.dim() == 4 and F.device.type == "cpu":
        rs = _per_pair(r)
        return torch.stack([dct_solve_reference(
            f, r if rs is None else float(rs[i]), reg_epsilon)
            for i, f in enumerate(F)])
    p = plan_for(F, r, reg_epsilon)
    return t_inverse(slice_solve_reference(t_forward(F, p), p, _per_pair(r)),
                     p)


def prepare_launch(Fz: torch.Tensor, p: Plan, r=None):
    """Check a CUDA operand (the t-transformed field, (Nt, Ny, Nx) or a
    (B, Nt, Ny, Nx) batch) and allocate the output and scratch of one
    launch of the per-slice kernel.  ``r``: a (B,) tensor of per-pair
    penalties (None: the plan's r for every pair).

    Returns ``(enqueue, out)``; ``enqueue()`` puts the kernel's four
    launches on the current stream, raises on a launch error and does not
    count launches."""
    _build.check_cuda(Fz, "dct_solve")
    _build.check_operand("Fz", Fz, Fz)
    if Fz.dim() not in (3, 4) or Fz.numel() == 0 \
            or Fz.numel() // (Fz.shape[-2] * Fz.shape[-1]) > 65535:
        raise ValueError("Fz must be a non-empty (Nt, Ny, Nx) field or "
                         "(B, Nt, Ny, Nx) batch of at most 65535 slices, got "
                         f"shape {tuple(Fz.shape)}")
    for name in (*KERNEL_MATRICES, "lt", "ly", "lx"):
        t = getattr(p, name)
        if t.device != Fz.device or t.dtype != torch.float32:
            raise ValueError(f"the plan's {name} is {t.dtype} on {t.device}, "
                             f"Fz float32 on {Fz.device}")
    Nt, Ny, Nx = Fz.shape[-3:]
    batch = Fz.shape[0] if Fz.dim() == 4 else 1
    if p.Cy.shape != (Ny, Ny) or p.Cx.shape != (Nx, Nx) \
            or p.lt.shape != (Nt,):
        raise ValueError(f"the plan does not fit Fz of shape {(Nt, Ny, Nx)}")
    rs = reps = None
    if r is not None:
        rs, reps = (t.contiguous() for t in
                    _build.pair_scalars(r, p.reg_epsilon, Fz))
    lib = _build.load_library()
    out = torch.empty_like(Fz)
    tmp = torch.empty_like(Fz)
    args = (Fz.data_ptr(), out.data_ptr(), tmp.data_ptr(),
            *(getattr(p, name).data_ptr() for name in KERNEL_MATRICES),
            p.lt.data_ptr(), p.ly.data_ptr(), p.lx.data_ptr(), batch, Nt,
            Ny, Nx, p.r, p.r * p.reg_epsilon,
            None if rs is None else rs.data_ptr(),
            None if reps is None else reps.data_ptr(), _build.stream_of(Fz))

    def enqueue():
        _build.check_launch(lib, lib.ofot_dct_solve(*args), "dct_solve")

    enqueue.buffers = (Fz, out, tmp, p, rs, reps)
    return enqueue, out


def dct_solve(F: torch.Tensor, r, reg_epsilon) -> torch.Tensor:
    """Exact solve of ``(-r*L_st + r*eps*I) phi = F`` on an (Nt, Ny, Nx)
    field, or a (B, Nt, Ny, Nx) batch with ``r`` one float or a (B,)
    tensor, in the DCT-II basis.

    CUDA tensors: the t-axis products with ``torch.matmul`` (fp32, TF32 off)
    and the per-slice body in the CUDA kernel (float32, contiguous, else it
    raises).  CPU tensors: :func:`dct_solve_reference`."""
    if F.device.type == "cpu":
        return dct_solve_reference(F, r, reg_epsilon)
    _build.check_cuda(F, "dct_solve")
    _build.check_operand("F", F, F)
    global launches
    p = plan_for(F, r, reg_epsilon)
    enqueue, out = prepare_launch(t_forward(F, p), p, _per_pair(r))
    enqueue()
    launches += 1
    return t_inverse(out, p)
