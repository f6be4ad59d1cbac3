"""Space-time stencils of the ALG2 loop: CUDA kernels and plain versions.

Two kernels of ``ofot_tpu_torch/csrc/stencil_st.cu``, each one pass over
memory where plain torch makes shifted copies, subtractions, scalings and
boundary-row copies:

  * :func:`grad_st`: ``operators.grad_st(phi, bc="N")``, the gradient of
    the potential, written straight into its (3, Nt, Ny, Nx) layout;
  * :func:`stepA_rhs`: stepA's right-hand side, ``div_st(mu - r*q,
    bc="N")`` plus the time-boundary terms of
    ``operators.add_time_boundary`` that inject rho0 / rhoT.

They replace no TPU kernel: the JAX package leaves both to XLA, which
fuses the shifts.  Each kernel output is bitwise its plain version's on
the card (same float32 operations in the same order), so a solve keeps
its bits and its iteration count.

CUDA tensors go to the kernels (contiguous float32, every axis at least
2 long, else they raise); CPU tensors to the plain versions, in any float
dtype; any other device raises, and so does a bc other than 'N' on any
device.  The ``_batched`` forms take a lockstep batch: (B, Nt, Ny, Nx)
potentials, (B, 3, Nt, Ny, Nx) fields, (B, Ny, Nx) frames and ``r`` one
float or a (B,) tensor, all B pairs in one launch, each pair bitwise its
single-pair launch.

``grad_st_launches`` and ``stepA_rhs_launches`` count the launches in
this process; only the CUDA branch of a wrapper changes them.
"""

from __future__ import annotations

import torch

from ofot_tpu_torch.ops import operators
from ofot_tpu_torch.ops.kernels import _build

grad_st_launches = 0
stepA_rhs_launches = 0


def _check_bc(bc) -> None:
    if bc != "N":
        raise ValueError(f"the space-time stencil kernels take bc='N' only, "
                         f"got {bc!r}")


def _over(r, x: torch.Tensor):
    """``r`` shaped to broadcast against ``x``'s pair axis where it is a
    (B,) tensor of per-pair penalties."""
    if isinstance(r, torch.Tensor) and r.dim() > 0:
        return r.view(-1, *(1,) * (x.dim() - 1))
    return r


# ------------------------------------------------------------ plain versions

def grad_st_reference(phi: torch.Tensor, batched=False) -> torch.Tensor:
    """Plain torch version of :func:`grad_st` (``batched``: of
    :func:`grad_st_batched`)."""
    return operators.grad_st(phi, bc="N", dim=int(batched))


def stepA_rhs_reference(mu, q, rho0, rhoT, r, batched=False):
    """Plain torch version of :func:`stepA_rhs` (``batched``: of
    :func:`stepA_rhs_batched`)."""
    cax = int(batched)
    F = operators.div_st(mu - _over(r, q) * q, bc="N", dim=cax)
    operators.add_time_boundary(F, mu.select(cax, 0), q.select(cax, 0),
                                rho0, rhoT, _over(r, rho0))
    return F


# ------------------------------------------------------------ CUDA kernels

def _check_size(batch, Nt, Ny, Nx) -> None:
    """Raise on a shape the kernels do not take (32-bit offsets, at most
    65535 planes), as the C entries refuse it."""
    if batch * Nt > 65535 or 3 * batch * Nt * Ny * Nx >= 2 ** 31:
        raise ValueError(f"a batch of {batch} ({Nt}, {Ny}, {Nx}) fields: "
                         "the kernels take at most 65535 planes and fewer "
                         "than 2^31 elements of a gradient")


def prepare_grad_st(phi: torch.Tensor, batched=False):
    """Check a CUDA potential ((Nt, Ny, Nx), or (B, Nt, Ny, Nx) with
    ``batched``) and allocate the gradient of one launch.

    Returns ``(enqueue, out)``; ``enqueue()`` puts the kernel on the
    current stream, raises on a launch error and does not count
    launches."""
    _build.check_cuda(phi, "grad_st")
    _build.check_operand("phi", phi, phi)
    if phi.dim() != 3 + batched or min(phi.shape[-3:]) < 2:
        raise ValueError(f"phi must be ({'B, ' if batched else ''}Nt, Ny, "
                         f"Nx) with Nt, Ny, Nx >= 2, got shape "
                         f"{tuple(phi.shape)}")
    batch = phi.shape[0] if batched else 1
    Nt, Ny, Nx = phi.shape[-3:]
    _check_size(batch, Nt, Ny, Nx)
    lib = _build.load_library()
    out = phi.new_empty(phi.shape[:-3] + (3,) + phi.shape[-3:])
    args = (phi.data_ptr(), out.data_ptr(), batch, Nt, Ny, Nx,
            _build.stream_of(phi))

    def enqueue():
        _build.check_launch(lib, lib.ofot_stencil_grad_st(*args), "grad_st")

    enqueue.buffers = (phi, out)
    return enqueue, out


def prepare_stepA_rhs(mu, q, rho0, rhoT, r, batched=False):
    """Check CUDA operands (mu, q (3, Nt, Ny, Nx) and rho0, rhoT (Ny, Nx),
    each with a leading pair axis with ``batched``; ``r`` a float, or with
    ``batched`` a (B,) tensor) and allocate the F of one launch.

    Returns ``(enqueue, F)``; ``enqueue()`` puts the kernel on the current
    stream, raises on a launch error and does not count launches."""
    _build.check_cuda(mu, "stepA_rhs")
    _build.check_operand("mu", mu, mu)
    _build.check_operand("q", q, mu)
    lead = mu.shape[:1] if batched else ()
    if mu.dim() != 4 + batched or mu.shape[batched] != 3 \
            or min(mu.shape[-3:]) < 2:
        raise ValueError(f"mu must be ({'B, ' if batched else ''}3, Nt, Ny, "
                         f"Nx) with Nt, Ny, Nx >= 2, got shape "
                         f"{tuple(mu.shape)}")
    batch = mu.shape[0] if batched else 1
    Nt, Ny, Nx = mu.shape[-3:]
    _check_size(batch, Nt, Ny, Nx)
    for name, t in (("rho0", rho0), ("rhoT", rhoT)):
        if t.device != mu.device:
            raise ValueError(f"{name} is on {t.device}, mu on {mu.device}")
        _build.check_operand(name, t, t)
        if tuple(t.shape) != lead + (Ny, Nx):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, mu "
                             f"{tuple(mu.shape)} needs {lead + (Ny, Nx)}")
    r_pairs = None
    if isinstance(r, torch.Tensor) and r.dim() > 0:
        if not batched or r.shape != (batch,):
            raise ValueError(f"a per-pair r must be ({batch},) for a batch, "
                             f"got shape {tuple(r.shape)}")
        r_pairs = r.to(mu.device, torch.float32).contiguous()
    lib = _build.load_library()
    F = mu.new_empty(lead + (Nt, Ny, Nx))
    args = (mu.data_ptr(), q.data_ptr(), rho0.data_ptr(), rhoT.data_ptr(),
            F.data_ptr(), batch, Nt, Ny, Nx,
            1.0 if r_pairs is not None else float(r),
            None if r_pairs is None else r_pairs.data_ptr(),
            _build.stream_of(mu))

    def enqueue():
        _build.check_launch(lib, lib.ofot_stencil_stepA_rhs(*args),
                            "stepA_rhs")

    enqueue.buffers = (mu, q, rho0, rhoT, F, r_pairs)
    return enqueue, F


# ------------------------------------------------------------ entry points

def grad_st(phi: torch.Tensor, bc="N") -> torch.Tensor:
    """``operators.grad_st(phi, bc="N")`` of an (Nt, Ny, Nx) potential ->
    (3, Nt, Ny, Nx) = (d/dt, d/dx, d/dy): one launch on CUDA tensors."""
    _check_bc(bc)
    if phi.device.type == "cpu":
        return grad_st_reference(phi)
    global grad_st_launches
    enqueue, out = prepare_grad_st(phi)
    enqueue()
    grad_st_launches += 1
    return out


def grad_st_batched(phi: torch.Tensor, bc="N") -> torch.Tensor:
    """:func:`grad_st` of a (B, Nt, Ny, Nx) batch -> (B, 3, Nt, Ny, Nx)
    (``operators.grad_st(phi, bc="N", dim=1)``): one launch for the
    batch."""
    _check_bc(bc)
    if phi.device.type == "cpu":
        return grad_st_reference(phi, batched=True)
    global grad_st_launches
    enqueue, out = prepare_grad_st(phi, batched=True)
    enqueue()
    grad_st_launches += 1
    return out


def stepA_rhs(mu, q, rho0, rhoT, r, bc="N") -> torch.Tensor:
    """stepA's right-hand side ``div_st(mu - r*q, bc="N")`` plus the
    time-boundary terms injecting ``rho0`` / ``rhoT`` -> (Nt, Ny, Nx), for
    (3, Nt, Ny, Nx) ``mu``, ``q`` and a float ``r``: one launch on CUDA
    tensors."""
    _check_bc(bc)
    if mu.device.type == "cpu":
        return stepA_rhs_reference(mu, q, rho0, rhoT, r)
    global stepA_rhs_launches
    enqueue, F = prepare_stepA_rhs(mu, q, rho0, rhoT, r)
    enqueue()
    stepA_rhs_launches += 1
    return F


def stepA_rhs_batched(mu, q, rho0, rhoT, r, bc="N") -> torch.Tensor:
    """:func:`stepA_rhs` of a lockstep batch: (B, 3, Nt, Ny, Nx) ``mu``,
    ``q``, (B, Ny, Nx) frames, ``r`` one float or a (B,) tensor -> (B, Nt,
    Ny, Nx): one launch for the batch."""
    _check_bc(bc)
    if mu.device.type == "cpu":
        return stepA_rhs_reference(mu, q, rho0, rhoT, r, batched=True)
    global stepA_rhs_launches
    enqueue, F = prepare_stepA_rhs(mu, q, rho0, rhoT, r, batched=True)
    enqueue()
    stepA_rhs_launches += 1
    return F
