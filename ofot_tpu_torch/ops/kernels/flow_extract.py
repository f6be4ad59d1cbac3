"""Flow extraction after the ALG2 loop: the CUDA kernels.

One C entry of ``ofot_tpu_torch/csrc/flow_extract.cu`` launches two
kernels on a (Nt, Ny, Nx) potential or a (B, Nt, Ny, Nx) batch of them:
the trajectories (u, v), one thread a start pixel over the Nt - 1 steps,
then the luminosity m = -div(u, v).  Together they compute
``solvers.flow_extract.flow_from_potential``'s plain path, which ran as
~780 eager torch launches a pair.

They replace no TPU kernel: the JAX package leaves the extraction to XLA.
Each output is bitwise the plain path's on the card (the same float
operations in the same order), so a solve keeps its bits; each pair of a
batch is bitwise its single call.

CUDA tensors only: contiguous float32 or float64, Ny, Nx >= 2, else they
raise.  ``solvers.flow_extract.flow_from_potential`` sends CPU tensors to
the plain path and CUDA tensors here.

``launches`` counts the kernel launches in this process (``LAUNCHES_A_CALL``
a call, single pair or batch).
"""

from __future__ import annotations

import torch

from ofot_tpu_torch.ops.kernels import _build

launches = 0

LAUNCHES_A_CALL = 2     # the trajectories, then the divergence
_DTYPES = (torch.float32, torch.float64)


def prepare_flow(phi: torch.Tensor):
    """Check a CUDA potential ((Nt, Ny, Nx) or (B, Nt, Ny, Nx)) and
    allocate the (u, v, m) of one call, each (Ny, Nx) or (B, Ny, Nx).

    Returns ``(enqueue, (u, v, m))``; ``enqueue()`` puts both kernels on
    the current stream, raises on a launch error and does not count
    launches."""
    _build.check_cuda(phi, "flow_extract")
    if phi.dtype not in _DTYPES:
        raise TypeError(f"phi must be float32 or float64 for the CUDA "
                        f"kernel, got {phi.dtype}")
    if phi.dim() not in (3, 4) or min(phi.shape[-2:]) < 2 \
            or 0 in phi.shape:
        raise ValueError(f"phi must be (Nt, Ny, Nx) or (B, Nt, Ny, Nx) with "
                         f"Ny, Nx >= 2, got shape {tuple(phi.shape)}")
    Nt, Ny, Nx = phi.shape[-3:]
    batch = phi.shape[0] if phi.dim() == 4 else 1
    if batch > 65535 or Nt * Ny * Nx >= 2 ** 31:
        raise ValueError(f"a batch of {batch} ({Nt}, {Ny}, {Nx}) potentials:"
                         " the kernels take at most 65535 pairs and fewer "
                         "than 2^31 points a pair")
    phi = phi.contiguous()
    lib = _build.load_library()
    out = phi.new_empty((3,) + phi.shape[:-3] + (Ny, Nx))
    u, v, m = out.unbind()
    args = (phi.data_ptr(), u.data_ptr(), v.data_ptr(), m.data_ptr(), batch,
            Nt, Ny, Nx, int(phi.dtype == torch.float64),
            _build.stream_of(phi))

    def enqueue():
        _build.check_launch(lib, lib.ofot_flow_extract(*args), "flow_extract")

    enqueue.buffers = (phi, out)
    return enqueue, (u, v, m)


def flow(phi: torch.Tensor):
    """(u, v, m) of a CUDA potential ((Nt, Ny, Nx) -> each (Ny, Nx); a
    (B, Nt, Ny, Nx) batch -> each (B, Ny, Nx)): one call of
    ``LAUNCHES_A_CALL`` launches."""
    global launches
    enqueue, uvm = prepare_flow(phi)
    enqueue()
    launches += LAUNCHES_A_CALL
    return uvm
