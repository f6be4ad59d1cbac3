"""Sinkhorn's exactly-stabilized softmin: the CUDA kernels.

One C entry of ``ofot_tpu_torch/csrc/exact_softmin.cu`` launches two
kernels on a (Ny, Nx) potential or a (B, Ny, Nx) lockstep batch of them: the
max-plus logsumexp over x' (stage 1, into an (Ny, Nx) scratch L1), then
over y' (stage 2).  Together they compute ``solvers.sinkhorn._exact_stats``,
whose plain path materializes (Ny, Nx, 64) temporaries chunk by chunk:
:func:`softmin` its S, :func:`stats` its (S, E[y'], E[x'], E[C]).

They replace no TPU kernel: the JAX package leaves the exact softmin to
XLA.  Every term and maximum is rounded as the plain path rounds it; the
sums run in another order, so values agree to rounding, not bitwise.  A
launch repeats bitwise, and each pair of a batch is bitwise its single
call.

CUDA tensors only: contiguous float32 or float64, (Ny, Nx) or (B, Ny, Nx)
with Ny, Nx >= 1, and ``eps`` a Python number > 0 (a host read of a device
tensor would break the device loop's graph capture), else they raise.  A
block holds ``ROWS`` rows of h, and stage 2 a table of 2 Ny - 1 distances,
in shared memory, which bounds Nx and Ny (``SHARED_BYTES``).
``solvers.sinkhorn._exact_stats`` sends CPU tensors to the plain path and
CUDA tensors here.

``launches`` counts the softmin's kernel launches in this process,
``stats_launches`` those of the statistics (``LAUNCHES_A_CALL`` a call,
single pair or batch).
"""

from __future__ import annotations

import torch

from ofot_tpu_torch.ops.kernels import _build

launches = 0
stats_launches = 0

LAUNCHES_A_CALL = 2      # stage 1 over x', then stage 2 over y'
ROWS = 4                 # rows of h a block of stage 1 holds (csrc kRows)
SHARED_BYTES = 232448    # shared memory a block may opt in to on the H100
_DTYPES = (torch.float32, torch.float64)


def check_field(h: torch.Tensor, eps) -> None:
    """Raise unless ``h`` and ``eps`` are what the kernels take (any
    device: the device is checked apart)."""
    if h.dtype not in _DTYPES:
        raise TypeError(f"h must be float32 or float64 for the CUDA kernel, "
                        f"got {h.dtype}")
    if h.dim() not in (2, 3) or 0 in h.shape:
        raise ValueError(f"h must be (Ny, Nx) or (B, Ny, Nx) and not empty, "
                         f"got shape {tuple(h.shape)}")
    if not h.is_contiguous():
        raise ValueError("h must be contiguous")
    if isinstance(eps, torch.Tensor) or not float(eps) > 0.0:
        raise ValueError(f"eps must be a Python number > 0, got {eps!r}")
    Ny, Nx = h.shape[-2:]
    batch = h.shape[0] if h.dim() == 3 else 1
    size = h.element_size()
    if batch > 65535 or Ny * Nx >= 2 ** 31 or max(
            ROWS * Nx, 2 * Ny - 1) * size > SHARED_BYTES:
        raise ValueError(f"a batch of {batch} ({Ny}, {Nx}) {h.dtype} fields: "
                         "the kernels take at most 65535 pairs, fewer than "
                         f"2^31 entries a pair, and {ROWS} rows of Nx and "
                         f"2 Ny - 1 values within {SHARED_BYTES} bytes")


def prepare_softmin(h: torch.Tensor, eps, want_means: bool):
    """Check a CUDA potential and allocate the outputs and the scratch of
    one call.

    Returns ``(enqueue, outs)``: ``outs`` is (S,) or, with ``want_means``,
    (S, E[y'], E[x'], E[C]), each of h's shape; ``enqueue()`` puts both
    kernels on the current stream, raises on a launch error and does not
    count launches."""
    check_field(h, eps)
    _build.check_cuda(h, "exact_softmin")
    Ny, Nx = h.shape[-2:]
    batch = h.shape[0] if h.dim() == 3 else 1
    lib = _build.load_library()
    out = h.new_empty((4 if want_means else 1,) + h.shape)
    scratch = h.new_empty((3 if want_means else 1,) + h.shape)
    args = (h.data_ptr(), out.data_ptr(), scratch.data_ptr(), batch, Ny, Nx,
            float(eps), int(want_means), int(h.dtype == torch.float64),
            _build.stream_of(h))

    def enqueue():
        _build.check_launch(lib, lib.ofot_exact_softmin(*args),
                            "exact_softmin")

    enqueue.buffers = (h, out, scratch)
    return enqueue, tuple(out.unbind())


def softmin(h: torch.Tensor, eps) -> torch.Tensor:
    """S = eps * logsumexp over (y', x') of (h - C) / eps, per output entry,
    of a CUDA potential: one call of ``LAUNCHES_A_CALL`` launches."""
    global launches
    enqueue, (S,) = prepare_softmin(h, eps, want_means=False)
    enqueue()
    launches += LAUNCHES_A_CALL
    return S


def stats(h: torch.Tensor, eps):
    """(S, E[y'], E[x'], E[C]) of a CUDA potential, the plan rows'
    conditional means beside the softmin: one call of ``LAUNCHES_A_CALL``
    launches."""
    global stats_launches
    enqueue, outs = prepare_softmin(h, eps, want_means=True)
    enqueue()
    stats_launches += LAUNCHES_A_CALL
    return outs
