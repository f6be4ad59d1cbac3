"""The device loop's per-pair freeze: CUDA kernels and plain versions.

Two kernels of ``ofot_tpu_torch/csrc/loop_mask.cu``, each launched once an
iteration of a captured block of ``solvers/device_loop.py``:

  * :func:`select_scalars`: ``run ? new : old`` for every per-pair scalar
    of the loop's state (criteria, counters, flags shaped like the running
    flag: 0-d for one pair, (B,) for a lockstep batch), of any dtype, all
    in one launch;
  * :func:`latch_fields`: for each pair that stops at this iteration
    (``run & ~nxt``), its part of every carried field copied into the
    loop's held buffers, in place; no pair stops, nothing is copied.

They replace no TPU kernel: ``lax.while_loop`` keeps a stopped loop's carry
for free.  Both copy values exactly, so the loop stays bitwise its host
loop.

CUDA tensors go to the kernels (contiguous operands of matching dtypes and
shapes, at most ``MAX_FIELDS`` of them, else they raise; no fallback); CPU
tensors to the plain versions.  A flag may have any strides: a (B,) bool
is a few bytes, so a strided one is made contiguous.

``select_launches`` and ``latch_launches`` count the launches in this
process; only the CUDA branch of a wrapper changes them.
"""

from __future__ import annotations

import ctypes

import torch

from ofot_tpu_torch.ops.kernels import _build

select_launches = 0
latch_launches = 0

MAX_FIELDS = 16


# ------------------------------------------------------------ plain versions

def select_scalars_reference(run, new, old) -> tuple:
    """Plain torch version of :func:`select_scalars`."""
    return tuple(torch.where(run.reshape(n.shape), n, o)
                 for n, o in zip(new, old))


def latch_fields_reference(run, nxt, fields, held) -> tuple:
    """Plain torch version of :func:`latch_fields` (returns new tensors;
    the kernel writes into ``held``)."""
    fire = run & ~nxt
    return tuple(torch.where(fire.view(fire.shape + (1,) * (f.dim()
                                                           - fire.dim())),
                             f, h)
                 for f, h in zip(fields, held))


# ------------------------------------------------------------ CUDA kernels

def _flag(name: str, flag: torch.Tensor, run: torch.Tensor) -> torch.Tensor:
    _build.check_cuda(flag, name)
    if flag.device != run.device or flag.shape != run.shape:
        raise ValueError(f"{name} is {tuple(flag.shape)} on {flag.device}, "
                         f"run {tuple(run.shape)} on {run.device}")
    if flag.dtype != torch.bool or flag.dim() > 1:
        raise TypeError(f"{name} must be a 0-d or (B,) bool tensor, got "
                        f"{flag.dtype} {tuple(flag.shape)}")
    return flag.contiguous()


def _check_count(what: str, n: int) -> None:
    if n > MAX_FIELDS:
        raise ValueError(f"{what}: {n} tensors, the kernel takes at most "
                         f"{MAX_FIELDS}")


def _check_pair(name: str, a: torch.Tensor, b: torch.Tensor,
                run: torch.Tensor) -> None:
    if a.device != run.device or b.device != run.device:
        raise ValueError(f"{name} is on {a.device} / {b.device}, run on "
                         f"{run.device}")
    if a.dtype != b.dtype or a.shape != b.shape:
        raise TypeError(f"{name}: {a.dtype} {tuple(a.shape)} against "
                        f"{b.dtype} {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{name} must be contiguous")


def _pointers(ts, ctype=ctypes.c_void_p):
    return (ctype * max(len(ts), 1))(*ts)


def prepare_select_scalars(run, new, old):
    """Check CUDA operands (``new[f]``, ``old[f]``: contiguous, one element
    a pair, of one dtype each) and allocate the outputs of one launch.

    Returns ``(enqueue, outs)``; ``enqueue()`` puts the kernel on the
    current stream, raises on a launch error and does not count
    launches."""
    run = _flag("run", run, run)
    new, old = tuple(new), tuple(old)
    _check_count("select_scalars", len(new))
    pairs = run.numel()
    for f, (n, o) in enumerate(zip(new, old)):
        _check_pair(f"scalar {f}", n, o, run)
        if n.numel() != pairs:
            raise ValueError(f"scalar {f} has {n.numel()} elements, one a "
                             f"pair is {pairs}")
    outs = tuple(torch.empty_like(n) for n in new)
    lib = _build.load_library()
    args = (run.data_ptr(), pairs, len(new),
            _pointers([n.data_ptr() for n in new]),
            _pointers([o.data_ptr() for o in old]),
            _pointers([t.data_ptr() for t in outs]),
            _pointers([n.element_size() for n in new], ctypes.c_int),
            _build.stream_of(run))

    def enqueue():
        _build.check_launch(lib, lib.ofot_loop_select_scalars(*args),
                            "select_scalars")

    enqueue.buffers = (run, new, old, outs)
    return enqueue, outs


def prepare_latch_fields(run, nxt, fields, held):
    """Check CUDA operands (``fields[f]``, ``held[f]``: contiguous, of one
    dtype and shape each, led by the flags' axes) for one launch that
    writes into ``held``.

    Returns ``enqueue``; ``enqueue()`` puts the kernel on the current
    stream, raises on a launch error and does not count launches."""
    run = _flag("run", run, run)
    nxt = _flag("nxt", nxt, run)
    fields, held = tuple(fields), tuple(held)
    _check_count("latch_fields", len(fields))
    pairs = run.numel()
    for f, (s, h) in enumerate(zip(fields, held)):
        _check_pair(f"field {f}", s, h, run)
        if s.shape[:run.dim()] != run.shape or s.numel() <= pairs:
            raise ValueError(f"field {f} of shape {tuple(s.shape)} is no "
                             f"field of {pairs} pair(s) led by the flags' "
                             f"shape {tuple(run.shape)}")
    lib = _build.load_library()
    args = (run.data_ptr(), nxt.data_ptr(), pairs, len(fields),
            _pointers([s.data_ptr() for s in fields]),
            _pointers([h.data_ptr() for h in held]),
            _pointers([s.numel() // pairs * s.element_size()
                       for s in fields], ctypes.c_longlong),
            _build.stream_of(run))

    def enqueue():
        _build.check_launch(lib, lib.ofot_loop_latch_fields(*args),
                            "latch_fields")

    enqueue.buffers = (run, nxt, fields, held)
    return enqueue


# ------------------------------------------------------------ entry points

def select_scalars(run, new, old) -> tuple:
    """Per pair, ``new`` where ``run`` else ``old``, for per-pair scalars
    (each with one element a pair; ``run`` 0-d or (B,) bool): one launch on
    CUDA tensors for all of them, none for an empty list."""
    if run.device.type == "cpu":
        return select_scalars_reference(run, new, old)
    if not new:
        return ()
    global select_launches
    enqueue, outs = prepare_select_scalars(run, new, old)
    enqueue()
    select_launches += 1
    return outs


def latch_fields(run, nxt, fields, held) -> tuple:
    """``held`` with each pair that stops here (``run & ~nxt``) taking its
    part of ``fields``, the rest unchanged.  On CUDA tensors: one launch
    that writes into ``held`` and returns it (none for an empty list)."""
    if run.device.type == "cpu":
        return latch_fields_reference(run, nxt, fields, held)
    if not fields:
        return ()
    global latch_launches
    enqueue = prepare_latch_fields(run, nxt, fields, held)
    enqueue()
    latch_launches += 1
    return tuple(held)
