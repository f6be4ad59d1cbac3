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

The tile form, :func:`cg_operator_tile`, is the operator on one rank's
(Nt, ty, tx) tile of a field split over a (y, x) mesh of ranks, given the
four lines next to the tile (``parallel/halo.py:edge_lines``): the SpMV of
the tiled ``cg-pallas`` set (``parallel/gspmd.py``).  Its kernel
evaluates the whole-field kernel's point expression (the shared
``csrc/cg_operator.cuh``), so the tiles' outputs put together are bitwise
the whole-field launch's; it runs one thread a group of 4 x points (or
one) on a grid of the tile's own (plane, row, x) coordinates, with 32-bit
offsets, so a tile holds fewer than 2^31 points.

``launches``, ``blocked_launches`` and ``tile_launches`` count the
kernel's launches through :func:`cg_operator`, :func:`cg_operator_blocked`
and :func:`cg_operator_tile` in this process; only the CUDA branch of each
wrapper changes its count.
"""

from __future__ import annotations

import torch

from ofot_tpu_torch.ops import operators
from ofot_tpu_torch.ops.kernels import _build

launches = 0
blocked_launches = 0
tile_launches = 0


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


# ------------------------------------------------------------- tile form

SIDES = ("up", "down", "left", "right")


def check_halos(x: torch.Tensor, halos) -> None:
    """Raise unless ``halos`` is (up, down, left, right) for the (Nt, ty,
    tx) tile ``x``: up/down (Nt, tx) rows, left/right (Nt, ty) columns,
    each a tensor or None (a global edge), with a line on at least one
    side of an axis along which the tile is one line wide."""
    if x.dim() != 3 or x.shape[0] < 2 or min(x.shape) < 1:
        raise ValueError("a tile must be (Nt, ty, tx) with Nt >= 2, got "
                         f"shape {tuple(x.shape)}")
    if len(halos) != 4:
        raise ValueError("halos must be (up, down, left, right), got "
                         f"{len(halos)} lines")
    Nt, ty, tx = x.shape
    for side, h in zip(SIDES, halos):
        want = (Nt, tx) if side in ("up", "down") else (Nt, ty)
        if h is not None and tuple(h.shape) != want:
            raise ValueError(f"halo {side} has shape {tuple(h.shape)}, the "
                             f"tile {tuple(x.shape)} needs {want}")
    up, down, left, right = halos
    if (ty < 2 and up is None and down is None) or \
            (tx < 2 and left is None and right is None):
        raise ValueError(f"a tile {tuple(x.shape)} one line wide needs a "
                         "halo line on that axis (the field is >= 2 wide)")


def cg_operator_tile_reference(x: torch.Tensor, halos, r,
                               reg_epsilon) -> torch.Tensor:
    """Plain torch version of the tile form: ``x`` padded with its halo
    lines, :func:`cg_operator_reference` on the padded block, the tile cut
    out.

    A side without a line (a global edge) is not padded, so the padded
    block's own first or last line there is the field's, and
    ``laplacian_st``'s 'N' rows land on it as on the whole field.  A padded
    line's own (wrong) row is cut away, and the corners of the block (zero)
    are read by no tile point.  Every tile point then evaluates the whole
    field's elementwise expression on the same neighbour values in the
    same order (t, then x, then y; each axis ``(next - 2 c + prev) / 1``),
    so the tiles put together are bitwise ``cg_operator_reference`` of the
    whole field, in any dtype."""
    check_halos(x, halos)
    up, down, left, right = halos
    rows = [x] if up is None else [up.unsqueeze(-2), x]
    if down is not None:
        rows.append(down.unsqueeze(-2))
    p = torch.cat(rows, -2)
    y0 = 0 if up is None else 1
    Nt, ty, tx = x.shape

    def column(line):
        c = p.new_zeros(Nt, p.shape[-2], 1)
        c[:, y0:y0 + ty, 0] = line
        return c

    cols = [p] if left is None else [column(left), p]
    if right is not None:
        cols.append(column(right))
    p = torch.cat(cols, -1)
    x0 = 0 if left is None else 1
    return cg_operator_reference(p, r, reg_epsilon)[
        :, y0:y0 + ty, x0:x0 + tx].contiguous()


def prepare_tile_launch(x: torch.Tensor, halos, r, reg_epsilon):
    """Check a CUDA tile and its halo lines (contiguous float32 on the
    tile's device) and allocate the output of one launch.

    Returns ``(enqueue, y)``; ``enqueue()`` puts the kernel on the current
    stream, raises on a launch error and does not count launches."""
    _build.check_cuda(x, "cg_operator_tile")
    _build.check_operand("x", x, x)
    check_halos(x, halos)
    if x.numel() >= 2 ** 31:
        raise ValueError(f"a tile of {x.numel()} points: the kernel takes "
                         "fewer than 2^31")
    for side, h in zip(SIDES, halos):
        if h is not None:
            _build.check_operand(side, h, h)
            if h.device != x.device:
                raise ValueError(f"halo {side} is on {h.device}, the tile "
                                 f"on {x.device}")
    r, reps = _build.pair_scalars(r, reg_epsilon, x)   # one r: x is 3-d
    lib = _build.load_library()
    y = torch.empty_like(x)
    args = (x.data_ptr(), y.data_ptr(), *x.shape,
            *(None if h is None else h.data_ptr() for h in halos),
            float(r), float(reps), _build.stream_of(x))

    def enqueue():
        _build.check_launch(lib, lib.ofot_cg_operator_tile(*args),
                            "cg_operator_tile")

    enqueue.buffers = (x, y, *halos)
    return enqueue, y


def cg_operator_tile(x: torch.Tensor, halos, r=1.0,
                     reg_epsilon=1e-2) -> torch.Tensor:
    """``-r * laplacian_st + r*eps*x`` on one rank's (Nt, ty, tx) tile,
    with ``halos`` = (up, down, left, right): the (Nt, tx) rows above and
    below the tile and the (Nt, ty) columns left and right of it, None on
    a global edge.  The tiled ``cg-pallas`` set's SpMV: the counterpart of
    ``cg_operator_pallas_blocked`` on a (y, x)-partitioned field."""
    if x.device.type == "cpu":
        return cg_operator_tile_reference(x, halos, r, reg_epsilon)
    global tile_launches
    enqueue, y = prepare_tile_launch(x, halos, r, reg_epsilon)
    enqueue()
    tile_launches += 1
    return y
