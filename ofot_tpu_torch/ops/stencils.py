"""Matrix-free 1-D finite-difference stencils on torch tensors.

Counterpart of ``ofot_tpu.ops.stencils``: each function applies, along one
axis, the action of one of the reference's 1-D sparse operators (reference
operators.py:5-110) with its exact boundary-condition quirks (SURVEY.md §2
quirks 1-3):

  * ``grad_central`` with bc='N' has *zeroed* boundary rows
    (reference operators.py:61-63);
  * ``grad_central_weird`` overwrites the bc='N' boundary rows with one-sided
    differences that are **not** divided by h (set after ``L /= h``,
    reference operators.py:42-46);
  * bc='D' keeps the truncated interior stencil at the boundary (the
    ghost value outside the domain is implicitly 0).

The FOTO slice needs the central, weird-central and Laplacian stencils;
the forward/backward differences and adjoints of the JAX module come with
the GN slice that calls them.  Boundary rows are written into a fresh
result tensor in place; inputs are never modified.
"""

from __future__ import annotations

import torch


def _shifted(f: torch.Tensor, offset: int, axis: int) -> torch.Tensor:
    """out[i] = f[i + offset] along ``axis``, zero beyond the boundary."""
    if offset == 0:
        return f
    n = f.shape[axis]
    zshape = list(f.shape)
    zshape[axis] = abs(offset)
    zeros = f.new_zeros(zshape)
    if offset > 0:
        return torch.cat([f.narrow(axis, offset, n - offset), zeros], axis)
    return torch.cat([zeros, f.narrow(axis, 0, n + offset)], axis)


def _index(f: torch.Tensor, i: int, axis: int) -> torch.Tensor:
    """Slice index ``i`` along ``axis`` (the axis is dropped)."""
    return f.select(axis, i)


def _set(out: torch.Tensor, i: int, axis: int, value) -> None:
    """Overwrite row ``i`` along ``axis`` of ``out`` (a fresh result
    tensor owned by the caller) with ``value``."""
    row = out.select(axis, i)
    if isinstance(value, torch.Tensor):
        row.copy_(value)
    else:
        row.fill_(value)


def _check_bc(bc: str) -> None:
    if bc not in ("N", "D"):
        raise NotImplementedError(
            "These boundary conditions are not implemented"
        )


# --------------------------------------------------------------------------
# standard FD schemes (reference operators.py:52-110)
# --------------------------------------------------------------------------

def grad_central(f, h, bc, axis=-1):
    """Central difference (f[i+1]-f[i-1])/(2h).

    bc='N': boundary rows are identically zero (reference operators.py:61-63).
    bc='D': truncated central stencil at the boundary.
    """
    _check_bc(bc)
    out = (_shifted(f, 1, axis) - _shifted(f, -1, axis)) / (2.0 * h)
    if bc == "N":
        _set(out, 0, axis, 0.0)
        _set(out, -1, axis, 0.0)
    return out


def lap1d(f, h, bc, axis=-1):
    """Three-point Laplacian (f[i-1]-2f[i]+f[i+1])/h^2.

    bc='N': boundary rows (-f[0]+f[1])/h^2 and (f[n-2]-f[n-1])/h^2
    (reference operators.py:104-108).  bc='D': truncated stencil.
    """
    _check_bc(bc)
    h2 = h * h
    out = (_shifted(f, 1, axis) - 2.0 * f + _shifted(f, -1, axis)) / h2
    if bc == "N":
        _set(out, 0, axis,
             (-_index(f, 0, axis) + _index(f, 1, axis)) / h2)
        _set(out, -1, axis,
             (-_index(f, -1, axis) + _index(f, -2, axis)) / h2)
    return out


# --------------------------------------------------------------------------
# "weird" variants (reference operators.py:5-48): boundary rows overwritten
# with one-sided differences NOT divided by h.
# --------------------------------------------------------------------------

def grad_central_weird(f, h, bc, axis=-1):
    """Central difference whose bc='N' boundary rows are the *unscaled*
    one-sided differences f[1]-f[0] / f[n-1]-f[n-2]
    (reference operators.py:42-46; SURVEY.md §2 quirk 1).
    bc='D' is the truncated central stencil.
    """
    _check_bc(bc)
    out = (_shifted(f, 1, axis) - _shifted(f, -1, axis)) / (2.0 * h)
    if bc == "N":
        _set(out, 0, axis, _index(f, 1, axis) - _index(f, 0, axis))
        _set(out, -1, axis, _index(f, -1, axis) - _index(f, -2, axis))
    return out
