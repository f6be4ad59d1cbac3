"""Matrix-free 1-D finite-difference stencils on torch tensors.

Counterpart of ``ofot_tpu.ops.stencils``: each function applies, along one
axis, the action of one of the reference's 1-D sparse operators (reference
operators.py:5-110) with its exact boundary-condition quirks (SURVEY.md §2
quirks 1-3):

  * ``grad_central`` with bc='N' has *zeroed* boundary rows
    (reference operators.py:61-63);
  * ``grad_central_weird`` overwrites the bc='N' boundary rows with one-sided
    differences that are **not** divided by h (set after ``L /= h``,
    reference operators.py:42-46); the forward/backward ``*_weird``
    variants overwrite their one-sided boundary row whatever the bc
    (reference operators.py:14-15, 28-29);
  * ``grad_forward`` with bc='N' zeroes its last row, and its adjoint
    zeroes the last entry of its input first;
  * bc='D' keeps the truncated interior stencil at the boundary (the
    ghost value outside the domain is implicitly 0).

Boundary rows are written into a fresh result tensor in place; inputs are
never modified (the adjoints clone before they zero a boundary entry).
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


def grad_forward(f, h, bc="N", axis=-1):
    """Forward difference (f[i+1]-f[i])/h.

    bc='N': last row zero (reference operators.py:76-77).
    bc='D': last row is -f[n-1]/h.
    """
    _check_bc(bc)
    out = (_shifted(f, 1, axis) - f) / h
    if bc == "N":
        _set(out, -1, axis, 0.0)
    return out


def grad_backward(f, h, bc="N", axis=-1):
    """Backward difference (f[i]-f[i-1])/h.

    bc='N': first row zero (reference operators.py:90-91).
    bc='D': first row is f[0]/h.
    """
    _check_bc(bc)
    out = (f - _shifted(f, -1, axis)) / h
    if bc == "N":
        _set(out, 0, axis, 0.0)
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


def grad_forward_weird(f, h, bc, axis=-1):
    """Forward difference; last row unconditionally f[n-1]-f[n-2], unscaled
    (reference operators.py:14-15)."""
    _check_bc(bc)
    out = (_shifted(f, 1, axis) - f) / h
    _set(out, -1, axis, _index(f, -1, axis) - _index(f, -2, axis))
    return out


def grad_backward_weird(f, h, bc, axis=-1):
    """Backward difference; first row unconditionally f[1]-f[0], unscaled
    (reference operators.py:28-29)."""
    _check_bc(bc)
    out = (f - _shifted(f, -1, axis)) / h
    _set(out, 0, axis, _index(f, 1, axis) - _index(f, 0, axis))
    return out


# --------------------------------------------------------------------------
# adjoints (needed matrix-free where the reference uses .transpose())
# --------------------------------------------------------------------------

def grad_forward_adjoint(f, h, bc="N", axis=-1):
    """Action of ``grad_forward``'s transpose.

    For bc='N' (zeroed last row): (D^T x)[i] = (x[i-1] - x[i])/h with
    x[-1] := 0 and the "- x[i]" term dropped at i = n-1.
    For bc='D': (D^T x)[i] = (x[i-1] - x[i])/h with x[-1] := 0.
    Used by the GN solver where the reference builds div = -grad^T
    (reference classical.py:103).
    """
    _check_bc(bc)
    if bc == "N":
        # zero the last entry of x (on a copy) before applying the
        # dense-pattern adjoint
        f = f.clone()
        _set(f, -1, axis, 0.0)
    return (_shifted(f, -1, axis) - f) / h


def grad_central_adjoint(f, h, bc, axis=-1):
    """Action of ``grad_central``'s transpose (for bc='N' the zeroed
    boundary rows mean the adjoint drops boundary contributions)."""
    _check_bc(bc)
    if bc == "N":
        f = f.clone()
        _set(f, 0, axis, 0.0)
        _set(f, -1, axis, 0.0)
    return (_shifted(f, -1, axis) - _shifted(f, 1, axis)) / (2.0 * h)
