"""Direct spectral (DCT) solver for the FOTO stepA system.

Counterpart of the dense route of ``ofot_tpu.solvers.dct``.  The stepA
operator ``A = -r * L_st + r*eps*I`` (reference benamou_brenier.py:203) is
built from 1-D Neumann Laplacians whose 'N' boundary rows are ``[-1, 1]``
(reference operators.py:104-108), which the orthonormal DCT-II basis
diagonalizes:

    v_k[i] = c_k * cos(pi * k * (2i+1) / (2n)),   lambda_k = 2 cos(pi k/n) - 2

so stepA solves exactly with one forward transform, a pointwise divide and
one inverse transform: six (n, n) matrix products along the three axes.

The products are plain ``torch.matmul`` calls in full float32.  TF32 would
keep about three decimal digits and stall ALG2 convergence (the JAX package
measured the bf16 analogue stalling at crit ~0.4), and the design holds
fp32 end to end (DESIGN.md §6), so this module turns TF32 off for CUDA
matmuls and sets the float32 matmul precision to "highest" explicitly.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


@lru_cache(maxsize=64)
def _dct_matrix_np(n: int) -> np.ndarray:
    """Orthonormal DCT-II analysis matrix C (C @ x = coefficients; the
    inverse transform is C.T)."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    C = np.sqrt(2.0 / n) * np.cos(np.pi * k * (2 * i + 1) / (2 * n))
    C[0, :] *= 1.0 / np.sqrt(2.0)
    return C


@lru_cache(maxsize=64)
def _neumann_eigenvalues_np(n: int) -> np.ndarray:
    """Eigenvalues of the 1-D 'N' Laplacian (h = 1) in DCT-II order."""
    k = np.arange(n)
    return 2.0 * np.cos(np.pi * k / n) - 2.0


def _transform(x: torch.Tensor, mat: torch.Tensor, axis: int) -> torch.Tensor:
    """Apply an (n, n) transform matrix along one axis of a field."""
    y = torch.matmul(x.movedim(axis, -1), mat.T)
    return y.movedim(-1, axis)


def _matrix(n: int, dtype, device) -> torch.Tensor:
    """The DCT-II analysis matrix of length n on ``device``."""
    return torch.as_tensor(_dct_matrix_np(n), dtype=dtype, device=device)


def dct3(x: torch.Tensor) -> torch.Tensor:
    """Separable orthonormal DCT-II over the (Nt, Ny, Nx) axes."""
    for axis in (-3, -2, -1):
        x = _transform(x, _matrix(x.shape[axis], x.dtype, x.device), axis)
    return x


def idct3(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`dct3` (transforms are orthonormal)."""
    for axis in (-3, -2, -1):
        x = _transform(x, _matrix(x.shape[axis], x.dtype, x.device).T,
                       axis)
    return x


def stepA_spectrum(Nt: int, Ny: int, Nx: int, r: float, reg_epsilon: float,
                   dtype=np.float32) -> np.ndarray:
    """Eigenvalues of A = -r*L_st + r*eps*I on the DCT-II tensor basis."""
    lt = _neumann_eigenvalues_np(Nt)[:, None, None]
    ly = _neumann_eigenvalues_np(Ny)[None, :, None]
    lx = _neumann_eigenvalues_np(Nx)[None, None, :]
    return (-r * (lt + ly + lx) + r * reg_epsilon).astype(dtype)


class StepAPlan:
    """The transform matrices and spectrum of one stepA system, on one
    device, built once and reused by every solve of that system.

    The spectrum is assembled like the JAX solver's in-graph one: the three
    1-D eigenvalue vectors are cast to the field's dtype first, then
    combined as ``-r*(lt + ly + lx) + r*eps`` in that dtype."""

    def __init__(self, shape, r: float, reg_epsilon: float, dtype, device):
        Nt, Ny, Nx = shape[-3:]
        self.mats = [_matrix(n, dtype, device) for n in (Nt, Ny, Nx)]
        np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        lt, ly, lx = (torch.as_tensor(_neumann_eigenvalues_np(n)
                                      .astype(np_dtype), device=device)
                      for n in (Nt, Ny, Nx))
        self.spec = (-r * (lt[:, None, None] + ly[None, :, None]
                           + lx[None, None, :]) + r * reg_epsilon)

    def solve(self, F: torch.Tensor) -> torch.Tensor:
        x = F
        for axis, mat in zip((-3, -2, -1), self.mats):
            x = _transform(x, mat, axis)
        x = x / self.spec
        for axis, mat in zip((-3, -2, -1), self.mats):
            x = _transform(x, mat.T, axis)
        return x


def solve_stepA_dct(F: torch.Tensor, r: float = 1.0,
                    reg_epsilon: float = 1e-2) -> torch.Tensor:
    """Exact solve of ``(-r*L_st + r*eps*I) phi = F`` via 3-D DCT."""
    return StepAPlan(F.shape, float(r), float(reg_epsilon), F.dtype,
                     F.device).solve(F)
