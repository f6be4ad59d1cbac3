"""Direct spectral (DCT) solvers: the FOTO stepA system and GN's 2-D case.

Counterpart of ``ofot_tpu.solvers.dct``.  The stepA operator
``A = -r * L_st + r*eps*I`` (reference benamou_brenier.py:203) is built
from 1-D Neumann Laplacians whose 'N' boundary rows are ``[-1, 1]``
(reference operators.py:104-108), which the orthonormal DCT-II basis
diagonalizes:

    v_k[i] = c_k * cos(pi * k * (2i+1) / (2n)),   lambda_k = 2 cos(pi k/n) - 2

so stepA solves exactly with one forward transform, a pointwise divide and
one inverse transform.  GN's smoothness operator ``-lap_gn`` is the 2-D
case of the same Laplacian.

Each axis takes one of three routes, as in the JAX module:

  * ``dense``: an (n, n) cosine-matrix product (``torch.matmul``);
  * ``fft``: the Makhoul even extension through a length-2n real FFT, for
    axes longer than ``_fft_threshold`` (1024 on the CPU, never on cuda —
    the split the JAX module makes between its CPU and other backends);
  * ``fold``: the even/odd split into two (n/2, n/2) products, off by
    default (``_FOLD_MIN_N``) and an option.  It emits the frequencies in
    even-first order, so a solve resolves the routes of its axes once
    (``_solve_modes``) and gives the same routes to the spectrum and to the
    transforms.

The products are full float32: TF32 keeps about three decimal digits and
stalls ALG2 convergence (the JAX package measured the bf16 analogue
stalling at crit ~0.4), and the design holds fp32 end to end (DESIGN.md
§6), so this module turns TF32 off for CUDA matmuls and sets the float32
matmul precision to "highest".  The one exception is
``solve_stepA_dct_refined``, whose approximate inverse runs its products
in TF32 on cuda (the MXU's bf16 default in JAX) inside ``_tf32_matmul``,
which restores both settings; the refinement against the exact stencil
operator stays fp32.

The matrices are built on the host in float64 and cast.  The JAX module's
on-device int32 matrix generation (``_dct_matrix_jnp``,
``_DEVICE_GEN_THRESHOLD``) keeps XLA program blobs small, a concern the
port does not have, so it has no counterpart here.
"""

from __future__ import annotations

from contextlib import contextmanager
from functools import lru_cache

import numpy as np
import torch

from ofot_tpu_torch.ops import operators
from ofot_tpu_torch.solvers.lockstep import PerPair

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


def _matrix(n: int, dtype, device) -> torch.Tensor:
    """The DCT-II analysis matrix of length n on ``device``."""
    return torch.as_tensor(_dct_matrix_np(n), dtype=dtype, device=device)


# Above this axis length the cosine transform runs through an FFT
# (O(n log n)) instead of a dense (n, n) product.  None = decide from the
# field's device: 1024 on the CPU, as the JAX module decides for its CPU
# backend; never on cuda, as it decides for every other backend (no
# default moves on the card without a measurement).  Tests set an int to
# force either route.
_FFT_THRESHOLD: int | None = None

# Axes of even length above this fold (set lower, e.g. 128, to enable).
_FOLD_MIN_N = 1 << 30


def _fft_threshold(device) -> int:
    if _FFT_THRESHOLD is not None:
        return _FFT_THRESHOLD
    return 1024 if torch.device(device).type == "cpu" else (1 << 30)


def _axis_mode(n: int, device) -> str:
    """Transform route for one axis on ``device``: 'fft', 'fold' (solve
    paths only) or 'dense'."""
    if n > _fft_threshold(device):
        return "fft"
    if n % 2 == 0 and n > _FOLD_MIN_N:
        return "fold"
    return "dense"


def _solve_modes(ns, device) -> tuple:
    """Resolve the per-axis transform routes of a spectral solve ONCE.

    The spectrum and the transforms of a solve must take the same routes
    (folding permutes the frequency order); every solve entry point calls
    this once and threads the result through both, so a change of
    ``_FOLD_MIN_N`` / ``_FFT_THRESHOLD`` in between cannot mismatch them."""
    return tuple(_axis_mode(n, device) for n in ns)


def _natural_modes(ns, device) -> tuple:
    """Routes of the public natural-order transforms: never folded."""
    return tuple("fft" if n > _fft_threshold(device) else "dense"
                 for n in ns)


def _eigs_1d_np(n: int, mode: str) -> np.ndarray:
    """1-D Neumann-Laplacian eigenvalues in the order a solve-path
    transform routed as ``mode`` emits them (even-first under 'fold')."""
    e = _neumann_eigenvalues_np(n)
    if mode == "fold":
        return np.concatenate([e[0::2], e[1::2]])
    return e


# ------------------------------------------------------- folded transforms
#
# DCT-II even/odd symmetry: C[k, n-1-i] = (-1)^k * C[k, i].  For even n the
# n x n transform splits into two (n/2 x n/2) products on the folded inputs
# u = x_lo + reverse(x_hi) (even frequencies) and v = x_lo - reverse(x_hi)
# (odd frequencies).  The JAX module measured no gain from it on the TPU
# and keeps it off; so does the port.

def _folded_matrices(n: int, dtype, device):
    """(E, O): rows are the even / odd frequencies of the DCT-II matrix,
    columns restricted to i < n/2 (the symmetric half)."""
    C = _dct_matrix_np(n)
    h = n // 2
    return (torch.as_tensor(C[0::2, :h], dtype=dtype, device=device),
            torch.as_tensor(C[1::2, :h], dtype=dtype, device=device))


def _folded_last(x: torch.Tensor, E, O, inverse: bool) -> torch.Tensor:
    h = E.shape[1]
    if not inverse:
        lo, hi_r = x[..., :h], x[..., h:].flip(-1)
        return torch.cat([torch.matmul(lo + hi_r, E.T),
                          torch.matmul(lo - hi_r, O.T)], -1)
    a = torch.matmul(x[..., :h], E)
    b = torch.matmul(x[..., h:], O)
    return torch.cat([a + b, (a - b).flip(-1)], -1)


def _apply_axis_folded(x: torch.Tensor, n: int, axis: int,
                       inverse: bool) -> torch.Tensor:
    """One folded DCT factor; output (forward) / input (inverse) frequency
    order is [k=0,2,..,n-2, 1,3,..,n-1] — pair with :func:`_eigs_1d_np`."""
    E, O = _folded_matrices(n, x.dtype, x.device)
    return _folded_last(x.movedim(axis, -1), E, O, inverse).movedim(-1, axis)


# ---------------------------------------------------------- FFT transforms

def _ortho_scale_np(n: int) -> np.ndarray:
    """Per-frequency scale mapping the unnormalized DCT-II (2*sum cos) to
    the orthonormal convention of the matrix route."""
    s = np.full(n, np.sqrt(1.0 / (2.0 * n)))
    s[0] = np.sqrt(1.0 / (4.0 * n))
    return s


def _half_shift_np(n: int) -> np.ndarray:
    """exp(-i*pi*k/(2n)) for k = 0..n-1 (the Makhoul half-sample shift)."""
    k = np.arange(n)
    return np.exp(-1j * np.pi * k / (2.0 * n))


def _complex_dtype(dtype):
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def _fft_twiddles(n: int, dtype, device):
    """(forward, inverse) twiddle vectors of :func:`_dct_fft_last` and
    :func:`_idct_fft_last`."""
    ctype = _complex_dtype(dtype)
    fwd = _half_shift_np(n) * _ortho_scale_np(n)
    inv = np.conj(_half_shift_np(n)) / _ortho_scale_np(n)
    return (torch.as_tensor(fwd, dtype=ctype, device=device),
            torch.as_tensor(inv, dtype=ctype, device=device))


def _dct_fft_last(x: torch.Tensor, tw=None) -> torch.Tensor:
    """Orthonormal DCT-II along the last axis via a length-2n real FFT.

    The even extension w = [x, reverse(x)] has
    ``rfft(w)[k] = exp(i*pi*k/(2n)) * (2 * sum_i x[i] cos(pi k (2i+1)/(2n)))``,
    so one rfft and a pointwise twiddle give the transform exactly."""
    n = x.shape[-1]
    if tw is None:
        tw = _fft_twiddles(n, x.dtype, x.device)[0]
    W = torch.fft.rfft(torch.cat([x, x.flip(-1)], -1), dim=-1)[..., :n]
    return (W * tw).real.to(x.dtype)


def _idct_fft_last(y: torch.Tensor, tw=None) -> torch.Tensor:
    """Inverse of :func:`_dct_fft_last` (orthonormal DCT-III)."""
    n = y.shape[-1]
    if tw is None:
        tw = _fft_twiddles(n, y.dtype, y.device)[1]
    # W[k] = exp(i*pi*k/(2n)) * y[k]/s[k] rebuilds the rfft of the even
    # extension; W[n] = 0 by the extension's antisymmetry at Nyquist
    W = y.to(tw.dtype) * tw
    W = torch.cat([W, W.new_zeros(W.shape[:-1] + (1,))], -1)
    return torch.fft.irfft(W, n=2 * n, dim=-1)[..., :n].to(y.dtype)


# ------------------------------------------------------ routed transforms

def _transform(x: torch.Tensor, mat: torch.Tensor, axis: int) -> torch.Tensor:
    """Apply an (n, n) transform matrix along one axis of a field."""
    y = torch.matmul(x.movedim(axis, -1), mat.T)
    return y.movedim(-1, axis)


class _AxisTransform:
    """The forward and inverse DCT of one axis length on one device, routed
    as ``mode``, with its matrices (or twiddles) built once."""

    def __init__(self, n: int, mode: str, dtype, device):
        self.mode = mode
        if mode == "dense":
            self.mat = _matrix(n, dtype, device)
        elif mode == "fold":
            self.E, self.O = _folded_matrices(n, dtype, device)
        elif mode == "fft":
            self.tw = _fft_twiddles(n, dtype, device)
        else:
            raise ValueError(f"unknown transform route {mode!r}")

    def __call__(self, x: torch.Tensor, axis: int,
                 inverse: bool) -> torch.Tensor:
        if self.mode == "dense":
            return _transform(x, self.mat.T if inverse else self.mat, axis)
        x = x.movedim(axis, -1)
        if self.mode == "fold":
            y = _folded_last(x, self.E, self.O, inverse)
        elif inverse:
            y = _idct_fft_last(x, self.tw[1])
        else:
            y = _dct_fft_last(x, self.tw[0])
        return y.movedim(-1, axis)


class SeparableDCT:
    """The separable DCT over the trailing ``len(ns)`` axes of fields of
    one shape, dtype and device, each axis routed by ``modes`` (resolved
    once by the caller; None = the solve-path routes of ``device``)."""

    def __init__(self, ns, dtype, device, modes=None):
        self.modes = tuple(modes or _solve_modes(ns, device))
        self.axes = [_AxisTransform(n, m, dtype, device)
                     for n, m in zip(ns, self.modes)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = len(self.axes)
        for i, ax in enumerate(self.axes):
            x = ax(x, i - d, inverse=False)
        return x

    def inverse(self, x: torch.Tensor) -> torch.Tensor:
        d = len(self.axes)
        for i, ax in enumerate(self.axes):
            x = ax(x, i - d, inverse=True)
        return x


def _apply_axis(x: torch.Tensor, n: int, axis: int, inverse: bool,
                mode: str | None = None) -> torch.Tensor:
    """One separable DCT factor.  ``mode`` is a route resolved by the
    caller (solve paths); None routes it here for a natural-order
    transform, which never folds."""
    if mode is None:
        mode = _natural_modes((n,), x.device)[0]
    return _AxisTransform(n, mode, x.dtype, x.device)(x, axis, inverse)


def dct3(x: torch.Tensor) -> torch.Tensor:
    """Separable orthonormal DCT-II over the (Nt, Ny, Nx) axes."""
    for axis in (-3, -2, -1):
        x = _apply_axis(x, x.shape[axis], axis, inverse=False)
    return x


def idct3(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`dct3` (transforms are orthonormal)."""
    for axis in (-3, -2, -1):
        x = _apply_axis(x, x.shape[axis], axis, inverse=True)
    return x


def _dct3_solve(x: torch.Tensor, modes=None) -> torch.Tensor:
    """3-D DCT for spectral solves, routed per ``modes`` (the caller's
    single :func:`_solve_modes` resolution; None resolves here);
    coefficient order matches :func:`_eigs_1d_np` per axis."""
    return SeparableDCT(x.shape[-3:], x.dtype, x.device, modes).forward(x)


def _idct3_solve(x: torch.Tensor, modes=None) -> torch.Tensor:
    return SeparableDCT(x.shape[-3:], x.dtype, x.device, modes).inverse(x)


# ------------------------------------------------------------ stepA solves

def stepA_spectrum(Nt: int, Ny: int, Nx: int, r: float, reg_epsilon: float,
                   dtype=np.float32) -> np.ndarray:
    """Eigenvalues of A = -r*L_st + r*eps*I on the DCT-II tensor basis."""
    lt = _neumann_eigenvalues_np(Nt)[:, None, None]
    ly = _neumann_eigenvalues_np(Ny)[None, :, None]
    lx = _neumann_eigenvalues_np(Nx)[None, None, :]
    return (-r * (lt + ly + lx) + r * reg_epsilon).astype(dtype)


def _stepA_spectrum_ingraph(Nt, Ny, Nx, r, reg_epsilon, dtype, modes,
                            device) -> torch.Tensor:
    """Spectrum of ``A = -r*L_st + r*eps*I`` as the JAX solver assembles it
    in its graph: the three 1-D eigenvalue vectors, in the order of the
    transforms routed as ``modes``, cast to the field's dtype first, then
    combined as ``-r*(lt + ly + lx) + r*eps`` in that dtype."""
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    lt, ly, lx = (torch.as_tensor(_eigs_1d_np(n, m).astype(np_dtype),
                                  device=device)
                  for n, m in zip((Nt, Ny, Nx), modes))
    return (-r * (lt[:, None, None] + ly[None, :, None]
                  + lx[None, None, :]) + r * reg_epsilon)


@contextmanager
def _tf32_matmul(device):
    """Float32 matmuls on ``device`` in TF32 inside the block, the
    setting restored after it (only the cuda matmul flag, as
    ``sinkhorn._f32_matmul`` does).  A no-op on the CPU, whose matmuls are
    full precision (as JAX's CPU ignores ``Precision.DEFAULT``)."""
    if torch.device(device).type != "cuda":
        yield
        return
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


class StepAPlan:
    """The transforms and spectrum of one stepA system on one device,
    routes resolved once and matrices built once, reused by every solve of
    that system.  At the sweep shape every axis is dense.

    A lockstep batch solves (B, Nt, Ny, Nx) fields.  With a per-pair ``r``
    (a ``lockstep.PerPair``) the spectrum depends on the pair, so it is
    built per pair, each exactly as a single pair's plan builds it (not a
    shared spectrum scaled per pair, which would round differently), and
    stacked to (B, Nt, Ny, Nx)."""

    def __init__(self, shape, r, reg_epsilon: float, dtype, device):
        Nt, Ny, Nx = shape[-3:]
        self.r, self.reg_epsilon = r, reg_epsilon
        self.dct = SeparableDCT((Nt, Ny, Nx), dtype, device)
        rs = r.values if isinstance(r, PerPair) else (r,)
        spec = [_stepA_spectrum_ingraph(Nt, Ny, Nx, v, reg_epsilon, dtype,
                                        self.dct.modes, device) for v in rs]
        self.spec = torch.stack(spec) if isinstance(r, PerPair) else spec[0]

    def solve(self, F: torch.Tensor) -> torch.Tensor:
        """The exact solve, full float32 (or float64) products."""
        return self.dct.inverse(self.dct.forward(F) / self.spec)

    def solve_refined(self, F: torch.Tensor, refine: int) -> torch.Tensor:
        """Low-precision spectral inverse ``M`` plus ``refine`` steps of
        iterative refinement against the exact stencil operator:

            phi  = M(F)
            phi += M(F - A(phi))  x refine

        ``M`` runs its products in TF32 on cuda (full precision on the
        CPU); ``A = -r*L_st + r*eps*I`` and the residual stay full
        precision."""
        r, eps = self.r, self.reg_epsilon

        def M(b):
            with _tf32_matmul(b.device):
                return self.solve(b)

        def A(phi):
            return -r * operators.laplacian_st(phi, bc="N") \
                + (r * eps) * phi

        phi = M(F)
        for _ in range(refine):
            phi = phi + M(F - A(phi))
        return phi


def solve_stepA_dct(F: torch.Tensor, r: float = 1.0,
                    reg_epsilon: float = 1e-2) -> torch.Tensor:
    """Exact solve of ``(-r*L_st + r*eps*I) phi = F`` via 3-D DCT."""
    return StepAPlan(F.shape, float(r), float(reg_epsilon), F.dtype,
                     F.device).solve(F)


def solve_stepA_dct_refined(F: torch.Tensor, r: float = 1.0,
                            reg_epsilon: float = 1e-2,
                            refine: int = 3) -> torch.Tensor:
    """Spectral stepA with low-precision transforms plus ``refine`` steps
    of iterative refinement (:meth:`StepAPlan.solve_refined`).

    The JAX package runs the transforms at the MXU's one-pass bf16 and
    measured that ``refine=3`` reaches the production ALG2 tolerance on a
    v5e (refine 1/2 stalled), hence the default.  TF32 keeps three more
    mantissa bits than bf16."""
    return StepAPlan(F.shape, float(r), float(reg_epsilon), F.dtype,
                     F.device).solve_refined(F, int(refine))


# ----------------------------------------------------------- 2-D (GN) case

def dct2(x: torch.Tensor) -> torch.Tensor:
    """Separable orthonormal DCT-II over the trailing (Ny, Nx) axes."""
    x = _apply_axis(x, x.shape[-2], -2, inverse=False)
    return _apply_axis(x, x.shape[-1], -1, inverse=False)


def idct2(x: torch.Tensor) -> torch.Tensor:
    x = _apply_axis(x, x.shape[-2], -2, inverse=True)
    return _apply_axis(x, x.shape[-1], -1, inverse=True)


def _dct2_solve(x: torch.Tensor, modes=None) -> torch.Tensor:
    """2-D DCT for spectral solves, routed per ``modes``; coefficient order
    matches :func:`neg_lap2d_spectrum_solve` for the same modes."""
    return SeparableDCT(x.shape[-2:], x.dtype, x.device, modes).forward(x)


def _idct2_solve(x: torch.Tensor, modes=None) -> torch.Tensor:
    return SeparableDCT(x.shape[-2:], x.dtype, x.device, modes).inverse(x)


def neg_lap2d_spectrum_solve(Ny: int, Nx: int, dtype=np.float64,
                             modes=None, device="cpu") -> np.ndarray:
    """:func:`neg_lap2d_spectrum` in the per-axis order emitted by the
    solve-path transforms routed as ``modes`` (None = the routes of
    ``device``)."""
    modes = modes or _solve_modes((Ny, Nx), device)
    ly = -_eigs_1d_np(Ny, modes[0])[:, None]
    lx = -_eigs_1d_np(Nx, modes[1])[None, :]
    return (ly + lx).astype(dtype)


def neg_lap2d_spectrum(Ny: int, Nx: int, dtype=np.float64) -> np.ndarray:
    """Eigenvalues of ``-lap_gn`` (= Dx^T Dx + Dy^T Dy with forward/'N'
    differences, reference classical.py:102-104) on the 2-D DCT-II basis:
    ``2 - 2 cos(pi k/n)`` per axis."""
    ly = -_neumann_eigenvalues_np(Ny)[:, None]
    lx = -_neumann_eigenvalues_np(Nx)[None, :]
    return (ly + lx).astype(dtype)
