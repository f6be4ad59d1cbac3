"""Drop-in compatibility layer: the reference's flat-array API surface.

Counterpart of ``ofot_tpu.compat`` on the PyTorch port.  Reference users
call module-level functions on flat row-major arrays
(``utils.py``/``benamou_brenier.py``/``classical.py`` interfaces); this
module exposes the same names and positional signatures, so existing
scripts switch with an import change:

    import ofot_tpu_torch.compat as utils     # reference utils.py surface
    from ofot_tpu_torch.compat import solve   # benamou_brenier.solve
    from ofot_tpu_torch.compat import GLLOpticalFlow

All functions accept/return numpy arrays in the reference's flat layouts
(pixel (i, j) -> i*w + j; space-time slice n -> [n*Nx*Ny : (n+1)*Nx*Ny];
3-vector fields component-outermost).  The functions that compute on
tensors take a trailing keyword ``device``: the card (``"cuda"``) unless
the caller asks for the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ofot_tpu_torch.solvers.gn import GLLOpticalFlow  # noqa: F401  (re-export)


def _field(a, shape, device):
    return torch.as_tensor(np.asarray(a).reshape(shape), device=device)


def _flat(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().ravel()


# ---------------------------------------------------------------- utils.py

def openGrayscaleImage(pathname):
    from ofot_tpu_torch.utils.image import open_grayscale
    f, w, h = open_grayscale(pathname)
    return f.ravel(), w, h


def openFlo(pathname):
    from ofot_tpu_torch.utils.flo import read_flo
    return read_flo(pathname)


def saveFlo(w, h, u, v, pathname):
    from ofot_tpu_torch.utils.flo import write_flo
    write_flo(w, h, u, v, pathname)


def apply_opticalflow(f1, u, v, w, h, m=None, *, device="cuda"):
    from ofot_tpu_torch.utils.warp import apply_flow
    # the reference's no-luminosity sentinel is np.array([None]) (an
    # object-dtype array, reference utils.py:186,202) — accept it, plain
    # None, or a real (w*h,) field
    m_np = None if m is None else np.asarray(m)
    if m_np is not None and m_np.dtype == object:
        m_np = None
    m2 = None if m_np is None else _field(m_np, (h, w), device)
    out = apply_flow(_field(f1, (h, w), device), _field(u, (h, w), device),
                     _field(v, (h, w), device), m2)
    return _flat(out)


def EE(w, h, u, v, uGT, vGT):
    from ofot_tpu_torch.utils.metrics import EE as _EE
    return _EE(w, h, u, v, uGT, vGT)


def AE(w, h, u, v, uGT, vGT):
    from ofot_tpu_torch.utils.metrics import AE as _AE
    return _AE(w, h, u, v, uGT, vGT)


def IE(w, h, I, IGT):
    from ofot_tpu_torch.utils.metrics import IE as _IE
    return _IE(w, h, np.asarray(I), np.asarray(IGT))


def opticalflow_from_benamoubrenier(phi, Nt, Nx, Ny, grad=None, div=None,
                                    *, device="cuda"):
    """(u, v, m) from a flat space-time potential.  The reference passes
    pre-built sparse ``grad``/``div`` operators (utils.py:148); the port
    owns its stencils, so those arguments are accepted and ignored."""
    from ofot_tpu_torch.solvers.flow_extract import flow_from_potential
    u, v, m = flow_from_potential(_field(phi, (Nt, Ny, Nx), device))
    return _flat(u), _flat(v), _flat(m)


def reconstructTrajectory(xStart, yStart, u, v, Nx, Ny, Nt):
    """Single-trajectory reference API (utils.py:44) — host-side numpy."""
    x_end, y_end = float(xStart), float(yStart)
    u = np.asarray(u)
    v = np.asarray(v)
    for n in range(Nt - 1):
        tx = max(0, min(Nx - 2, int(x_end)))
        ty = max(0, min(Ny - 2, int(y_end)))
        dx = x_end - tx
        dy = y_end - ty
        w1 = (1 - dy) * (1 - dx)
        w2 = dx * (1 - dy)
        w3 = dy * dx
        w4 = (1 - dx) * dy
        i00 = ty * Nx + tx
        x_end += (w1 * u[n, i00] + w2 * u[n, i00 + 1]
                  + w3 * u[n, i00 + Nx + 1] + w4 * u[n, i00 + Nx])
        y_end += (w1 * v[n, i00] + w2 * v[n, i00 + 1]
                  + w3 * v[n, i00 + Nx + 1] + w4 * v[n, i00 + Nx])
    return [x_end - xStart, y_end - yStart]


# ------------------------------------------------------- benamou_brenier.py

def solve(rho0, rhoT, Nt, Nx, Ny, r=1, convergence_tol=0.3,
          reg_epsilon=1e-3, max_it=100, *, device="cuda"):
    """Reference ``benamou_brenier.solve`` signature -> flat (u, v, m),
    with the reference's CG stepA (the JAX twin's default ops)."""
    from ofot_tpu_torch.solvers import foto
    res = foto.solve(_field(rho0, (Ny, Nx), device),
                     _field(rhoT, (Ny, Nx), device),
                     Nt, r=r, convergence_tol=convergence_tol,
                     reg_epsilon=reg_epsilon, max_it=max_it)
    return _flat(res.u), _flat(res.v), _flat(res.m)
