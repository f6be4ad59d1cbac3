"""Checkpoint / resume of FOTO solver state (.npz).

The file layout is the JAX package's (``ofot_tpu/utils/checkpoint.py:25-34``):
one .npz with arrays ``mu``, ``q``, ``phi``, ``crit``, ``prev_crit``,
``iteration`` (int32), ``cg_iterations`` (int32) and ``done`` (bool), so a
state saved by either package resumes in the other.
"""

from __future__ import annotations

import numpy as np
import torch

from ofot_tpu_torch.solvers.foto import FotoState

_FLOAT_FIELDS = ("mu", "q", "phi", "crit", "prev_crit")


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def state_to_arrays(state: FotoState) -> dict[str, np.ndarray]:
    """A ``FotoState`` as host arrays in the .npz layout."""
    out = {k: getattr(state, k).detach().cpu().numpy() for k in _FLOAT_FIELDS}
    out["iteration"] = np.asarray(state.iteration, np.int32)
    out["cg_iterations"] = np.asarray(state.cg_iterations, np.int32)
    out["done"] = np.asarray(bool(state.done))
    return out


def state_from_arrays(arrays, device, dtype=None) -> FotoState:
    """A ``FotoState`` on ``device`` from arrays in the .npz layout (a dict
    or an open ``np.load`` result); ``dtype`` casts the float fields."""
    # np.array copies: arrays from np.load are read-only
    fields = {k: torch.as_tensor(np.array(arrays[k]), device=device)
              for k in _FLOAT_FIELDS}
    if dtype is not None:
        fields = {k: t.to(dtype) for k, t in fields.items()}
    return FotoState(
        **fields,
        iteration=int(arrays["iteration"]),
        cg_iterations=int(arrays["cg_iterations"]),
        done=torch.as_tensor(bool(arrays["done"]), device=device))


def save_state(path: str, state: FotoState) -> None:
    """Save a ``FotoState`` to ``path`` (.npz appended when missing)."""
    np.savez(_npz_path(path), **state_to_arrays(state))


def load_state(path: str, device, dtype=None) -> FotoState:
    """Load a state saved by :func:`save_state` or by the JAX package."""
    with np.load(_npz_path(path)) as z:
        return state_from_arrays(z, device, dtype)
