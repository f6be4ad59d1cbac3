"""Checkpoint / resume of FOTO solver state.

Two backends, as the JAX package has:

  * ``save_state`` / ``load_state`` — one .npz in the JAX package's layout
    (``ofot_tpu/utils/checkpoint.py:25-34``): arrays ``mu``, ``q``,
    ``phi``, ``crit``, ``prev_crit``, ``iteration`` (int32),
    ``cg_iterations`` (int32) and ``done`` (bool), so a state saved by
    either package resumes in the other;
  * ``save_state_dcp`` / ``load_state_dcp`` — checkpoint directories of
    ``torch.distributed.checkpoint``, the counterpart of the JAX
    package's Orbax pair (``save_state_orbax``/``load_state_orbax``).  A
    state whose fields are tiles on a (y, x) mesh (``parallel/mesh.py``)
    is written distributed, each rank its own tiles (as DTensor shards),
    and restores onto a mesh or whole in one process, without gathering
    to one rank first.  The two packages do not read each other's
    directories.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch
import torch.distributed.checkpoint as dcp

if TYPE_CHECKING:       # the solvers import utils (their spans): no cycle
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
    from ofot_tpu_torch.solvers.foto import FotoState
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


_COUNTERS = ("iteration", "cg_iterations")


def _placements(t: torch.Tensor, mesh):
    from torch.distributed.tensor import Replicate, Shard

    split = {"y": Shard(t.dim() - 2), "x": Shard(t.dim() - 1)}
    return [split.get(name, Replicate()) for name in mesh.names]


def save_state_dcp(path: str, state: FotoState, mesh=None) -> None:
    """Save a ``FotoState`` as a ``torch.distributed.checkpoint``
    directory, from one process.

    ``mesh``: the fields ``mu``, ``q`` and ``phi`` are this rank's (y, x)
    tiles on that mesh, which spans the world (a collective call: every
    rank saves its tiles; the scalars are the same on every rank)."""
    from torch.distributed.tensor import DTensor

    sd = {k: getattr(state, k) for k in _FLOAT_FIELDS + ("done",)}
    sd.update({k: torch.as_tensor(getattr(state, k)) for k in _COUNTERS})
    if mesh is not None:
        for k in ("mu", "q", "phi"):
            sd[k] = DTensor.from_local(sd[k], mesh.device_mesh,
                                       _placements(sd[k], mesh))
    dcp.save(sd, checkpoint_id=str(path), no_dist=mesh is None)


def load_state_dcp(path: str, device="cuda", mesh=None) -> FotoState:
    """Load a state saved by :func:`save_state_dcp` (by one rank or many)
    onto ``device`` whole, or with a ``mesh`` as this rank's (y, x) tiles
    on the mesh's device (collective)."""
    from torch.distributed.tensor import DTensor

    meta = dcp.FileSystemReader(str(path)).read_metadata().state_dict_metadata
    device = mesh.device if mesh is not None else torch.device(device)
    sd = {}
    for k, m in meta.items():
        whole = torch.empty(m.size, dtype=m.properties.dtype, device=device)
        if mesh is not None and k in ("mu", "q", "phi"):
            tile = mesh.tile(whole)
            sd[k] = DTensor.from_local(tile, mesh.device_mesh,
                                       _placements(tile, mesh),
                                       shape=whole.shape,
                                       stride=whole.stride())
        else:
            sd[k] = whole
    dcp.load(sd, checkpoint_id=str(path), no_dist=mesh is None)
    fields = {k: v.to_local() if isinstance(v, DTensor) else v
              for k, v in sd.items()}
    from ofot_tpu_torch.solvers.foto import FotoState
    return FotoState(**{k: fields[k] for k in _FLOAT_FIELDS},
                     iteration=int(fields["iteration"]),
                     cg_iterations=int(fields["cg_iterations"]),
                     done=fields["done"])
