"""Multi-process execution scaffolding.

Counterpart of ``ofot_tpu.parallel.multihost``.  Two ways to scale the
sweep beyond one process:

1. **SPMD over processes** — ``initialize()`` joins a
   ``torch.distributed`` world (where JAX's joins
   ``jax.distributed``); afterwards the meshes of
   ``ofot_tpu_torch.parallel.mesh`` lay the world's ranks out, and the
   tiled and data-parallel solves run over them.  The transport is gloo
   on the CPU and NCCL where each rank has a card of its own; NCCL refuses
   two ranks on one device, so a world of more than one rank on one card
   shares ``cuda:0`` over gloo, staging through host memory.

2. **Embarrassing host partitioning** — independent Middlebury sequences
   need no communication at all, so ``partition_keys`` deterministically
   splits the sequence list across hosts; each host runs its share of the
   sweep with local flag-file resume, and the per-host manifest shards
   merge trivially (``merge_manifests``).
"""

from __future__ import annotations

import json
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist

from ofot_tpu_torch.parallel.mesh import TIMEOUT


def default_backend(world: int) -> str:
    """NCCL where every rank of a world of ``world`` can have a card of
    its own, gloo otherwise (NCCL refuses two ranks on one device)."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *,
               init_method: str | None = None, backend: str | None = None,
               timeout: timedelta = TIMEOUT) -> tuple[int, int]:
    """Join a ``torch.distributed`` world; returns (rank, world_size).

    ``coordinator_address`` ("host:port", rank 0's) or ``init_method``
    (e.g. ``file:///path``) names the rendezvous.  One process with no
    coordinator is a no-op that returns (0, 1); a process already in a
    world returns its place there.  ``backend``: default
    :func:`default_backend`.  The default group waits ``timeout`` at most
    for a peer."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if coordinator_address is None and init_method is None:
        if num_processes not in (None, 1):
            raise ValueError(f"{num_processes} processes need a "
                             "coordinator address or an init method")
        return 0, 1
    world = 1 if num_processes is None else int(num_processes)
    rank = 0 if process_id is None else int(process_id)
    backend = backend or default_backend(world)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=init_method or f"tcp://{coordinator_address}",
        world_size=world, rank=rank, timeout=timeout)
    return rank, world


def partition_keys(keys, process_id: int, process_count: int):
    """Deterministic round-robin split of sequence keys across hosts."""
    keys = sorted(keys)
    return [k for i, k in enumerate(keys) if i % process_count == process_id]


def merge_manifests(paths, out_path: str) -> dict:
    """Merge per-host manifest shards into one manifest.json."""
    merged: dict = {}
    for p in paths:
        p = Path(p)
        if p.exists():
            merged.update(json.loads(p.read_text()))
    Path(out_path).write_text(json.dumps(merged, indent=1))
    return merged
