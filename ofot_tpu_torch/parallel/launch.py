"""Start a world of local processes and join it under a time limit.

The distribution layer runs one process per rank.  ``run`` starts a whole
world of ``spawn``-method processes that meet at a file rendezvous in a
fresh temporary directory (never a fixed port), runs one function on every
rank and returns each rank's result, handing the function and its
arguments to the ranks through a file in that directory (the spawn pipe
would make the parent wait, writing a large argument, until each rank in
turn has imported torch, so the ranks would start one after another);
``start`` starts the ranks from 1 up, for a process that goes on as rank 0
itself (the pipeline's ``--data-parallel``).  A rank that exits with an
error, or outlives the time limit, fails the whole world: the survivors
are killed and ``WorldError`` names the ranks.  The backend is gloo unless
the caller asks for another: the processes of one card share it over gloo,
since NCCL refuses two ranks on one device.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import tempfile
import time
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist

from ofot_tpu_torch.parallel import multihost
from ofot_tpu_torch.parallel.mesh import TIMEOUT


class WorldError(RuntimeError):
    """A rank of a local world failed or timed out."""


def rendezvous(workdir) -> str:
    """A file init method in ``workdir`` (the file must not exist yet)."""
    return Path(workdir, "rendezvous").resolve().as_uri()


def _rank_main(fn, rank, world, init_method, backend, threads, timeout,
               out, args):
    if threads:
        torch.set_num_threads(threads)
    multihost.initialize(init_method=init_method, num_processes=world,
                         process_id=rank, backend=backend, timeout=timeout)
    try:
        result = fn(*args)
        if out is not None:
            torch.save(result, Path(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _call_saved(path):
    fn, args = torch.load(path, weights_only=False)
    return fn(*args)


def start(fn, world: int, init_method: str, *args, backend="gloo",
          first=1, threads=0, timeout: timedelta = TIMEOUT,
          out=None) -> list:
    """Start ranks ``first``..``world - 1``, each joining ``init_method``
    and calling ``fn(*args)`` (``fn`` importable by name: it is pickled by
    its module path); ``out``: a directory each rank saves its result to.
    ``threads``: torch's intra-op threads per rank (0: torch's default)."""
    ctx = mp.get_context("spawn")
    procs = []
    for rank in range(first, world):
        p = ctx.Process(target=_rank_main, name=f"rank{rank}",
                        args=(fn, rank, world, init_method, backend, threads,
                              timeout, out, args))
        p.start()
        procs.append(p)
    return procs


def join(procs, seconds: float) -> None:
    """Wait for every process, at most ``seconds`` in all; kill the rest
    and raise ``WorldError`` if any failed or ran out of time."""
    end = time.monotonic() + seconds
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    late = [p.name for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    failed = [f"{p.name} (exit {p.exitcode})" for p in procs
              if p.exitcode not in (0, None)]
    if late or failed:
        raise WorldError("local world failed: "
                         + ", ".join([f"{n} timed out after {seconds} s"
                                      for n in late] + failed))


def run(fn, world: int, *args, backend="gloo", threads=1,
        seconds: float = 300.0) -> list:
    """``fn(*args)`` on every rank of a fresh local world of ``world``
    processes -> the ranks' results, in rank order."""
    with tempfile.TemporaryDirectory() as tmp:
        call = Path(tmp, "call.pt")
        torch.save((fn, args), call)
        procs = start(_call_saved, world, rendezvous(tmp), str(call),
                      backend=backend, first=0, threads=threads, out=tmp,
                      timeout=timedelta(seconds=seconds))
        join(procs, seconds)
        return [torch.load(Path(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]


def cpu_threads(world: int) -> int:
    """Intra-op threads for each of ``world`` ranks sharing this host's
    cores."""
    return max(1, (os.cpu_count() or 1) // world)
