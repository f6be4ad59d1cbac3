"""Meshes of ranks: the (data, y, x) layout of the distribution layer.

Counterpart of ``ofot_tpu.parallel.mesh``.  JAX lays the devices of one
program out on a ``jax.sharding.Mesh``; here the unit is a process (a rank
of a ``torch.distributed`` world) that computes on one device, and a mesh
lays the ranks out on named axes:

  * ``data``: a batch of independent sequences (pure data parallelism);
  * ``y, x``: a spatial tile decomposition of the image grid, whose
    stencil halos travel between neighbouring ranks (``parallel/halo.py``).

Every axis line and every (y, x) plane gets its own process group, made
with a timeout, so that a collective some rank never joins fails instead
of hanging; the groups also back a ``torch.distributed.device_mesh.
DeviceMesh`` with the axis names (``Mesh.device_mesh``, built with
``DeviceMesh.from_group``: ``init_device_mesh`` makes its own groups,
with the default timeout).

Transport: gloo on the CPU, and NCCL where each rank has a card of its
own.  NCCL refuses two ranks on one device, so a world of more than one
rank on one card shares ``cuda:0`` over a gloo group, and every
collective stages its CUDA tensors through host memory (``Mesh.staged``).

Tiles: ``tile`` takes this rank's (y, x) block of a full field (the
counterpart of placing an array with ``field_sharding``), and ``gather``
puts the blocks of every rank of the plane back together.
"""

from __future__ import annotations

import math
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

# the longest any collective may wait for a peer
TIMEOUT = timedelta(minutes=10)

SPATIAL = ("y", "x")


def rank_device(platform: str, rank: int) -> torch.device:
    """The device rank ``rank`` computes on: ``cuda:{rank % cards}``, or
    the CPU when ``platform`` is ``cpu``.  ``cuda`` without a card raises
    instead of falling back to the CPU."""
    if platform == "cpu":
        return torch.device("cpu")
    if platform != "cuda":
        raise ValueError(f"unknown platform {platform!r} (cuda or cpu)")
    if not torch.cuda.is_available():
        raise RuntimeError("platform 'cuda' but torch sees no CUDA device; "
                           "ask for the CPU (platform='cpu') to run there")
    return torch.device("cuda", rank % torch.cuda.device_count())


class Mesh:
    """Ranks ``ranks`` (an integer array of the mesh's shape) on the named
    axes ``names``; this rank's coordinates, device and groups.

    Build one with :func:`make_mesh` (a collective call: every rank of the
    world makes the same mesh)."""

    def __init__(self, names, ranks: np.ndarray, device: torch.device,
                 timeout: timedelta = TIMEOUT):
        self.names = tuple(names)
        self.ranks = ranks
        self.device = torch.device(device)
        self.backend = dist.get_backend()
        # gloo takes CPU tensors only for some collectives: stage them all
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        rank = dist.get_rank()
        where = np.argwhere(ranks == rank)
        self.coord = (dict(zip(self.names, map(int, where[0])))
                      if len(where) else None)
        self._groups = {}
        for axis, name in enumerate(self.names):
            # one group per line along the axis; every rank creates all of
            # them, in the same order
            lines = np.moveaxis(ranks, axis, -1).reshape(-1, ranks.shape[axis])
            for line in lines:
                g = dist.new_group(line.tolist(), timeout=timeout)
                if rank in line:
                    self._groups[name] = g
        # one group per (y, x) plane: the ranks that tile one field
        other = [a for a, n in enumerate(self.names) if n not in SPATIAL]
        planes = np.moveaxis(ranks, other, list(range(len(other))))
        planes = planes.reshape(-1, self.size("y") * self.size("x"))
        self.plane = None
        for plane in planes:
            g = dist.new_group(plane.tolist(), timeout=timeout)
            if rank in plane:
                self.plane = g
                # the order all_gather returns the plane's blocks in
                self.plane_ranks = dist.get_process_group_ranks(g)
        self.device_mesh = None
        if self.coord is not None:
            self.device_mesh = DeviceMesh.from_group(
                [self._groups[n] for n in self.names],
                "cuda" if self.backend == "nccl" else "cpu",
                mesh=torch.as_tensor(ranks), mesh_dim_names=self.names)

    @property
    def shape(self) -> dict[str, int]:
        """{axis: size}, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.names, self.ranks.shape))

    def size(self, name: str) -> int:
        """The size of axis ``name`` (1 for an axis the mesh lacks)."""
        return self.shape.get(name, 1)

    def index(self, name: str) -> int:
        """This rank's coordinate on axis ``name`` (0 if the mesh lacks
        it)."""
        self._member()
        return self.coord.get(name, 0)

    def group(self, name: str):
        """The process group of this rank's line along axis ``name``."""
        self._member()
        return self._groups[name]

    def neighbour(self, name: str, step: int) -> int | None:
        """The global rank ``step`` places along axis ``name`` from this
        one, or None past the mesh's edge."""
        coord = dict(self.coord)
        coord[name] += step
        if not 0 <= coord[name] < self.size(name):
            return None
        return int(self.ranks[tuple(coord[n] for n in self.names)])

    def _member(self) -> None:
        if self.coord is None:
            raise ValueError(f"rank {dist.get_rank()} is not in the mesh "
                             f"{self.shape}")

    # ------------------------------------------------------- collectives

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.staged else t

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM,
                   group=None) -> torch.Tensor:
        """``t`` reduced over ``group`` (default: this rank's plane), as a
        new tensor on this rank's device; every rank of the group gets the
        same bits."""
        self._member()
        buf = self._host(t).clone()
        dist.all_reduce(buf, op=op, group=group or self.plane)
        return buf.to(self.device)

    def all_gather(self, t: torch.Tensor, group) -> list[torch.Tensor]:
        """``t`` of every rank of ``group``, in the group's rank order."""
        buf = self._host(t.contiguous())
        out = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
        dist.all_gather(out, buf, group=group)
        return [o.to(self.device) for o in out]

    def exchange(self, sends, recvs) -> list[torch.Tensor]:
        """Point-to-point: send each ``(rank, tensor)`` of ``sends`` and
        receive one tensor shaped like ``like`` from each ``(rank, like)``
        of ``recvs``, all posted at once as non-blocking pairs."""
        ops, bufs = [], []
        for peer, t in sends:
            ops.append(dist.P2POp(dist.isend, self._host(t.contiguous()),
                                  peer))
        for peer, like in recvs:
            b = torch.empty(like.shape, dtype=like.dtype,
                            device="cpu" if self.staged else like.device)
            bufs.append(b)
            ops.append(dist.P2POp(dist.irecv, b, peer))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return [b.to(self.device) for b in bufs]

    # ------------------------------------------------------------- tiles

    def check_grid(self, ny: int, nx: int) -> None:
        """Refuse a grid the (y, x) axes do not divide, or tiles under 2
        lines along a split axis (the boundary rows touch two lines)."""
        py, px = self.size("y"), self.size("x")
        if ny % py or nx % px:
            raise ValueError(f"grid {(ny, nx)} not divisible by mesh "
                             f"{(py, px)}")
        if (py > 1 and ny // py < 2) or (px > 1 and nx // px < 2):
            raise ValueError("local tiles must be >= 2 pixels per sharded "
                             "axis")

    def tile(self, field) -> torch.Tensor:
        """This rank's (y, x) block of a full field (trailing axes
        (Ny, Nx)), contiguous, on this rank's device."""
        field = torch.as_tensor(field)
        ny = field.shape[-2] // self.size("y")
        nx = field.shape[-1] // self.size("x")
        iy, ix = self.index("y"), self.index("x")
        return field[..., iy * ny:(iy + 1) * ny,
                     ix * nx:(ix + 1) * nx].to(self.device).contiguous()

    def gather(self, tile: torch.Tensor) -> torch.Tensor:
        """The full field whose blocks the ranks of this rank's plane
        hold (each rank gets all of it)."""
        self._member()
        parts = self.all_gather(tile, self.plane)
        py, px = self.size("y"), self.size("x")
        grid = [[None] * px for _ in range(py)]
        for rank, part in zip(self.plane_ranks, parts):
            where = np.argwhere(self.ranks == rank)[0]
            c = dict(zip(self.names, where))
            grid[c.get("y", 0)][c.get("x", 0)] = part
        return torch.cat([torch.cat(row, dim=-1) for row in grid], dim=-2)


def shard_pair(rho0, rhoT, mesh: Mesh):
    """This rank's (y, x) tiles of a pair of full (Ny, Nx) frames, on its
    device, after refusing a grid the mesh does not divide: the one place
    a tiled solve tiles its frames (``gspmd.shard_pair``)."""
    mesh.check_grid(*torch.as_tensor(rho0).shape[-2:])
    return mesh.tile(rho0), mesh.tile(rhoT)


def make_mesh(shape: dict[str, int] | None = None, *, platform="cuda",
              timeout: timedelta = TIMEOUT) -> Mesh:
    """Build a mesh from an {axis: size} spec, e.g. {"data": 2, "y": 2,
    "x": 2}, over the ranks of the default process group (data-outermost,
    row-major).  With no spec: every rank on a 1-D ``data`` axis.

    Collective: every rank calls it with the same spec.  A spec that needs
    more ranks than the world has raises ``ValueError``; ranks past the
    mesh's size are left out of it.  ``platform``: ``cuda`` (each rank on
    ``cuda:{rank % cards}``) or ``cpu``."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.multihost."
                           "initialize (or torch.distributed."
                           "init_process_group) first")
    world = dist.get_world_size()
    if shape is None:
        shape = {"data": world}
    n = math.prod(shape.values())
    if n > world:
        raise ValueError(f"mesh {shape} needs {n} ranks, have {world}")
    ranks = np.arange(n).reshape(tuple(shape.values()))
    return Mesh(shape.keys(), ranks, rank_device(platform, dist.get_rank()),
                timeout)


def spatial_mesh(ny_tiles: int, nx_tiles: int, **kw) -> Mesh:
    """(y, x) tile mesh for one big grid split across ranks."""
    return make_mesh({"y": ny_tiles, "x": nx_tiles}, **kw)


def batch_spatial_mesh(n_data: int, ny_tiles: int, nx_tiles: int,
                       **kw) -> Mesh:
    """(data, y, x) mesh: sequences split over ``data``, each grid tiled
    over (y, x)."""
    return make_mesh({"data": n_data, "y": ny_tiles, "x": nx_tiles}, **kw)
