"""Spatially tiled FOTO solve on a (y, x) mesh of ranks.

The twin of the JAX package's ``examples/sharded_solve.py``.  A rank is a
process (``parallel.launch.run`` starts the world); the mesh follows
JAX's rule from the number of ranks (2 or more: two tiles along y; 4 or
more: two along x too):

  * on the card, one rank a card: a 1x1 mesh on one H100 (NCCL), as JAX
    on one TPU;
  * on the CPU (``--platform cpu``), a local gloo world of 4 ranks, in
    place of JAX's virtual CPU devices: a 2x2 mesh.

Run: python -m ofot_tpu_torch.examples.sharded_solve [--platform cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ofot_tpu_torch.examples import parse
from ofot_tpu_torch.parallel import launch, multihost

CPU_RANKS = 4


def solve_on_rank(platform: str) -> dict:
    """Every rank's part: the mesh, the tiled solve, the rank's result."""
    import torch.distributed as dist
    from ofot_tpu_torch.ops import kernels
    from ofot_tpu_torch.parallel import foto_sharded, mesh as meshlib

    n_dev = dist.get_world_size()
    py = 2 if n_dev >= 2 else 1
    px = 2 if n_dev >= 4 else 1
    mesh = meshlib.spatial_mesh(py, px, platform=platform)

    n = 64
    f1 = np.zeros((n, n), np.float32); f1[10:30, 10:30] = 1.0
    f2 = np.zeros((n, n), np.float32); f2[16:36, 16:36] = 1.0

    st = foto_sharded.solve_potential_tiled(
        torch.from_numpy(f1), torch.from_numpy(f2), 8, mesh,
        r=1.0, convergence_tol=0.05, reg_epsilon=1e-2, max_it=40)
    cuda = mesh.device.type == "cuda"
    return dict(mesh=mesh.shape, n_dev=n_dev, iterations=int(st.iteration),
                crit=float(st.crit), phi_shape=tuple(st.phi.shape),
                launches=kernels.launch_counts(),
                peak_mib=(torch.cuda.max_memory_allocated(mesh.device)
                          / 2 ** 20 if cuda else None))


def main(argv=None) -> dict:
    args = parse(argv, __doc__)
    world = (torch.cuda.device_count() if args.platform == "cuda"
             else CPU_RANKS)
    # named through the package, so that every rank imports it by name
    from ofot_tpu_torch.examples import sharded_solve
    out = launch.run(sharded_solve.solve_on_rank, world, args.platform,
                     backend=multihost.default_backend(world)
                     if args.platform == "cuda" else "gloo",
                     seconds=600.0)[0]
    print(f"mesh: {out['mesh']} over {out['n_dev']} devices")
    print(f"iterations={out['iterations']} crit={out['crit']:.4f} "
          f"phi shape={out['phi_shape']}")
    return out


if __name__ == "__main__":
    main()
