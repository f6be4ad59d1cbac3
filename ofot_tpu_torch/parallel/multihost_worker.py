"""Executable multi-process worker: one process per host (or per rank).

Counterpart of ``ofot_tpu.parallel.multihost_worker``.  It is both the
entry point of a multi-host sweep and the subject of the two-process
localhost test (tests/test_torch_multihost.py):

    python -m ofot_tpu_torch.parallel.multihost_worker \\
        --coordinator localhost:12355 --process-id 0 --num-processes 2 \\
        --out /tmp/host0.json [--platform cuda|cpu] \\
        [--data-root data --results results] [--checkpoint-dir ckpt]

``--coordinator`` is rank 0's ``host:port`` (or an init URL such as
``file:///path``).  Each worker:

1. joins the world (``multihost.initialize``): gloo on the CPU, NCCL where
   each rank has a card of its own; on one card the ranks share
   ``cuda:0`` over gloo, staging through host memory (NCCL refuses two
   ranks on one device);
2. all-reduces its rank over the world;
3. runs a small FOTO solve tiled over a (y, x) mesh of every rank
   (``gspmd.solve_foto_sharded``, the ``cg`` set: halo exchanges cross the
   process boundary), whose fingerprint every rank must share;
4. optionally writes the solve's tiles as a distributed checkpoint (every
   rank its own, ``torch.distributed.checkpoint``), restores them onto
   the mesh and fingerprints them again;
5. optionally runs its partition of the benchmark sweep
   (``pipeline run --host-id <rank>`` on ``--platform``), writing the
   per-host manifest shard that ``pipeline merge-manifests`` folds;
6. writes a JSON record of everything it measured to ``--out``, with
   each leg's wall seconds under ``leg_s``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist


def _smooth_pair(ny: int, nx: int, shift=(2.0, 1.0)):
    """Deterministic smooth density pair (every process builds the same
    input, since each takes its tile of the full frames)."""
    yy, xx = np.mgrid[0:ny, 0:nx].astype(np.float64)
    cy, cx = ny / 2.0, nx / 2.0

    def blob(dy, dx):
        r2 = ((yy - cy - dy) / (0.22 * ny)) ** 2 \
            + ((xx - cx - dx) / (0.22 * nx)) ** 2
        return 0.15 + np.exp(-r2)

    return blob(0.0, 0.0), blob(*shift)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="ofot_tpu_torch multi-process worker (one per host)")
    p.add_argument("--coordinator", required=True,
                   help="rank 0's host:port, or an init URL (file://...)")
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--platform", choices=["cuda", "cpu"], default="cuda",
                   help="device of every rank and of the sweep")
    p.add_argument("--out", required=True, help="result JSON path")
    p.add_argument("--data-root", default=None)
    p.add_argument("--results", default=None)
    p.add_argument("--datasets", default="middlebury-1")
    p.add_argument("--algos", default="GN")
    p.add_argument("--foto-shape", default="48x64")
    p.add_argument("--foto-nt", type=int, default=6)
    p.add_argument("--foto-iters", type=int, default=40)
    p.add_argument("--checkpoint-dir", default=None,
                   help="optional: distributed checkpoint round trip of "
                        "the tiled solve's state (every rank writes its "
                        "own tiles, then restores them onto the mesh)")
    args = p.parse_args(argv)
    legs, t0 = {}, time.perf_counter()

    def leg(name):
        nonlocal t0
        t = time.perf_counter()
        legs[name] = round(t - t0, 4)
        t0 = t

    from ofot_tpu_torch.parallel import gspmd, multihost
    from ofot_tpu_torch.parallel import mesh as mesh_mod

    coord = args.coordinator
    url = coord if "://" in coord else None
    backend = ("gloo" if args.platform == "cpu"
               else multihost.default_backend(args.num_processes))
    pid, count = multihost.initialize(
        None if url else coord, args.num_processes, args.process_id,
        init_method=url, backend=backend)
    out: dict = {"process_id": pid, "process_count": count,
                 "backend": dist.get_backend(), "leg_s": legs}
    leg("join")

    # --- leg 1: a cross-process all-reduce over the world --------------
    m1 = mesh_mod.make_mesh({"data": count}, platform=args.platform)
    out["device"] = str(m1.device)
    total = m1.all_reduce(torch.tensor(float(pid), device=m1.device),
                          group=m1.group("data"))
    out["psum"] = float(total)
    out["psum_expected"] = float(sum(range(count)))
    leg("all_reduce")

    # --- leg 2: a FOTO solve tiled over every rank ----------------------
    ny, nx = (int(s) for s in args.foto_shape.split("x"))
    ytiles = 2 if count % 2 == 0 else 1
    m2 = mesh_mod.spatial_mesh(ytiles, count // ytiles,
                               platform=args.platform)
    rho0, rhoT = (torch.as_tensor(f, dtype=torch.float32)
                  for f in _smooth_pair(ny, nx))
    st = gspmd.solve_foto_sharded(rho0, rhoT, args.foto_nt, m2,
                                  max_it=args.foto_iters)
    out["foto_crit"] = float(st.crit)
    out["foto_iterations"] = int(st.iteration)
    out["foto_phi_l1"] = float(torch.sum(torch.abs(st.phi)))
    leg("foto")

    # --- leg 2b: a distributed checkpoint round trip ---------------------
    if args.checkpoint_dir:
        from ofot_tpu_torch.utils import checkpoint as ckpt

        ckdir = str(Path(args.checkpoint_dir) / "tiled_state")
        ckpt.save_state_dcp(ckdir, st._replace(
            mu=m2.tile(st.mu), q=m2.tile(st.q), phi=m2.tile(st.phi)), m2)
        restored = gspmd.gather_state(ckpt.load_state_dcp(ckdir, mesh=m2),
                                      m2)
        out["ckpt_phi_l1"] = float(torch.sum(torch.abs(restored.phi)))
        out["ckpt_iteration"] = int(restored.iteration)
        leg("checkpoint")

    # --- leg 3: this host's partition of the benchmark sweep -------------
    if args.data_root and args.results:
        from ofot_tpu_torch.cli import pipeline

        rc = pipeline.main([
            "run", "--data-root", args.data_root, "--results", args.results,
            "--datasets", args.datasets, "--algos", args.algos,
            f"--platform={args.platform}", "--host-id", str(pid),
            "--host-count", str(count)])
        out["sweep_rc"] = rc
        out["manifest"] = str(Path(args.results) /
                              (f"manifest.{pid}.json" if count > 1
                               else "manifest.json"))
        leg("sweep")

    # no process exits while a peer still has collectives in flight
    dist.barrier()
    dist.destroy_process_group()
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
