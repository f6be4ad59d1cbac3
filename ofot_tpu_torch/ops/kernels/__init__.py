"""Hand-written CUDA kernels with their plain torch versions (counterpart of
ofot_tpu.ops.pallas).

Each kernel module keeps a plain integer count of its kernel's launches,
which only the CUDA branch of its wrapper changes.  ``launch_counts`` reads
them all by kernel name; ``reset_launch_counts`` sets them to 0.
"""

from __future__ import annotations

import importlib

# kernel name -> (module under ofot_tpu_torch.ops.kernels, count attribute)
KERNELS = {
    "fused_pointwise": ("fused_pointwise", "launches"),
    "dct_solve": ("dct_solve", "launches"),
    "project_paraboloid": ("projection", "launches"),
    "cg_operator": ("cg_operator", "launches"),
    "cg_operator_blocked": ("cg_operator", "blocked_launches"),
}


def _module(name: str):
    return importlib.import_module(f"{__name__}.{name}")


def launch_counts() -> dict[str, int]:
    """Launches of every kernel in this process, by kernel name."""
    return {kernel: getattr(_module(mod), attr)
            for kernel, (mod, attr) in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod, attr in KERNELS.values():
        setattr(_module(mod), attr, 0)
