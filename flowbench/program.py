"""What the benchmark takes from the program (``ofot_tpu_torch``, the
PyTorch and CUDA port): its package from this checkout, its launch and
device-loop counters, and the call that frees its cached graphs.

Nothing here runs at import time: the program is imported by
:func:`load`, which refuses a package that does not lie in the checkout.
"""

from __future__ import annotations

import importlib
from pathlib import Path

NAME = "ofot_tpu_torch"


class ProgramMissing(RuntimeError):
    pass


def load(root: Path):
    """The program's package from ``root`` (ProgramMissing if it is not
    there, or if another copy was imported)."""
    try:
        pkg = importlib.import_module(NAME)
    except ModuleNotFoundError as e:
        raise ProgramMissing(f"the program {NAME!r} is not in {root}: {e}") \
            from None
    where = Path(pkg.__file__).resolve().parent
    if where.parent != Path(root).resolve():
        raise ProgramMissing(f"{NAME} was imported from {where}, not from "
                             f"the checkout {root}")
    return pkg


def launch_counts() -> dict:
    """Kernel launches of the program so far, by kernel name."""
    from ofot_tpu_torch.ops import kernels
    return dict(kernels.launch_counts())


def loop_stats() -> dict:
    """The device loop's counters: captures, their milliseconds, replays
    and iteration slots."""
    from ofot_tpu_torch.solvers import device_loop
    s = device_loop.stats
    return {"captures": s.captures, "capture_ms": s.capture_ms,
            "replays": s.replays, "slots": s.slots}


def free() -> None:
    """Drop the program's cached graphs and their memory pools."""
    from ofot_tpu_torch.solvers import device_loop
    device_loop.clear_cache()
