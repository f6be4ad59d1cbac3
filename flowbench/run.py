"""Benchmark of the PyTorch and CUDA port (``ofot_tpu_torch``) on NVIDIA
cards: one cell of ``BENCHMARK.json`` a run.

    python3 flowbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout.  Set-up (imports, the CUDA context, the
kernel library, built at the first run in a checkout into the program's
own ``_build`` directory there, the traffic pool and one warm-up call of
the cell's shapes) is timed as ``setup_s``; then the cell's traffic runs
as a closed loop for ``--seconds``; with ``--trace 1`` a few more calls
run under ``torch.profiler``.  The window's answers are then checked
against the plain reference, and the last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number compared beside its limit (also the last lines of standard error).

With no card, fewer cards than the cell asks for, no program in the
checkout, or JAX or the JAX package loaded by the end, the run exits
non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0:
        p.error("--seed is a whole number >= 0")
    return args


def fail(msg: str) -> int:
    print(f"flowbench: {msg}", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(ROOT))
    from flowbench import harness, program

    try:
        cell = harness.Cell(ROOT, args.workload)
    except (OSError, KeyError, ValueError) as e:
        return fail(f"cannot read the cell {args.workload!r}: {e}")
    import torch
    torch.set_num_threads(4)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark measures the card only")
    if torch.cuda.device_count() < chips:
        return fail(f"the cell asks for {chips} cards, "
                    f"{torch.cuda.device_count()} seen")
    try:
        program.load(ROOT)
    except program.ProgramMissing as e:
        return fail(str(e))
    result, _ = harness.run(ROOT, args.workload, args.seed, args.seconds,
                            bool(args.trace), T_START, cell=cell)
    found = harness.forbidden(list(sys.modules))
    if found:
        return fail(f"modules of {', '.join(found)} are loaded in this "
                    "process: the port's run may not load JAX or the JAX "
                    "package")
    for line in harness.check_lines(result):
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
