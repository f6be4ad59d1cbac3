"""The readings that the limits of ``flowbench/limits/<cell>.json`` are
set from: the numbers that a run compares, over many seeds in one
process, for the program (the lower readings), for the control, the
plain reference one precision step below the configuration's put in the
program's place, or for the program with a fault of ``flowbench/faults.py``
planted (the upper readings).

    python3 flowbench/readings.py --workload <name> --seeds 1,2,3 \\
        [--control | --fault <name>] [--seconds 3] [--calls 8]

Each seed runs the cell's set-up and a short closed loop (``--seconds``,
at least ``--calls`` calls), then the same sample and check as a run of
``flowbench/run.py``; one JSON line per seed.  Run on the card.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    sys.path.insert(0, str(ROOT))
    from flowbench import faults, harness

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    side = p.add_mutually_exclusive_group()
    side.add_argument("--control", action="store_true")
    side.add_argument("--fault", choices=sorted(faults.FAULTS))
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--calls", type=int, default=1)
    args = p.parse_args(argv)
    if args.fault:
        faults.FAULTS[args.fault](setattr)

    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        res, numbers = harness.run(ROOT, args.workload, seed, args.seconds,
                                   False, t, control=args.control,
                                   min_calls=args.calls)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "side": ("control" if args.control else
                     f"fault {args.fault}" if args.fault else "program"),
            "attempted": res["attempted"], "failed": res["failed"],
            "numbers": numbers,
            "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
