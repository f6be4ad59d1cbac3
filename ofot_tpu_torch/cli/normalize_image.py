"""Mass-normalization tool for OT-comparable frame pairs.

Equivalent of reference bin/normalize_image.py: each frame divided by its
own total mass, then both rescaled by their common max.
A copy of ``ofot_tpu.cli.normalize_image`` on the port's image I/O (PNG
without Pillow).

Usage: python -m ofot_tpu_torch.cli.normalize_image f1.png f2.png out1.png out2.png
"""

from __future__ import annotations

import argparse
import sys

from ofot_tpu_torch.utils import image


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="sample argument parser")
    p.add_argument("f1", help="frame 1")
    p.add_argument("f2", help="frame 2")
    p.add_argument("out1", help="output 1")
    p.add_argument("out2", help="output 2")
    args = p.parse_args(argv)

    f1, w, h = image.open_grayscale(args.f1)
    f2, w, h = image.open_grayscale(args.f2)
    f1, f2 = image.mass_normalize_pair_common_max(f1, f2)
    image.save_grayscale(f1, args.out1)
    image.save_grayscale(f2, args.out2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
