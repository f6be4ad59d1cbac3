"""Frame-difference visualization tool.

Equivalent of reference bin/data_diff.py: min-max-normalized (f2 - f1)
saved as a grayscale PNG.
A copy of ``ofot_tpu.cli.data_diff`` on the port's image I/O (PNG
without Pillow).

Usage: python -m ofot_tpu_torch.cli.data_diff f0.png f1.png out.png
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ofot_tpu_torch.utils import image


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="sample argument parser")
    p.add_argument("f0", help="first frame")
    p.add_argument("f1", help="second frame")
    p.add_argument("out", help="output")
    args = p.parse_args(argv)

    f1, w, h = image.open_grayscale(args.f0)
    f2, w, h = image.open_grayscale(args.f1)

    diff = f2 - f1
    diff = diff - np.min(diff)
    # identical frames (static scene) make max(diff) == 0: render mid-gray
    # instead of 0/0 = NaN garbage (the reference shares this hole)
    rng = np.max(diff)
    diff = diff / rng if rng > 0 else np.full_like(diff, 0.5)
    image.save_grayscale(diff, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
