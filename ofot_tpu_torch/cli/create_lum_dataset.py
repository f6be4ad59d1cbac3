"""Synthetic illumination augmentation tool.

Equivalent of reference bin/create_lum_dataset.py: adds two random
rectangles and two random circles of brightness in [-0.25, 0.25] to a
frame (seeded), clipped to [0, 1] — builds the "lum" dataset variant that
stresses the solvers' luminosity terms.  Uses the same ``random`` module
draw sequence as the reference so a given seed produces the same artifacts.
A copy of ``ofot_tpu.cli.create_lum_dataset`` on the port's image I/O (PNG
without Pillow).

Usage: python -m ofot_tpu_torch.cli.create_lum_dataset frame.png out.png seed
"""

from __future__ import annotations

import argparse
import random
import sys

import numpy as np

from ofot_tpu_torch.utils import image


def add_rectangle(f, L_x, L_y, r_x, r_y, v):
    """Add value v on the rectangle centered (r_x, r_y), size (L_x, L_y)."""
    y0, y1 = int(r_y - L_y / 2), int(r_y + L_y / 2)
    x0, x1 = int(r_x - L_x / 2), int(r_x + L_x / 2)
    f[y0:y1, x0:x1] += v
    return f


def add_circle(f, R, c_x, c_y, v):
    h, w = f.shape
    x = np.arange(w)[None, :]
    y = np.arange(h)[:, None]
    f[(x - c_x) ** 2 + (y - c_y) ** 2 < R ** 2] += v
    return f


def add_random_rectangle(f, w, h):
    # draw order matches the reference for seed parity
    L_x = random.randint(10, w - 1)
    L_y = random.randint(10, h - 1)
    r_x = random.randint(int(L_x / 2), int(w - L_x / 2))
    r_y = random.randint(int(L_y / 2), int(h - L_y / 2))
    v = random.uniform(-0.25, 0.25)
    return add_rectangle(f, L_x, L_y, r_x, r_y, v)


def add_random_circle(f, w, h):
    R = random.randint(10, min(w, h)) / 2
    c_x = random.randint(int(R), int(w - R))
    c_y = random.randint(int(R), int(h - R))
    v = random.uniform(-0.25, 0.25)
    return add_circle(f, R, c_x, c_y, v)


def augment(f, w, h, seed: int):
    random.seed(seed)
    f = add_random_rectangle(f, w, h)
    f = add_random_rectangle(f, w, h)
    f = add_random_circle(f, w, h)
    f = add_random_circle(f, w, h)
    return f


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="sample argument parser")
    p.add_argument("f", help="frame")
    p.add_argument("out", help="output")
    p.add_argument("seed", type=int, help="random seed")
    args = p.parse_args(argv)

    f, w, h = image.open_grayscale(args.f)
    f = augment(f, w, h, args.seed)
    image.save_grayscale(f, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
