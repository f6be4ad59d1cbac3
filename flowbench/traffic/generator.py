"""The one traffic generator: a pool of Middlebury-style frame pairs made
from a traffic file, and the order, drawn from ``--seed``, in which a
closed loop sends them.

The pool follows the dataset lifecycle of the reference ``run.sh`` as the
port's pipeline runs it (``ofot_tpu_torch/cli/pipeline.py``: download,
resize, lum augmentation, mass normalisation, 8-bit PNGs read back):

1. analytic textures, sampled exactly under affine motions (copies of
   ``texture``, ``motions`` and ``render_pair`` from
   ``tools/make_synthetic_middlebury.py``), each frame quantised to 8 bits
   as its PNG is;
2. the seven motions (Translate, Rotate, Zoom, Shear, RotZoom, Diverge,
   LargeMotion) of every texture;
3. every pair plain and lum-augmented (``middlebury-1`` and
   ``middlebury-1-lum``): frame 11 gets two random rectangles and two
   random circles of brightness in [-0.25, 0.25] (a copy of
   ``cli/create_lum_dataset.augment``), per-sequence seeds drawn from one
   ``random.Random`` seeded with the traffic file's ``lum_seed`` (the
   pipeline's ``--lum-seed``, run.sh's ``RANDOM=12345``), and is quantised
   again;
4. both frames mass-normalised with a common max (a copy of
   ``utils/image.mass_normalize_pair_common_max``) and quantised a third
   time, as the sweep reads them.

The pool is the traffic file's alone (``texture_seeds``, ``lum_seed``):
every ``--seed`` brings the same pairs, so that the work of a window does
not swing with the seed (measured on an H100 with seeded lum artefacts:
640x480 windows of different seeds differed by up to 5%, two windows of
one seed by 1-2%); ``--seed`` draws the order they are sent in and the
answers the check compares.  numpy only: this file imports nothing of
the program.
"""

from __future__ import annotations

import random

import numpy as np


def texture(seed: int):
    """Analytic grayscale scene f(x, y, w, h) -> [0, 1]: a band-limited
    sinusoid mixture plus four Gaussian blobs, its [0, 1] gauge fixed per
    (w, h) from the regular pixel grid (so both frames share it)."""
    rng = np.random.default_rng(seed)
    waves = [(rng.uniform(0.02, 0.2), rng.uniform(0.02, 0.2),
              rng.uniform(0, 2 * np.pi)) for _ in range(6)]
    blobs = [(rng.uniform(0.2, 0.8), rng.uniform(0.2, 0.8),
              rng.uniform(0.05, 0.15), rng.uniform(0.5, 1.0))
             for _ in range(4)]
    norms = {}

    def raw(x, y, w, h):
        out = np.zeros_like(x)
        for kx, ky, ph in waves:
            out += np.sin(kx * x + ky * y + ph)
        out /= 2 * len(waves)
        for cx, cy, s, amp in blobs:
            out += amp * np.exp(-(((x / w - cx) / s) ** 2
                                  + (((y / h - cy) / s) ** 2)))
        return out

    def f(x, y, w, h):
        if (w, h) not in norms:
            xg, yg = np.meshgrid(np.arange(w, dtype=np.float64),
                                 np.arange(h, dtype=np.float64))
            g = raw(xg, yg, w, h)
            norms[(w, h)] = (g.min(), g.max())
        lo, hi = norms[(w, h)]
        return np.clip((raw(x, y, w, h) - lo) / (hi - lo), 0.0, 1.0)

    return f


def motions(w, h, translation_scale: float = 1.0):
    """The seven (name, A, b) affine motions about the frame's centre:
    p' = A p + b; ``translation_scale`` shrinks only the translations."""
    c = np.array([w / 2.0, h / 2.0])

    def about_center(A, t):
        t = translation_scale * np.asarray(t)
        return A, c - A @ c + t

    def R(deg):
        t = np.deg2rad(deg)
        return np.array([[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]])

    return [
        ("Translate", *about_center(np.eye(2), [6.0, 4.0])),
        ("Rotate", *about_center(R(1.2), [0.0, 0.0])),
        ("Zoom", *about_center(1.02 * np.eye(2), [0.0, 0.0])),
        ("Shear", *about_center(np.array([[1.0, 0.015], [0.0, 1.0]]),
                                [2.0, -3.0])),
        ("RotZoom", *about_center(1.012 * R(-0.8), [-4.0, 2.0])),
        ("Diverge", *about_center(np.array([[1.018, 0.0], [0.0, 0.985]]),
                                  [3.0, 3.0])),
        ("LargeMotion", *about_center(np.eye(2), [20.0, 12.0])),
    ]


def render_pair(f, A, b, w, h):
    """Exact analytic sampling of both frames: frame11(p) = f(A^-1 (p - b))."""
    x, y = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    f10 = f(x, y, w, h)
    Ainv = np.linalg.inv(A)
    xs = Ainv[0, 0] * (x - b[0]) + Ainv[0, 1] * (y - b[1])
    ys = Ainv[1, 0] * (x - b[0]) + Ainv[1, 1] * (y - b[1])
    return f10, f(xs, ys, w, h)


def quantize(f):
    """A [0, 1] field written as an 8-bit PNG and read back: clip, scale
    by 255, truncate, divide by 255."""
    return np.uint8(255 * np.clip(f, 0.0, 1.0)).astype(np.float64) / 255.0


def _add_rectangle(f, L_x, L_y, r_x, r_y, v):
    y0, y1 = int(r_y - L_y / 2), int(r_y + L_y / 2)
    x0, x1 = int(r_x - L_x / 2), int(r_x + L_x / 2)
    f[y0:y1, x0:x1] += v


def _add_circle(f, R, c_x, c_y, v):
    h, w = f.shape
    x = np.arange(w)[None, :]
    y = np.arange(h)[:, None]
    f[(x - c_x) ** 2 + (y - c_y) ** 2 < R ** 2] += v


def augment(f, w, h, seed: int):
    """Two random rectangles and two random circles of brightness in
    [-0.25, 0.25] added to ``f`` in place, drawn from ``random`` seeded
    with ``seed`` in the reference tool's order."""
    rnd = random.Random(seed)
    for _ in range(2):
        L_x = rnd.randint(10, w - 1)
        L_y = rnd.randint(10, h - 1)
        r_x = rnd.randint(int(L_x / 2), int(w - L_x / 2))
        r_y = rnd.randint(int(L_y / 2), int(h - L_y / 2))
        _add_rectangle(f, L_x, L_y, r_x, r_y, rnd.uniform(-0.25, 0.25))
    for _ in range(2):
        R = rnd.randint(10, min(w, h)) / 2
        c_x = rnd.randint(int(R), int(w - R))
        c_y = rnd.randint(int(R), int(h - R))
        _add_circle(f, R, c_x, c_y, rnd.uniform(-0.25, 0.25))
    return f


def mass_normalize_pair_common_max(f1, f2):
    """Each frame divided by its total mass, then both by their common
    max."""
    f1 = f1 / np.sum(f1)
    f2 = f2 / np.sum(f2)
    scale = max(np.max(f1), np.max(f2))
    return f1 / scale, f2 / scale


class Pair:
    """One pair of the pool: its name, whether frame 11 is lum-augmented,
    and the two float32 (h, w) frames the solver gets."""

    def __init__(self, name: str, lum: bool, f1, f2):
        self.name, self.lum = name, lum
        self.f1 = np.ascontiguousarray(f1, dtype=np.float32)
        self.f2 = np.ascontiguousarray(f2, dtype=np.float32)


def make_pool(traffic: dict) -> list[Pair]:
    """The pool of a traffic file: every texture under every motion, plain
    and lum-augmented (``lum_share`` 0.5: one of each)."""
    w, h = traffic["width"], traffic["height"]
    if traffic["lum_share"] not in (0.0, 0.5, 1.0):
        raise ValueError("lum_share is 0, 0.5 (each pair plain and "
                         "augmented) or 1")
    lum_seeds = random.Random(traffic["lum_seed"])
    base = []
    for t in traffic["texture_seeds"]:
        f = texture(t)
        for name, A, b in motions(w, h, traffic["translation_scale"]):
            f10, f11 = render_pair(f, A, b, w, h)
            base.append((f"t{t}-{name}", quantize(f10), quantize(f11)))
    pool = []
    for name, f10, f11 in base:
        kinds = {0.0: (False,), 0.5: (False, True), 1.0: (True,)}
        for lum in kinds[traffic["lum_share"]]:
            g11 = f11
            if lum:
                g11 = quantize(augment(f11.copy(), w, h,
                                       lum_seeds.randint(0, 32767)))
            a, b = mass_normalize_pair_common_max(f10, g11)
            pool.append(Pair(name + ("-lum" if lum else ""), lum,
                             quantize(a), quantize(b)))
    return pool


def order(seed: int, pool_size: int):
    """The closed loop's stream of pool indices: one seeded permutation of
    the pool after another, without end."""
    rng = np.random.default_rng([seed, 1])
    while True:
        yield from (int(i) for i in rng.permutation(pool_size))
