"""Middlebury .flo optical-flow file I/O.

Byte-exact implementation of the format the reference reads/writes
(reference utils.py:250-292): float32 magic ``202021.25``, int32 width and
height, then h*w*2 float32 with (u, v) interleaved per pixel, row-major.
A copy of ``ofot_tpu.utils.flo``, kept in the port so that the port never
imports the JAX package.
"""

from __future__ import annotations

import numpy as np

MAGIC = np.float32(202021.25)


def read_flo(pathname: str):
    """Read a .flo file -> (w, h, u, v) with u, v flat float arrays of
    length w*h (reference ``openFlo``, utils.py:250-271)."""
    with open(pathname, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)[0]
        if magic != MAGIC:
            print("Magic number incorrect. Invalid .flo file")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32)
    data = data.reshape(h, w, 2)
    return w, h, data[..., 0].ravel(), data[..., 1].ravel()


def write_flo(w: int, h: int, u, v, pathname: str) -> None:
    """Write a .flo file (reference ``saveFlo``, utils.py:273-292)."""
    u = np.asarray(u, dtype=np.float32).ravel()
    v = np.asarray(v, dtype=np.float32).ravel()
    with open(pathname, "wb") as f:
        np.array([MAGIC], dtype=np.float32).tofile(f)
        np.array([w, h], dtype=np.int32).tofile(f)
        data = np.empty((w * h, 2), dtype=np.float32)
        data[:, 0] = u
        data[:, 1] = v
        data.tofile(f)
