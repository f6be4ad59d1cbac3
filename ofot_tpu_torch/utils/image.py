"""Grayscale image I/O and normalization helpers (host numpy).

Counterpart of ``ofot_tpu.utils.image``.  Binary PGM (P5, maxval 255) is
read and written with numpy alone, so the GPU path needs no Pillow: a P5
file's bytes are its 8-bit gray levels, which is exactly what PIL's
``convert('L')`` returns for it.  PNG (8-bit gray or RGB) is written with
``zlib`` and ``struct`` alone.  Every other format goes through Pillow,
imported inside the function that needs it.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _is_pgm(pathname: str) -> bool:
    return pathname.lower().endswith(".pgm")


def _pgm_header(data: bytes):
    """Parse a P5 header -> (w, h, maxval, offset of the pixel bytes).

    Header tokens are separated by whitespace; '#' starts a comment that
    runs to the end of its line; exactly one whitespace byte follows the
    maxval (Netpbm's definition)."""
    if data[:2] != b"P5":
        raise ValueError("not a binary PGM (P5) file")
    tokens, pos = [], 2
    while len(tokens) < 3:
        c = data[pos:pos + 1]
        if not c:
            raise ValueError("truncated PGM header")
        if c == b"#":
            pos = data.index(b"\n", pos) + 1
        elif c.isspace():
            pos += 1
        else:
            end = pos
            while end < len(data) and not data[end:end + 1].isspace():
                end += 1
            tokens.append(int(data[pos:end]))
            pos = end
    return tokens[0], tokens[1], tokens[2], pos + 1


def read_pgm(pathname: str) -> np.ndarray:
    """Read a binary 8-bit PGM -> (h, w) uint8."""
    with open(pathname, "rb") as f:
        data = f.read()
    w, h, maxval, off = _pgm_header(data)
    if maxval != 255:
        raise ValueError(f"{pathname}: PGM maxval {maxval} (only 255 is "
                         "read without Pillow)")
    if len(data) < off + w * h:
        raise ValueError(f"{pathname}: truncated PGM pixel data")
    return np.frombuffer(data, np.uint8, count=w * h, offset=off).reshape(h, w)


def write_pgm(arr: np.ndarray, pathname: str) -> None:
    """Write an (h, w) uint8 array as a binary PGM (P5, maxval 255)."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    h, w = arr.shape
    with open(pathname, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (w, h))
        f.write(arr.tobytes())


def write_png(arr: np.ndarray, pathname: str) -> None:
    """Write an (h, w) uint8 array as an 8-bit grayscale PNG, or an (h, w,
    3) one as 8-bit RGB: one IDAT chunk of zlib-compressed rows, each with
    filter type 0."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    if arr.ndim == 2:
        color_type = 0
    elif arr.ndim == 3 and arr.shape[2] == 3:
        color_type = 2
    else:
        raise ValueError(f"PNG of shape {arr.shape}: expected (h, w) or "
                         "(h, w, 3)")
    h, w = arr.shape[:2]
    rows = np.zeros((h, 1 + arr[0].size), np.uint8)
    rows[:, 1:] = arr.reshape(h, -1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(pathname, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))


def _save_uint8(arr: np.ndarray, pathname: str, mode: str) -> None:
    """Write uint8 pixels by the file name: PGM (gray) and PNG without
    Pillow, any other format with it."""
    if mode == "L" and _is_pgm(pathname):
        write_pgm(arr, pathname)
    elif pathname.lower().endswith(".png"):
        write_png(arr, pathname)
    else:
        from PIL import Image
        Image.fromarray(arr, mode).save(pathname)


def open_grayscale(pathname: str):
    """Open an image as normalized grayscale -> (field (h, w) float64 in
    [0, 1], w, h), like ``ofot_tpu.utils.image.open_grayscale``."""
    if _is_pgm(pathname):
        f = read_pgm(pathname)
    else:
        from PIL import Image
        f = np.asarray(Image.open(pathname).convert("L"))
    h, w = f.shape
    return f.astype(np.float64) / 255.0, w, h


def save_grayscale(field, pathname: str) -> None:
    """Save a [0, 1] field (h, w) as 8-bit grayscale, with the reference's
    clip-then-quantize convention (reference main.py:142)."""
    arr = np.uint8(255 * np.clip(np.asarray(field), 0.0, 1.0))
    _save_uint8(arr, pathname, "L")


def save_rgb(rgb: np.ndarray, pathname: str) -> None:
    """Save an (h, w, 3) uint8 RGB image (the flow visualization)."""
    _save_uint8(np.asarray(rgb, np.uint8), pathname, "RGB")


def mass_normalize(f1, f2):
    """Divide each frame by its own total mass — the CLI ``--normalize``
    behavior (reference main.py:71-77)."""
    return f1 / np.sum(f1), f2 / np.sum(f2)
