"""Grayscale image I/O and normalization helpers (host numpy).

Counterpart of ``ofot_tpu.utils.image``.  Binary PGM (P5, maxval 255) is
read and written with numpy alone, so the GPU path needs no Pillow: a P5
file's bytes are its 8-bit gray levels, which is exactly what PIL's
``convert('L')`` returns for it.  PNG is read (``read_png``: every filter
type, Adam7, gray, gray+alpha, RGB, RGBA and palette forms, bitwise equal
to PIL's ``convert('L')``) and written (8-bit gray or RGB) with ``zlib``,
``struct`` and numpy alone.  Every other format goes through Pillow,
imported inside the function that needs it.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _is_pgm(pathname: str) -> bool:
    return pathname.lower().endswith(".pgm")


def _is_png(pathname: str) -> bool:
    return pathname.lower().endswith(".png")


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

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# (color type, bit depth) read without Pillow -> samples per pixel: gray
# 8/16, gray+alpha 8, RGB 8, RGBA 8, palette 1/2/4/8
_PNG_FORMS = {(0, 8): 1, (0, 16): 1, (4, 8): 2, (2, 8): 3, (6, 8): 4,
              (3, 1): 1, (3, 2): 1, (3, 4): 1, (3, 8): 1}


def _png_chunks(data: bytes, pathname: str):
    """The (kind, body) chunks of a PNG file's bytes, up to IEND."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{pathname}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError(f"{pathname}: truncated {kind!r} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{pathname}: no IEND chunk")


def _ihdr(body: bytes, pathname: str):
    if len(body) != 13:
        raise ValueError(f"{pathname}: IHDR of {len(body)} bytes")
    return struct.unpack(">IIBBBBB", body)


def png_size(pathname: str) -> tuple[int, int]:
    """(w, h) of a PNG file, from its IHDR chunk."""
    with open(pathname, "rb") as f:
        data = f.read(33)
    kind, body = next(_png_chunks(data, pathname))
    if kind != b"IHDR":
        raise ValueError(f"{pathname}: first chunk is {kind!r}, not IHDR")
    w, h = _ihdr(body, pathname)[:2]
    return w, h


def _unfilter(raw: memoryview, pos: int, rows: int, stride: int, bpp: int):
    """Undo the per-row PNG filters of one (sub-)image whose rows start at
    ``raw[pos]`` -> ((rows, stride) uint8, position after it)."""
    out = np.zeros((rows + 1, stride), np.uint8)    # row 0: the zero row
    for y in range(1, rows + 1):
        kind = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1)
        pos += 1 + stride
        up = out[y - 1]
        if kind == 0:
            out[y] = line
        elif kind == 1:       # Sub: a running sum of each byte lane
            lanes = np.zeros(-(-stride // bpp) * bpp, np.uint8)
            lanes[:stride] = line
            out[y] = np.cumsum(lanes.reshape(-1, bpp), axis=0,
                               dtype=np.uint8).ravel()[:stride]
        elif kind == 2:       # Up
            out[y] = line + up
        elif kind in (3, 4):  # Average, Paeth: left-to-right, one byte a step
            cur = bytearray(line.tobytes())
            prev = up.tobytes()
            if kind == 3:
                for i in range(stride):
                    left = cur[i - bpp] if i >= bpp else 0
                    cur[i] = (cur[i] + ((left + prev[i]) >> 1)) & 255
            else:
                for i in range(stride):
                    if i >= bpp:
                        a, c = cur[i - bpp], prev[i - bpp]
                    else:
                        a = c = 0
                    b = prev[i]
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                    cur[i] = (cur[i] + pred) & 255
            out[y] = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG filter type {kind}")
    return out[1:], pos


def _samples(rows: np.ndarray, w: int, depth: int, spp: int) -> np.ndarray:
    """Filtered-away rows -> (h, w, spp) samples (uint8, or uint16 at
    depth 16); sub-byte samples are packed from the high bits down."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2")[:, :w * spp].astype(np.uint16).reshape(
            h, w, spp)
    if depth == 8:
        return rows[:, :w * spp].reshape(h, w, spp)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(h, -1)[:, :w].reshape(h, w, 1)


def _luma(rgb: np.ndarray) -> np.ndarray:
    """PIL's fixed-point ITU-R 601-2 luma of uint8 RGB."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(
        np.uint8)


def read_png(pathname: str) -> np.ndarray:
    """Read a PNG -> (h, w) uint8, bitwise what
    ``np.asarray(PIL.Image.open(pathname).convert("L"))`` returns.

    Forms: gray 8 and 16 bits (16 bits clip at 255, as PIL's ``I`` to
    ``L`` conversion does), gray+alpha 8 (alpha dropped), RGB 8, RGBA 8
    and palette 1/2/4/8 (PIL's fixed-point luma of the color), each
    plain or Adam7-interlaced.  Any other form raises ``ValueError``."""
    with open(pathname, "rb") as f:
        data = f.read()
    header, palette, idat = None, None, []
    for kind, body in _png_chunks(data, pathname):
        if kind == b"IHDR":
            header = _ihdr(body, pathname)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{pathname}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if (color, depth) not in _PNG_FORMS or interlace not in (0, 1):
        raise ValueError(f"{pathname}: PNG color type {color} at bit depth "
                         f"{depth}, interlace {interlace}, is not read "
                         "without Pillow")
    spp = _PNG_FORMS[(color, depth)]
    if color == 3 and palette is None:
        raise ValueError(f"{pathname}: palette PNG without PLTE")
    try:
        raw = memoryview(zlib.decompress(b"".join(idat)))
    except zlib.error as e:
        raise ValueError(f"{pathname}: bad PNG pixel data ({e})") from None
    bpp = max(1, depth * spp // 8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    px = np.zeros((h, w, spp), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    try:
        for x0, y0, dx, dy in passes:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw <= 0 or ph <= 0:
                continue
            stride = -(-(pw * depth * spp) // 8)
            rows, pos = _unfilter(raw, pos, ph, stride, bpp)
            px[y0::dy, x0::dx] = _samples(rows, pw, depth, spp)
    except (IndexError, ValueError) as e:   # short data, bad filter type
        raise ValueError(f"{pathname}: bad PNG pixel data ({e})") from None
    if color == 0:
        return (np.minimum(px[..., 0], 255).astype(np.uint8) if depth == 16
                else px[..., 0])
    if color == 4:
        return px[..., 0]
    if color == 3:
        index = px[..., 0]
        if index.max(initial=0) >= len(palette):
            raise ValueError(f"{pathname}: palette index past PLTE")
        return _luma(palette)[index]
    return _luma(px)


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
        f.write(PNG_SIGNATURE + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))


def _save_uint8(arr: np.ndarray, pathname: str, mode: str) -> None:
    """Write uint8 pixels by the file name: PGM (gray) and PNG without
    Pillow, any other format with it."""
    if mode == "L" and _is_pgm(pathname):
        write_pgm(arr, pathname)
    elif _is_png(pathname):
        write_png(arr, pathname)
    else:
        from PIL import Image
        Image.fromarray(arr, mode).save(pathname)


def open_grayscale(pathname: str):
    """Open an image as normalized grayscale -> (field (h, w) float64 in
    [0, 1], w, h), like ``ofot_tpu.utils.image.open_grayscale``."""
    if _is_pgm(pathname):
        f = read_pgm(pathname)
    elif _is_png(pathname):
        f = read_png(pathname)
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


def mass_normalize_pair_common_max(f1, f2):
    """Per-frame mass normalization then common-max rescale — the dataset
    preparation tool's behavior (reference bin/normalize_image.py:20-26)."""
    f1 = f1 / np.sum(f1)
    f2 = f2 / np.sum(f2)
    scale = max(np.max(f1), np.max(f2))
    return f1 / scale, f2 / scale
