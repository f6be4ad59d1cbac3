"""The port's Pillow-free PNG reader (``ofot_tpu_torch.utils.image``)
against Pillow: ``read_png`` must equal ``np.asarray(PIL.Image.open(p)
.convert("L"))`` bitwise on every form the sweep's frames can take —
Pillow-written (hence filtered) gray frames at the sweep's size and at odd
sizes, a hand-encoded file for each filter type 0-4, RGB/RGBA/gray+alpha
(PIL's fixed-point luma), palettes at 1/2/4/8 bits, 16-bit gray (clipped
at 255, as PIL's I -> L conversion does) and Adam7 interlacing."""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from ofot_tpu_torch.utils import image

RNG = np.random.default_rng(91)


def _pil_gray(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("L"))


def _chunk(tag, payload):
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload)))


def _png_bytes(w, h, depth, color, raw, interlace=0, plte=None):
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace)
    return (image.PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + (_chunk(b"PLTE", plte) if plte is not None else b"")
            + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


def _filter_rows(rows, kind, bpp):
    """Encode (h, stride) uint8 rows with one PNG filter type."""
    out = b""
    prev = np.zeros(rows.shape[1], np.int32)
    for row in rows.astype(np.int32):
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(row)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        out += bytes([kind]) + ((row - pred) % 256).astype(np.uint8).tobytes()
        prev = row
    return out


def _smooth_gray(h, w, noise=4.0):
    y, x = np.mgrid[0:h, 0:w]
    f = (128 + 60 * np.sin(x / 13.0) + 50 * np.cos(y / 7.0)
         + RNG.normal(0, noise, (h, w)))
    return np.clip(f, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("h,w", [(240, 320), (37, 53), (1, 1), (5, 2)])
def test_pillow_gray_frames(tmp_path, h, w):
    """Pillow filters the rows of the gray PNGs it writes (Sub, Up,
    Paeth...), as the frames the pipeline's resize writes."""
    p = tmp_path / "g.png"
    Image.fromarray(_smooth_gray(h, w), "L").save(p)
    got = image.read_png(str(p))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, _pil_gray(p))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("color,spp", [(0, 1), (2, 3)])
def test_each_filter_type(tmp_path, kind, color, spp):
    h, w = 9, 13
    px = RNG.integers(0, 256, (h, w * spp), dtype=np.uint8)
    p = tmp_path / "f.png"
    p.write_bytes(_png_bytes(w, h, 8, color, _filter_rows(px, kind, spp)))
    np.testing.assert_array_equal(image.read_png(str(p)), _pil_gray(p))
    if color == 0:
        np.testing.assert_array_equal(image.read_png(str(p)), px)


@pytest.mark.parametrize("mode,channels", [("RGB", 3), ("RGBA", 4),
                                           ("LA", 2)])
def test_color_forms_use_pillows_luma(tmp_path, mode, channels):
    p = tmp_path / "c.png"
    Image.fromarray(RNG.integers(0, 256, (30, 41, channels),
                                 dtype=np.uint8), mode).save(p)
    np.testing.assert_array_equal(image.read_png(str(p)), _pil_gray(p))


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_palette(tmp_path, bits):
    n = 1 << bits
    im = Image.fromarray(RNG.integers(0, n, (19, 23), dtype=np.uint8), "P")
    im.putpalette([int(c) for c in RNG.integers(0, 256, 3 * n)])
    p = tmp_path / "p.png"
    im.save(p, bits=bits)
    with Image.open(p) as check:
        assert check.mode == "P"
    np.testing.assert_array_equal(image.read_png(str(p)), _pil_gray(p))


def test_16bit_gray_clips_at_255(tmp_path):
    arr = RNG.integers(0, 65536, (8, 9), dtype=np.uint16)
    arr[0, :4] = [30000, 100, 255, 256]
    p = tmp_path / "g16.png"
    Image.fromarray(arr).save(p)
    got = image.read_png(str(p))
    np.testing.assert_array_equal(got, _pil_gray(p))
    np.testing.assert_array_equal(got[0, :4], [255, 100, 255, 255])


@pytest.mark.parametrize("h,w", [(8, 8), (11, 6), (3, 17)])
def test_adam7(tmp_path, h, w):
    """Interlaced PNGs must de-interlace; PIL cannot write Adam7, so
    hand-encode one (one pass after another, each filtered on its own)."""
    img = RNG.integers(0, 256, (h, w), dtype=np.uint8)
    raw = b""
    for i, (x0, y0, dx, dy) in enumerate(image._ADAM7):
        sub = img[y0::dy, x0::dx]
        if sub.size:
            raw += _filter_rows(sub, i % 5, 1)
    p = tmp_path / "adam7.png"
    p.write_bytes(_png_bytes(w, h, 8, 0, raw, interlace=1))
    np.testing.assert_array_equal(_pil_gray(p), img)
    np.testing.assert_array_equal(image.read_png(str(p)), img)


def test_open_grayscale_reads_png_without_pillow(tmp_path, monkeypatch):
    import builtins
    f = RNG.random((12, 14))
    p = tmp_path / "w.png"
    image.save_grayscale(f, str(p))
    real_import = builtins.__import__

    def no_pil(name, *args, **kw):
        if name.split(".")[0] == "PIL":
            raise ImportError("Pillow hidden")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    got, w, h = image.open_grayscale(str(p))
    assert (w, h) == (14, 12)
    np.testing.assert_array_equal(
        got, np.uint8(255 * np.clip(f, 0, 1)) / 255.0)


def test_missing_file_raises():
    with pytest.raises(FileNotFoundError):
        image.read_png("/nonexistent/x.png")


@pytest.mark.parametrize("data", [b"not a png at all",
                                  image.PNG_SIGNATURE + b"\x00\x00"])
def test_not_a_png_raises(tmp_path, data):
    p = tmp_path / "bad.png"
    p.write_bytes(data)
    with pytest.raises(ValueError):
        image.read_png(str(p))
    with pytest.raises(ValueError):
        image.png_size(str(p))


def test_unsupported_form_names_itself(tmp_path):
    p = tmp_path / "rgb16.png"
    p.write_bytes(_png_bytes(2, 2, 16, 2, b"\x00" * (2 * (1 + 12))))
    with pytest.raises(ValueError, match="color type 2 at bit depth 16"):
        image.read_png(str(p))


@pytest.mark.parametrize("h,w", [(240, 320), (7, 3)])
def test_png_size(tmp_path, h, w):
    p = tmp_path / "s.png"
    Image.fromarray(_smooth_gray(h, w), "L").save(p)
    with Image.open(p) as im:
        assert image.png_size(str(p)) == im.size == (w, h)
