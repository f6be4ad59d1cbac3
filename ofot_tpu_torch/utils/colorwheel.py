"""Middlebury flow color encoding (Baker et al. optical-flow color wheel).

Counterpart of ``ofot_tpu.utils.colorwheel``: the 55-entry color wheel of
the reference's ``bin/color_flow`` visualizer (segments RY=15, YG=6,
GC=4, CB=11, BM=13, MR=6; hue from atan2(-v, -u), saturation from the
normalized motion radius; pixels with radius > 1 dimmed by 0.75; unknown
flow, |u| or |v| > 1e9 or NaN, renders black).  The numpy functions are
copies of the JAX package's and give the same uint8 pixels;
:func:`compute_color_torch` is the on-device twin of
:func:`compute_color` (``compute_color_jax`` there), with the same dtype
at every step.  PNG files are written without Pillow
(``utils/image.py``).
"""

from __future__ import annotations

import numpy as np
import torch

UNKNOWN_FLOW_THRESH = 1e9

_SEGMENTS = [("RY", 15), ("YG", 6), ("GC", 4), ("CB", 11), ("BM", 13),
             ("MR", 6)]
NCOLS = sum(n for _, n in _SEGMENTS)   # 55


def make_colorwheel() -> np.ndarray:
    """(55, 3) uint8-valued float array of wheel colors."""
    wheel = np.zeros((NCOLS, 3))
    k = 0
    RY, YG, GC, CB, BM, MR = (n for _, n in _SEGMENTS)
    i = np.arange(RY); wheel[k:k+RY] = np.stack(
        [np.full(RY, 255.0), np.floor(255.0 * i / RY), np.zeros(RY)], 1); k += RY
    i = np.arange(YG); wheel[k:k+YG] = np.stack(
        [255.0 - np.floor(255.0 * i / YG), np.full(YG, 255.0), np.zeros(YG)], 1); k += YG
    i = np.arange(GC); wheel[k:k+GC] = np.stack(
        [np.zeros(GC), np.full(GC, 255.0), np.floor(255.0 * i / GC)], 1); k += GC
    i = np.arange(CB); wheel[k:k+CB] = np.stack(
        [np.zeros(CB), 255.0 - np.floor(255.0 * i / CB), np.full(CB, 255.0)], 1); k += CB
    i = np.arange(BM); wheel[k:k+BM] = np.stack(
        [np.floor(255.0 * i / BM), np.zeros(BM), np.full(BM, 255.0)], 1); k += BM
    i = np.arange(MR); wheel[k:k+MR] = np.stack(
        [np.full(MR, 255.0), np.zeros(MR), 255.0 - np.floor(255.0 * i / MR)], 1); k += MR
    return wheel


_WHEEL = make_colorwheel()


def compute_color(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Map *normalized* flow (u, v) -> (h, w, 3) uint8 RGB.

    Radius and hue in single precision like the reference colorcode (its
    computeColor runs in float), the wheel interpolation in float64."""
    u = np.asarray(u, np.float32)
    v = np.asarray(v, np.float32)
    rad = np.sqrt(u * u + v * v)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1.0) / 2.0 * (NCOLS - 1)
    k0 = fk.astype(np.int32)
    k1 = (k0 + 1) % NCOLS
    f = fk - k0

    col0 = _WHEEL[k0] / 255.0           # (..., 3)
    col1 = _WHEEL[k1] / 255.0
    col = (1.0 - f[..., None]) * col0 + f[..., None] * col1

    small = rad <= 1.0
    col = np.where(small[..., None],
                   1.0 - rad[..., None] * (1.0 - col),
                   col * 0.75)
    return (255.0 * col).astype(np.uint8)


def compute_color_torch(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """On-device twin of :func:`compute_color`: normalized flow in, (h, w,
    3) uint8 RGB out, on the flow's device."""
    u = u.to(torch.float32)
    v = v.to(torch.float32)
    rad = torch.sqrt(u * u + v * v)
    return _wheel_color(rad, torch.atan2(-v, -u) / np.pi)


def _wheel_color(rad: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """The wheel lookup of :func:`compute_color_torch` from the float32
    radius and hue ``a = atan2(-v, -u) / pi``, in numpy's dtypes: float32
    up to the wheel index, float64 from ``f = fk - k0`` on (numpy
    promotes float32 - int32 to float64)."""
    fk = (a + 1.0) / 2.0 * (NCOLS - 1)
    k0 = fk.to(torch.int32)
    k1 = (k0 + 1) % NCOLS
    f = (fk.to(torch.float64) - k0.to(torch.float64))[..., None]
    wheel = torch.as_tensor(_WHEEL, device=a.device) / 255.0
    col = (1.0 - f) * wheel[k0.long()] + f * wheel[k1.long()]
    radc = rad.to(torch.float64)[..., None]
    col = torch.where(radc <= 1.0, 1.0 - radc * (1.0 - col), col * 0.75)
    return (255.0 * col).to(torch.uint8)


def motion_to_color(u: np.ndarray, v: np.ndarray,
                    maxmotion: float | None = None):
    """Full color_flow behavior: find the max motion radius over known
    pixels, normalize, colorize; unknown-flow pixels are black.

    Returns (rgb (h, w, 3) uint8, maxrad, stats dict)."""
    u = np.asarray(u, np.float64)
    v = np.asarray(v, np.float64)
    if u.size == 0:
        raise ValueError("empty flow field (zero-size u/v)")
    # NaN counts as unknown, like the reference ELF's unknown_flow()
    unknown = (np.abs(u) > UNKNOWN_FLOW_THRESH) \
        | (np.abs(v) > UNKNOWN_FLOW_THRESH) \
        | np.isnan(u) | np.isnan(v)
    uk = np.where(unknown, 0.0, u)
    vk = np.where(unknown, 0.0, v)

    rad = np.sqrt(uk * uk + vk * vk)
    maxrad = float(rad.max()) if rad.size else 0.0
    stats = {"maxu": float(uk.max()), "minu": float(uk.min()),
             "maxv": float(vk.max()), "minv": float(vk.min()),
             "maxrad": maxrad}
    if maxmotion is not None and maxmotion > 0:
        maxrad = maxmotion
    if maxrad == 0:                      # if flow == 0 everywhere
        maxrad = 1.0
    rgb = compute_color(uk / maxrad, vk / maxrad)
    rgb[unknown] = 0
    return rgb, maxrad, stats


def flow_to_png(flo_path: str, png_path: str,
                maxmotion: float | None = None, quiet: bool = True):
    """Python equivalent of the ``color_flow in.flo out.png [maxmotion]``
    CLI (reference bin/color_flow)."""
    from ofot_tpu_torch.utils import flo, image

    w, h, uf, vf = flo.read_flo(flo_path)
    u = uf.reshape(h, w)
    v = vf.reshape(h, w)
    rgb, maxrad, s = motion_to_color(u, v, maxmotion)
    if not quiet:
        print("max motion: %.4f  motion range: u = %.3f .. %.3f; "
              " v = %.3f .. %.3f" % (s["maxrad"], s["minu"], s["maxu"],
                                     s["minv"], s["maxv"]))
    image.save_rgb(rgb, png_path)
    return maxrad


def cli_main(argv=None) -> int:
    """The native tool's surface: ``[-quiet] in.flo out.png
    [maxmotion]``."""
    import sys
    args = list(sys.argv[1:] if argv is None else argv)
    quiet = False
    if args and args[0] == "-quiet":
        quiet = True
        args = args[1:]
    if len(args) not in (2, 3):
        print("  usage: python -m ofot_tpu_torch.utils.colorwheel [-quiet] "
              "in.flo out.png [maxmotion]", file=sys.stderr)
        return 1
    maxmotion = float(args[2]) if len(args) == 3 else None
    flow_to_png(args[0], args[1], maxmotion=maxmotion, quiet=quiet)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli_main())
