"""Backward warping of an image by a flow field.

Counterpart of ``ofot_tpu.utils.warp`` (reference ``apply_opticalflow``,
utils.py:186-248), with its exact numerics:

  * optional luminosity pre-multiplication ``f1 <- (1 + m) * f1``
    (reference utils.py:202-203);
  * source position (i - v, j - u); fractional offsets via truncation
    toward zero computed **before** clamping the position into the image
    (so offsets can be negative near the border);
  * positions clamped into [0, h-1] x [0, w-1]; the four reference boundary
    branches (utils.py:228-247) collapse to clamping the +1 neighbor index.
"""

from __future__ import annotations

import torch


def apply_flow(f1: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
               m: torch.Tensor | None = None) -> torch.Tensor:
    """Backward-warp ``f1`` (Ny, Nx) by flow (u, v); optional luminosity m.
    Returns the warped image (Ny, Nx)."""
    h, w = f1.shape
    dtype, device = f1.dtype, f1.device
    if m is not None:
        f1 = (1.0 + m) * f1

    jj = torch.arange(w, dtype=dtype, device=device)[None, :].expand(h, w)
    ii = torch.arange(h, dtype=dtype, device=device)[:, None].expand(h, w)

    src_i = ii - v
    src_j = jj - u

    # fractional offsets w.r.t. the truncated (toward zero), UNclamped corner
    di = src_i - torch.trunc(src_i)
    dj = src_j - torch.trunc(src_j)

    w1 = (1.0 - di) * (1.0 - dj)
    w2 = dj * (1.0 - di)
    w3 = di * dj
    w4 = (1.0 - dj) * di

    ti = torch.trunc(torch.clamp(src_i, 0.0, h - 1)).long()
    tj = torch.trunc(torch.clamp(src_j, 0.0, w - 1)).long()
    tip = torch.clamp(ti + 1, max=h - 1)
    tjp = torch.clamp(tj + 1, max=w - 1)

    return (w1 * f1[ti, tj] + w2 * f1[ti, tjp]
            + w3 * f1[tip, tjp] + w4 * f1[tip, tj])
