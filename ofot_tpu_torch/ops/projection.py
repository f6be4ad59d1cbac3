"""Pointwise projection onto the Benamou–Brenier paraboloid (plain torch).

Counterpart of ``ofot_tpu.ops.projection``: the branch-free form of the
reference's ``stepB`` (reference benamou_brenier.py:93-149), projecting each
point ``p = (alpha, beta_1 .. beta_k)`` onto

    K = { (a, b) in R x R^k : a + |b|^2 / 2 <= 0 }.

Every point computes both cubic-root branches (Cardano for a single real
root, trigonometric for three) on domain-clamped inputs and selects with
``torch.where``.  The Cardano radicand ``(4/3)(a+1)^3 + (9/2) rho^2`` is
positive exactly on the single-root branch, so its square root is safe
there; the arccos argument is clamped to [0, 1] for fp safety.  torch has
no ``cbrt``: ``s ** (1/3)`` serves for the non-negative ``s`` of the
Cardano branch.
"""

from __future__ import annotations

import torch

_SQRT2 = 1.4142135623730951
_TRIG_COEF = 2.0 * (2.0 / 3.0) ** 0.5      # 2*sqrt(2/3)
_ACOS_COEF = (3.0 / 2.0) ** 1.5            # (3/2)^(3/2)


def _project_core(alpha, rho2, eps):
    """Project ``(alpha, rho)`` with ``rho = sqrt(rho2) >= 0`` onto
    ``a + rho^2 / 2 <= 0`` -> ``(inside, alpha_h, rho_h)``; the projected
    coordinates are only meaningful where ``~inside``."""
    rho = torch.sqrt(rho2)
    inside = 2.0 * alpha + rho2 <= 0.0

    ap1 = alpha + 1.0
    radicand = (4.0 / 3.0) * ap1 * ap1 * ap1 + 4.5 * rho2
    single = radicand > 0.0          # == -32*(a+1)^3 - 108*rho^2 < 0

    # --- Cardano branch (single real root) ---
    s = 0.25 * _SQRT2 * rho + (1.0 / 6.0) * torch.sqrt(
        torch.clamp(radicand, min=0.0))
    c = s ** (1.0 / 3.0)             # s >= 0 on its branch
    c_safe = torch.where(c > 0, c, 1.0)
    zh_card = -(1.0 / 3.0) * ap1 / c_safe + c

    # --- trigonometric branch (triple real root), needs alpha < -1 ---
    nam = torch.clamp(-ap1, min=eps)
    acos_arg = torch.clamp(_ACOS_COEF * rho / (nam * torch.sqrt(nam)),
                           0.0, 1.0)
    zh_trig = _TRIG_COEF * torch.sqrt(nam) * torch.cos(
        torch.acos(acos_arg) / 3.0)

    zh = torch.where(single, zh_card, zh_trig)
    alpha_h = torch.where(single, -zh * zh, -0.5 * zh * zh)
    rho_h = torch.where(single, _SQRT2 * zh, zh)
    return inside, alpha_h, rho_h


def _proj_eps(dtype) -> float:
    """Floor of the divisions: 1e-30 in float64, 1e-20 in float32
    (``ofot_tpu/ops/projection.py:69-70``)."""
    return 1e-30 if dtype == torch.float64 else 1e-20


def project_paraboloid(p: torch.Tensor) -> torch.Tensor:
    """Project ``p`` (component axis 0: alpha, beta1, beta2) onto K.

    Accepts any shape ``(3, ...)``; returns the same shape.  The beta
    direction is taken as cos/sin of atan2(beta2, beta1), with
    atan2(0, 0) = 0 giving (1, 0)."""
    alpha, beta1, beta2 = p[0], p[1], p[2]
    eps = _proj_eps(p.dtype)

    rho2 = beta1 * beta1 + beta2 * beta2
    rho = torch.sqrt(rho2)
    safe_rho = torch.clamp(rho, min=eps)
    cos_t = torch.where(rho > 0, beta1 / safe_rho, 1.0)
    sin_t = torch.where(rho > 0, beta2 / safe_rho, 0.0)

    inside, alpha_h, rho_h = _project_core(alpha, rho2, eps)

    a_out = torch.where(inside, alpha, alpha_h)
    b1_out = torch.where(inside, beta1, rho_h * cos_t)
    b2_out = torch.where(inside, beta2, rho_h * sin_t)
    return torch.stack([a_out, b1_out, b2_out])


def project_paraboloid_nd(p: torch.Tensor) -> torch.Tensor:
    """Project ``p`` (component axis 0: alpha, beta_1 .. beta_k) onto K for
    any k >= 1.  The projection acts only on (alpha, |beta|), so the betas
    are rescaled by ``rho_h / rho`` (exactly 0 at the rho = 0 apex, where
    rho_h = 0).  k = 2 is the Benamou–Brenier stepB, k = 3 the WFR one."""
    alpha, betas = p[0], p[1:]
    eps = _proj_eps(p.dtype)
    rho2 = torch.sum(betas * betas, dim=0)
    inside, alpha_h, rho_h = _project_core(alpha, rho2, eps)
    scale = torch.where(inside, 1.0,
                        rho_h / torch.clamp(torch.sqrt(rho2), min=eps))
    a_out = torch.where(inside, alpha, alpha_h)
    return torch.cat([a_out[None], betas * scale[None]])
