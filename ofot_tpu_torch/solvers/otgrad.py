"""Differentiable OT values: envelope-theorem gradients w.r.t. densities.

Counterpart of ``ofot_tpu.solvers.otgrad``.  The entropic value is the
maximum of the dual objective ``D(f, g; a, b) = <f, a> + <g, b> - eps
<e^{f/eps}, K e^{g/eps}> + eps`` over the potentials, and at a converged
plan the penalty term vanishes (unit plan mass), so

    OT_eps(a, b) = <f, a> + <g, b>      and      d OT_eps / d a = f

with (f, g) the converged duals held fixed: no differentiation through
the Sinkhorn iteration.  The densities are normalized internally
(â = a / Σa), whose chain rule gives ``(∇_a OT)_i = (f_i - <f, â>) / Σa``.
The debiased divergence ``S = OT(a,b) - ½ OT(a,a) - ½ OT(b,b)`` has
``∇_a S = [f_ab - p_aa - <f_ab - p_aa, â>] / Σa`` with ``p_aa`` the
(symmetric) self-solve potential.

Each JAX ``custom_vjp`` is a ``torch.autograd.Function`` here: the forward
runs the annealed solves under no_grad (as every ``Function.forward``
does), so no graph is built through the iterations; the backward is the
centered potentials, with zero extra solves.  ``solve_kw`` is a tuple of
(key, value) pairs forwarded to :func:`sinkhorn.solve_annealed`.
"""

from __future__ import annotations

import torch

from ofot_tpu_torch.solvers import sinkhorn


def _dual_value(res, a_hat, b_hat):
    """<f, a> + <g, b> of a converged solve (the regularized OT value)."""
    return torch.sum(res.f * a_hat) + torch.sum(res.g * b_hat)


def _norm(a):
    s = torch.sum(a)
    return a / s, s


def _centered(grad_field, a_hat, total):
    """Normalization chain rule: d(â)/d(a) projects out the mean."""
    return (grad_field - torch.sum(grad_field * a_hat)) / total


class _EntropicOTDual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, epsilon, solve_kw):
        a_hat, sa = _norm(a)
        b_hat, sb = _norm(b)
        res = sinkhorn.solve_annealed(a_hat, b_hat, epsilon, **dict(solve_kw))
        val = _dual_value(res, a_hat, b_hat)
        ctx.save_for_backward(res.f, res.g, a_hat, b_hat, sa, sb)
        return val

    @staticmethod
    def backward(ctx, ct):
        f, g, a_hat, b_hat, sa, sb = ctx.saved_tensors
        return (ct * _centered(f, a_hat, sa), ct * _centered(g, b_hat, sb),
                None, None)


class _SinkhornDivergenceDual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, epsilon, solve_kw):
        kw = dict(solve_kw)
        a_hat, sa = _norm(a)
        b_hat, sb = _norm(b)
        ab = sinkhorn.solve_annealed(a_hat, b_hat, epsilon, **kw)
        aa = sinkhorn.solve_annealed(a_hat, a_hat, epsilon, **kw)
        bb = sinkhorn.solve_annealed(b_hat, b_hat, epsilon, **kw)
        val = (_dual_value(ab, a_hat, b_hat)
               - 0.5 * _dual_value(aa, a_hat, a_hat)
               - 0.5 * _dual_value(bb, b_hat, b_hat))
        # the self-solve is symmetric (f = g) up to the final half-update;
        # average for robustness
        p_aa = 0.5 * (aa.f + aa.g)
        p_bb = 0.5 * (bb.f + bb.g)
        ctx.save_for_backward(ab.f, ab.g, p_aa, p_bb, a_hat, b_hat, sa, sb)
        return val

    @staticmethod
    def backward(ctx, ct):
        f_ab, g_ab, p_aa, p_bb, a_hat, b_hat, sa, sb = ctx.saved_tensors
        ga = _centered(f_ab - p_aa, a_hat, sa)
        gb = _centered(g_ab - p_bb, b_hat, sb)
        return ct * ga, ct * gb, None, None


def entropic_ot_dual(a, b, epsilon=4.0, solve_kw=()):
    """Regularized OT value ``<f, â> + <g, b̂>`` between grid densities,
    differentiable w.r.t. both densities via the envelope theorem."""
    return _EntropicOTDual.apply(a, b, epsilon, tuple(solve_kw))


def sinkhorn_divergence_dual(a, b, epsilon=4.0, solve_kw=()):
    """Debiased Sinkhorn divergence on the dual value,
    ``S = OT(a,b) - ½ OT(a,a) - ½ OT(b,b)``: three annealed solves
    forward, zero extra work backward."""
    return _SinkhornDivergenceDual.apply(a, b, epsilon, tuple(solve_kw))


def wasserstein2_dual(a, b, epsilon=4.0, solve_kw=()):
    """sqrt of the (clamped) debiased dual divergence: a differentiable W2
    estimate in pixel units; autograd flows through the sqrt into the
    envelope backward."""
    s = sinkhorn_divergence_dual(a, b, epsilon, solve_kw)
    return torch.sqrt(torch.clamp(s, min=1e-12))
