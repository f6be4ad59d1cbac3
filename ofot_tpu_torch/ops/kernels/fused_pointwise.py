"""Fused stepB + stepC + criterion pass: CUDA kernel and plain version.

Counterpart of ``fused_pointwise_pallas`` (ofot_tpu/ops/pallas/kernels.py
:288, kernel body :224).  ``fused_pointwise`` launches the CUDA kernel of
``ofot_tpu_torch/csrc/fused_pointwise.cu`` on CUDA tensors and runs
``fused_pointwise_reference``, the plain torch version, on CPU tensors;
any other device, dtype or layout raises.  ``fused_pointwise_batched`` is
the lockstep batch form: (B, 1+k, Nt, Ny, Nx) fields, a per-pair ``r`` and
per-pair sums, all B pairs in one launch of the same kernel, each pair
bitwise its single-pair launch.

``launches`` counts the kernel's launches in this process; it is the only
module-level state, and only the CUDA branch of the wrapper changes it.
"""

from __future__ import annotations

import torch

from ofot_tpu_torch.ops.kernels import _build

launches = 0

# Grid cap of the pointwise kernel.  Fixed (not derived from the card) so
# the criterion partials, and with them the sums, depend only on L.
MAX_BLOCKS = 1024

_SQRT2 = 1.4142135623730951
_TRIG_COEF = 2.0 * (2.0 / 3.0) ** 0.5
_ACOS_COEF = (3.0 / 2.0) ** 1.5
_EPS = 1e-20


# ------------------------------------------------------------ plain version

def _project_core(alpha, rho2):
    """The Pallas kernel's projection core (kernels.py:59-92): exp/log
    cube root and ``cos(acos(x)/3)`` by five Newton steps on
    ``4c^3 - 3c = x`` from c = 1, with the kernel's 1e-20 floor."""
    rho = torch.sqrt(rho2)
    inside = 2.0 * alpha + rho2 <= 0.0

    ap1 = alpha + 1.0
    radicand = (4.0 / 3.0) * ap1 * ap1 * ap1 + 4.5 * rho2
    single = radicand > 0.0

    s = 0.25 * _SQRT2 * rho + (1.0 / 6.0) * torch.sqrt(
        torch.clamp(radicand, min=0.0))
    c = torch.exp(torch.log(torch.clamp(s, min=_EPS)) * (1.0 / 3.0))
    c = torch.where(s > 0, c, 0.0)
    c_safe = torch.where(c > 0, c, 1.0)
    zh_card = -(1.0 / 3.0) * ap1 / c_safe + c

    nam = torch.clamp(-ap1, min=_EPS)
    acos_arg = torch.clamp(_ACOS_COEF * rho / (nam * torch.sqrt(nam)),
                           0.0, 1.0)
    c3 = torch.ones_like(acos_arg)
    for _ in range(5):
        c3 = c3 - (4.0 * c3 * c3 * c3 - 3.0 * c3 - acos_arg) / (
            12.0 * c3 * c3 - 3.0)
    zh_trig = _TRIG_COEF * torch.sqrt(nam) * c3

    zh = torch.where(single, zh_card, zh_trig)
    alpha_h = torch.where(single, -zh * zh, -0.5 * zh * zh)
    rho_h = torch.where(single, _SQRT2 * zh, zh)
    return inside, alpha_h, rho_h


def _project_point_nd(alpha, betas):
    """Projection of (alpha, betas) with the betas stacked on axis 0
    (kernels.py:112-127): all betas rescale by ``rho_h / rho``."""
    rho2 = betas[0] * betas[0]
    for b in betas[1:]:
        rho2 = rho2 + b * b
    inside, alpha_h, rho_h = _project_core(alpha, rho2)
    scale = torch.where(inside, 1.0,
                        rho_h / torch.clamp(torch.sqrt(rho2), min=_EPS))
    return torch.where(inside, alpha, alpha_h), betas * scale


def fused_pointwise_reference(grad_phi, mu, r, alpha=None, q_prev=None):
    """Plain torch version of the fused pass, in the Pallas kernel's
    arithmetic; same arguments and results as :func:`fused_pointwise`."""
    g0, gb = grad_phi[0], grad_phi[1:]
    m0, mb = mu[0], mu[1:]
    if q_prev is None:
        x0, xb = g0, gb
    else:
        x0 = alpha * g0 + (1.0 - alpha) * q_prev[0]
        xb = alpha * gb + (1.0 - alpha) * q_prev[1:]

    q0, qb = _project_point_nd(x0 + m0 / r, xb + mb / r)
    n0 = torch.clamp(m0 + r * (x0 - q0), min=0.0)   # density clamped >= 0
    nb = mb + r * (xb - qb)

    speed2 = gb[0] * gb[0]
    for g in gb[1:]:
        speed2 = speed2 + g * g
    res = g0 + 0.5 * speed2
    num = torch.sum(n0 * torch.abs(res))
    den = torch.sum(n0 * speed2)
    return (torch.cat([q0[None], qb]), torch.cat([n0[None], nb]), num, den)


def _pair_r(r, b):
    """Pair ``b``'s r: ``r`` is one float for every pair or a (B,)
    tensor."""
    return float(r[b]) if isinstance(r, torch.Tensor) else r


def fused_pointwise_batched_reference(grad_phi, mu, r, alpha=None,
                                      q_prev=None):
    """Plain torch version of :func:`fused_pointwise_batched`: the
    single-pair plain version applied pair by pair."""
    outs = [fused_pointwise_reference(
        grad_phi[b], mu[b], _pair_r(r, b), alpha,
        None if q_prev is None else q_prev[b]) for b in range(len(mu))]
    return tuple(torch.stack(f) for f in zip(*outs))


# ------------------------------------------------------------ CUDA kernel

def prepare_launch(grad_phi, mu, r, alpha=None, q_prev=None,
                   batched=False):
    """Check CUDA operands and allocate the outputs of one kernel launch.

    ``batched``: the fields are (B, 1+k, ...) and ``r`` is one float or a
    (B,) tensor; ``sums`` is then (B, 2), else (2,).

    Returns ``(enqueue, (q, mu_new, sums))``: ``enqueue()`` puts the kernel
    on the current stream and raises on a launch error; it does not count
    launches (the wrapper does).  Calling it again overwrites the same
    outputs, which is how a timing loop measures the launch alone."""
    _build.check_cuda(grad_phi, "fused_pointwise")
    operands = [("grad_phi", grad_phi), ("mu", mu)]
    if q_prev is not None:
        operands.append(("q_prev", q_prev))
    for name, t in operands:
        _build.check_operand(name, t, grad_phi)
    batch = grad_phi.shape[0] if batched else 1
    ncomp = grad_phi.shape[1] if batched else grad_phi.shape[0]
    if ncomp not in (3, 4) or grad_phi.dim() < 2 + batched:
        raise ValueError(f"grad_phi must be ({'B, ' if batched else ''}1+k, "
                         f"...) with k in {{2, 3}}, got shape "
                         f"{tuple(grad_phi.shape)}")
    if not 0 < batch <= 65535:
        raise ValueError(f"a batch of {batch} pairs (1 to 65535)")
    L = grad_phi.numel() // (batch * ncomp)
    if L == 0:
        raise ValueError("grad_phi has no points")
    r_pairs = None
    if isinstance(r, torch.Tensor) and r.dim() > 0:
        if not batched or r.shape != (batch,):
            raise ValueError(f"a per-pair r must be ({batch},) for a batch, "
                             f"got shape {tuple(r.shape)}")
        r_pairs = r.to(grad_phi.device, torch.float32).contiguous()

    lib = _build.load_library()
    threads = lib.ofot_fused_pointwise_threads()
    nblocks = min(-(-L // threads), MAX_BLOCKS)
    q = torch.empty_like(grad_phi)
    mu_new = torch.empty_like(mu)
    partials = torch.empty(batch * 2 * nblocks, dtype=torch.float32,
                           device=grad_phi.device)
    sums = torch.empty((batch, 2) if batched else (2,), dtype=torch.float32,
                       device=grad_phi.device)
    stream = _build.stream_of(grad_phi)
    args = (grad_phi.data_ptr(), mu.data_ptr(),
            None if q_prev is None else q_prev.data_ptr(),
            q.data_ptr(), mu_new.data_ptr(), partials.data_ptr(),
            sums.data_ptr(), ncomp, L, nblocks, batch,
            1.0 if r_pairs is not None else float(r),
            None if r_pairs is None else r_pairs.data_ptr(),
            1.0 if alpha is None else float(alpha), stream)

    def enqueue():
        _build.check_launch(lib, lib.ofot_fused_pointwise(*args),
                            "fused_pointwise")

    # the closure holds the raw pointers: keep every buffer alive with it
    enqueue.buffers = (grad_phi, mu, q_prev, partials, r_pairs)
    return enqueue, (q, mu_new, sums)


def _check_relaxation(alpha, q_prev) -> None:
    if alpha is not None and q_prev is None:
        # silently running the un-relaxed update would let over-relaxation
        # no-op
        raise ValueError("alpha given without q_prev")
    if q_prev is not None and alpha is None:
        raise ValueError("q_prev given without alpha")


def fused_pointwise(grad_phi: torch.Tensor, mu: torch.Tensor, r,
                    alpha=None, q_prev: torch.Tensor | None = None):
    """Fused stepB + stepC + HJ-criterion sums.

    ``grad_phi``, ``mu``: (1+k, Nt, Ny, Nx) with k = 2 (balanced) or 3
    (source-extended).  Returns ``(q, mu_new, num, denom)`` with 0-d
    criterion sums such that ``crit = sqrt(num / (denom + 1e-10))``.

    ``alpha``/``q_prev`` (both or neither): over-relaxed ADMM — stepB and
    stepC act on ``alpha*grad_phi + (1-alpha)*q_prev``, the criterion on
    the true grad_phi.

    CUDA tensors go to the kernel (float32, contiguous, one device, equal
    shapes, else it raises); CPU tensors to :func:`fused_pointwise_reference`.
    """
    _check_relaxation(alpha, q_prev)
    if grad_phi.device.type == "cpu":
        return fused_pointwise_reference(grad_phi, mu, r, alpha, q_prev)
    global launches
    enqueue, (q, mu_new, sums) = prepare_launch(grad_phi, mu, r, alpha,
                                                q_prev)
    enqueue()
    launches += 1
    return q, mu_new, sums[0], sums[1]


def fused_pointwise_batched(grad_phi: torch.Tensor, mu: torch.Tensor, r,
                            alpha=None, q_prev: torch.Tensor | None = None):
    """The fused pass over a lockstep batch of pairs.

    ``grad_phi``, ``mu`` (and ``q_prev``): (B, 1+k, Nt, Ny, Nx); ``r``: one
    float for every pair or a (B,) tensor of per-pair penalties.  Returns
    ``(q, mu_new, num, denom)`` with (B,) criterion sums.  CUDA tensors go
    to one launch of the kernel for the whole batch (counted once in
    ``launches``); CPU tensors to :func:`fused_pointwise_batched_reference`.
    """
    _check_relaxation(alpha, q_prev)
    if grad_phi.device.type == "cpu":
        return fused_pointwise_batched_reference(grad_phi, mu, r, alpha,
                                                 q_prev)
    global launches
    enqueue, (q, mu_new, sums) = prepare_launch(grad_phi, mu, r, alpha,
                                                q_prev, batched=True)
    enqueue()
    launches += 1
    return q, mu_new, sums[:, 0], sums[:, 1]
