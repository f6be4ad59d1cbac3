"""Matrix-free conjugate-gradient solver on torch tensors.

Counterpart of ``ofot_tpu.solvers.cg``, with the convergence semantics of
``scipy.sparse.linalg.cg`` as the reference uses it (reference
benamou_brenier.py:85): start from x0 = 0, stop when
``||r||_2 <= max(rtol * ||b||_2, atol)`` or after ``maxiter`` iterations.

The JAX version runs a ``lax.while_loop`` on the device.  Here
``loop="device"`` (the default on cuda) runs the iteration in blocks of K
steps (``solvers/device_loop.py``): steps after the stop leave the
scalars (``rz``, ``rnorm2``, ``k``) as they were, ``x``, ``r`` and ``p``
are kept as they were at the stop, and the loop reads the residual test
once per block.  ``loop="host"`` (the default on the CPU) reads the
squared residual norm once per step.  Both give the same bits.

A captured block bakes in what ``A``, ``M`` and ``dot`` close over, so a
graph is cached only under a caller's ``key`` that names all of it (the
ALG2 stepA sets pass one: their operator closes over ``r`` and ``eps``
only), with the data tensors they close over named ``bound`` (GN and HS:
the pair's gradients and spectrum, copied into the cached graph's own);
without a key each solve captures its own graph.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ofot_tpu_torch.solvers import device_loop
from ofot_tpu_torch.utils import trace


class CGResult(NamedTuple):
    x: torch.Tensor
    iterations: int           # number of iterations performed
    residual: torch.Tensor    # final ||r||_2 (0-d)
    converged: bool


def _default_dot(a, b):
    return torch.sum(a * b)


class _CGState(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor
    rnorm2: torch.Tensor
    k: torch.Tensor          # steps taken (int64)


def _device_cg(A, precond, dot, M, state: _CGState, thresh2, maxiter, key,
               bound, per_pair):
    """The CG iteration on the device loop; ``per_pair`` shapes a (B,)
    scalar to its batch (identity for one system)."""
    def running(s, thresh2):
        return (s.k < maxiter) & (s.rnorm2 > thresh2)

    def step(s, thresh2):
        q = A(s.p)
        alpha = per_pair(s.rz / dot(s.p, q), s.p)
        r = s.r - alpha * q
        z = precond(r)
        rz_new = dot(r, z)
        rnorm2 = rz_new if M is None else dot(r, r)
        beta = per_pair(rz_new / s.rz, s.p)
        return _CGState(x=s.x + alpha * s.p, r=r, p=z + beta * s.p,
                        rz=rz_new, rnorm2=rnorm2, k=s.k + 1)

    return device_loop.while_loop(
        step, running, state, (thresh2,),
        key=None if key is None else ("cg", key, maxiter, M is None),
        bound=bound)


def cg(A: Callable, b: torch.Tensor, *,
       rtol: float = 1e-6, atol: float = 0.0, maxiter: int = 1000,
       M: Optional[Callable] = None,
       dot: Callable = _default_dot,
       x0: Optional[torch.Tensor] = None, loop: str = "auto",
       key=None, bound=()) -> CGResult:
    """Solve ``A x = b`` with (preconditioned) CG, matrix-free.

    Parameters mirror scipy's ``cg``; ``M`` is the preconditioner *action*
    (an approximation of A^-1).  ``loop``: "device", "host" or "auto"
    (see the module docstring); ``key``: the graph cache key of ``A``,
    ``M`` and ``dot`` (None: capture per solve), ``bound``: the data
    tensors they close over."""
    x = torch.zeros_like(b) if x0 is None else x0
    precond = M if M is not None else (lambda v: v)

    r = b - A(x) if x0 is not None else b
    z = precond(r)
    p = z
    rz = dot(r, z)
    rnorm2 = rz if M is None else dot(r, r)
    bnorm2 = dot(b, b)
    # scipy: ||r|| <= max(rtol*||b||, atol)
    thresh2 = torch.clamp(rtol * rtol * bnorm2, min=atol * atol)

    with trace.annotate("cg.loop"):
        if device_loop.resolve(loop, b.device) == "device":
            s = _device_cg(A, precond, dot, M, _CGState(
                x, r, p, rz, rnorm2, torch.zeros((), dtype=torch.int64,
                                                 device=b.device)),
                thresh2, maxiter, key, bound, lambda s, like: s)
            k, converged = (int(v) for v in torch.stack(
                [s.k, (s.rnorm2 <= thresh2).to(s.k.dtype)]).tolist())
            return CGResult(x=s.x, iterations=k,
                            residual=torch.sqrt(s.rnorm2),
                            converged=bool(converged))

        k = 0
        while k < maxiter and bool(rnorm2 > thresh2):
            q = A(p)
            pq = dot(p, q)
            alpha = rz / pq
            x = x + alpha * p
            r = r - alpha * q
            z = precond(r)
            rz_new = dot(r, z)
            rnorm2 = rz_new if M is None else dot(r, r)
            beta = rz_new / rz
            p = z + beta * p
            rz = rz_new
            k += 1

        return CGResult(x=x, iterations=k, residual=torch.sqrt(rnorm2),
                        converged=bool(rnorm2 <= thresh2))


def _per_pair(s: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (B,) per-pair scalar shaped to broadcast against ``like``."""
    return s.view(-1, *(1,) * (like.dim() - 1))


def cg_batched(A: Callable, b: torch.Tensor, *,
               rtol: float = 1e-6, atol: float = 0.0, maxiter: int = 1000,
               M: Optional[Callable] = None,
               dot: Callable | None = None, loop: str = "auto",
               key=None, bound=()) -> CGResult:
    """Lockstep CG on a batch of B independent systems: ``b`` is (B, ...),
    ``A`` and ``M`` act on the whole batch, and ``dot`` reduces per pair to
    a (B,) tensor (default: the sum over every axis but the first).

    Each pair keeps scipy's stop ``||r|| <= max(rtol*||b||, atol)`` and its
    own step count: a pair that has met it, or has taken ``maxiter``
    steps, keeps its ``x``, ``r``, ``p`` and scalars: through
    ``torch.where`` on the host loop, as frozen scalars and fields latched
    at its stop on the device loop (its ``p.Ap`` can be 0, so its alpha
    can be NaN, and a multiplied mask would carry that NaN in; the dots
    reduce pair by pair, so a NaN of one pair never reaches another).  The
    loop reads one "any pair still running" flag per block of K steps
    (``loop="device"``) or per step (``loop="host"``), as :func:`cg`
    does.  Returns a CGResult whose ``iterations``, ``residual`` and
    ``converged`` are (B,) tensors."""
    if dot is None:
        def dot(u, v):
            return torch.sum((u * v).flatten(1), dim=1)
    precond = M if M is not None else (lambda v: v)

    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = dot(r, z)
    rnorm2 = rz if M is None else dot(r, r)
    thresh2 = torch.clamp(rtol * rtol * dot(b, b), min=atol * atol)
    k = torch.zeros(b.shape[0], dtype=torch.int64, device=b.device)

    with trace.annotate("cg.loop"):
        if device_loop.resolve(loop, b.device) == "device":
            s = _device_cg(A, precond, dot, M,
                           _CGState(x, r, p, rz, rnorm2, k), thresh2,
                           maxiter, key, bound, _per_pair)
            return CGResult(x=s.x, iterations=s.k,
                            residual=torch.sqrt(s.rnorm2),
                            converged=s.rnorm2 <= thresh2)

        while True:
            running = (k < maxiter) & (rnorm2 > thresh2)
            if not bool(running.any()):
                break
            q = A(p)
            alpha = _per_pair(rz / dot(p, q), p)
            r_new = r - alpha * q
            z = precond(r_new)
            rz_new = dot(r_new, z)
            rnorm2_new = rz_new if M is None else dot(r_new, r_new)
            beta = _per_pair(rz_new / rz, p)
            keep = _per_pair(running, p)
            x = torch.where(keep, x + alpha * p, x)
            r = torch.where(keep, r_new, r)
            p = torch.where(keep, z + beta * p, p)
            rz = torch.where(running, rz_new, rz)
            rnorm2 = torch.where(running, rnorm2_new, rnorm2)
            k = k + running.to(k.dtype)

        return CGResult(x=x, iterations=k, residual=torch.sqrt(rnorm2),
                        converged=rnorm2 <= thresh2)
