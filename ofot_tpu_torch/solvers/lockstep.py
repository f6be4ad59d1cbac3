"""Lockstep batches: B independent pairs advanced by one host loop.

Counterpart of ``jax.vmap`` over the JAX package's solvers (its
``batch_mode="vmap"``).  Under vmap a ``lax.while_loop`` runs while any
pair's condition holds, computes the body for every pair, and keeps a
pair whose condition is false through a select on each carried field.
The port's lockstep form is the same loop over (B, ...) tensors, with the
same result bitwise.  On the device (``solvers/device_loop.py``, one "any
pair still running" read per block of K iterations) the per-pair scalars
are selected every iteration and each pair's fields are latched once, at
its own stop, while the batch carries them on unmasked; with
``loop="host"`` (one read an iteration) :func:`select_pairs` freezes the
stopped pairs' every field.

A per-pair scalar that the single-pair solvers keep as a Python float
(the ADMM penalty ``r`` under ``auto_r``) is a :class:`PerPair`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ofot_tpu_torch.solvers import device_loop
from ofot_tpu_torch.utils.trace import annotate


class PerPair:
    """One float per pair of a lockstep batch, also held as a (B,) tensor
    in the batch's dtype on its device.

    Arithmetic with a Python number stays on the host in float64, as a
    single pair's float does (so ``r * eps`` rounds as a single pair's
    ``r * eps``); arithmetic with a (B, ...) tensor broadcasts the values
    over the pair axis."""

    def __init__(self, values, like: torch.Tensor):
        self.values = tuple(float(v) for v in values)
        self.t = torch.tensor(self.values, dtype=like.dtype,
                              device=like.device)

    def _map(self, fn) -> "PerPair":
        return PerPair([fn(v) for v in self.values], self.t)

    def over(self, x: torch.Tensor) -> torch.Tensor:
        """The values shaped to broadcast against (B, ...) ``x``."""
        return self.t.view(-1, *(1,) * (x.dim() - 1))

    def __neg__(self) -> "PerPair":
        return self._map(lambda v: -v)

    def __mul__(self, other):
        if isinstance(other, torch.Tensor):
            return self.over(other) * other
        return self._map(lambda v: v * other)

    __rmul__ = __mul__

    def __rtruediv__(self, other: torch.Tensor) -> torch.Tensor:
        return other / self.over(other)


def kernel_r(r):
    """``r`` as a kernel wrapper takes it: a float, or a (B,) tensor."""
    return r.t if isinstance(r, PerPair) else r


def select_pairs(keep: torch.Tensor, new: NamedTuple, old: NamedTuple):
    """Field by field, pair ``b`` of ``new`` where ``keep[b]``, else of
    ``old`` (the select ``jax.vmap`` makes of a batched while_loop's
    carry)."""
    return type(new)(*(
        torch.where(keep.view(-1, *(1,) * (n.dim() - 1)), n, o)
        for n, o in zip(new, old)))


def run(state: NamedTuple, step: Callable, max_it: int, args=(), *,
        loop: str = "auto", key=None, trace=None, show=None):
    """Advance ``state`` (fields with a leading batch axis, among them
    ``done`` and ``iteration``) by ``step(state, *args)`` while any pair
    has ``~done & iteration < max_it``; a pair that has stopped keeps every
    field.

    ``loop``: ``"device"`` runs ``device_loop.while_loop`` (blocks of K
    iterations, one flag read a block; a captured graph cached under
    ``key`` on cuda, with ``args`` its tensor inputs), ``"host"`` reads
    the flag every iteration; ``"auto"`` is ``"device"`` on cuda.  With
    ``trace``/``show`` both print, for every iteration, ``show`` of the
    records ``trace(old, new)`` makes of the carried state before and
    after it (``device_loop.while_loop``).  Span ``lockstep.loop``."""
    def running(s, *a):
        return ~s.done & (s.iteration < max_it)

    with annotate("lockstep.loop"):
        if device_loop.resolve(loop, state.done.device) == "device":
            return device_loop.while_loop(
                step, running, state, args,
                key=None if key is None else ("lockstep", key, max_it),
                trace=trace, show=show)
        while True:
            keep = running(state)
            if not bool(keep.any()):
                return state
            old, state = state, select_pairs(keep, step(state, *args), state)
            if trace is not None:
                show(*(t.tolist() for t in trace(old, state)))


def pair(batch: NamedTuple, i: int):
    """Pair ``i`` of a batched NamedTuple (each field indexed)."""
    return type(batch)(*(f[i] for f in batch))
