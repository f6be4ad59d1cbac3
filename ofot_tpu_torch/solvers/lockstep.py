"""Lockstep batches: B independent pairs advanced by one host loop.

Counterpart of ``jax.vmap`` over the JAX package's solvers (its
``batch_mode="vmap"``).  Under vmap a ``lax.while_loop`` runs while any
pair's condition holds, computes the body for every pair, and keeps a
pair whose condition is false through a select on each carried field.
The port's solvers loop on the host, so the lockstep form is the same
loop over (B, ...) tensors: one "any pair still running" flag is read per
iteration, and :func:`select_pairs` freezes the pairs that have stopped.

A per-pair scalar that the single-pair solvers keep as a Python float
(the ADMM penalty ``r`` under ``auto_r``) is a :class:`PerPair`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


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


def run(state: NamedTuple, step: Callable, max_it: int):
    """Advance ``state`` (fields with a leading batch axis, among them
    ``done`` and ``iteration``) by ``step`` while any pair has
    ``~done & iteration < max_it``; a pair that has stopped keeps every
    field."""
    while True:
        running = ~state.done & (state.iteration < max_it)
        if not bool(running.any()):
            return state
        state = select_pairs(running, step(state), state)


def pair(batch: NamedTuple, i: int):
    """Pair ``i`` of a batched NamedTuple (each field indexed)."""
    return type(batch)(*(f[i] for f in batch))
