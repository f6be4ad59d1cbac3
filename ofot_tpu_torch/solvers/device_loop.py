"""Solver loops on the device: the counterpart of ``lax.while_loop`` and
``lax.fori_loop``.

The JAX package runs every solver loop inside one jitted program, so the
host never waits on the device until the loop is done.  Here a loop on
CUDA tensors runs as replays of a captured ``torch.cuda.CUDAGraph`` of K
iterations: the host reads one "still running" flag per replay, not one
per iteration.  Inside a block, iterations run on past a stop (at most
K - 1 for one pair; in a lockstep batch, a stopped pair until the batch
ends), so each pair's result is frozen at its own stop:

    run = running(state)
    K times:
        new = step(state)
        state = new, with its per-pair scalars select(run, new, state)
        nxt = running(state)                # sticky: done, counts frozen
        held = latch(run & ~nxt, state, held)
        run = nxt

A carried tensor with one element a pair (0-d for one pair, (B,) for a
lockstep batch: criteria, counters, flags) is a per-pair scalar, selected
every iteration, so a stopped pair's counters and flags stay as they were
and its ``running`` stays false.  A larger one is a field: it is carried
unmasked, and each pair's part of it is copied into the loop's held
buffers once, on the iteration where that pair stops (``latch``); the
loop returns the held fields with the scalars.  The held fields are
``new`` of the stopping iteration, which is what the host loop keeps, and
pairs never mix (every per-pair sum and product of a batch contracts
within its pair), so the result is bitwise the host loop's, as
``lax.while_loop`` (and, for a batch, ``jax.vmap`` of it) gives.  Both
steps are one kernel launch each on cuda (``ops/kernels/loop_mask.py``)
and their plain versions on the CPU.

* ``loop="auto"`` is ``"device"`` on cuda and ``"host"`` on the CPU.  On
  the CPU ``"device"`` runs the same blocked body eagerly, with no
  capture; the tests exercise that form.
* Before a capture, the body runs once eagerly on the loop's own stream
  (the warm-up: plans, the kernel library and the cuBLAS handles are
  built on first use and must exist before capture), with its result
  dropped.  The capture then records the block and the copy of its result
  back into the graph's static input buffers, so replays chain.  The held
  fields are static buffers of the graph too: loaded with the start state
  (a pair that starts stopped keeps it), written only by the latch, in
  place, and never copied back.
* Every tensor the body reads is either a field of the state or one of
  ``args``: both are copied into the graph's static buffers before the
  first replay of each loop.  Everything else the body closes over (the
  ops set and its plans, Python scalars such as ``r``) is baked in at
  capture, so the graph cache's key must name it.  The cache keeps the
  body (and with it what it closes over) alive with the graph.  A body
  whose closures hold data of the solve (GN's gradients and spectrum)
  names those tensors ``bound``: the graph keeps the first solve's, and a
  later solve that reuses the graph copies its own into them.
* A capture or replay error raises.  Nothing falls back to the host loop.
  During a capture the sync debug mode is "error", so a host read inside
  the body raises at once.
* The kernel wrappers count launches in Python, which a replay does not
  run: the counts a capture added are taken back and added again on
  every replay, so launches = eager launches (warm-ups included) +
  replays x launches per graph.

``stats`` records captures, their milliseconds, replays, the iteration
slots the replays offered (replays x K) and those of them whose fields
went through the latch (``latch_slots``, also the trace counter
``device_loop.latch_slots``), for the launch and iteration relations that
``chip_smoke.py`` checks: per kernel, launches = warm-up launches +
replayed launches, replayed launches = the slots of the replays that
launched it, and iterations <= slots <= iterations + (K - 1) a loop.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, NamedTuple

import torch

from ofot_tpu_torch.ops import kernels
from ofot_tpu_torch.ops.kernels import loop_mask
from ofot_tpu_torch.utils import trace as _trace
from ofot_tpu_torch.utils.trace import annotate

# Iterations per block (K).  K = 1 reads the card every iteration; from
# K = 4 on, an ALG2 iteration costs the same on the card, while the
# capture's time and the iterations run past the stop (at most K - 1)
# grow with K (PERF.md §6: the K sweep of chip_smoke.py's phase 19).
BLOCK = 8
# Captured graphs kept; each pins its private memory pool.
CACHE_SIZE = 16


@dataclass
class Stats:
    captures: int = 0
    capture_ms: float = 0.0
    replays: int = 0                # blocks run (replays, or eager blocks)
    slots: int = 0                  # sum over replays of the block's K
    latch_slots: int = 0            # the slots of blocks with a latch
    eager_launches: dict = field(default_factory=dict)   # warm-ups
    graph_launches: dict = field(default_factory=dict)   # by replays
    # per kernel: the slots of the replays that launched it, and the
    # iterations its loops may have run past their stops (K - 1 a
    # while loop), so that iterations <= slots <= iterations + spare
    kernel_slots: dict = field(default_factory=dict)
    kernel_spare: dict = field(default_factory=dict)


stats = Stats()


def reset_stats() -> None:
    global stats
    stats = Stats()


def resolve(loop: str, device) -> str:
    """``"device"`` or ``"host"`` for a ``loop=`` keyword on ``device``."""
    if loop == "auto":
        return "device" if torch.device(device).type == "cuda" else "host"
    if loop not in ("device", "host"):
        raise ValueError(f"loop={loop!r}: expected auto, device or host")
    return loop


def select(run: torch.Tensor, new, old) -> tuple:
    """Pair by pair, ``new`` where ``run`` else ``old``, for the per-pair
    scalars of a loop's state (each with one element a pair; ``run`` 0-d,
    or (B,) one flag per pair of a batch): one launch on cuda."""
    return loop_mask.select_scalars(run, tuple(new), tuple(old))


# ------------------------------------------------------------ counters

def _counts() -> dict:
    return kernels.launch_counts()


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _shift_counts(delta: dict, sign: int = 1) -> None:
    """Add ``sign`` x ``delta`` to the kernels' launch counts."""
    for name, n in delta.items():
        mod, attr = kernels.KERNELS[name]
        module = kernels._module(mod)
        setattr(module, attr, getattr(module, attr) + sign * n)


def _tally(into: dict, delta: dict) -> None:
    for name, n in delta.items():
        into[name] = into.get(name, 0) + n


# ------------------------------------------------------------ runners

_side_streams: dict = {}


def _side_stream(device) -> torch.cuda.Stream:
    s = _side_streams.get(device)
    if s is None:
        s = _side_streams[device] = torch.cuda.Stream(device)
    return s


class _Graph:
    """A captured ``fn(state, args) -> (state, outs)``: static state and
    argument buffers, the block's result copied back into the state
    buffers, ``outs`` in static output tensors."""

    def __init__(self, fn, warmup, state, args, iters: int):
        self.fn, self.iters = fn, iters      # fn keeps its closure alive
        with annotate("device_loop.capture"):
            self._capture(warmup, state, args)

    def _capture(self, warmup, state, args) -> None:
        """The warm-up on the loop's own stream, then the capture."""
        fn = self.fn
        device = state[0].device
        current = torch.cuda.current_stream(device)
        self.state = [t.clone() for t in state]
        self.args = [t.clone() for t in args]
        side = _side_stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            before = _counts()
            (warmup or fn)(tuple(self.state), tuple(self.args))
            _tally(stats.eager_launches, _delta(_counts(), before))
        current.wait_stream(side)
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        before = _counts()
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.cuda.stream(side):
                self.graph.capture_begin()
                try:
                    new, self.outs = fn(tuple(self.state), tuple(self.args))
                    # a buffer the block returns as itself was written in
                    # place (the held fields): nothing to copy back
                    ins = {t.data_ptr() for t in self.state + self.args}
                    new = [n if n is buf else
                           n.clone() if n.data_ptr() in ins else n
                           for buf, n in zip(self.state, new)]
                    for buf, n in zip(self.state, new):
                        if n is not buf:
                            buf.copy_(n)
                finally:
                    self.graph.capture_end()
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of a solver loop failed "
                               f"(no host fallback): {e}") from e
        finally:
            torch.cuda.set_sync_debug_mode(mode)
            self.launches = _delta(_counts(), before)
            _shift_counts(self.launches, -1)          # nothing ran
        current.wait_stream(side)
        stats.captures += 1
        stats.capture_ms += 1e3 * (time.perf_counter() - t0)

    def load(self, state, args) -> None:
        for buf, t in zip(self.state + self.args, (*state, *args)):
            buf.copy_(t)

    def replay(self):
        self.graph.replay()
        _shift_counts(self.launches)
        _tally(stats.graph_launches, self.launches)
        _tally(stats.kernel_slots, dict.fromkeys(self.launches, self.iters))
        stats.replays += 1
        stats.slots += self.iters
        return self.outs

    def result(self, take=None) -> tuple:
        """Copies of the state buffers (``take``: of those at these
        indices)."""
        ts = self.state if take is None else [self.state[i] for i in take]
        return tuple(t.clone() for t in ts)


class _Eager:
    """The same interface without a capture: each "replay" runs the block
    eagerly (the CPU form of the device loop)."""

    def __init__(self, fn, state, args, iters: int):
        self.fn, self.iters = fn, iters
        self.load(state, args)

    def load(self, state, args) -> None:
        self.state, self.args = tuple(state), tuple(args)

    def replay(self):
        self.state, outs = self.fn(self.state, self.args)
        stats.replays += 1
        stats.slots += self.iters
        return outs

    def result(self, take=None) -> tuple:
        return (self.state if take is None else
                tuple(self.state[i] for i in take))


_cache: OrderedDict = OrderedDict()


def _check_tensors(ts) -> None:
    for t in ts:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"a device loop carries tensors only, got "
                            f"{type(t).__name__}")


def clear_cache() -> None:
    """Drop every cached graph (and the memory pools they pin)."""
    _cache.clear()


def runner(fn: Callable, state, args=(), *, key=None, iters: int = 1,
           warmup: Callable | None = None, bound=()):
    """A runner of the block ``fn(state, args) -> (state, outs)`` loaded
    with ``state`` and ``args`` (tuples of tensors): ``replay()`` runs one
    block and returns ``outs``, ``result()`` gives the state.

    On cuda the block is a captured graph, cached under ``key`` and the
    shapes and dtypes of ``state`` and ``args`` (``key=None``: captured
    for this runner alone); on the CPU it runs eagerly.  ``iters``: the
    iterations one block offers (for ``stats.slots``); ``warmup``: the
    eager pre-capture call (default ``fn``); ``bound``: the tensors that
    ``fn`` closes over and a later solve with the same ``key`` brings anew
    (copied into the cached graph's own, which it read at capture)."""
    state, args, bound = tuple(state), tuple(args), tuple(bound)
    _check_tensors((*state, *args))
    device = state[0].device
    if device.type != "cuda":
        return _Eager(fn, state, args, iters)
    if key is None:
        return _loaded(_Graph(fn, warmup, state, args, iters), state, args)
    full = (key, iters, device, tuple((tuple(t.shape), t.dtype)
                                      for t in (*state, *args, *bound)))
    g = _cache.get(full)
    if g is None:
        g = _Graph(fn, warmup, state, args, iters)
        g.bound = bound
        _cache[full] = g
        while len(_cache) > CACHE_SIZE:
            _cache.popitem(last=False)
    else:
        _cache.move_to_end(full)
        for mine, new in zip(g.bound, bound):
            if mine is not new:
                mine.copy_(new)
    return _loaded(g, state, args)


def _loaded(g: _Graph, state, args) -> _Graph:
    g.load(state, args)
    return g


# ------------------------------------------------------------ loops

def _fields(state, flag: torch.Tensor) -> tuple:
    """The indices of ``state``'s fields: its tensors with more elements
    than the running ``flag`` (the rest, one element a pair, are its
    per-pair scalars)."""
    _check_tensors(state)
    pairs = flag.numel()
    for name, t in zip(type(state)._fields, state):
        if t.numel() < pairs:
            raise ValueError(f"{name} of shape {tuple(t.shape)} has fewer "
                             f"elements than the {pairs} pair(s) of the "
                             "running flag")
    return tuple(i for i, t in enumerate(state) if t.numel() > pairs)


def _block(step, running, n: int, cls, trace, fields):
    """The body of ``n`` iterations on ``(state, held)``: per-pair scalars
    selected, the ``fields`` (indices) carried unmasked and latched into
    ``held`` at each pair's stop.  ``outs`` is (still running,) plus, with
    ``trace``, the (n,) "ran" flags and the stacked records."""
    m = len(cls._fields)
    scalars = tuple(i for i in range(m) if i not in fields)

    def fn(s, a):
        s, held = cls(*s[:m]), tuple(s[m:])
        run = running(s, *a)
        ran, recs = [], []
        for _ in range(n):
            new = list(step(s, *a))
            kept = select(run, (new[i] for i in scalars),
                          (s[i] for i in scalars))
            for i, t in zip(scalars, kept):
                new[i] = t
            old, s = s, cls(*new)
            nxt = running(s, *a)
            if trace is not None:
                ran.append(run.any())
                recs.append(trace(old, s))
            held = loop_mask.latch_fields(run, nxt, [s[i] for i in fields],
                                          held)
            run = nxt
        outs = (run.any(),)
        if trace is not None:
            outs += (torch.stack(ran),
                     *(torch.stack(r) for r in zip(*recs)))
        return (*s, *held), outs
    return fn


def while_loop(step: Callable, running: Callable, state: NamedTuple,
               args=(), *, key=None, trace: Callable | None = None,
               show: Callable | None = None, bound=()) -> NamedTuple:
    """``state = step(state, *args)`` while ``running(state, *args)``, in
    blocks of ``BLOCK`` iterations with one flag read per block (and one
    before the first); each pair's result is its state at its own stop
    (see the module docstring).

    ``state``: a NamedTuple of tensors; ``running`` returns a 0-d flag or
    one flag per pair ((B,)), and reads only the per-pair scalars and
    ``args``, so that it stays false once they are frozen (the fields run
    on past the stop).  ``step`` must not write into its inputs.
    ``trace(old, new)`` returns a tuple of tensors recorded per iteration,
    ``new`` with its per-pair scalars selected; after each block
    ``show(*values)`` gets, for every iteration that ran (any pair
    running), its records as Python values: the host loop's per-iteration
    prints, in order.  ``key`` and ``bound`` as in :func:`runner`."""
    K = BLOCK
    cls = type(state)
    with annotate("device_loop.flag_read"):
        flag = running(state, *args)
        run = bool(flag.any())
    if not run:
        return state
    fields = _fields(state, flag)
    body = _block(step, running, K, cls, trace, fields)
    r = runner(body, (*state, *(state[i] for i in fields)), args,
               key=None if key is None else (key, trace is not None), iters=K,
               warmup=_block(step, running, 1, cls, trace, fields),
               bound=bound)
    while True:
        with annotate("device_loop.launch"):
            outs = r.replay()
        if fields:
            stats.latch_slots += K
            _trace.count("device_loop.latch_slots", K)
        with annotate("device_loop.flag_read"):
            if trace is not None:
                ran = outs[1].tolist()
                recs = [t.tolist() for t in outs[2:]]
                for i, flag in enumerate(ran):
                    if flag:
                        show(*(rec[i] for rec in recs))
            run = bool(outs[0])
        if not run:
            _tally(stats.kernel_spare,
                   dict.fromkeys(getattr(r, "launches", ()), K - 1))
            m = len(cls._fields)
            held = {i: m + j for j, i in enumerate(fields)}
            return cls(*r.result([held.get(i, i) for i in range(m)]))


def fori_loop(step: Callable, state: NamedTuple, n: int, args=(), *,
              key=None) -> NamedTuple:
    """``n`` iterations of ``state = step(state, *args)`` with no select
    and no read: replays of a block of ``BLOCK`` iterations, then one of
    the remainder (the counterpart of ``lax.fori_loop``)."""
    K = BLOCK
    cls = type(state)

    def body(m):
        def fn(s, a):
            s = cls(*s)
            for _ in range(m):
                s = step(s, *a)
            return tuple(s), ()
        return fn

    full, rest = divmod(n, K)
    if full:
        r = runner(body(K), state, args, key=key, iters=K, warmup=body(1))
        for _ in range(full):
            with annotate("device_loop.launch"):
                r.replay()
        state = cls(*r.result())
    if rest:
        r = runner(body(rest), state, args, key=key, iters=rest,
                   warmup=body(1))
        with annotate("device_loop.launch"):
            r.replay()
        state = cls(*r.result())
    return state
