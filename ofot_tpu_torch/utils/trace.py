"""Tracing, profiling and structured logging helpers.

Counterpart of ``ofot_tpu.utils.trace``, with the port's own spans and
counters:

  * ``annotate(name)``: a span.  Off by default: it then returns one
    shared no-op context manager, and costs a flag check (0.2 us for the
    ``with`` statement on the H100 machine's host).  After
    ``enable(True)`` each span records its name, its start and end on
    ``time.perf_counter_ns()``, its own index, its parent's index (-1 for
    a root, a span opened with no span open around it) and a request id,
    the index of its root, shared by every span under that root: 0.9 us
    a span there, 1.6 us a root or its child (which also checks for the
    profiler).  Records go into a ring of ``RING`` entries that drops its
    oldest and counts the drops.  Spans nest on one host thread.
  * Clock anchors: while spans are on and ``torch.profiler`` runs, a root
    span and its direct children also enter ``record_function`` and take
    their start inside it, so each is an event of the profiler's trace and
    the offset of its start there against its recorded start maps the
    recorded spans onto the trace's clock.  Deeper spans (one a replay of
    the device loop) never enter it: at about 15 us each they would widen
    the idle gaps the trace measures.
  * ``count(name, n)``: a process-wide integer (``counts()``), as
    ``ops.kernels.launch_counts()`` keeps one a kernel; while spans are on
    each count is also a timestamped event of the ring.
  * ``profile(dir)``: a ``torch.profiler`` window (CPU activity, plus CUDA
    activity where there is a card), spans on, that writes a
    Chrome/TensorBoard trace file (``*.pt.trace.json``) into ``dir`` when
    it closes;
  * ``JsonlLogger``: the append-only structured event log of the CLI's
    ``--log-jsonl``, one JSON object ``{"ts", "event", **fields}`` a line.

The solvers open these spans (at layer boundaries, never inside a block
the device loop captures, which would run once at capture):
``foto.solve`` > ``alg2.loop``, ``foto.extract``; ``wfr.solve`` >
``alg2.loop``, ``wfr.extract``; ``gn.solve`` >
``gn.setup``, ``cg.loop``; ``sinkhorn.solve`` > ``sinkhorn.loop`` (one a
stage), ``sinkhorn.verify``, ``sinkhorn.extract``; ``sweep.batch`` >
``lockstep.loop``, ``lockstep.extract``; inside the loops
``device_loop.capture``, ``device_loop.launch`` (a replay) and
``device_loop.flag_read`` (a host read of the running flag).  Counters:
``dct.builds`` (a ``dct.SeparableDCT`` built: host matrices and their
upload); ``sinkhorn.iterations``, ``sinkhorn.exact_iterations`` and
``sinkhorn.escalations`` (``solvers/sinkhorn.py``).
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import deque
from typing import NamedTuple

import torch

RING = 1 << 18


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    index: int
    parent: int         # -1 for a root
    request: int        # the index of its root


class Event(NamedTuple):
    name: str
    t_ns: int
    n: int
    request: int        # of the span open around it, -1 for none


class Recorded(NamedTuple):
    spans: list
    events: list
    dropped: int        # records the full ring let go, oldest first


_on = False
_ring: deque = deque(maxlen=RING)
_written = 0            # records ever put into the ring
_next = 0               # index of the next span
_open: list = []        # the spans open now, innermost last
_counts: dict = {}


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "start", "index", "parent", "request", "rf")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        global _next
        self.index = _next
        _next += 1
        if _open:
            outer = _open[-1]
            self.parent, self.request = outer.index, outer.request
        else:
            self.parent, self.request = -1, self.index
        self.rf = None
        if len(_open) < 2 and torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        _open.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _written
        end = time.perf_counter_ns()
        _open.pop()
        _ring.append((self.name, self.start, end, self.index, self.parent,
                      self.request))
        _written += 1
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def annotate(name: str):
    """A span named ``name`` (a no-op while spans are off)."""
    return _Span(name) if _on else _NOOP


def enable(on: bool) -> None:
    """Turn the recording of spans and counter events on or off."""
    global _on
    _on = bool(on)


def clear(capacity: int = RING) -> None:
    """Empty the ring (and its count of drops), giving it ``capacity``
    entries."""
    global _ring, _written
    _ring = deque(maxlen=capacity)
    _written = 0


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (and, while spans are on, record
    the event)."""
    global _written
    _counts[name] = _counts.get(name, 0) + n
    if _on:
        _ring.append((name, time.perf_counter_ns(), n,
                      _open[-1].request if _open else -1))
        _written += 1


def counts() -> dict:
    """Every counter of this process, by name."""
    return dict(_counts)


def spans() -> Recorded:
    """What the ring holds: spans (in the order they ended) and counter
    events, and how many older records it dropped."""
    recs = list(_ring)      # plain tuples: a span has 6 fields, an event 4
    return Recorded([Span(*r) for r in recs if len(r) == 6],
                    [Event(*r) for r in recs if len(r) == 4],
                    _written - len(recs))


@contextlib.contextmanager
def profile(trace_dir: str | None):
    """Profile the block into ``trace_dir`` (a no-op when it is empty),
    with the card's activity where torch sees a card, and spans on."""
    if not trace_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile as _profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    was = _on
    enable(True)
    try:
        with _profile(activities=activities,
                      on_trace_ready=tensorboard_trace_handler(trace_dir)):
            yield
    finally:
        enable(was)


class JsonlLogger:
    """Append structured events to a JSONL file (no-op when path is None)."""

    def __init__(self, path: str | None):
        self.path = path

    def log(self, event: str, **fields) -> None:
        if not self.path:
            return
        rec = {"ts": time.time(), "event": event, **fields}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
