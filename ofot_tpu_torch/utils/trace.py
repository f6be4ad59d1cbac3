"""Tracing, profiling and structured logging helpers.

Counterpart of ``ofot_tpu.utils.trace``:

  * ``profile(dir)``: a ``torch.profiler`` window (CPU activity, plus CUDA
    activity where there is a card) that writes a Chrome/TensorBoard trace
    file (``*.pt.trace.json``) into ``dir`` when it closes;
  * ``annotate(name)``: a ``torch.profiler.record_function`` range for
    marking solver phases on the timeline;
  * ``JsonlLogger``: the append-only structured event log of the CLI's
    ``--log-jsonl``, one JSON object ``{"ts", "event", **fields}`` a line.
"""

from __future__ import annotations

import contextlib
import json
import time

import torch


@contextlib.contextmanager
def profile(trace_dir: str | None):
    """Profile the block into ``trace_dir`` (a no-op when it is empty),
    with the card's activity where torch sees a card."""
    if not trace_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile as _profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with _profile(activities=activities,
                  on_trace_ready=tensorboard_trace_handler(trace_dir)):
        yield


def annotate(name: str):
    return torch.profiler.record_function(name)


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
