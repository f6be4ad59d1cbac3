"""The traced sub-window: ``torch.profiler`` over a few calls of the cell,
its chrome trace written under ``TMPDIR`` and reduced to device busy time,
kernel records by name and idle gaps by what the host was doing.

The profiler can drop kernel records late in a long run (15 of 20 kernels
in some windows on an H100), so a sub-window is proved complete only
where, if the cell launches kernel #1, the recorded
``fused_pointwise_kernel`` records equal the launches the program counted
in the sub-window; otherwise (GN, which launches no counted kernel) where
two sub-windows over the same pairs record the same number of kernels.
Where no try proves complete, the fullest is kept (:func:`fullest`): a
traced run always reports its device's busy time and window.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
SPAN = "flowbench.subwindow"
SHORT_GAP_US = 5.0
FUSED_KERNEL = "fused_pointwise_kernel"
FUSED_REDUCE = "reduce_partials_kernel"


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def profile_calls(run, calls, launch_counts):
    """Run ``run(call)`` for each of ``calls`` under the profiler -> the
    reduced record of the sub-window (see :func:`reduce`), with the kernel
    launches the program counted in it."""
    from torch.profiler import ProfilerActivity, profile, record_function
    card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * card
    sync = torch.cuda.synchronize if card else (lambda: None)
    sync()
    before = launch_counts()
    with profile(activities=activities) as prof:
        with record_function(SPAN):
            t0 = time.perf_counter()
            for call in calls:
                run(call)
            sync()
            wall = time.perf_counter() - t0
    after = launch_counts()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="flowbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        rec = reduce(_events(path))
    finally:
        os.remove(path)
    rec["launches"] = {k: after[k] - before[k] for k in after}
    rec["host_wall_s"] = wall
    return rec


def _union(intervals):
    """Total length of the union of (start, end) intervals, and the gaps
    between them, sorted by start."""
    busy, gaps, cur = 0.0, [], None
    for s, e in sorted(intervals):
        if cur is None:
            cur = [s, e]
        elif s > cur[1]:
            busy += cur[1] - cur[0]
            gaps.append((cur[1], s))
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy, gaps


def _host_at(host, starts, max_dur, t):
    """Name of the shortest host event that covers time ``t``."""
    best = None
    i = bisect.bisect_right(starts, t)
    while i > 0:
        i -= 1
        s, e, name = host[i]
        if s < t - max_dur:
            break
        if e >= t and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return "host: nothing traced" if best is None else best[2]


def reduce(events):
    """Reduce chrome-trace events to ``window_s`` (the span of the
    sub-window), ``busy_s`` (the union of device activity inside it),
    ``kernels`` {name: [count, seconds]}, and ``gaps`` [[host activity,
    seconds]] (idle time summed by what the host was doing; gaps under
    5 us together)."""
    span = [e for e in events if e.get("name") == SPAN
            and e.get("cat") == "user_annotation"]
    if not span:
        raise RuntimeError("the profiler's trace has no sub-window span")
    w0 = float(span[0]["ts"])
    w1 = w0 + float(span[0]["dur"])
    device, host, kernels = [], [], {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            s, t = max(s, w0), min(s + d, w1)
            if t <= s:
                continue
            device.append((s, t))
            k = kernels.setdefault(e["name"], [0, 0.0])
            k[0] += 1
            k[1] += (t - s) * 1e-6
        elif e.get("cat") in HOST_CATS and e.get("name") != SPAN:
            host.append((s, s + d, e["name"]))
    busy, gaps = _union(device)
    if device:
        first = min(s for s, _ in device)
        last = max(t for _, t in device)
        gaps = [(w0, first)] + gaps + [(last, w1)]
    host.sort()
    starts = [h[0] for h in host]
    max_dur = max((h[1] - h[0] for h in host), default=0.0)
    by_host = {}
    for g0, g1 in gaps:
        if g1 <= g0:
            continue
        name = (f"short gaps (<{SHORT_GAP_US:g} us)"
                if g1 - g0 < SHORT_GAP_US
                else _host_at(host, starts, max_dur, 0.5 * (g0 + g1)))
        by_host[name] = by_host.get(name, 0.0) + (g1 - g0) * 1e-6
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy * 1e-6,
            "kernels": kernels,
            "gaps": sorted(([k, v] for k, v in by_host.items()),
                           key=lambda kv: -kv[1])}


def records(rec, needle: str):
    """(count, seconds) of the kernels whose name contains ``needle``."""
    n, s = 0, 0.0
    for name, (count, sec) in rec["kernels"].items():
        if needle in name:
            n += count
            s += sec
    return n, s


def total_records(rec) -> int:
    return sum(c for c, _ in rec["kernels"].values())


def missing(rec) -> int:
    """#1 launches counted in a sub-window that it holds no record of."""
    return (rec["launches"].get("fused_pointwise", 0)
            - records(rec, FUSED_KERNEL)[0])


def complete(rec, *twins) -> bool:
    """Whether a sub-window's records are complete: its #1 records equal
    the #1 launches counted, where it launched #1; else the same number of
    records as one of ``twins``, sub-windows over the same pairs."""
    if rec["launches"].get("fused_pointwise", 0):
        return missing(rec) == 0
    return any(total_records(rec) == total_records(t) for t in twins)


def fullest(recs):
    """Of sub-windows over the same pairs none of which proved complete,
    the one that lost the fewest #1 records, and of those the one with the
    most records (GN's: a few of some 70,000 differ between tries)."""
    return min(recs, key=lambda r: (missing(r), -total_records(r)))


def breakdown(rec, top: int = 10) -> dict:
    """The ``breakdown`` of a result line: the device operations that took
    most time, and the idle gaps by what the host was doing."""
    ops = sorted(([name[:160], sec] for name, (_, sec) in
                  rec["kernels"].items()), key=lambda kv: -kv[1])
    return {"device_ops": ops[:top], "idle_gaps": rec["gaps"][:top]}
