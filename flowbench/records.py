"""Arithmetic over a run's record that the metric readers share.

A record holds ``calls``: one entry per call of the window, with its host
``start`` and ``end`` (the call's start and its fields on the host), the
``pairs`` it solved and each pair's ``counters``; ``setup_s``;
``setup_loop``, the device loop's counters over set-up; ``profile``, the
reduced traced sub-window or None; the cell's ``config`` and ``traffic``;
and ``device_kind``, the card's name.
"""

from __future__ import annotations

import numpy as np


def window_s(rec) -> float:
    """From the first call's start to the last call's end."""
    calls = rec["calls"]
    return calls[-1]["end"] - calls[0]["start"]


def pairs(rec) -> int:
    return sum(c["pairs"] for c in rec["calls"])


def pairs_per_s(rec) -> float:
    """Pairs whose fields reached the host in the window, over the
    window's seconds (a batch of B counts B)."""
    return pairs(rec) / window_s(rec)


def pair_latencies_s(rec) -> list[float]:
    """Each pair's time from its call's start to its fields on the host."""
    return [c["end"] - c["start"] for c in rec["calls"]
            for _ in range(c["pairs"])]


def pair_p95_ms(rec) -> float:
    """The 95th percentile over every pair of the window of the time from
    its call's start to its fields on the host (ms)."""
    return 1e3 * percentile(pair_latencies_s(rec), 95)


def percentile(values, q: float) -> float:
    """The q-th percentile of every value, linearly interpolated."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def counter(rec, name: str) -> list[list[int]]:
    """Per call, each pair's counter ``name`` (empty if the cell's
    algorithm does not count it)."""
    return [[c[name] for c in call["counters"] if name in c]
            for call in rec["calls"]]


def single(rec) -> bool:
    return rec["traffic"]["batch"] == 1


def span_ms_per(rec, name: str):
    """Sum of the calls' walls over the sum of their counter ``name`` (ms),
    for cells of one pair a call that count it; else None."""
    counts = counter(rec, name)
    total = sum(sum(c) for c in counts)
    if not single(rec) or total == 0:
        return None
    return 1e3 * sum(c["end"] - c["start"] for c in rec["calls"]) / total


def mean_per_pair(rec, name: str):
    counts = [n for c in counter(rec, name) for n in c]
    if not single(rec) or not counts:
        return None
    return float(np.mean(counts))


def fused_pointwise_share(rec, pairs: int):
    """Kernel #1's share of its roofline in the traced sub-window (%): its
    least time over ``pairs`` pairs at the cell's shape (bytes-bound,
    relaxed, k = 2) over the mean device time of one launch, which is the
    mean recorded ``fused_pointwise_kernel`` plus the mean recorded
    ``reduce_partials_kernel``; None untraced."""
    from flowbench import roofline, trace
    prof = rec["profile"]
    if prof is None:
        return None
    n_main, s_main = trace.records(prof, trace.FUSED_KERNEL)
    n_red, s_red = trace.records(prof, trace.FUSED_REDUCE)
    if n_main == 0 or n_red == 0:
        return None
    t = rec["traffic"]
    points = rec["config"]["Nt"] * t["height"] * t["width"]
    nbytes, ops = roofline.fused_pointwise(points, pairs)
    least = roofline.bound_s(nbytes, ops, rec["device_kind"])
    return 100.0 * least / (s_main / n_main + s_red / n_red)


def idle_pct(rec):
    """100 x (1 - device busy / the traced sub-window), None untraced."""
    prof = rec["profile"]
    if prof is None:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
