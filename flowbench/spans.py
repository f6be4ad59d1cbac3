"""The program's own spans and counters (``ofot_tpu_torch/utils/trace.py``)
read for the benchmark: nine per-layer metrics over a run's window, and
the traced sub-window's idle gaps named by the program span open at each.

The harness does not turn the program's spans on: ``flowbench/spanrun.py``
runs a cell with them on, and reports these metrics beside the cell's own
(``PERF.md`` §7 names the harness edit that would make them the
benchmark's).  ``METRICS`` holds their entries as ``BENCHMARK.json``'s
``per_layer`` would take them, ``READERS`` their readers, each of which
returns None where the ring recorded nothing in the window or dropped
records.

Clock: a span's start and end are ``time.perf_counter_ns()``, the clock of
the harness's call starts and ends.  In a profiler's trace the program's
root spans and their direct children are events of their own (anchors);
the median of their trace start less their recorded start maps every
recorded span onto the trace.
"""

from __future__ import annotations

import bisect
import statistics
import sys

from flowbench import records, trace

FOTO_CELLS = ["foto_mb1_320", "foto_mb1_320_lockstep8", "foto_mb1_640"]
GN_CELLS = ["gn_mb1_320"]
LOOP = {"foto": "alg2.loop", "gn": "cg.loop"}
MAX_SPREAD_US = 50.0
OUTSIDE = "outside any span"


def _entry(name, unit, source, layer, moves, cells):
    return {"name": name, "unit": unit, "better": "lower", "source": source,
            "layer": layer, "moves": moves, "workloads": cells}


_ALG2 = "ALG2 loop (solvers/foto.py)"
_LOCK = "lockstep batch (solvers/lockstep.py, parallel/sweep.py)"
_GN = "GN and CG (solvers/gn.py, solvers/cg.py)"
_ENTRIES = "solve entries (foto.solve, flow_extract, sweep.solve_batch_full)"
_LOOP = "device loop (solvers/device_loop.py)"
_DCT = "spectral transforms (solvers/dct.py)"
METRICS = [
    _entry("alg2.loop_ms_per_iter", "ms", "program_span", _ALG2,
           "pairs_per_s", ["foto_mb1_320", "foto_mb1_640"]),
    _entry("lockstep.loop_ms_per_iter", "ms", "program_span", _LOCK,
           "pairs_per_s", ["foto_mb1_320_lockstep8"]),
    _entry("cg.loop_ms_per_step", "ms", "program_span", _GN,
           "gn.pairs_per_s", GN_CELLS),
    _entry("outside_loop_pct", "%", "program_span", _ENTRIES,
           "pairs_per_s", FOTO_CELLS),
    _entry("gn.outside_loop_pct", "%", "program_span", _GN,
           "gn.pairs_per_s", GN_CELLS),
    _entry("device_loop.launch_ms_per_block", "ms", "program_span", _LOOP,
           "pairs_per_s", FOTO_CELLS),
    _entry("device_loop.launch_ms_per_block.gn", "ms", "program_span",
           _LOOP, "gn.pairs_per_s", GN_CELLS),
    _entry("dct.builds_per_pair", "builds", "program_counter", _DCT,
           "pairs_per_s", FOTO_CELLS),
    _entry("gn.dct_builds_per_pair", "builds", "program_counter", _DCT,
           "gn.pairs_per_s", GN_CELLS),
]


def recorded():
    """What the program's ring holds now (spans, events, dropped)."""
    from ofot_tpu_torch.utils import trace as program_trace
    return program_trace.spans()


def window(rec):
    """The program's spans and counter events inside the run's window
    ``[calls[0].start, calls[-1].end]`` on the harness's clock, as
    ``(spans, events)``; None where the ring dropped records or holds no
    span there."""
    got = recorded()
    if got.dropped or not rec["calls"]:
        return None
    t0 = rec["calls"][0]["start"] * 1e9
    t1 = rec["calls"][-1]["end"] * 1e9
    spans = [s for s in got.spans if s.start_ns >= t0 and s.end_ns <= t1]
    if not spans:
        return None
    return spans, [e for e in got.events if t0 <= e.t_ns <= t1]


def _seconds(spans, name):
    durs = [(s.end_ns - s.start_ns) * 1e-9 for s in spans if s.name == name]
    return sum(durs), len(durs)


def _walls(rec) -> float:
    return sum(c["end"] - c["start"] for c in rec["calls"])


def _algo(rec) -> str:
    return rec["config"]["algo"]


def _loop_ms_per(rec, algo: str, batch: bool):
    """Sum of the loop's spans over the sum of its iterations (each
    batch's largest count) in cells of ``algo``, one pair or a batch a
    call (ms)."""
    got = window(rec)
    if got is None or _algo(rec) != algo or records.single(rec) == batch:
        return None
    name = "lockstep.loop" if batch else LOOP[algo]
    secs, n = _seconds(got[0], name)
    counts = records.counter(rec, "iters" if algo == "foto" else "steps")
    total = sum(max(c) if batch else sum(c) for c in counts if c)
    return 1e3 * secs / total if n and total else None


def _outside_pct(rec, algo: str):
    """100 x (the calls' walls - the loop spans) / the calls' walls."""
    got = window(rec)
    if got is None or _algo(rec) != algo:
        return None
    name = LOOP[algo] if records.single(rec) else "lockstep.loop"
    secs, n = _seconds(got[0], name)
    walls = _walls(rec)
    return 100.0 * (walls - secs) / walls if n else None


def _launch_ms(rec, algo: str):
    """The mean ``device_loop.launch`` span (one replay of a block)."""
    got = window(rec)
    if got is None or _algo(rec) != algo:
        return None
    secs, n = _seconds(got[0], "device_loop.launch")
    return 1e3 * secs / n if n else None


def _builds_per_pair(rec, algo: str):
    """``dct.builds`` counted in the window over its pairs."""
    got = window(rec)
    if got is None or _algo(rec) != algo:
        return None
    return (sum(e.n for e in got[1] if e.name == "dct.builds")
            / records.pairs(rec))


READERS = {
    "alg2.loop_ms_per_iter": lambda r: _loop_ms_per(r, "foto", False),
    "lockstep.loop_ms_per_iter": lambda r: _loop_ms_per(r, "foto", True),
    "cg.loop_ms_per_step": lambda r: _loop_ms_per(r, "gn", False),
    "outside_loop_pct": lambda r: _outside_pct(r, "foto"),
    "gn.outside_loop_pct": lambda r: _outside_pct(r, "gn"),
    "device_loop.launch_ms_per_block": lambda r: _launch_ms(r, "foto"),
    "device_loop.launch_ms_per_block.gn": lambda r: _launch_ms(r, "gn"),
    "dct.builds_per_pair": lambda r: _builds_per_pair(r, "foto"),
    "gn.dct_builds_per_pair": lambda r: _builds_per_pair(r, "gn"),
}


# ------------------------------------------------------------ the trace

def _marks(events, names):
    """The trace's events of the program's spans (anchors), by start."""
    return sorted((float(e["ts"]), e["name"]) for e in events
                  if e.get("cat") == "user_annotation"
                  and e.get("name") in names and e.get("ph") == "X")


def _anchor_spans(spans):
    """The recorded roots and their direct children, by start."""
    by_index = {s.index: s for s in spans}
    out = [s for s in spans if s.parent == -1 or (
        s.parent in by_index and by_index[s.parent].parent == -1)]
    return sorted(out, key=lambda s: s.start_ns)


def offset(events, spans):
    """(median offset in ns of the trace's clock less the spans' clock,
    spread of the anchors' offsets in us, anchors) for the anchors of the
    trace: the last recorded roots and children, matched in order by
    name; None where they do not match."""
    marks = _marks(events, {s.name for s in spans})
    anchors = _anchor_spans(spans)[-len(marks):] if marks else []
    if not marks or [a.name for a in anchors] != [m[1] for m in marks]:
        return None
    offs = [ts * 1e3 - a.start_ns for (ts, _), a in zip(marks, anchors)]
    return statistics.median(offs), (max(offs) - min(offs)) * 1e-3, \
        len(offs)


def _gaps(events):
    """The sub-window's idle gaps (trace us), as ``trace.reduce`` finds
    them: between the union of device activity and the window's edges."""
    span = [e for e in events if e.get("name") == trace.SPAN
            and e.get("cat") == "user_annotation"]
    w0 = float(span[0]["ts"])
    w1 = w0 + float(span[0]["dur"])
    device = []
    for e in events:
        if e.get("ph") == "X" and "dur" in e \
                and e.get("cat") in trace.DEVICE_CATS:
            s = max(float(e["ts"]), w0)
            t = min(float(e["ts"]) + float(e["dur"]), w1)
            if t > s:
                device.append((s, t))
    _, gaps = trace._union(device)
    if device:
        gaps = ([(w0, min(s for s, _ in device))] + gaps
                + [(max(t for _, t in device), w1)])
    return [(g0, g1) for g0, g1 in gaps if g1 > g0], (w0, w1)


def idle_by_span(events, spans, top: int = 10):
    """Idle seconds of the sub-window summed by the innermost program
    span open at each gap's midpoint (or ``OUTSIDE``), the top ``top``,
    with the anchors' offset and spread; None (and a line on standard
    error) where fewer than two anchors match or they spread more than
    ``MAX_SPREAD_US``."""
    found = offset(events, spans)
    if found is None or found[2] < 2 or found[1] > MAX_SPREAD_US:
        print(f"flowbench: idle_by_span left out: anchors {found}",
              file=sys.stderr)
        return None
    off, spread, n = found
    gaps, (w0, w1) = _gaps(events)
    lo, hi = w0 * 1e3 - off, w1 * 1e3 - off
    inside = sorted((s for s in spans if s.end_ns >= lo and s.start_ns <= hi),
                    key=lambda s: s.start_ns)
    starts = [s.start_ns for s in inside]
    by = {}
    for g0, g1 in gaps:
        t = 0.5 * (g0 + g1) * 1e3 - off
        name, i = OUTSIDE, bisect.bisect_right(starts, t)
        while i:                     # the latest start that covers t
            i -= 1
            if inside[i].end_ns >= t:
                name = inside[i].name
                break
        by[name] = by.get(name, 0.0) + (g1 - g0) * 1e-6
    ranked = sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])
    return {"idle_by_span": ranked[:top], "idle_s": sum(by.values()),
            "anchors": {"n": n, "spread_us": spread, "offset_ns": off}}


def reduce(events, spans, plain=trace.reduce):
    """``plain`` (``trace.reduce``) of the trace with the program's anchors
    left out (so its gaps read as in a trace without them), with
    :func:`idle_by_span`'s keys where the anchors allow."""
    names = {s.name for s in spans}
    rec = plain([e for e in events if not (
        e.get("cat") == "user_annotation" and e.get("name") in names)])
    rec.update(idle_by_span(events, spans) or {})
    return rec
