"""The span metrics and the idle gaps by program span
(``flowbench/spans.py``), on records and traces made by hand, and a CPU
run of a cell with the program's spans on (``flowbench/spanrun.py``)."""

import time

import pytest

from flowbench import harness, spanrun, spans, trace
from ofot_tpu_torch.utils import trace as program_trace
from ofot_tpu_torch.utils.trace import Event, Recorded, Span

ROOT = harness.HERE.parent
MS = 1_000_000              # ns


def _record(algo, iters, batch=1, start=100.0, wall=0.01):
    """Calls of ``wall`` seconds back to back from ``start``; ``iters``
    per call: one count a pair."""
    key = "iters" if algo == "foto" else "steps"
    calls, t = [], start
    for counts in iters:
        calls.append({"start": t, "end": t + wall, "pairs": batch,
                      "counters": [{key: n} for n in counts]})
        t += wall
    return {"calls": calls, "config": {"algo": algo},
            "traffic": {"batch": batch}}


def _call_spans(rec, root, loop, loop_ms, launches=(), builds=0):
    """Per call: ``root`` over the call's wall but its last ms, ``loop``
    of ``loop_ms`` inside it with ``launches`` (ms each) in it, and
    ``builds`` dct.builds events."""
    out, events, i = [], [], 0
    for call in rec["calls"]:
        t0 = int(call["start"] * 1e9)
        r = Span(root, t0, int(call["end"] * 1e9) - MS, i, -1, i)
        lp = Span(loop, t0 + MS, t0 + MS + int(loop_ms * MS), i + 1, i, i)
        t = lp.start_ns
        for j, ms in enumerate(launches):
            out.append(Span("device_loop.launch", t, t + int(ms * MS),
                            i + 2 + j, lp.index, i))
            t += int(ms * MS)
        out += [lp, r]
        events += [Event("dct.builds", t0 + 1, 1, i)] * builds
        i += 2 + len(launches)
    return out, events


def _ring(monkeypatch, spans_, events=(), dropped=0):
    monkeypatch.setattr(spans, "recorded",
                        lambda: Recorded(list(spans_), list(events), dropped))


FOTO = dict(algo="foto", iters=[[100], [300]])
GN = dict(algo="gn", iters=[[150], [50]])
LOCK = dict(algo="foto", iters=[[100, 200], [50, 100]], batch=2)


@pytest.mark.parametrize("name, rec, loop, want", [
    ("alg2.loop_ms_per_iter", FOTO, "alg2.loop", 2 * 6.0 / 400),
    ("lockstep.loop_ms_per_iter", LOCK, "lockstep.loop", 2 * 6.0 / 300),
    ("cg.loop_ms_per_step", GN, "cg.loop", 2 * 6.0 / 200),
    ("outside_loop_pct", FOTO, "alg2.loop", 40.0),
    ("outside_loop_pct", LOCK, "lockstep.loop", 40.0),
    ("gn.outside_loop_pct", GN, "cg.loop", 40.0),
    ("device_loop.launch_ms_per_block", FOTO, "alg2.loop", 1.5),
    ("device_loop.launch_ms_per_block.gn", GN, "cg.loop", 1.5),
    ("dct.builds_per_pair", LOCK, "lockstep.loop", 0.5),
    ("gn.dct_builds_per_pair", GN, "cg.loop", 1.0),
])
def test_each_span_metric_reads_its_window(monkeypatch, name, rec, loop,
                                           want):
    rec = _record(**rec)
    made, events = _call_spans(rec, "x.solve", loop, 6.0,
                               launches=(1.0, 2.0), builds=1)
    # spans of the set-up and of the traced sub-window lie outside
    early = Span(loop, 1, 2 * MS, 900, -1, 900)
    late = Span(loop, int(200e9), int(201e9), 901, -1, 901)
    _ring(monkeypatch, [early, *made, late],
          [Event("dct.builds", 5, 7, -1), *events])
    assert spans.READERS[name](rec) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(spans.READERS))
def test_no_reading_without_spans_or_after_drops(monkeypatch, name):
    cell = {m["name"]: m for m in spans.METRICS}[name]["workloads"][0]
    rec = _record(**(GN if cell.startswith("gn") else LOCK if "lockstep"
                     in cell else FOTO))
    _ring(monkeypatch, [])
    assert spans.READERS[name](rec) is None
    loop = "cg.loop" if cell.startswith("gn") else "alg2.loop"
    made, events = _call_spans(rec, "x.solve", loop, 6.0, launches=(1.0,),
                               builds=1)
    _ring(monkeypatch, made, events, dropped=1)
    assert spans.READERS[name](rec) is None


def test_every_span_metric_has_a_reader_and_keeps_to_the_contract():
    import json
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"] for w in bench["workloads"]}
    ends = {m["name"]: m for m in bench["end_to_end"]}
    layers = {m["layer"] for m in bench["per_layer"]}
    assert {m["name"] for m in spans.METRICS} == set(spans.READERS)
    for m in spans.METRICS:
        assert set(m["workloads"]) <= cells
        assert m["moves"] in ends
        assert set(m["workloads"]) <= set(ends[m["moves"]]["workloads"])
        assert m["name"] not in {p["name"] for p in bench["per_layer"]}
    assert {m["layer"] for m in spans.METRICS} - layers == {
        spans._ENTRIES, spans._DCT}


def _event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


BASE_NS = 5_000_000         # the trace's clock less the spans' clock


def _traced(jitter_us=(0.0, 0.0, 0.0)):
    """A sub-window of 100 us: kernels at 10-30, 40-50 and 80-90; a root
    span over 6-94 with a loop over 8-60 and one launch over 31-39 in it,
    the root and loop as trace anchors (one jittered by ``jitter_us``)."""
    device = [_event("user_annotation", trace.SPAN, 0.0, 100.0),
              _event("kernel", "a", 10.0, 20.0),
              _event("kernel", "b", 40.0, 10.0),
              _event("kernel", "c", 80.0, 10.0),
              _event("cuda_runtime", "cudaGraphLaunch", 31.0, 8.0),
              _event("cpu_op", "aten::copy_", 60.0, 25.0)]
    ns = [Span("foto.solve", 6000, 94000, 0, -1, 0),
          Span("alg2.loop", 8000, 60000, 1, 0, 0),
          Span("device_loop.launch", 31000, 39000, 2, 1, 0)]
    ns = [s._replace(start_ns=s.start_ns - BASE_NS,
                     end_ns=s.end_ns - BASE_NS) for s in ns]
    marks = [_event("user_annotation", s.name,
                    (s.start_ns + BASE_NS) * 1e-3 + j,
                    (s.end_ns - s.start_ns) * 1e-3)
             for s, j in zip(ns[:2], jitter_us)]
    return device, marks, ns


def test_program_spans_leave_the_gaps_as_they_were_and_name_the_idle():
    device, marks, ns = _traced()
    plain = trace.reduce(device)
    rec = spans.reduce(device + marks, ns)
    assert rec["gaps"] == plain["gaps"]
    assert {k: rec[k] for k in plain} == plain
    idle = sum(s for _, s in plain["gaps"])
    assert rec["idle_s"] == pytest.approx(idle)
    assert sum(s for _, s in rec["idle_by_span"]) == pytest.approx(idle)
    # by each gap's midpoint: 0-10 and 90-100 outside the root, 30-40 in
    # the launch, 50-80 in the root once the loop has ended (at 60)
    assert dict(rec["idle_by_span"]) == pytest.approx({
        "device_loop.launch": 10e-6, "foto.solve": 30e-6,
        spans.OUTSIDE: 20e-6})
    assert rec["anchors"]["n"] == 2
    assert rec["anchors"]["offset_ns"] == pytest.approx(BASE_NS)
    assert rec["anchors"]["spread_us"] == pytest.approx(0.0)


def test_anchors_that_spread_leave_out_the_idle_by_span(capsys):
    device, marks, ns = _traced(jitter_us=(0.0, 60.0))
    rec = spans.reduce(device + marks, ns)
    assert "idle_by_span" not in rec
    assert rec["gaps"] == trace.reduce(device)["gaps"]
    assert "idle_by_span left out" in capsys.readouterr().err
    one = [m for m in marks if m["name"] == "foto.solve"]
    assert "idle_by_span" not in spans.reduce(device + one, ns)


def _cpu_run(monkeypatch, traced):
    cell = spanrun._cell_class(harness, spans)(ROOT, "foto_mb1_320")
    cell.traffic = dict(cell.traffic, width=32, height=24,
                        translation_scale=0.25)
    monkeypatch.setattr(trace, "reduce", trace.reduce)
    monkeypatch.setattr(trace, "breakdown", trace.breakdown)
    spanrun._with_spans(trace, spans, program_trace.spans)
    program_trace.clear()
    program_trace.enable(True)
    try:
        res, _ = harness.run(ROOT, "foto_mb1_320", 2 ** 31 + 9, 0.0, traced,
                             time.perf_counter(), device="cpu", cell=cell,
                             min_calls=3)
    finally:
        program_trace.enable(False)
    return res


def test_a_traced_cpu_run_with_spans_reports_the_span_metrics(monkeypatch):
    res = _cpu_run(monkeypatch, True)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    assert m["alg2.loop_ms_per_iter"]["value"] > 0
    assert 0 < m["outside_loop_pct"]["value"] < 100
    assert m["dct.builds_per_pair"]["value"] == 0.0     # one ops set
    assert "alg2.ms_per_iter" in m
    bd = res["breakdown"]
    assert bd["anchors"]["n"] >= 2 and "idle_by_span" in bd
    res = _cpu_run(monkeypatch, False)
    assert set(res["metrics"]) == {"pairs_per_s", "pair_p95_ms", "setup_s"}
    program_trace.clear()
