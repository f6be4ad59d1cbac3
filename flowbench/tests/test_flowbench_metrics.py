"""The metric readers and the trace reduction, on records made by hand."""

import numpy as np
import pytest

from flowbench import harness, records, roofline, trace

ROOT = harness.HERE.parent


def _record(latencies, batch=1, iters=None, profile=None):
    calls, t = [], 100.0
    for i, lat in enumerate(latencies):
        counters = [{"iters": (iters or [10] * len(latencies))[i]}] * batch
        calls.append({"start": t, "end": t + lat, "pairs": batch,
                      "counters": counters})
        t += lat
    return {"calls": calls, "setup_s": 12.5, "profile": profile,
            "setup_loop": {"capture_ms": 42.0},
            "traffic": {"batch": batch, "width": 320, "height": 240},
            "config": {"Nt": 16}, "device_kind": "NVIDIA H100 80GB HBM3"}


def _read(name, rec):
    cell = harness.Cell(ROOT, "foto_mb1_320")
    return cell.reader(name).read(rec)


def test_rate_and_tail_are_taken_over_every_pair():
    # one slow pair among 99 quick ones: a mean of chunk percentiles or a
    # rate per chunk would read otherwise
    lat = [0.1] * 99 + [2.0]
    rec = _record(lat)
    assert _read("pairs_per_s", rec) == pytest.approx(100 / sum(lat))
    assert _read("pair_p95_ms", rec) == pytest.approx(
        1e3 * np.percentile(lat, 95))
    rec = _record([0.05] * 94 + [1.0] * 6)
    assert _read("pair_p95_ms", rec) == pytest.approx(1000.0)


def test_a_batch_counts_its_pairs():
    rec = _record([1.0, 1.0], batch=8, iters=[100, 200])
    assert _read("pairs_per_s", rec) == pytest.approx(8.0)
    assert _read("lockstep.ms_per_iter", rec) == pytest.approx(
        2000.0 / 300)
    assert _read("lockstep.useful_pct", rec) == pytest.approx(100.0)
    assert _read("alg2.ms_per_iter", rec) is None


def test_useful_share_of_a_lockstep_batch():
    rec = _record([1.0], batch=2)
    rec["calls"][0]["counters"] = [{"iters": 50}, {"iters": 200}]
    assert _read("lockstep.useful_pct", rec) == pytest.approx(62.5)


def test_span_metrics_of_single_pairs():
    rec = _record([0.1, 0.3], iters=[100, 300])
    assert _read("alg2.ms_per_iter", rec) == pytest.approx(1.0)
    assert _read("alg2.iters_per_pair", rec) == pytest.approx(200.0)
    assert _read("cg.ms_per_step", rec) is None
    assert _read("setup_s", rec) == 12.5
    assert _read("device_loop.capture_ms", rec) == 42.0


def test_fused_pointwise_bytes_from_the_shapes():
    points = 16 * 240 * 320
    nbytes, ops = roofline.fused_pointwise(points)
    # grad phi, mu and q_prev read, q and mu written: 5 fields of 3 planes
    assert nbytes == 5 * 3 * points * 4
    assert roofline.fused_pointwise(points, pairs=8)[0] == 8 * nbytes
    assert roofline.fused_pointwise(points, relaxed=False)[0] == \
        4 * 3 * points * 4
    assert ops == (9 + 6 + 4 + 2 + 20) * points
    kind = "NVIDIA H100 80GB HBM3"
    assert roofline.bound_s(nbytes, ops, kind) == pytest.approx(
        nbytes / 3.35e12)


def _profile(main_us, reduce_us, n=4):
    kernels = {"fused_pointwise_kernel(float const*)": [n, n * main_us * 1e-6],
               "reduce_partials_kernel(float const*)":
                   [n, n * reduce_us * 1e-6],
               "ampere_sgemm": [3, 1e-4]}
    return {"kernels": kernels, "busy_s": 0.6, "window_s": 1.0,
            "launches": {"fused_pointwise": n}, "gaps": []}


def test_roofline_share_of_one_launch():
    nbytes, ops = roofline.fused_pointwise(16 * 240 * 320)
    least = roofline.bound_s(nbytes, ops, "NVIDIA H100 80GB HBM3")
    rec = _record([0.1], profile=_profile(30.0, 4.0))
    assert _read("fused_pointwise_roofline", rec) == pytest.approx(
        100 * least / 34e-6)
    assert _read("fused_pointwise_batched_roofline", rec) is None
    rec = _record([0.1], batch=8, profile=_profile(200.0, 10.0))
    assert _read("fused_pointwise_batched_roofline", rec) == pytest.approx(
        100 * 8 * least / 210e-6)
    assert _read("device.idle_pct", rec) == pytest.approx(40.0)
    assert _read("fused_pointwise_roofline", _record([0.1])) is None


def _event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_reduction():
    events = [
        _event("user_annotation", trace.SPAN, 0.0, 100.0),
        _event("kernel", "a", 10.0, 20.0),
        _event("kernel", "b", 25.0, 10.0),     # overlaps a
        _event("gpu_memcpy", "copy", 50.0, 10.0),
        _event("kernel", "a", 62.0, 2.0),      # a 2 us gap before it
        _event("cuda_runtime", "cudaGraphLaunch", 35.0, 14.0),
        _event("cpu_op", "aten::copy_", 64.0, 36.0),
        _event("kernel", "late", 150.0, 5.0),  # outside the window
    ]
    rec = trace.reduce(events)
    assert rec["window_s"] == pytest.approx(100e-6)
    assert rec["busy_s"] == pytest.approx(37e-6)
    assert rec["kernels"]["a"] == [2, pytest.approx(22e-6)]
    assert "late" not in rec["kernels"]
    gaps = dict(rec["gaps"])
    assert gaps["cudaGraphLaunch"] == pytest.approx(15e-6)
    assert gaps["aten::copy_"] == pytest.approx(36e-6)
    assert gaps["short gaps (<5 us)"] == pytest.approx(2e-6)
    assert gaps["host: nothing traced"] == pytest.approx(10e-6)
    bd = trace.breakdown(rec)
    assert bd["device_ops"][0][0] == "a"


def test_a_sub_window_that_lost_kernel_records_does_not_count():
    rec = _profile(30.0, 4.0, n=4)
    assert trace.complete(rec)
    rec["launches"]["fused_pointwise"] = 5
    assert not trace.complete(rec)
    gn = {"kernels": {"k": [10, 1.0]}, "launches": {"fused_pointwise": 0}}
    assert not trace.complete(gn)
    assert trace.complete(gn, {"kernels": {"k": [10, 0.5]}})
    assert not trace.complete(gn, {"kernels": {"k": [9, 0.5]}})


def test_the_fullest_sub_window_is_kept_where_none_proves_complete():
    gn = [{"kernels": {"k": [n, 1.0]}, "launches": {"fused_pointwise": 0}}
          for n in (73017, 72964, 73016)]
    assert not any(trace.complete(r, *gn[:i]) for i, r in enumerate(gn))
    assert trace.complete({"kernels": {"k": [72964, 1.0]},
                           "launches": {}}, *gn)
    assert trace.fullest(gn) is gn[0]
    foto = [_profile(30.0, 4.0, n=4) for _ in range(3)]
    for rec, launched in zip(foto, (7, 5, 6)):
        rec["launches"]["fused_pointwise"] = launched
    assert [trace.missing(r) for r in foto] == [3, 1, 2]
    assert trace.fullest(foto) is foto[1]


def test_window_helpers():
    rec = _record([0.5, 0.25, 0.25])
    assert records.window_s(rec) == pytest.approx(1.0)
    assert records.pairs(rec) == 3


def test_stop_miss_reads_the_stopping_rule():
    from flowbench.reference.foto import stop_miss
    crits = [0.5, 0.3, 0.02, 0.019995, 0.009]
    assert stop_miss(crits, 4, 0.01, 200) == 0.0          # stalled
    assert stop_miss(crits, 5, 0.01, 200) == 0.0          # under tol
    assert stop_miss(crits, 200, 0.01, 200) == 0.0        # max_it
    assert stop_miss(crits, 2, 0.01, 200) == pytest.approx(0.2 - 1e-5)
    assert stop_miss(crits, 3, 0.01, 200) == pytest.approx(0.01)
    # after one iteration only the tolerance can stop it; 0 reads as 1
    assert stop_miss(crits, 1, 0.01, 200) == pytest.approx(0.49)
    assert stop_miss(crits, 0, 0.01, 200) == pytest.approx(0.49)


def test_a_lockstep_sample_takes_the_whole_batch():
    from types import SimpleNamespace as NS
    calls = [{"pairs": [NS(lum=i % 2 == 0, name=f"c{c}p{i}")
                        for i in range(8)],
              "outs": [((None,), {"iters": 10 + i}) for i in range(8)]}
             for c in range(3)]
    rng = np.random.default_rng(5)
    got = harness._sample(rng, calls, 8, 8, "iters")
    assert len(got) == 8 and len({p.name[:2] for p, *_ in got}) == 1
    assert sorted(o[1]["iters"] for _, *o in got) == list(range(10, 18))
    assert len(harness._sample(rng, calls, 6, 8, "iters")) == 6
