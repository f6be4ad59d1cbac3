"""The WFR cell (``wfr_mb1_320``): a sound run on the CPU at a small frame
size comes out correct with the cell's own limits, and each fault of
``flowbench/faults_wfr.py`` planted in the program makes it not correct:
an iteration that keeps its state, max_it cut to 20, the tolerance
loosened to 0.1, the source dropped (delta -> infinity, the balanced
solve in WFR's place), the growth altered where it is produced, and m
shipped without the growth.  Then the cell's metric readers on records
made by hand."""

import time

import pytest

from flowbench import faults_wfr, harness, roofline

ROOT = harness.HERE.parent
SEED = 2 ** 31 + 77
NAME = "wfr_mb1_320"


def _run(seed=SEED):
    cell = harness.Cell(ROOT, NAME)
    cell.traffic = dict(cell.traffic, width=32, height=24,
                        translation_scale=0.25)
    res, _ = harness.run(ROOT, NAME, seed, 0.0, False, time.perf_counter(),
                         device="cpu", cell=cell, min_calls=4)
    return res


def test_sound_run_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 4
    assert set(res["checks"]) == {"flow_gap_px", "lum_frame_gap",
                                  "stop_miss"}


# the number each fault moves past its limit
MOVES = {
    "wfr_keeps_state": "flow_gap_px",
    "wfr_early_stop": "stop_miss",
    "wfr_loose_tol": "stop_miss",
    "wfr_no_source": "flow_gap_px",
    "wfr_answer_altered": "lum_frame_gap",
    "wfr_no_growth": "lum_frame_gap",
}


@pytest.mark.parametrize("fault", sorted(faults_wfr.FAULTS))
def test_each_fault_reads_not_correct(monkeypatch, fault):
    faults_wfr.FAULTS[fault](monkeypatch.setattr)
    res = _run()
    assert not res["correct"], res["checks"]
    moved = res["checks"][MOVES[fault]]
    assert moved["value"] > moved["limit"], res["checks"]


def test_every_fault_has_the_number_it_moves():
    assert set(MOVES) == set(faults_wfr.FAULTS)


def _record(profile, iters=(150, 170)):
    return {"calls": [{"start": 0.0, "end": 0.1, "pairs": 1,
                       "counters": [{"iters": n}]} for n in iters],
            "profile": profile, "traffic": {"batch": 1, "width": 320,
                                            "height": 240},
            "config": {"Nt": 16}, "device_kind": "NVIDIA H100 80GB HBM3"}


def _read(name, rec):
    return harness.Cell(ROOT, NAME).reader(name).read(rec)


def test_readers_of_the_cell():
    points = 16 * 240 * 320
    nbytes, ops = roofline.fused_pointwise(points, 1, ncomp=4)
    # grad phi, mu and q_prev read, q and mu written: 5 fields of 4 planes
    assert nbytes == 5 * 4 * points * 4
    least = roofline.bound_s(nbytes, ops, "NVIDIA H100 80GB HBM3")
    prof = {"busy_s": 0.05, "window_s": 0.1,
            "launches": {"fused_pointwise": 100},
            "kernels": {"fused_pointwise_kernel<3, true, float>": [
                100, 100 * 2 * least * 0.9],
                "reduce_partials_kernel": [100, 100 * 2 * least * 0.1]}}
    rec = _record(prof)
    assert _read("wfr.iters_per_pair", rec) == pytest.approx(160.0)
    assert _read("wfr.device_ms_per_iter", rec) == pytest.approx(0.5)
    assert _read("wfr.fused_pointwise_roofline", rec) == pytest.approx(50.0)
    assert _read("device.idle_pct", rec) == pytest.approx(50.0)
    # untraced, or a sub-window without #1: nothing to read
    for name in ("wfr.device_ms_per_iter", "wfr.fused_pointwise_roofline"):
        assert _read(name, _record(None)) is None
    prof = dict(prof, launches={}, kernels={})
    for name in ("wfr.device_ms_per_iter", "wfr.fused_pointwise_roofline"):
        assert _read(name, _record(prof)) is None


def test_the_cells_metrics():
    cell = harness.Cell(ROOT, NAME)
    e2e = {m["name"] for m in cell.metrics("end_to_end")}
    assert e2e == {"pairs_per_s", "pair_p95_ms", "setup_s"}
    layer = {m["name"] for m in cell.metrics("per_layer")}
    assert {"wfr.iters_per_pair", "wfr.device_ms_per_iter",
            "wfr.fused_pointwise_roofline", "device.idle_pct"} <= layer
    assert not layer & {"alg2.ms_per_iter", "fused_pointwise_roofline"}
