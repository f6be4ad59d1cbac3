"""The Sinkhorn cell (``sinkhorn_mb1_320``): a sound run on the CPU at 32x24
comes out correct with the cell's own limits, and each fault of
``flowbench/faults_sinkhorn.py`` planted in the program makes it not
correct: the eps ladder dropped, the debiasing dropped, ``auto`` without
its re-solve, max-it cut to 100, the tolerance loosened to 1e-2, a dual
update that keeps its state, and u altered where it is produced.  The
runs take eps 1, the cell's 100 scaled by the grid's area (32x24 against
320x240): the ladder then has the cell's four rungs, and the matmul
softmin misses tol on some pairs as it does on the card.  Then the
reference's imports and the cell's metric readers."""

import ast
import time

import pytest

from flowbench import faults_sinkhorn, harness
from flowbench.reference import sinkhorn as ref

ROOT = harness.HERE.parent
SEED = 2 ** 31 + 77
NAME = "sinkhorn_mb1_320"


def _run(seed=SEED):
    cell = harness.Cell(ROOT, NAME)
    cell.traffic = dict(cell.traffic, width=32, height=24,
                        translation_scale=0.25)
    cell.config = dict(cell.config, epsilon=1.0)
    res, _ = harness.run(ROOT, NAME, seed, 0.0, False, time.perf_counter(),
                         device="cpu", cell=cell, min_calls=4)
    return res


def test_sound_run_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 4
    assert set(res["checks"]) == {"flow_gap_px", "m_gap", "stop_miss"}


# the number each fault moves past its limit
MOVES = {
    "sinkhorn_no_anneal": "flow_gap_px",
    "sinkhorn_no_debias": "flow_gap_px",
    "sinkhorn_no_escalation": "flow_gap_px",
    "sinkhorn_early_stop": "stop_miss",
    "sinkhorn_loose_tol": "stop_miss",
    "sinkhorn_keeps_state": "flow_gap_px",
    "sinkhorn_answer_altered": "flow_gap_px",
}


@pytest.mark.parametrize("fault", sorted(faults_sinkhorn.FAULTS))
def test_each_fault_reads_not_correct(monkeypatch, fault):
    faults_sinkhorn.FAULTS[fault](monkeypatch.setattr)
    res = _run()
    assert not res["correct"], res["checks"]
    moved = res["checks"][MOVES[fault]]
    assert moved["value"] > moved["limit"], res["checks"]


def test_every_fault_has_the_number_it_moves():
    assert set(MOVES) == set(faults_sinkhorn.FAULTS)


def test_the_reference_imports_nothing_of_the_program_or_jax():
    tree = ast.parse(open(ref.__file__).read())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0}
    assert {n.split(".", 1)[0] for n in names} <= {
        "__future__", "math", "typing", "torch", "flowbench"}, names
    assert all(n.startswith("flowbench.reference") for n in names
               if n.startswith("flowbench")), names


def _record(counters):
    return {"calls": [{"start": 0.0, "end": 0.1, "pairs": 1,
                       "counters": [c]} for c in counters],
            "profile": None, "traffic": {"batch": 1, "width": 320,
                                         "height": 240},
            "setup_loop": {"capture_ms": 12.5}}


def _read(name, rec):
    return harness.Cell(ROOT, NAME).reader(name).read(rec)


def test_readers_of_the_cell():
    rec = _record([{"iters": 1100, "escalated": 0},
                   {"iters": 2700, "escalated": 1},
                   {"iters": 1000, "escalated": 0},
                   {"iters": 1200, "escalated": 0}])
    assert _read("sinkhorn.iters_per_pair", rec) == pytest.approx(1500.0)
    assert _read("sinkhorn.escalated_pct", rec) == pytest.approx(25.0)
    assert _read("device_loop.capture_ms", rec) == 12.5
    # another cell's counters: nothing to read
    other = _record([{"steps": 150}])
    for name in ("sinkhorn.iters_per_pair", "sinkhorn.escalated_pct"):
        assert _read(name, other) is None


def test_the_cells_metrics():
    """Not ``pairs_per_s``: a 51 s window holds about 3.4 of the stream's
    permutations of the pool, and how many of the last one's pairs are
    escalated (~1.8-2.1 s each against ~0.16 s) moves it 7-10% between
    seeds, past half its bound; its per-layer metrics move the p95, an
    escalated pair's latency."""
    cell = harness.Cell(ROOT, NAME)
    e2e = {m["name"] for m in cell.metrics("end_to_end")}
    assert e2e == {"pair_p95_ms", "setup_s"}
    layer = {m["name"]: m["moves"] for m in cell.metrics("per_layer")}
    assert layer == {"sinkhorn.iters_per_pair": "pair_p95_ms",
                     "sinkhorn.escalated_pct": "pair_p95_ms",
                     "device_loop.capture_ms": "setup_s"}
