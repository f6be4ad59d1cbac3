"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run on the CPU at a small frame size, with the cell's own limits: first
sound (correct), then with one fault of ``flowbench/faults.py`` planted
in the program: an ALG2 iteration or a CG solve that leaves its state as
it was, an answer altered where it is produced, half of a lockstep batch
left out, a stop that the stopping rule does not call for (a cut max_it,
a loosened tolerance, a CG stopped early), and a lockstep batch without
its per-pair freeze.  The exchange between chips does not exist in these
one-card cells."""

import time
from functools import partial

import pytest

from flowbench import faults, harness

ROOT = harness.HERE.parent
SEED = 2 ** 31 + 77


def _run(name, seed=SEED, **traffic):
    cell = harness.Cell(ROOT, name)
    cell.traffic = dict(cell.traffic, width=32, height=24,
                        translation_scale=0.25, **traffic)
    res, _ = harness.run(ROOT, name, seed, 0.0, False, time.perf_counter(),
                         device="cpu", cell=cell, min_calls=4)
    return res


@pytest.mark.parametrize("name", ["foto_mb1_320", "gn_mb1_320",
                                  "foto_mb1_320_lockstep8",
                                  "foto_mb1_640"])
def test_sound_run_is_correct(name):
    res = _run(name)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 4


def test_foto_iteration_that_keeps_its_state(monkeypatch):
    faults.foto_keeps_state(monkeypatch.setattr)
    assert not _run("foto_mb1_320")["correct"]


def test_foto_answer_altered_where_it_is_produced(monkeypatch):
    faults.foto_answer_altered(monkeypatch.setattr)
    assert not _run("foto_mb1_320")["correct"]


@pytest.mark.parametrize("rest", ["copies", "initial"])
def test_lockstep_half_of_the_batch_left_out(monkeypatch, rest):
    faults.lockstep_half_batch(monkeypatch.setattr, rest=rest)
    assert not _run("foto_mb1_320_lockstep8")["correct"]


EARLY = partial(faults.foto_early_stop, max_it=20)


@pytest.mark.parametrize("name, plant", [
    ("foto_mb1_320", EARLY), ("foto_mb1_640", EARLY),
    ("foto_mb1_320_lockstep8", EARLY),
    ("foto_mb1_320", partial(faults.foto_loose_tol, tol=0.1)),
], ids=["max_it-320", "max_it-640", "max_it-lockstep", "tol-320"])
def test_foto_stopped_before_its_rule(monkeypatch, name, plant):
    """max_it cut to 20, or the tolerance loosened to 0.1: the answers are
    those of the program's own count, so only the stop can show it."""
    plant(monkeypatch.setattr)
    res = _run(name)
    assert not res["correct"], res["checks"]
    assert res["checks"]["stop_miss"]["value"] > \
        res["checks"]["stop_miss"]["limit"]


def test_lockstep_without_its_per_pair_freeze(monkeypatch):
    """Every pair steps while any runs and reports the batch's count."""
    faults.lockstep_no_freeze(monkeypatch.setattr)
    res = _run("foto_mb1_320_lockstep8")
    assert not res["correct"], res["checks"]
    assert res["checks"]["stop_overrun"]["value"] > \
        res["checks"]["stop_overrun"]["limit"]


def test_gn_solve_that_keeps_its_state(monkeypatch):
    faults.gn_keeps_state(monkeypatch.setattr)
    assert not _run("gn_mb1_320")["correct"]


def test_gn_answer_altered_where_it_is_produced(monkeypatch):
    faults.gn_answer_altered(monkeypatch.setattr)
    assert not _run("gn_mb1_320")["correct"]


def test_gn_cg_stopped_early(monkeypatch):
    """CG stopped at rtol 1e-3 where the configuration states 1e-10."""
    faults.gn_cg_loose(monkeypatch.setattr, rtol=1e-3)
    res = _run("gn_mb1_320")
    assert not res["correct"], res["checks"]
    assert res["checks"]["residual"]["value"] > \
        res["checks"]["residual"]["limit"]
