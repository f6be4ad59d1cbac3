"""The control comes out not correct: the plain reference, one precision
step below the configuration's (TF32 products for FOTO, bfloat16 for
GN), put in the program's place at the cell's own size.  TF32 and
bfloat16 products on the card are what the control is about, so this
runs on the card only; ``flowbench/readings.py --control`` reads the same
numbers over more seeds."""

import time

import pytest

from flowbench import harness

ROOT = harness.HERE.parent


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("the control's TF32 and bfloat16 products need a card")
    return "cuda"


@pytest.mark.parametrize("name", ["foto_mb1_320", "gn_mb1_320",
                                  "foto_mb1_320_lockstep8",
                                  "foto_mb1_640"])
def test_control_is_not_correct(card, name):
    res, _ = harness.run(ROOT, name, 2 ** 31 + 99, 0.0, False,
                         time.perf_counter(), device=card, control=True,
                         min_calls=6 if name != "foto_mb1_320_lockstep8"
                         else 1)
    assert not res["correct"], res["checks"]
