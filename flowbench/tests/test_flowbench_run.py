"""The command's refusals: no card, or no program in the checkout, gives
a non-zero exit and no result line."""

import json
import shutil
import subprocess
import sys

import pytest

from flowbench import harness, program

ROOT = harness.HERE.parent


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "flowbench/run.py", "--workload", "foto_mb1_320",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0",
         *extra], cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the run without one")
    proc = _run(ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr


def test_a_checkout_without_the_program_has_no_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "flowbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    code = ("import sys; sys.path.insert(0, '.'); from flowbench import "
            "program\ntry:\n    program.load(__import__('pathlib').Path('.')"
            ".resolve())\nexcept program.ProgramMissing as e:\n"
            "    print('missing', e)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.startswith("missing")


def test_the_program_is_taken_from_the_checkout():
    pkg = program.load(ROOT)
    assert pkg.__name__ == "ofot_tpu_torch"


def test_a_bad_seed_is_refused():
    proc = subprocess.run(
        [sys.executable, "flowbench/run.py", "--workload", "foto_mb1_320",
         "--seed", "-1", "--seconds", "1"], cwd=ROOT, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_benchmark_json_keeps_to_the_contract():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["flowbench"]
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
