"""A cell and a metric are added as files alone: the harness finds the
configuration, the traffic, the limits and the metric's reader by the
names in BENCHMARK.json, with no edit to its code."""

import json
import shutil
import sys

import pytest

from flowbench import harness

ROOT = harness.HERE.parent


@pytest.fixture
def checkout(tmp_path):
    """A copy of BENCHMARK.json and flowbench/ with one cell, one traffic
    mix, one configuration and one metric added as files."""
    shutil.copytree(harness.HERE, tmp_path / "flowbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = tmp_path / "flowbench"
    config = json.loads((base / "configs" / "gn_sweep.json").read_text())
    (base / "configs" / "gn_dummy.json").write_text(
        json.dumps(dict(config, maxiter=7)))
    traffic = json.loads((base / "traffic" / "mb1_320.json").read_text())
    (base / "traffic" / "dummy_mix.json").write_text(json.dumps(dict(
        traffic, width=24, height=16, check_sample=2)))
    (base / "limits" / "dummy_cell.json").write_text(json.dumps(
        {"numbers": {"field_rel": {"limit": 1.0}}}))
    (base / "metrics" / "dummy.steps_total.py").write_text(
        "def read(rec):\n"
        "    return sum(c['steps'] for call in rec['calls']\n"
        "               for c in call['counters'])\n")
    bench["configs"].append({"name": "gn_dummy", "source": "test",
                             "file": "flowbench/configs/gn_dummy.json",
                             "reduced": ["maxiter"], "why": "test"})
    bench["workloads"].append({"name": "dummy_cell", "config": "gn_dummy",
                               "traffic": "dummy_mix", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({
        "name": "dummy.steps_total", "unit": "steps", "better": "lower",
        "bound": 0.1, "source": "host_clock", "workloads": ["dummy_cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def test_new_cell_and_metric_are_found_by_name(checkout, monkeypatch):
    base = checkout / "flowbench"
    cell = harness.Cell(checkout, "dummy_cell", base=base)
    assert cell.config["maxiter"] == 7
    assert cell.traffic["width"] == 24
    assert cell.limits == {"field_rel": {"limit": 1.0}}
    names = [m["name"] for m in cell.metrics("end_to_end")]
    assert "dummy.steps_total" in names and "pair_p95_ms" not in names
    assert cell.reader("dummy.steps_total").read(
        {"calls": [{"counters": [{"steps": 3}]},
                   {"counters": [{"steps": 4}]}]}) == 7
    assert cell.algo().COUNTER == "steps"
    # the whole run, on the CPU, through the harness as it stands
    monkeypatch.setattr(sys, "path", [str(ROOT)] + sys.path)
    res, _ = harness.run(ROOT, "dummy_cell", 3, 0.0, False, 0.0, device="cpu",
                      cell=cell, min_calls=2)
    assert res["metrics"]["dummy.steps_total"]["value"] <= 7 * 2
    assert list(res)[-1] == "checks"
    assert res["checks"]["field_rel"]["limit"] == 1.0


def test_a_traced_run_reports_the_device_where_no_sub_window_proves_complete(
        checkout, monkeypatch):
    cell = harness.Cell(checkout, "dummy_cell", base=checkout / "flowbench")
    monkeypatch.setattr(sys, "path", [str(ROOT)] + sys.path)
    totals = iter([73017, 72964, 73016, 73014])

    def profile_calls(run, calls, launch_counts):
        for call in calls:
            run(call)
        n = next(totals)
        return {"kernels": {"k": [n, n * 1e-6]}, "busy_s": n * 1e-6,
                "window_s": 0.2, "launches": {"fused_pointwise": 0},
                "gaps": [["cudaGraphLaunch", 0.05]], "host_wall_s": 0.2}

    monkeypatch.setattr(harness.trace, "profile_calls", profile_calls)
    res, _ = harness.run(ROOT, "dummy_cell", 3, 0.0, True, 0.0, device="cpu",
                      cell=cell)
    assert res["device"]["busy_s"] == pytest.approx(73017e-6)
    assert res["device"]["window_s"] == 0.2
    assert res["breakdown"]["idle_gaps"] == [["cudaGraphLaunch", 0.05]]
    assert list(res)[-1] == "checks"


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.Cell(ROOT, "no_such_cell")


def test_every_cell_of_the_benchmark_has_its_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = harness.Cell(ROOT, w["name"])
        assert cell.limits, f"{w['name']} has no limits"
        cell.algo()
        for kind in ("end_to_end", "per_layer"):
            for m in cell.metrics(kind):
                assert callable(cell.reader(m["name"]).read)
