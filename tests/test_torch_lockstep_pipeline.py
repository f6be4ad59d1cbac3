"""``pipeline run --batch --batch-mode=vmap``: the port's lockstep sweep
against the JAX pipeline's, both on the CPU on the same frames, at the
keys and bounds tests/test_torch_pipeline.py holds the per-sequence and
map-mode sweeps to: the same manifest keys and ALG2 / Sinkhorn iteration
counts, CG steps within 2, IE within rtol 1e-4, .flo AEPE < 1e-3, the
reconstruction and luminosity PNGs within one gray level, and every flow
visualization the port's own color wheel of its own .flo.  GN runs at
``--precision=f64``: its CG stops at rtol 1e-10, below float32's
resolution, where JAX's own vmap and map modes differ by up to 5 steps on
these frames.  The frames are those of tests/test_torch_pipeline.py.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from ofot_tpu.cli import pipeline as jax_pipeline
from ofot_tpu_torch.cli import pipeline
from ofot_tpu_torch.utils import colorwheel, flo, image

import fixtures

FAST = "--Nt=4 --max-it=4"
SEQS = ["middlebury-1/a", "middlebury-1/b", "middlebury-2/GTSeq"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mk_data(root):
    """Two middlebury-1 sequences (one batch of 2) and one middlebury-2
    sequence with a constant ground-truth flow, all 18x20."""
    for name, shift in (("a", (2.0, 1.0)), ("b", (-1.0, 2.0))):
        d = root / "middlebury-1" / "eval-data-gray" / name
        d.mkdir(parents=True)
        f1, f2 = fixtures.smooth_blob_pair(18, 20, shift=shift)
        image.save_grayscale(f1, str(d / "frame10.png"))
        image.save_grayscale(f2, str(d / "frame11.png"))
    d = root / "middlebury-2" / "other-data-gray" / "GTSeq"
    d.mkdir(parents=True)
    f1, f2 = fixtures.smooth_blob_pair(18, 20, shift=(2.0, 1.0))
    image.save_grayscale(f1, str(d / "frame10.png"))
    image.save_grayscale(f2, str(d / "frame11.png"))
    g = root / "middlebury-2" / "other-gt-flow" / "GTSeq"
    g.mkdir(parents=True)
    flo.write_flo(20, 18, np.full(360, 1.0), np.full(360, 2.0),
                  str(g / "flow10.flo"))
    return root


def _run(main, data, results, *extra):
    """foto, WFR and Sinkhorn at float32, then GN at float64, into one
    results folder."""
    for algos, fast in (("foto,WFR,sinkhorn", FAST),
                        ("GN", FAST + " --precision=f64")):
        assert main(["run", "--data-root", str(data), "--results",
                     str(results), "--datasets", "middlebury-1,middlebury-2",
                     "--algos", algos, "--platform=cpu", "--extra-args",
                     fast, "--batch", *extra]) == 0


def _manifest(results):
    return json.loads((Path(results) / "manifest.json").read_text())


def _flo(path):
    return flo.read_flo(str(path))[2:]


def _ie(path):
    return float(next(ln for ln in path.read_text().splitlines()
                      if ln.startswith("IE")).split(": ")[1])


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    root = tmp_path_factory.mktemp("lockstep_pipeline")
    data = _mk_data(root / "data")
    _run(pipeline.main, data, root / "port", "--batch-mode=vmap")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OFOT_COMPILE_CACHE", str(root / "jax_cache"))
        _run(jax_pipeline.main, data, root / "jax", "--batch-mode=vmap")
    _run(pipeline.main, data, root / "map")
    return root


@pytest.mark.parametrize("seq", SEQS)
def test_vmap_manifest_matches_jax(sweeps, seq):
    port, jax = _manifest(sweeps / "port")[seq], _manifest(sweeps / "jax")[seq]
    assert sorted(port) == sorted(jax) == ["GN", "WFR", "foto", "sinkhorn"]
    for algo in port:
        p, j = port[algo], jax[algo]
        assert set(p) == set(j), (algo, set(p) ^ set(j))
        assert p["status"] == "ok" and p["batched"]
        assert p["batch_mode"] == j["batch_mode"] == "vmap"
        assert p["batch_size"] == (2 if "middlebury-1" in seq else 1)
        if "iterations" in p:
            assert p["iterations"] == j["iterations"], algo
        if "inner_iterations" in p:
            assert abs(p["inner_iterations"] - j["inner_iterations"]) <= 2


@pytest.mark.parametrize("seq", SEQS)
def test_vmap_artifacts_match_jax(sweeps, seq):
    p, j = sweeps / "port" / seq, sweeps / "jax" / seq
    assert sorted(x.name for x in p.iterdir()) == \
        sorted(x.name for x in j.iterdir())
    gt = "GTSeq" in seq
    for algo in ("gn", "foto", "wfr", "sinkhorn"):
        (u1, v1), (u2, v2) = _flo(p / f"{algo}.flo"), _flo(j / f"{algo}.flo")
        assert np.sqrt((u1 - u2) ** 2 + (v1 - v2) ** 2).mean() < 1e-3
        assert _ie(p / f"{algo}.benchmark.txt") == pytest.approx(
            _ie(j / f"{algo}.benchmark.txt"), rel=1e-4)
        for kind in ("rec", "lum"):
            a = image.read_png(str(p / f"{algo}.{kind}.png")).astype(int)
            b = image.read_png(str(j / f"{algo}.{kind}.png")).astype(int)
            assert np.abs(a - b).max() <= 1, (algo, kind)
        colorwheel.flow_to_png(
            str(p / f"{algo}.flo"), str(p / "again.png"),
            maxmotion=pipeline._gt_maxmotion(
                sweeps / "data" / "middlebury-2" / "other-gt-flow" / "GTSeq"
                / "flow10.flo") if gt else None)
        assert (p / "again.png").read_bytes() == \
            (p / f"{algo}.png").read_bytes()
        (p / "again.png").unlink()


@pytest.mark.parametrize("seq", SEQS)
def test_vmap_matches_the_ports_map_batch(sweeps, seq):
    """The same counts as the port's map mode, and flows within float32
    rounding of it (batched and single products may round apart)."""
    vm, mp = _manifest(sweeps / "port")[seq], _manifest(sweeps / "map")[seq]
    for algo in vm:
        assert mp[algo]["batch_mode"] == "map"
        for key in ("iterations", "inner_iterations", "converged"):
            if key in vm[algo]:
                assert vm[algo][key] == mp[algo][key], (algo, key)
        (u1, v1), (u2, v2) = (
            _flo(sweeps / name / seq / f"{algo.lower()}.flo")
            for name in ("port", "map"))
        assert np.sqrt((u1 - u2) ** 2 + (v1 - v2) ** 2).mean() < 1e-4
