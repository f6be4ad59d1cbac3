"""The port's pipeline (``ofot_tpu_torch.cli.pipeline``) against the JAX
package's, both on the CPU on the same frames.

Per sequence and algorithm: the same manifest key set and ALG2 / Sinkhorn
iteration counts, CG steps within 2 (float32 dot products summed in
another order stop CG a step or two apart at rtol 1e-10), IE within rtol
1e-4 and .flo AEPE < 1e-3 (the CLI tests' bounds), ``diff.png`` bitwise,
the reconstruction and luminosity PNGs within one gray level (one float32
warp rounding across a quantization step), and every flow visualization
exactly the port's ``flow_to_png`` of the port's own .flo.  Also: resume,
the middlebury-2 ground-truth path, the two-host partition and
``merge-manifests``, ``--batch`` against per-sequence, the batched
parameter parser, both rungs of the Sinkhorn escalation and the
interrupted-escalation flag (as tests/test_pipeline.py holds JAX's), and
``download`` from the synthetic Middlebury zips.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ofot_tpu.cli import pipeline as jax_pipeline
from ofot_tpu_torch.cli import pipeline
from ofot_tpu_torch.utils import colorwheel, flo, image

import fixtures

ROOT = Path(__file__).resolve().parents[1]
FAST = "--Nt=4 --max-it=4"
ALGOS = "GN,foto,WFR,sinkhorn"
SEQS = ["middlebury-1/a", "middlebury-1/b", "middlebury-2/GTSeq"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small shapes: one intra-op thread, so that the suite's parallel
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mk_data(root):
    """Two middlebury-1 sequences and one middlebury-2 sequence with a
    constant ground-truth flow, all 18x20 (one program per algo in JAX)."""
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


def _run_argv(data, results, *extra, algos=ALGOS,
              datasets="middlebury-1,middlebury-2"):
    return ["run", "--data-root", str(data), "--results", str(results),
            "--datasets", datasets, "--algos", algos, "--platform=cpu",
            "--extra-args", FAST, *extra]


def _manifest(results, name="manifest.json"):
    return json.loads((Path(results) / name).read_text())


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """The port's and the JAX pipeline's per-sequence sweeps, and the
    port's batched sweep, of the same data."""
    root = tmp_path_factory.mktemp("pipeline")
    data = _mk_data(root / "data")
    assert pipeline.main(_run_argv(data, root / "port")) == 0
    with pytest.MonkeyPatch.context() as mp:
        # keep the JAX CLI's compilation cache out of the repository
        mp.setenv("OFOT_COMPILE_CACHE", str(root / "jax_cache"))
        assert jax_pipeline.main(_run_argv(data, root / "jax")) == 0
    assert pipeline.main(_run_argv(data, root / "batch", "--batch")) == 0
    return root


def _flo(path):
    return flo.read_flo(str(path))[2:]


def _aepe(a, b):
    (u1, v1), (u2, v2) = _flo(a), _flo(b)
    return float(np.sqrt((u1 - u2) ** 2 + (v1 - v2) ** 2).mean())


def _ie(path):
    return float(next(ln for ln in path.read_text().splitlines()
                      if ln.startswith("IE")).split(": ")[1])


@pytest.mark.parametrize("seq", SEQS)
def test_manifest_matches_jax(sweeps, seq):
    port, jax = _manifest(sweeps / "port")[seq], _manifest(sweeps / "jax")[seq]
    assert sorted(port) == sorted(jax) == ["GN", "WFR", "foto", "sinkhorn"]
    for algo in port:
        p, j = port[algo], jax[algo]
        assert set(p) == set(j), (algo, set(p) ^ set(j))
        assert p["status"] == "ok"
        if "iterations" in p:
            assert p["iterations"] == j["iterations"], algo
        if "inner_iterations" in p:
            assert abs(p["inner_iterations"] - j["inner_iterations"]) <= 2
        assert p["IE"] == pytest.approx(j["IE"], rel=1e-4)
        assert p["solver_wall_s"] <= p["wall_s"]
    assert port["foto"]["stepA_solver"] == "cg"      # auto on the CPU
    assert port["WFR"]["stepA_solver"] == "dct"
    assert port["sinkhorn"]["stabilizer"] == "matmul"


@pytest.mark.parametrize("seq", SEQS)
def test_artifacts_match_jax(sweeps, seq):
    p, j = sweeps / "port" / seq, sweeps / "jax" / seq
    assert sorted(x.name for x in p.iterdir()) == \
        sorted(x.name for x in j.iterdir())
    np.testing.assert_array_equal(image.read_png(str(p / "diff.png")),
                                  image.read_png(str(j / "diff.png")))
    gt = "GTSeq" in seq
    for algo in ("gn", "foto", "wfr", "sinkhorn"):
        assert _aepe(p / f"{algo}.flo", j / f"{algo}.flo") < 1e-3
        assert _ie(p / f"{algo}.benchmark.txt") == pytest.approx(
            _ie(j / f"{algo}.benchmark.txt"), rel=1e-4)
        for kind in ("rec", "lum"):
            a = image.read_png(str(p / f"{algo}.{kind}.png")).astype(int)
            b = image.read_png(str(j / f"{algo}.{kind}.png")).astype(int)
            assert np.abs(a - b).max() <= 1, (algo, kind)
        # the visualization is the port's own color wheel of its own flow
        colorwheel.flow_to_png(
            str(p / f"{algo}.flo"), str(p / "again.png"),
            maxmotion=pipeline._gt_maxmotion(
                sweeps / "data" / "middlebury-2" / "other-gt-flow" / "GTSeq"
                / "flow10.flo") if gt else None)
        assert (p / "again.png").read_bytes() == \
            (p / f"{algo}.png").read_bytes()
        (p / "again.png").unlink()
        lines = (p / f"{algo}.benchmark.txt").read_text().splitlines()
        assert lines[0].startswith("EE-mean: ") == gt
        assert any(ln.startswith("AE-mean: ") for ln in lines) == gt
    assert (p / "flow10.png").exists() == gt
    assert (p / "wfr.growth.png").exists()


def test_resume_solves_nothing_and_keeps_entries(sweeps, tmp_path,
                                                 monkeypatch):
    from ofot_tpu_torch.cli import main as cli_main
    calls = []
    monkeypatch.setattr(cli_main, "main", lambda argv: calls.append(argv))
    before = _manifest(sweeps / "port")
    assert pipeline.main(_run_argv(sweeps / "data", sweeps / "port")) == 0
    assert calls == []
    assert _manifest(sweeps / "port") == before


def test_batch_matches_per_sequence(sweeps):
    batch, port = _manifest(sweeps / "batch"), _manifest(sweeps / "port")
    for seq in SEQS:
        for algo, entry in batch[seq].items():
            assert entry["batched"] and entry["batch_mode"] == "map"
            assert entry["batch_size"] == (2 if "middlebury-1" in seq else 1)
            for key in ("iterations", "inner_iterations"):
                if key in port[seq][algo]:
                    assert entry[key] == port[seq][algo][key], (seq, algo)
            # the same functions in the same order on the same device
            for got, want in zip(
                    _flo(sweeps / "batch" / seq / f"{algo.lower()}.flo"),
                    _flo(sweeps / "port" / seq / f"{algo.lower()}.flo")):
                np.testing.assert_array_equal(got, want)
        assert (sweeps / "batch" / seq / ".out.sinkhorn.sucess").exists()


def test_batch_manifest_keys_match_jax(sweeps, tmp_path, monkeypatch):
    monkeypatch.setenv("OFOT_COMPILE_CACHE", str(tmp_path / "jax_cache"))
    argv = _run_argv(sweeps / "data", tmp_path / "jax", "--batch",
                     algos="GN,foto", datasets="middlebury-2")
    assert jax_pipeline.main(argv) == 0
    want = _manifest(tmp_path / "jax")["middlebury-2/GTSeq"]
    got = _manifest(sweeps / "batch")["middlebury-2/GTSeq"]
    for algo in want:
        assert set(got[algo]) == set(want[algo]), algo
        assert got[algo]["iterations" if algo == "foto"
                         else "inner_iterations"] == pytest.approx(
            want[algo]["iterations" if algo == "foto"
                       else "inner_iterations"], abs=2)


def test_two_host_partition_and_merge(sweeps, tmp_path):
    base = _run_argv(sweeps / "data", tmp_path, "--host-count", "2",
                     algos="GN", datasets="middlebury-1")
    assert pipeline.main(base + ["--host-id", "0"]) == 0
    assert sorted(p.parent.name for p in
                  (tmp_path / "middlebury-1").glob("*/gn.flo")) == ["a"]
    assert pipeline.main(base + ["--host-id", "1", "--batch"]) == 0
    assert pipeline.main(["merge-manifests", "--results",
                          str(tmp_path)]) == 0
    shard0, shard1 = (_manifest(tmp_path, f"manifest.{i}.json")
                      for i in (0, 1))
    assert list(shard0) == ["middlebury-1/a"]
    assert list(shard1) == ["middlebury-1/b"]
    assert _manifest(tmp_path) == {**shard0, **shard1}


@pytest.mark.parametrize("extra", [
    "--lambda=0.4 --conv=0.2 --wfr-delta=15 --auto-r --sinkhorn-eps=2.5 "
    "--max-it=50",
    "--precision=f64 --max-it=400", "--platform=cpu",
    "--sinkhorn-theta=1.5 --sinkhorn-stabilizer=exact --stepA=dct",
    "--p=f64", "--a=9", "--bogus=1", "--normalize", "--sinkhorn-theta=2",
    "--sinkhorn-stabilizer=auto"])
def test_batched_params_match_jax(extra):
    try:
        want = jax_pipeline._batched_params(extra)
    except SystemExit as e:
        with pytest.raises(SystemExit) as got:
            pipeline._batched_params(extra)
        assert str(got.value) == str(e)
        return
    assert pipeline._batched_params(extra) == want


def _assert_flows_match(results, reference, seqs, algos, bound=1e-4):
    for seq in seqs:
        for algo in algos:
            aepe = _aepe(Path(results) / seq / f"{algo}.flo",
                         Path(reference) / seq / f"{algo}.flo")
            assert aepe < bound, (seq, algo, aepe)


@pytest.mark.parametrize("extra,match", [(["--data-parallel=2"], "")])
def test_unported_batch_layouts_exit_2(sweeps, tmp_path, capsys, extra,
                                       match):
    """``--data-parallel`` runs now (it exited 2 before the distribution
    layer was ported): 2 ranks, every algo, the one-process batch's
    flows and manifest rows."""
    argv = _run_argv(sweeps / "data", tmp_path, "--batch", *extra)
    assert pipeline.main(argv) == 0
    assert match in capsys.readouterr().err
    _assert_flows_match(tmp_path, sweeps / "batch", SEQS,
                        [a.lower() for a in ALGOS.split(",")])
    rows, want = _manifest(tmp_path), _manifest(sweeps / "batch")
    assert rows.keys() == want.keys()
    for seq in rows:
        for algo in ALGOS.split(","):
            assert rows[seq][algo].keys() == want[seq][algo].keys()
            assert rows[seq][algo]["batch_size"] == \
                want[seq][algo]["batch_size"]


@pytest.mark.parametrize("mode", ["map", "vmap"])
def test_batch_data_parallel_matches_single_process(sweeps, tmp_path, mode):
    """``run --batch --data-parallel 4 --platform=cpu``: the pairs split
    over 4 ranks (2 + 1 sequences padded to 4) give the one-process
    batch's flows (AEPE < 1e-4, tests/test_batch_sweep.py's bound)."""
    common = ["--batch", f"--batch-mode={mode}"]
    one, dp = tmp_path / "one", tmp_path / "dp"
    assert pipeline.main(_run_argv(sweeps / "data", one, *common,
                                   algos="GN,foto")) == 0
    assert pipeline.main(_run_argv(sweeps / "data", dp, *common,
                                   "--data-parallel", "4",
                                   algos="GN,foto")) == 0
    _assert_flows_match(dp, one, SEQS, ["gn", "foto"])
    assert _manifest(dp).keys() == _manifest(one).keys()


def test_batch_vmap_runs(sweeps, tmp_path):
    """``--batch-mode=vmap`` runs the lockstep batch and records it."""
    argv = _run_argv(sweeps / "data", tmp_path, "--batch",
                     "--batch-mode=vmap", algos="GN,foto",
                     datasets="middlebury-1")
    assert pipeline.main(argv) == 0
    rows = _manifest(tmp_path)
    assert sorted(rows) == ["middlebury-1/a", "middlebury-1/b"]
    for seq, entry in rows.items():
        for algo in ("GN", "foto"):
            assert entry[algo]["batch_mode"] == "vmap"
            assert entry[algo]["batch_size"] == 2
            assert (tmp_path / seq / f".out.{algo.lower()}.sucess").exists()
            assert (tmp_path / seq / f"{algo.lower()}.flo").exists()


def test_batch_refuses_float64_kernel_set_on_cuda(sweeps, tmp_path, capsys,
                                                  monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    argv = ["run", "--batch", "--data-root", str(sweeps / "data"),
            "--results", str(tmp_path), "--datasets", "middlebury-1",
            "--algos", "foto", "--precision=f64"]
    assert pipeline.main(argv) == 2
    assert "float32 only" in capsys.readouterr().err


def test_unknown_algo_rejected(sweeps, tmp_path):
    with pytest.raises(SystemExit):
        pipeline.main(_run_argv(sweeps / "data", tmp_path, algos="HS"))


# ------------------------------------------------- the Sinkhorn escalation

def _stats(tmp_path, **rec):
    p = tmp_path / "s.jsonl"
    p.write_text(json.dumps({"event": "solve", **rec}) + "\n")
    return p


def test_escalation_skips_converged_and_f64(monkeypatch):
    calls = []
    monkeypatch.setattr(pipeline, "_escalate_sinkhorn_f64",
                        lambda argv: calls.append(argv) or True)
    res = {"marginal_error": 5e-5}
    pipeline._maybe_escalate_sinkhorn(res, ["--algo=sinkhorn"],
                                      Path("x"), 1.0)
    res64 = {"marginal_error": 0.1}
    pipeline._maybe_escalate_sinkhorn(
        res64, ["--algo=sinkhorn", "--precision", "f64"], Path("x"), 1.0)
    assert not calls and "escalated_f64" not in res | res64


@pytest.mark.parametrize("me", [0.05, float("nan")])
@pytest.mark.parametrize("ok", [True, False])
def test_escalation_rung2(monkeypatch, tmp_path, me, ok):
    stats = _stats(tmp_path, marginal_error=7e-5, iterations=333)
    monkeypatch.setattr(pipeline, "_escalate_sinkhorn_f64", lambda argv: ok)
    res = {"marginal_error": me, "wall_s": 1.0}
    pipeline._maybe_escalate_sinkhorn(res, ["--algo=sinkhorn"], stats, 1.0)
    if ok:
        assert res["escalated_f64"] is True
        assert res["marginal_error"] == 7e-5 and res["iterations"] == 333
        assert "escalation_failed" not in res
    else:
        assert res["escalation_failed"] is True
        assert "escalated_f64" not in res


@pytest.mark.parametrize("exact_me,pinned,want_calls", [
    (8e-5, False, ["exact"]), (5e-4, False, ["exact", "f64"]),
    (9e-5, True, ["f64"])])
def test_escalation_rung1_for_batches(monkeypatch, tmp_path, exact_me,
                                      pinned, want_calls):
    stats = _stats(tmp_path, marginal_error=exact_me, stabilizer="exact")
    calls = []

    def fake_f64(argv):
        calls.append("f64")
        stats.write_text(json.dumps({"event": "solve",
                                     "marginal_error": 8e-5}) + "\n")
        return True

    monkeypatch.setattr(pipeline, "_escalate_sinkhorn_inprocess",
                        lambda argv: calls.append("exact") or True)
    monkeypatch.setattr(pipeline, "_escalate_sinkhorn_f64", fake_f64)
    argv = ["--algo=sinkhorn"] + (["--sinkhorn-stabilizer=exact"]
                                  if pinned else [])
    res = {"marginal_error": 0.12, "wall_s": 1.0, "batched": True}
    pipeline._maybe_escalate_sinkhorn(res, argv, stats, 1.0)
    assert calls == want_calls
    assert res.get("escalated_exact") is (True if want_calls == ["exact"]
                                          else None)
    if want_calls == ["exact", "f64"]:
        assert res["marginal_error_exact"] == 5e-4
        assert res["marginal_error_batch"] == 0.12
    if "f64" in want_calls:
        assert res["escalated_f64"] is True
        assert res["marginal_error"] == 8e-5


def test_rung2_reruns_the_ports_cli_at_float64_on_the_cpu(sweeps,
                                                         tmp_path,
                                                         monkeypatch):
    """Rung 2 re-solves in process at float64 on the sweep's own device
    (the CPU here): the argv's --platform stays, only the precision is
    appended."""
    from ofot_tpu_torch.cli import main as cli_main
    seen, real = [], cli_main.main
    monkeypatch.setattr(cli_main, "main",
                        lambda argv: seen.append(argv) or real(argv))
    seq = sweeps / "data" / "middlebury-1" / "eval-data-gray" / "a"
    argv, stats = pipeline._algo_argv(
        "sinkhorn", seq / "frame10.png", seq / "frame11.png", tmp_path,
        ["--max-it=50", "--platform=cpu"])
    assert pipeline._escalate_sinkhorn_f64(argv)
    assert seen == [[str(x) for x in argv] + ["--precision=f64"]]
    rec = json.loads(stats.read_text().splitlines()[-1])
    assert rec["algo"] == "sinkhorn" and rec["iterations"] > 0
    w, h, u, v = flo.read_flo(str(tmp_path / "sinkhorn.flo"))
    assert (w, h) == (20, 18) and np.isfinite(u).all()


def test_rung1_reruns_the_ports_cli_in_process_with_exact(sweeps, tmp_path):
    seq = sweeps / "data" / "middlebury-1" / "eval-data-gray" / "b"
    argv, stats = pipeline._algo_argv(
        "sinkhorn", seq / "frame10.png", seq / "frame11.png", tmp_path,
        ["--max-it=50", "--platform=cpu"])
    assert pipeline._escalate_sinkhorn_inprocess(argv)
    assert json.loads(stats.read_text())["stabilizer"] == "exact"


@pytest.mark.parametrize("batch", [False, True])
def test_failing_f64_resolve_marks_the_row_and_the_sweep_goes_on(
        sweeps, tmp_path, monkeypatch, capsys, batch):
    """An exception in rung 2's in-process float64 re-solve gives the row
    ``escalation_failed``, and the sweep writes its other rows and returns
    0, as the JAX pipeline does when its float64 subprocess fails."""
    from ofot_tpu_torch.cli import main as cli_main
    real, f64_runs = cli_main.main, []

    def main(argv):
        if "--precision=f64" in argv:
            f64_runs.append(argv)
            raise RuntimeError("CUDA out of memory (simulated)")
        return real(argv)

    monkeypatch.setattr(cli_main, "main", main)
    argv = _run_argv(sweeps / "data", tmp_path, *(["--batch"] if batch
                                                  else []),
                     algos="GN,sinkhorn", datasets="middlebury-1")
    # a tolerance that 4 iterations cannot meet sends both rows to rung 2
    argv[argv.index(FAST)] = FAST + " --sinkhorn-tol=1e-12"
    assert pipeline.main(argv) == 0
    assert len(f64_runs) == 2
    assert "RuntimeError: CUDA out of memory" in capsys.readouterr().err
    rows = _manifest(tmp_path)
    assert sorted(rows) == ["middlebury-1/a", "middlebury-1/b"]
    for seq, entry in rows.items():
        assert entry["sinkhorn"]["escalation_failed"] is True
        assert "escalated_f64" not in entry["sinkhorn"]
        assert entry["GN"]["status"] == "ok"
        for algo in ("gn", "sinkhorn"):
            assert (tmp_path / seq / f"{algo}.flo").exists()
            assert (tmp_path / seq / f".out.{algo}.sucess").exists()


def test_batch_interrupted_escalation_not_marked_done(sweeps, tmp_path,
                                                      monkeypatch):
    class _Boom(BaseException):
        pass

    def boom(res, argv, stats_path, wall0):
        raise _Boom()

    monkeypatch.setattr(pipeline, "_maybe_escalate_sinkhorn", boom)
    argv = _run_argv(sweeps / "data", tmp_path, "--batch",
                     algos="sinkhorn", datasets="middlebury-1")
    with pytest.raises(_Boom):
        pipeline.main(argv)
    seq = tmp_path / "middlebury-1" / "a"
    assert (seq / "sinkhorn.flo").exists()
    assert not (seq / ".out.sinkhorn.sucess").exists()
    seen = []
    monkeypatch.setattr(pipeline, "_maybe_escalate_sinkhorn",
                        lambda res, argv, stats_path, wall0: seen.append(
                            argv))
    assert pipeline.main(argv) == 0
    assert (seq / ".out.sinkhorn.sucess").exists()
    # an escalation re-solves on the batch's own device
    assert seen and all("--platform=cpu" in a for a in seen)


# ---------------------------------------------------------------- download

def test_download_matches_jax(tmp_path):
    zips = tmp_path / "zips"
    subprocess.run([sys.executable, str(ROOT / "tools" /
                                        "make_synthetic_middlebury.py"),
                    str(zips), "--size", "64x48", "--mb2-size", "32x24"],
                   check=True, capture_output=True, timeout=300,
                   env={**os.environ, "PYTHONPATH": str(ROOT)})
    argv = ["--local-zip", str(zips / "eval-gray-twoframes.zip"),
            "--local-zip-mb2-data", str(zips / "other-gray-twoframes.zip"),
            "--local-zip-mb2-gt", str(zips / "other-gt-flow.zip"),
            "--lum-seed", "7"]
    for name, mod in (("port", pipeline), ("jax", jax_pipeline)):
        assert mod.main(["download", "--data-root", str(tmp_path / name),
                         *argv]) == 0
    frames = sorted(p.relative_to(tmp_path / "port") for p in
                    (tmp_path / "port").rglob("*.png"))
    assert frames == sorted(p.relative_to(tmp_path / "jax") for p in
                            (tmp_path / "jax").rglob("*.png"))
    assert {f.parts[0] for f in frames} == {"middlebury-1",
                                            "middlebury-1-lum",
                                            "middlebury-2"}
    for f in frames:
        got = image.read_png(str(tmp_path / "port" / f))
        np.testing.assert_array_equal(got,
                                      image.read_png(str(tmp_path / "jax"
                                                         / f)))
        assert got.shape == ((24, 32) if f.parts[0] != "middlebury-2"
                             else (24, 32))
    lum = tmp_path / "port" / "middlebury-1-lum" / "eval-data-gray"
    base = tmp_path / "port" / "middlebury-1" / "eval-data-gray"
    seq = sorted(p.name for p in lum.iterdir())[0]
    assert not np.array_equal(image.read_png(str(lum / seq / "frame11.png")),
                              image.read_png(str(base / seq /
                                                 "frame11.png")))
