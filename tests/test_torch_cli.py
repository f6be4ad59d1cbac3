"""The port's CLI (``ofot_tpu_torch.cli.main``) on the CPU vs the JAX CLI.

Both CLIs read the same small PGM pair and run the sweep's FOTO_ARGS or
WFR_ARGS (cli/pipeline.py:58-63) with Nt and max-it cut down, or GN_ARGS
(:40) and HS, single-level and coarse-to-fine, at --precision=f64.
Tolerances: IE rtol 1e-4 and the .flo AEPE between the two outputs < 1e-3,
the bounds tests/test_cli.py holds its own backends to, and the same ALG2
or CG iteration count; GN's AEPE at f64 < 1e-8 (both run CG to rtol 1e-10
on the same system).
"""

import json

import numpy as np
import pytest
import torch

from ofot_tpu.cli import main as jax_cli
from ofot_tpu.cli.pipeline import FOTO_ARGS, GN_ARGS, WFR_ARGS
from ofot_tpu_torch.cli import main as cli
from ofot_tpu_torch.utils import flo, image

import fixtures

SMALL = ["--Nt=4", "--max-it=25"]


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    f1, f2 = fixtures.smooth_blob_pair(20, 24, shift=(2.0, 1.0))
    image.save_grayscale(f1, str(d / "f0.pgm"))
    image.save_grayscale(f2, str(d / "f1.pgm"))
    return d


@pytest.fixture
def no_repo_cache(monkeypatch, tmp_path):
    """Keep the JAX CLI's compilation cache out of the repository."""
    monkeypatch.setenv("OFOT_COMPILE_CACHE", str(tmp_path / "jax_cache"))


def _argv(frames, *extra):
    return [str(frames / "f0.pgm"), str(frames / "f1.pgm"), "--quiet",
            "--platform=cpu", *extra]


def _ie(path):
    return float([ln for ln in path.read_text().splitlines()
                  if ln.startswith("IE")][0].split(": ")[1])


def _aepe(a, b):
    _, _, u1, v1 = flo.read_flo(str(a))
    _, _, u2, v2 = flo.read_flo(str(b))
    return float(np.sqrt((u1 - u2) ** 2 + (v1 - v2) ** 2).mean())


@pytest.mark.usefixtures("no_repo_cache")
def test_cli_matches_jax_cli(frames, tmp_path):
    outs = {}
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        d = tmp_path / name
        d.mkdir()
        rc = main(_argv(frames, *FOTO_ARGS, *SMALL, "--precision=f64",
                        f"--out={d}/flow.flo", f"--save-benchmark={d}/b.txt",
                        f"--checkpoint={d}/state.npz"))
        assert rc == 0
        outs[name] = d
    port, jax = outs["port"], outs["jax"]
    np.testing.assert_allclose(_ie(port / "b.txt"), _ie(jax / "b.txt"),
                               rtol=1e-4)
    assert _aepe(port / "flow.flo", jax / "flow.flo") < 1e-3
    with np.load(port / "state.npz") as a, np.load(jax / "state.npz") as b:
        assert int(a["iteration"]) == int(b["iteration"]) > 1
        assert a["phi"].dtype == b["phi"].dtype == np.float64
    w, h, u, _ = flo.read_flo(str(port / "flow.flo"))
    assert (w, h) == (24, 20) and np.isfinite(u).all()


def test_pallas_stepA_on_cpu_matches_dct(frames, tmp_path):
    """The pallas ops set runs its plain fused pass on the CPU and gives
    the dct set's flow."""
    for name in ("dct", "pallas"):
        rc = cli.main(_argv(frames, *FOTO_ARGS, *SMALL,
                            f"--stepA-solver={name}",
                            f"--out={tmp_path}/{name}.flo"))
        assert rc == 0
    assert _aepe(tmp_path / "dct.flo", tmp_path / "pallas.flo") < 1e-3


def test_cli_writes_all_foto_artifacts(frames, tmp_path, capsys):
    gt = tmp_path / "gt.flo"
    flo.write_flo(24, 20, np.ones(480), np.full(480, 2.0), str(gt))
    rc = cli.main(_argv(frames, "--algo=foto", "--Nt=4", "--max-it=5",
                        "--reg-epsilon=1e-2", "--stepA-solver=dct",
                        f"--ground-truth={gt}",
                        f"--out={tmp_path}/f.flo",
                        f"--save-benchmark={tmp_path}/b.txt",
                        f"--save-reconstruction={tmp_path}/rec.pgm",
                        f"--save-lum={tmp_path}/lum.pgm"))
    assert rc == 0
    txt = (tmp_path / "b.txt").read_text()
    assert txt.startswith("EE-mean: ") and "IE: " in txt and "time: " in txt
    assert image.read_pgm(str(tmp_path / "rec.pgm")).shape == (20, 24)
    assert image.read_pgm(str(tmp_path / "lum.pgm")).shape == (20, 24)
    out = capsys.readouterr().out
    # CPU tensors never launch a kernel
    line = [ln for ln in out.splitlines()
            if ln.startswith("kernel_launches=")]
    counts = dict(kv.split(":") for kv in line[0].split("=")[1].split(","))
    assert set(counts) == {"fused_pointwise", "dct_solve",
                           "project_paraboloid", "cg_operator",
                           "cg_operator_blocked"}
    assert set(counts.values()) == {"0"} and "iterations=5" in out


def test_lambda_prefix_and_parser_surface():
    """Quirk 4: --lambda resolves to --lambdaa; the parser is the JAX one's
    apart from the --platform choices."""
    args = cli.build_parser().parse_args(["a", "b", "--lambda=0.7"])
    assert args.lambdaa == 0.7
    ours = {a.dest for a in cli.build_parser()._actions}
    theirs = {a.dest for a in jax_cli.build_parser()._actions}
    assert ours == theirs


def test_default_platform_is_cuda():
    assert cli.build_parser().parse_args(["a", "b"]).platform == "cuda"


@pytest.mark.parametrize("algo", ["sinkhorn", "bogus"])
def test_other_algos_exit_nonzero(frames, algo, capsys):
    assert cli.main(_argv(frames, f"--algo={algo}")) == 2
    err = capsys.readouterr().err
    assert ("slice" in err) if algo != "bogus" else ("unknown" in err)


@pytest.mark.parametrize("flag", ["--profile=p", "--log-jsonl=l.jsonl",
                                  "--save-flow-viz=v.png",
                                  "--save-density-frames=d"])
def test_jax_only_outputs_exit_nonzero(frames, flag, capsys):
    assert cli.main(_argv(frames, "--algo=foto", flag)) == 2
    assert "not ported" in capsys.readouterr().err


@pytest.mark.parametrize("algo", ["foto", "WFR"])
@pytest.mark.parametrize("solver,twin", [("dct-fused", "dct"),
                                         ("cg-pallas", "cg")])
def test_kernel_stepA_sets_run_from_cli(frames, tmp_path, algo, solver,
                                        twin):
    """The dct-fused and cg-pallas sets run their plain versions on the CPU
    and give the flow of the set they stand in for."""
    for name in (twin, solver):
        rc = cli.main(_argv(frames, f"--algo={algo}", "--Nt=4", "--max-it=6",
                            "--reg-epsilon=1e-2", "--admm-alpha=1.7",
                            f"--stepA-solver={name}",
                            f"--out={tmp_path}/{name}.flo"))
        assert rc == 0
    assert _aepe(tmp_path / f"{twin}.flo", tmp_path / f"{solver}.flo") < 1e-3


@pytest.mark.parametrize("solver", ["auto", "pallas", "dct-fused",
                                    "cg-pallas"])
def test_fused_kernel_set_rejects_f64_on_cuda(frames, solver, capsys):
    """On cuda these sets run a float32-only kernel: f64 exits 2 before any
    device is touched, so this holds with or without a card."""
    argv = [str(frames / "f0.pgm"), str(frames / "f1.pgm"), "--quiet",
            "--algo=foto", "--precision=f64", f"--stepA-solver={solver}"]
    assert cli.main(argv) == 2
    assert "float32" in capsys.readouterr().err


def test_wfr_auto_rejects_f64_on_cuda(frames, capsys):
    """WFR's auto is the pallas set on cuda (the fused kernel at 4
    components), so f64 exits 2 there too."""
    argv = [str(frames / "f0.pgm"), str(frames / "f1.pgm"), "--quiet",
            "--algo=WFR", "--precision=f64"]
    assert cli.main(argv) == 2
    assert "float32" in capsys.readouterr().err


@pytest.mark.usefixtures("no_repo_cache")
def test_wfr_cli_matches_jax_cli(frames, tmp_path, capsys):
    """--algo=WFR at WFR_ARGS (Nt and max-it cut): the same iterations, IE
    and flow as the JAX CLI, the combined luminosity in the m slot, and the
    growth field written."""
    outs = {}
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        d = tmp_path / name
        d.mkdir()
        rc = main(_argv(frames, *WFR_ARGS, *SMALL, "--precision=f64",
                        f"--out={d}/flow.flo", f"--save-benchmark={d}/b.txt",
                        f"--checkpoint={d}/state.npz",
                        f"--save-lum={d}/lum.pgm",
                        f"--save-growth={d}/growth.pgm"))
        assert rc == 0
        outs[name] = d
    port, jax = outs["port"], outs["jax"]
    np.testing.assert_allclose(_ie(port / "b.txt"), _ie(jax / "b.txt"),
                               rtol=1e-4)
    assert _aepe(port / "flow.flo", jax / "flow.flo") < 1e-3
    with np.load(port / "state.npz") as a, np.load(jax / "state.npz") as b:
        assert int(a["iteration"]) == int(b["iteration"]) > 1
        assert a["mu"].shape[0] == b["mu"].shape[0] == 4
    for img in ("lum.pgm", "growth.pgm"):
        ours = image.read_pgm(str(port / img)).astype(int)
        theirs = image.read_pgm(str(jax / img)).astype(int)
        assert ours.shape == (20, 24)
        # 8-bit quantization of fields that agree to ~1e-10
        assert np.abs(ours - theirs).max() <= 1, img
    out = capsys.readouterr().out
    assert "algorithm: WFR" in out and "delta=2.5" in out


def test_wfr_cli_prints_distance_and_created_mass(frames, capsys):
    assert cli.main([str(frames / "f0.pgm"), str(frames / "f1.pgm"),
                     "--platform=cpu", "--algo=WFR", "--Nt=4",
                     "--max-it=3", "--reg-epsilon=1e-2"]) == 0
    out = capsys.readouterr().out
    assert "WFR(rho0, rhoT) = " in out and "created mass = " in out
    assert "stepA_solver=dct" in out


@pytest.mark.usefixtures("no_repo_cache")
def test_resume_from_jax_checkpoint(frames, tmp_path):
    """A state the JAX CLI saved resumes in the port's CLI and continues
    where it left off."""
    common = ["--algo=foto", "--Nt=4", "--reg-epsilon=1e-2",
              "--convergence-tol=0", "--stepA-solver=dct"]
    assert jax_cli.main(_argv(frames, *common, "--max-it=3",
                              f"--checkpoint={tmp_path}/jax.npz")) == 0
    assert cli.main(_argv(frames, *common, "--max-it=6",
                          f"--resume={tmp_path}/jax.npz",
                          f"--checkpoint={tmp_path}/port.npz",
                          f"--out={tmp_path}/resumed.flo")) == 0
    assert cli.main(_argv(frames, *common, "--max-it=6",
                          f"--out={tmp_path}/straight.flo")) == 0
    with np.load(tmp_path / "port.npz") as z:
        assert int(z["iteration"]) == 6
        assert z["phi"].dtype == np.float32
    assert _aepe(tmp_path / "resumed.flo", tmp_path / "straight.flo") < 1e-3


@pytest.fixture(scope="module")
def big_frames(tmp_path_factory):
    """A 64x72 pair: three pyramid levels (64x72, 32x36, 16x18)."""
    d = tmp_path_factory.mktemp("big_frames")
    f1, f2 = fixtures.smooth_blob_pair(64, 72, shift=(3.0, 2.0))
    image.save_grayscale(f1, str(d / "f0.pgm"))
    image.save_grayscale(f2, str(d / "f1.pgm"))
    return d


def _solver_line(out):
    line = [ln for ln in out.splitlines() if ln.startswith("solver: ")][0]
    return dict(kv.split("=") for kv in line[len("solver: "):].split())


@pytest.mark.usefixtures("no_repo_cache")
@pytest.mark.parametrize("algo_args,pyramid,precision", [
    (GN_ARGS, False, "f64"), (GN_ARGS, False, "f32"),
    (["--algo=HS", "--alpha=0.1"], False, "f64"),
    (GN_ARGS, True, "f64"), (["--algo=HS"], True, "f64")])
def test_gn_hs_cli_matches_jax_cli(frames, big_frames, tmp_path, capsys,
                                   algo_args, pyramid, precision):
    """GN and HS through both CLIs: the CG step count (the JAX CLI's
    --log-jsonl record; within one at f32), IE, the .flo and the
    luminosity image (0 for HS)."""
    src = big_frames if pyramid else frames
    extra = ["--pyramid-levels=3"] if pyramid else []
    outs = {}
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        d = tmp_path / name
        d.mkdir()
        argv = _argv(src, *algo_args, *extra, f"--precision={precision}",
                     f"--out={d}/flow.flo", f"--save-benchmark={d}/b.txt",
                     f"--save-lum={d}/lum.pgm")
        if name == "jax":
            argv.append(f"--log-jsonl={d}/log.jsonl")
        assert main(argv) == 0
        outs[name] = d
    stats = _solver_line(capsys.readouterr().out)
    port, jax = outs["port"], outs["jax"]
    record = json.loads((jax / "log.jsonl").read_text().splitlines()[-1])
    assert stats["converged"] == "True"
    if pyramid:
        assert int(stats["pyramid_levels"]) == record["pyramid_levels"] == 3
    else:
        slack = 0 if precision == "f64" else 1
        assert abs(int(stats["inner_iterations"])
                   - record["inner_iterations"]) <= slack
    np.testing.assert_allclose(_ie(port / "b.txt"), _ie(jax / "b.txt"),
                               rtol=1e-4)
    aepe = _aepe(port / "flow.flo", jax / "flow.flo")
    assert aepe < 1e-3
    if algo_args is GN_ARGS and precision == "f64":
        assert aepe < 1e-8
    ours = image.read_pgm(str(port / "lum.pgm")).astype(int)
    theirs = image.read_pgm(str(jax / "lum.pgm")).astype(int)
    assert np.abs(ours - theirs).max() <= 1
    if "--algo=HS" in algo_args:
        assert ours.min() == ours.max()          # m = 0 everywhere


@pytest.mark.usefixtures("no_repo_cache")
def test_dct_refined_cli_matches_jax_cli(frames, tmp_path, capsys):
    outs = {}
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        d = tmp_path / name
        d.mkdir()
        rc = main(_argv(frames, *FOTO_ARGS, *SMALL, "--precision=f64",
                        "--stepA-solver=dct-refined",
                        f"--out={d}/flow.flo", f"--save-benchmark={d}/b.txt",
                        f"--checkpoint={d}/state.npz"))
        assert rc == 0
        outs[name] = d
    port, jax = outs["port"], outs["jax"]
    np.testing.assert_allclose(_ie(port / "b.txt"), _ie(jax / "b.txt"),
                               rtol=1e-4)
    assert _aepe(port / "flow.flo", jax / "flow.flo") < 1e-3
    with np.load(port / "state.npz") as a, np.load(jax / "state.npz") as b:
        assert int(a["iteration"]) == int(b["iteration"]) > 1
        assert int(a["cg_iterations"]) == int(b["cg_iterations"]) \
            == 4 * int(a["iteration"])
    stats = _solver_line(capsys.readouterr().out)
    assert stats["stepA_solver"] == "dct-refined"


@pytest.mark.parametrize("algo", ["GN", "HS"])
def test_gn_hs_print_solver_and_launch_lines(frames, algo, capsys):
    assert cli.main(_argv(frames, f"--algo={algo}")) == 0
    out = capsys.readouterr().out
    stats = _solver_line(out)
    assert set(stats) == {"inner_iterations", "residual", "converged"}
    line = [ln for ln in out.splitlines()
            if ln.startswith("kernel_launches=")][0]
    counts = dict(kv.split(":") for kv in line.split("=")[1].split(","))
    assert set(counts.values()) == {"0"}


@pytest.mark.parametrize("algo", ["GN", "HS"])
def test_gn_hs_f64_pass_the_float32_guard(frames, algo, capsys):
    """GN and HS run no kernel, so f64 on cuda is allowed: without a card
    the run gets past the float32 guard and stops at the device check."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the run would succeed")
    argv = [str(frames / "f0.pgm"), str(frames / "f1.pgm"), "--quiet",
            f"--algo={algo}", "--precision=f64"]
    with pytest.raises(RuntimeError, match="--platform=cpu"):
        cli.main(argv)
    assert "float32" not in capsys.readouterr().err
