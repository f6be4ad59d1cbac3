"""The port's CLI (``ofot_tpu_torch.cli.main``) on the CPU vs the JAX CLI.

Both CLIs read the same small PGM pair and run the sweep's FOTO_ARGS
(cli/pipeline.py:61-63) with Nt and max-it cut down, at --precision=f64.
Tolerances: IE rtol 1e-4 and the .flo AEPE between the two outputs
< 1e-3, the bounds tests/test_cli.py holds its own backends to, and the
same ALG2 iteration count.
"""

import numpy as np
import pytest

from ofot_tpu.cli import main as jax_cli
from ofot_tpu.cli.pipeline import FOTO_ARGS
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
    # CPU tensors never launch the kernel
    assert "kernel_launches=0" in out and "iterations=5" in out


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


@pytest.mark.parametrize("algo", ["GN", "HS", "WFR", "sinkhorn", "bogus"])
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


@pytest.mark.parametrize("solver", ["dct-refined", "dct-fused", "cg-pallas"])
def test_later_stepA_solvers_exit_nonzero(frames, solver, capsys):
    assert cli.main(_argv(frames, "--algo=foto",
                          f"--stepA-solver={solver}")) == 2
    assert "slice" in capsys.readouterr().err


@pytest.mark.parametrize("solver", ["auto", "pallas"])
def test_fused_kernel_set_rejects_f64_on_cuda(frames, solver, capsys):
    """On cuda the pallas set runs the float32-only kernel: f64 exits 2
    before any device is touched, so this holds with or without a card."""
    argv = [str(frames / "f0.pgm"), str(frames / "f1.pgm"), "--quiet",
            "--algo=foto", "--precision=f64", f"--stepA-solver={solver}"]
    assert cli.main(argv) == 2
    assert "float32" in capsys.readouterr().err


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
