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


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The shapes here are small: one intra-op thread, so that the suite's
    parallel workers do not oversubscribe the cores (spinning OpenMP
    threads slowed this file 8x under a loaded run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
                           "cg_operator_blocked", "cg_operator_tile",
                           "stencil_grad_st", "stencil_stepA_rhs",
                           "select_scalars", "latch_fields",
                           "flow_extract", "exact_softmin", "exact_stats"}
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
def test_other_algos_exit_nonzero(frames, tmp_path, algo, capsys):
    """An unknown --algo exits 2; sinkhorn, refused until the port had it,
    now runs and writes its flow."""
    out = tmp_path / "flow.flo"
    rc = cli.main(_argv(frames, f"--algo={algo}", f"--out={out}"))
    if algo == "bogus":
        assert rc == 2 and "unknown" in capsys.readouterr().err
        return
    assert rc == 0
    w, h, u, _ = flo.read_flo(str(out))
    assert (w, h) == (24, 20) and np.isfinite(u).all()


def _artifact(tmp_path, flag):
    """The files a flag leaves, named relative to the run's directory."""
    name = flag.split("=")[1]
    if flag.startswith("--profile"):
        return list((tmp_path / name).glob("*.pt.trace.json"))
    if flag.startswith("--save-density-frames"):
        return sorted((tmp_path / name).glob("rho-*.png"))
    return [tmp_path / name] if (tmp_path / name).exists() else []


@pytest.mark.parametrize("flag", ["--profile=p", "--log-jsonl=l.jsonl",
                                  "--save-flow-viz=v.png",
                                  "--save-density-frames=d"])
def test_jax_only_outputs_exit_nonzero(frames, tmp_path, monkeypatch, flag):
    """The four outputs the port refused until it had them now run with
    rc 0 and leave their artifact (the density frames: one a time step)."""
    monkeypatch.chdir(tmp_path)
    assert cli.main(_argv(frames, "--algo=foto", "--Nt=4", "--max-it=2",
                          flag)) == 0
    files = _artifact(tmp_path, flag)
    assert len(files) == (4 if "density" in flag else 1)


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


# ------------------------------------------- Sinkhorn and the new outputs

# tests/test_cli.py:65-83's run of --algo=sinkhorn
SINKHORN_CLI = ["--algo=sinkhorn", "--max-it=500", "--sinkhorn-epsilon=4.0",
                "--normalize"]
# keys of the solve record that are not a result: the clock, the paths
_NOT_RESULTS = ("ts", "wall_s", "f0", "f1")


@pytest.fixture(scope="module")
def square_frames(tmp_path_factory):
    """tests/test_cli.py's pair: a square moved by (4, 4) px on 24x24."""
    d = tmp_path_factory.mktemp("square")
    f1, f2 = fixtures.translating_square(24)
    image.save_grayscale(f1, str(d / "f0.pgm"))
    image.save_grayscale(f2, str(d / "f1.pgm"))
    return d


def _record(path):
    return json.loads(path.read_text().splitlines()[-1])


def _run_both(src, tmp_path, *args):
    """Both CLIs on the same frames, each in its own directory with a
    .flo, a benchmark file and a JSONL record."""
    outs = {}
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        d = tmp_path / name
        d.mkdir()
        assert main(_argv(src, *args, f"--out={d}/flow.flo",
                          f"--save-benchmark={d}/b.txt",
                          f"--log-jsonl={d}/log.jsonl")) == 0
        outs[name] = d
    return outs["port"], outs["jax"]


@pytest.mark.usefixtures("no_repo_cache")
@pytest.mark.parametrize("extra", [[], ["--precision=f64"],
                                   ["--sinkhorn-stabilizer=exact"]])
def test_sinkhorn_cli_matches_jax_cli(square_frames, tmp_path, extra):
    """--algo=sinkhorn against the JAX CLI: .flo AEPE < 1e-3, the same
    record keys, numbers within 1e-4 relative and iterations within one
    check block (25)."""
    port, jax = _run_both(square_frames, tmp_path, *SINKHORN_CLI, *extra)
    assert _aepe(port / "flow.flo", jax / "flow.flo") < 1e-3
    np.testing.assert_allclose(_ie(port / "b.txt"), _ie(jax / "b.txt"),
                               rtol=1e-4)
    ours, theirs = _record(port / "log.jsonl"), _record(jax / "log.jsonl")
    assert set(ours) == set(theirs)
    assert ours["stabilizer"] == theirs["stabilizer"]
    assert abs(ours["iterations"] - theirs["iterations"]) <= 25
    for key in ("IE", "epsilon", "wasserstein2"):
        np.testing.assert_allclose(ours[key], theirs[key], rtol=1e-4)
    for key in ("marginal_error", "w2_marginal_error"):
        assert ours[key] <= 1e-4 and theirs[key] <= 1e-4
    # the square moves by (4, 4): the plan's barycentric map moves it
    _, _, u, _ = flo.read_flo(str(port / "flow.flo"))
    moving = np.abs(u) > 0.5
    assert moving.any() and abs(u[moving].mean() - 4.0) < 0.5


@pytest.fixture(scope="module")
def corner_frames(tmp_path_factory):
    """tests/test_sinkhorn.py's exp-window pair: a blob moved corner to
    corner on 64x64, whose potential spread is past float32's exp window
    at eps 4."""
    d = tmp_path_factory.mktemp("corner")
    y, x = np.mgrid[0:64, 0:64].astype(np.float64)
    for name, c in (("f0", 8), ("f1", 55)):
        image.save_grayscale(np.exp(-((y - c) ** 2 + (x - c) ** 2) / 18),
                             str(d / f"{name}.pgm"))
    return d


@pytest.mark.usefixtures("no_repo_cache")
def test_sinkhorn_auto_escalates_like_jax_cli(corner_frames, tmp_path,
                                              capsys):
    """Past the matmul softmin's envelope the verified marginal error
    misses the tolerance, and both CLIs re-solve with the exact softmin
    and log the matmul run's error beside the exact run's."""
    port, jax = _run_both(corner_frames, tmp_path, "--algo=sinkhorn",
                          "--max-it=600", "--sinkhorn-epsilon=4.0")
    assert "re-solving with the exactly-stabilized softmin" in \
        capsys.readouterr().out
    ours, theirs = _record(port / "log.jsonl"), _record(jax / "log.jsonl")
    assert set(ours) == set(theirs)
    assert ours["stabilizer"] == theirs["stabilizer"] == "exact"
    assert ours["marginal_error_matmul"] > 0.1
    assert theirs["marginal_error_matmul"] > 0.1
    assert ours["marginal_error"] <= 1e-4
    assert abs(ours["iterations"] - theirs["iterations"]) <= 25
    assert _aepe(port / "flow.flo", jax / "flow.flo") < 1e-3


@pytest.mark.parametrize("frames_name,args", [
    ("corner_frames", ["--max-it=600", "--sinkhorn-epsilon=4.0"]),
    ("square_frames", ["--max-it=500", "--sinkhorn-epsilon=4.0"])],
    ids=["escalating", "matmul"])
def test_sinkhorn_cli_prints_and_logs_the_two_call_sequence(
        frames_name, args, request, tmp_path, capsys):
    """The CLI's Sinkhorn solve (``sinkhorn.solve_fields``) prints the
    lines and logs the record that the sequence it replaced gave: ``flow``
    with the matmul softmin, ``flow`` again with the exact one where the
    marginal error missed tol, m = -div(u, v); its .flo holds that
    sequence's (u, v) bit for bit."""
    from ofot_tpu_torch.ops import operators
    from ofot_tpu_torch.solvers import sinkhorn
    frames = request.getfixturevalue(frames_name)
    log = tmp_path / "log.jsonl"
    assert cli.main(_argv(frames, "--algo=sinkhorn", *args,
                          f"--out={tmp_path}/flow.flo",
                          f"--log-jsonl={log}")) == 0
    out = capsys.readouterr().out.splitlines()

    a, b = (torch.as_tensor(image.open_grayscale(str(frames / n))[0],
                            dtype=torch.float32) for n in ("f0.pgm", "f1.pgm"))
    kw = dict(max_iter=int(args[0].split("=")[1]), tol=1e-4, theta=1.0)
    res = sinkhorn.flow(a, b, 4.0, stabilizer="matmul", **kw)
    want, stab = [], "matmul"
    if not bool(res.marginal_error <= 1e-4):
        want.append(f"  marginal error {float(res.marginal_error):.3g} > "
                    "tol 0.0001 on the matmul-softmin path — re-solving "
                    "with the exactly-stabilized softmin")
        stab, me_matmul = "exact", float(res.marginal_error)
        res = sinkhorn.flow(a, b, 4.0, stabilizer="exact", **kw)
    assert (stab == "exact") == (frames_name == "corner_frames")
    want.append(f"solver: iterations={res.iterations} "
                f"marginal_error={float(res.marginal_error)} "
                f"stabilizer={stab}")
    first = next(i for i, ln in enumerate(out) if ln == want[0])
    assert out[first:first + len(want)] == want

    rec = _record(log)
    assert (rec["iterations"], rec["marginal_error"], rec["stabilizer"]) \
        == (res.iterations, float(res.marginal_error), stab)
    assert ("marginal_error_matmul" in rec) == (stab == "exact")
    if stab == "exact":
        assert rec["marginal_error_matmul"] == me_matmul
    _, _, u, v = flo.read_flo(str(tmp_path / "flow.flo"))
    np.testing.assert_array_equal(u.reshape(res.u.shape), res.u.numpy())
    np.testing.assert_array_equal(v.reshape(res.v.shape), res.v.numpy())
    m = -operators.div2d(res.u, res.v, bc="D")
    fields = sinkhorn.solve_fields(a, b, 4.0, **kw)
    assert torch.equal(fields.m, m)


def test_sinkhorn_f32_envelope_warning(square_frames, capsys):
    """The envelope warning fires only when matmul is pinned at float32
    (tests/test_cli.py:85-108)."""
    run = ["--algo=sinkhorn", "--max-it=100", "--sinkhorn-epsilon=1.0"]
    assert cli.main(_argv(square_frames, *run,
                          "--sinkhorn-stabilizer=matmul")) == 0
    assert "f32 envelope" in capsys.readouterr().err
    assert cli.main(_argv(square_frames, *run)) == 0
    assert "envelope" not in capsys.readouterr().err
    assert cli.main(_argv(square_frames, *run, "--precision=f64")) == 0
    assert "envelope" not in capsys.readouterr().err


def test_sinkhorn_max_iter_warning(square_frames, capsys):
    assert cli.main(_argv(square_frames, "--algo=sinkhorn", "--max-it=2",
                          "--sinkhorn-tol=1e-12")) == 0
    err = capsys.readouterr().err
    assert "marginal error" in err and "--max-it" in err


@pytest.mark.usefixtures("no_repo_cache")
@pytest.mark.parametrize("theta", ["2.0", "0", "-0.5", "2.5"])
def test_sinkhorn_theta_guard_matches_jax_cli(square_frames, theta):
    argv = _argv(square_frames, "--algo=sinkhorn",
                 f"--sinkhorn-theta={theta}")
    with pytest.raises(SystemExit) as ours:
        cli.main(argv)
    with pytest.raises(SystemExit) as theirs:
        jax_cli.main(argv)
    assert str(ours.value) == str(theirs.value)
    assert "outside the convergent range" in str(ours.value)


_FOTO_SHORT = ["--algo=foto", "--Nt=4", "--max-it=3"]
_WFR_SHORT = ["--algo=WFR", "--Nt=4", "--max-it=3"]
_SINKHORN_SHORT = ["--algo=sinkhorn", "--sinkhorn-stabilizer=matmul",
                   "--max-it=300"]


@pytest.mark.usefixtures("no_repo_cache")
@pytest.mark.parametrize("algo_args,quiet", [
    (_FOTO_SHORT, True), (_FOTO_SHORT, False), (_WFR_SHORT, True),
    (_WFR_SHORT, False), (["--algo=GN"], True), (["--algo=HS"], True),
    (["--algo=GN", "--pyramid-levels=2"], True),
    (["--algo=HS", "--pyramid-levels=2"], True),
    (_SINKHORN_SHORT, True), (_SINKHORN_SHORT, False)])
def test_log_jsonl_keys_match_jax_cli(frames, tmp_path, algo_args, quiet):
    """One solve record with the JAX CLI's keys on every path; for the
    paths with diagnostics (W2, the WFR distance), with and without
    --quiet (they are computed for the record)."""
    records = {}
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        log = tmp_path / f"{name}.jsonl"
        argv = [str(frames / "f0.pgm"), str(frames / "f1.pgm"),
                "--platform=cpu", *algo_args, f"--log-jsonl={log}"]
        assert main(argv + (["--quiet"] if quiet else [])) == 0
        lines = log.read_text().splitlines()
        assert len(lines) == 1
        records[name] = json.loads(lines[0])
    ours, theirs = records["port"], records["jax"]
    assert set(ours) == set(theirs)
    assert ours["event"] == "solve" and ours["algo"] == theirs["algo"]
    assert (ours["w"], ours["h"]) == (theirs["w"], theirs["h"]) == (24, 20)
    for key in set(ours) - set(_NOT_RESULTS):
        assert type(ours[key]) is type(theirs[key]), key


@pytest.mark.usefixtures("no_repo_cache")
def test_density_frames_and_flow_viz_match_jax_cli(frames, tmp_path):
    """--save-density-frames and --save-flow-viz on the same float64 FOTO
    run: the same PNG pixels as the JAX CLI's (Pillow decodes both)."""
    from PIL import Image
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        d = tmp_path / name
        assert main(_argv(frames, "--algo=foto", "--Nt=4", "--max-it=5",
                          "--reg-epsilon=1e-2", "--stepA-solver=dct",
                          "--precision=f64", f"--save-density-frames={d}",
                          f"--save-flow-viz={d}/viz.png")) == 0
    port, jax = tmp_path / "port", tmp_path / "jax"
    names = sorted(p.name for p in jax.glob("rho-*.png"))
    assert names == sorted(p.name for p in port.glob("rho-*.png"))
    assert len(names) == 4
    for n in names + ["viz.png"]:
        ours, theirs = Image.open(port / n), Image.open(jax / n)
        assert ours.mode == theirs.mode == ("RGB" if n == "viz.png" else "L")
        np.testing.assert_array_equal(np.asarray(ours), np.asarray(theirs),
                                      err_msg=n)


def test_profile_trace_names_the_solver_ops(frames, tmp_path):
    assert cli.main(_argv(frames, "--algo=sinkhorn",
                          f"--profile={tmp_path}/p")) == 0
    (path,) = (tmp_path / "p").glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}
    assert "aten::matmul" in names and "aten::exp" in names
