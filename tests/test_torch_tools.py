"""The port's tools and reference API against the JAX package's.

``data_diff``, ``create_lum_dataset``, ``normalize_image`` and
``image.mass_normalize_pair_common_max`` must write the JAX tools' pixels
(the same numpy arithmetic on the same 8-bit frames, bitwise);
``print_operators`` must print the JAX tool's text; ``compat`` must agree
with ``ofot_tpu.compat`` on the CPU at tests/test_compat.py's tolerances
(1e-12 for the warp and the trajectory; the solves, both float64, to 1e-8
of their max, a few hundred CG steps summed in another order).

The differentiable layer's two user tools against their JAX twins
(``tools/w2_gradient_flow.py``, ``tools/tune_gn.py``, each run as a
subprocess on the CPU):

  * ``w2_gradient_flow`` at ``--size 24 --steps 3``, float32 as in JAX:
    the JSON S trajectories within 2e-4 relative (measured: 5.1e-5; the
    annealed Sinkhorn solves sum in another order), each strictly
    decreasing;
  * ``tune_gn`` on a 2-sequence 24x20 Middlebury-2 layout written here,
    ``--steps 3``, both float64: the tuned alpha and lambda and every EE
    within 1e-6 relative (CG to rtol 1e-8 on both sides), and the same
    printed table.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import ofot_tpu.compat as jax_compat
from ofot_tpu.cli import create_lum_dataset as jax_lum
from ofot_tpu.cli import data_diff as jax_diff
from ofot_tpu.cli import normalize_image as jax_norm
from ofot_tpu.cli import print_operators as jax_print
from ofot_tpu.utils import image as jax_image

import ofot_tpu_torch.compat as compat
from ofot_tpu_torch.cli import create_lum_dataset, data_diff
from ofot_tpu_torch.cli import normalize_image, print_operators
from ofot_tpu_torch.tools import tune_gn, w2_gradient_flow
from ofot_tpu_torch.utils import flo, image

import fixtures

RNG = np.random.default_rng(93)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small shapes: one intra-op thread, so that the suite's parallel
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def pair(tmp_path):
    f1, f2 = fixtures.smooth_blob_pair(20, 26, shift=(2.0, 1.0))
    f1 = 0.1 + 0.8 * f1 + 0.05 * RNG.random(f1.shape)
    f2 = 0.1 + 0.8 * f2 + 0.05 * RNG.random(f2.shape)
    image.save_grayscale(f1, str(tmp_path / "a.png"))
    image.save_grayscale(f2, str(tmp_path / "b.png"))
    return tmp_path / "a.png", tmp_path / "b.png"


def _pixels(path):
    return image.read_png(str(path))


@pytest.mark.parametrize("same", [False, True],
                         ids=["moving", "identical-frames"])
def test_data_diff_matches_jax(pair, tmp_path, same):
    a, b = pair
    if same:
        b = a
    assert data_diff.main([str(a), str(b), str(tmp_path / "p.png")]) == 0
    assert jax_diff.main([str(a), str(b), str(tmp_path / "j.png")]) == 0
    np.testing.assert_array_equal(_pixels(tmp_path / "p.png"),
                                  _pixels(tmp_path / "j.png"))
    if same:   # static scene: mid-gray, not 0/0 = NaN garbage
        assert np.unique(_pixels(tmp_path / "p.png")).tolist() == [127]


@pytest.mark.parametrize("seed", [0, 12345, 31337])
def test_create_lum_dataset_matches_jax(pair, tmp_path, seed):
    a, _ = pair
    assert create_lum_dataset.main(
        [str(a), str(tmp_path / "p.png"), str(seed)]) == 0
    assert jax_lum.main([str(a), str(tmp_path / "j.png"), str(seed)]) == 0
    got = _pixels(tmp_path / "p.png")
    np.testing.assert_array_equal(got, _pixels(tmp_path / "j.png"))
    assert not np.array_equal(got, _pixels(a))     # artifacts were added
    f, w, h = image.open_grayscale(str(a))
    np.testing.assert_array_equal(create_lum_dataset.augment(f.copy(), w, h,
                                                             seed),
                                  jax_lum.augment(f.copy(), w, h, seed))


def test_normalize_image_matches_jax(pair, tmp_path):
    a, b = pair
    outs = {}
    for name, tool in (("p", normalize_image), ("j", jax_norm)):
        o1, o2 = tmp_path / f"{name}1.png", tmp_path / f"{name}2.png"
        assert tool.main([str(a), str(b), str(o1), str(o2)]) == 0
        outs[name] = (_pixels(o1), _pixels(o2))
    for got, want in zip(outs["p"], outs["j"]):
        np.testing.assert_array_equal(got, want)
    assert max(o.max() for o in outs["p"]) == 255


def test_mass_normalize_pair_common_max_matches_jax():
    f1, f2 = RNG.random((9, 11)), 3 * RNG.random((9, 11))
    for got, want in zip(image.mass_normalize_pair_common_max(f1, f2),
                         jax_image.mass_normalize_pair_common_max(f1, f2)):
        np.testing.assert_array_equal(got, want)


def test_print_operators_prints_the_jax_text():
    outs = []
    for tool in (print_operators, jax_print):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert tool.main([]) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert outs[0].splitlines()[-1] == "0.0"      # the adjointness probe


def test_densify_is_the_operator():
    a = print_operators.densify(lambda x: 2.0 * x.flip(0), (4,))
    np.testing.assert_array_equal(a, 2.0 * np.eye(4)[::-1])


# ---------------------------------------------------------------- compat

def test_compat_io_matches_jax(pair, tmp_path):
    a, _ = pair
    got, w, h = compat.openGrayscaleImage(str(a))
    want, wj, hj = jax_compat.openGrayscaleImage(str(a))
    assert (w, h) == (wj, hj) and got.shape == (w * h,)
    np.testing.assert_array_equal(got, want)
    u = RNG.standard_normal(35).astype(np.float32)
    v = RNG.standard_normal(35).astype(np.float32)
    compat.saveFlo(7, 5, u, v, str(tmp_path / "p.flo"))
    jax_compat.saveFlo(7, 5, u, v, str(tmp_path / "j.flo"))
    assert (tmp_path / "p.flo").read_bytes() == \
        (tmp_path / "j.flo").read_bytes()
    w, h, u2, v2 = compat.openFlo(str(tmp_path / "j.flo"))
    assert (w, h) == (7, 5)
    np.testing.assert_array_equal(u2, u)
    np.testing.assert_array_equal(v2, v)


@pytest.mark.parametrize("m", ["field", None, "sentinel"])
def test_compat_apply_opticalflow_matches_jax(m):
    h, w = 9, 11
    f1 = RNG.random(h * w)
    u = RNG.uniform(-2, 2, h * w)
    v = RNG.uniform(-2, 2, h * w)
    lum = {"field": RNG.uniform(-0.2, 0.2, h * w), None: None,
           "sentinel": np.array([None])}[m]
    got = compat.apply_opticalflow(f1, u, v, w, h, lum, device="cpu")
    want = jax_compat.apply_opticalflow(f1, u, v, w, h, lum)
    assert got.shape == (h * w,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_compat_metrics_match_jax():
    n = 8 * 7
    u, v, ug, vg = (RNG.uniform(-3, 3, n) for _ in range(4))
    assert compat.EE(7, 8, u, v, ug, vg) == pytest.approx(
        jax_compat.EE(7, 8, u, v, ug, vg), rel=1e-12)
    assert compat.AE(7, 8, u, v, ug, vg) == pytest.approx(
        jax_compat.AE(7, 8, u, v, ug, vg), rel=1e-12)
    a, b = RNG.random(n), RNG.random(n)
    assert compat.IE(7, 8, a, b) == pytest.approx(jax_compat.IE(7, 8, a, b),
                                                  rel=1e-12)


def test_compat_flow_from_potential_and_trajectory_match_jax():
    Nt, Ny, Nx = 4, 6, 7
    phi = RNG.standard_normal(Nt * Ny * Nx)
    got = compat.opticalflow_from_benamoubrenier(phi, Nt, Nx, Ny,
                                                 device="cpu")
    want = jax_compat.opticalflow_from_benamoubrenier(phi, Nt, Nx, Ny)
    for g, w_ in zip(got, want):
        assert g.shape == (Nx * Ny,)
        np.testing.assert_allclose(g, w_, rtol=0, atol=1e-12)
    un = RNG.uniform(-1, 1, (Nt, Nx * Ny))
    vn = RNG.uniform(-1, 1, (Nt, Nx * Ny))
    for x0, y0 in [(0, 0), (3.0, 4.0), (Nx - 1, Ny - 1)]:
        assert compat.reconstructTrajectory(x0, y0, un, vn, Nx, Ny, Nt) == \
            jax_compat.reconstructTrajectory(x0, y0, un, vn, Nx, Ny, Nt)


def test_compat_solve_matches_jax():
    f1, f2 = fixtures.translating_square(18)
    h, w = f1.shape
    kw = dict(r=1.0, convergence_tol=0.15, reg_epsilon=1e-2, max_it=8)
    got = compat.solve(f1.ravel(), f2.ravel(), 4, w, h, **kw, device="cpu")
    want = jax_compat.solve(f1.ravel(), f2.ravel(), 4, w, h, **kw)
    for g, w_ in zip(got, want):
        assert g.shape == (w * h,) and g.dtype == np.float64
        np.testing.assert_allclose(g, w_, rtol=0,
                                   atol=1e-8 * np.abs(w_).max())


def test_compat_gll_matches_jax():
    f1, f2 = fixtures.smooth_blob_pair(10, 12)
    outs = []
    for mod, kw in ((compat, {"device": "cpu"}), (jax_compat, {})):
        c = mod.GLLOpticalFlow(12, 10, **kw)
        c.setAlpha(0.1)
        c.setLambda(0.2)
        outs.append(c.assemble(f1.ravel(), f2.ravel()).process())
    for g, w_ in zip(*outs):
        assert g.shape == (120,)
        np.testing.assert_allclose(g, np.asarray(w_), rtol=0,
                                   atol=1e-8 * np.abs(w_).max())


def test_compat_defaults_to_the_card():
    import inspect
    for fn in (compat.apply_opticalflow,
               compat.opticalflow_from_benamoubrenier, compat.solve):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            compat.apply_opticalflow(np.zeros(4), np.zeros(4), np.zeros(4),
                                     2, 2)


# ------------------------------------------- the differentiable layer's tools

ROOT = Path(__file__).resolve().parents[1]


def _jax_tool(code, *args, timeout=300):
    """Run ``code`` (a script that calls a JAX tool) in a CPU subprocess."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code, *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def _trajectory(text):
    line = [ln for ln in text.splitlines() if ln.startswith("{")][-1]
    rec = json.loads(line)
    assert rec["tool"] == "w2_gradient_flow" and rec["steps"] == 3
    return rec["S_trajectory"]


def test_w2_gradient_flow_matches_jax(tmp_path):
    args = ["--size", "24", "--steps", "3", "--platform", "cpu"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert w2_gradient_flow.main(
            args + ["--out-dir", str(tmp_path)]) == 0
    ours = _trajectory(out.getvalue())
    theirs = _trajectory(_jax_tool(
        "import runpy, sys; sys.argv = ['w2_gradient_flow.py'] + "
        "sys.argv[1:]; runpy.run_path('tools/w2_gradient_flow.py', "
        "run_name='__main__')", *args))
    assert len(ours) == len(theirs) == 4
    np.testing.assert_allclose(ours, theirs, rtol=2e-4)
    assert all(b < a for a, b in zip(ours, ours[1:]))
    labels = [ln.split("=")[0] for ln in out.getvalue().splitlines()[:4]]
    assert labels == [f"step {t:2d}: S " for t in range(3)] + ["final:   S "]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"a_{i:02d}.png" for i in range(4)] + ["target.png"]


# (dy, dx) of each sequence's constant ground-truth flow
TUNE_SHIFTS = {"Blob": (1, 1), "Drift": (0, 2)}


def write_middlebury2(root: Path, h: int = 20, w: int = 24):
    """A Middlebury-2 layout of seeded textures moved by TUNE_SHIFTS, with
    the constant ground truth as ``.flo`` (u = dx, v = dy)."""
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:h + 8, 0:w + 8]
    for name, (dy, dx) in TUNE_SHIFTS.items():
        tex = sum(rng.uniform(0.05, 0.15) * np.cos(
            rng.uniform(0.2, 0.6) * yy + rng.uniform(0.2, 0.6) * xx
            + rng.uniform(0, 6.3)) for _ in range(4)) + 0.5
        f1 = tex[4:4 + h, 4:4 + w]
        f2 = tex[4 - dy:4 - dy + h, 4 - dx:4 - dx + w]
        seq = root / "middlebury-2" / "other-data-gray" / name
        gt = root / "middlebury-2" / "other-gt-flow" / name
        seq.mkdir(parents=True)
        gt.mkdir(parents=True)
        image.save_grayscale(f1, str(seq / "frame10.png"))
        image.save_grayscale(f2, str(seq / "frame11.png"))
        flo.write_flo(w, h, np.full(h * w, float(dx)),
                      np.full(h * w, float(dy)), str(gt / "flow10.flo"))
    return root


# the JAX tool with optax.apply_updates and metrics.EE wrapped, so that
# its tuned parameters and EE come back at full precision
JAX_TUNE = """
import importlib.util, json, sys
sys.path.insert(0, '.')
import optax
from ofot_tpu.utils import metrics
thetas, ees = [], []
apply, ee = optax.apply_updates, metrics.EE
def recording_apply(p, u):
    out = apply(p, u)
    thetas.append([float(v) for v in out])
    return out
def recording_ee(*a):
    r = ee(*a)
    ees.append(r[0])
    return r
optax.apply_updates, metrics.EE = recording_apply, recording_ee
spec = importlib.util.spec_from_file_location('tune_gn', 'tools/tune_gn.py')
tool = importlib.util.module_from_spec(spec)
spec.loader.exec_module(tool)
sys.argv = ['tune_gn.py'] + sys.argv[1:]
assert tool.main() == 0
print('RESULT ' + json.dumps(dict(theta=thetas[-1], ees=ees)))
"""


def test_tune_gn_matches_jax(tmp_path):
    root = write_middlebury2(tmp_path)
    args = ["--data-root", str(root), "--steps", "3", "--platform", "cpu"]
    jax_out = _jax_tool(JAX_TUNE, *args)
    rec = json.loads(jax_out.split("RESULT ")[1])
    names, groups = tune_gn.load_groups(str(root / "middlebury-2"), "cpu")
    assert names == sorted(TUNE_SHIFTS) and len(groups) == 1
    res = tune_gn.tune(groups, names, 3, 0.15, "cpu")
    np.testing.assert_allclose([res["alpha"], res["lambda_"]],
                               np.exp(rec["theta"]), rtol=1e-6)
    np.testing.assert_allclose(res["ee_default"] + res["ee_tuned"],
                               rec["ees"], rtol=1e-6)
    assert res["losses"][-1] < res["losses"][0]
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        assert tune_gn.main(args) == 0
    ours = out.getvalue().splitlines()
    theirs = jax_out.split("RESULT ")[0].splitlines()
    assert len(ours) == len(theirs) == 2 + len(names)
    assert [ln.split()[0] for ln in ours] == [ln.split()[0]
                                              for ln in theirs]


def test_tools_refuse_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        w2_gradient_flow.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tune_gn.main(["--data-root", str(write_middlebury2(tmp_path))])
