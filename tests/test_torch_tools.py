"""The port's tools and reference API against the JAX package's.

``data_diff``, ``create_lum_dataset``, ``normalize_image`` and
``image.mass_normalize_pair_common_max`` must write the JAX tools' pixels
(the same numpy arithmetic on the same 8-bit frames, bitwise);
``print_operators`` must print the JAX tool's text; ``compat`` must agree
with ``ofot_tpu.compat`` on the CPU at tests/test_compat.py's tolerances
(1e-12 for the warp and the trajectory; the solves, both float64, to 1e-8
of their max, a few hundred CG steps summed in another order).
"""

import contextlib
import io

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
from ofot_tpu_torch.utils import image

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
