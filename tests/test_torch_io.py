"""The port's host I/O (.flo, PGM, images) and metrics vs ofot_tpu.

Inputs come from a numpy seed and go to both packages.  The host modules
are numpy code in both, so results must be byte- or bit-identical."""

import numpy as np
import pytest
from PIL import Image

from ofot_tpu.utils import flo as jax_flo
from ofot_tpu.utils import image as jax_image
from ofot_tpu.utils import metrics as jax_metrics
from ofot_tpu_torch.utils import flo, image, metrics

RNG = np.random.default_rng(2024)


@pytest.mark.parametrize("h,w", [(6, 7), (1, 5), (13, 4)])
def test_flo_byte_parity(tmp_path, h, w):
    """The port writes byte-identical .flo files (float64 input)."""
    u = RNG.standard_normal(h * w)
    v = RNG.standard_normal(h * w)
    ours, theirs = tmp_path / "a.flo", tmp_path / "b.flo"
    flo.write_flo(w, h, u, v, str(ours))
    jax_flo.write_flo(w, h, u, v, str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()


def test_flo_read_parity(tmp_path):
    h, w = 5, 9
    u = RNG.standard_normal(h * w).astype(np.float32)
    v = RNG.standard_normal(h * w).astype(np.float32)
    p = tmp_path / "c.flo"
    jax_flo.write_flo(w, h, u, v, str(p))
    w2, h2, u2, v2 = flo.read_flo(str(p))
    w3, h3, u3, v3 = jax_flo.read_flo(str(p))
    assert (w2, h2) == (w3, h3) == (w, h)
    np.testing.assert_array_equal(u2, u3)
    np.testing.assert_array_equal(v2, v3)
    np.testing.assert_array_equal(u2, u)


def _flows(n=400, outliers=True):
    u, v = RNG.uniform(-5, 5, n), RNG.uniform(-5, 5, n)
    ug, vg = RNG.uniform(-5, 5, n), RNG.uniform(-5, 5, n)
    if outliers:
        u[:7] += 80.0          # EE > 50: dropped by both
    return u, v, ug, vg


@pytest.mark.parametrize("outliers", [False, True])
def test_endpoint_error_parity(outliers):
    u, v, ug, vg = _flows(outliers=outliers)
    assert metrics.EE(20, 20, u, v, ug, vg) == \
        jax_metrics.EE(20, 20, u, v, ug, vg)


def test_endpoint_error_drops_outliers_and_uses_population_std():
    u = np.array([0.0, 0.0, 100.0])
    zero = np.zeros(3)
    v = np.array([1.0, 3.0, 0.0])
    mean, std = metrics.EE(3, 1, u, v, zero, zero)
    assert mean == 2.0 and std == 1.0      # population std of (1, 3)


def test_angular_error_parity_with_nan_drop():
    u, v, ug, vg = _flows(outliers=False)
    # points whose arccos argument rounds outside [-1, 1] give NaN in both
    u[:3], v[:3], ug[:3], vg[:3] = 1e8, 1e8, 1e8, 1e8
    assert metrics.AE(20, 20, u, v, ug, vg) == \
        jax_metrics.AE(20, 20, u, v, ug, vg)


def test_all_dropped_gives_nan():
    u = np.full(4, 100.0)
    z = np.zeros(4)
    assert all(np.isnan(metrics.EE(2, 2, u, z, z, z)))


def test_interpolation_error_parity():
    a, b = RNG.random((12, 9)), RNG.random((12, 9))
    assert metrics.IE(9, 12, a, b) == jax_metrics.IE(9, 12, a, b)


def _gray(h, w):
    return RNG.integers(0, 256, (h, w), dtype=np.uint8)


@pytest.mark.parametrize("h,w", [(7, 11), (24, 24), (1, 3)])
def test_pgm_read_matches_pil(tmp_path, h, w):
    """A P5 file written by Pillow reads back as PIL's convert('L')."""
    p = tmp_path / "f.pgm"
    Image.fromarray(_gray(h, w), "L").save(p)
    want = np.asarray(Image.open(p).convert("L"))
    np.testing.assert_array_equal(image.read_pgm(str(p)), want)
    field, w2, h2 = image.open_grayscale(str(p))
    assert (w2, h2) == (w, h) and field.dtype == np.float64
    np.testing.assert_array_equal(field, want.astype(np.float64) / 255.0)


def test_pgm_header_comments_and_whitespace(tmp_path):
    arr = _gray(3, 4)
    p = tmp_path / "c.pgm"
    p.write_bytes(b"P5 # made by hand\n# another comment\n4\t3\n255\n"
                  + arr.tobytes())
    np.testing.assert_array_equal(image.read_pgm(str(p)), arr)
    np.testing.assert_array_equal(np.asarray(Image.open(p).convert("L")),
                                  arr)


@pytest.mark.parametrize("header", [b"P2\n2 2\n255\n", b"P5\n2 2\n65535\n",
                                    b"P5\n2 2\n"])
def test_pgm_rejects_what_it_cannot_read(tmp_path, header):
    p = tmp_path / "bad.pgm"
    p.write_bytes(header + b"\x00" * 8)
    with pytest.raises(ValueError):
        image.read_pgm(str(p))


def test_save_grayscale_pgm_matches_jax_quantization(tmp_path):
    """The port's PGM writer and the JAX package's PNG writer quantize
    alike (clip, then uint8(255*x)), and Pillow reads the PGM."""
    field = RNG.uniform(-0.2, 1.2, (9, 13))
    image.save_grayscale(field, str(tmp_path / "a.pgm"))
    jax_image.save_grayscale(field, str(tmp_path / "b.png"))
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "a.pgm").convert("L")),
        np.asarray(Image.open(tmp_path / "b.png").convert("L")))


def test_png_goes_through_pil_like_jax(tmp_path):
    p = tmp_path / "f.png"
    Image.fromarray(_gray(10, 6), "L").save(p)
    ours, w, h = image.open_grayscale(str(p))
    theirs, w2, h2 = jax_image.open_grayscale(str(p))
    assert (w, h) == (w2, h2) == (6, 10)
    np.testing.assert_array_equal(ours, theirs)


def test_mass_normalize_parity():
    a, b = RNG.random((5, 6)), RNG.random((5, 6))
    for x, y in zip(image.mass_normalize(a, b),
                    jax_image.mass_normalize(a, b)):
        np.testing.assert_array_equal(x, y)
