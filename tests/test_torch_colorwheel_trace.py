"""The port's colorwheel (``utils/colorwheel.py``), PNG writer
(``utils/image.py``) and trace helpers (``utils/trace.py``) on the CPU,
against the JAX package's.

The numpy color functions are copies and must give the same uint8 pixels.
``compute_color_torch`` is bitwise-equal to ``compute_color`` given the
same float32 hue; the hue itself comes from each library's float32
``atan2``, and numpy's SIMD ``arctan2`` and torch's differ by 1-2 ulps on
about a third of random inputs (numpy's and XLA's ``compute_color_jax``
differ alike).  Where that moves a value across an 8-bit truncation
boundary the pixel differs by one level: on uniform random flows about one
channel value in 230,000.  So on random flows the tests allow a
one-level difference exactly at pixels whose hues differ, and nowhere
else.
"""

import json

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from PIL import Image

from ofot_tpu.utils import colorwheel as jcw
from ofot_tpu.utils import flo as jflo
from ofot_tpu.utils import image as jimage
from ofot_tpu.utils import trace as jtrace
from ofot_tpu_torch.utils import colorwheel, flo, image, trace

RNG = np.random.default_rng(61)

# the published-algorithm probes of tests/test_colorwheel.py
GOLDEN_PROBES = [
    ((1.0, 0.0), (255, 0, 0)),
    ((-1.0, 0.0), (0, 209, 255)),
    ((0.0, 0.0), (255, 255, 255)),
    ((0.5, 0.0), (255, 127, 127)),
    ((0.0, 1.0), (255, 229, 0)),
]


def _random_flow(h=48, w=64, scale=1.5):
    return (RNG.uniform(-scale, scale, (h, w)),
            RNG.uniform(-scale, scale, (h, w)))


def _numpy_hue(u, v):
    u = np.asarray(u, np.float32)
    v = np.asarray(v, np.float32)
    return np.sqrt(u * u + v * v), np.arctan2(-v, -u) / np.pi


def _assert_hue_explains(got, want, u, v):
    """got == want except, by one level, where torch's float32 hue differs
    from numpy's."""
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1
    _, a_np = _numpy_hue(u, v)
    a_t = (torch.atan2(-torch.as_tensor(v, dtype=torch.float32),
                       -torch.as_tensor(u, dtype=torch.float32))
           / np.pi).numpy()
    assert not (diff.any(-1) & (a_np == a_t)).any()


def test_wheel_is_the_jax_wheel():
    np.testing.assert_array_equal(colorwheel.make_colorwheel(),
                                  jcw.make_colorwheel())
    assert colorwheel.NCOLS == jcw.NCOLS == 55
    assert colorwheel.UNKNOWN_FLOW_THRESH == jcw.UNKNOWN_FLOW_THRESH


@pytest.mark.parametrize("scale", [0.0, 0.7, 1.5, 40.0])
def test_compute_color_matches_jax_numpy(scale):
    u, v = _random_flow(scale=scale)
    np.testing.assert_array_equal(colorwheel.compute_color(u, v),
                                  jcw.compute_color(u, v))


def test_golden_probes_numpy_and_torch():
    for (u, v), want in GOLDEN_PROBES:
        got = colorwheel.compute_color(np.array([[u]]), np.array([[v]]))
        np.testing.assert_array_equal(got[0, 0], want)
        got = colorwheel.compute_color_torch(torch.tensor([[u]]),
                                             torch.tensor([[v]]))
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got[0, 0].numpy(), want)


@pytest.mark.parametrize("scale", [0.0, 0.7, 1.5, 40.0])
def test_torch_twin_is_bitwise_given_the_hue(scale):
    """Everything after the hue (the wheel index, the float64
    interpolation, desaturation and dimming, the uint8 truncation) is
    bitwise numpy's."""
    u, v = _random_flow(scale=scale)
    rad, a = _numpy_hue(u, v)
    got = colorwheel._wheel_color(torch.from_numpy(rad), torch.from_numpy(a))
    np.testing.assert_array_equal(got.numpy(),
                                  colorwheel.compute_color(u, v))


@pytest.mark.parametrize("scale", [0.7, 1.5])
def test_torch_twin_matches_numpy_and_jax(scale):
    u, v = _random_flow(240, 320, scale)
    got = colorwheel.compute_color_torch(torch.from_numpy(u),
                                         torch.from_numpy(v)).numpy()
    assert got.shape == (240, 320, 3)
    _assert_hue_explains(got, colorwheel.compute_color(u, v), u, v)
    theirs = np.asarray(jcw.compute_color_jax(jnp.asarray(u, jnp.float32),
                                              jnp.asarray(v, jnp.float32)))
    assert np.abs(got.astype(int) - theirs.astype(int)).max() <= 1
    assert (got != theirs).mean() < 1e-4


def test_torch_twin_zero_flow_is_white():
    got = colorwheel.compute_color_torch(torch.zeros(4, 5), torch.zeros(4, 5))
    assert (got == 255).all()


@pytest.mark.parametrize("case", ["random", "zero", "unknown", "nan",
                                  "maxmotion"])
def test_motion_to_color_matches_jax(case):
    u, v = _random_flow(24, 30, 3.0)
    maxmotion = None
    if case == "zero":
        u, v = np.zeros_like(u), np.zeros_like(v)
    elif case == "unknown":
        u[0, :3] = 2e9
        v[5, 7] = -3e9
    elif case == "nan":
        u[2, 2] = np.nan
        v[3, 4] = np.nan
    elif case == "maxmotion":
        maxmotion = 1.0
    ours = colorwheel.motion_to_color(u, v, maxmotion)
    theirs = jcw.motion_to_color(u, v, maxmotion)
    np.testing.assert_array_equal(ours[0], theirs[0])
    assert ours[1] == theirs[1] and ours[2] == theirs[2]
    if case in ("unknown", "nan"):
        bad = ~np.isfinite(u) | ~np.isfinite(v) | (np.abs(u) > 1e9) \
            | (np.abs(v) > 1e9)
        assert (ours[0][bad] == 0).all()
    if case == "zero":
        assert ours[1] == 1.0 and (ours[0] == 255).all()


def test_motion_to_color_rejects_empty_flow():
    with pytest.raises(ValueError, match="empty"):
        colorwheel.motion_to_color(np.zeros((0, 3)), np.zeros((0, 3)))


def test_flow_to_png_matches_jax(tmp_path):
    h, w = 12, 17
    u, v = _random_flow(h, w, 4.0)
    u[0, 0] = 2e9
    fp = tmp_path / "t.flo"
    flo.write_flo(w, h, u.ravel(), v.ravel(), str(fp))
    ours = colorwheel.flow_to_png(str(fp), str(tmp_path / "ours.png"),
                                  quiet=False)
    theirs = jcw.flow_to_png(str(fp), str(tmp_path / "theirs.png"))
    assert ours == theirs
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "ours.png")),
        np.asarray(Image.open(tmp_path / "theirs.png")))


def test_cli_main(tmp_path, capsys):
    fp = tmp_path / "t.flo"
    jflo.write_flo(4, 3, np.ones(12), np.zeros(12), str(fp))
    out = tmp_path / "t.png"
    assert colorwheel.cli_main(["-quiet", str(fp), str(out)]) == 0
    want, _, _ = jcw.motion_to_color(np.ones((3, 4)), np.zeros((3, 4)))
    np.testing.assert_array_equal(np.asarray(Image.open(out)), want)
    assert colorwheel.cli_main([str(fp), str(out), "2.5"]) == 0
    assert "max motion" in capsys.readouterr().out
    want, _, _ = jcw.motion_to_color(np.ones((3, 4)), np.zeros((3, 4)), 2.5)
    np.testing.assert_array_equal(np.asarray(Image.open(out)), want)
    assert colorwheel.cli_main([]) == 1
    assert "usage" in capsys.readouterr().err


# ----------------------------------------------------------- PNG writer

@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (240, 320), (5, 9, 3),
                                   (240, 320, 3)])
def test_png_writer_decodes_to_the_same_pixels(tmp_path, shape):
    arr = RNG.integers(0, 256, shape, dtype=np.uint8)
    p = tmp_path / "a.png"
    image.write_png(arr, str(p))
    img = Image.open(p)
    assert img.mode == ("L" if len(shape) == 2 else "RGB")
    np.testing.assert_array_equal(np.asarray(img), arr)


def test_png_writer_rejects_other_shapes(tmp_path):
    with pytest.raises(ValueError):
        image.write_png(np.zeros((2, 3, 4), np.uint8), str(tmp_path / "a.png"))


def test_save_grayscale_png_matches_jax(tmp_path):
    field = RNG.uniform(-0.2, 1.2, (9, 13))
    image.save_grayscale(field, str(tmp_path / "ours.png"))
    jimage.save_grayscale(field, str(tmp_path / "theirs.png"))
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "ours.png")),
        np.asarray(Image.open(tmp_path / "theirs.png")))


def test_save_rgb_other_formats_go_through_pillow(tmp_path):
    rgb = RNG.integers(0, 256, (6, 8, 3), dtype=np.uint8)
    image.save_rgb(rgb, str(tmp_path / "a.bmp"))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.bmp")),
                                  rgb)


# ---------------------------------------------------------------- trace

def test_jsonl_logger_matches_jax(tmp_path):
    records = []
    for name, logger_cls in (("ours", trace.JsonlLogger),
                             ("theirs", jtrace.JsonlLogger)):
        p = tmp_path / f"{name}.jsonl"
        log = logger_cls(str(p))
        log.log("solve", algo="foto", wall_s=1.5)
        log.log("solve", algo="GN", wall_s=0.1)
        records.append([json.loads(ln) for ln in p.read_text().splitlines()])
    ours, theirs = records
    assert len(ours) == 2
    for a, b in zip(ours, theirs):
        assert list(a) == list(b)
        assert {k: a[k] for k in a if k != "ts"} \
            == {k: b[k] for k in b if k != "ts"}


def test_jsonl_logger_noop(tmp_path):
    trace.JsonlLogger(None).log("x", a=1)
    trace.JsonlLogger("").log("x", a=1)
    assert not list(tmp_path.iterdir())


def test_profile_writes_a_trace(tmp_path):
    d = tmp_path / "prof"
    with trace.profile(str(d)):
        with trace.annotate("stepA"):
            torch.ones(64).sum()
    files = list(d.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "stepA" for e in events)


def test_profile_none_is_a_noop():
    with trace.profile(None):
        torch.ones(4).sum()
    with trace.annotate("x"):
        pass
