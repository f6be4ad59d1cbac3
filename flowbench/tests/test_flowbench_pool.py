"""The traffic pool: the same for a seed, other lum artefacts and order
for another seed, and the copied generators equal to the originals."""

import importlib.util
import random
from pathlib import Path

import numpy as np
import pytest

from flowbench.traffic import generator

ROOT = Path(__file__).resolve().parents[2]
SMALL = dict(width=40, height=30, translation_scale=0.5,
             texture_seeds=[100, 200], lum_share=0.5, lum_seed=12345,
             batch=1)


def _stream(seed, n, size=28):
    it = generator.order(seed, size)
    return [next(it) for _ in range(n)]


def test_stream_identical_for_one_seed_and_other_for_another():
    assert _stream(2 ** 31 + 11, 60) == _stream(2 ** 31 + 11, 60)
    assert _stream(5, 60) != _stream(6, 60)
    # each run of the pool is a permutation: every seed sends the same work
    for seed in (5, 2 ** 31 + 11):
        s = _stream(seed, 56)
        assert sorted(s[:28]) == sorted(s[28:]) == list(range(28))


def test_pool_is_the_traffic_files_alone():
    a, b = generator.make_pool(SMALL), generator.make_pool(SMALL)
    assert [p.name for p in a] == [p.name for p in b]
    for p, q in zip(a, b):
        assert np.array_equal(p.f1, q.f1) and np.array_equal(p.f2, q.f2)
    assert len(a) == 28 and sum(p.lum for p in a) == 14
    c = generator.make_pool(dict(SMALL, lum_seed=7))
    for p, q in zip(a, c):
        assert np.array_equal(p.f2, q.f2) != p.lum  # lum pairs differ


def test_lum_seeds_follow_the_pipeline():
    """The pipeline draws each sequence's augmentation seed from one
    random.Random(--lum-seed), in sequence order."""
    rnd = random.Random(12345)
    pool = generator.make_pool(SMALL)
    first = next(p for p in pool if p.lum)
    f10, f11 = generator.render_pair(
        generator.texture(100), *generator.motions(40, 30, 0.5)[0][1:], 40,
        30)
    g11 = generator.quantize(generator.augment(
        generator.quantize(f11), 40, 30, rnd.randint(0, 32767)))
    a, b = generator.mass_normalize_pair_common_max(
        generator.quantize(f10), g11)
    assert np.array_equal(first.f2, generator.quantize(b).astype(np.float32))


def test_frames_are_8_bit_and_normalised():
    for p in generator.make_pool(SMALL):
        for f in (p.f1, p.f2):
            assert f.dtype == np.float32 and f.shape == (30, 40)
            assert np.allclose(np.round(f.astype(np.float64) * 255),
                               f.astype(np.float64) * 255, atol=1e-4)
        assert max(p.f1.max(), p.f2.max()) <= 1.0


def test_augment_matches_the_port():
    from ofot_tpu_torch.cli import create_lum_dataset
    rng = np.random.default_rng(0)
    f = rng.uniform(0, 1, (48, 64))
    for seed in (0, 12345, 32767):
        want = create_lum_dataset.augment(f.copy(), 64, 48, seed)
        got = generator.augment(f.copy(), 64, 48, seed)
        assert np.array_equal(got, want)
    random.seed(None)


def test_normalisation_matches_the_port():
    from ofot_tpu_torch.utils import image
    rng = np.random.default_rng(1)
    f1, f2 = rng.uniform(0, 1, (2, 30, 40))
    for got, want in zip(generator.mass_normalize_pair_common_max(f1, f2),
                         image.mass_normalize_pair_common_max(f1, f2)):
        assert np.array_equal(got, want)


def test_quantize_matches_the_port_png_round_trip(tmp_path):
    from ofot_tpu_torch.utils import image
    f = np.random.default_rng(2).uniform(-0.1, 1.1, (12, 16))
    path = str(tmp_path / "f.png")
    image.save_grayscale(f, path)
    back, _, _ = image.open_grayscale(path)
    assert np.array_equal(generator.quantize(f), back)


def test_scenes_match_the_synthetic_dataset_tool():
    spec = importlib.util.spec_from_file_location(
        "make_synthetic_middlebury",
        ROOT / "tools" / "make_synthetic_middlebury.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    for (name, A, b), (name2, A2, b2) in zip(
            generator.motions(40, 30, 0.5), tool.motions(40, 30, 0.5)):
        assert name == name2
        assert np.array_equal(A, A2) and np.array_equal(b, b2)
        f10, f11 = generator.render_pair(generator.texture(7), A, b, 40, 30)
        g10, g11, _, _ = tool.render_pair(tool.texture(7), A2, b2, 40, 30)
        assert np.array_equal(f10, g10) and np.array_equal(f11, g11)


def test_lum_share_must_be_a_half_or_all_or_nothing():
    with pytest.raises(ValueError):
        generator.make_pool(dict(SMALL, lum_share=0.3))
