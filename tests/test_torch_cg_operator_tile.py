"""The tile form of the CG stepA operator (``cg_operator_tile``) and the
tiled ``cg-pallas`` set, on the CPU.

A seeded (4, 8, 12) field is split into tiles along y and x, evenly as a
(2, 2), (1, 4) or (4, 1) mesh splits it, and unevenly with tiles one line
wide at the global edges and in the middle.  Fields of their own shape
give the tile shapes the CUDA kernel's index scheme treats apart: corner,
edge and inner tiles of 3x3 splits with tx not a multiple of 4 (its
4-point groups), Nt = 2 with a tile one row wide under a line, and odd
Nt (3, 5).  Each tile goes through the
plain tile operator with the lines next to it (None on a global edge); put
back together, the tiles are bitwise ``cg_operator_reference`` of the
whole field, at float32 and float64.  At float32 they also lie within
1e-5 of the Pallas kernel ``cg_operator_pallas_blocked`` in interpret mode
(tests/test_pallas.py's bound, as tests/test_torch_cg_operator.py holds
the whole-field entry points).

The CUDA kernel is held bitwise against the whole-field kernel on the card
in tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ofot_tpu.ops.pallas import kernels
from ofot_tpu_torch.ops.kernels import cg_operator as cgk
from ofot_tpu_torch.parallel import gspmd
from ofot_tpu_torch.parallel.halo import Tiled
from ofot_tpu_torch.solvers import foto

FIELD = np.random.default_rng(53).standard_normal((4, 8, 12))
# (field shape, y cuts, x cuts)
SPLITS = {
    "2x2": (FIELD.shape, (0, 4, 8), (0, 6, 12)),
    "1x4": (FIELD.shape, (0, 8), (0, 3, 6, 9, 12)),
    "4x1": (FIELD.shape, (0, 2, 4, 6, 8), (0, 12)),
    "one-line edges": (FIELD.shape, (0, 1, 7, 8), (0, 1, 5, 6, 11, 12)),
    "one-line middle": (FIELD.shape, (0, 3, 4, 8), (0, 5, 6, 12)),
    "3x3, tx 7 and 8": ((3, 9, 22), (0, 3, 6, 9), (0, 7, 14, 22)),
    "3x3, tx 4 and 8, Nt 5": ((5, 12, 16), (0, 4, 8, 12), (0, 4, 12, 16)),
    "Nt 2, ty 1 under a line": ((2, 8, 12), (0, 1, 4, 8), (0, 6, 12)),
    "Nt 5, tx 5 and 9": ((5, 10, 14), (0, 5, 10), (0, 5, 14)),
}


def field(shape):
    """FIELD, or a seeded field of another shape."""
    if shape == FIELD.shape:
        return FIELD
    return np.random.default_rng(sum(shape)).standard_normal(shape)


def tiles(f, ys, xs):
    """Each tile of ``f`` between the cuts, with its (up, down, left,
    right) lines cut from the whole field (None on a global edge)."""
    _, ny, nx = f.shape
    for a, b in zip(ys, ys[1:]):
        for c, d in zip(xs, xs[1:]):
            lines = (f[:, a - 1, c:d] if a > 0 else None,
                     f[:, b, c:d] if b < ny else None,
                     f[:, a:b, c - 1] if c > 0 else None,
                     f[:, a:b, d] if d < nx else None)
            yield ((slice(None), slice(a, b), slice(c, d)),
                   f[:, a:b, c:d].contiguous(),
                   tuple(None if h is None else h.contiguous()
                         for h in lines))


def assembled(f, ys, xs, r, eps):
    out = torch.full_like(f, float("nan"))
    for where, t, halos in tiles(f, ys, xs):
        out[where] = cgk.cg_operator_tile(t, halos, r, eps)
    return out


@pytest.mark.parametrize("split", sorted(SPLITS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("r,eps", [(1.0, 1e-2), (0.7, 1e-3)])
def test_tiles_assemble_to_the_whole_field_bitwise(split, dtype, r, eps):
    shape, ys, xs = SPLITS[split]
    f = torch.from_numpy(field(shape)).to(dtype)
    got = assembled(f, ys, xs, r, eps)
    assert torch.equal(got, cgk.cg_operator_reference(f, r, eps))


@pytest.fixture
def _interpret_mode(monkeypatch):
    real_call = pl.pallas_call

    def patched(*a, **kw):
        kw.setdefault("interpret", True)
        return real_call(*a, **kw)

    monkeypatch.setattr(kernels.pl, "pallas_call", patched)


@pytest.mark.usefixtures("_interpret_mode")
@pytest.mark.parametrize("split", ["2x2", "one-line edges",
                                   "one-line middle", "3x3, tx 7 and 8",
                                   "3x3, tx 4 and 8, Nt 5",
                                   "Nt 2, ty 1 under a line",
                                   "Nt 5, tx 5 and 9"])
def test_tiles_match_the_pallas_kernel(split):
    shape, ys, xs = SPLITS[split]
    x = field(shape).astype(np.float32)
    got = assembled(torch.from_numpy(x), ys, xs, 0.7, 1e-3)
    want = np.asarray(kernels.cg_operator_pallas_blocked(jnp.asarray(x),
                                                         0.7, 1e-3))
    assert float(np.abs(got.numpy() - want).max()) < 1e-5


def test_cpu_tiles_take_the_plain_version_without_counting():
    f = torch.from_numpy(FIELD)
    where, t, halos = next(tiles(f, *SPLITS["2x2"][1:]))
    before = (cgk.launches, cgk.blocked_launches, cgk.tile_launches)
    got = cgk.cg_operator_tile(t, halos, 1.0, 1e-2)
    assert torch.equal(got, cgk.cg_operator_tile_reference(t, halos, 1.0,
                                                           1e-2))
    assert (cgk.launches, cgk.blocked_launches, cgk.tile_launches) == before


def test_other_devices_raise():
    x = torch.zeros(3, 4, 5, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        cgk.cg_operator_tile(x, (None,) * 4, 1.0, 1e-2)


@pytest.mark.parametrize("halos,match", [
    ((torch.zeros(4, 4), None, None, None), "halo up has shape"),
    ((None, None, torch.zeros(4, 6), None), "halo left has shape"),
    ((None, None, None), r"\(up, down, left, right\)"),
])
def test_bad_halos_raise(halos, match):
    with pytest.raises(ValueError, match=match):
        cgk.cg_operator_tile(torch.zeros(4, 5, 6), halos, 1.0, 1e-2)


def test_a_one_line_tile_needs_a_line_on_that_axis():
    with pytest.raises(ValueError, match="one line wide"):
        cgk.cg_operator_tile(torch.zeros(4, 1, 6), (None,) * 4, 1.0, 1e-2)
    got = cgk.cg_operator_tile(torch.zeros(4, 1, 6),
                               (torch.ones(4, 6), None, None, None), 1.0,
                               1e-2)
    # the global last row against the line above: -r * (-0 + 1)
    assert torch.equal(got, torch.full((4, 1, 6), -1.0))


class _LoneMesh:
    """A mesh of one rank: no neighbour on any side, so every collective
    returns this rank's own values."""
    device = torch.device("cpu")

    @staticmethod
    def size(name):
        return 1

    @staticmethod
    def index(name):
        return 0

    @staticmethod
    def exchange(sends, recvs):
        assert sends == [] and recvs == []
        return []

    @staticmethod
    def all_reduce(t, op=None, group=None):
        return t.clone()

    @staticmethod
    def gather(t):
        return t

    @staticmethod
    def tile(t):
        return torch.as_tensor(t).contiguous()


def test_sharded_ops_maps_cg_pallas_to_the_tile_set():
    """The tiled form of ``cg-pallas`` runs #4's tile form on the halo
    stencils' mesh, on host loops."""
    tiled = gspmd.sharded_ops(foto.stepA_ops("cg-pallas"), _LoneMesh())
    assert type(tiled) is foto.PallasCGOps
    assert isinstance(tiled.form, Tiled) and tiled.host_only
    assert tiled.hooks.cg_operator.__func__ is Tiled._cg_operator_tile
    with pytest.raises(ValueError, match="not a single-pair"):
        gspmd.sharded_ops(foto.lockstep_ops(foto.stepA_ops("cg-pallas")),
                          _LoneMesh())


def test_tile_set_operator_on_a_lone_tile_is_the_whole_operator():
    """On a mesh of one rank every side is a global edge: the tiled set's
    SpMV is the whole-field operator, bitwise."""
    f = torch.from_numpy(FIELD)
    A = gspmd.sharded_ops(foto.stepA_ops("cg-pallas"),
                          _LoneMesh()).cg_operator(0.7, 1e-3)
    assert torch.equal(A(f), cgk.cg_operator_reference(f, 0.7, 1e-3))
