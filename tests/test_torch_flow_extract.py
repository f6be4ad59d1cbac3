"""The flow extraction's one entry (``solvers.flow_extract``) and its CUDA
kernels' design (``ops/kernels/flow_extract.py``, ``csrc/flow_extract.cu``).

On the CPU ``flow_from_potential`` takes the plain path, a (B, Nt, Ny, Nx)
batch pair by pair, and launches nothing; the CUDA wrapper refuses a
tensor that is not on the card before it builds anything.  The kernels'
arithmetic, one start pixel at a time with each corner's velocity formed
from phi as it is gathered, is written out below in numpy (each float
operation rounded on its own, as the kernels' ``__f*_rn`` spell it) and
must be bitwise the plain path, on potentials whose trajectories leave
the grid, hit the clamp and carry offsets outside [0, 1).  The kernels
themselves are held bitwise against the plain path on the card in
tests/test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import torch

from ofot_tpu_torch.ops import kernels
from ofot_tpu_torch.ops.kernels import _build
from ofot_tpu_torch.ops.kernels import flow_extract as fk
from ofot_tpu_torch.parallel import sweep
from ofot_tpu_torch.solvers import flow_extract

RNG = np.random.default_rng(71)
DTYPES = [torch.float32, torch.float64]
# Nt 2, 3 and 16 on 2x2, 3x3 and 33x47 frames
SHAPES = [(nt, ny, nx) for nt in (2, 3, 16)
          for ny, nx in ((2, 2), (3, 3), (33, 47))]
# drifts of up to 0.2 px a step, and of up to 3 px: trajectories that
# leave the grid, hit the clamp and carry offsets outside [0, 1)
SCALES = [0.2, 3.0]


def potential(shape, dtype, scale, batch=None):
    """A random potential: a drift of up to ``scale`` px a step in each
    slice, plus noise."""
    lead = () if batch is None else (batch,)
    Nt, Ny, Nx = shape
    y, x = np.mgrid[0:Ny, 0:Nx]
    drift = RNG.uniform(-1, 1, lead + (Nt, 1, 1)) * x \
        + RNG.uniform(-1, 1, lead + (Nt, 1, 1)) * y
    phi = scale * drift + 0.1 * RNG.standard_normal(lead + shape)
    return torch.from_numpy(phi).to(dtype)


def kernel_model(phi: np.ndarray):
    """The kernels' arithmetic in numpy on one (Nt, Ny, Nx) potential:
    every start pixel's trajectory with x, y carried over the Nt - 1
    steps, the velocities of the four corners formed from phi (+0 on a
    boundary row or column), the sample ((w1 a + w2 b) + w3 c) + w4 d; then
    m = -(gx + gy) with a +0 Dirichlet neighbour."""
    Nt, Ny, Nx = phi.shape
    T = phi.dtype.type
    zero, one, half = T(0), T(1), T(0.5)
    iy, ix = np.divmod(np.arange(Ny * Nx), Nx)
    x0, y0 = ix.astype(phi.dtype), iy.astype(phi.dtype)
    x, y = x0.copy(), y0.copy()

    def cell(c, n):
        return np.clip(np.trunc(c).astype(np.int64), 0, n - 2)

    for n in range(Nt - 1):
        p = phi[n]

        def at(r, c):
            return p[np.clip(r, 0, Ny - 1), np.clip(c, 0, Nx - 1)]

        def diff(nxt, prv, zeroed):
            return np.where(zeroed, zero, (nxt - prv) * half)

        tx, ty = cell(x, Nx), cell(y, Ny)
        dx, dy = x - tx.astype(phi.dtype), y - ty.astype(phi.dtype)
        ex, ey = one - dx, one - dy
        w1, w2, w3, w4 = ey * ex, dx * ey, dy * dx, ex * dy
        left, right = tx == 0, tx + 1 == Nx - 1
        top, bottom = ty == 0, ty + 1 == Ny - 1
        u00 = diff(at(ty, tx + 1), at(ty, tx - 1), left)
        u01 = diff(at(ty, tx + 2), at(ty, tx), right)
        u11 = diff(at(ty + 1, tx + 2), at(ty + 1, tx), right)
        u10 = diff(at(ty + 1, tx + 1), at(ty + 1, tx - 1), left)
        v00 = diff(at(ty + 1, tx), at(ty - 1, tx), top)
        v01 = diff(at(ty + 1, tx + 1), at(ty - 1, tx + 1), top)
        v11 = diff(at(ty + 2, tx + 1), at(ty, tx + 1), bottom)
        v10 = diff(at(ty + 2, tx), at(ty, tx), bottom)
        su = ((w1 * u00 + w2 * u01) + w3 * u11) + w4 * u10
        sv = ((w1 * v00 + w2 * v01) + w3 * v11) + w4 * v10
        x, y = x + su, y + sv
    u, v = (x - x0).reshape(Ny, Nx), (y - y0).reshape(Ny, Nx)
    pad_x = np.zeros((Ny, 1), phi.dtype)
    pad_y = np.zeros((1, Nx), phi.dtype)
    gx = (np.concatenate([u[:, 1:], pad_x], 1)
          - np.concatenate([pad_x, u[:, :-1]], 1)) * half
    gy = (np.concatenate([v[1:], pad_y], 0)
          - np.concatenate([pad_y, v[:-1]], 0)) * half
    return u, v, -(gx + gy)


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


@pytest.fixture
def no_launches():
    kernels.reset_launch_counts()
    yield
    assert kernels.launch_counts()["flow_extract"] == 0


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_arithmetic_is_bitwise_the_plain_path(shape, dtype, scale):
    phi = potential(shape, dtype, scale)
    want = flow_extract.flow_from_potential_reference(phi)
    got = kernel_model(phi.numpy())
    for g, w in zip(got, want):
        assert _same_bits(g, w.numpy())


def test_large_potentials_reach_the_clamp_and_offsets_outside_the_cell():
    """The scaled potentials exercise what the kernels must round as the
    plain path does: displacements past the frame (the clamp) and so
    offsets from the clamped corner outside [0, 1)."""
    shape = (16, 33, 47)
    u, v, _ = flow_extract.flow_from_potential(
        potential(shape, torch.float64, SCALES[-1]))
    x = torch.arange(shape[2], dtype=u.dtype) + u
    y = torch.arange(shape[1], dtype=v.dtype)[:, None] + v
    assert bool((x < 0).any() | (x > shape[2] - 1).any())
    assert bool((y < 0).any() | (y > shape[1] - 1).any())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batched", [False, True])
def test_entry_takes_the_plain_path_on_cpu(no_launches, dtype, batched):
    phi = potential((5, 9, 12), dtype, 3.0, batch=3 if batched else None)
    got = flow_extract.flow_from_potential(phi)
    want = flow_extract.flow_from_potential_reference(phi)
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, w)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(4, 6, 8), (16, 2, 2), (2, 33, 47)])
def test_batched_plain_path_is_the_stacked_single_calls(no_launches, shape,
                                                        dtype):
    phi = potential(shape, dtype, 3.0, batch=4)
    got = flow_extract.flow_from_potential(phi)
    assert [tuple(f.shape) for f in got] == [(4,) + shape[1:]] * 3
    for b in range(4):
        for g, w in zip(got, flow_extract.flow_from_potential(phi[b])):
            assert torch.equal(g[b], w)


def test_lockstep_extracts_the_batch_in_one_call(no_launches, monkeypatch):
    """``sweep._flows`` hands the whole (B, Nt, Ny, Nx) potential to the
    one entry (where a planted fault finds it), not B pair slices."""
    calls, real = [], flow_extract.flow_from_potential

    def spy(phi):
        calls.append(tuple(phi.shape))
        return real(phi)

    monkeypatch.setattr(flow_extract, "flow_from_potential", spy)
    phi = potential((4, 6, 8), torch.float32, 3.0, batch=8)
    got = sweep._flows(phi)
    assert calls == [(8, 4, 6, 8)]
    for g, w in zip(got, flow_extract.flow_from_potential_reference(phi)):
        assert torch.equal(g, w)


def test_cuda_wrapper_refuses_other_devices_before_any_build(no_launches):
    phi = potential((3, 4, 5), torch.float32, 1.0)
    with pytest.raises(ValueError, match="cuda"):
        fk.prepare_flow(phi)
    with pytest.raises(ValueError, match="cuda"):
        flow_extract.flow_from_potential(phi.to("meta"))


def test_source_entry_point_kernel_names_and_counter():
    """The C entry the wrapper binds, the kernel names the card's profiler
    test looks for (none that the benchmark's trace readers match for #1),
    and the launch counter in ``KERNELS``."""
    src = (_build.SRC_DIR / "flow_extract.cu").read_text()
    assert "int ofot_flow_extract(" in src
    for kernel in ("flow_trajectories_kernel", "flow_divergence_kernel"):
        assert kernel in src
    assert "fused_pointwise_kernel" not in src
    assert "reduce_partials_kernel" not in src
    assert kernels.KERNELS["flow_extract"] == ("flow_extract", "launches")
    assert fk.LAUNCHES_A_CALL == 2
