"""The port's CUDA kernels against their plain torch versions, on the card
(marker ``cuda``; skipped without one).

This file imports neither JAX nor ``ofot_tpu``, so it runs where the card
is, without the repository's conftest (which sets JAX up):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

Tolerances:
  * the fused pass and the projection take cbrtf/acosf where the plain
    versions take the Pallas kernels' exp/log and Newton forms, and nvcc
    fuses multiply-adds, so elementwise agreement is atol 2e-5 / rtol 1e-5
    (a few hundred float32 ulps on O(1) values); the criterion sums agree
    to rtol 1e-5 (the same float32 products summed in another order);
  * the stepA operator: 1e-5 absolute, the bound tests/test_pallas.py holds
    the Pallas operator to (the same stencil, fused multiply-adds);
  * the spectral solve: 5e-6 relative to max|phi|, tests/test_pallas.py's
    bound for the Pallas solve (the same float32 products, summed in
    another order, divided by eigenvalues down to r*eps).
Every kernel's repeat launches are bitwise-equal (fixed summation orders).
The GN, HS and GN-pyramid solves, which run no kernel, are held on the
card against the same solves on the CPU, and so are fixed-iteration
Sinkhorn solves (both stabilizers) and the device color wheel.  The
sweep's map mode is held bitwise against single-pair solves on the card,
and a tiny pipeline run must write every artifact, with one fused-kernel
launch per FOTO and WFR ALG2 iteration; a Sinkhorn solve of the sweep
that misses its tolerance is re-solved at float64 on the card.  An
all-NaN flow warps to NaN pixels on the card, with no device-side assert.
The shapes of the stepA operator and the spectral solve cover their tile
edges and both copy widths (16-byte copies where a row is 16-byte aligned,
4-byte copies otherwise).  The tile form of the stepA operator, on the
tiles of (2, 2), (1, 4), (4, 1), (1, 2), (2, 1) and (3, 3) splits, of
splits with tiles one line wide, Nt = 2 and odd Nt, put together, is
bitwise the whole-field kernel, on both its paths (4 x points a thread
where tx % 4 == 0, one point otherwise); its C entry refuses a tile of
2^31 points or more before any launch.

The solver loops run on the device loop by default on the card (captured
graphs of K iterations, ``solvers/device_loop.py``): each is held bitwise
against its host loop, a host read inside a captured body raises, and
wherever a test counted one launch an iteration it holds the replay
relation instead: launches = warm-up launches + replayed launches,
replayed launches = the slots of the replays, and iterations <= slots <=
iterations + (K - 1) a loop.  The device loop's own two kernels (the
per-pair scalars' select and the latch of a stopped pair's fields) are
bitwise their plain versions at the loops' shapes, launch once each an
iteration slot of every while loop, and leave no ``where`` kernel in a
replayed FOTO block.

The flow extraction's kernels (``ops/kernels/flow_extract.py``) are
bitwise the plain path on random potentials (Nt 2, 3 and 16; frames 2x2,
3x3 and 33x47, 320x240 and 640x480; float32 and float64; drifts that
leave the grid) and on potentials solved from the benchmark's pools; a
batch of 8 is one call, bitwise its 8 single calls; every call launches
``LAUNCHES_A_CALL`` kernels, and a FOTO solve's extraction runs no
``index``, ``trunc`` or ``clamp`` op.

The exact softmin's kernels (``ops/kernels/exact_softmin.py``) agree with
the plain path to the tolerances stated above their tests (float32 and
float64; 240x320, 320x240 and 194x292; a potential past the matmul
softmin's exp window); a batch of 3 is one call, bitwise its single calls;
an exact solve on the device loop launches them inside its graphs the
number of times its blocks imply, bitwise its host loop; and an escalated
pair of the benchmark's pool solved on them is as close to float64 as on
the plain path.
"""

import functools

import numpy as np
import pytest
import torch

from ofot_tpu_torch.ops.kernels import cg_operator as cgk
from ofot_tpu_torch.ops.kernels import dct_solve as ds
from ofot_tpu_torch.ops.kernels import fused_pointwise as fp
from ofot_tpu_torch.ops.kernels import projection as pk

RNG = np.random.default_rng(37)


def _reset_counts():
    from ofot_tpu_torch.ops import kernels
    from ofot_tpu_torch.solvers import device_loop
    kernels.reset_launch_counts()
    device_loop.reset_stats()


# the device loop's own kernels (ops/kernels/loop_mask.py): one launch
# each an iteration slot of every while loop's block
LOOP_MASK = ("select_scalars", "latch_fields")


def _assert_loop_mask_relation(launches):
    """The device loop's two mask kernels: launches = warm-up launches +
    replayed launches, replayed launches = the slots of the replays that
    launched them, and the latch's = ``stats.latch_slots``."""
    from ofot_tpu_torch.solvers import device_loop
    s = device_loop.stats
    for kernel in LOOP_MASK:
        replayed = s.graph_launches.get(kernel, 0)
        assert launches[kernel] == s.eager_launches.get(kernel, 0) \
            + replayed, kernel
        assert replayed == s.kernel_slots.get(kernel, 0), kernel
        assert s.eager_launches.get(kernel, 0) <= s.captures, kernel
    assert s.graph_launches.get("latch_fields", 0) == s.latch_slots


# the exact softmin's kernels (ops/kernels/exact_softmin.py): a Sinkhorn
# solve launches them at its verify, and at every iteration of the exact
# stabilizer, so their count follows the stages and blocks a solve ran
SOFTMIN = ("exact_softmin", "exact_stats")


def _assert_launch_relation(launches, expect, extractions=0,
                            softmins=False):
    """The device loop's launch relation for each kernel of ``expect``
    (kernel -> the iterations that launch it once each) and for its own
    mask kernels, the flow extraction's kernels launched by
    ``extractions`` calls (one a pair, or one a lockstep batch), with
    ``softmins`` (a run that solved Sinkhorn) whole calls of the exact
    softmin, at least its verify's, and no launch of any other kernel."""
    from ofot_tpu_torch.ops.kernels import exact_softmin as ek
    from ofot_tpu_torch.ops.kernels import flow_extract as fk
    from ofot_tpu_torch.solvers import device_loop
    s = device_loop.stats
    assert launches["flow_extract"] == fk.LAUNCHES_A_CALL * extractions
    if softmins:
        assert launches["exact_softmin"] >= 2 * ek.LAUNCHES_A_CALL
        for kernel in SOFTMIN:
            assert launches[kernel] % ek.LAUNCHES_A_CALL == 0, kernel
    for kernel, iterations in expect.items():
        replayed = s.graph_launches.get(kernel, 0)
        assert launches[kernel] == s.eager_launches.get(kernel, 0) \
            + replayed, kernel
        assert replayed == s.kernel_slots.get(kernel, 0), kernel
        assert iterations <= replayed <= iterations + s.kernel_spare.get(
            kernel, 0), kernel
    _assert_loop_mask_relation(launches)
    assert sum(launches.values()) == sum(
        launches[k] for k in {*expect, *LOOP_MASK, "flow_extract",
                              *(SOFTMIN if softmins else ())})


def _pallas_launches(foto_iterations, wfr_iterations=0):
    """The kernels an ALG2 iteration of the ``pallas`` set launches once
    each: #1 and the gradient in FOTO and WFR, stepA's right-hand side in
    FOTO (WFR forms its own)."""
    both = foto_iterations + wfr_iterations
    return {"fused_pointwise": both, "stencil_grad_st": both,
            "stencil_stepA_rhs": foto_iterations}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(ncomp, shape, relaxed, device):
    full = (ncomp,) + shape
    arrs = [RNG.uniform(-2, 2, full), RNG.uniform(-1, 2, full),
            RNG.uniform(-2, 1, full) if relaxed else None]
    return [None if a is None else
            torch.from_numpy(a.astype(np.float32)).to(device) for a in arrs]


def _assert_close(got, want):
    for a, b, name in zip(got[:2], want[:2], ("q", "mu")):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=1e-5, msg=name)
    for a, b, name in zip(got[2:], want[2:], ("num", "den")):
        torch.testing.assert_close(a, b, atol=0, rtol=1e-5, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("ncomp", [3, 4])
@pytest.mark.parametrize("alpha", [None, 1.7])
def test_kernel_matches_plain_version_on_card(cuda_device, ncomp, alpha):
    t = _inputs(ncomp, (16, 48, 64), alpha is not None, cuda_device)
    before = fp.launches
    got = fp.fused_pointwise(t[0], t[1], 1.3, alpha=alpha, q_prev=t[2])
    again = fp.fused_pointwise(t[0], t[1], 1.3, alpha=alpha, q_prev=t[2])
    torch.cuda.synchronize()
    assert fp.launches == before + 2
    want = fp.fused_pointwise_reference(t[0], t[1], 1.3, alpha, t[2])
    _assert_close(got, want)
    # the two-stage reduction is deterministic
    assert torch.equal(got[2], again[2]) and torch.equal(got[3], again[3])


@pytest.mark.cuda
def test_kernel_rejects_bad_operands_on_card(cuda_device):
    g = torch.zeros(3, 4, 5, 6, device=cuda_device)
    with pytest.raises(TypeError):
        fp.fused_pointwise(g.double(), g.double(), 1.0)
    with pytest.raises(ValueError):
        fp.fused_pointwise(g, g.transpose(-1, -2).contiguous().transpose(
            -1, -2), 1.0)
    with pytest.raises(ValueError):
        fp.fused_pointwise(torch.zeros(2, 4, device=cuda_device),
                           torch.zeros(2, 4, device=cuda_device), 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("ncomp", [3, 4])
def test_projection_matches_plain_version_on_card(cuda_device, ncomp):
    p = torch.from_numpy(RNG.uniform(-4, 3, (ncomp, 5, 17, 23)).astype(
        np.float32)).to(cuda_device)
    before = pk.launches
    got = pk.project_paraboloid(p)
    again = pk.project_paraboloid(p)
    torch.cuda.synchronize()
    assert pk.launches == before + 2
    torch.testing.assert_close(got, pk.project_paraboloid_reference(p),
                               atol=2e-5, rtol=1e-5)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 17, 23), (4, 48, 40), (2, 2, 2),
                                   (17, 33, 131), (16, 240, 320)])
def test_cg_operator_matches_plain_version_on_card(cuda_device, shape):
    x = torch.from_numpy(RNG.standard_normal(shape).astype(np.float32)).to(
        cuda_device)
    before = (cgk.launches, cgk.blocked_launches)
    a = cgk.cg_operator(x, 0.7, 1e-3)
    b = cgk.cg_operator_blocked(x, 0.7, 1e-3)
    again = cgk.cg_operator(x, 0.7, 1e-3)
    torch.cuda.synchronize()
    assert (cgk.launches, cgk.blocked_launches) == (before[0] + 2,
                                                    before[1] + 1)
    want = cgk.cg_operator_reference(x, 0.7, 1e-3)
    assert float((a - want).abs().max()) < 1e-5
    assert torch.equal(a, b) and torch.equal(a, again)


@pytest.mark.cuda
def test_cg_operator_takes_an_unaligned_field_on_card(cuda_device):
    """A contiguous view 4 bytes past a 16-byte boundary, with Nx % 4 == 0,
    runs the one-point-a-thread kernel, which gives the same bits as the
    four-points-a-thread kernel on an aligned copy."""
    shape = (4, 48, 40)
    n = int(np.prod(shape))
    buf = torch.from_numpy(RNG.standard_normal(n + 1).astype(np.float32)).to(
        cuda_device)
    x = buf[1:].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    got = cgk.cg_operator_blocked(x, 1.3, 1e-2)
    want = cgk.cg_operator_reference(x, 1.3, 1e-2)
    assert float((got - want).abs().max()) < 1e-5
    assert torch.equal(got, cgk.cg_operator_blocked(x.clone(), 1.3, 1e-2))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 17, 23), (4, 65, 130), (3, 1, 70),
                                   (16, 240, 320), (3, 63, 129),
                                   (2, 33, 64)])
@pytest.mark.parametrize("r,eps", [(1.0, 1e-2), (0.3, 1e-3)])
def test_dct_solve_matches_plain_version_on_card(cuda_device, shape, r,
                                                 eps):
    F = torch.from_numpy(RNG.standard_normal(shape).astype(np.float32)).to(
        cuda_device)
    before = ds.launches
    got = ds.dct_solve(F, r, eps)
    again = ds.dct_solve(F, r, eps)
    torch.cuda.synchronize()
    assert ds.launches == before + 2
    want = ds.dct_solve_reference(F, r, eps)
    assert float((got - want).abs().max() / want.abs().max()) < 5e-6
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("r,eps", [(1.0, 1e-2), (0.3, 1e-3)])
def test_dct_solve_keeps_float32_accuracy_against_float64_on_card(
        cuda_device, r, eps):
    """At the sweep shape, over several seeds, the 3xTF32 kernel stays
    within 5e-6 of max|phi| of the float64 solve, as the float32 plain
    version does."""
    for seed in range(4):
        F = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            (16, 240, 320)).astype(np.float32)).to(cuda_device)
        exact = ds.dct_solve_reference(F.double(), r, eps)
        scale = float(exact.abs().max())
        for got in (ds.dct_solve(F, r, eps),
                    ds.dct_solve_reference(F, r, eps)):
            assert float((got.double() - exact).abs().max()) / scale < 5e-6


def _tiles(f, ys, xs):
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


@pytest.mark.cuda
@pytest.mark.parametrize("shape,ys,xs", [
    ((16, 240, 320), (0, 120, 240), (0, 160, 320)),     # 2x2, 4 x a thread
    ((16, 240, 322), (0, 120, 240), (0, 161, 322)),     # 2x2, tx = 161
    ((16, 240, 320), (0, 1, 120, 239, 240), (0, 1, 160, 319, 320)),
    ((5, 17, 23), (0, 17), (0, 6, 12, 18, 23)),         # 1x4
    ((5, 17, 23), (0, 4, 8, 12, 17), (0, 23)),          # 4x1
    ((16, 240, 320), (0, 240), (0, 160, 320)),          # 1x2
    ((16, 240, 320), (0, 120, 240), (0, 320)),          # 2x1
    ((16, 240, 320), (0, 80, 160, 240), (0, 106, 214, 320)),    # 3x3
    ((4, 8, 12), (0, 3, 4, 8), (0, 5, 6, 12)),          # one line between two
    ((3, 9, 22), (0, 3, 6, 9), (0, 7, 14, 22)),         # 3x3, tx 7 and 8
    ((5, 12, 16), (0, 4, 8, 12), (0, 4, 12, 16)),       # 3x3, tx 4 and 8
    ((2, 8, 12), (0, 1, 4, 8), (0, 6, 12)),             # Nt 2, ty 1
    ((5, 10, 14), (0, 5, 10), (0, 5, 14)),              # Nt 5, tx 5 and 9
    ((2, 48, 64), (0, 1, 24, 48), (0, 32, 64)),
    ((5, 24, 36), (0, 11, 12, 24), (0, 12, 36)),
])
def test_cg_operator_tile_assembles_to_the_whole_kernel_on_card(
        cuda_device, shape, ys, xs):
    """The tiles' outputs put together are bitwise the whole-field kernel
    #4; each tile lies within #4's tolerance of its plain version, and
    repeats are bitwise-equal."""
    f = torch.from_numpy(RNG.standard_normal(shape).astype(np.float32)).to(
        cuda_device)
    whole = cgk.cg_operator_blocked(f, 0.7, 1e-3)
    out = torch.full_like(f, float("nan"))
    before, n = cgk.tile_launches, 0
    for where, t, halos in _tiles(f, ys, xs):
        got = cgk.cg_operator_tile(t, halos, 0.7, 1e-3)
        again = cgk.cg_operator_tile(t, halos, 0.7, 1e-3)
        n += 2
        want = cgk.cg_operator_tile_reference(t, halos, 0.7, 1e-3)
        assert float((got - want).abs().max()) < 1e-5
        assert torch.equal(got, again)
        out[where] = got
    torch.cuda.synchronize()
    assert cgk.tile_launches == before + n
    assert torch.equal(out, whole)


@pytest.mark.cuda
def test_cg_operator_tile_refuses_2_31_points_before_any_launch(cuda_device):
    """The C entry takes 32-bit offsets: a tile of 2^31 points or more is
    refused before any launch (null pointers, nothing allocated), and a
    tile of 2^31 - 1 points would pass that check."""
    from ofot_tpu_torch.ops.kernels import _build
    lib = _build.load_library()
    stream = torch.cuda.current_stream().cuda_stream
    for shape in ((2, 32768, 32768), (2, 65536, 16384), (3, 46341, 15447)):
        assert np.prod(shape, dtype=np.int64) >= 2 ** 31
        assert lib.ofot_cg_operator_tile(None, None, *shape, None, None,
                                         None, None, 1.0, 1e-2, stream) == 1
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cg_operator_tile_rejects_bad_operands_on_card(cuda_device):
    x = torch.zeros(3, 4, 8, device=cuda_device)
    row = torch.zeros(3, 8, device=cuda_device)
    with pytest.raises(TypeError):
        cgk.cg_operator_tile(x.double(), (None,) * 4, 1.0, 1e-2)
    with pytest.raises(ValueError, match="contiguous"):
        cgk.cg_operator_tile(torch.zeros(3, 8, 4, device=cuda_device
                                         ).transpose(1, 2), (None,) * 4,
                             1.0, 1e-2)
    with pytest.raises(TypeError):
        cgk.cg_operator_tile(x, (row.double(), None, None, None), 1.0, 1e-2)
    with pytest.raises(ValueError, match="contiguous"):
        cgk.cg_operator_tile(x, (None, None, torch.zeros(
            4, 3, device=cuda_device).t(), None), 1.0, 1e-2)
    with pytest.raises(ValueError, match="halo down has shape"):
        cgk.cg_operator_tile(x, (None, row[:, :7], None, None), 1.0, 1e-2)


@pytest.mark.cuda
def test_new_kernels_reject_bad_operands_on_card(cuda_device):
    x = torch.zeros(3, 4, 5, device=cuda_device)
    with pytest.raises(TypeError):
        cgk.cg_operator(x.double(), 1.0, 1e-2)
    with pytest.raises(ValueError):
        cgk.cg_operator(torch.zeros(1, 4, 5, device=cuda_device), 1.0, 1e-2)
    with pytest.raises(ValueError):
        cgk.cg_operator(x.transpose(1, 2), 1.0, 1e-2)
    with pytest.raises(TypeError):
        ds.dct_solve(x.double(), 1.0, 1e-2)
    with pytest.raises(ValueError):
        pk.project_paraboloid(torch.zeros(5, 4, device=cuda_device))


# The stencil kernels at the sweep's shapes, Nt = 2, Ny = 2, Nx % 4 != 0
# (one point a thread) and an unaligned field (one point a thread too)
STENCIL_SHAPES = [(16, 240, 320), (16, 480, 640), (2, 24, 32), (5, 17, 23),
                  (4, 2, 40), (3, 6, 2)]


def _stencil_inputs(shape, device, batch=None, offset=0):
    """phi, mu, q, rho0, rhoT of ``shape`` (a leading pair axis with
    ``batch``), each starting ``offset`` floats into its storage."""
    lead = () if batch is None else (batch,)

    def field(*s):
        n = int(np.prod(s))
        flat = RNG.uniform(-1, 2, n + offset).astype(np.float32)
        return torch.from_numpy(flat).to(device)[offset:].view(*s)

    return (field(*lead, *shape), field(*lead, 3, *shape),
            field(*lead, 3, *shape), field(*lead, *shape[1:]),
            field(*lead, *shape[1:]))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", STENCIL_SHAPES + ["unaligned"])
@pytest.mark.parametrize("r", [1.0, 0.7])
def test_stencil_kernels_match_plain_versions_on_card(cuda_device, shape, r):
    """grad_st and stepA's right-hand side: bitwise their plain versions,
    and repeat launches bitwise."""
    from ofot_tpu_torch.ops.kernels import stencil_st as ss
    offset = 1 if shape == "unaligned" else 0
    shape = (6, 10, 16) if shape == "unaligned" else shape
    phi, mu, q, a, b = _stencil_inputs(shape, cuda_device, offset=offset)
    got = ss.grad_st(phi)
    assert torch.equal(got, ss.grad_st_reference(phi))
    assert torch.equal(got, ss.grad_st(phi))
    F = ss.stepA_rhs(mu, q, a, b, r)
    assert torch.equal(F, ss.stepA_rhs_reference(mu, q, a, b, r))
    assert torch.equal(F, ss.stepA_rhs(mu, q, a, b, r))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 240, 320), (5, 17, 23)])
@pytest.mark.parametrize("per_pair", [False, True])
def test_batched_stencil_kernels_on_card(cuda_device, shape, per_pair):
    """A lockstep batch of 8 in one launch each: bitwise the plain batched
    versions, and every pair bitwise its single-pair launch."""
    from ofot_tpu_torch.ops.kernels import stencil_st as ss
    phi, mu, q, a, b = _stencil_inputs(shape, cuda_device, batch=8)
    r = (torch.from_numpy(RNG.uniform(0.3, 2.0, 8).astype(np.float32))
         .to(cuda_device) if per_pair else 0.7)
    got = ss.grad_st_batched(phi)
    F = ss.stepA_rhs_batched(mu, q, a, b, r)
    assert torch.equal(got, ss.grad_st_reference(phi, batched=True))
    assert torch.equal(F, ss.stepA_rhs_reference(mu, q, a, b, r,
                                                 batched=True))
    for i in range(8):
        ri = float(r[i]) if per_pair else r
        assert torch.equal(got[i], ss.grad_st(phi[i]))
        assert torch.equal(F[i], ss.stepA_rhs(mu[i], q[i], a[i], b[i], ri))


@pytest.mark.cuda
def test_stencil_kernels_reject_bad_operands_on_card(cuda_device):
    from ofot_tpu_torch.ops.kernels import stencil_st as ss
    phi, mu, q, a, b = _stencil_inputs((4, 6, 8), cuda_device)
    with pytest.raises(TypeError):
        ss.grad_st(phi.double())
    with pytest.raises(TypeError):
        ss.stepA_rhs(mu, q.double(), a, b, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        ss.grad_st(phi.transpose(1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        ss.stepA_rhs(mu, q, a.t().contiguous().t(), b, 1.0)
    for bad in ((1, 6, 8), (4, 1, 8), (4, 6, 1)):
        with pytest.raises(ValueError, match=">= 2"):
            ss.grad_st(torch.zeros(bad, device=cuda_device))
        with pytest.raises(ValueError, match=">= 2"):
            z = torch.zeros((3,) + bad, device=cuda_device)
            ss.stepA_rhs(z, z, z[0, 0], z[0, 0], 1.0)
    with pytest.raises(ValueError, match="rho0 has shape"):
        ss.stepA_rhs(mu, q, a[:, :4].contiguous(), b, 1.0)
    with pytest.raises(ValueError, match="per-pair r"):
        ss.stepA_rhs(mu, q, a, b, torch.ones(2, device=cuda_device))
    with pytest.raises(ValueError, match="bc='N' only"):
        ss.grad_st(phi, bc="D")


def _texture_pair(h, w, shift=(2, 3), sigma=3.0, seed=5):
    """A smooth random texture in [0.1, 0.9] and the same texture moved by
    ``shift`` = (dy, dx) pixels."""
    rng = np.random.default_rng(seed)
    pad = 16
    H, W = h + 2 * pad, w + 2 * pad
    ky = np.fft.fftfreq(H)[:, None]
    kx = np.fft.fftfreq(W)[None, :]
    tex = np.fft.ifft2(np.fft.fft2(rng.standard_normal((H, W))) * np.exp(
        -2 * (np.pi * sigma) ** 2 * (kx ** 2 + ky ** 2))).real
    tex = 0.1 + 0.8 * (tex - tex.min()) / (tex.max() - tex.min())
    dy, dx = shift
    return (tex[pad:pad + h, pad:pad + w],
            tex[pad - dy:pad - dy + h, pad - dx:pad - dx + w])


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["gn", "hs", "gn-pyramid"])
def test_gn_hs_card_match_cpu(cuda_device, solver):
    """GN, HS and the GN pyramid at float32 on the card and on the CPU:
    CG steps within 3 a solve and fields within 1e-4 of their max — both
    run CG to rtol 1e-10 and differ only in summation order (chip_smoke.py
    phase 12's tolerances)."""
    from ofot_tpu_torch.solvers import gn, hs, pyramid
    f1, f2 = _texture_pair(96, 128)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        a, b = (torch.from_numpy(x.astype(np.float32)).to(dev)
                for x in (f1, f2))
        if solver == "gn":
            r = gn.solve_fields(a, b)
            out[dev.type] = ((r.u, r.v, r.m), [r.cg])
        elif solver == "hs":
            r = hs.solve_fields(a, b)
            out[dev.type] = ((r.u, r.v), [r.cg])
        else:
            log = []
            fields = pyramid.solve_gn_pyramid(a, b, levels=3, cg_log=log)
            out[dev.type] = (fields, log)
    (card, card_cg), (cpu, cpu_cg) = out["cuda"], out["cpu"]
    assert card[0].device.type == "cuda"
    assert len(card_cg) == len(cpu_cg)
    for x, y in zip(card_cg, cpu_cg):
        assert x.converged and y.converged
        assert abs(x.iterations - y.iterations) <= 3
    for x, y in zip(card, cpu):
        assert float((x.cpu() - y).abs().max() / y.abs().max()) < 1e-4


@pytest.mark.cuda
def test_refined_stepA_on_card(cuda_device):
    """The refined stepA on an ALG2 right-hand side at the sweep shape:
    TF32 alone is visibly off the float64 solve (6.8e-4 of max|phi| on an
    H100), three refinement steps bring it within 2e-6 (1.3e-7 measured;
    the exact float32 solve is at 2.0e-6), and TF32 is off again after."""
    from ofot_tpu_torch.ops import operators
    from ofot_tpu_torch.solvers import dct, foto
    f1, f2 = _texture_pair(240, 320)
    a, b = (torch.from_numpy(x.astype(np.float32)).to(cuda_device)
            for x in (f1, f2))
    F = operators.div_st(foto.init_state(a, b, 16).mu, bc="N")
    plan = dct.StepAPlan(F.shape, 1.0, 1e-2, F.dtype, F.device)
    exact = dct.solve_stepA_dct(F.double(), 1.0, 1e-2)
    scale = float(exact.abs().max())
    errs = [float((plan.solve_refined(F, k).double() - exact).abs().max())
            / scale for k in range(4)]
    assert errs[0] > 1e-5 and errs[1] < errs[0] and errs[3] < 2e-6, errs
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


@pytest.mark.cuda
@pytest.mark.parametrize("stabilizer", ["matmul", "exact"])
def test_sinkhorn_card_matches_cpu(cuda_device, stabilizer):
    """25 fixed float32 Sinkhorn iterations at 64x80, eps 100, on the card
    and on the CPU: potentials within 2e-4 of their max and the cost
    within 1e-6 relative (chip_smoke.py phase 14's bounds, ~20-50x the
    CPU's own float32-vs-float64 drift), with TF32 off in every product
    even when the caller turned it on."""
    from ofot_tpu_torch.solvers import sinkhorn
    f1, f2 = _texture_pair(64, 80)
    seen, real = [], sinkhorn._matmul

    def recording(x, y):
        if x.is_cuda:
            seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(x, y)

    out = {}
    allow = torch.backends.cuda.matmul.allow_tf32
    try:
        sinkhorn._matmul = recording
        torch.backends.cuda.matmul.allow_tf32 = True
        for dev in (cuda_device, torch.device("cpu")):
            a, b = (torch.from_numpy(x.astype(np.float32)).to(dev)
                    for x in (f1, f2))
            out[dev.type] = sinkhorn.solve(a, b, 100.0, max_iter=25, tol=0.0,
                                           stabilizer=stabilizer)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        sinkhorn._matmul = real
        torch.backends.cuda.matmul.allow_tf32 = allow
    # the exact softmin has no product
    assert not any(seen) and (len(seen) > 0) == (stabilizer == "matmul")
    card, cpu = out["cuda"], out["cpu"]
    assert card.f.device.type == "cuda" and card.iterations == 25
    for x, y in ((card.f, cpu.f), (card.g, cpu.g)):
        assert float((x.cpu() - y).abs().max() / y.abs().max()) < 2e-4
    assert abs(float(card.cost) / float(cpu.cost) - 1) < 1e-6


@pytest.mark.cuda
def test_compute_color_torch_on_card(cuda_device):
    """The device color wheel: bitwise numpy's given numpy's float32 hue;
    with the card's own atan2, off by one level only where the two hues
    round differently."""
    from ofot_tpu_torch.utils import colorwheel
    rng = np.random.default_rng(3)
    u, v = (rng.uniform(-1.5, 1.5, (240, 320)) for _ in range(2))
    want = colorwheel.compute_color(u, v)
    u32, v32 = u.astype(np.float32), v.astype(np.float32)
    rad = torch.from_numpy(np.sqrt(u32 * u32 + v32 * v32)).to(cuda_device)
    hue_np = np.arctan2(-v32, -u32) / np.pi
    given = colorwheel._wheel_color(rad, torch.from_numpy(hue_np).to(
        cuda_device))
    assert given.device.type == "cuda"
    np.testing.assert_array_equal(given.cpu().numpy(), want)
    ut, vt = (torch.from_numpy(x).to(cuda_device) for x in (u, v))
    got = colorwheel.compute_color_torch(ut, vt).cpu().numpy()
    hue_card = (torch.atan2(-vt.float(), -ut.float()) / np.pi).cpu().numpy()
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1
    assert not (diff.any(-1) & (hue_card == hue_np)).any()


def _blob_pairs(n, ny, nx):
    """n smooth blobs, each moved by its own shift, as float32 stacks."""
    y, x = np.mgrid[0:ny, 0:nx].astype(np.float64)

    def blob(cy, cx):
        return np.exp(-(((y - cy) / 6.0) ** 2 + ((x - cx) / 6.0) ** 2))

    shifts = [(2.0, 1.0), (-1.0, 2.0), (1.5, -1.0), (0.5, 0.5)][:n]
    f1s = np.stack([blob(ny / 2, nx / 2) for _ in shifts])
    f2s = np.stack([blob(ny / 2 + dy, nx / 2 + dx) for dy, dx in shifts])
    return f1s.astype(np.float32), f2s.astype(np.float32)


@pytest.mark.cuda
def test_map_mode_bitwise_equals_single_pair_on_card(cuda_device):
    """The sweep's map mode on the card: each pair equals the CLI's
    single-pair solve bitwise, and the fused kernel's launches hold the
    device loop's relation to the batch's ALG2 iterations."""
    from ofot_tpu_torch.ops import kernels
    from ofot_tpu_torch.parallel import sweep
    from ofot_tpu_torch.solvers import foto

    f1s, f2s = _blob_pairs(3, 48, 64)
    params = dict(r=1.0, convergence_tol=0.01, reg_epsilon=1e-2, max_it=6,
                  admm_alpha=1.7)
    _reset_counts()
    u, v, m, diag = sweep.solve_batch_full(
        "foto", f1s, f2s, foto_params=dict(params, Nt=4),
        device=cuda_device)
    launches = kernels.launch_counts()
    assert u.device.type == "cuda"
    _assert_launch_relation(launches,
                            _pallas_launches(int(diag["iterations"].sum())),
                            extractions=3)
    for i in range(3):
        one = foto.solve(torch.as_tensor(f1s[i], device=cuda_device),
                         torch.as_tensor(f2s[i], device=cuda_device), 4,
                         **params, ops=foto.stepA_ops("pallas"))
        assert diag["iterations"][i] == one.state.iteration
        for got, want in ((u[i], one.u), (v[i], one.v), (m[i], one.m)):
            assert torch.equal(got, want), i


@pytest.mark.cuda
def test_pipeline_run_on_card(cuda_device, tmp_path):
    """A tiny per-sequence sweep on the card (the pipeline's default
    platform) writes every artifact, runs FOTO and WFR on the fused kernel
    and its launches hold the device loop's relation to the ALG2
    iterations."""
    import json

    from ofot_tpu_torch.cli import pipeline
    from ofot_tpu_torch.ops import kernels
    from ofot_tpu_torch.utils import image

    f1s, f2s = _blob_pairs(2, 48, 64)
    for i in range(2):
        d = tmp_path / "data" / "middlebury-1" / "eval-data-gray" / f"s{i}"
        d.mkdir(parents=True)
        image.save_grayscale(f1s[i], str(d / "frame10.png"))
        image.save_grayscale(f2s[i], str(d / "frame11.png"))
    _reset_counts()
    assert pipeline.main([
        "run", "--data-root", str(tmp_path / "data"), "--results",
        str(tmp_path / "res"), "--datasets", "middlebury-1", "--algos",
        "GN,foto,WFR,sinkhorn", "--extra-args=--Nt=4 --max-it=6"]) == 0
    launches = kernels.launch_counts()
    manifest = json.loads((tmp_path / "res" / "manifest.json").read_text())
    foto_its = wfr_its = 0
    for i in range(2):
        out = tmp_path / "res" / "middlebury-1" / f"s{i}"
        names = ["diff.png", "wfr.growth.png"]
        for a in ("gn", "foto", "wfr", "sinkhorn"):
            names += [f"{a}.flo", f"{a}.benchmark.txt", f"{a}.rec.png",
                      f"{a}.lum.png", f"{a}.png", f".out.{a}.sucess"]
        assert all((out / n).exists() for n in names)
        row = manifest[f"middlebury-1/s{i}"]
        assert all(r["status"] == "ok" for r in row.values())
        assert row["foto"]["stepA_solver"] == row["WFR"]["stepA_solver"] \
            == "pallas"
        foto_its += row["foto"]["iterations"]
        wfr_its += row["WFR"]["iterations"]
    _assert_launch_relation(launches, _pallas_launches(foto_its, wfr_its),
                            extractions=4, softmins=True)


@pytest.mark.cuda
def test_sinkhorn_float64_rescue_runs_on_card(cuda_device, tmp_path,
                                              monkeypatch):
    """A float32 Sinkhorn solve of the sweep that misses its tolerance is
    re-solved at float64 in process on the card, not on the CPU."""
    import json

    from ofot_tpu_torch.cli import pipeline
    from ofot_tpu_torch.solvers import sinkhorn
    from ofot_tpu_torch.utils import image

    seen, real = [], sinkhorn.solve_fields

    def spy(a, b, *args, **kw):
        seen.append((a.device.type, a.dtype))
        return real(a, b, *args, **kw)

    # the CLI's one Sinkhorn solve
    monkeypatch.setattr(sinkhorn, "solve_fields", spy)
    f1s, f2s = _blob_pairs(1, 48, 64)
    d = tmp_path / "data" / "middlebury-1" / "eval-data-gray" / "s0"
    d.mkdir(parents=True)
    image.save_grayscale(f1s[0], str(d / "frame10.png"))
    image.save_grayscale(f2s[0], str(d / "frame11.png"))
    # two iterations cannot reach the tolerance in float32
    assert pipeline.main([
        "run", "--data-root", str(tmp_path / "data"), "--results",
        str(tmp_path / "res"), "--datasets", "middlebury-1", "--algos",
        "sinkhorn", "--extra-args=--max-it=2"]) == 0
    row = json.loads((tmp_path / "res" / "manifest.json").read_text())[
        "middlebury-1/s0"]["sinkhorn"]
    assert row["escalated_f64"] is True
    assert seen[-1] == ("cuda", torch.float64)
    assert {dev for dev, _ in seen} == {"cuda"}


# ------------------------------------------------------- lockstep batches

@pytest.mark.cuda
@pytest.mark.parametrize("ncomp", [3, 4])
@pytest.mark.parametrize("alpha", [None, 1.7])
def test_batched_fused_pointwise_on_card(cuda_device, ncomp, alpha):
    """One launch for 3 pairs with a per-pair r: against the plain version,
    and each pair bitwise its single-pair launch (fields and sums)."""
    per = [_inputs(ncomp, (4, 24, 40), alpha is not None, cuda_device)
           for _ in range(3)]
    g, m, qp = (None if per[0][j] is None
                else torch.stack([p[j] for p in per]) for j in range(3))
    r = torch.tensor([0.7, 1.0, 1.3], device=cuda_device)
    before = fp.launches
    got = fp.fused_pointwise_batched(g, m, r, alpha, qp)
    torch.cuda.synchronize()
    assert fp.launches == before + 1
    want = fp.fused_pointwise_batched_reference(g, m, r, alpha, qp)
    _assert_close(got, want)
    for i in range(3):
        one = fp.fused_pointwise(g[i], m[i], float(r[i]), alpha,
                                 None if qp is None else qp[i])
        assert all(torch.equal(a[i], b) for a, b in zip(got, one))


@pytest.mark.cuda
def test_batched_dct_solve_on_card(cuda_device):
    """B*Nt slices in one call with a per-pair r: against the plain
    version, and the slice kernel bitwise its single-pair launches."""
    F = torch.from_numpy(RNG.standard_normal((3, 5, 17, 24)).astype(
        np.float32)).to(cuda_device)
    r, eps = torch.tensor([0.3, 1.0, 2.5], device=cuda_device), 1e-2
    got = ds.dct_solve(F, r, eps)
    want = ds.dct_solve_reference(F, r, eps)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 5e-6 * float(
        want.abs().max())
    p = ds.plan_for(F, r, eps)
    Fz = ds.t_forward(F, p)
    enqueue, out = ds.prepare_launch(Fz, p, r)
    enqueue()
    for i in range(3):
        e, o = ds.prepare_launch(Fz[i].contiguous(), ds.plan(
            (5, 17, 24), F.dtype, F.device, float(r[i]), eps))
        e()
        assert torch.equal(o, out[i])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 17, 23), (4, 48, 40)])
def test_batched_cg_operator_on_card(cuda_device, shape):
    """One launch over 3 pairs: the 'N' time rows at each pair's own
    planes, each pair bitwise its single-pair launch."""
    x = torch.from_numpy(RNG.standard_normal((3,) + shape).astype(
        np.float32)).to(cuda_device)
    r = torch.tensor([0.5, 1.0, 2.0], device=cuda_device)
    before = cgk.blocked_launches
    got = cgk.cg_operator_blocked(x, r, 1e-2)
    torch.cuda.synchronize()
    assert cgk.blocked_launches == before + 1
    torch.testing.assert_close(got, cgk.cg_operator_reference(x, r, 1e-2),
                               atol=1e-5, rtol=0)
    for i in range(3):
        assert torch.equal(got[i], cgk.cg_operator_blocked(
            x[i], float(r[i]), 1e-2))


@pytest.mark.cuda
def test_lockstep_solve_batch_full_on_card(cuda_device):
    """The lockstep batch on the card: FOTO (fused kernel, the device
    loop's launch relation to the lockstep iterations) and GN against map
    mode on the same pairs."""
    from ofot_tpu_torch.ops import kernels
    from ofot_tpu_torch.parallel import sweep
    a = RNG.uniform(0.1, 0.9, (3, 24, 28)).astype(np.float32)
    b = np.roll(a, (1, 2), axis=(1, 2))
    b[1] = np.roll(a[1], (-2, 1), axis=(0, 1))
    fp_ = dict(Nt=4, r=1.0, convergence_tol=0.01, reg_epsilon=1e-2,
               max_it=40, admm_alpha=1.7)
    _reset_counts()
    u, v, m, d = sweep.solve_batch_full("foto", a, b, foto_params=fp_,
                                        batch_mode="vmap", device="cuda")
    _assert_launch_relation(kernels.launch_counts(),
                            _pallas_launches(int(d["iterations"].max())),
                            extractions=1)
    um, vm, mm, dm = sweep.solve_batch_full("foto", a, b, foto_params=fp_,
                                            device="cuda")
    for i in range(3):
        if d["iterations"][i] == dm["iterations"][i]:
            assert float(torch.hypot(u[i] - um[i], v[i] - vm[i]).mean()) \
                < 1e-3
    g = sweep.solve_batch_full("GN", a, b, batch_mode="vmap", device="cuda")
    gm = sweep.solve_batch_full("GN", a, b, device="cuda")
    assert np.abs(g[3]["inner_iterations"]
                  - gm[3]["inner_iterations"]).max() <= 3
    torch.testing.assert_close(g[0], gm[0], atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["dct", "pallas"])
def test_lockstep_pairs_are_bitwise_their_single_solves_on_card(
        cuda_device, solver):
    """Each pair of a lockstep FOTO solve with the spectral stepA (``dct``;
    ``pallas`` adds the batched fused kernel) is bitwise its single-pair
    solve on the card: one batched t-axis product serves the batch there,
    where the CPU goes pair by pair (``solvers/dct.py:_transform``)."""
    from ofot_tpu_torch.parallel import sweep
    from ofot_tpu_torch.solvers import foto
    a = RNG.uniform(0.1, 0.9, (3, 24, 28)).astype(np.float32)
    b = np.roll(a, (1, 2), axis=(1, 2))
    b[1] = np.roll(a[1], (-2, 1), axis=(0, 1))
    kw = dict(r=1.0, convergence_tol=0.01, reg_epsilon=1e-2, max_it=40,
              admm_alpha=1.7, ops=foto.stepA_ops(solver))
    states = sweep.solve_foto_batch(a, b, 4, device="cuda", **kw)
    for i in range(3):
        one = foto.solve_potential(torch.from_numpy(a[i]).cuda(),
                                   torch.from_numpy(b[i]).cuda(), 4, **kw)
        assert int(states.iteration[i]) == one.iteration
        assert torch.equal(states.phi[i], one.phi)
        assert torch.equal(states.mu[i], one.mu)


def _plain_stencil_pallas(lockstep):
    """The ``pallas`` set with the plain stencils in place of the stencil
    kernels (#1 kept), on the single-pair or the lockstep form."""
    from ofot_tpu_torch.solvers import foto

    class PlainStencils(foto.PallasOps):
        kernels = foto.PallasOps.kernels._replace(grad_st=None,
                                                  stepA_rhs=None)

    return PlainStencils(foto.LOCKSTEP if lockstep else foto.SINGLE)


@pytest.mark.cuda
@pytest.mark.parametrize("lockstep", [False, True])
def test_foto_pallas_solve_keeps_its_bits_with_the_stencil_kernels_on_card(
        cuda_device, lockstep):
    """A 320x240 FOTO ``pallas`` solve on the device loop, single-pair or a
    lockstep batch of 4 with per-pair r: phi, u, v, m and the iteration
    counts bitwise those of the same solve with the plain stencils, and
    one launch of each stencil kernel an iteration (the replay
    relation)."""
    from ofot_tpu_torch.ops import kernels
    from ofot_tpu_torch.solvers import flow_extract, foto
    pairs = [_texture_pair(240, 320, shift=s, seed=5 + i) for i, s in
             enumerate([(2, 3), (-1, 2), (3, -2), (1, 1)])]
    a, b = (torch.from_numpy(np.stack(f).astype(np.float32)).to(cuda_device)
            for f in zip(*pairs))
    kw = dict(r=1.0, convergence_tol=0.01, reg_epsilon=1e-2, max_it=200,
              admm_alpha=1.7, loop="device")
    if lockstep:
        run = functools.partial(foto.alg2_loop_batched, a, b, 16,
                                auto_r=True, **kw)
    else:
        run = functools.partial(foto.alg2_loop, a[0], b[0], 16, **kw)
    _reset_counts()
    st = run(ops=foto.stepA_ops("pallas"))
    iterations = (int(st.iteration.max()) if lockstep else st.iteration)
    _assert_launch_relation(kernels.launch_counts(),
                            _pallas_launches(iterations))
    want = run(ops=_plain_stencil_pallas(lockstep))
    assert torch.equal(torch.as_tensor(st.iteration),
                       torch.as_tensor(want.iteration))
    for got, ref in ((st.phi, want.phi), (st.mu, want.mu), (st.q, want.q)):
        assert _same_bits(got, ref)
    for i in range(len(a) if lockstep else 1):
        one, ref = ((st.phi[i], want.phi[i]) if lockstep
                    else (st.phi, want.phi))
        for f, g in zip(flow_extract.flow_from_potential(one),
                        flow_extract.flow_from_potential(ref)):
            assert _same_bits(f, g)


@pytest.mark.cuda
def test_stencil_kernels_launch_once_an_alg2_iteration_on_card(cuda_device):
    """On the host loop each stencil kernel launches exactly once an ALG2
    iteration of the ``pallas`` set (FOTO; WFR the gradient only), and GN
    launches none (its CG's device loop only the loop's mask kernels)."""
    from ofot_tpu_torch.ops import kernels
    from ofot_tpu_torch.solvers import foto, gn, wfr
    a, b = (torch.as_tensor(x[0], device=cuda_device)
            for x in _blob_pairs(1, 40, 48))
    kw = dict(r=1.0, convergence_tol=0.01, reg_epsilon=1e-2, max_it=30,
              admm_alpha=1.7, loop="host", ops=foto.stepA_ops("pallas"))
    _reset_counts()
    st = foto.alg2_loop(a, b, 8, **kw)
    assert kernels.launch_counts() == dict(
        {k: 0 for k in kernels.KERNELS}, **_pallas_launches(st.iteration))
    _reset_counts()
    st = wfr.alg2_loop(a, b, 8, delta=2.5, **kw)
    assert kernels.launch_counts() == dict(
        {k: 0 for k in kernels.KERNELS}, **_pallas_launches(0, st.iteration))
    _reset_counts()
    gn.solve_fields(a, b)
    _assert_launch_relation(kernels.launch_counts(), {})


@pytest.mark.cuda
def test_warp_of_an_all_nan_flow_on_the_card(cuda_device):
    """A FOTO solve stopped by its NaN guard returns an all-NaN flow; its
    warp must give NaN pixels on the card, not an out-of-range gather
    (a device-side assert ends the process's CUDA context)."""
    from ofot_tpu_torch.utils import warp
    f1 = torch.rand(24, 30, device=cuda_device)
    u = torch.full_like(f1, float("nan"))
    out = warp.apply_flow(f1, u, u, torch.zeros_like(f1))
    torch.cuda.synchronize()
    assert out.shape == f1.shape and torch.isnan(out).all()
    # the context still works after it
    z = torch.zeros_like(f1)
    assert torch.equal(warp.apply_flow(f1, z, z), f1)


def _same_bits(a, b):
    if a.is_floating_point():
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _loop_paths(device):
    """name -> run(loop) -> (fields, counters) at a small size."""
    from ofot_tpu_torch.solvers import foto, gn, sinkhorn, wfr
    f1s, f2s = (torch.as_tensor(x, device=device)
                for x in _blob_pairs(3, 40, 48))
    a, b = f1s[0], f2s[0]
    alg2 = dict(r=1.0, convergence_tol=0.01, reg_epsilon=1e-2, max_it=60,
                admm_alpha=1.7)

    def state(st):
        return ((st.mu, st.q, st.phi, st.crit),
                (st.iteration, st.cg_iterations, st.done))

    def sk(stab):
        def run(loop):
            r = sinkhorn.solve(a, b, 20.0, max_iter=300, tol=1e-5,
                               stabilizer=stab, loop=loop)
            return (r.f, r.g, r.cost, r.marginal_error), (r.iterations,)
        return run

    def gn_run(loop):
        r = gn.solve_fields(a, b, loop=loop)
        return (r.u, r.v, r.m, r.cg.residual), (r.cg.iterations,)

    return {
        "foto-pallas": lambda loop: state(foto.alg2_loop(
            a, b, 8, ops=foto.stepA_ops("pallas"), loop=loop, **alg2)),
        "foto-dct-fused": lambda loop: state(foto.alg2_loop(
            a, b, 8, ops=foto.stepA_ops("dct-fused"), loop=loop, **alg2)),
        "wfr-pallas": lambda loop: state(wfr.alg2_loop(
            a, b, 8, delta=2.5, ops=foto.stepA_ops("pallas"), loop=loop,
            **alg2)),
        "gn": gn_run,
        "sinkhorn-matmul": sk("matmul"),
        "sinkhorn-exact": sk("exact"),
        "lockstep-foto": lambda loop: state(foto.alg2_loop_batched(
            f1s, f2s, 8, ops=foto.stepA_ops("pallas"), loop=loop, **alg2)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["foto-pallas", "foto-dct-fused",
                                  "wfr-pallas", "gn", "sinkhorn-matmul",
                                  "sinkhorn-exact", "lockstep-foto"])
def test_device_loop_is_bitwise_the_host_loop_on_card(cuda_device, path):
    """Captured loops (a cold run that captures, a warm one that replays
    the cached graph) give the host loop's fields bitwise and its
    counters."""
    run = _loop_paths(cuda_device)[path]
    host_fields, host_counts = run("host")
    for _ in range(2):
        fields, counts = run("device")
        assert all(map(_same_bits, host_fields, fields))
        for h, d in zip(host_counts, counts):
            assert torch.equal(torch.as_tensor(h), torch.as_tensor(d))


@pytest.mark.cuda
def test_capture_with_a_host_read_raises_on_card(cuda_device):
    """A body that reads the card on the host cannot be captured: the
    device loop raises and does not fall back to the host loop."""
    from typing import NamedTuple

    from ofot_tpu_torch.solvers import device_loop

    class S(NamedTuple):
        x: torch.Tensor

    def step(s):
        return S(s.x + float(s.x.sum()))          # a host read

    with pytest.raises(RuntimeError, match="no host fallback"):
        device_loop.while_loop(step, lambda s: s.x.sum() < 1e6,
                               S(torch.ones(4, device=cuda_device)))
    # the card still works after the failed capture
    assert float(torch.ones(3, device=cuda_device).sum()) == 3.0


@pytest.mark.cuda
@pytest.mark.parametrize("solver,kernel", [("pallas", "fused_pointwise"),
                                           ("dct-fused", "dct_solve")])
def test_device_loop_launch_relation_on_card(cuda_device, solver, kernel):
    """launches = warm-up launches + replays x K (one launch an
    iteration), and iterations <= replays x K < iterations + K; a warm
    solve replays the cached graph without a capture."""
    from ofot_tpu_torch.ops import kernels
    from ofot_tpu_torch.solvers import device_loop, foto
    a, b = (torch.as_tensor(x[0], device=cuda_device)
            for x in _blob_pairs(1, 40, 48))
    kw = dict(r=1.0, convergence_tol=0.01, reg_epsilon=1e-2, max_it=60,
              admm_alpha=1.7, loop="device")
    device_loop.clear_cache()          # an earlier test cached this graph
    for cold in (True, False):
        _reset_counts()
        st = foto.alg2_loop(a, b, 8, ops=foto.stepA_ops(solver), **kw)
        s, K = device_loop.stats, device_loop.BLOCK
        launches = kernels.launch_counts()
        assert s.captures == (1 if cold else 0)
        assert launches[kernel] == s.eager_launches.get(kernel, 0) \
            + s.replays * K
        assert s.eager_launches.get(kernel, 0) == (1 if cold else 0)
        assert st.iteration <= s.replays * K < st.iteration + K
        for mask in LOOP_MASK:
            assert launches[mask] == (1 if cold else 0) + s.replays * K
        assert s.latch_slots == s.slots == s.replays * K
        _assert_launch_relation(
            launches, _pallas_launches(st.iteration) if solver == "pallas"
            else {kernel: st.iteration})


def _graft_step_f64(device):
    """graft_entry.entry()'s step made from ``foto.init_state`` +
    ``alg2_iteration`` at float64 on ``device``, CG to cg_rtol 1e-12 ->
    (phi on the CPU, its CG steps)."""
    from ofot_tpu_torch import graft_entry
    from ofot_tpu_torch.solvers import foto
    a, b = (torch.as_tensor(f, device=device)
            for f in graft_entry._example_pair(dtype=np.float64))
    st = foto.alg2_iteration(foto.init_state(a, b, 8), a, b, r=1.0,
                             reg_epsilon=1e-2, convergence_tol=0.01,
                             cg_rtol=1e-12, cg_maxiter=10_000)
    return st.phi.cpu(), int(st.cg_iterations)


@pytest.mark.cuda
def test_graft_entry_step_on_card(cuda_device):
    """entry()'s step (the default cg set, no solver kernel) on the card:
    float32 phi (8, 32, 40) and finite; at float64 with CG run to cg_rtol
    1e-12 (at the default 1e-6 one-ulp input noise moves phi by ~5e-9 of
    max|phi|), the CPU's phi within 1e-10 of max|phi| with the same CG
    steps (the bound tests/test_torch_graft_entry.py holds the CPU to
    against JAX)."""
    from ofot_tpu_torch import graft_entry
    from ofot_tpu_torch.ops import kernels
    _reset_counts()
    fn, args = graft_entry.entry(device="cuda")
    assert all(a.device.type == "cuda" for a in args)
    phi, crit = fn(*args)
    assert phi.shape == (8, 32, 40) and bool(torch.isfinite(phi).all())
    assert np.isfinite(float(crit))
    _assert_launch_relation(kernels.launch_counts(), {})
    card, cpu = _graft_step_f64("cuda"), _graft_step_f64("cpu")
    scale = float(cpu[0].abs().max())
    assert float((card[0] - cpu[0]).abs().max()) <= 1e-10 * scale
    assert card[1] == cpu[1] == 241


# ------------------------------------------------------------ loop mask

def _loop_state(device, lead, fields, scalars, seed):
    """Random fields of the given shapes (float32) and per-pair scalars
    of the given dtypes and ``lead`` shape, as the loops carry them."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    fs = [torch.randn(sh, generator=g).to(device) for sh in fields]
    sc = [(torch.rand(lead, generator=g) * 100).to(dt).to(device)
          for dt in scalars]
    return fs, sc


_FOTO_SCALARS = (torch.float32, torch.float32, torch.int64, torch.int64,
                 torch.bool)
# name -> (the pairs' shape, the fields' shapes, the scalars' dtypes)
_LOOP_SHAPES = {
    "foto-320": ((), [(3, 16, 240, 320), (3, 16, 240, 320), (16, 240, 320)],
                 _FOTO_SCALARS),
    "foto-640": ((), [(3, 16, 480, 640), (3, 16, 480, 640), (16, 480, 640)],
                 _FOTO_SCALARS),
    "lockstep8-320": ((8,), [(8, 3, 16, 240, 320), (8, 3, 16, 240, 320),
                             (8, 16, 240, 320)], _FOTO_SCALARS),
    "wfr-320": ((), [(4, 16, 240, 320), (4, 16, 240, 320), (16, 240, 320)],
                _FOTO_SCALARS),
    "gn-320": ((), [(2, 240, 320)] * 3,
               (torch.float32, torch.float32, torch.int64)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(_LOOP_SHAPES))
def test_loop_mask_kernels_match_plain_versions_on_card(cuda_device, shape):
    """Both kernels bitwise their plain versions at the loops' shapes, on
    iterations where no pair stops, where one or every running pair
    stops, and with pairs stopped before; one launch each a call."""
    from ofot_tpu_torch.ops.kernels import loop_mask as lm
    lead, fields, scalars = _LOOP_SHAPES[shape]
    fs, new = _loop_state(cuda_device, lead, fields, scalars, 11)
    held, old = _loop_state(cuda_device, lead, fields, scalars, 12)
    B = lead[0] if lead else 1
    cases = [(True, True), (True, False), (False, False)]
    if lead:
        cases = [(torch.ones(B, dtype=torch.bool),
                  torch.ones(B, dtype=torch.bool)),
                 (torch.ones(B, dtype=torch.bool),
                  torch.arange(B) != 3),
                 (torch.arange(B) % 2 == 0, torch.arange(B) % 4 == 0),
                 (torch.zeros(B, dtype=torch.bool),
                  torch.zeros(B, dtype=torch.bool))]
    for run, nxt in cases:
        run, nxt = (torch.as_tensor(t, device=cuda_device)
                    for t in (run, nxt))
        sel0, lat0 = lm.select_launches, lm.latch_launches
        got = lm.select_scalars(run, new, old)
        want = lm.select_scalars_reference(run, new, old)
        assert all(map(_same_bits, got, want))
        mine = tuple(h.clone() for h in held)
        want = lm.latch_fields_reference(run, nxt, fs, mine)
        got = lm.latch_fields(run, nxt, fs, mine)
        assert all(g is m for g, m in zip(got, mine))      # in place
        assert all(map(_same_bits, got, want))
        assert (lm.select_launches - sel0, lm.latch_launches - lat0) \
            == (1, 1)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_loop_mask_kernels_take_unaligned_fields_on_card(cuda_device):
    """A field whose pair segments are not 16-byte multiples, or that
    starts off a 16-byte boundary, copies by words: bitwise as well."""
    from ofot_tpu_torch.ops.kernels import loop_mask as lm
    base = torch.randn(1 + 4 * 3 * 5 * 7, device=cuda_device)
    fields = [base[1:].view(4, 3, 5, 7),
              torch.randn(4, 3, 5, 7, device=cuda_device)]
    held = [torch.randn(4, 3, 5, 7, device=cuda_device) for _ in fields]
    run = torch.tensor([True, True, False, True], device=cuda_device)
    nxt = torch.tensor([False, True, False, False], device=cuda_device)
    want = lm.latch_fields_reference(run, nxt, fields, held)
    got = lm.latch_fields(run, nxt, fields, held)
    assert all(map(_same_bits, got, want))


@pytest.mark.cuda
def test_loop_mask_kernels_reject_bad_operands_on_card(cuda_device):
    from ofot_tpu_torch.ops.kernels import loop_mask as lm
    run = torch.ones(2, dtype=torch.bool, device=cuda_device)
    f = torch.zeros(2, 3, 4, device=cuda_device)
    s = torch.zeros(2, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        lm.latch_fields(run, run, [f.transpose(1, 2)], [f.transpose(1, 2)])
    with pytest.raises(TypeError):
        lm.latch_fields(run, run, [f], [f.double()])
    with pytest.raises(ValueError, match="no field"):
        lm.latch_fields(run, run, [s], [s.clone()])
    with pytest.raises(ValueError, match="at most"):
        lm.select_scalars(run, [s] * 17, [s] * 17)
    with pytest.raises(ValueError, match="elements"):
        lm.select_scalars(run, [f], [f])
    with pytest.raises(TypeError):
        lm.select_scalars(run.float(), [s], [s])
    with pytest.raises(ValueError):
        lm.select_scalars(run, [s.cpu()], [s.cpu()])


@pytest.mark.cuda
def test_replayed_foto_block_launches_no_where_on_card(cuda_device):
    """A replayed FOTO ``pallas`` block: no ``where`` kernel (the select
    of every field is gone), the two mask kernels once an iteration."""
    from torch.profiler import ProfilerActivity, profile
    from ofot_tpu_torch.solvers import device_loop, foto
    a, b = (torch.as_tensor(x[0], device=cuda_device)
            for x in _blob_pairs(1, 240, 320))
    kw = dict(r=1.0, convergence_tol=0.01, reg_epsilon=1e-2, max_it=40,
              admm_alpha=1.7, loop="device", ops=foto.stepA_ops("pallas"))
    foto.alg2_loop(a, b, 16, **kw)              # captures the graph
    torch.cuda.synchronize()
    _reset_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        st = foto.alg2_loop(a, b, 16, **kw)
        torch.cuda.synchronize()
    assert device_loop.stats.captures == 0 and device_loop.stats.replays
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert any("fused_pointwise_kernel" in n for n in names), names[:20]
    assert not [n for n in names if "where" in n]
    latch = sum("loop_latch_fields_kernel" in n for n in names)
    select = sum("loop_select_scalars_kernel" in n for n in names)
    slots = device_loop.stats.slots
    assert st.iteration <= slots and latch <= slots and select <= slots
    assert latch > 0 and select > 0


# ------------------------------------------------------------ flow extraction

# Nt 2, 3 and 16 on 2x2, 3x3 and 33x47 frames, and the cells' two sizes
FLOW_SHAPES = [(nt, ny, nx) for nt in (2, 3, 16)
               for ny, nx in ((2, 2), (3, 3), (33, 47))] \
    + [(16, 240, 320), (16, 480, 640)]


def _flow_potential(shape, dtype, scale, device, batch=None, seed=0):
    """A random potential: a drift of up to ``scale`` px a step in each
    slice, plus noise (3 px a step: trajectories leave the grid, hit the
    clamp and carry offsets outside [0, 1))."""
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    Nt, Ny, Nx = shape
    y, x = np.mgrid[0:Ny, 0:Nx]
    drift = rng.uniform(-1, 1, lead + (Nt, 1, 1)) * x \
        + rng.uniform(-1, 1, lead + (Nt, 1, 1)) * y
    phi = scale * drift + 0.1 * rng.standard_normal(lead + shape)
    return torch.from_numpy(phi).to(device, dtype)


def _flow_launches():
    from ofot_tpu_torch.ops import kernels
    return kernels.launch_counts()["flow_extract"]


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [0.2, 3.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", FLOW_SHAPES)
def test_flow_extract_kernel_is_bitwise_the_plain_path_on_card(
        cuda_device, shape, dtype, scale):
    """(u, v, m) of one call bitwise the plain path's on the card, repeat
    calls bitwise, ``LAUNCHES_A_CALL`` launches a call."""
    from ofot_tpu_torch.ops.kernels import flow_extract as fk
    from ofot_tpu_torch.solvers import flow_extract
    phi = _flow_potential(shape, dtype, scale, cuda_device)
    _reset_counts()
    got = flow_extract.flow_from_potential(phi)
    assert _flow_launches() == fk.LAUNCHES_A_CALL
    want = flow_extract.flow_from_potential_reference(phi)
    again = flow_extract.flow_from_potential(phi)
    for g, w, a in zip(got, want, again):
        assert g.shape == shape[1:] and g.dtype == dtype
        assert _same_bits(g, w) and _same_bits(g, a)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(16, 240, 320), (3, 33, 47)])
def test_batched_flow_extract_is_bitwise_its_single_calls_on_card(
        cuda_device, shape, dtype):
    """A batch of 8: one call of ``LAUNCHES_A_CALL`` launches, each pair
    bitwise its single call and the plain path."""
    from ofot_tpu_torch.ops.kernels import flow_extract as fk
    from ofot_tpu_torch.solvers import flow_extract
    phi = _flow_potential(shape, dtype, 3.0, cuda_device, batch=8, seed=1)
    _reset_counts()
    got = flow_extract.flow_from_potential(phi)
    assert _flow_launches() == fk.LAUNCHES_A_CALL
    for g, w in zip(got, flow_extract.flow_from_potential_reference(phi)):
        assert g.shape == (8,) + shape[1:] and _same_bits(g, w)
    for b in range(8):
        for g, w in zip(got, flow_extract.flow_from_potential(phi[b])):
            assert _same_bits(g[b], w)
    assert _flow_launches() == 9 * fk.LAUNCHES_A_CALL


@pytest.mark.cuda
@pytest.mark.parametrize("traffic", ["mb1_320", "mb1_640"])
def test_flow_extract_of_solved_pool_potentials_on_card(cuda_device,
                                                        traffic):
    """Potentials that FOTO solves at the benchmark's configuration from a
    plain and a lum pair of the benchmark's pool: the kernel's (u, v, m)
    bitwise the plain path's."""
    import json
    from pathlib import Path

    from flowbench.traffic import generator
    from ofot_tpu_torch.solvers import flow_extract, foto
    root = Path(__file__).resolve().parents[1] / "flowbench"
    cfg = json.loads((root / "configs" / "foto_sweep.json").read_text())
    pool = generator.make_pool(json.loads(
        (root / "traffic" / f"{traffic}.json").read_text()))
    pairs = [next(p for p in pool if p.lum == lum) for lum in (False, True)]
    for p in pairs:
        a, b = (torch.as_tensor(f, device=cuda_device) for f in (p.f1, p.f2))
        st = foto.solve_potential(
            a, b, cfg["Nt"], r=cfg["r"],
            convergence_tol=cfg["convergence_tol"],
            reg_epsilon=cfg["reg_epsilon"], max_it=cfg["max_it"],
            admm_alpha=cfg["admm_alpha"], ops=foto.stepA_ops("pallas"))
        got = flow_extract.flow_from_potential(st.phi)
        want = flow_extract.flow_from_potential_reference(st.phi)
        assert all(map(_same_bits, got, want))


@pytest.mark.cuda
def test_foto_solve_extracts_through_the_kernel_on_card(cuda_device):
    """A 320x240 FOTO solve (graph cached): its extraction launches the two
    kernels once each and no ``index``, ``trunc`` or ``clamp`` op beyond
    those of the loop alone."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile
    from ofot_tpu_torch.solvers import foto
    a, b = (torch.as_tensor(x, dtype=torch.float32, device=cuda_device)
            for x in _texture_pair(240, 320))
    kw = dict(r=1.0, convergence_tol=0.01, reg_epsilon=1e-2, max_it=40,
              admm_alpha=1.7, ops=foto.stepA_ops("pallas"))
    foto.solve(a, b, 16, **kw)                  # captures the graph
    torch.cuda.synchronize()
    ops = ("aten::index", "aten::trunc", "aten::clamp")
    seen = []
    for run in (foto.solve_potential, foto.solve):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(a, b, 16, **kw)
            torch.cuda.synchronize()
        names = Counter(e.name for e in prof.events())
        seen.append(({k: names[k] for k in ops},
                     sum(v for k, v in names.items()
                         if "flow_trajectories_kernel" in k),
                     sum(v for k, v in names.items()
                         if "flow_divergence_kernel" in k)))
    (loop_ops, *loop_kernels), (solve_ops, *solve_kernels) = seen
    assert solve_ops == loop_ops
    assert loop_kernels == [0, 0] and solve_kernels == [1, 1]


@pytest.mark.cuda
def test_flow_extract_kernel_rejects_bad_operands_on_card(cuda_device):
    """Other dtypes, a frame axis of 1 and other ranks raise before any
    launch; a non-contiguous potential is taken as its contiguous copy."""
    from ofot_tpu_torch.ops.kernels import flow_extract as fk
    from ofot_tpu_torch.solvers import flow_extract
    phi = _flow_potential((4, 6, 8), torch.float32, 3.0, cuda_device)
    _reset_counts()
    with pytest.raises(TypeError):
        fk.flow(phi.half())
    with pytest.raises(ValueError):
        fk.flow(phi[:, :1])
    with pytest.raises(ValueError):
        fk.flow(phi[None, None])
    assert _flow_launches() == 0
    t = phi.transpose(1, 2)
    got = fk.flow(t)
    want = flow_extract.flow_from_potential_reference(t.contiguous())
    assert all(map(_same_bits, got, want))
    assert _flow_launches() == fk.LAUNCHES_A_CALL


# ------------------------------------------------ the exact softmin kernels
#
# The kernels (ops/kernels/exact_softmin.py) against the plain path
# (solvers/sinkhorn._exact_stats_plain) on the card, in the working dtype.
# Tolerances, relative to the plain output's largest magnitude: float32
# 2e-6 for S and 1e-5 for E[y'], E[x'], E[C]; float64 1e-13 and 1e-12.
# The two form every term and maximum alike but sum the terms in other
# orders (four running partial sums of up to Nx or Ny terms against torch's
# reductions) and divide the means' sums by the denominator after the sum,
# not term by term: each sum differs by a few ulps, S (eps times a
# logarithm of up to ~300 nats for the wide potential) by a few ulps of
# max|S|, and the means by their ulps times the few pixels over which a
# plan row spreads.  The emulated arithmetic read 3e-7 (float32) and 6e-16
# (float64) on small fields.

SOFTMIN_RTOL = {torch.float32: (2e-6, 1e-5), torch.float64: (1e-13, 1e-12)}


def _softmin_potential(shape, dtype, nats, device, seed=3):
    """eps times a smooth field spanning ``nats`` nats at eps 100, as a
    Sinkhorn potential (B, Ny, Nx) or (Ny, Nx): 30 nats for a plain
    pair's, 300 for one past the matmul softmin's float32 exp window
    (~88 nats)."""
    ny, nx = shape[-2:]
    n = shape[0] if len(shape) == 3 else 1
    tex = np.stack([_texture_pair(ny, nx, seed=seed + i)[0]
                    for i in range(n)]).reshape(shape)
    return torch.as_tensor(-100.0 * nats * (tex - 0.1) / 0.8, dtype=dtype,
                           device=device)


def _softmin_gap(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("nats", [30, 300], ids=["plain", "wide"])
@pytest.mark.parametrize("shape", [(240, 320), (320, 240), (194, 292)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_exact_softmin_matches_plain_path_on_card(cuda_device, dtype, shape,
                                                  nats):
    """S, and (S, E[y'], E[x'], E[C]), of the kernels against the plain
    path on the card, at the sweep's frame, its transpose and the eval
    set's ragged 194x292, for a plain potential and one whose range is
    past the matmul softmin's exp window; one call of two launches each,
    and a repeat launch is bitwise the first."""
    from ofot_tpu_torch.ops import kernels
    from ofot_tpu_torch.ops.kernels import exact_softmin as ek
    from ofot_tpu_torch.solvers import sinkhorn
    h = _softmin_potential(shape, dtype, nats, cuda_device)
    s_tol, m_tol = SOFTMIN_RTOL[dtype]
    _reset_counts()
    S = sinkhorn._exact_stats(h, 100.0, want_means=False)
    got = sinkhorn._exact_stats(h, 100.0, want_means=True)
    counts = kernels.launch_counts()
    assert counts["exact_softmin"] == counts["exact_stats"] \
        == ek.LAUNCHES_A_CALL
    want = sinkhorn._exact_stats_plain(h, 100.0, want_means=True)
    assert S.dtype == dtype and S.device.type == "cuda"
    assert all(bool(torch.isfinite(x).all()) for x in (S, *got))
    assert torch.equal(S, got[0])
    assert _softmin_gap(S, want[0]) <= s_tol
    for g, w in zip(got[1:], want[1:]):
        assert _softmin_gap(g, w) <= m_tol
    assert torch.equal(sinkhorn._exact_stats(h, 100.0, want_means=False), S)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_exact_softmin_is_its_single_calls_on_card(cuda_device,
                                                           dtype):
    """A (3, 240, 320) lockstep batch is one call, and each of its pairs is
    bitwise the pair's single call, S and the means alike."""
    from ofot_tpu_torch.ops import kernels
    from ofot_tpu_torch.ops.kernels import exact_softmin as ek
    from ofot_tpu_torch.solvers import sinkhorn
    h = _softmin_potential((3, 240, 320), dtype, 30, cuda_device)
    _reset_counts()
    S = sinkhorn._exact_stats(h, 100.0, want_means=False)
    stats = sinkhorn._exact_stats(h, 100.0, want_means=True)
    assert kernels.launch_counts()["exact_softmin"] == ek.LAUNCHES_A_CALL
    for i in range(3):
        assert torch.equal(S[i], sinkhorn._exact_stats(
            h[i], 100.0, want_means=False))
        one = sinkhorn._exact_stats(h[i], 100.0, want_means=True)
        assert all(torch.equal(b[i], o) for b, o in zip(stats, one))
    want = sinkhorn._exact_stats_plain(h, 100.0, want_means=False)
    assert _softmin_gap(S, want) <= SOFTMIN_RTOL[dtype][0]


@pytest.mark.cuda
def test_exact_solve_launches_the_softmin_inside_its_graphs_on_card(
        cuda_device):
    """An exact solve on the device loop: each block of K iterations is a
    replay of a graph that launches 2K + 2 softmins (two an iteration, two
    for the block's marginal check), its capture's warm-up one block of
    one iteration eagerly (4 softmins), and the cost one call of the
    statistics; the host loop launches the same softmins eagerly and gives
    the same bits."""
    from ofot_tpu_torch.ops import kernels
    from ofot_tpu_torch.ops.kernels import exact_softmin as ek
    from ofot_tpu_torch.solvers import device_loop, sinkhorn
    f1, f2 = _texture_pair(48, 64)
    a, b = (torch.as_tensor(x.astype(np.float32), device=cuda_device)
            for x in (f1, f2))
    K, blocks = 5, 3
    kw = dict(max_iter=K * blocks, check_every=K, tol=0.0,
              stabilizer="exact")
    device_loop.clear_cache()
    _reset_counts()
    dev = sinkhorn.solve(a, b, 100.0, loop="device", **kw)
    launches, s = kernels.launch_counts(), device_loop.stats
    call = ek.LAUNCHES_A_CALL
    assert s.captures == 1 and s.replays == blocks
    assert s.eager_launches["exact_softmin"] == 4 * call
    assert s.graph_launches["exact_softmin"] == (2 * K + 2) * blocks * call
    assert launches["exact_softmin"] == (4 + (2 * K + 2) * blocks) * call
    assert launches["exact_stats"] == call
    _reset_counts()
    host = sinkhorn.solve(a, b, 100.0, loop="host", **kw)
    launches = kernels.launch_counts()
    assert launches["exact_softmin"] == (2 * K + 2) * blocks * call
    assert launches["exact_stats"] == call
    assert dev.iterations == host.iterations == K * blocks
    assert all(map(_same_bits, (dev.f, dev.g, dev.cost),
                   (host.f, host.g, host.cost)))


@pytest.mark.cuda
def test_exact_solve_keeps_the_plain_paths_accuracy_on_card(cuda_device,
                                                            monkeypatch):
    """Pool pair 19 of ``sinkhorn_mb1_320``, a lum pair that the cell
    solves again with the exact softmin, solved as the cell solves it on the
    kernels and again with ``_exact_stats`` on its plain path, both float32
    on the card, each against the float64 reference read at its own counts:
    the kernels' flow and m gaps within twice the plain path's, plus 1e-4.
    The plain path reads 1.2e-4 px and 9.1e-5 there.  Sums in another order
    move a float32 solve by its rounding; a bias moves it further, since the
    loop's slowest modes gather it over a thousand iterations: stage 1's
    terms multiplied by a rounded 1 / eps, where the plain path divides,
    read 4.0e-3 px and 1.7e-3."""
    import json
    from pathlib import Path

    from flowbench.algos import sinkhorn as cell
    from flowbench.traffic import generator
    from ofot_tpu_torch.solvers import device_loop, sinkhorn
    root = Path(__file__).resolve().parents[1] / "flowbench"
    cfg = json.loads((root / "configs" / "sinkhorn_sweep.json").read_text())
    pair = generator.make_pool(json.loads(
        (root / "traffic" / "mb1_320.json").read_text()))[19]
    a, b = (torch.as_tensor(f, device=cuda_device) for f in (pair.f1, pair.f2))

    def gaps():
        device_loop.clear_cache()         # graphs bake in the softmin
        res = sinkhorn.solve_fields(a, b, cfg["epsilon"],
                                    max_iter=cfg["max_it"], tol=cfg["tol"],
                                    theta=cfg["theta"])
        assert res.stabilizer == "exact"
        fields = tuple(t.cpu().numpy() for t in (res.u, res.v, res.m))
        counters = dict(final_ab=int(res.iterations_ab),
                        final_aa=int(res.iterations_aa))
        return cell.check(cfg, [(pair, fields, counters)], cuda_device)

    kernels = gaps()
    monkeypatch.setattr(sinkhorn, "_exact_stats", sinkhorn._exact_stats_plain)
    try:
        plain = gaps()
    finally:
        device_loop.clear_cache()
    for k in ("flow_gap_px", "m_gap"):
        assert kernels[k] <= 2.0 * plain[k] + 1e-4, (k, kernels, plain)


@pytest.mark.cuda
def test_exact_softmin_kernel_rejects_bad_operands_on_card(cuda_device):
    """Other dtypes, ranks and a device eps raise before any launch; the
    dispatcher takes a non-contiguous potential as its contiguous copy."""
    from ofot_tpu_torch.ops import kernels
    from ofot_tpu_torch.ops.kernels import exact_softmin as ek
    from ofot_tpu_torch.solvers import sinkhorn
    h = _softmin_potential((24, 40), torch.float32, 30, cuda_device)
    _reset_counts()
    with pytest.raises(TypeError):
        ek.softmin(h.half(), 100.0)
    with pytest.raises(ValueError):
        ek.softmin(h[None, None], 100.0)
    with pytest.raises(ValueError):
        ek.stats(h.t(), 100.0)
    with pytest.raises(ValueError):
        ek.softmin(h, torch.tensor(100.0, device=cuda_device))
    assert kernels.launch_counts()["exact_softmin"] == 0
    assert kernels.launch_counts()["exact_stats"] == 0
    got = sinkhorn._exact_stats(h.t(), 100.0, want_means=False)
    assert torch.equal(got, ek.softmin(h.t().contiguous(), 100.0))
