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
4-byte copies otherwise).

The solver loops run on the device loop by default on the card (captured
graphs of K iterations, ``solvers/device_loop.py``): each is held bitwise
against its host loop, a host read inside a captured body raises, and
wherever a test counted one launch an iteration it holds the replay
relation instead: launches = warm-up launches + replayed launches,
replayed launches = the slots of the replays, and iterations <= slots <=
iterations + (K - 1) a loop.
"""

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


def _assert_launch_relation(launches, kernel, iterations):
    """The device loop's launch relation for ``kernel``, launched once an
    iteration, and no launch of any other kernel."""
    from ofot_tpu_torch.solvers import device_loop
    s = device_loop.stats
    replayed = s.graph_launches.get(kernel, 0)
    assert launches[kernel] == s.eager_launches.get(kernel, 0) + replayed
    assert replayed == s.kernel_slots.get(kernel, 0)
    assert iterations <= replayed <= iterations + s.kernel_spare.get(kernel,
                                                                     0)
    assert sum(launches.values()) == launches[kernel]


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
    _assert_launch_relation(launches, "fused_pointwise",
                            int(diag["iterations"].sum()))
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
    iterations = 0
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
        iterations += row["foto"]["iterations"] + row["WFR"]["iterations"]
    _assert_launch_relation(launches, "fused_pointwise", iterations)


@pytest.mark.cuda
def test_sinkhorn_float64_rescue_runs_on_card(cuda_device, tmp_path,
                                              monkeypatch):
    """A float32 Sinkhorn solve of the sweep that misses its tolerance is
    re-solved at float64 in process on the card, not on the CPU."""
    import json

    from ofot_tpu_torch.cli import pipeline
    from ofot_tpu_torch.solvers import sinkhorn
    from ofot_tpu_torch.utils import image

    seen, real = [], sinkhorn.flow

    def spy(a, b, *args, **kw):
        seen.append((a.device.type, a.dtype))
        return real(a, b, *args, **kw)

    monkeypatch.setattr(sinkhorn, "flow", spy)
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
    _assert_launch_relation(kernels.launch_counts(), "fused_pointwise",
                            int(d["iterations"].max()))
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
        _assert_launch_relation(launches, kernel, st.iteration)
