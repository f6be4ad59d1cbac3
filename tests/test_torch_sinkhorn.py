"""The port's Sinkhorn solver (``ofot_tpu_torch.solvers.sinkhorn``) on the
CPU against the JAX package's, and the behaviour tests of
tests/test_sinkhorn.py run on the port.

Tolerances against JAX, on the same seeded or closed-form densities:
  * float64: potentials within 1e-9 of max|f|, the same iteration counts,
    costs within 1e-10 relative, flows within 1e-9 px (both run the same
    float64 operations; only the summation order of the products
    differs);
  * float32: costs within 1e-4 relative, iterations within one check
    block (25), flows within 1e-3 px (float32 rounding in another order,
    carried through hundreds of iterations).
The behaviour tests keep tests/test_sinkhorn.py's own bounds.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ofot_tpu.solvers import sinkhorn as jsk
from ofot_tpu_torch.solvers import sinkhorn

import fixtures

F64 = dict(f=1e-9, cost=1e-10, flow=1e-9)
F32 = dict(cost=1e-4, iterations=25, flow=1e-3)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The shapes here are small: one intra-op thread, so that the suite's
    parallel workers do not oversubscribe the cores (spinning OpenMP
    threads slowed this file 8x under a loaded run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blob(ny, nx, cy, cx, sigma=6.0):
    y, x = np.mgrid[0:ny, 0:nx].astype(np.float64)
    return np.exp(-(((y - cy) / sigma) ** 2 + ((x - cx) / sigma) ** 2))


def _pair(dtype=np.float64):
    return (_blob(32, 40, 14, 12).astype(dtype),
            _blob(32, 40, 18, 20, sigma=4.0).astype(dtype))


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def _assert_result_f64(ours, theirs):
    f = np.asarray(theirs.f)
    scale = np.abs(f).max()
    assert np.abs(ours.f.numpy() - f).max() <= F64["f"] * scale
    assert np.abs(ours.g.numpy() - np.asarray(theirs.g)).max() \
        <= F64["f"] * scale
    assert ours.iterations == int(theirs.iterations)
    assert _rel(ours.cost, theirs.cost) <= F64["cost"]
    np.testing.assert_allclose(float(ours.marginal_error),
                               float(theirs.marginal_error), rtol=1e-6)


@pytest.mark.parametrize("stabilizer", ["matmul", "exact"])
@pytest.mark.parametrize("theta", [1.0, 1.5])
def test_solve_matches_jax_f64(stabilizer, theta):
    a, b = _pair()
    kw = dict(max_iter=800, tol=1e-6, theta=theta, stabilizer=stabilizer)
    theirs = jsk.solve(jnp.asarray(a), jnp.asarray(b), 4.0, **kw)
    ours = sinkhorn.solve(_t(a), _t(b), 4.0, **kw)
    assert ours.f.dtype == torch.float64
    _assert_result_f64(ours, theirs)


@pytest.mark.parametrize("stabilizer", ["matmul", "exact"])
def test_solve_annealed_matches_jax_f64(stabilizer):
    f1, f2 = fixtures.smooth_blob_pair(20, 24, shift=(2.0, 1.0))
    kw = dict(max_iter=800, tol=1e-8, stabilizer=stabilizer)
    theirs = jsk.solve_annealed(jnp.asarray(f1), jnp.asarray(f2), 4.0, **kw)
    ours = sinkhorn.solve_annealed(_t(f1), _t(f2), 4.0, **kw)
    _assert_result_f64(ours, theirs)


@pytest.mark.parametrize("debias", [True, False])
@pytest.mark.parametrize("anneal", [True, False])
def test_flow_matches_jax_f64(debias, anneal):
    a = _blob(24, 28, 12, 11)
    b = _blob(24, 28, 14, 13)
    kw = dict(max_iter=600, tol=1e-7, debias=debias, anneal=anneal)
    theirs = jsk.flow(jnp.asarray(a), jnp.asarray(b), 4.0, **kw)
    ours = sinkhorn.flow(_t(a), _t(b), 4.0, **kw)
    assert np.abs(ours.u.numpy() - np.asarray(theirs.u)).max() <= F64["flow"]
    assert np.abs(ours.v.numpy() - np.asarray(theirs.v)).max() <= F64["flow"]
    assert ours.iterations == int(theirs.iterations)
    assert _rel(ours.cost_ab, theirs.cost_ab) <= F64["cost"]
    if debias:
        assert _rel(ours.cost_aa, theirs.cost_aa) <= F64["cost"]
    else:
        assert np.isnan(float(ours.cost_aa)) and np.isnan(
            float(theirs.cost_aa))


def test_exact_flow_matches_jax_f64():
    a = _blob(20, 24, 10, 9)
    b = _blob(20, 24, 12, 12)
    kw = dict(max_iter=600, tol=1e-7, stabilizer="exact")
    theirs = jsk.flow(jnp.asarray(a), jnp.asarray(b), 4.0, **kw)
    ours = sinkhorn.flow(_t(a), _t(b), 4.0, **kw)
    assert np.abs(ours.u.numpy() - np.asarray(theirs.u)).max() <= F64["flow"]
    assert np.abs(ours.v.numpy() - np.asarray(theirs.v)).max() <= F64["flow"]
    assert ours.iterations == int(theirs.iterations)


def test_divergence_and_w2_match_jax_f64():
    a = _blob(32, 32, 16, 13)
    b = _blob(32, 32, 16, 17)
    kw = dict(max_iter=600, tol=1e-7)
    theirs = jsk.sinkhorn_divergence(jnp.asarray(a), jnp.asarray(b), 4.0,
                                     full=True, **kw)
    ours = sinkhorn.sinkhorn_divergence(_t(a), _t(b), 4.0, full=True, **kw)
    assert _rel(ours.value, theirs.value) <= 1e-9
    assert ours.iterations == int(theirs.iterations)
    np.testing.assert_allclose(float(ours.marginal_error),
                               float(theirs.marginal_error), rtol=1e-6)
    w_theirs = jsk.wasserstein2_entropic(jnp.asarray(a), jnp.asarray(b),
                                         4.0, **kw)
    w_ours = sinkhorn.wasserstein2_entropic(_t(a), _t(b), 4.0, **kw)
    assert _rel(w_ours, w_theirs) <= 1e-9
    assert float(w_ours) == pytest.approx(4.0, abs=0.04)


@pytest.mark.parametrize("shape,chunk", [((6, 9), 4), ((5, 17), 3),
                                         ((17, 5), 64), ((13, 40), 16),
                                         ((13, 40), 64)])
def test_exact_stats_matches_jax_and_brute_force(shape, chunk):
    """The port's short last chunk gives what JAX's padded chunks give, and
    both what a direct O(N^2) evaluation gives."""
    Ny, Nx = shape
    rng = np.random.default_rng(Ny * 100 + Nx + chunk)
    h = rng.standard_normal((Ny, Nx)) * 50
    eps = 7.3
    ours = sinkhorn._exact_stats(_t(h), eps, want_means=True, chunk=chunk)
    theirs = jsk._exact_stats(jnp.asarray(h), eps, want_means=True,
                              chunk=chunk)
    for x, y in zip(ours, theirs):
        y = np.asarray(y)
        assert np.abs(x.numpy() - y).max() <= 1e-12 * max(1.0,
                                                          np.abs(y).max())
    S_only = sinkhorn._exact_stats(_t(h), eps, want_means=False, chunk=chunk)
    np.testing.assert_array_equal(S_only.numpy(), ours[0].numpy())
    S, ty, tx, ec = (o.numpy() for o in ours)
    yy, xx = np.mgrid[0:Ny, 0:Nx]
    for y in range(Ny):
        for x in range(Nx):
            C = (yy - y) ** 2 + (xx - x) ** 2
            m = (h - C).max()
            w = np.exp((h - C - m) / eps)
            assert S[y, x] == pytest.approx(m + eps * np.log(w.sum()),
                                            rel=1e-10, abs=1e-10)
            assert ty[y, x] == pytest.approx((w * yy).sum() / w.sum(),
                                             abs=1e-10)
            assert tx[y, x] == pytest.approx((w * xx).sum() / w.sum(),
                                             abs=1e-10)
            assert ec[y, x] == pytest.approx((w * C).sum() / w.sum(),
                                             rel=1e-10)


@pytest.mark.parametrize("stabilizer", ["matmul", "exact"])
def test_solve_annealed_matches_jax_f32(stabilizer):
    f1, f2 = fixtures.smooth_blob_pair(20, 24, shift=(2.0, 1.0))
    kw = dict(max_iter=800, tol=1e-5, stabilizer=stabilizer)
    theirs = jsk.solve_annealed(jnp.asarray(f1, jnp.float32),
                                jnp.asarray(f2, jnp.float32), 4.0, **kw)
    ours = sinkhorn.solve_annealed(_t(f1, torch.float32),
                                   _t(f2, torch.float32), 4.0, **kw)
    assert ours.f.dtype == torch.float32
    assert float(ours.marginal_error) <= 1e-5
    assert _rel(ours.cost, theirs.cost) <= F32["cost"]
    assert abs(ours.iterations - int(theirs.iterations)) <= F32["iterations"]


@pytest.mark.parametrize("stabilizer", ["matmul", "exact"])
def test_flow_matches_jax_f32(stabilizer):
    a = _blob(40, 40, 20, 17).astype(np.float32)
    b = _blob(40, 40, 20, 21).astype(np.float32)
    kw = dict(max_iter=1500, stabilizer=stabilizer)
    theirs = jsk.flow(jnp.asarray(a), jnp.asarray(b), 4.0, **kw)
    ours = sinkhorn.flow(_t(a, torch.float32), _t(b, torch.float32), 4.0,
                         **kw)
    assert ours.u.dtype == torch.float32
    assert np.abs(ours.u.numpy() - np.asarray(theirs.u)).max() <= F32["flow"]
    assert np.abs(ours.v.numpy() - np.asarray(theirs.v)).max() <= F32["flow"]
    assert abs(ours.iterations - int(theirs.iterations)) <= F32["iterations"]
    assert _rel(ours.cost_ab, theirs.cost_ab) <= F32["cost"]


# ------------------------------------------------ behaviour on the port

def test_translation_recovers_shift():
    """Debiased entropic W2 of a translated blob == the shift distance."""
    for shift in (2.0, 5.0):
        a = _t(_blob(48, 48, 24, 21))
        b = _t(_blob(48, 48, 24, 21 + shift))
        w2 = float(sinkhorn.wasserstein2_entropic(a, b, 4.0, max_iter=1000))
        assert abs(w2 - shift) < 1e-2 * shift, w2


def test_divergence_is_zero_on_equal_inputs():
    a = _t(_blob(32, 40, 15, 20))
    assert abs(float(sinkhorn.sinkhorn_divergence(a, a, 4.0))) < 1e-8


def test_marginals_converge():
    a = _t(_blob(32, 32, 14, 12))
    b = _t(_blob(32, 32, 18, 20, sigma=4.0))
    r = sinkhorn.solve(a, b, 2.0, max_iter=2000, tol=1e-6)
    assert float(r.marginal_error) < 1e-6
    assert float(r.cost) > 0


def test_f32_envelope_eps3():
    """float32 with the two-stage stabilized softmin is accurate to <0.1%
    at eps = 3, the documented envelope."""
    a = _t(_blob(48, 48, 24, 20), torch.float32)
    b = _t(_blob(48, 48, 24, 24), torch.float32)
    w2 = float(sinkhorn.wasserstein2_entropic(a, b, 3.0, max_iter=3000))
    assert np.isfinite(w2)
    assert abs(w2 - 4.0) < 0.01


def test_flow_recovers_translation():
    a_np = _blob(48, 56, 24, 22)
    b_np = _blob(48, 56, 27, 25)            # dy = 3, dx = 3
    r = sinkhorn.flow(_t(a_np), _t(b_np), 4.0, max_iter=2000, tol=1e-6)
    assert float(r.marginal_error) <= 1e-6
    an = a_np / a_np.sum()
    u, v = r.u.numpy(), r.v.numpy()
    assert abs((an * u).sum() - 3.0) < 5e-3
    assert abs((an * v).sum() - 3.0) < 5e-3
    sup = an > 0.05 * an.max()
    assert np.abs(u[sup] - 3.0).max() < 1e-3
    assert np.abs(v[sup] - 3.0).max() < 1e-3
    off = an <= 1e-3 * an.max()
    assert np.all(u[off] == 0) and np.all(v[off] == 0)
    raw = sinkhorn.flow(_t(a_np), _t(b_np), 4.0, max_iter=2000, tol=1e-6,
                        debias=False)
    u_raw = raw.u.numpy()
    assert abs((an * u_raw).sum() - 3.0) < 5e-3
    assert np.abs(u_raw[sup] - 3.0).max() > 0.3


def test_overrelaxation_same_fixed_point_fewer_iterations():
    a = _t(_blob(48, 48, 20, 20))
    b = _t(_blob(48, 48, 28, 26))
    base = sinkhorn.solve(a, b, 4.0, max_iter=5000, tol=1e-6, check_every=10)
    over = sinkhorn.solve(a, b, 4.0, max_iter=5000, tol=1e-6, check_every=10,
                          theta=1.5)
    assert float(base.marginal_error) <= 1e-6
    assert float(over.marginal_error) <= 1e-6
    assert abs(float(base.cost) - float(over.cost)) < 1e-3
    assert over.iterations <= base.iterations // 2


@pytest.mark.parametrize("theta", [2.3, 0.0, 2.0, -1.0, np.float32(2.5),
                                   torch.tensor(2.1)])
def test_overrelaxation_theta_validated(theta):
    """A theta outside (0, 2) raises for every entry point, whatever its
    type (the port is eager, so flow() checks it too)."""
    a = _t(_blob(24, 24, 10, 10))
    with pytest.raises(ValueError, match="theta"):
        sinkhorn.solve(a, a, 4.0, theta=theta)
    with pytest.raises(ValueError, match="theta"):
        sinkhorn.flow(a, a, 4.0, theta=theta)


def test_max_iter_hard_ceiling():
    f1, f2 = fixtures.smooth_blob_pair(12, 14)
    r = sinkhorn.solve(_t(f1), _t(f2), 4.0, max_iter=30, tol=0.0)
    assert r.iterations == 30


def test_annealed_ladder_guards():
    f1, f2 = fixtures.smooth_blob_pair(12, 14)
    a, b = _t(f1), _t(f2)
    with pytest.raises(ValueError):
        sinkhorn.solve_annealed(a, b, 4.0, anneal_factor=1.0)
    with pytest.raises(ValueError):
        sinkhorn.solve_annealed(a, b, 0.0)


def test_solve_rejects_unknown_stabilizer():
    f1, f2 = fixtures.smooth_blob_pair(12, 14)
    with pytest.raises(ValueError, match="stabilizer"):
        sinkhorn.solve(_t(f1), _t(f2), 4.0, stabilizer="bogus")


def test_exact_stabilizer_matches_matmul_when_well_conditioned():
    f1, f2 = fixtures.smooth_blob_pair(20, 24, shift=(2.0, 1.0))
    a, b = _t(f1, torch.float32), _t(f2, torch.float32)
    rm = sinkhorn.solve_annealed(a, b, 4.0, max_iter=800, tol=1e-5)
    re = sinkhorn.solve_annealed(a, b, 4.0, max_iter=800, tol=1e-5,
                                 stabilizer="exact")
    assert float(rm.marginal_error) <= 1e-5
    assert float(re.marginal_error) <= 1e-5
    assert float(re.cost) == pytest.approx(float(rm.cost), rel=1e-3)
    fm = sinkhorn.flow(a, b, 4.0, max_iter=800, tol=1e-5)
    fe = sinkhorn.flow(a, b, 4.0, max_iter=800, tol=1e-5, stabilizer="exact")
    an = f1 / f1.sum()
    sup = an > 1e-3 * an.max()
    assert np.abs(fm.u.numpy() - fe.u.numpy())[sup].max() < 1e-2
    assert np.abs(fm.v.numpy() - fe.v.numpy())[sup].max() < 1e-2


def test_exact_stabilizer_survives_f32_exp_window():
    """Corner-to-corner transport past float32's exp window: the matmul
    softmin's plan is wrong and verify=True surfaces it as a marginal
    error > 0.1; the exactly-shifted softmin converges at float32."""
    y, x = np.mgrid[0:64, 0:64].astype(np.float64)

    def mk(cy, cx):
        return np.exp(-((y - cy) ** 2 + (x - cx) ** 2) / 18) + 1e-6

    a = _t(mk(8, 8), torch.float32)
    b = _t(mk(55, 55), torch.float32)
    rm = sinkhorn.solve_annealed(a, b, 4.0, max_iter=600, tol=1e-4)
    re = sinkhorn.solve_annealed(a, b, 4.0, max_iter=600, tol=1e-4,
                                 stabilizer="exact")
    assert float(re.marginal_error) <= 1e-4, "exact path must converge"
    assert float(re.cost) == pytest.approx(2 * 47.0 ** 2, rel=0.05)
    assert float(rm.cost) < 100.0
    assert float(rm.marginal_error) > 0.1, \
        "verification no longer surfaces the exp-window failure"
    fe = sinkhorn.flow(a, b, 4.0, max_iter=600, tol=1e-4, stabilizer="exact")
    an = mk(8, 8) / mk(8, 8).sum()
    sup = an > 1e-2 * an.max()
    assert fe.u.numpy()[sup].mean() == pytest.approx(47.0, abs=2.0)
    assert fe.v.numpy()[sup].mean() == pytest.approx(47.0, abs=2.0)


def test_f32_matmul_context_restores_tf32_settings():
    """On cuda the products run with TF32 off whatever the caller set, and
    the caller's settings come back after (the flags exist without a
    card, so this holds here too); on the CPU nothing is touched.  A
    caller that mixed the process-wide precision with the cuda flag (its
    getter then raises) can still call it, and a caller that toggles the
    flag after a call still reads a consistent precision."""
    allow = torch.backends.cuda.matmul.allow_tf32
    precision = torch.get_float32_matmul_precision()
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        with sinkhorn._f32_matmul("cuda"):
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is True
        assert torch.get_float32_matmul_precision() == "high"
        with sinkhorn._f32_matmul(torch.device("cpu")):
            assert torch.get_float32_matmul_precision() == "high"
        # a mixed state: the precision set to "high", the flag turned off
        torch.backends.cuda.matmul.allow_tf32 = False
        with sinkhorn._f32_matmul("cuda"):
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is False
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = True
        with sinkhorn._f32_matmul("cuda"):
            pass
        torch.backends.cuda.matmul.allow_tf32 = False
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
        torch.set_float32_matmul_precision(precision)


def test_check_block_reads_once_per_block(monkeypatch):
    """The host loop reads the marginal error once per check block: 30
    iterations with check_every 25 are two reads (25, then 5)."""
    f1, f2 = fixtures.smooth_blob_pair(12, 14)
    reads = []
    real = torch.Tensor.__bool__

    def counting_bool(self):
        reads.append(1)
        return real(self)

    monkeypatch.setattr(torch.Tensor, "__bool__", counting_bool)
    r = sinkhorn.solve(_t(f1), _t(f2), 4.0, max_iter=30, tol=0.0,
                       verify=False)
    monkeypatch.undo()
    assert r.iterations == 30 and len(reads) == 2


@pytest.mark.parametrize("escalates", [False, True],
                         ids=["matmul", "escalating"])
def test_solve_fields_is_the_two_flow_calls_bit_for_bit(escalates):
    """``solve_fields`` against the sequence the CLI ran before it:
    ``flow`` with the matmul softmin, again with the exact one where the
    marginal error is not within tol, and m = -div(u, v) ('D' boundary).
    The plain pair is tests/test_cli.py's square moved by (4, 4) px on
    24x24, the escalating one tests/test_sinkhorn.py's exp-window pair (a
    blob moved corner to corner on 64x64), both at eps 4 in float32."""
    from ofot_tpu_torch.ops import operators
    if escalates:
        a = _t(_blob(64, 64, 8, 8, sigma=3.0), torch.float32)
        b = _t(_blob(64, 64, 55, 55, sigma=3.0), torch.float32)
    else:
        a, b = (_t(x, torch.float32) for x in fixtures.translating_square(24))
    kw = dict(max_iter=600, tol=1e-4, theta=1.0)
    res = sinkhorn.flow(a, b, 4.0, stabilizer="matmul", **kw)
    stab, me = "matmul", None
    if not bool(res.marginal_error <= 1e-4):
        stab, me = "exact", float(res.marginal_error)
        res = sinkhorn.flow(a, b, 4.0, stabilizer="exact", **kw)
    assert (stab == "exact") == escalates
    out = sinkhorn.solve_fields(a, b, 4.0, **kw)
    assert out.stabilizer == stab and out.marginal_error_matmul == me
    assert torch.equal(out.u, res.u) and torch.equal(out.v, res.v)
    assert torch.equal(out.m, -operators.div2d(res.u, res.v, bc="D"))
    for name in ("marginal_error", "cost_ab", "cost_aa"):
        assert torch.equal(getattr(out.flow, name), getattr(res, name))
    assert out.flow.iterations == res.iterations == max(
        out.iterations_ab, out.iterations_aa)


def test_solve_fields_rejects_unknown_stabilizer():
    a, b = (_t(x) for x in _pair())
    with pytest.raises(ValueError, match="unknown stabilizer"):
        sinkhorn.solve_fields(a, b, 4.0, max_iter=10, tol=1e-4,
                              stabilizer="fast")


# ------------------------------------------------- the exact softmin kernels
#
# ``_exact_stats`` sends CUDA tensors to ops/kernels/exact_softmin.py (the
# kernels run only on the card: tests/test_torch_kernels_cuda.py) and CPU
# tensors to its plain path.

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_exact_softmin_takes_the_plain_path_and_launches_nothing(dtype):
    """On the CPU ``_exact_stats`` is its plain path bit for bit, for a
    field and a lockstep batch, and neither it nor an exact solve moves a
    kernel's launch count."""
    from ofot_tpu_torch.ops import kernels
    rng = np.random.default_rng(11)
    before = kernels.launch_counts()
    for shape in ((9, 13), (2, 9, 13)):
        h = _t(rng.standard_normal(shape) * 30, dtype)
        for means in (False, True):
            got = sinkhorn._exact_stats(h, 3.0, want_means=means, chunk=4)
            want = sinkhorn._exact_stats_plain(h, 3.0, want_means=means,
                                               chunk=4)
            for g, w in zip(*((got, want) if means else ((got,), (want,)))):
                assert torch.equal(g, w)
    a, b = (_t(x, dtype) for x in _pair())
    r = sinkhorn.solve(a, b, 4.0, max_iter=5, check_every=5,
                       stabilizer="exact")
    assert r.iterations == 5
    assert kernels.launch_counts() == before


def _bad_softmin_operand(case):
    """(h, eps) that the kernels' wrapper must refuse, by case."""
    h = torch.zeros(6, 8)
    return {
        "float16": (h.half(), 1.0),
        "int64": (h.long(), 1.0),
        "cpu": (h, 1.0),
        "meta": (h.to("meta"), 1.0),
        "one_dim": (torch.zeros(8), 1.0),
        "four_dim": (torch.zeros(2, 2, 6, 8), 1.0),
        "empty": (torch.zeros(0, 8), 1.0),
        "non_contiguous": (torch.zeros(8, 6).t(), 1.0),
        "eps_tensor": (h, torch.tensor(1.0)),
        "eps_zero": (h, 0.0),
        "too_wide_float32": (torch.zeros(1, 14600), 1.0),
        "too_tall_float64": (torch.zeros(14600, 1, dtype=torch.float64),
                             1.0),
    }[case]


@pytest.mark.parametrize("means", [False, True], ids=["softmin", "stats"])
@pytest.mark.parametrize("case", [
    "float16", "int64", "cpu", "meta", "one_dim", "four_dim", "empty",
    "non_contiguous", "eps_tensor", "eps_zero", "too_wide_float32",
    "too_tall_float64"])
def test_exact_softmin_wrapper_refuses_bad_operands(case, means):
    """The wrapper refuses a wrong dtype, device, shape, layout or eps
    (a device tensor's eps would need a host read) before any launch or
    any build of the kernels."""
    from ofot_tpu_torch.ops import kernels
    from ofot_tpu_torch.ops.kernels import exact_softmin as ek
    h, eps = _bad_softmin_operand(case)
    before = kernels.launch_counts()
    with pytest.raises((TypeError, ValueError)):
        (ek.stats if means else ek.softmin)(h, eps)
    assert kernels.launch_counts() == before


def test_exact_softmin_entry_point_kernel_names_and_counters():
    """The C entry the wrapper binds, kernel names that tell the softmin
    (``exact_softmin_*``, read by the benchmark's
    ``sinkhorn.exact_softmin_ms``) from the statistics (``exact_stats_*``),
    and both launch counters in ``KERNELS``."""
    from ofot_tpu_torch.ops import kernels
    from ofot_tpu_torch.ops.kernels import _build
    from ofot_tpu_torch.ops.kernels import exact_softmin as ek
    src = (_build.SRC_DIR / "exact_softmin.cu").read_text()
    assert "int ofot_exact_softmin(" in src
    for kernel in ("exact_softmin_x", "exact_softmin_y", "exact_stats_x",
                   "exact_stats_y"):
        assert f"\n{kernel}(" in src
    for fast in ("__expf", "__logf", "use_fast_math", "__nv_bfloat16",
                 "wgmma", "mma.sync"):
        assert fast not in src
    assert kernels.KERNELS["exact_softmin"] == ("exact_softmin", "launches")
    assert kernels.KERNELS["exact_stats"] == ("exact_softmin",
                                              "stats_launches")
    assert ek.LAUNCHES_A_CALL == 2


def test_exact_softmin_ms_reads_the_softmin_kernels_alone():
    """``flowbench/metrics/sinkhorn.exact_softmin_ms.py``: per kernel of the
    softmin its seconds over its records, summed (ms); the statistics'
    kernels and every other kernel left out; None untraced or with no
    softmin kernel recorded."""
    import importlib.util
    from pathlib import Path
    path = (Path(__file__).resolve().parents[1] / "flowbench" / "metrics"
            / "sinkhorn.exact_softmin_ms.py")
    spec = importlib.util.spec_from_file_location("exact_softmin_ms", path)
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    ns = "void (anonymous namespace)::"
    kernels = {
        f"{ns}exact_softmin_x<float>(float const*, float*, int, int, "
        "float)": [4, 4 * 30e-6],
        f"{ns}exact_softmin_y<float>(float const*, float*, int, int, "
        "float)": [3, 3 * 20e-6],
        f"{ns}exact_stats_x<float>(float const*)": [2, 2 * 90e-6],
        "void at::native::elementwise_kernel<128, 2>": [10, 1.0],
    }
    rec = {"profile": {"kernels": kernels}}
    assert reader.read(rec) == pytest.approx(0.05)
    assert reader.read({"profile": None}) is None
    del kernels[f"{ns}exact_softmin_x<float>(float const*, float*, int, "
                "int, float)"]
    del kernels[f"{ns}exact_softmin_y<float>(float const*, float*, int, "
                "int, float)"]
    assert reader.read(rec) is None
