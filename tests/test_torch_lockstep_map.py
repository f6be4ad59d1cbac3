"""The port's lockstep batch against its own map mode and single-pair
solves, and the plain batched kernels against ``jax.vmap`` of their Pallas
twins.

* float64, stopping rule active: lockstep and map give the same per-pair
  iterations and CG steps and flows within 1e-8;
* float32 at a fixed iteration count (no stop), as JAX's
  ``test_map_mode_bitwise_equals_single_and_vmap`` runs it: AEPE < 1e-4;
* a pair that stops early keeps its final state, equal to its single-pair
  solve's, and its counters stop;
* the plain batched kernels against ``jax.vmap`` of the Pallas functions in
  interpret mode, per pair (sums included) at the single-pair tests'
  tolerances, and against single-pair calls of the port bitwise;
* the masked batched CG against single-pair CG.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ofot_tpu.ops import operators as jax_operators
from ofot_tpu.ops.pallas import kernels
from ofot_tpu_torch.ops.kernels import cg_operator as cgk
from ofot_tpu_torch.ops.kernels import dct_solve as ds
from ofot_tpu_torch.ops.kernels import fused_pointwise as fp
from ofot_tpu_torch.parallel import sweep
from ofot_tpu_torch.solvers import cg as cg_mod
from ofot_tpu_torch.solvers import foto, lockstep, wfr

import fixtures

SHIFTS = [(2.0, 1.0), (-1.0, 2.0), (0.2, 0.0)]
RNG = np.random.default_rng(7)
FOTO = dict(Nt=4, r=1.0, convergence_tol=0.1, reg_epsilon=1e-2, max_it=14)
CASES = {
    "foto-cg": ("foto", {"foto_params": dict(
        FOTO, stepA_solver="cg", max_it=6, convergence_tol=0.2)}),
    "foto-dct-refined": ("foto", {"foto_params": dict(
        FOTO, stepA_solver="dct-refined")}),
    "foto-pallas-auto-r": ("foto", {"foto_params": dict(
        FOTO, stepA_solver="pallas", admm_alpha=1.7, auto_r=True)}),
    "foto-cg-pallas": ("foto", {"foto_params": dict(
        FOTO, stepA_solver="cg-pallas", max_it=6, convergence_tol=0.2)}),
    "WFR-dct-fused": ("WFR", {"wfr_params": dict(
        FOTO, delta=2.5, convergence_tol=0.05, admm_alpha=1.7,
        stepA_solver="dct-fused")}),
    "GN": ("GN", {"gn_params": dict(alpha=0.1, lambda_=0.2)}),
    "sinkhorn": ("sinkhorn", {"sinkhorn_params": dict(
        epsilon=4.0, max_iter=200, tol=1e-5, check_every=5,
        anneal=False)}),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small shapes: one intra-op thread, so that the suite's parallel
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def _interpret_mode(monkeypatch):
    real_call = pl.pallas_call

    def patched(*a, **kw):
        kw.setdefault("interpret", True)
        return real_call(*a, **kw)

    monkeypatch.setattr(kernels.pl, "pallas_call", patched)


def _frames(dtype):
    pairs = [fixtures.smooth_blob_pair(18, 20, shift=s) for s in SHIFTS]
    return (np.stack([np.asarray(a, dtype) for a, _ in pairs]),
            np.stack([np.asarray(b, dtype) for _, b in pairs]))


@pytest.mark.parametrize("case", list(CASES))
def test_lockstep_matches_map_float64(case):
    algo, params = CASES[case]
    f1s, f2s = _frames(np.float64)
    got = sweep.solve_batch_full(algo, f1s, f2s, batch_mode="vmap",
                                 device="cpu", **params)
    want = sweep.solve_batch_full(algo, f1s, f2s, batch_mode="map",
                                  device="cpu", **params)
    assert set(got[3]) == set(want[3])
    for key in ("iterations", "inner_iterations", "converged"):
        if key in got[3]:
            np.testing.assert_array_equal(got[3][key], want[3][key],
                                          err_msg=key)
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == torch.float64
        torch.testing.assert_close(a, b, rtol=0, atol=1e-8)


@pytest.mark.parametrize("algo,params", [
    ("foto", {"foto_params": dict(FOTO, convergence_tol=0.0, max_it=5,
                                  stepA_solver="pallas", admm_alpha=1.7)}),
    ("WFR", {"wfr_params": dict(FOTO, convergence_tol=0.0, max_it=5,
                                delta=2.5, stepA_solver="dct")})])
def test_lockstep_matches_map_float32_fixed_iterations(algo, params):
    f1s, f2s = _frames(np.float32)
    u, v, _, diag = sweep.solve_batch_full(algo, f1s, f2s,
                                           batch_mode="vmap", device="cpu",
                                           **params)
    mu, mv, _, mdiag = sweep.solve_batch_full(algo, f1s, f2s, device="cpu",
                                              **params)
    assert diag["iterations"].tolist() == mdiag["iterations"].tolist() \
        == [5, 5, 5]
    aepe = torch.sqrt((u - mu) ** 2 + (v - mv) ** 2).mean(dim=(1, 2))
    assert aepe.max() < 1e-4, aepe


@pytest.mark.parametrize("module", [foto, wfr])
def test_a_done_pair_stays_put(module):
    """Pair 2 stops well before the others: its lockstep state equals its
    single-pair solve's and its counters stop where that solve's do."""
    f1s, f2s = (torch.from_numpy(f) for f in _frames(np.float64))
    kw = dict(FOTO, ops=foto.stepA_ops("dct"), admm_alpha=1.7)
    Nt = kw.pop("Nt")
    if module is wfr:
        kw["delta"] = 2.5
    batch = module.solve_potential_batched(f1s, f2s, Nt, **kw)
    its = batch.iteration.tolist()
    assert its[2] < min(its[0], its[1])
    for i in range(3):
        one = module.solve_potential(f1s[i], f2s[i], Nt, **kw)
        pair = lockstep.pair(batch, i)
        assert int(pair.iteration) == one.iteration
        assert int(pair.cg_iterations) == one.cg_iterations
        assert bool(pair.done) == bool(one.done)
        for name in ("mu", "q", "phi", "crit", "prev_crit"):
            torch.testing.assert_close(getattr(pair, name),
                                       getattr(one, name), rtol=0,
                                       atol=1e-12, msg=name)


def test_a_nan_pair_stops_and_leaves_the_others():
    f1s, f2s = (torch.from_numpy(f) for f in _frames(np.float64))
    f1s[1, 3, 4] = float("nan")
    kw = dict(FOTO, ops=foto.stepA_ops("dct"))
    Nt = kw.pop("Nt")
    batch = foto.solve_potential_batched(f1s, f2s, Nt, **kw)
    assert batch.iteration[1] == 1 and bool(batch.done[1])
    assert torch.isnan(batch.crit[1])
    one = foto.solve_potential(f1s[0], f2s[0], Nt, **kw)
    assert int(batch.iteration[0]) == one.iteration
    torch.testing.assert_close(batch.phi[0], one.phi, rtol=0, atol=1e-12)


# ------------------------------------------------------------- the kernels

def _vmap_fused(g, m, r, alpha, qp):
    """jax.vmap of the Pallas fused pass over pairs, r per pair."""
    if qp is None:
        fn = jax.vmap(lambda a, b, rr: kernels.fused_pointwise_pallas(
            a, b, rr))
        return fn(jnp.asarray(g), jnp.asarray(m), jnp.asarray(r))
    fn = jax.vmap(lambda a, b, rr, c: kernels.fused_pointwise_pallas(
        a, b, rr, alpha=alpha, q_prev=c))
    return fn(jnp.asarray(g), jnp.asarray(m), jnp.asarray(r),
              jnp.asarray(qp))


@pytest.mark.usefixtures("_interpret_mode")
@pytest.mark.parametrize("ncomp", [3, 4])
@pytest.mark.parametrize("alpha", [None, 1.7])
def test_batched_fused_pointwise_matches_jax_vmap(ncomp, alpha):
    B, shape = 3, (4, 10, 18)
    full = (B, ncomp) + shape
    g = RNG.uniform(-2, 2, full).astype(np.float32)
    m = RNG.uniform(-1, 2, full).astype(np.float32)
    qp = (RNG.uniform(-2, 1, full).astype(np.float32)
          if alpha is not None else None)
    r = np.asarray([1.0, 1.3, 0.7], np.float32)
    t = [None if a is None else torch.from_numpy(a) for a in (g, m, qp)]
    got = fp.fused_pointwise_batched(t[0], t[1], torch.from_numpy(r),
                                     alpha=alpha, q_prev=t[2])
    want = _vmap_fused(g, m, r, alpha, qp)
    for a, b, name in zip(got[:2], want[:2], ("q", "mu")):
        assert a.shape == full
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-6,
                                   rtol=1e-5, err_msg=name)
    for a, b, name in zip(got[2:], want[2:], ("num", "den")):
        assert a.shape == (B,)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   err_msg=name)
    # each pair is its single-pair call, bitwise; a float r is every
    # pair's r
    for i in range(B):
        one = fp.fused_pointwise(t[0][i], t[1][i], float(r[i]), alpha,
                                 None if qp is None else t[2][i])
        for a, b in zip(got, one):
            assert torch.equal(a[i], b)
    same = fp.fused_pointwise_batched(t[0], t[1], 1.3, alpha, t[2])
    one = fp.fused_pointwise(t[0][1], t[1][1], 1.3, alpha,
                             None if qp is None else t[2][1])
    assert all(torch.equal(a[1], b) for a, b in zip(same, one))


@pytest.mark.usefixtures("_interpret_mode")
def test_batched_dct_solve_matches_jax_vmap():
    F = RNG.standard_normal((3, 4, 10, 12)).astype(np.float32)
    r = np.asarray([1.0, 2.5, 0.3], np.float32)
    got = ds.dct_solve(torch.from_numpy(F), torch.from_numpy(r), 1e-2)
    want = jax.vmap(lambda f, rr: kernels.dct_solve_pallas(f, rr, 1e-2))(
        jnp.asarray(F), jnp.asarray(r))
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=5e-6 * scale)
    for i in range(3):
        one = ds.dct_solve(torch.from_numpy(F[i]), float(r[i]), 1e-2)
        assert torch.equal(got[i], one)
    with pytest.raises(ValueError, match="per-pair r"):
        ds.dct_solve(torch.from_numpy(F[0]), torch.from_numpy(r), 1e-2)


@pytest.mark.usefixtures("_interpret_mode")
def test_batched_cg_operator_matches_jax_per_pair():
    """Per pair, at the pair boundaries too: the JAX stencil and the JAX
    blocked Pallas operator of each pair alone, and the port's single-pair
    call bitwise.  A pair's first and last planes hold extreme values, so
    a stencil reading across pairs would show."""
    x = RNG.standard_normal((3, 5, 9, 12)).astype(np.float32)
    x[:, 0] += 50.0
    x[:, -1] -= 50.0
    r = np.asarray([1.0, 2.0, 0.5], np.float32)
    for fn in (cgk.cg_operator, cgk.cg_operator_blocked):
        got = fn(torch.from_numpy(x), torch.from_numpy(r), 1e-2).numpy()
        for i in range(3):
            rr = float(r[i])
            stencil = (-rr * jax_operators.laplacian_st(
                jnp.asarray(x[i]), bc="N") + rr * 1e-2 * jnp.asarray(x[i]))
            np.testing.assert_allclose(got[i], np.asarray(stencil),
                                       rtol=0, atol=1e-4)
            blocked = kernels.cg_operator_pallas_blocked(
                jnp.asarray(x[i]), rr, 1e-2)
            np.testing.assert_allclose(got[i], np.asarray(blocked),
                                       rtol=0, atol=1e-4)
            one = fn(torch.from_numpy(x[i]), rr, 1e-2)
            assert torch.equal(torch.from_numpy(got[i]), one)


def test_cg_batched_matches_single_and_freezes_converged_pairs():
    """Each pair stops on its own residual with its own count; a pair whose
    right-hand side is 0 converges at step 0 and stays exactly 0 (its
    p.Ap is 0, so its alpha is NaN, which the select keeps out)."""
    rng = np.random.default_rng(3)
    n = 24
    mats = []
    for shift in (0.5, 3.0, 20.0, 1.0):
        q = rng.standard_normal((n, n))
        mats.append(q @ q.T + shift * np.eye(n))
    A = torch.from_numpy(np.stack(mats))
    b = torch.from_numpy(rng.standard_normal((4, n)))
    b[3] = 0.0

    def apply(x):
        return torch.einsum("bij,bj->bi", A, x)

    res = cg_mod.cg_batched(apply, b, rtol=1e-10, maxiter=500)
    assert res.iterations[3] == 0 and bool(res.converged[3])
    assert torch.equal(res.x[3], torch.zeros(n, dtype=torch.float64))
    for i in range(3):
        one = cg_mod.cg(lambda v: A[i] @ v, b[i], rtol=1e-10, maxiter=500)
        assert int(res.iterations[i]) == one.iterations
        assert bool(res.converged[i]) == one.converged
        torch.testing.assert_close(res.x[i], one.x, rtol=0, atol=1e-9)
    capped = cg_mod.cg_batched(apply, b, rtol=1e-10, maxiter=3)
    assert capped.iterations.tolist() == [3, 3, 3, 0]
    assert not bool(capped.converged[0])
