"""The port's FOTO solver vs ofot_tpu.solvers.foto, with states carried
across the two packages through the shared .npz layout.

Tolerances, each on O(1) fields:
  * float64, unfused stepB/stepC (ops ``cg`` and ``dct``): 1e-10 — the same
    arithmetic, with sums and matrix products in another order;
  * float32, fused pass (ops ``pallas``; the Pallas kernel in interpret
    mode): phi, q and mu to 2e-5 absolute and crit to rtol 1e-4 — float32
    rounding of the spectral solve's six products (relative ~1e-6) and of
    the criterion sums, over one iteration.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl

from ofot_tpu.ops.pallas import kernels
from ofot_tpu.solvers import foto as jax_foto
from ofot_tpu.utils import checkpoint as jax_checkpoint
from ofot_tpu_torch.solvers import foto
from ofot_tpu_torch.utils import checkpoint

import fixtures

CPU = torch.device("cpu")


@pytest.fixture
def _interpret_mode(monkeypatch):
    real_call = pl.pallas_call

    def patched(*a, **kw):
        kw.setdefault("interpret", True)
        return real_call(*a, **kw)

    monkeypatch.setattr(kernels.pl, "pallas_call", patched)


def _pair(dtype, ny=16, nx=20):
    return fixtures.smooth_blob_pair(ny, nx, dtype=dtype)


def _jax_state_after(n, f1, f2, Nt=4, **kw):
    """A JAX ALG2 state after ``n`` iterations (tol 0: no early stop)."""
    return jax_foto.solve_potential(
        jnp.asarray(f1), jnp.asarray(f2), Nt, r=1.0, reg_epsilon=1e-2,
        convergence_tol=0.0, max_it=n, ops=jax_foto.DCT_OPS, **kw)


def _carry(jax_state, tmp_path, dtype=None):
    """Save with the JAX package, load with the port."""
    path = str(tmp_path / "jax_state.npz")
    jax_checkpoint.save_state(path, jax_state)
    return checkpoint.load_state(path, CPU, dtype)


def _assert_state_close(ours, theirs, atol, crit_rtol, cg_slack=0):
    for name in ("mu", "q", "phi"):
        np.testing.assert_allclose(getattr(ours, name).numpy(),
                                   np.asarray(getattr(theirs, name)),
                                   rtol=0, atol=atol, err_msg=name)
    np.testing.assert_allclose(float(ours.crit), float(theirs.crit),
                               rtol=crit_rtol)
    np.testing.assert_allclose(float(ours.prev_crit),
                               float(theirs.prev_crit), rtol=crit_rtol)
    assert ours.iteration == int(theirs.iteration)
    assert abs(ours.cg_iterations - int(theirs.cg_iterations)) <= cg_slack
    assert bool(ours.done) == bool(theirs.done)


_ITER_KW = dict(r=1.0, reg_epsilon=1e-2, convergence_tol=0.01)


@pytest.mark.parametrize("solver,jax_ops", [("cg", jax_foto.DEFAULT_OPS),
                                            ("dct", jax_foto.DCT_OPS)])
@pytest.mark.parametrize("admm_alpha", [1.0, 1.7])
def test_unfused_iteration_from_jax_state(tmp_path, solver, jax_ops,
                                          admm_alpha):
    f1, f2 = _pair(np.float64)
    st = _jax_state_after(2, f1, f2, admm_alpha=admm_alpha)
    ours = foto.alg2_iteration(
        _carry(st, tmp_path), torch.from_numpy(f1), torch.from_numpy(f2),
        ops=foto.stepA_ops(solver), admm_alpha=admm_alpha, **_ITER_KW)
    theirs = jax_foto.alg2_iteration(
        st, jnp.asarray(f1), jnp.asarray(f2), ops=jax_ops,
        admm_alpha=admm_alpha, **_ITER_KW)
    _assert_state_close(ours, theirs, atol=1e-10, crit_rtol=1e-10)


@pytest.mark.usefixtures("_interpret_mode")
@pytest.mark.parametrize("admm_alpha", [1.0, 1.7])
def test_fused_iteration_from_jax_state(tmp_path, admm_alpha):
    """Both fused branches (alpha = 1 and the over-relaxed one) against the
    JAX Pallas ops set, float32 as on the chip."""
    f1, f2 = _pair(np.float32)
    st = _jax_state_after(3, f1, f2, admm_alpha=admm_alpha)
    assert st.mu.dtype == jnp.float32
    ours = foto.alg2_iteration(
        _carry(st, tmp_path), torch.from_numpy(f1), torch.from_numpy(f2),
        ops=foto.stepA_ops("pallas"), admm_alpha=admm_alpha, **_ITER_KW)
    theirs = jax_foto.alg2_iteration(
        st, jnp.asarray(f1), jnp.asarray(f2), ops=jax_foto.PALLAS_OPS,
        admm_alpha=admm_alpha, **_ITER_KW)
    assert ours.mu.dtype == torch.float32
    _assert_state_close(ours, theirs, atol=2e-5, crit_rtol=1e-4)


@pytest.mark.parametrize("admm_alpha", [1.0, 1.7])
def test_fused_and_unfused_ops_agree(admm_alpha):
    """The pallas ops set (plain fused pass on CPU) tracks the dct set."""
    f1, f2 = (torch.from_numpy(a) for a in _pair(np.float64))
    kw = dict(r=1.0, reg_epsilon=1e-2, convergence_tol=0.0, max_it=6,
              admm_alpha=admm_alpha)
    a = foto.solve_potential(f1, f2, 4, ops=foto.stepA_ops("dct"), **kw)
    b = foto.solve_potential(f1, f2, 4, ops=foto.stepA_ops("pallas"), **kw)
    torch.testing.assert_close(a.phi, b.phi, rtol=0, atol=1e-10)
    torch.testing.assert_close(a.crit, b.crit, rtol=1e-10, atol=0)


@pytest.mark.parametrize("solver,jax_ops,atol", [
    # CG stops each stepA at rtol 1e-6: over some 1e3 CG steps the two
    # packages' differently ordered dot products move its iterates by up
    # to ~1e-6 of the O(1e-2) fields, and a residual that sits on the
    # threshold within roundoff may stop one CG step earlier or later
    ("cg", jax_foto.DEFAULT_OPS, 1e-7),
    ("dct", jax_foto.DCT_OPS, 1e-9)])
def test_solve_potential_matches_jax(solver, jax_ops, atol):
    """Same stopping iteration and final state under the stopping rule."""
    f1, f2 = _pair(np.float64)
    kw = dict(r=1.0, reg_epsilon=1e-2, convergence_tol=0.1, max_it=40,
              admm_alpha=1.7)
    ours = foto.solve_potential(torch.from_numpy(f1), torch.from_numpy(f2),
                                4, ops=foto.stepA_ops(solver), **kw)
    theirs = jax_foto.solve_potential(jnp.asarray(f1), jnp.asarray(f2), 4,
                                      ops=jax_ops, **kw)
    assert 1 < ours.iteration < 40
    _assert_state_close(ours, theirs, atol=atol, crit_rtol=100 * atol,
                        cg_slack=ours.iteration if solver == "cg" else 0)


def test_auto_r_matches_jax():
    f1, f2 = _pair(np.float64)
    f1, f2 = f1 / f1.sum(), f2 / f2.sum()
    kw = dict(r=1.0, reg_epsilon=1e-2, convergence_tol=0.0, max_it=3,
              auto_r=True)
    ours = foto.solve_potential(torch.from_numpy(f1), torch.from_numpy(f2),
                                4, ops=foto.stepA_ops("dct"), **kw)
    theirs = jax_foto.solve_potential(jnp.asarray(f1), jnp.asarray(f2), 4,
                                      ops=jax_foto.DCT_OPS, **kw)
    np.testing.assert_allclose(ours.phi.numpy(), np.asarray(theirs.phi),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        float(foto.scale_invariant_r(torch.from_numpy(f1),
                                     torch.from_numpy(f2))),
        float(jax_foto.scale_invariant_r(jnp.asarray(f1), jnp.asarray(f2))),
        rtol=1e-15)


def test_history_matches_jax_and_keeps_iterating():
    f1, f2 = _pair(np.float64)
    kw = dict(r=1.0, reg_epsilon=1e-2, admm_alpha=1.7)
    st, hist = foto.solve_potential_with_history(
        torch.from_numpy(f1), torch.from_numpy(f2), 4, 12,
        ops=foto.stepA_ops("dct"), **kw)
    jst, jhist = jax_foto.solve_potential_with_history(
        jnp.asarray(f1), jnp.asarray(f2), 4, 12, ops=jax_foto.DCT_OPS, **kw)
    assert st.iteration == 12 and hist["crit"].shape == (12,)
    np.testing.assert_allclose(hist["crit"].numpy(), np.asarray(jhist["crit"]),
                               rtol=1e-9)
    np.testing.assert_array_equal(hist["cg"].numpy(), np.asarray(jhist["cg"]))
    np.testing.assert_allclose(st.phi.numpy(), np.asarray(jst.phi), rtol=0,
                               atol=1e-10)


def test_init_state_matches_jax():
    f1, f2 = _pair(np.float64, 6, 5)
    ours = foto.init_state(torch.from_numpy(f1), torch.from_numpy(f2), 5)
    theirs = jax_foto.init_state(jnp.asarray(f1), jnp.asarray(f2), 5)
    _assert_state_close(ours, theirs, atol=0, crit_rtol=0)


def test_nan_criterion_stops_the_loop():
    """Divergence guard: a NaN criterion ends the solve at once."""
    f1, f2 = _pair(np.float64)
    f1[3, 3] = np.nan
    st = foto.solve_potential(torch.from_numpy(f1), torch.from_numpy(f2), 4,
                              reg_epsilon=1e-2, max_it=50,
                              ops=foto.stepA_ops("dct"))
    assert st.iteration == 1 and bool(st.done)
    assert torch.isnan(st.crit)


def test_stagnation_rule_matches_jax():
    """With a tolerance no iterate reaches, the stagnation rule
    |prev - crit| < 1e-5 ends both solves at the same iteration."""
    f1, f2 = _pair(np.float64, 12, 14)
    kw = dict(r=1.0, reg_epsilon=1e-2, convergence_tol=1e-9, max_it=400)
    ours = foto.solve_potential(torch.from_numpy(f1), torch.from_numpy(f2),
                                3, ops=foto.stepA_ops("dct"), **kw)
    theirs = jax_foto.solve_potential(jnp.asarray(f1), jnp.asarray(f2), 3,
                                      ops=jax_foto.DCT_OPS, **kw)
    assert ours.iteration < 400
    assert ours.iteration == int(theirs.iteration)
    assert abs(float(ours.crit) - float(ours.prev_crit)) < 1e-5


def test_kinetic_action_and_w2_match_jax():
    f1, f2 = _pair(np.float64)
    st = _jax_state_after(5, f1, f2)
    ours = checkpoint.state_from_arrays(
        {k: np.asarray(v) for k, v in st._asdict().items()}, CPU)
    np.testing.assert_allclose(float(foto.kinetic_action(ours.mu)),
                               float(jax_foto.kinetic_action(st.mu)),
                               rtol=1e-12)
    np.testing.assert_allclose(float(foto.wasserstein2(ours)),
                               float(jax_foto.wasserstein2(st)), rtol=1e-12)


def test_solve_returns_flow_of_the_potential():
    from ofot_tpu_torch.solvers import flow_extract
    f1, f2 = (torch.from_numpy(a) for a in _pair(np.float64))
    res = foto.solve(f1, f2, 4, reg_epsilon=1e-2, max_it=3,
                     ops=foto.stepA_ops("dct"))
    u, v, m = flow_extract.flow_from_potential(res.state.phi)
    for a, b in zip((res.u, res.v, res.m), (u, v, m)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ----------------------------------------------------------- checkpoints

def test_checkpoint_from_jax_resumes_like_jax(tmp_path):
    """A state saved by ofot_tpu resumes in the port and continues exactly
    as the JAX solve continues from it."""
    f1, f2 = _pair(np.float64)
    st = _jax_state_after(3, f1, f2)
    ours = foto.solve_potential(
        torch.from_numpy(f1), torch.from_numpy(f2), 4, r=1.0,
        reg_epsilon=1e-2, convergence_tol=0.0, max_it=6,
        ops=foto.stepA_ops("dct"), init=_carry(st, tmp_path))
    theirs = jax_foto.solve_potential(
        jnp.asarray(f1), jnp.asarray(f2), 4, r=1.0, reg_epsilon=1e-2,
        convergence_tol=0.0, max_it=6, ops=jax_foto.DCT_OPS, init=st)
    assert ours.iteration == 6
    _assert_state_close(ours, theirs, atol=1e-10, crit_rtol=1e-10)


def test_checkpoint_layout_round_trips_both_ways(tmp_path):
    f1, f2 = _pair(np.float32)
    st = _jax_state_after(2, f1, f2)
    ours = _carry(st, tmp_path)
    checkpoint.save_state(str(tmp_path / "port"), ours)
    with np.load(tmp_path / "port.npz") as a, \
            np.load(tmp_path / "jax_state.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    back = jax_checkpoint.load_state(str(tmp_path / "port.npz"))
    for k in jax_foto.FotoState._fields:
        np.testing.assert_array_equal(np.asarray(getattr(back, k)),
                                      np.asarray(getattr(st, k)), err_msg=k)


def test_state_from_arrays_casts_on_request():
    f1, f2 = _pair(np.float64, 6, 5)
    st = foto.init_state(torch.from_numpy(f1), torch.from_numpy(f2), 3)
    back = checkpoint.state_from_arrays(checkpoint.state_to_arrays(st), CPU,
                                        torch.float32)
    assert back.mu.dtype == back.crit.dtype == torch.float32
    assert back.iteration == 0 and not bool(back.done)


# ----------------------------------------------------------- ops sets

@pytest.mark.parametrize("device,want", [("cpu", "cg"), ("cuda", "pallas"),
                                         (torch.device("cuda:0"), "pallas")])
def test_auto_resolves_per_device(device, want):
    assert foto.resolve_stepA_solver("auto", device) == want
    assert foto.resolve_stepA_solver("dct", device) == "dct"


def test_unknown_solver_raises():
    with pytest.raises(ValueError, match="unknown"):
        foto.stepA_ops("bogus")


def test_ops_sets_are_fresh_and_only_pallas_fuses():
    assert foto.stepA_ops("dct") is not foto.stepA_ops("dct")
    assert getattr(foto.stepA_ops("pallas"), "fused_pointwise", None)
    for name in ("cg", "dct", "dct-fused", "cg-pallas"):
        assert getattr(foto.stepA_ops(name), "fused_pointwise", None) is None


@pytest.mark.usefixtures("_interpret_mode")
@pytest.mark.parametrize("name,jax_ops,cg_slack", [
    ("dct-fused", jax_foto.DCTFusedOps(), 0),
    ("cg-pallas", jax_foto.PallasCGOps(), 1)])
def test_kernel_stepA_sets_iteration_from_jax_state(tmp_path, name, jax_ops,
                                                    cg_slack):
    """The sets that replaced the later-slice errors: one float64 iteration
    from a JAX state against the JAX set of the same name (its Pallas
    kernel in interpret mode), at the unfused sets' 1e-10."""
    f1, f2 = _pair(np.float64)
    st = _jax_state_after(2, f1, f2, admm_alpha=1.7)
    ours = foto.alg2_iteration(
        _carry(st, tmp_path), torch.from_numpy(f1), torch.from_numpy(f2),
        ops=foto.stepA_ops(name), admm_alpha=1.7, **_ITER_KW)
    theirs = jax_foto.alg2_iteration(
        st, jnp.asarray(f1), jnp.asarray(f2), ops=jax_ops, admm_alpha=1.7,
        **_ITER_KW)
    _assert_state_close(ours, theirs, atol=1e-10, crit_rtol=1e-10,
                        cg_slack=cg_slack)
