"""The port's WFR solver vs ofot_tpu.solvers.wfr, with states carried across
the two packages through the shared .npz layout.

Tolerances, each on O(1) fields:
  * float64, unfused stepB/stepC (ops ``cg`` and ``dct``) and every
    postprocessing function: 1e-10 — the same arithmetic, with sums and
    matrix products in another order;
  * float32, each of the four other ops branches (``pallas`` at alpha 1
    and 1.7, ``dct-fused``, ``cg-pallas``) against the JAX package's set of
    the same name (Pallas kernels in interpret mode): phi, q and mu to
    2e-5 absolute and crit to rtol 1e-4 over one iteration, the bounds
    tests/test_torch_foto.py holds the float32 fused FOTO set to.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl

from ofot_tpu.ops.pallas import kernels
from ofot_tpu.solvers import foto as jax_foto
from ofot_tpu.solvers import wfr as jax_wfr
from ofot_tpu.utils import checkpoint as jax_checkpoint
from ofot_tpu_torch.solvers import foto, wfr
from ofot_tpu_torch.utils import checkpoint

import fixtures

CPU = torch.device("cpu")
DELTA = 2.5
_ITER_KW = dict(r=1.0, delta=DELTA, reg_epsilon=1e-2, convergence_tol=0.01)


@pytest.fixture
def _interpret_mode(monkeypatch):
    real_call = pl.pallas_call

    def patched(*a, **kw):
        kw.setdefault("interpret", True)
        return real_call(*a, **kw)

    monkeypatch.setattr(kernels.pl, "pallas_call", patched)


def _pair(dtype, ny=16, nx=20):
    """A blob pair with a brightness change, so the source term works."""
    f1, f2 = fixtures.smooth_blob_pair(ny, nx, dtype=dtype)
    return f1, (1.3 * f2).astype(dtype)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _jax_state_after(n, f1, f2, Nt=4, ops=jax_foto.DCT_OPS, **kw):
    return jax_wfr.solve_potential(
        *_j(f1, f2), Nt, delta=DELTA, r=1.0, reg_epsilon=1e-2,
        convergence_tol=0.0, max_it=n, ops=ops, **kw)


def _carry(jax_state, tmp_path):
    path = str(tmp_path / "jax_state.npz")
    jax_checkpoint.save_state(path, jax_state)
    return checkpoint.load_state(path, CPU)


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


# ------------------------------------------------------------- modules

def test_init_state_matches_jax():
    f1, f2 = _pair(np.float64, 6, 5)
    ours = wfr.init_state(*_t(f1, f2), 5)
    theirs = jax_wfr.init_state(*_j(f1, f2), 5)
    assert ours.mu.shape == (4, 5, 6, 5)
    _assert_state_close(ours, theirs, atol=0, crit_rtol=0)


def test_G_st_matches_jax():
    phi = np.random.default_rng(3).standard_normal((4, 6, 7))
    np.testing.assert_allclose(
        wfr.G_st(torch.from_numpy(phi), DELTA).numpy(),
        np.asarray(jax_wfr.G_st(jnp.asarray(phi), DELTA)), rtol=0,
        atol=1e-15)


@pytest.mark.parametrize("solver,jax_ops", [("cg", jax_foto.DEFAULT_OPS),
                                            ("dct", jax_foto.DCT_OPS)])
@pytest.mark.parametrize("admm_alpha", [1.0, 1.7])
def test_unfused_iteration_from_jax_state(tmp_path, solver, jax_ops,
                                          admm_alpha):
    """stepA (shifted eps), the 4-component stepB/stepC and the extended
    criterion, one iteration from a JAX state, float64."""
    f1, f2 = _pair(np.float64)
    st = _jax_state_after(2, f1, f2, admm_alpha=admm_alpha)
    ours = wfr.alg2_iteration(_carry(st, tmp_path), *_t(f1, f2),
                              ops=foto.stepA_ops(solver),
                              admm_alpha=admm_alpha, **_ITER_KW)
    theirs = jax_wfr.alg2_iteration(st, *_j(f1, f2), ops=jax_ops,
                                    admm_alpha=admm_alpha, **_ITER_KW)
    _assert_state_close(ours, theirs, atol=1e-10, crit_rtol=1e-10)


@pytest.mark.usefixtures("_interpret_mode")
@pytest.mark.parametrize("solver,admm_alpha", [("pallas", 1.0),
                                               ("pallas", 1.7),
                                               ("dct-fused", 1.7),
                                               ("cg-pallas", 1.7)])
def test_kernel_sets_iteration_from_jax_state_float32(tmp_path, solver,
                                                      admm_alpha):
    """The fused branches at 4 components and the two kernel stepA sets,
    float32 as on the card, against the JAX sets of the same name."""
    f1, f2 = _pair(np.float32)
    st = _jax_state_after(3, f1, f2, admm_alpha=admm_alpha)
    assert st.mu.dtype == jnp.float32 and st.mu.shape[0] == 4
    ours = wfr.alg2_iteration(_carry(st, tmp_path), *_t(f1, f2),
                              ops=foto.stepA_ops(solver),
                              admm_alpha=admm_alpha, **_ITER_KW)
    theirs = jax_wfr.alg2_iteration(st, *_j(f1, f2),
                                    ops=jax_foto.stepA_ops(solver),
                                    admm_alpha=admm_alpha, **_ITER_KW)
    assert ours.mu.dtype == torch.float32
    _assert_state_close(ours, theirs, atol=2e-5, crit_rtol=1e-4,
                        cg_slack=1)


@pytest.mark.parametrize("auto_r", [False, True])
def test_solve_potential_matches_jax(auto_r):
    """Same stopping iteration and final state under the stopping rule."""
    f1, f2 = _pair(np.float64)
    kw = dict(delta=DELTA, r=1.0, reg_epsilon=1e-2, convergence_tol=0.1,
              max_it=60, admm_alpha=1.7, auto_r=auto_r)
    ours = wfr.solve_potential(*_t(f1, f2), 4, ops=foto.stepA_ops("dct"),
                               **kw)
    theirs = jax_wfr.solve_potential(*_j(f1, f2), 4, ops=jax_foto.DCT_OPS,
                                     **kw)
    assert 1 < ours.iteration < 60
    _assert_state_close(ours, theirs, atol=1e-9, crit_rtol=1e-7)


def test_default_ops_are_the_spectral_set():
    f1, f2 = _pair(np.float64)
    kw = dict(delta=DELTA, reg_epsilon=1e-2, convergence_tol=0.0, max_it=3)
    a = wfr.solve_potential(*_t(f1, f2), 4, **kw)
    b = wfr.solve_potential(*_t(f1, f2), 4, ops=foto.stepA_ops("dct"), **kw)
    torch.testing.assert_close(a.phi, b.phi, rtol=0, atol=0)


def test_solve_outputs_match_jax(tmp_path):
    """Flow, growth, source and the combined luminosity of one state."""
    f1, f2 = _pair(np.float64)
    st = _jax_state_after(8, f1, f2, admm_alpha=1.7)
    ours = wfr._postprocess(_carry(st, tmp_path), DELTA)
    theirs = jax_wfr._postprocess(st, DELTA)
    for a, b, name in zip(ours, theirs, ("u", "v", "m", "growth", "source")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-10, err_msg=name)
    np.testing.assert_allclose(
        wfr.combined_luminosity(ours[2], ours[3]).numpy(),
        np.asarray(jax_wfr.combined_luminosity(theirs[2], theirs[3])),
        rtol=0, atol=1e-10)


def test_scalars_match_jax(tmp_path):
    f1, f2 = _pair(np.float64)
    st = _jax_state_after(8, f1, f2)
    ours = _carry(st, tmp_path)
    for got, want in (
            (wfr.kinetic_action(ours.mu), jax_wfr.kinetic_action(st.mu)),
            (wfr.wfr_distance(ours), jax_wfr.wfr_distance(st)),
            (wfr.total_created_mass(ours, DELTA),
             jax_wfr.total_created_mass(st, DELTA))):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-12)


def test_growth_floor_zeroes_vacuum_cells():
    """The relative floor (1e-6 max rho) keeps zeta/rho out of vacuum."""
    mu = torch.zeros(4, 3, 2, 2, dtype=torch.float64)
    mu[0] = 1.0
    mu[0, :, 0, 0] = 1e-9                   # below the floor
    mu[3] = 0.1
    st = foto.FotoState(mu=mu, q=mu, phi=mu[0], crit=mu[0, 0, 0, 0],
                        prev_crit=mu[0, 0, 0, 0], iteration=0,
                        cg_iterations=0, done=torch.tensor(False))
    g = wfr.growth_from_state(st, 2.0)
    assert float(g[0, 0]) == 0.0
    np.testing.assert_allclose(float(g[1, 1]), np.exp(2 * 0.05) - 1,
                               rtol=1e-12)


@pytest.mark.parametrize("device,want", [("cpu", "dct"), ("cuda", "pallas"),
                                         (torch.device("cuda:0"), "pallas")])
def test_auto_resolves_per_device(device, want):
    assert wfr.resolve_stepA_solver("auto", device) == want
    assert wfr.resolve_stepA_solver("cg", device) == "cg"


# ----------------------------------------------------------- checkpoints

def test_checkpoint_from_jax_resumes_like_jax(tmp_path):
    """A 4-component state saved by ofot_tpu resumes in the port and
    continues as the JAX solve continues from it."""
    f1, f2 = _pair(np.float64)
    st = _jax_state_after(3, f1, f2, admm_alpha=1.7)
    resumed = _carry(st, tmp_path)
    assert resumed.mu.shape[0] == 4 and resumed.iteration == 3
    kw = dict(delta=DELTA, r=1.0, reg_epsilon=1e-2, convergence_tol=0.0,
              max_it=6, admm_alpha=1.7)
    ours = wfr.solve_potential(*_t(f1, f2), 4, ops=foto.stepA_ops("dct"),
                               init=resumed, **kw)
    theirs = jax_wfr.solve_potential(*_j(f1, f2), 4, ops=jax_foto.DCT_OPS,
                                     init=st, **kw)
    assert ours.iteration == 6
    _assert_state_close(ours, theirs, atol=1e-10, crit_rtol=1e-10)
    # and back: the port's file loads in the JAX package unchanged
    checkpoint.save_state(str(tmp_path / "port.npz"), ours)
    back = jax_checkpoint.load_state(str(tmp_path / "port.npz"))
    np.testing.assert_array_equal(np.asarray(back.mu), ours.mu.numpy())
