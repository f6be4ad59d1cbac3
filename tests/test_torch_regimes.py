"""Regression guards: the port in the regimes of nine JAX tests that no
other port test reaches, each held against the JAX package on the same
numpy inputs at float64 and by the property the JAX test asserts.

  * ``tests/test_wfr.py``: ``TestProjectionNd::test_kkt_conditions`` at
    k = 1 and 5 (``ops/projection.py:project_paraboloid_nd``), the delta
    -> inf limit against balanced FOTO, pure growth, translation with
    brightening, and the ~pi*delta/2 transport cutoff at delta 2.5 and 10;
  * ``tests/test_foto.py::TestAutoR``: the exact invariance of ``auto_r``
    and the unit-mass stall it fixes;
  * ``tests/test_sinkhorn.py::test_matches_dynamic_w2``;
  * ``tests/test_pipeline.py::test_escalation_triggers_on_nan``, against
    the port's ``cli/pipeline.py:_maybe_escalate_sinkhorn``.

Tolerances (measured on an AMD EPYC CPU, both packages at float64): the same
iteration counts; phi within PHI_ATOL = 1e-10 (measured at most 1.9e-13
on O(10) potentials); the projection within 1e-12 (the same closed form);
W2, the WFR distance and the created mass within REL = 1e-10 relative
(measured 6e-16 to 1.1e-15); the mass-weighted flows within 1e-10.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures
from ofot_tpu.cli import pipeline as jax_pipeline
from ofot_tpu.ops.projection import project_paraboloid_nd as jax_project_nd
from ofot_tpu.solvers import flow_extract as jax_flow
from ofot_tpu.solvers import foto as jax_foto
from ofot_tpu.solvers import sinkhorn as jax_sinkhorn
from ofot_tpu.solvers import wfr as jax_wfr
from ofot_tpu_torch.cli import pipeline
from ofot_tpu_torch.ops.projection import project_paraboloid_nd
from ofot_tpu_torch.solvers import flow_extract, foto, sinkhorn, wfr

PHI_ATOL = 1e-10
PROJ_ATOL = 1e-12
REL = 1e-10


def _blob(ny, nx, cy, cx, s=6.0):
    y, x = np.mgrid[0:ny, 0:nx].astype(np.float64)
    return np.exp(-(((y - cy) / s) ** 2 + ((x - cx) / s) ** 2))


def _gap(ours, theirs) -> float:
    return float(np.abs(ours.numpy() - np.asarray(theirs)).max())


def _rel(ours, theirs) -> float:
    return abs(float(ours) - float(theirs)) / abs(float(theirs))


def _same_state(ours, theirs):
    assert int(ours.iteration) == int(theirs.iteration)
    assert _gap(ours.phi, theirs.phi) < PHI_ATOL


# ------------------------------------------------------------- projection

@pytest.mark.parametrize("k", [1, 5])
def test_projection_nd_kkt_conditions_match_jax(k):
    """The projected point is in K; an outside point lands on the boundary
    with (p - p_hat) along the constraint normal (1, b_hat) with a
    nonnegative multiplier; and the port's projection is JAX's."""
    p = np.random.default_rng(7 + k).standard_normal((1 + k, 2000))
    ph = project_paraboloid_nd(torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(ph, np.asarray(jax_project_nd(jnp.asarray(p))),
                               rtol=0, atol=PROJ_ATOL)
    a, b = ph[0], ph[1:]
    g = a + 0.5 * np.sum(b * b, axis=0)
    assert g.max() < 1e-9
    outside = (p[0] + 0.5 * np.sum(p[1:] ** 2, axis=0)) > 1e-9
    assert outside.any() and (~outside).any()
    assert abs(g[outside]).max() < 1e-9
    lam = p[0][outside] - a[outside]
    assert lam.min() > -1e-9
    resid = p[1:][:, outside] - b[:, outside] - lam[None] * b[:, outside]
    assert abs(resid).max() < 1e-7


# -------------------------------------------------------------------- WFR

def _wfr_solves(r0, rT, **kw):
    """wfr.solve in both packages on the same float64 frames."""
    ours = wfr.solve(torch.from_numpy(r0), torch.from_numpy(rT), 8, **kw)
    theirs = jax_wfr.solve(jnp.asarray(r0), jnp.asarray(rT), 8, **kw)
    _same_state(ours.state, theirs.state)
    for name in ("u", "v", "growth"):
        assert _gap(getattr(ours, name), getattr(theirs, name)) < PHI_ATOL
    return ours, theirs


def _translated_pair():
    a, b = _blob(48, 48, 24, 22), _blob(48, 48, 24, 26)
    a, b = a / a.sum(), b / b.sum()
    s = max(a.max(), b.max())
    return a / s, b / s


def test_delta_inf_matches_balanced():
    """delta -> inf turns the source off: the potential and the distance
    are balanced FOTO's, in both packages, over 150 full iterations."""
    r0, rT = _translated_pair()
    kw = dict(r=0.1, reg_epsilon=1e-3, convergence_tol=0.0, max_it=150)
    t0, tT = torch.from_numpy(r0), torch.from_numpy(rT)
    j0, jT = jnp.asarray(r0), jnp.asarray(rT)
    stW = wfr.solve_potential(t0, tT, 8, delta=1e4, **kw)
    stF = foto.solve_potential(t0, tT, 8, ops=foto.DCT_OPS, **kw)
    jW = jax_wfr.solve_potential(j0, jT, 8, delta=1e4, **kw)
    jF = jax_foto.solve_potential(j0, jT, 8, ops=jax_foto.DCT_OPS, **kw)
    _same_state(stW, jW)
    _same_state(stF, jF)
    assert int(stW.iteration) == int(stF.iteration) == 150
    assert float((stW.phi - stF.phi).abs().max()) < 1e-3
    w2, d = float(foto.wasserstein2(stF)), float(wfr.wfr_distance(stW))
    assert _rel(w2, jax_foto.wasserstein2(jF)) < REL
    assert _rel(d, jax_wfr.wfr_distance(jW)) < REL
    assert abs(d - w2) / w2 < 1e-4
    assert float(stW.mu[3].abs().max()) < 1e-3


def test_pure_growth():
    """The same blob at 1.5x the mass: pure Fisher-Rao, no transport; the
    source creates the added mass (JAX: 197 iterations, created mass
    58.8769)."""
    a = _blob(48, 48, 24, 24)
    a = a / a.sum()
    r0 = a / a.max()
    rT = 1.5 * r0
    ours, theirs = _wfr_solves(r0, rT, delta=5.0, r=0.1, reg_epsilon=1e-3,
                               convergence_tol=0.0, max_it=300)
    created = float(wfr.total_created_mass(ours.state, 5.0))
    assert _rel(created, jax_wfr.total_created_mass(theirs.state, 5.0)) < REL
    sup = r0 > 0.1
    assert abs(ours.u.numpy()[sup]).max() < 0.5
    assert abs(ours.v.numpy()[sup]).max() < 0.5
    want = float(np.sum(rT - r0))
    assert abs(created - want) / want < 0.1
    assert abs(float(ours.growth[24, 24]) - 0.5) < 0.12


def test_translation_with_brightening():
    """A blob moving 4 px and brightening 40%: the flow tracks the shift
    while the source takes the brightening."""
    a = _blob(48, 48, 24, 22)
    b = 1.4 * _blob(48, 48, 24, 26)
    sc = a.max()
    r0, rT = a / sc, b / sc
    ours, theirs = _wfr_solves(r0, rT, delta=20.0, r=0.1, reg_epsilon=1e-3,
                               convergence_tol=0.0, max_it=150)
    sup = r0 > 0.1
    u, v = ours.u.numpy(), ours.v.numpy()
    assert abs(u[sup].mean() - np.asarray(theirs.u)[sup].mean()) < REL
    assert 3.0 < u[sup].mean() < 4.5
    assert abs(v[sup].mean()) < 0.2
    assert float(ours.growth[24, 26]) > 0.15
    created = float(wfr.total_created_mass(ours.state, 20.0))
    assert _rel(created, jax_wfr.total_created_mass(theirs.state, 20.0)) < REL
    want = float(np.sum(rT - r0))
    assert abs(created - want) / want < 0.25


@pytest.mark.parametrize("delta,lo,hi", [(2.5, None, 2.0), (10.0, 3.5, None)])
def test_delta_transport_cutoff_regimes(delta, lo, hi):
    """The ~pi*delta/2 transport cutoff on a 5 px blob translation: below
    it most of the motion is absorbed as growth (JAX: the 400-iteration
    budget at delta 2.5), well above it the transport recovers most of the
    shift (127 iterations at delta 10)."""
    f1, f2 = fixtures.smooth_blob_pair(28, 32, shift=(0.0, 5.0))
    sup = f1 > 0.25 * f1.max()
    ours, theirs = _wfr_solves(f1, f2, delta=delta, r=0.1, reg_epsilon=1e-3,
                               convergence_tol=0.05, max_it=400)
    mean_u = float(ours.u.numpy()[sup].mean())
    assert abs(mean_u - float(np.asarray(theirs.u)[sup].mean())) < REL
    assert (lo is None or mean_u > lo) and (hi is None or mean_u < hi)


# ------------------------------------------------------------ FOTO auto_r

class TestAutoR:
    """The scale-invariant ADMM penalty (``auto_r``) in both packages."""

    def _pair(self):
        y, x = np.mgrid[0:32, 0:36].astype(np.float64)

        def blob(cy, cx):
            return np.exp(-(((y - cy) / 5.0) ** 2 + ((x - cx) / 5.0) ** 2))

        a, b = blob(16, 14), blob(16, 18)
        return a / a.sum(), b / b.sum()      # unit mass: peak ~8e-3

    def _solves(self, a, b, **kw):
        ours = foto.solve_potential(torch.from_numpy(a), torch.from_numpy(b),
                                    6, ops=foto.DCT_OPS, **kw)
        theirs = jax_foto.solve_potential(jnp.asarray(a), jnp.asarray(b), 6,
                                          ops=jax_foto.DCT_OPS, **kw)
        _same_state(ours, theirs)
        return ours

    def test_exact_invariance(self):
        """auto_r on the raw frames is the solve of the peak-normalized
        frames (the iteration is 1-homogeneous in (mu, rho, r))."""
        a, b = self._pair()
        p = max(a.max(), b.max())
        kw = dict(r=0.1, reg_epsilon=1e-3, convergence_tol=1e-4, max_it=120)
        ra = self._solves(a, b, auto_r=True, **kw)
        rb = self._solves(a / p, b / p, **kw)
        assert int(ra.iteration) == int(rb.iteration)
        assert float((ra.phi - rb.phi).abs().max()) < 1e-10

    def test_fixes_unit_mass_stall(self):
        """r = 1 on unit-mass frames stalls on the stagnation guard having
        moved almost no mass; auto_r recovers the 4 px translation."""
        a, b = self._pair()
        kw = dict(reg_epsilon=1e-3, convergence_tol=1e-4, max_it=400)
        stalled = self._solves(a, b, r=1.0, **kw)
        fixed = self._solves(a, b, r=0.1, auto_r=True, **kw)
        assert int(stalled.iteration) < int(fixed.iteration) < 400

        def mw_u(state):
            u, _, _ = flow_extract.flow_from_potential(state.phi)
            ju, _, _ = jax_flow.flow_from_potential(
                jnp.asarray(state.phi.numpy()))
            assert _gap(u, ju) < PHI_ATOL
            return float((a * u.numpy()).sum())

        assert abs(mw_u(stalled)) < 1.0
        assert abs(mw_u(fixed) - 4.0) < 0.5


# --------------------------------------------------------------- Sinkhorn

@pytest.fixture(scope="module")
def translated_blob_w2():
    """The 300-iteration ALG2 solve of tests/fixtures.translated_blob_w2
    (a unit-mass blob moved 4 px on 48x48), at float64 in both
    packages -> (a, b, the port's state, JAX's state)."""
    y, x = np.mgrid[0:48, 0:48].astype(np.float64)

    def blob(cy, cx):
        return np.exp(-(((y - cy) / 6.0) ** 2 + ((x - cx) / 6.0) ** 2))

    a, b = blob(24, 22), blob(24, 26)
    a, b = a / a.sum(), b / b.sum()
    s = max(a.max(), b.max())
    kw = dict(r=0.1, reg_epsilon=1e-3)
    ours, _ = foto.solve_potential_with_history(
        torch.from_numpy(a / s), torch.from_numpy(b / s), 8, 300,
        ops=foto.DCT_OPS, **kw)
    theirs, _ = jax_foto.solve_potential_with_history(
        jnp.asarray(a / s), jnp.asarray(b / s), 8, 300,
        ops=jax_foto.DCT_OPS, **kw)
    return a, b, ours, theirs


def test_matches_dynamic_w2(translated_blob_w2):
    """Static (Sinkhorn, eps 2) and dynamic (ALG2) W2 agree within 10% on
    the pair, and each is JAX's value."""
    a, b, st, jst = translated_blob_w2
    assert int(st.iteration) == int(jst.iteration) == 300
    assert _gap(st.phi, jst.phi) < PHI_ATOL
    res = sinkhorn.wasserstein2_entropic(
        torch.from_numpy(a), torch.from_numpy(b), 2.0, max_iter=2000,
        full=True)
    jres = jax_sinkhorn.wasserstein2_entropic(
        jnp.asarray(a), jnp.asarray(b), 2.0, max_iter=2000, full=True)
    assert int(res.iterations) == int(jres.iterations)
    assert _rel(res.value, jres.value) < REL
    assert _rel(res.marginal_error, jres.marginal_error) < 1e-6
    assert float(res.marginal_error) <= 0.05
    w2_static = float(res.value)
    w2_dynamic = float(foto.wasserstein2(st))
    assert _rel(w2_dynamic, jax_foto.wasserstein2(jst)) < REL
    assert abs(w2_static - w2_dynamic) / w2_static < 0.1


# --------------------------------------------------------------- pipeline

@pytest.mark.parametrize("batched", [False, True])
def test_escalation_triggers_on_nan(monkeypatch, tmp_path, batched):
    """A NaN marginal error escalates (``me <= tol`` is False for NaN):
    the port's ``_maybe_escalate_sinkhorn`` takes JAX's rungs in JAX's
    order and leaves JAX's record, rung 2 replaced in both packages."""
    stats = tmp_path / "s.jsonl"
    stats.write_text(json.dumps({"event": "solve",
                                 "marginal_error": 9e-5}) + "\n")
    out = {}
    for name, mod in (("port", pipeline), ("jax", jax_pipeline)):
        calls = []
        monkeypatch.setattr(mod, "_escalate_sinkhorn_inprocess",
                            lambda argv, c=calls: c.append("exact") or True)
        monkeypatch.setattr(mod, "_escalate_sinkhorn_f64",
                            lambda argv, c=calls: c.append("f64") or True)
        res = {"marginal_error": float("nan"), "wall_s": 1.0}
        if batched:
            res["batched"] = True
        mod._maybe_escalate_sinkhorn(res, ["--algo=sinkhorn"], Path(stats),
                                     1.0)
        res.pop("wall_s")
        out[name] = calls, res
    (calls, res), (jcalls, jres) = out["port"], out["jax"]
    assert calls == jcalls == (["exact"] if batched else ["f64"])
    assert res["marginal_error"] == 9e-5
    if batched:
        # rung 1's exact re-solve met the tolerance
        assert res["escalated_exact"] is True
        assert np.isnan(res["marginal_error_batch"])
    else:
        assert res["escalated_f64"] is True
        assert np.isnan(res["marginal_error_f32"])
    assert json.dumps(res, sort_keys=True) == json.dumps(jres,
                                                         sort_keys=True)
