"""The port's lockstep batch (``solve_batch_full(..., batch_mode="vmap")``)
against the JAX package's ``vmap`` mode, both on the CPU on the same
float32 frames.

Four pairs with distinct shifts; at ``convergence_tol=0.1`` two of them
stop on the criterion well before the others reach ``max_it``, so every
FOTO set runs pairs that are done beside pairs that are not.  The CG
stepA sets run 6 ALG2 iterations at ``convergence_tol=0.2`` (one pair
stops at 5): their CG counts are cumulative, and JAX's own vmap moves
them by up to 3 from its map mode over 7 iterations on these frames.  GN
runs in float64: its CG stops at rtol 1e-10, below float32's resolution,
where the float32 step count is rounding noise (JAX's own map and vmap
modes differ by 5 on these frames).  The JAX Pallas kernels run in
interpret mode.  Held to the bounds the port's map
mode is held to against JAX's (tests/test_torch_sweep.py): the same
per-pair ALG2 / Sinkhorn iteration counts, CG steps within 2 (float32 dot
products summed in another order stop CG a step or two apart), and flows
with AEPE < 1e-3.
"""

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ofot_tpu.ops.pallas import kernels
from ofot_tpu.parallel import sweep as jax_sweep
from ofot_tpu_torch.parallel import sweep

import fixtures

SHIFTS = [(2.0, 1.0), (-1.0, 2.0), (0.2, 0.0), (1.5, -1.0)]
FOTO = dict(Nt=4, r=1.0, convergence_tol=0.1, reg_epsilon=1e-2, max_it=16)
FOTO_CG = dict(FOTO, convergence_tol=0.2, max_it=6)
CASES = {
    "foto-cg": ("foto", {"foto_params": dict(FOTO_CG, stepA_solver="cg")}),
    "foto-dct": ("foto", {"foto_params": dict(FOTO, stepA_solver="dct")}),
    "foto-pallas-1.7": ("foto", {"foto_params": dict(
        FOTO, stepA_solver="pallas", admm_alpha=1.7)}),
    "foto-dct-fused": ("foto", {"foto_params": dict(
        FOTO, stepA_solver="dct-fused")}),
    "foto-cg-pallas": ("foto", {"foto_params": dict(
        FOTO_CG, stepA_solver="cg-pallas")}),
    "foto-dct-auto-r": ("foto", {"foto_params": dict(
        FOTO, stepA_solver="dct", admm_alpha=1.7, auto_r=True)}),
    "WFR-pallas": ("WFR", {"wfr_params": dict(
        FOTO, delta=2.5, convergence_tol=0.05, admm_alpha=1.7,
        stepA_solver="pallas")}),
    "WFR-pallas-f64": ("WFR", {"wfr_params": dict(
        FOTO, delta=2.5, convergence_tol=0.05, admm_alpha=1.7,
        stepA_solver="pallas")}),
    "GN-f64": ("GN", {"gn_params": dict(alpha=0.1, lambda_=0.2)}),
    "sinkhorn-matmul": ("sinkhorn", {"sinkhorn_params": dict(
        epsilon=4.0, max_iter=200, tol=1e-5, check_every=5)}),
    "sinkhorn-exact": ("sinkhorn", {"sinkhorn_params": dict(
        epsilon=4.0, max_iter=200, tol=1e-5, check_every=5, anneal=False,
        stabilizer="exact")}),
}
# The crit of WFR-pallas's nearly static pair (shift (0.2, 0), stopped at
# iteration 9) carries float32 rounding amplified ~1e3 times.  At float64
# the port and JAX agree there to 1e-13 (the WFR-pallas-f64 case).  At
# float32 each package lands up to ~1.2e-3 (relative) from that float64
# crit: JAX's vmap +6.9e-4, its map +4.7e-4; the port -1.22e-3.
# Re-running both with the frames moved by one float32 ulp (random
# signs, 5 draws) moved JAX's crit between -5.8e-4 and +8.5e-4 and the
# port's between -7.3e-4 and +1.06e-3 of the float64 value.  Two
# float32 results each within 1.22e-3 of it differ by up to 2.44e-3.
CRIT_RTOL = {"WFR-pallas": 2.5e-3}
FLOAT64_BOUNDS = dict(crit_rtol=1e-9, aepe=1e-9)


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


def frames(dtype=np.float32):
    pairs = [fixtures.smooth_blob_pair(18, 20, shift=s) for s in SHIFTS]
    f1s = np.stack([np.asarray(a, dtype) for a, _ in pairs])
    f2s = np.stack([np.asarray(b, dtype) for _, b in pairs])
    return f1s, f2s


@pytest.mark.usefixtures("_interpret_mode")
@pytest.mark.parametrize("case", list(CASES))
def test_lockstep_matches_jax_vmap(case):
    algo, params = CASES[case]
    f1s, f2s = frames(np.float64 if case.endswith("f64") else np.float32)
    u, v, m, diag = sweep.solve_batch_full(algo, f1s, f2s, None,
                                           batch_mode="vmap", device="cpu",
                                           **params)
    ju, jv, jm, jdiag = jax_sweep.solve_batch_full(
        algo, f1s, f2s, None, batch_mode="vmap", **params)
    assert u.shape == v.shape == m.shape == f1s.shape
    assert set(diag) == set(jdiag)
    for key, val in diag.items():
        assert val.shape == (len(f1s),), key
    for key in ("iterations", "converged"):
        if key in diag:
            np.testing.assert_array_equal(diag[key], np.asarray(jdiag[key]),
                                          err_msg=key)
    if algo in ("foto", "WFR"):
        # the case runs done pairs beside pairs that are not
        its = diag["iterations"]
        assert its.min() < its.max() <= params[
            "foto_params" if algo == "foto" else "wfr_params"]["max_it"]
    if "inner_iterations" in diag:
        assert np.abs(diag["inner_iterations"]
                      - np.asarray(jdiag["inner_iterations"])).max() <= 2
    f64 = case.endswith("f64") and algo != "GN"
    for key in ("crit", "marginal_error"):
        if key in diag:
            rtol = (FLOAT64_BOUNDS["crit_rtol"] if f64
                    else CRIT_RTOL.get(case, 1e-3))
            np.testing.assert_allclose(diag[key], np.asarray(jdiag[key]),
                                       rtol=rtol, atol=0 if f64 else 1e-6,
                                       err_msg=key)
    aepe = np.sqrt((u.numpy() - np.asarray(ju)) ** 2
                   + (v.numpy() - np.asarray(jv)) ** 2).mean(axis=(1, 2))
    assert aepe.max() < (FLOAT64_BOUNDS["aepe"] if f64 else 1e-3), (
        case, aepe)
