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
    "GN-f64": ("GN", {"gn_params": dict(alpha=0.1, lambda_=0.2)}),
    "sinkhorn-matmul": ("sinkhorn", {"sinkhorn_params": dict(
        epsilon=4.0, max_iter=200, tol=1e-5, check_every=5)}),
    "sinkhorn-exact": ("sinkhorn", {"sinkhorn_params": dict(
        epsilon=4.0, max_iter=200, tol=1e-5, check_every=5, anneal=False,
        stabilizer="exact")}),
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
    for key in ("crit", "marginal_error"):
        if key in diag:
            np.testing.assert_allclose(diag[key], np.asarray(jdiag[key]),
                                       rtol=1e-3, atol=1e-6, err_msg=key)
    aepe = np.sqrt((u.numpy() - np.asarray(ju)) ** 2
                   + (v.numpy() - np.asarray(jv)) ** 2).mean(axis=(1, 2))
    assert aepe.max() < 1e-3, (case, aepe)
