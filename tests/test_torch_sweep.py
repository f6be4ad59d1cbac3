"""The port's sweep (``ofot_tpu_torch.parallel.sweep``) in map mode.

Map mode solves the pairs one after another through the functions the
port's CLI calls, so each pair's flow must equal the single-pair solve
bitwise (GN too: the port's CG has no program embedding to differ by;
tests/test_batch_sweep.py holds JAX's GN to 2e-6 across embeddings).
Against ``ofot_tpu.parallel.sweep.solve_batch_full(..., batch_mode="map")``
on the same float32 arrays: the same ALG2 / Sinkhorn iteration counts,
CG steps within 2 (float32 dot products summed in another order stop CG
a step or two apart at rtol 1e-10), and flows with AEPE < 1e-3 (the CLI
tests' bound).
"""

import numpy as np
import pytest
import torch

from ofot_tpu.parallel import sweep as jax_sweep
from ofot_tpu_torch.ops import operators
from ofot_tpu_torch.parallel import sweep
from ofot_tpu_torch.solvers import flow_extract, foto, gn, sinkhorn, wfr

import fixtures

SHIFTS = [(2.0, 1.0), (-1.0, 2.0), (1.5, 0.0)]
PARAMS = {
    "foto": {"foto_params": dict(Nt=4, r=1.0, convergence_tol=0.01,
                                 reg_epsilon=1e-2, max_it=6,
                                 admm_alpha=1.7)},
    "WFR": {"wfr_params": dict(Nt=4, delta=2.5, r=1.0, convergence_tol=0.01,
                               reg_epsilon=1e-2, max_it=6, admm_alpha=1.7,
                               stepA_solver="auto")},
    "sinkhorn": {"sinkhorn_params": dict(epsilon=4.0, max_iter=200,
                                         tol=1e-4)},
    "GN": {"gn_params": dict(alpha=0.1, lambda_=0.2)},
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small shapes: one intra-op thread, so that the suite's parallel
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    pairs = [fixtures.smooth_blob_pair(24, 28, shift=s) for s in SHIFTS]
    f1s = np.stack([np.asarray(a, np.float32) for a, _ in pairs])
    f2s = np.stack([np.asarray(b, np.float32) for _, b in pairs])
    return f1s, f2s


def _single(algo, a, b):
    """One pair through the functions, in the order, of the port's CLI."""
    if algo == "foto":
        fp = dict(PARAMS["foto"]["foto_params"])
        res = foto.solve(a, b, fp.pop("Nt"), **fp, ops=foto.stepA_ops(
            foto.resolve_stepA_solver("auto", a.device)))
        return res.u, res.v, res.m
    if algo == "WFR":
        wp = dict(PARAMS["WFR"]["wfr_params"])
        solver = wfr.resolve_stepA_solver(wp.pop("stepA_solver"), a.device)
        res = wfr.solve(a, b, wp.pop("Nt"), **wp,
                        ops=foto.stepA_ops(solver))
        return res.u, res.v, res.m_combined
    if algo == "sinkhorn":
        sp = dict(PARAMS["sinkhorn"]["sinkhorn_params"])
        res = sinkhorn.flow(a, b, sp.pop("epsilon"), stabilizer="matmul",
                            max_iter=sp["max_iter"], tol=sp["tol"],
                            theta=1.0)
        return res.u, res.v, -operators.div2d(res.u, res.v, bc="D")
    res = gn.solve_fields(a, b, 0.1, 0.2)
    return res.u, res.v, res.m


@pytest.fixture(scope="module")
def port_runs(frames):
    f1s, f2s = frames
    return {algo: sweep.solve_batch_full(algo, f1s, f2s, None, **params,
                                         device="cpu")
            for algo, params in PARAMS.items()}


@pytest.mark.parametrize("algo", list(PARAMS))
def test_map_mode_bitwise_equals_single(frames, port_runs, algo):
    f1s, f2s = frames
    u, v, m, diag = port_runs[algo]
    assert u.shape == v.shape == m.shape == f1s.shape
    assert u.dtype == torch.float32
    for key, val in diag.items():
        assert val.shape == (len(f1s),), key
    for i in range(len(f1s)):
        want = _single(algo, torch.as_tensor(f1s[i]),
                       torch.as_tensor(f2s[i]))
        for got, w in zip((u[i], v[i], m[i]), want):
            assert torch.equal(got, w), (algo, i)


@pytest.mark.parametrize("algo", list(PARAMS))
def test_diagnostics_match_jax_map_mode(frames, port_runs, algo):
    f1s, f2s = frames
    u, v, _, diag = port_runs[algo]
    ju, jv, _, jdiag = jax_sweep.solve_batch_full(
        algo, f1s, f2s, None, batch_mode="map", **PARAMS[algo])
    assert set(diag) == set(jdiag)
    for key in ("iterations", "converged"):
        if key in diag:
            np.testing.assert_array_equal(diag[key], np.asarray(jdiag[key]))
    if "inner_iterations" in diag:
        assert np.abs(diag["inner_iterations"]
                      - np.asarray(jdiag["inner_iterations"])).max() <= 2
    for key in ("crit", "marginal_error"):
        if key in diag:
            np.testing.assert_allclose(diag[key], np.asarray(jdiag[key]),
                                       rtol=1e-3, atol=1e-6)
    aepe = np.sqrt((u.numpy() - np.asarray(ju)) ** 2
                   + (v.numpy() - np.asarray(jv)) ** 2).mean(axis=(1, 2))
    assert aepe.max() < 1e-3, (algo, aepe)


def test_group_by_shape_and_pad_batch():
    a, b, c = np.zeros((4, 5)), np.ones((4, 5)), np.zeros((3, 5))
    groups = sweep.group_by_shape([("a", a, a), ("c", c, c), ("b", b, b)])
    assert list(groups) == [(4, 5), (3, 5)]
    assert [k for k, _, _ in groups[(4, 5)]] == ["a", "b"]
    assert groups == jax_sweep.group_by_shape(
        [("a", a, a), ("c", c, c), ("b", b, b)])
    arr = np.arange(3 * 2).reshape(3, 2)
    for multiple in (1, 2, 4):
        got, n = sweep._pad_batch(arr, multiple)
        want, nj = jax_sweep._pad_batch(arr, multiple)
        assert n == nj == 3
        np.testing.assert_array_equal(got, want)


def test_vmap_and_mesh_raise(frames):
    f1s, f2s = frames
    # the lockstep batch runs now; only the mesh still raises
    u, v, m, diag = sweep.solve_batch_full(
        "foto", f1s, f2s, None, batch_mode="vmap", device="cpu",
        foto_params=dict(Nt=4, max_it=2, stepA_solver="dct"))
    assert u.shape == v.shape == m.shape == f1s.shape
    assert diag["iterations"].tolist() == [2, 2, 2]
    with pytest.raises(NotImplementedError, match="item 10"):
        sweep.solve_batch_full("foto", f1s, f2s, object(), batch_mode="vmap",
                               device="cpu")
    with pytest.raises(NotImplementedError, match="item 10"):
        sweep.solve_batch_full("foto", f1s, f2s, object(), device="cpu")
    with pytest.raises(ValueError, match="unknown batch_mode"):
        sweep.solve_batch_full("foto", f1s, f2s, None, batch_mode="scan",
                               device="cpu")
    with pytest.raises(NotImplementedError, match="item 10"):
        sweep.solve_foto_batch(f1s, f2s, 4, object(), device="cpu")


@pytest.mark.parametrize("bad,match", [
    (dict(algo="HS"), "unknown batch algo"),
    (dict(algo="sinkhorn", sinkhorn_params=dict(theta=2.5)), "theta"),
    (dict(algo="sinkhorn", sinkhorn_params=dict(stabilizer="auto")),
     "stabilizer")])
def test_bad_arguments_raise_before_solving(frames, bad, match):
    f1s, f2s = frames
    bad = dict(bad)
    with pytest.raises(ValueError, match=match):
        sweep.solve_batch_full(bad.pop("algo"), f1s, f2s, None, **bad,
                               device="cpu")


def test_float64_kernel_set_on_cuda_is_refused(frames, monkeypatch):
    for algo in ("foto", "WFR"):
        with pytest.raises(ValueError, match=f"pallas stepA set of {algo} "
                           "runs a CUDA kernel that is float32 only"):
            sweep.check_kernel_dtype(algo, {}, "cuda", torch.float64)
    for algo, params, device, dtype in (
            ("foto", {}, "cuda", torch.float32),
            ("WFR", {}, "cpu", torch.float64),
            ("foto", {"stepA_solver": "dct"}, "cuda", torch.float64),
            ("GN", None, "cuda", torch.float64)):
        sweep.check_kernel_dtype(algo, params, device, dtype)
    # the batch is refused before it moves to the card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    f1s, f2s = (np.asarray(f, np.float64) for f in frames)
    with pytest.raises(ValueError, match="float32 only"):
        sweep.solve_batch_full("foto", f1s, f2s, device="cuda")


def test_cuda_without_a_card_raises(frames):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    f1s, f2s = frames
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep.solve_batch_full("GN", f1s, f2s)


def test_foto_and_gn_batches_and_sweep_foto(frames):
    f1s, f2s = frames
    kw = dict(max_it=3, ops=foto.stepA_ops("dct"))
    states = sweep.solve_foto_batch(f1s, f2s, 4, device="cpu", **kw)
    assert states.phi.shape == (3, 4, 24, 28)
    assert states.iteration.tolist() == [3, 3, 3]
    pairs = [(f"k{i}", f1s[i], f2s[i]) for i in range(3)]
    pairs.append(("small", f1s[0, :20, :21], f2s[0, :20, :21]))
    swept = sweep.sweep_foto(pairs, 4, device="cpu", **kw)
    assert sorted(swept) == ["k0", "k1", "k2", "small"]
    for i in range(3):
        one = foto.solve_potential(torch.as_tensor(f1s[i]),
                                   torch.as_tensor(f2s[i]), 4, **kw)
        assert torch.equal(states.phi[i], one.phi)
        assert torch.equal(swept[f"k{i}"].phi, one.phi)
        assert int(swept[f"k{i}"].iteration) == one.iteration
    assert swept["small"].phi.shape == (4, 20, 21)
    res = sweep.solve_gn_batch(f1s, f2s, device="cpu")
    assert res.u.shape == (3, 24, 28) and res.cg.iterations.shape == (3,)
    one = gn.solve_fields(torch.as_tensor(f1s[1]), torch.as_tensor(f2s[1]))
    assert torch.equal(res.m[1], one.m)
    assert int(res.cg.iterations[1]) == one.cg.iterations
