"""The port's differentiable solves (``solvers/otgrad.py``,
``solvers/implicit.py``) on the CPU: values and gradients against the JAX
package's ``custom_vjp`` versions at float64 (1e-8 relative: the same
converged potentials or CG solutions, summed in another order), and the
finite-difference checks of tests/test_otgrad.py and tests/test_implicit.py
run on the port at their own tolerances."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from ofot_tpu.solvers import otgrad as jotgrad
from ofot_tpu.solvers.implicit import gn_solve_implicit as j_gn_implicit
from ofot_tpu_torch.solvers import gn, otgrad
from ofot_tpu_torch.solvers.implicit import gn_solve_implicit

import fixtures

KW = (("max_iter", 1500), ("tol", 1e-9))
REL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The shapes here are small: one intra-op thread, so that the suite's
    parallel workers do not oversubscribe the cores (spinning OpenMP
    threads slowed this file 8x under a loaded run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(n=24, shift=(3.0, 2.0)):
    y, x = np.mgrid[0:n, 0:n].astype(np.float64)

    def blob(cy, cx):
        return np.exp(-((y - cy) ** 2 + (x - cx) ** 2) / 14) + 1e-4

    c = n / 2
    return (blob(c - shift[0] / 2, c - shift[1] / 2),
            blob(c + shift[0] / 2, c + shift[1] / 2))


def _leaf(x):
    return torch.tensor(x, dtype=torch.float64, requires_grad=True)


def _fd(fn, a, i, j, h=1e-5):
    e = torch.zeros_like(a)
    e[i, j] = h
    return (float(fn(a + e)) - float(fn(a - e))) / (2 * h)


def _assert_rel(ours, theirs, rel=REL):
    theirs = np.asarray(theirs)
    assert np.abs(np.asarray(ours) - theirs).max() \
        <= rel * np.abs(theirs).max()


@pytest.mark.parametrize("name", ["entropic_ot_dual",
                                  "sinkhorn_divergence_dual",
                                  "wasserstein2_dual"])
def test_values_and_gradients_match_jax(name):
    a, b = _pair()
    j_val, (j_ga, j_gb) = jax.value_and_grad(
        getattr(jotgrad, name), argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(b), 4.0, KW)
    at, bt = _leaf(a), _leaf(b)
    val = getattr(otgrad, name)(at, bt, 4.0, KW)
    val.backward()
    _assert_rel(float(val.detach()), float(j_val))
    _assert_rel(at.grad.numpy(), j_ga)
    _assert_rel(bt.grad.numpy(), j_gb)


def test_entropic_value_grad_matches_fd():
    a, b = (torch.tensor(x) for x in _pair())
    at = a.clone().requires_grad_(True)
    bt = b.clone().requires_grad_(True)
    val = otgrad.entropic_ot_dual(at, bt, 4.0, KW)
    val.backward()
    assert np.isfinite(float(val.detach()))
    rng = np.random.RandomState(0)
    for _ in range(3):
        i, j = rng.randint(0, 24, 2)
        fd = _fd(lambda aa: otgrad.entropic_ot_dual(aa, b, 4.0, KW), a, i, j)
        assert float(at.grad[i, j]) == pytest.approx(fd, rel=1e-3, abs=1e-6)
        fd = _fd(lambda bb: otgrad.entropic_ot_dual(a, bb, 4.0, KW), b, i, j)
        assert float(bt.grad[i, j]) == pytest.approx(fd, rel=1e-3, abs=1e-6)


def test_divergence_grad_matches_fd():
    a, b = (torch.tensor(x) for x in _pair())
    at = a.clone().requires_grad_(True)
    bt = b.clone().requires_grad_(True)
    otgrad.sinkhorn_divergence_dual(at, bt, 4.0, KW).backward()
    rng = np.random.RandomState(1)
    for _ in range(3):
        i, j = rng.randint(0, 24, 2)
        fd = _fd(lambda aa: otgrad.sinkhorn_divergence_dual(aa, b, 4.0, KW),
                 a, i, j)
        assert float(at.grad[i, j]) == pytest.approx(fd, rel=1e-3, abs=1e-6)
        fd = _fd(lambda bb: otgrad.sinkhorn_divergence_dual(a, bb, 4.0, KW),
                 b, i, j)
        assert float(bt.grad[i, j]) == pytest.approx(fd, rel=1e-3, abs=1e-6)


def test_w2_dual_tracks_translation():
    a, b = _pair(shift=(4.0, 3.0))          # true W2 = 5
    at = _leaf(a)
    w2 = otgrad.wasserstein2_dual(at, torch.tensor(b), 4.0, KW)
    assert float(w2.detach()) == pytest.approx(5.0, rel=0.02)
    w2.backward()
    assert torch.isfinite(at.grad).all()


def test_gradient_step_decreases_divergence():
    a, b = (torch.tensor(x) for x in _pair(shift=(4.0, 0.0)))
    at = a.clone().requires_grad_(True)
    val0 = otgrad.sinkhorn_divergence_dual(at, b, 4.0, KW)
    val0.backward()
    a1 = a * torch.exp(-2.0 * at.grad)       # mass-positive update
    a1 = a1 * torch.sum(a) / torch.sum(a1)
    val1 = otgrad.sinkhorn_divergence_dual(a1, b, 4.0, KW)
    assert float(val1) < float(val0.detach())


def test_forward_builds_no_graph_through_the_solves():
    """The forward runs the solves without autograd: the value's graph is
    the custom backward alone."""
    a, b = _pair()
    val = otgrad.entropic_ot_dual(_leaf(a), torch.tensor(b), 4.0, KW)
    assert type(val.grad_fn).__name__ == "_EntropicOTDualBackward"


# -------------------------------------------------------------- implicit

def test_primal_matches_direct_solve_and_jax():
    f1, f2 = fixtures.smooth_blob_pair(10, 12)
    x = gn_solve_implicit(torch.tensor(f1), torch.tensor(f2), 0.1, 0.2)
    r = gn.solve_fields(torch.tensor(f1), torch.tensor(f2), 0.1, 0.2)
    np.testing.assert_allclose(x[0].numpy(), r.u.numpy(), atol=1e-8)
    xj = np.asarray(j_gn_implicit(jnp.asarray(f1), jnp.asarray(f2), 0.1,
                                  0.2))
    _assert_rel(x.numpy(), xj)


def test_gradients_match_jax():
    """d/d(f1, f2, alpha, lambda) of one loss through both adjoints."""
    f1, f2 = fixtures.smooth_blob_pair(10, 12)

    def j_loss(f1v, f2v, alpha, lam):
        x = j_gn_implicit(f1v, f2v, alpha, lam)
        return jnp.sum(x[0] * x[1]) + jnp.sum(x[2] ** 2) + jnp.sum(x[0] ** 2)

    jg = jax.grad(j_loss, argnums=(0, 1, 2, 3))(
        jnp.asarray(f1), jnp.asarray(f2), 0.1, 0.2)
    t1, t2, alpha, lam = _leaf(f1), _leaf(f2), _leaf(0.1), _leaf(0.2)
    x = gn_solve_implicit(t1, t2, alpha, lam)
    (torch.sum(x[0] * x[1]) + torch.sum(x[2] ** 2)
     + torch.sum(x[0] ** 2)).backward()
    for ours, theirs in zip((t1.grad, t2.grad, alpha.grad, lam.grad), jg):
        _assert_rel(ours.numpy(), theirs)


def test_grad_wrt_alpha_matches_fd():
    f1, f2 = (torch.tensor(x) for x in fixtures.smooth_blob_pair(10, 12))

    def loss(alpha):
        x = gn_solve_implicit(f1, f2, alpha, 0.2)
        return torch.sum(x[0] ** 2 + x[1] ** 2)

    alpha = _leaf(0.1)
    loss(alpha).backward()
    eps = 1e-6
    fd = (float(loss(0.1 + eps)) - float(loss(0.1 - eps))) / (2 * eps)
    np.testing.assert_allclose(float(alpha.grad), fd, rtol=1e-3)


def test_grad_wrt_image_matches_fd():
    f1, f2 = fixtures.smooth_blob_pair(8, 9)
    f2t = torch.tensor(f2)

    def loss(f1v):
        x = gn_solve_implicit(f1v, f2t, 0.1, 0.2)
        return torch.sum(x[0] * x[1]) + torch.sum(x[2] ** 2)

    t1 = _leaf(f1)
    loss(t1).backward()
    g = t1.grad.numpy()
    eps = 1e-6
    rng = np.random.default_rng(5)
    for _ in range(3):
        i, j = rng.integers(0, 8), rng.integers(0, 9)
        d = np.zeros_like(f1)
        d[i, j] = eps
        fd = (float(loss(torch.tensor(f1 + d)))
              - float(loss(torch.tensor(f1 - d)))) / (2 * eps)
        np.testing.assert_allclose(g[i, j], fd, rtol=5e-3, atol=1e-5)


def test_float_parameters_take_no_gradient():
    """Python-float alpha/lambda are constants: only the frames get a
    gradient, and the result keeps the frames' dtype."""
    f1, f2 = fixtures.smooth_blob_pair(8, 9)
    t1 = _leaf(f1)
    x = gn_solve_implicit(t1, torch.tensor(f2), 0.1, 0.2)
    assert x.dtype == torch.float64 and x.shape == (3, 8, 9)
    x.sum().backward()
    assert t1.grad is not None and torch.isfinite(t1.grad).all()
