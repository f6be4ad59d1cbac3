"""The space-time stencils of the ALG2 loop (``ops/kernels/stencil_st.py``).

On the CPU the wrappers run their plain versions, which must be bitwise
the stencils they stand for: ``operators.grad_st``, and ``div_st`` of
``mu - r*q`` plus ``add_time_boundary``, the code stepA ran before its
right-hand side became an ops hook.  ``_DefaultOps.stepA_rhs`` is that
code for every ops set; the ``pallas`` set's table names the kernels,
which its single-pair and lockstep forms run, while the tiled form keeps
the plain stencils on its halos.  The
kernels themselves are held bitwise against these plain versions on the
card in tests/test_torch_kernels_cuda.py (dtype, contiguity and axes of
length 1 are refused there).
"""

import numpy as np
import pytest
import torch

from ofot_tpu_torch.ops import kernels, operators
from ofot_tpu_torch.ops.kernels import _build
from ofot_tpu_torch.ops.kernels import stencil_st as ss
from ofot_tpu_torch.parallel import gspmd
from ofot_tpu_torch.parallel.halo import Tiled
from ofot_tpu_torch.solvers import foto
from ofot_tpu_torch.solvers.lockstep import PerPair

RNG = np.random.default_rng(53)
DTYPES = [torch.float32, torch.float64]
SHAPES = [(4, 6, 8), (2, 5, 7), (3, 2, 9)]


def _rand(shape, dtype):
    return torch.from_numpy(RNG.uniform(-1, 2, shape)).to(dtype)


def _fields(shape, dtype, batch=None):
    lead = () if batch is None else (batch,)
    mu, q = (_rand(lead + (3,) + shape, dtype) for _ in range(2))
    rho0, rhoT = (_rand(lead + shape[1:], dtype) for _ in range(2))
    return mu, q, rho0, rhoT


def _old_stepA_rhs(mu, q, rho0, rhoT, r, cax, div_st=operators.div_st):
    """stepA's right-hand side as ``foto._stepA`` formed it inline before
    the hook, word for word (``ops.div_st``, ``_add_time_boundary``)."""
    dt = 1.0
    F = div_st(mu - r * q, bc="N")
    rho, a = mu.select(cax, 0), q.select(cax, 0)
    g0 = rho0 - rho.select(-3, 0) + r * a.select(-3, 0)
    gN = rhoT - rho.select(-3, -1) + r * a.select(-3, -1)
    F.select(-3, 0).add_(-(1.0 / dt) * g0)
    F.select(-3, -1).add_((1.0 / dt) * gN)
    return F


def _bitwise(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.fixture
def no_launches():
    kernels.reset_launch_counts()
    yield
    counts = kernels.launch_counts()
    assert counts["stencil_grad_st"] == counts["stencil_stepA_rhs"] == 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_grad_st_on_cpu_is_the_plain_stencil(no_launches, shape, dtype):
    phi = _rand(shape, dtype)
    assert _bitwise(ss.grad_st(phi), operators.grad_st(phi, bc="N"))
    batch = _rand((3,) + shape, dtype)
    got = ss.grad_st_batched(batch)
    assert _bitwise(got, operators.grad_st(batch, bc="N", dim=1))
    for b in range(3):
        assert _bitwise(got[b], ss.grad_st(batch[b]))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("r", [1.0, 0.7])
def test_stepA_rhs_on_cpu_is_div_st_and_the_time_boundary(no_launches,
                                                          shape, dtype, r):
    mu, q, rho0, rhoT = _fields(shape, dtype)
    assert _bitwise(ss.stepA_rhs(mu, q, rho0, rhoT, r),
                    _old_stepA_rhs(mu, q, rho0, rhoT, r, 0))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("per_pair", [False, True])
def test_batched_stepA_rhs_on_cpu_is_each_pair_and_the_old_code(
        no_launches, dtype, per_pair):
    """A batch with one float r or per-pair r (the (B,) tensor a
    ``PerPair`` hands the kernels): bitwise the old code on the batch with
    the ``PerPair``, and each pair its single-pair call."""
    mu, q, rho0, rhoT = _fields((4, 6, 8), dtype, batch=3)
    r = PerPair([0.7, 1.0, 1.3], rho0) if per_pair else 0.9
    got = ss.stepA_rhs_batched(mu, q, rho0, rhoT, r.t if per_pair else r)
    want = _old_stepA_rhs(mu, q, rho0, rhoT, r, 1,
                          lambda x, bc: operators.div_st(x, bc=bc, dim=1))
    assert _bitwise(got, want)
    for b in range(3):
        rb = r.values[b] if per_pair else r
        assert _bitwise(got[b], ss.stepA_rhs(mu[b], q[b], rho0[b], rhoT[b],
                                              rb))


@pytest.mark.parametrize("solver", ["cg", "dct", "dct-refined", "pallas",
                                    "dct-fused", "cg-pallas"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_every_ops_set_forms_the_old_right_hand_side(solver, dtype):
    """``ops.stepA_rhs`` of every set, single and lockstep (r a float and a
    ``PerPair``), is bitwise the code it replaced, through the set's own
    ``div_st``."""
    ops = foto.stepA_ops(solver)
    mu, q, rho0, rhoT = _fields((4, 6, 8), dtype)
    assert _bitwise(ops.stepA_rhs(mu, q, rho0, rhoT, 0.7),
                    _old_stepA_rhs(mu, q, rho0, rhoT, 0.7, 0, ops.div_st))
    lock = foto.lockstep_ops(ops)
    mu, q, rho0, rhoT = _fields((4, 6, 8), dtype, batch=3)
    for r in (0.8, PerPair([0.7, 1.0, 1.3], rho0)):
        want = _old_stepA_rhs(mu, q, rho0, rhoT, r, 1,
                              foto.Lockstep.div_st)
        assert _bitwise(lock.stepA_rhs(mu, q, rho0, rhoT, r), want)


def test_default_stepA_rhs_is_the_plain_version_of_the_kernel():
    mu, q, rho0, rhoT = _fields((5, 4, 6), torch.float32)
    assert _bitwise(foto.DEFAULT_OPS.stepA_rhs(mu, q, rho0, rhoT, 1.1),
                    ss.stepA_rhs_reference(mu, q, rho0, rhoT, 1.1))


def test_pallas_sets_take_the_kernels_and_lockstep_the_batched_forms():
    """``PallasOps``'s table names the kernel wrappers: its single-pair
    form runs them, its lockstep form the batched ones (not the lockstep
    form's plain stencils); the other sets and the tiled ``pallas`` set
    keep the plain stencils and the plain right-hand side."""
    assert foto.PallasOps.kernels.grad_st == (ss.grad_st, ss.grad_st_batched)
    single = foto.PALLAS_OPS
    assert single.grad_st is ss.grad_st
    assert single.hooks.stepA_rhs is ss.stepA_rhs
    lock = foto.lockstep_ops(foto.PALLAS_OPS)
    assert lock.grad_st is ss.grad_st_batched
    assert lock.hooks.stepA_rhs is ss.stepA_rhs_batched
    for solver in ("cg", "dct", "dct-refined", "dct-fused", "cg-pallas"):
        ops = foto.stepA_ops(solver)
        assert type(ops).stepA_rhs is foto._DefaultOps.stepA_rhs
        assert ops.hooks.stepA_rhs is None
        assert ops.grad_st is operators.grad_st
        assert foto.lockstep_ops(ops).grad_st is foto.Lockstep.grad_st
    tiled = gspmd.sharded_ops(foto.stepA_ops("pallas"), None)
    assert tiled.hooks.stepA_rhs is None and tiled.hooks.grad_st is None
    assert tiled.grad_st.__func__ is Tiled.grad_st


def test_lockstep_pallas_iteration_on_cpu_counts_no_launch(no_launches):
    """One lockstep ALG2 iteration of the ``pallas`` set on the CPU runs the
    plain versions: the same state as the ``dct`` set's with the fused
    pass's plain version."""
    a = torch.from_numpy(RNG.uniform(0.1, 0.9, (2, 6, 8)))
    b = torch.roll(a, 1, dims=-1)
    st = foto.init_state(a, b, 4)
    kw = dict(r=PerPair([0.9, 1.2], a), reg_epsilon=1e-2,
              convergence_tol=0.01)
    got = foto.alg2_iteration(st, a, b, ops=foto.lockstep_ops(
        foto.PALLAS_OPS), **kw)
    plain = foto.lockstep_ops(foto.DCT_OPS)
    F = plain.stepA_rhs(st.mu, st.q, a, b, kw["r"])
    phi, _ = plain.stepA_solve(F, kw["r"], 1e-2, 1e-6, 1000)
    assert _bitwise(got.phi, phi)


@pytest.mark.parametrize("fn,args", [
    (ss.grad_st, lambda t: (t[0],)),
    (ss.grad_st_batched, lambda t: (t,)),
    (ss.stepA_rhs, lambda t: (t[0], t[0], t[0, 0, 0], t[0, 0, 0], 1.0)),
    (ss.stepA_rhs_batched, lambda t: (t, t, t[:, 0, 0], t[:, 0, 0], 1.0)),
])
def test_other_devices_and_boundary_conditions_raise(fn, args):
    """A meta tensor raises before any launch is prepared, as on any device
    other than cuda and cpu; bc 'D' raises on every device, so that the CPU
    and the card refuse the same calls."""
    meta = torch.zeros(2, 3, 4, 5, 6, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fn(*args(meta))
    for t in (meta, torch.zeros(2, 3, 4, 5, 6)):
        with pytest.raises(ValueError, match="bc='N' only"):
            fn(*args(t), bc="D")


def test_build_compiles_the_stencil_source():
    assert "stencil_st.cu" in [s.name for s in _build.sources()]
    src = (_build.SRC_DIR / "stencil_st.cu").read_text()
    assert 'extern "C"' in src and "torch/" not in src
    for name in ("ofot_stencil_grad_st", "ofot_stencil_stepA_rhs"):
        assert f"int {name}(" in src
    # flowbench's trace reader matches #1's records by these substrings
    for kernel in ("stencil_grad_st_kernel", "stencil_stepA_rhs_kernel"):
        assert kernel in src
    assert "fused_pointwise_kernel" not in src
    assert "reduce_partials_kernel" not in src
    assert kernels.KERNELS["stencil_grad_st"] == ("stencil_st",
                                                  "grad_st_launches")
    assert kernels.KERNELS["stencil_stepA_rhs"] == ("stencil_st",
                                                    "stepA_rhs_launches")
