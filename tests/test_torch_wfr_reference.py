"""The port's WFR solve (``ofot_tpu_torch.solvers.wfr``, the ``dct`` set,
float64 and float32) against the benchmark's plain float64 reference of
WFR (``flowbench/reference/wfr.py``), on seeded random frames at Nt 4,
24x32, with the sweep's settings (r 1, delta 2.5, reg-epsilon 1e-2,
admm-alpha 1.7).

Tolerances, on fields of O(1) (frames scaled to a largest value of 1;
flows to 0.14 px, growth and luminosity to 0.28):
  * float64 against float64: 1e-12 on the state and the criterion after
    each iteration (the same arithmetic, the spectral solve's products and
    the sums in another order: 3e-15 read), 1e-10 on the fields after a
    whole solve (200 iterations carry the rounding: 1e-14 read);
  * float32 against float64: 2e-5 absolute on mu, q and phi and 1e-4
    relative on the criterion (the bounds tests/test_torch_wfr.py holds
    float32 sets to; 2e-6 and, the criterion being a ratio of sums of a
    residual that cancels, 3e-5 read after 32 iterations);
    2e-5 on u, v, m_combined and growth after the program's count (4e-6
    read after 200 iterations, float32's rounding over the solve);
  * the stop count equal in both precisions, at a tolerance the
    criterion crosses with a margin of 3e-5 or more, 30 times float32's
    error on it here.
"""

import ast
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ofot_tpu_torch.solvers import foto, wfr

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from flowbench.reference import foto as ref_foto  # noqa: E402
from flowbench.reference import wfr as ref  # noqa: E402

NT, NY, NX = 4, 24, 32
DELTA = 2.5
KW = dict(r=1.0, delta=DELTA, reg_epsilon=1e-2, admm_alpha=1.7)
SEEDS = [2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3]
DTYPES = [torch.float64, torch.float32]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread at these small shapes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(seed):
    """A smooth random frame and its shift by one pixel on each axis,
    brightened 10-30% with noise: both scaled to a largest value of 1."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:NY, 0:NX] / np.array([NY, NX])[:, None, None]
    f = 0.6 + sum(rng.uniform(-0.1, 0.1)
                  * np.cos(np.pi * (kx * x + ky * y) + rng.uniform(0, 6.3))
                  for kx in range(1, 4) for ky in range(1, 4))
    g = (np.roll(f, (1, 1), (0, 1)) * rng.uniform(1.1, 1.3)
         + 0.05 * rng.uniform(0, 1, (NY, NX)))
    s = max(f.max(), g.max())
    return f / s, g / s


def _pair(seed, dtype):
    return [torch.as_tensor(f, dtype=dtype) for f in _frames(seed)]


def _gap(a, b) -> float:
    return float(torch.max(torch.abs(a.double() - b.double())))


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("module", [ref, ref_foto],
                         ids=["wfr", "foto"])
def test_the_reference_imports_neither_the_program_nor_jax(module):
    tops = {n.split(".", 1)[0] for n in _imports(Path(module.__file__))}
    assert not tops & {"ofot_tpu_torch", "ofot_tpu", "jax", "jaxlib",
                       "flax"}, tops
    assert tops <= {"__future__", "math", "typing", "numpy", "torch",
                    "flowbench"}, tops


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["float64", "float32"])
def test_state_and_criterion_after_each_iteration(seed, dtype):
    a, b = _pair(seed, dtype)
    A, B = a.double(), b.double()
    ops = foto.stepA_ops("dct")
    ours = wfr.init_state(a, b, NT)
    theirs = ref.init(A, B, NT)
    solver = ref_foto.Spectral((NT, NY, NX), KW["r"],
                               KW["reg_epsilon"] + 1.0 / DELTA ** 2,
                               torch.float64, "cpu")
    tol = 1e-12 if dtype == torch.float64 else 2e-5
    crit_rtol = 1e-12 if dtype == torch.float64 else 1e-4
    for _ in range(6):
        ours = wfr.alg2_iteration(ours, a, b, ops=ops, convergence_tol=0.01,
                                  max_it=200, **KW)
        theirs = ref.iterate(theirs, A, B, solver, r=KW["r"], delta=DELTA,
                             admm_alpha=KW["admm_alpha"])
        assert ours.mu.shape == theirs.mu.shape == (4, NT, NY, NX)
        for name in ("mu", "q", "phi"):
            assert _gap(getattr(ours, name), getattr(theirs, name)) < tol, \
                name
        assert float(ours.crit) == pytest.approx(theirs.crit, rel=crit_rtol)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["float64", "float32"])
def test_stop_count(seed, dtype):
    a, b = _pair(seed, dtype)
    res = wfr.solve(a, b, NT, ops=foto.stepA_ops("dct"),
                    convergence_tol=0.09, max_it=60, **KW)
    run = ref.alg2(a.double(), b.double(), NT, convergence_tol=0.09,
                   max_it=60, **KW)
    assert run.stop < 60
    assert res.state.iteration == run.stop
    assert float(res.state.crit) == pytest.approx(run.crits[-1], rel=1e-4)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["float64", "float32"])
def test_fields_at_the_programs_count(seed, dtype):
    a, b = _pair(seed, dtype)
    res = wfr.solve(a, b, NT, ops=foto.stepA_ops("dct"),
                    convergence_tol=0.01, max_it=200, **KW)
    k = res.state.iteration
    run = ref.alg2(a.double(), b.double(), NT, convergence_tol=0.01,
                   max_it=200, read_at=k, **KW)
    u, v, m, g = ref.fields(run.at_read, DELTA)
    # the source does work here: a growth of 10% or more
    assert float(torch.max(torch.abs(g))) > 0.1
    tol = 1e-10 if dtype == torch.float64 else 2e-5
    for name, got, want in [("u", res.u, u), ("v", res.v, v),
                            ("m_combined", res.m_combined, m),
                            ("growth", res.growth, g)]:
        assert _gap(got, want) < tol, name
    # m_combined composes the growth with -div(u, v)
    assert _gap(res.m_combined, wfr.combined_luminosity(res.m, res.growth)) \
        == 0.0


def test_the_reference_projection_lands_on_the_paraboloid():
    """Points outside go to the surface a + |b|^2 / 2 = 0 along the
    normal; points inside stay."""
    gen = torch.Generator().manual_seed(7)
    a = torch.randn(500, generator=gen, dtype=torch.float64)
    b = 2.0 * torch.randn(3, 500, generator=gen, dtype=torch.float64)
    p = ref.project_paraboloid(a, b)
    surface = p[0] + 0.5 * torch.sum(p[1:] ** 2, dim=0)
    outside = a + 0.5 * torch.sum(b ** 2, dim=0) > 0
    assert torch.all(torch.abs(surface[outside]) < 1e-10)
    assert torch.equal(p[:, ~outside], torch.cat([a[None], b])[:, ~outside])
    # the step is along the normal (1, b'): b - b' parallel to b'
    d = torch.cat([a[None], b]) - p
    normal = torch.cat([torch.ones_like(p[0])[None], p[1:]])
    cross = d[1:] * normal[0] - normal[1:] * d[0]
    assert torch.all(torch.abs(cross[:, outside]) < 1e-9)
