"""The port's Sinkhorn solve (``ofot_tpu_torch.solvers.sinkhorn``: ``solve``,
``flow`` and ``solve_fields``, float64 and float32) against the
benchmark's plain float64 reference (``flowbench/reference/sinkhorn.py``)
on seeded random densities at 24x32, eps 4 (a ladder of three rungs,
256, 64 and 16, before the final stage), tol 1e-4, max-it 1000.

Tolerances, on potentials of O(100) px^2 and flows of 1-2 px:
  * float64 against float64: 1e-10 of max|f| on the potentials after two
    blocks (the matmul softmin's shifted products against per-entry
    logsumexps, the same values in another order: 7e-16 read), 1e-6
    relative on the marginal error there (3e-13 read), 1e-10 px on u, v
    and m after a whole solve (8e-14 read);
  * float32 against float64: 1e-5 of max|f| on the potentials after two
    blocks (float32's rounding, 8e-7 read), 1e-3 relative on the
    marginal error (a sum of |residuals| of 1e-3-1e-2: 8.5e-5 read), 5e-4
    px on u, v and m read at the program's own counts (5.8e-5 read:
    rounding carried through a few hundred iterations of each solve);
  * the stop counts equal: each crosses tol with a margin that float32's
    rounding does not close here (the float64 and float32 counts were
    equal on every seed and stabilizer).
The escalating case runs at eps 0.5, below the float32 matmul softmin's
envelope on this grid: there ``auto``'s answer is the exact solve's, bit
for bit, and its counters count both solves.
"""

import ast
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ofot_tpu_torch.solvers import sinkhorn
from ofot_tpu_torch.utils import trace

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from flowbench.reference import sinkhorn as ref  # noqa: E402

NY, NX = 24, 32
EPS = 4.0
KW = dict(tol=1e-4, theta=1.0)
SEEDS = [2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3]
DTYPES = [torch.float64, torch.float32]
STABILIZERS = ["matmul", "exact"]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread at these small shapes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(seed):
    """A smooth random density and its shift by (2, 3) px, brightened
    10-30% with noise: both scaled to a largest value of 1."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:NY, 0:NX] / np.array([NY, NX])[:, None, None]
    f = 0.6 + sum(rng.uniform(-0.15, 0.15)
                  * np.cos(np.pi * (kx * x + ky * y) + rng.uniform(0, 6.3))
                  for kx in range(1, 4) for ky in range(1, 4))
    g = (np.roll(f, (2, 3), (0, 1)) * rng.uniform(1.1, 1.3)
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


def test_the_reference_imports_neither_the_program_nor_jax():
    names = set(_imports(Path(ref.__file__)))
    tops = {n.split(".", 1)[0] for n in names}
    assert tops <= {"__future__", "math", "typing", "numpy", "torch",
                    "flowbench"}, tops
    assert all(n.startswith("flowbench.reference") for n in names
               if n.startswith("flowbench")), names


def _brute_softmin(h, eps):
    """eps log sum over the whole grid, one output entry at a time."""
    Ny, Nx = h.shape
    y, x = torch.meshgrid(torch.arange(Ny, dtype=h.dtype),
                          torch.arange(Nx, dtype=h.dtype), indexing="ij")
    out = torch.empty_like(h)
    for i in range(Ny):
        for j in range(Nx):
            c = (y - i) ** 2 + (x - j) ** 2
            out[i, j] = eps * torch.logsumexp(((h - c) / eps).reshape(-1), 0)
    return out


def test_the_reference_softmin_and_barycentre_are_the_brute_force_ones():
    """On a 5x7 grid, against sums over every (source, target) pair of
    the plan; in float64 within 1e-12 (only the order of the sums
    differs)."""
    gen = torch.Generator().manual_seed(3)
    h = 30.0 * torch.rand(5, 7, generator=gen, dtype=torch.float64)
    for eps in (0.5, 4.0):
        brute = _brute_softmin(h, eps)
        assert _gap(ref.softmin_exact(h, eps), brute) < 1e-12
        # the matmul form agrees where float64's exponent window holds it
        assert _gap(ref.softmin_matmul(h, eps), brute) < 1e-9
        y, x = torch.meshgrid(torch.arange(5, dtype=h.dtype),
                              torch.arange(7, dtype=h.dtype), indexing="ij")
        ty, tx = ref.barycentre(h, eps)
        for i in range(5):
            for j in range(7):
                w = torch.softmax(((h - (y - i) ** 2 - (x - j) ** 2) / eps)
                                  .reshape(-1), 0)
                assert abs(float(ty[i, j] - w @ y.reshape(-1))) < 1e-12
                assert abs(float(tx[i, j] - w @ x.reshape(-1))) < 1e-12


def test_the_reference_bfloat16_sums_are_coarser():
    """The control's exponent sums in bfloat16 move the softmin by about
    bfloat16's rounding of its terms, eps 2^-9 (8e-3 at eps 4): far more
    than float32's, and no more than a few of those steps."""
    gen = torch.Generator().manual_seed(5)
    h = 50.0 * torch.rand(12, 16, generator=gen, dtype=torch.float64)
    exact = ref.softmin_exact(h, EPS)
    gap = _gap(ref.softmin_exact(h, EPS, bf16_sums=True), exact)
    assert 1e-5 < gap < 8 * EPS * 2.0 ** -9


@pytest.mark.parametrize("stabilizer", STABILIZERS)
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["float64", "float32"])
def test_potentials_after_the_first_blocks(dtype, seed, stabilizer):
    """Two check blocks (50 iterations) from zero potentials at eps 4,
    theta 1.5, no stop (tol 0)."""
    a, b = _pair(seed, dtype)
    ours = sinkhorn.solve(a, b, EPS, max_iter=50, tol=0.0, theta=1.5,
                          stabilizer=stabilizer, verify=False)
    A, B = (t.double() / t.double().sum() for t in (a, b))
    zero = torch.zeros_like(A)
    theirs = ref.stage(A, B, EPS, zero, zero, budget=50, tol=0.0,
                       theta=1.5,
                       softmin=lambda h: ref.softmin_exact(h, EPS))
    assert ours.iterations == theirs.iters == 50
    scale = float(torch.max(torch.abs(theirs.f)))
    tol = 1e-10 if dtype == torch.float64 else 1e-5
    assert _gap(ours.f, theirs.f) < tol * scale
    assert _gap(ours.g, theirs.g) < tol * scale
    assert float(ours.marginal_error) == pytest.approx(
        theirs.error, rel=1e-6 if dtype == torch.float64 else 1e-3)


@pytest.mark.parametrize("stabilizer", STABILIZERS)
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["float64", "float32"])
def test_stop_counts(dtype, seed, stabilizer):
    """The annealed solve's final stage stops at the reference's own stop,
    a->b and a->a."""
    a, b = _pair(seed, dtype)
    for t in (b, a):
        ours = sinkhorn.solve_annealed(a, t, EPS, max_iter=1000,
                                       stabilizer=stabilizer, **KW)
        theirs = ref.solve(a.double(), t.double(), EPS, max_it=1000, **KW)
        assert theirs.stop is not None and theirs.stop < 1000
        assert ours.iterations == theirs.stop
        assert float(ours.marginal_error) <= KW["tol"]


def _reference_fields(a, iters_ab, iters_aa, eps=EPS):
    a, b = a
    A, B = a.double(), b.double()
    runs = [ref.solve(A, t, eps, max_it=1000, read_at=k, **KW)
            for t, k in ((B, iters_ab), (A, iters_aa))]
    return ref.fields(A / A.sum(), runs[0].g, runs[1].g, eps)


@pytest.mark.parametrize("stabilizer", ["auto", *STABILIZERS])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["float64", "float32"])
def test_fields_at_the_programs_counts(dtype, seed, stabilizer):
    """``solve_fields``' (u, v, m) against the reference read at the
    program's own counts; ``flow``'s (u, v) are its."""
    pair = _pair(seed, dtype)
    res = sinkhorn.solve_fields(*pair, EPS, max_iter=1000,
                                stabilizer=stabilizer, **KW)
    assert res.stabilizer == ("matmul" if stabilizer == "auto"
                              else stabilizer)
    u, v, m = _reference_fields(pair, res.iterations_ab, res.iterations_aa)
    # the pair moves by (2, 3) px and the debiasing keeps most of it
    assert float(torch.max(torch.abs(u))) > 1.0
    tol = 1e-10 if dtype == torch.float64 else 5e-4
    for name, got, want in [("u", res.u, u), ("v", res.v, v),
                            ("m", res.m, m)]:
        assert _gap(got, want) < tol, name
    fl = sinkhorn.flow(*pair, EPS, max_iter=1000, stabilizer=res.stabilizer,
                       **KW)
    assert torch.equal(fl.u, res.u) and torch.equal(fl.v, res.v)
    assert fl.iterations == max(res.iterations_ab, res.iterations_aa)


def _counts():
    return {k: trace.counts().get(f"sinkhorn.{k}", 0)
            for k in ("iterations", "exact_iterations", "escalations")}


def test_auto_escalates_to_the_exact_solve():
    """At eps 0.5 the float32 matmul softmin misses tol: ``auto`` solves
    again with the exact softmin, and its answer is that solve's, bit for
    bit; the counters count both (six stages a solve at this eps, a->b
    and a->a, each of the two stabilizers), and the answer holds to the
    float64 reference as the pinned solves do (1.3e-5 px read)."""
    eps = 0.5
    pair = _pair(SEEDS[0], torch.float32)
    before = _counts()
    res = sinkhorn.solve_fields(*pair, eps, max_iter=1000, stabilizer="auto",
                                **KW)
    after = _counts()
    exact = sinkhorn.solve_fields(*pair, eps, max_iter=1000,
                                  stabilizer="exact", **KW)
    again = _counts()
    assert res.stabilizer == "exact"
    assert res.marginal_error_matmul > KW["tol"]
    for name in ("u", "v", "m"):
        assert torch.equal(getattr(res, name), getattr(exact, name)), name
    assert (res.iterations_ab, res.iterations_aa) == (
        exact.iterations_ab, exact.iterations_aa)
    assert float(res.flow.marginal_error) <= KW["tol"]
    exact_run = again["exact_iterations"] - after["exact_iterations"]
    assert again["iterations"] - after["iterations"] == exact_run
    assert after["escalations"] - before["escalations"] == 1
    assert after["exact_iterations"] - before["exact_iterations"] \
        == exact_run
    # the matmul solves ran their final stages to max-it or to a stop
    matmul_run = after["iterations"] - before["iterations"] - exact_run
    assert matmul_run >= 2 * 6 * 25
    u, v, m = _reference_fields(pair, res.iterations_ab, res.iterations_aa,
                                eps)
    for name, got, want in [("u", res.u, u), ("v", res.v, v),
                            ("m", res.m, m)]:
        assert _gap(got, want) < 5e-4, name


def test_rows_whose_matmul_ratio_underflows_take_the_exact_statistics():
    """The benchmark pool's LargeMotion-lum pair at 32x24 and eps 2, float32:
    the matmul softmin's marginals verify within tol, but the two-stage
    ratio of the a->b plan's rows underflows at 25 pixels of the support.
    Those take the exact statistics of the same potential, so the flow
    holds to the float64 reference there too (the JAX package zeroes it:
    2.29 px off)."""
    from flowbench import harness
    from flowbench.traffic import generator
    traffic = harness.Cell(ROOT, "sinkhorn_mb1_320").traffic
    pair = generator.make_pool(dict(traffic, width=32, height=24,
                                    translation_scale=0.25))[13]
    a, b = (torch.as_tensor(f) for f in (pair.f1, pair.f2))
    eps = 2.0
    res, _ = sinkhorn._flow_solves(a, b, eps, anneal=True, debias=False,
                                   stabilizer="matmul", max_iter=1000,
                                   loop="auto", **KW)
    e = torch.tensor(eps)
    Ky, Kx = (sinkhorn._gibbs_1d(n, e, a.dtype, "cpu") for n in (24, 32))
    den, _ = sinkhorn._plan_row_stats(res.g, e, Ky, Kx, [(Ky, Kx)],
                                      sinkhorn._tiny(a.dtype, "cpu"))
    an = a / a.sum()
    lost = (an > 1e-3 * an.max()) & ~(den > sinkhorn._den_floor(a.dtype,
                                                                 "cpu"))
    assert int(lost.sum()) == 25
    out = sinkhorn.solve_fields(a, b, eps, max_iter=1000,
                                stabilizer="matmul", **KW)
    assert float(out.flow.marginal_error) <= KW["tol"]
    u, v, m = _reference_fields((a, b), out.iterations_ab,
                                out.iterations_aa, eps)
    for name, got, want in [("u", out.u, u), ("v", out.v, v),
                            ("m", out.m, m)]:
        assert _gap(got, want) < 5e-4, name
    assert _gap(out.u[lost], u[lost]) < 5e-4
    assert float(torch.max(torch.abs(u[lost]))) > 1.0
