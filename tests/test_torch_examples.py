"""The port's package API and its examples against the JAX package's.

The API: ``import ofot_tpu_torch`` touches no card and builds nothing;
the package and its ``ops``, ``solvers``, ``utils`` and ``parallel``
import the module lists of ``ofot_tpu``'s; ``solve_foto``/``solve_gn``
match ``ofot_tpu.solve_foto``/``solve_gn`` at float64 (fields within
1e-8; CG counts as tests/test_torch_foto.py and test_torch_gn.py hold
them: the cumulative stepA count within 2, GN's within 1);
the ready sets ``foto.DCT_OPS`` and ``PALLAS_OPS`` solve bitwise as fresh
``stepA_ops`` sets.

The examples: each JAX example (``examples/<name>.py --platform cpu``, a
subprocess, float32 as it runs) and the port's
``ofot_tpu_torch.examples.<name>.main(["--platform", "cpu"])`` print the
same lines up to their numbers; each number agrees within the example's
relative tolerance plus one unit of its last printed digit.  The
tolerances, and where they come from:

  * quickstart, sharded_solve: 1e-3; GN's float32 CG count (rtol 1e-10,
    below float32's resolution) within 25 steps: on the CPU the port's
    count spans 175-198 when the frames change by one float32 ulp (IE
    the same to 1e-7);
  * unbalanced_flow: FOTO 1e-3; WFR 2%.  At float64 the two packages'
    WFR solves agree to 1e-12 (iterations, crit, created mass); at
    float32 the port lands within 1e-5 of that float64 value while the
    JAX example, run without x64, lands 1.5% off (created mass 11.7806
    against 11.9564; 11.9564 again with x64 on, the arrays float32);
  * wasserstein: the dynamic W2 1e-3.  The entropic line is in the
    regime ``solvers/sinkhorn.py`` documents for the float32 matmul
    softmin (eps 2 on 48x48: the within-row spread passes the exp
    window); both packages report the failure (marginal error > 10x the
    tolerance 1e-4) but stop apart (JAX 225 iterations on its in-loop
    error, whose exp flushes denormals; the port 2000), so their W2 is
    held within 3% of each other and of the shift.  At float64, and at
    float32 with the exact stabilizer, the two agree (test below);
  * differentiable_ot: S at the start 1e-4, the gradient's range 2e-3,
    the descent's S 1%: the same float32 regime (each package's float32
    S is 2.6% from its float64 S); at float64 the two agree to 1e-12
    over the same steps (test below).
"""

import contextlib
import importlib
import io
import json
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ofot_tpu
import ofot_tpu_torch
from ofot_tpu.solvers import otgrad as jax_otgrad
from ofot_tpu.solvers import sinkhorn as jax_sinkhorn
from ofot_tpu_torch.solvers import flow_extract, foto, otgrad, sinkhorn, wfr

import fixtures

ROOT = Path(__file__).resolve().parents[1]
NUMBER = re.compile(r"(?<![\w.|])[-+]?\d+(?:\.\d+)?(?:e[-+]?\d+)?")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- the package

def test_import_touches_no_card_and_builds_nothing():
    code = (
        "import json, sys\n"
        "before = set(sys.modules)\n"
        "import ofot_tpu_torch, torch\n"
        "from ofot_tpu_torch.ops.kernels import _build\n"
        "new = set(sys.modules) - before\n"
        "print(json.dumps(dict(\n"
        "    cuda=torch.cuda.is_initialized(),\n"
        "    library=_build.load_library.cache_info().currsize,\n"
        "    dist=torch.distributed.is_initialized(),\n"
        "    pil=sorted(m for m in new if m.split('.')[0] == 'PIL'),\n"
        "    jax=sorted(m for m in new if m.split('.')[0] in\n"
        "               ('jax', 'jaxlib', 'ofot_tpu')))))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    rec = json.loads(proc.stdout.splitlines()[-1])
    assert rec == dict(cuda=False, library=0, dist=False, pil=[], jax=[])


def _init_imports(path: Path):
    """The names an ``__init__.py`` imports."""
    import ast
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
    return names


@pytest.mark.parametrize("sub", ["", "ops", "solvers", "utils",
                                 "parallel"])
def test_exported_names_match_jax(sub):
    theirs = _init_imports(ROOT / "ofot_tpu" / sub / "__init__.py")
    ours = _init_imports(ROOT / "ofot_tpu_torch" / sub / "__init__.py")
    assert ours == theirs
    pkg = importlib.import_module(".".join(filter(None, (
        "ofot_tpu_torch", sub))))
    for name in ours:
        assert hasattr(pkg, name), name
        if isinstance(getattr(pkg, name), types.ModuleType):
            assert getattr(pkg, name).__name__ == f"{pkg.__name__}.{name}"
    assert ofot_tpu_torch.solve_foto is foto.solve
    assert ofot_tpu_torch.solve_gn is ofot_tpu_torch.solvers.gn.solve_fields
    assert wfr.flow_from_potential is flow_extract.flow_from_potential


def test_solve_foto_and_solve_gn_match_jax_at_float64():
    f1, f2 = fixtures.smooth_blob_pair(18, 20)
    a, b = torch.from_numpy(f1), torch.from_numpy(f2)
    kw = dict(r=1.0, convergence_tol=0.05, reg_epsilon=1e-2, max_it=20)
    ours = ofot_tpu_torch.solve_foto(a, b, 4, **kw)
    theirs = ofot_tpu.solve_foto(jnp.asarray(f1), jnp.asarray(f2), 4, **kw)
    assert ours.state.iteration == int(theirs.state.iteration)
    # the cumulative CG steps of 20 stepA solves to rtol 1e-6 (float64
    # dot products summed in another order stop one of them a step apart)
    assert abs(ours.state.cg_iterations
               - int(theirs.state.cg_iterations)) <= 2
    for x, y in zip((ours.u, ours.v, ours.m),
                    (theirs.u, theirs.v, theirs.m)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0,
                                   atol=1e-8)
    ours = ofot_tpu_torch.solve_gn(a, b, 0.1, 0.2)
    theirs = ofot_tpu.solve_gn(jnp.asarray(f1), jnp.asarray(f2), 0.1, 0.2)
    # tests/test_torch_gn.py's bound: CG to rtol 1e-10 may stop a step
    # apart at float64
    assert abs(int(ours.cg.iterations) - int(theirs.cg.iterations)) <= 1
    for x, y in zip((ours.u, ours.v, ours.m),
                    (theirs.u, theirs.v, theirs.m)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0,
                                   atol=1e-8)


@pytest.mark.parametrize("ready,name", [("DCT_OPS", "dct"),
                                        ("PALLAS_OPS", "pallas")])
def test_ready_sets_solve_as_fresh_sets(ready, name):
    ops = getattr(foto, ready)
    assert type(ops) is type(foto.stepA_ops(name))
    f1, f2 = fixtures.smooth_blob_pair(18, 20, dtype=np.float32)
    a, b = torch.from_numpy(f1), torch.from_numpy(f2)
    kw = dict(r=1.0, convergence_tol=0.01, reg_epsilon=1e-2, max_it=12,
              admm_alpha=1.7)
    for _ in range(2):       # the second solve reuses the ready set's plan
        got = foto.solve_potential(a, b, 4, ops=ops, **kw)
        want = foto.solve_potential(a, b, 4, ops=foto.stepA_ops(name), **kw)
        assert got.iteration == want.iteration
        assert torch.equal(got.phi, want.phi)
        assert torch.equal(got.mu, want.mu)


# ------------------------------------------------------------- the examples

def jax_example(name, env=None):
    """The JAX example's stdout, run as its docstring says, on the CPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env or {}))
    proc = subprocess.run([sys.executable, f"examples/{name}.py",
                           "--platform", "cpu"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.splitlines()


def port_example(name):
    """The port's example on the CPU -> (stdout lines, returned numbers)."""
    mod = importlib.import_module(f"ofot_tpu_torch.examples.{name}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = mod.main(["--platform", "cpu"])
    return out.getvalue().splitlines(), res


def _numbers(line):
    return [(float(m.group()), len(m.group().split(".")[1].split("e")[0])
             if "." in m.group() else 0) for m in NUMBER.finditer(line)]


def compare_lines(ours, theirs, rtol, special=None):
    """The same lines with their numbers replaced by '#', and each pair of
    numbers within ``rtol`` relative plus one unit of the last printed
    digit; ``special[(line, k)]`` overrides number k of a line: a float
    is its relative tolerance, ``("count", n)`` a count within n, and None
    leaves it to the caller."""
    special = special or {}
    assert len(ours) == len(theirs), (ours, theirs)
    for i, (a, b) in enumerate(zip(ours, theirs)):
        assert NUMBER.sub("#", a) == NUMBER.sub("#", b), (a, b)
        for k, ((x, dx), (y, dy)) in enumerate(zip(_numbers(a),
                                                  _numbers(b))):
            rule = special.get((i, k), rtol)
            if rule is None:
                continue
            if isinstance(rule, tuple):
                assert abs(x - y) <= rule[1], (a, b)
            else:
                assert abs(x - y) <= rule * abs(y) + 10.0 ** -max(dx, dy), (
                    a, b, rule)


def test_quickstart_matches_jax():
    ours, res = port_example("quickstart")
    compare_lines(ours, jax_example("quickstart"), 1e-3,
                  {(3, 0): ("count", 25)})
    assert res["foto_IE"] < 60 and res["gn_IE"] < 80


def test_unbalanced_flow_matches_jax():
    ours, res = port_example("unbalanced_flow")
    compare_lines(ours, jax_example("unbalanced_flow"), 1e-3,
                  {(2, 0): 2e-2, (2, 1): 2e-2, (3, 0): 2e-2, (3, 2): 2e-2})
    # WFR explains the brightening better than balanced FOTO
    assert res["wfr_IE"] < res["foto_IE"]
    assert 0 < res["created"] < res["true_gain"]


def test_wasserstein_matches_jax():
    ours, res = port_example("wasserstein")
    theirs = jax_example("wasserstein")
    compare_lines(ours, theirs, 1e-3, {(3, 0): 3e-2, (3, 1): None,
                                       (3, 2): None, (7, 0): None})
    assert abs(res["dynamic"] - 4.0) / 4.0 < 0.01
    assert abs(res["entropic"] - 4.0) / 4.0 < 0.03
    their_err = _numbers(theirs[3])[1][0]
    assert res["marginal_error"] > 1e-3 and their_err > 1e-3


def test_wasserstein_entropic_matches_jax_where_it_converges():
    """The example's entropic W2 at float64 (matmul softmin) and at
    float32 with the exact stabilizer: both packages converge, to the
    same value and iteration count."""
    ny = nx = 48
    y, x = np.mgrid[0:ny, 0:nx].astype(np.float32)

    def blob(cy, cx):
        return np.exp(-(((y - cy) / 6.0) ** 2 + ((x - cx) / 6.0) ** 2))

    a, b = blob(24, 22), blob(24, 26)
    a, b = a / a.sum(), b / b.sum()
    for dtype, kw, rtol in ((np.float64, {}, 1e-9),
                            (np.float32, dict(stabilizer="exact"), 1e-5)):
        p, q = a.astype(dtype), b.astype(dtype)
        ours = sinkhorn.wasserstein2_entropic(
            torch.from_numpy(p), torch.from_numpy(q), epsilon=2.0,
            max_iter=2000, full=True, **kw)
        theirs = jax_sinkhorn.wasserstein2_entropic(
            jnp.asarray(p), jnp.asarray(q), epsilon=2.0, max_iter=2000,
            full=True, **kw)
        assert int(ours.iterations) == int(theirs.iterations)
        assert float(ours.marginal_error) < 1e-4
        np.testing.assert_allclose(float(ours.value), float(theirs.value),
                                   rtol=rtol)
        assert abs(float(ours.value) - 4.0) < 1e-4


def test_differentiable_ot_matches_jax():
    ours, res = port_example("differentiable_ot")
    compare_lines(ours, jax_example("differentiable_ot"), 1e-4,
                  {(0, 1): 1e-3, (1, 2): 2e-3, (1, 3): 2e-3, (3, 1): 1e-2,
                   (4, 0): 1e-2})
    assert res["after"] < res["steps"][1] < res["steps"][0]


def test_differentiable_ot_steps_match_jax_at_float64():
    """The example's value-and-gradient and mirror-descent steps at
    float64: S and the gradient field agree to 1e-12 over three steps."""
    n = 40
    y, x = np.mgrid[0:n, 0:n].astype(np.float64)

    def blob(cy, cx):
        return np.exp(-((y - cy) ** 2 + (x - cx) ** 2) / 22) + 1e-4

    kw = (("max_iter", 600), ("tol", 1e-6))
    a, b = torch.from_numpy(blob(14, 14)), torch.from_numpy(blob(26, 23))
    ja, jb = jnp.asarray(blob(14, 14)), jnp.asarray(blob(26, 23))
    for _ in range(3):
        val, g = otgrad.value_and_grad(otgrad.sinkhorn_divergence_dual, a,
                                       b, 4.0, kw)
        jval, jg = jax.value_and_grad(jax_otgrad.sinkhorn_divergence_dual)(
            ja, jb, 4.0, kw)
        np.testing.assert_allclose(float(val), float(jval), rtol=1e-12)
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0,
                                   atol=1e-12 * float(np.abs(jg).max()))
        mass = float(a.sum())
        a = a * torch.exp(-0.6 * g / g.abs().max())
        a = a * mass / a.sum()
        jmass = float(jnp.sum(ja))
        ja = ja * jnp.exp(-0.6 * jg / jnp.max(jnp.abs(jg)))
        ja = ja * jmass / jnp.sum(ja)


@pytest.mark.parametrize("name", ["quickstart", "unbalanced_flow",
                                  "wasserstein", "differentiable_ot",
                                  "sharded_solve"])
def test_examples_refuse_cuda_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    mod = importlib.import_module(f"ofot_tpu_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
