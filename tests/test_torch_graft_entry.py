"""The port's entry hooks (``ofot_tpu_torch.graft_entry``) against the JAX
package's ``__graft_entry__`` on the CPU.

``entry()``: one ALG2 step on ``_example_pair()`` against JAX's eager
``init_state`` + ``alg2_iteration`` on the same frames (not its jitted
step: JAX's own jitted and eager float32 steps differ by 0.9% in crit,
0.7384043 against 0.745356, because CG stops at 50 of ~158 steps and
amplifies rounding).  Measured on an AMD EPYC CPU:

  * float32, entry()'s own step (CG capped at 50): phi within 2.02e-6 of
    max|phi|, crit 0.7453279 against 0.7453560 (3.8e-5 relative); held
    to ENTRY_F32_PHI = 5e-6 and ENTRY_F32_CRIT_RTOL = 1e-4;
  * float64, the same step built from ``foto.init_state`` and
    ``foto.alg2_iteration`` (bitwise entry()'s at float32) with CG run to
    its tolerance: at the default cg_rtol 1e-6, 153 CG steps in both, phi
    within 2.8e-11 of max|phi|; at cg_rtol 1e-12, 241 steps in both,
    4.0e-15; held to 1e-10 and equal CG steps.

At cg_rtol 1e-6 the step is sensitive to rounding: inputs perturbed by
one-ulp noise move the port's own phi by 4-5e-9 of max|phi| on that CPU
(1e-12: 5.5e-15), so JAX's and the port's agreement there rests on the
two running the same operations on the same CPU; the card, which rounds
its reductions and fused multiply-adds otherwise, is held to the CPU at
cg_rtol 1e-12 (``chip_smoke.py`` phase 21).

``dryrun_multichip(n)`` at n = 1 and 4 (8 ranks would load every core
of an 8-core host, and JAX's own test leaves n = 8 out below 8 devices):
every assertion of every leg passes in the port's world, and every leg
stops on its own rule (``done``), as in JAX's ``dryrun_multichip(n)`` on
conftest's virtual devices, whose printed line is parsed (crit to 4
significant digits).  Measured gaps (port against JAX, float32):

  * n = 1: tiled FOTO 26 / 26 iterations (1028 CG steps both), crit
    0.048563 / 0.04855; GSPMD dct 26 / 26, 0.048560 / 0.04856; tiled WFR
    24 / 24, 0.047704 / 0.04771; n = 4 (a 2x2 mesh, 16x16 frames): GSPMD
    dct 29 / 29, 0.049849 / 0.04985.  These are held to equal iterations
    and crit within CRIT_ATOL = 5e-5 of JAX's printed value (measured at
    most 1.3e-5).
  * n = 4, the tiled FOTO and WFR legs: 41 / 30 and 31 / 31 iterations.
    They cap CG at 40 steps, which every ALG2 iteration reaches; a
    truncated CG amplifies a rounding-level difference, such as the order
    of a sum across tiles, so their iteration counts are chaotic (JAX's
    own whole, untiled solve of the FOTO leg's frames stops at 41, its
    tiled one at 30).  Only their ``done`` is held at float32.  Instead
    the same two tiled solves, on the same 2x2 mesh and 16x16 frames with
    the legs' parameters, run at float64 with CG to rtol 1e-12 in one
    4-rank gloo world (``parallel.cases``) against JAX's
    ``foto_sharded``/``wfr_sharded.solve_potential_tiled``: FOTO 29 / 29
    iterations, 2874 CG steps both, phi within 7.6e-15 of max|phi|, crit
    6.5e-13 relative; WFR 27 / 27, 2575 both, 2.3e-14, 9.6e-13.  Held to
    equal iterations, CG steps within 2 (the tiles' dot products sum in
    another order), phi and mu within F64_PHI = 1e-10 of max|phi| and
    crit within 1e-10 relative.
"""

import contextlib
import io
import os
import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofot_tpu.parallel import foto_sharded as jax_foto_sharded
from ofot_tpu.parallel import mesh as jax_mesh
from ofot_tpu.parallel import wfr_sharded as jax_wfr_sharded
from ofot_tpu.solvers import foto as jax_foto
from ofot_tpu_torch import graft_entry
from ofot_tpu_torch.parallel import cases, launch
from ofot_tpu_torch.solvers import foto

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import __graft_entry__ as jax_graft  # noqa: E402

ENTRY_F32_PHI, ENTRY_F32_CRIT_RTOL = 5e-6, 1e-4
F64_PHI = 1e-10
CG_TO_TOLERANCE = 10_000
CRIT_ATOL = 5e-5
LEGS = ("tiled", "gspmd", "wfr")
# the legs held to JAX's printed readings (equal iterations, CRIT_ATOL);
# the CG-capped legs at n = 4 are held at float64 below
EXACT_LEGS = [(1, leg) for leg in LEGS] + [(4, "gspmd")]
# the n = 4 tiled legs at float64, CG to its tolerance: (name, the case's
# function in parallel.cases, JAX's module, keywords)
PAIR16 = graft_entry._example_pair(16, 16, dtype=np.float64)
DRY_KW = dict(r=1.0, reg_epsilon=1e-2, convergence_tol=0.05, max_it=150,
              cg_rtol=1e-12, cg_maxiter=CG_TO_TOLERANCE)
TILED64 = {"tiled": ("foto_tiled", jax_foto_sharded, DRY_KW),
           "wfr": ("wfr_tiled", jax_wfr_sharded,
                   dict(DRY_KW, max_it=300, delta=10.0))}

LINE = re.compile(
    r"dryrun_multichip OK: tiled solve mesh\(y=(\d+), x=(\d+)\) converged "
    r"crit=(\S+) in (\d+) its \(cg (\d+)\); gspmd-dct converged "
    r"crit=(\S+) in (\d+) its; wfr tiled converged crit=(\S+) in (\d+) "
    r"its; dp batch (\d+) over data=(\d+) \(foto \+ sinkhorn\)")


def _parse(text: str) -> dict:
    m = LINE.search(text)
    assert m, text
    g = m.groups()
    return {"mesh": (int(g[0]), int(g[1])), "batch": (int(g[9]), int(g[10])),
            "tiled": {"crit": float(g[2]), "iterations": int(g[3]),
                      "cg_iterations": int(g[4])},
            "gspmd": {"crit": float(g[5]), "iterations": int(g[6])},
            "wfr": {"crit": float(g[7]), "iterations": int(g[8])}}


_RUNS = {}


def _runs(n: int):
    """(the port's readings, the port's printed line, JAX's printed line)
    of ``dryrun_multichip(n)`` on the CPU, each run once a module."""
    if n not in _RUNS:
        port_out, jax_out = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(port_out):
            if n == 1:
                res = graft_entry.main(["1", "--platform", "cpu"])
            else:
                res = graft_entry.dryrun_multichip(n, platform="cpu")
        # JAX's dry run appends a device count to XLA_FLAGS; the backend
        # already has conftest's 8 virtual devices
        before = os.environ.get("XLA_FLAGS")
        try:
            with contextlib.redirect_stdout(jax_out):
                jax_graft.dryrun_multichip(n)
        finally:
            if before is None:
                os.environ.pop("XLA_FLAGS", None)
            else:
                os.environ["XLA_FLAGS"] = before
        _RUNS[n] = res, _parse(port_out.getvalue()), _parse(jax_out.getvalue())
    return _RUNS[n]


# ------------------------------------------------------- factors, inputs

@pytest.mark.parametrize("n", range(1, 17))
def test_mesh_and_spatial_factors_match_jax(n):
    assert graft_entry._mesh_factors(n) == jax_graft._mesh_factors(n)
    assert graft_entry._spatial_factors(n) == jax_graft._spatial_factors(n)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_example_pair_is_jax_bitwise(dtype):
    for shape in ((32, 40), (16, 16), (8, 8)):
        ours = graft_entry._example_pair(*shape, dtype=dtype)
        theirs = jax_graft._example_pair(*shape, dtype=dtype)
        for a, b in zip(ours, theirs):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------- entry

def test_entry_step_on_the_cpu():
    fn, args = graft_entry.entry(device="cpu")
    assert all(a.device.type == "cpu" and a.dtype == torch.float32
               for a in args)
    phi, crit = fn(*args)
    assert phi.shape == (8, 32, 40) and phi.device.type == "cpu"
    assert bool(torch.isfinite(phi).all())
    assert np.isfinite(float(crit))


def _jax_eager_step(dtype, cg_maxiter, cg_rtol=1e-6):
    a, b = (jnp.asarray(f) for f in jax_graft._example_pair(dtype=dtype))
    st = jax_foto.init_state(a, b, 8)
    return jax_foto.alg2_iteration(st, a, b, r=1.0, reg_epsilon=1e-2,
                                   convergence_tol=0.01, cg_rtol=cg_rtol,
                                   cg_maxiter=cg_maxiter)


def _port_step(dtype, cg_maxiter, cg_rtol=1e-6):
    """entry()'s step made from ``foto.init_state`` + ``alg2_iteration``
    on the CPU at ``dtype`` -> its state."""
    a, b = (torch.as_tensor(f)
            for f in graft_entry._example_pair(dtype=dtype))
    st = foto.init_state(a, b, 8)
    return foto.alg2_iteration(st, a, b, r=1.0, reg_epsilon=1e-2,
                               convergence_tol=0.01, cg_rtol=cg_rtol,
                               cg_maxiter=cg_maxiter)


def test_entry_is_init_state_and_one_alg2_iteration():
    """The float64 checks below build entry()'s step themselves: at
    float32 it is entry()'s bitwise."""
    fn, args = graft_entry.entry(device="cpu")
    phi, crit = fn(*args)
    st = _port_step(np.float32, 50)
    assert torch.equal(phi, st.phi) and torch.equal(crit, st.crit)
    assert int(st.cg_iterations) == 50


def test_entry_matches_jax_eager_step_float32():
    fn, args = graft_entry.entry(device="cpu")
    phi, crit = (t.numpy() for t in fn(*args))
    st = _jax_eager_step(np.float32, 50)
    want = np.asarray(st.phi)
    assert phi.dtype == want.dtype == np.float32
    assert np.abs(phi - want).max() <= ENTRY_F32_PHI * np.abs(want).max()
    np.testing.assert_allclose(float(crit), float(st.crit),
                               rtol=ENTRY_F32_CRIT_RTOL)


@pytest.mark.parametrize("cg_rtol,steps", [(1e-6, 153), (1e-12, 241)])
def test_entry_matches_jax_eager_step_float64_cg_converged(cg_rtol, steps):
    st = _port_step(np.float64, CG_TO_TOLERANCE, cg_rtol)
    want = _jax_eager_step(np.float64, CG_TO_TOLERANCE, cg_rtol)
    phi, scale = st.phi.numpy(), np.abs(np.asarray(want.phi)).max()
    assert np.abs(phi - np.asarray(want.phi)).max() <= F64_PHI * scale
    np.testing.assert_allclose(float(st.crit), float(want.crit),
                               rtol=F64_PHI)
    assert int(st.cg_iterations) == int(want.cg_iterations) == steps


# ------------------------------------------------------ dryrun_multichip

@pytest.mark.parametrize("n", [1, 4])
def test_dryrun_runs_every_leg_and_prints_jax_line(n):
    """Every leg's assertions pass (a failing one fails the world), every
    leg stops on its own rule, and the printed line carries the returned
    readings in JAX's format."""
    res, line, jax_line = _runs(n)
    py, px = jax_graft._spatial_factors(n)
    assert line["mesh"] == jax_line["mesh"] == (py, px)
    assert line["batch"] == jax_line["batch"] == (2 * n, n)
    for leg in LEGS:
        assert res[leg]["done"] is True, leg
        assert line[leg]["iterations"] == res[leg]["iterations"]
        assert line[leg]["crit"] == float(f"{res[leg]['crit']:.4g}")
    assert line["tiled"]["cg_iterations"] == res["tiled"]["cg_iterations"]
    for leg in ("map", "vmap"):
        assert len(res[leg]["iterations"]) == 2 * n
        assert all(i == 4 for i in res[leg]["iterations"])
    assert res["vmap"]["iterations"] == res["map"]["iterations"]
    assert res["vmap"]["max_abs_gap"] <= 1e-5
    assert np.isfinite(res["sinkhorn"]["marginal_error"]).all()
    for leg in (*LEGS, "map", "vmap", "sinkhorn"):
        assert res[leg]["wall_s"] > 0
        # the CPU runs every kernel's plain version and no device loop
        assert not any(res[leg]["launches"].values()), leg
        assert res[leg]["loops"]["captures"] == 0, leg


@pytest.mark.parametrize("n,leg", EXACT_LEGS)
def test_dryrun_leg_matches_jax(n, leg):
    res, _, jax_line = _runs(n)
    want = jax_line[leg]
    assert res[leg]["iterations"] == want["iterations"]
    assert abs(res[leg]["crit"] - want["crit"]) <= CRIT_ATOL
    if leg == "tiled":
        assert res[leg]["cg_iterations"] == want["cg_iterations"]


@pytest.fixture(scope="module")
def tiled64():
    """The n = 4 dry run's tiled FOTO and WFR solves at float64, CG to
    its tolerance, on the 2x2 mesh of one 4-rank gloo world."""
    runs = [(leg, {"y": 2, "x": 2}, fn,
             dict(f1=PAIR16[0], f2=PAIR16[1], Nt=graft_entry.NT_DRYRUN,
                  **kw)) for leg, (fn, _, kw) in TILED64.items()]
    return launch.run(cases.run_cases, 4, runs, "cpu",
                      threads=launch.cpu_threads(4), seconds=240)[0]


@pytest.mark.parametrize("leg", TILED64)
def test_dryrun_tiled_leg_at_float64_matches_jax(tiled64, leg):
    got = tiled64[leg]
    _, module, kw = TILED64[leg]
    want = module.solve_potential_tiled(
        *(jnp.asarray(f) for f in PAIR16), graft_entry.NT_DRYRUN,
        jax_mesh.spatial_mesh(2, 2), **kw)
    assert bool(got["done"]) and bool(want.done)
    assert int(got["iteration"]) == int(want.iteration)
    assert abs(int(got["cg_iterations"]) - int(want.cg_iterations)) <= 2
    scale = np.abs(np.asarray(want.phi)).max()
    for name in ("phi", "mu"):
        np.testing.assert_allclose(got[name], np.asarray(getattr(want, name)),
                                   rtol=0, atol=F64_PHI * scale)
    np.testing.assert_allclose(float(got["crit"]), float(want.crit),
                               rtol=F64_PHI)


def test_main_defaults_to_eight_ranks_on_the_card(monkeypatch):
    calls = []
    monkeypatch.setattr(graft_entry, "dryrun_multichip",
                        lambda n, platform: calls.append((n, platform)))
    graft_entry.main([])
    graft_entry.main(["4", "--platform", "cpu"])
    assert calls == [(8, "cuda"), (4, "cpu")]


# ------------------------------------------------------------- no card

def test_entry_points_raise_without_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default platform works")
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.dryrun_multichip(1)
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.main(["1"])
    fn, args = graft_entry.entry(device="cpu")
    assert args[0].device.type == "cpu"
