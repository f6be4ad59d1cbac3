"""The port's distribution layer against whole solves and against the JAX
package, on the CPU: counterpart of tests/test_parallel.py.

One local world of 4 gloo processes (``parallel.launch.run``, a file
rendezvous in a temporary directory, joined under a time limit) runs
every case, each on a mesh of its own shape: (y, x) = (2, 2) for the halo
stencils, the tiled and the GSPMD-route solves, (1, 4) and (4, 1) as well
for the edge lines of the tile operator and the tiled ``cg-pallas`` solve,
``data`` = 4 and 2 for the data sweeps.  The code the ranks run is
``ofot_tpu_torch.parallel.cases``.  Every rank must return the same result (the stop decisions are
made from all-reduced values), and rank 0's is checked.

Tolerances are tests/test_parallel.py's, at float64: the halo stencils
atol 1e-12, the all-reduced sum rtol 1e-12; tiled against whole solves
(and against JAX's tiled solves on conftest's 8 virtual devices) phi, mu,
u, v, m atol 1e-8 and crit rtol 1e-6, with the same iteration count;
``auto_r`` at float32 atol 2e-5.  The tiled ``cg-pallas`` solves (the
tile form of kernel #4, whose CPU path is its plain version) run CG to
rtol 1e-13 and must also take within 2 CG steps of the whole solve in
all (their dot products sum in another order; JAX's own tiled run takes
one step more than its whole one).
"""

import operator
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofot_tpu.parallel import foto_sharded as jax_foto_sharded
from ofot_tpu.parallel import gn_sharded as jax_gn_sharded
from ofot_tpu.parallel import gspmd as jax_gspmd
from ofot_tpu.parallel import mesh as jax_mesh
from ofot_tpu.parallel import wfr_sharded as jax_wfr_sharded
from ofot_tpu.solvers import foto as jax_foto
from ofot_tpu.solvers import gn as jax_gn
from ofot_tpu_torch.ops import operators
from ofot_tpu_torch.parallel import cases, launch
from ofot_tpu_torch.solvers import foto, gn, wfr

import fixtures

RNG = np.random.default_rng(23)
PHI = RNG.standard_normal((3, 8, 12))
MU = RNG.standard_normal((3, 3, 8, 12))
X = RNG.standard_normal((8, 12))
SQ = fixtures.translating_square(24)
BLOB = fixtures.smooth_blob_pair(16, 24)
UNBAL = (BLOB[0], 1.3 * BLOB[1])
AUTO = tuple(7.3 * f for f in fixtures.smooth_blob_pair(16, 16,
                                                        dtype=np.float32))
FOTO_KW = dict(r=1.0, convergence_tol=1e-6, reg_epsilon=1e-2, max_it=8,
               cg_rtol=1e-13)
WFR_KW = dict(delta=10.0, r=0.5, convergence_tol=1e-6, reg_epsilon=1e-2,
              max_it=8, cg_rtol=1e-13)
GSPMD_KW = dict(r=1.0, convergence_tol=1e-6, reg_epsilon=1e-2, max_it=6)
AUTO_KW = dict(r=1.0, reg_epsilon=1e-2, convergence_tol=0.0, max_it=6,
               cg_rtol=1e-12, cg_maxiter=300, auto_r=True)
SETS = ("cg", "dct", "dct-refined", "dct-fused", "pallas", "cg-pallas")
CG_SETS = ("cg", "cg-pallas")
WFR_GSPMD_KW = dict(delta=10.0, r=0.5, convergence_tol=1e-6,
                    reg_epsilon=1e-2, max_it=6)


def _gspmd_kw(ops, kw=GSPMD_KW):
    """The CG sets run the tiled halo CG, whose dot products sum in
    another order than the whole CG's: CG to tests/test_parallel.py's
    tiled rtol, 1e-13, so that both stop at the fixed point."""
    return dict(kw, cg_rtol=1e-13) if ops in CG_SETS else kw

SWEEP_KW = dict(r=1.0, convergence_tol=1e-6, reg_epsilon=1e-2, max_it=4)
# a lockstep block sums its CG dots per pair, in another order than one
# pair's CG: CG to 1e-13, so that both stop at the fixed point
DATA_KW = dict(SWEEP_KW, cg_rtol=1e-13)
D4 = (np.stack([SQ[0] * s for s in (1.0, 0.9, 0.8, 0.7)]),
      np.stack([SQ[1] * s for s in (1.0, 0.9, 0.8, 0.7)]))
HETERO = [("a", *fixtures.translating_square(18)),
          ("b", *fixtures.smooth_blob_pair(12, 16)),
          ("c", *fixtures.smooth_blob_pair(12, 16, shift=(1.0, 2.0)))]
BATCH = (np.stack([fixtures.smooth_blob_pair(12, 14, shift=s)[0]
                   for s in ((2, 1), (-1, 2), (1, 0), (0, -1))]),
         np.stack([fixtures.smooth_blob_pair(12, 14, shift=s)[1]
                   for s in ((2, 1), (-1, 2), (1, 0), (0, -1))]))
BATCH_FOTO = dict(Nt=4, max_it=5, stepA_solver="dct", convergence_tol=1e-6,
                  reg_epsilon=1e-2)

TILES = {"y": 2, "x": 2}
MESHES = {"2x2": TILES, "1x4": {"y": 1, "x": 4}, "4x1": {"y": 4, "x": 1}}
CASES = [
    ("stencils", TILES, "stencils", dict(phi=PHI, mu=MU, x=X)),
    ("foto", TILES, "foto_tiled", dict(f1=SQ[0], f2=SQ[1], Nt=4, **FOTO_KW)),
    ("wfr", TILES, "wfr_tiled", dict(f1=UNBAL[0], f2=UNBAL[1], Nt=4,
                                     **WFR_KW)),
    ("gn", TILES, "gn_tiled", dict(f1=BLOB[0], f2=BLOB[1], rtol=1e-12)),
    ("auto_r", TILES, "foto_tiled", dict(f1=AUTO[0], f2=AUTO[1], Nt=4,
                                         **AUTO_KW)),
    ("refusals", TILES, "refusals", {}),
    *[(f"gspmd_foto_{s}", TILES, "foto_gspmd",
       dict(f1=SQ[0], f2=SQ[1], Nt=4, ops=s, **_gspmd_kw(s))) for s in SETS],
    ("gspmd_wfr", TILES, "wfr_gspmd",
     dict(f1=UNBAL[0], f2=UNBAL[1], Nt=4, **WFR_GSPMD_KW)),
    ("gspmd_wfr_cg-pallas", TILES, "wfr_gspmd",
     dict(f1=UNBAL[0], f2=UNBAL[1], Nt=4, ops="cg-pallas",
          **_gspmd_kw("cg-pallas", WFR_GSPMD_KW))),
    *[(f"edge_lines_{m}", shape, "edge_lines", dict(field=PHI))
      for m, shape in MESHES.items()],
    *[(f"gspmd_foto_cg-pallas_{m}", MESHES[m], "foto_gspmd",
       dict(f1=SQ[0], f2=SQ[1], Nt=4, ops="cg-pallas",
            **_gspmd_kw("cg-pallas"))) for m in ("1x4", "4x1")],
    ("gspmd_gn", TILES, "gn_gspmd", dict(f1=BLOB[0], f2=BLOB[1])),
    ("foto_batch", {"data": 4}, "foto_batch",
     dict(r0=D4[0], rT=D4[1], Nt=4, device="cpu", **DATA_KW)),
    ("gn_batch", {"data": 4}, "gn_batch",
     dict(f1s=BATCH[0], f2s=BATCH[1], device="cpu")),
    *[(f"full_{algo}_{mode}", {"data": 4}, "batch_full",
       dict(algo=algo, f1s=BATCH[0], f2s=BATCH[1], batch_mode=mode,
            foto_params=BATCH_FOTO))
      for algo in ("foto", "GN") for mode in ("map", "vmap")],
    ("sweep", {"data": 2}, "sweep_foto",
     dict(pairs=HETERO, Nt=4, device="cpu",
          **dict(SWEEP_KW, max_it=3))),
]


@pytest.fixture(scope="module")
def world():
    """Every case on every rank of one 4-process gloo world."""
    return launch.run(cases.run_cases, 4, CASES, "cpu", seconds=240)


@pytest.fixture(scope="module")
def mesh4():
    return jax_mesh.spatial_mesh(2, 2)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _case(world, name):
    """Rank 0's result of a case, after checking that every other rank of
    the case's mesh returned the same bits (its digest)."""
    results = [r[name] for r in world if r[name] is not None]
    for other in results[1:]:
        assert cases.digest(results[0]) == other
    return results[0]


def _close(got, want, atol=1e-8):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _assert_state(got, want, with_mu=True):
    _close(got["phi"], want.phi)
    if with_mu:
        _close(got["mu"], want.mu)
    np.testing.assert_allclose(float(got["crit"]), float(want.crit),
                               rtol=1e-6)
    assert int(got["iteration"]) == int(want.iteration)


# ------------------------------------------------------------ halo stencils

@pytest.mark.parametrize("name,arg", [("laplacian_st", PHI),
                                      ("grad_st", PHI), ("div_st", MU)])
def test_ops_tiled_equal_whole(world, name, arg):
    got = _case(world, "stencils")[name]
    _close(got, getattr(operators, name)(_t(arg), bc="N"), atol=1e-12)


def test_all_reduce_sum(world):
    np.testing.assert_allclose(_case(world, "stencils")["sum"],
                               float(np.sum(X * X)), rtol=1e-12)


# ------------------------------------------------------------- tiled solves

def test_tiled_foto_equals_whole_and_jax(world, mesh4):
    got = _case(world, "foto")
    _assert_state(got, foto.solve_potential(_t(SQ[0]), _t(SQ[1]), 4,
                                            **FOTO_KW))
    _assert_state(got, jax_foto_sharded.solve_potential_tiled(
        jnp.asarray(SQ[0]), jnp.asarray(SQ[1]), 4, mesh4, **FOTO_KW))


def test_tiled_wfr_equals_whole_and_jax(world, mesh4):
    got = _case(world, "wfr")
    _assert_state(got, wfr.solve_potential(
        _t(UNBAL[0]), _t(UNBAL[1]), 4, ops=foto.DEFAULT_OPS, **WFR_KW))
    _assert_state(got, jax_wfr_sharded.solve_potential_tiled(
        jnp.asarray(UNBAL[0]), jnp.asarray(UNBAL[1]), 4, mesh4, **WFR_KW))


def test_tiled_gn_equals_whole_and_jax(world, mesh4):
    got = _case(world, "gn")
    whole = gn.solve_fields(_t(BLOB[0]), _t(BLOB[1]), precond="jacobi",
                            rtol=1e-12)
    jax_tiled = jax_gn_sharded.solve_fields_tiled(
        jnp.asarray(BLOB[0]), jnp.asarray(BLOB[1]), mesh4, rtol=1e-12)
    for want in (whole, jax_tiled):
        for k in ("u", "v", "m"):
            _close(got[k], getattr(want, k))
    assert int(got["iterations"]) == whole.cg.iterations


@pytest.mark.parametrize("name", ["foto", "wfr", "gn"])
def test_tiled_shape_validation(world, name):
    assert "not divisible by mesh" in _case(world, "refusals")[name]


def test_auto_r_tiled_matches_whole(world):
    """``auto_r``'s penalty is the GLOBAL max density (all-reduced MAX):
    the blob's peak lies in one tile."""
    got = _case(world, "auto_r")
    whole = foto.solve_potential(_t(AUTO[0]), _t(AUTO[1]), 4, **AUTO_KW)
    _close(got["phi"], whole.phi, atol=2e-5)
    assert int(got["iteration"]) == whole.iteration


# ----------------------------------------------- the gather route (GSPMD)

@pytest.mark.parametrize("ops", SETS)
def test_foto_gspmd_equals_whole(world, mesh4, ops):
    got = _case(world, f"gspmd_foto_{ops}")
    whole = foto.solve_potential(_t(SQ[0]), _t(SQ[1]), 4,
                                 ops=foto.stepA_ops(ops), **_gspmd_kw(ops))
    _close(got["phi"], whole.phi)
    assert int(got["iteration"]) == whole.iteration
    if ops in ("cg", "dct"):       # tests/test_parallel.py's two sets
        jax_ops = {"cg": jax_foto.DEFAULT_OPS, "dct": jax_foto.DCT_OPS}[ops]
        want = jax_foto.solve_potential(jnp.asarray(SQ[0]),
                                        jnp.asarray(SQ[1]), 4, ops=jax_ops,
                                        **_gspmd_kw(ops))
        _close(got["phi"], want.phi)
    if ops == "cg-pallas":
        _assert_cg_pallas(world, "gspmd_foto_cg-pallas", whole,
                          jax_gspmd.solve_foto_sharded(
                              jnp.asarray(SQ[0]), jnp.asarray(SQ[1]), 4,
                              mesh4, ops=jax_foto.stepA_ops("cg-pallas"),
                              **_gspmd_kw(ops)))


def _assert_cg_pallas(world, name, whole, jax_sharded):
    """A tiled cg-pallas solve against the port's whole solve and JAX's
    sharded one: the state, the iterations, CG steps within 2 of the
    whole solve's; no launch on the CPU (the plain version runs)."""
    got = _case(world, name)
    for want in (whole, jax_sharded):
        _assert_state(got, want)
    assert abs(int(got["cg_iterations"]) - int(whole.cg_iterations)) <= 2
    for r in world:
        assert r[f"{name}_launches"]["cg_operator_tile"] == 0


def test_wfr_gspmd_equals_whole(world):
    got = _case(world, "gspmd_wfr")
    whole = wfr.solve_potential(_t(UNBAL[0]), _t(UNBAL[1]), 4,
                                **WFR_GSPMD_KW)
    _close(got["phi"], whole.phi)
    _close(got["mu"][3], whole.mu[3])


def test_wfr_gspmd_cg_pallas_equals_whole_and_jax(world, mesh4):
    kw = _gspmd_kw("cg-pallas", WFR_GSPMD_KW)
    whole = wfr.solve_potential(_t(UNBAL[0]), _t(UNBAL[1]), 4,
                                ops=foto.stepA_ops("cg-pallas"), **kw)
    want = jax_gspmd.solve_wfr_sharded(
        jnp.asarray(UNBAL[0]), jnp.asarray(UNBAL[1]), 4, mesh4,
        ops=jax_foto.stepA_ops("cg-pallas"), **kw)
    _assert_cg_pallas(world, "gspmd_wfr_cg-pallas", whole, want)


@pytest.mark.parametrize("mesh", ["1x4", "4x1"])
def test_foto_gspmd_cg_pallas_on_strips_equals_whole(world, mesh):
    """Tiles one tile wide along one axis: two global edges on every
    tile, lines on the other axis only."""
    whole = foto.solve_potential(_t(SQ[0]), _t(SQ[1]), 4,
                                 ops=foto.stepA_ops("cg-pallas"),
                                 **_gspmd_kw("cg-pallas"))
    name = f"gspmd_foto_cg-pallas_{mesh}"
    got = _case(world, name)
    _assert_state(got, whole)
    assert abs(int(got["cg_iterations"]) - int(whole.cg_iterations)) <= 2


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_edge_lines_match_halo_shifts(world, mesh):
    """``halo.edge_lines``' four lines are bitwise the lines the halo
    shifts bring in at the tile's edges, each the neighbour's edge line of
    the whole field, and None exactly on the global edges."""
    got = _case(world, f"edge_lines_{mesh}")
    py, px = MESHES[mesh]["y"], MESHES[mesh]["x"]
    ty, tx = PHI.shape[1] // py, PHI.shape[2] // px
    iy, ix = np.arange(py), np.arange(px)
    want = {
        "up": (PHI[:, np.maximum(iy * ty - 1, 0), :], iy == 0, 1),
        "down": (PHI[:, np.minimum((iy + 1) * ty, PHI.shape[1] - 1), :],
                 iy == py - 1, 1),
        "left": (PHI[:, :, np.maximum(ix * tx - 1, 0)], ix == 0, 2),
        "right": (PHI[:, :, np.minimum((ix + 1) * tx, PHI.shape[2] - 1)],
                  ix == px - 1, 2)}
    for side, (lines, edge, axis) in want.items():
        np.testing.assert_array_equal(got[side], got[f"{side}_shift"])
        none = np.broadcast_to(edge[:, None] if axis == 1 else edge[None],
                               (py, px))
        np.testing.assert_array_equal(got[f"{side}_none"], none)
        mask = edge[None, :, None] if axis == 1 else edge[None, None, :]
        np.testing.assert_array_equal(got[side], np.where(mask, 0.0, lines))


def test_gn_gspmd_equals_whole(world):
    got = _case(world, "gspmd_gn")
    whole = gn.solve_fields(_t(BLOB[0]), _t(BLOB[1]))
    want = jax_gn.solve_fields(jnp.asarray(BLOB[0]), jnp.asarray(BLOB[1]))
    for ref in (whole.u, want.u):
        _close(got["u"], ref)
    _close(got["m"], whole.m)


# -------------------------------------------------------------- data sweeps

def test_data_sharded_sweep(world):
    """The batch split over ``data`` = 4: each pair its one-process
    lockstep result, and its single solve's (the port's and JAX's)."""
    from ofot_tpu_torch.parallel import sweep
    got = _case(world, "foto_batch")
    one = sweep.solve_foto_batch(D4[0], D4[1], 4, device="cpu", **DATA_KW)
    _close(got["phi"], one.phi, atol=1e-12)
    single = foto.solve_potential(_t(D4[0][2]), _t(D4[1][2]), 4, **DATA_KW)
    _close(got["phi"][2], single.phi)
    want = jax_foto.solve_potential(jnp.asarray(D4[0][2]),
                                    jnp.asarray(D4[1][2]), 4, **DATA_KW)
    _close(got["phi"][2], want.phi)
    assert got["iteration"].tolist() == [4] * 4


def test_gn_batch_over_data(world):
    got = _case(world, "gn_batch")
    for i in range(4):
        single = gn.solve_fields(_t(BATCH[0][i]), _t(BATCH[1][i]))
        _close(got["u"][i], single.u)
        _close(got["m"][i], single.m)


@pytest.mark.parametrize("algo", ["foto", "GN"])
@pytest.mark.parametrize("mode", ["map", "vmap"])
def test_solve_batch_full_over_data_equals_one_process(world, algo, mode):
    from ofot_tpu_torch.parallel import sweep
    got = _case(world, f"full_{algo}_{mode}")
    u, v, m, diag = sweep.solve_batch_full(algo, BATCH[0], BATCH[1], None,
                                           foto_params=BATCH_FOTO,
                                           batch_mode=mode, device="cpu")
    # each rank solves its block on its own: map mode is bitwise the
    # one-process batch; a lockstep block is bitwise it too (each pair
    # keeps its own arithmetic)
    for k, want in (("u", u), ("v", v), ("m", m)):
        np.testing.assert_array_equal(got[k], want.numpy())
    assert got["diag"].keys() == diag.keys()
    for k in diag:
        np.testing.assert_array_equal(got["diag"][k], diag[k])


def test_sweep_heterogeneous(world):
    """Groups padded to a multiple of ``data`` = 2 (ranks 2 and 3 are
    outside the mesh); the duplicates dropped."""
    got = _case(world, "sweep")
    assert set(got) == {"a", "b", "c"}
    assert got["a"]["phi"].shape == (4, 18, 18)
    assert got["b"]["phi"].shape == (4, 12, 16)
    assert world[2]["sweep"] is None and world[3]["sweep"] is None
    kw = dict(SWEEP_KW, max_it=3)
    for key, f1, f2 in HETERO:
        _close(got[key]["phi"], foto.solve_potential(_t(f1), _t(f2), 4,
                                                     **kw).phi)


# --------------------------------------------------------- the local world

def test_a_failing_rank_fails_the_world():
    with pytest.raises(launch.WorldError, match=r"rank1 \(exit 1\)"):
        launch.run(operator.truediv, 2, 1.0, 0.0, seconds=60)


def test_a_hanging_rank_fails_the_world():
    with pytest.raises(launch.WorldError, match="rank1 timed out"):
        launch.run(time.sleep, 2, 600, seconds=8)


def test_run_cases_runs_on_the_card_unless_asked(monkeypatch):
    """The ranks' entry point asks for ``cuda`` by default (``make_mesh``
    then refuses a machine without a card), and the CPU only when told."""
    asked = []

    def fake_mesh(shape, platform):
        asked.append(platform)
        return type("OutsideMesh", (), {"coord": None})()

    monkeypatch.setattr(cases, "make_mesh", fake_mesh)
    case = [("x", {"data": 1}, "digest", {})]
    assert cases.run_cases(case)["x"] is None
    assert cases.run_cases(case, "cpu")["x"] is None
    assert asked == ["cuda", "cpu"]
