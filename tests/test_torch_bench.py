"""The port's bench (``python -m ofot_tpu_torch.bench``) on the CPU at a
small shape: one JSON line last with the JAX bench's keys (``bench.py:
212-219`` and the family keys, or ``gn_solve_seconds_{nx}x{ny}``), value
= Nt*Ny*Nx*iters*B / wall, and the timed loop's arithmetic against three
steps of the JAX package's ``alg2_iteration`` with its ``dct`` set on the
JAX bench's pair (float64, rtol 1e-9)."""

import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jax_bench
from ofot_tpu.solvers import foto as jax_foto
from ofot_tpu_torch import bench
from ofot_tpu_torch.solvers import foto

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--platform", "cpu", "--ny", "12", "--nx", "16", "--Nt", "4",
         "--iters", "3", "--repeats", "1"]
KEYS = {"metric", "value", "unit", "vs_baseline",
        "device_ms_per_iter_marginal", "wall_ms_per_iter"}
FAMILIES = {"gn_ms_device", "wfr_ms_per_iter_device",
            "sinkhorn_us_per_iter_device"}


def _last_json(text):
    lines = text.strip().splitlines()
    return json.loads(lines[-1])


def _check_foto_line(out, batch=1, families=True):
    assert KEYS <= out.keys()
    assert (FAMILIES <= out.keys()) is families
    assert "families_error" not in out
    assert out["metric"] == "foto_alg2_gridpoint_iters_per_s"
    assert out["unit"] == "grid-point-iterations/s"
    assert out["device"] == "cpu" and out["batch"] == batch
    wall = out["wall_ms_per_iter"] * 3 / 1e3
    assert out["value"] == pytest.approx(4 * 12 * 16 * 3 * batch / wall,
                                         rel=1e-3)
    assert out["vs_baseline"] == pytest.approx(
        out["value"] / jax_bench.BASELINE_PTS_PER_S, abs=0.01)
    for k in KEYS | (FAMILIES if families else set()):
        if k not in ("metric", "unit"):
            assert np.isfinite(out[k]), k


def test_bench_module_prints_one_json_line():
    proc = subprocess.run([sys.executable, "-m", "ofot_tpu_torch.bench",
                           *SMALL], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert len(proc.stdout.strip().splitlines()) == 1
    out = _last_json(proc.stdout)
    _check_foto_line(out)
    # 3 iterations, first call + 1 repeat; 15, first call + 2 repeats;
    # the WFR family's 2 and 10 iterations, first call + 3 repeats each
    assert out["alg2_iterations"] == 3 * 2 + 15 * 3 + (2 + 10) * 4


@pytest.mark.parametrize("extra,batch,families", [
    (["--no-families"], 1, False),
    (["--batch", "2", "--no-families", "--ops", "dct"], 2, False),
    (["--ops", "pallas", "--no-families", "--with-cg"], 1, False)])
def test_bench_variants(capsys, extra, batch, families):
    assert bench.main(SMALL + extra) == 0
    out = _last_json(capsys.readouterr().out)
    _check_foto_line(out, batch, families)


def test_bench_gn(capsys):
    assert bench.main(SMALL + ["--algo", "GN"]) == 0
    out = _last_json(capsys.readouterr().out)
    assert out["metric"] == "gn_solve_seconds_16x12"
    assert out["unit"] == "s" and out["vs_baseline"] is None
    assert out["value"] > 0 and out["cg_iterations"] > 0


def test_no_card_raises_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="--platform=cpu"):
        bench.main(SMALL[2:])


def test_timed_loop_matches_jax_alg2_iterations():
    """The bench's pair is the JAX bench's, and three of its fixed
    iterations give the criterion of three JAX ``alg2_iteration`` steps
    (``dct`` set, convergence_tol 0) at float64."""
    for dtype in (np.float32, np.float64):
        for a, b in zip(bench.blob_pair(12, 16, dtype),
                        jax_bench.blob_pair(12, 16, dtype)):
            np.testing.assert_array_equal(a, b)
    f1, f2 = bench.normalized_pair(12, 16, np.float64)
    b = bench.Bench(bench.parse_args(SMALL + ["--ops", "dct"]))
    b.rho0, b.rhoT = torch.as_tensor(f1), torch.as_tensor(f2)
    crit, inner = b.make_run(foto.stepA_ops("dct"), 3)()

    r0, rT = jnp.asarray(f1), jnp.asarray(f2)
    st = jax_foto.init_state(r0, rT, 4)
    for _ in range(3):
        st = jax_foto.alg2_iteration(st, r0, rT, r=1.0, reg_epsilon=1e-2,
                                     convergence_tol=0.0, cg_rtol=1e-6,
                                     cg_maxiter=1000,
                                     ops=jax_foto.stepA_ops("dct"))
    np.testing.assert_allclose(float(crit), float(st.crit), rtol=1e-9)
    assert int(inner) == int(st.cg_iterations) == 3


@pytest.mark.parametrize("ops", ["pallas", "dct"])
def test_device_and_host_loops_give_the_same_bench_line(capsys, ops):
    """``--loop device`` (blocks of K iterations, no select) and ``--loop
    host`` run the same iterations: the same criterion and CG count, and
    the line names its loop."""
    outs = {}
    for loop in ("device", "host"):
        assert bench.main(SMALL + ["--ops", ops, "--no-families",
                                   "--loop", loop]) == 0
        outs[loop] = _last_json(capsys.readouterr().out)
        _check_foto_line(outs[loop], 1, False)
        assert outs[loop]["loop"] == loop
    for k in ("crit", "cg_iterations", "alg2_iterations"):
        assert outs["device"][k] == outs["host"][k], k
