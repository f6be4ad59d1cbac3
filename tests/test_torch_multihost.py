"""The port's multi-process scaffolding against the JAX package's:
counterpart of tests/test_multihost.py.

``initialize`` for one process, and two real worker processes
(``python -m ofot_tpu_torch.parallel.multihost_worker --platform cpu``)
meeting at a file rendezvous: a world of 2, a cross-process all-reduce,
a FOTO solve tiled over both ranks whose fingerprint is bitwise equal on
the two and matches this process's whole solve (rel 1e-5, the JAX test's
bound for its one-process solve) and the JAX package's, a distributed
checkpoint round trip that reproduces it exactly, and a host-partitioned
sweep whose manifest shards merge to full coverage.  The workers are
joined under a time limit.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from ofot_tpu.solvers import foto as jax_foto
from ofot_tpu_torch.cli import pipeline
from ofot_tpu_torch.parallel import multihost
from ofot_tpu_torch.parallel.multihost_worker import _smooth_pair
from ofot_tpu_torch.solvers import foto
from ofot_tpu_torch.utils import image

import fixtures

ROOT = Path(__file__).resolve().parents[1]


def test_initialize_single_process():
    assert multihost.initialize() == (0, 1)
    with pytest.raises(ValueError, match="coordinator"):
        multihost.initialize(num_processes=2, process_id=0)


def test_real_two_process_distributed(tmp_path):
    for i in range(3):
        d = tmp_path / "data" / "middlebury-1" / "eval-data-gray" / f"s{i}"
        d.mkdir(parents=True)
        f1, f2 = fixtures.translating_square(18)
        image.save_grayscale(f1, str(d / "frame10.png"))
        image.save_grayscale(f2, str(d / "frame11.png"))

    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    coordinator = (tmp_path / "rendezvous").as_uri()
    outs = [tmp_path / f"host{i}.json" for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ofot_tpu_torch.parallel.multihost_worker",
         "--coordinator", coordinator, "--process-id", str(i),
         "--num-processes", "2", "--platform", "cpu", "--out", str(outs[i]),
         "--data-root", str(tmp_path / "data"),
         "--results", str(tmp_path / "results"),
         "--checkpoint-dir", str(tmp_path / "ckpt")],
        env=env, cwd=tmp_path, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(2)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            logs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("multi-process workers timed out")
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-2000:]

    res = [json.loads(o.read_text()) for o in outs]
    for r in res:
        assert r["process_count"] == 2
        assert r["backend"] == "gloo" and r["device"] == "cpu"
        assert r["psum"] == r["psum_expected"] == 1.0
        assert r["sweep_rc"] == 0
        # the distributed checkpoint round trip reproduces the solve
        assert r["ckpt_phi_l1"] == r["foto_phi_l1"]
        assert r["ckpt_iteration"] == r["foto_iterations"]
    assert [r["process_id"] for r in res] == [0, 1]
    # the two processes computed ONE tiled solve: identical diagnostics
    assert res[0]["foto_crit"] == res[1]["foto_crit"]
    assert res[0]["foto_phi_l1"] == res[1]["foto_phi_l1"]
    assert res[0]["foto_iterations"] == res[1]["foto_iterations"] > 0

    # the tiled solve == this process's whole solve, and JAX's
    rho0, rhoT = _smooth_pair(48, 64)
    st = foto.solve_potential(torch.as_tensor(rho0, dtype=torch.float32),
                              torch.as_tensor(rhoT, dtype=torch.float32),
                              6, max_it=40)
    jst = jax_foto.solve_potential(jnp.asarray(rho0, jnp.float32),
                                   jnp.asarray(rhoT, jnp.float32), 6,
                                   max_it=40)
    for crit, phi in ((float(st.crit), st.phi.abs().sum().item()),
                      (float(jst.crit), float(jnp.sum(jnp.abs(jst.phi))))):
        assert crit == pytest.approx(res[0]["foto_crit"], rel=1e-5)
        assert phi == pytest.approx(res[0]["foto_phi_l1"], rel=1e-5)

    # the two real processes' manifest shards merge to full coverage
    assert pipeline.main(["merge-manifests", "--results",
                          str(tmp_path / "results")]) == 0
    merged = json.loads((tmp_path / "results" / "manifest.json").read_text())
    assert sorted(merged) == ["middlebury-1/s0", "middlebury-1/s1",
                              "middlebury-1/s2"]
    shard_keys = [json.loads((tmp_path / "results" / f"manifest.{i}.json")
                             .read_text()).keys() for i in range(2)]
    assert not (set(shard_keys[0]) & set(shard_keys[1]))
    for v in merged.values():
        assert v["GN"]["status"] == "ok"
