"""The port's ``torch.distributed.checkpoint`` pair (``save_state_dcp`` /
``load_state_dcp``), counterpart of tests/test_checkpoint.py's two Orbax
cases: a round trip in one process whose restored state resumes the solve
exactly as the original does (atol 1e-12, the JAX test's), and a state
saved by 4 gloo ranks, each writing its own (y, x) tiles, restored onto
the 2x2 mesh and whole in this process, bitwise.  The JAX package's Orbax
directories and these are not compared: this sandbox has no ``orbax``;
the .npz pair stays the format both packages read.
"""

import numpy as np
import torch

from ofot_tpu_torch.parallel import cases, launch
from ofot_tpu_torch.solvers import foto
from ofot_tpu_torch.utils import checkpoint

import fixtures

KW = dict(convergence_tol=0.0, reg_epsilon=1e-2)


def _frames(dtype=torch.float32):
    f1, f2 = fixtures.translating_square(16)
    return torch.as_tensor(f1, dtype=dtype), torch.as_tensor(f2, dtype=dtype)


def _assert_states_equal(a, b):
    for k in ("mu", "q", "phi", "crit", "prev_crit", "done"):
        np.testing.assert_array_equal(np.asarray(getattr(a, k)),
                                      np.asarray(getattr(b, k)), err_msg=k)
    assert int(a.iteration) == int(b.iteration)
    assert int(a.cg_iterations) == int(b.cg_iterations)


def test_dcp_roundtrip(tmp_path):
    f1, f2 = _frames()
    state = foto.solve_potential(f1, f2, 4, max_it=4,
                                 ops=foto.stepA_ops("dct"), **KW)
    checkpoint.save_state_dcp(str(tmp_path / "dcp"), state)
    back = checkpoint.load_state_dcp(str(tmp_path / "dcp"), "cpu")
    _assert_states_equal(state, back)
    # the restored state resumes the solve exactly like the original
    a, b = (foto.solve_potential(f1, f2, 4, max_it=8,
                                 ops=foto.stepA_ops("dct"), init=s, **KW)
            for s in (state, back))
    np.testing.assert_allclose(a.phi.numpy(), b.phi.numpy(), atol=1e-12)


def test_dcp_restore_of_a_state_saved_by_4_ranks(tmp_path):
    f1, f2 = fixtures.translating_square(16)
    path = str(tmp_path / "dcp_tiles")
    world = launch.run(cases.run_cases, 4, [
        ("ckpt", {"y": 2, "x": 2}, "checkpoint",
         dict(path=path, f1=f1, f2=f2, Nt=4, max_it=3, **KW))], "cpu",
        seconds=120)
    saved, restored = world[0]["ckpt"]["saved"], world[0]["ckpt"]["restored"]
    for k in saved:
        np.testing.assert_array_equal(restored[k], saved[k], err_msg=k)
    # the other ranks return digests: the same state, restored the same
    for r in world[1:]:
        assert r["ckpt"] == cases.digest(world[0]["ckpt"])
    # whole, in this process, from the 4 ranks' files
    back = checkpoint.load_state_dcp(path, "cpu")
    saved = world[0]["ckpt"]["saved"]
    for k in ("mu", "q", "phi", "crit", "done"):
        np.testing.assert_array_equal(getattr(back, k).numpy(), saved[k])
    assert back.iteration == int(saved["iteration"]) == 3
    assert back.cg_iterations == int(saved["cg_iterations"])
