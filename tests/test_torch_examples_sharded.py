"""The port's ``sharded_solve`` example against the JAX package's, on the
CPU: the port as a local gloo world of 4 ranks (a 2x2 mesh), JAX over 4
virtual CPU devices (its rule gives the same 2x2 mesh).  The same lines;
the iteration count (the cap, 40) equal and crit within 1e-3 plus one
unit of its last printed digit, the bound the tiled solve keeps against
the whole one in tests/test_torch_parallel.py at float32."""

from test_torch_examples import compare_lines, jax_example, port_example


def test_sharded_solve_matches_jax():
    ours, res = port_example("sharded_solve")
    theirs = jax_example("sharded_solve", env={
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4"})
    compare_lines(ours, theirs, 1e-3, {(1, 0): ("count", 0)})
    assert res["mesh"] == {"y": 2, "x": 2} and res["n_dev"] == 4
    assert res["phi_shape"] == (8, 64, 64)
    assert sum(res["launches"].values()) == 0
