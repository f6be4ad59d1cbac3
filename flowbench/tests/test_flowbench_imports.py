"""No file the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the program; the check of a run's
loaded modules compares whole top-level names."""

import ast
from pathlib import Path

from flowbench import harness

BENCH = harness.HERE
FORBIDDEN = {"jax", "jaxlib", "flax", "ofot_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", None))
                == "import_module" and node.args
                and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def _top(name: str) -> str:
    return name.split(".", 1)[0]


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    files = list(BENCH.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        bad = {_top(n) for n in _imports(path)} & FORBIDDEN
        assert not bad, f"{path} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        tops = {_top(n) for n in _imports(path)}
        assert not tops & (FORBIDDEN | {"ofot_tpu_torch"}), path
        assert tops <= {"__future__", "math", "typing", "numpy", "torch",
                        "flowbench"}, (path, tops)
        for name in _imports(path):
            if _top(name) == "flowbench":
                assert name.startswith("flowbench.reference"), (path, name)


def test_the_check_of_loaded_modules_compares_whole_top_level_names():
    assert harness.forbidden(["ofot_tpu_torch", "ofot_tpu_torch.solvers",
                              "jaxtyping", "flaxen", "numpy"]) == []
    assert harness.forbidden(["jax.numpy"]) == ["jax"]
    assert harness.forbidden(["ofot_tpu.cli.main", "ofot_tpu_torch"]) == [
        "ofot_tpu"]
    assert set(harness.forbidden(["jaxlib", "flax.linen", "ofot_tpu"])) == {
        "jaxlib", "flax", "ofot_tpu"}


def test_the_import_scan_sees_a_forbidden_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import ofot_tpu.cli\nfrom jax import numpy\n"
                 "import ofot_tpu_torch\n")
    assert {_top(n) for n in _imports(f)} & FORBIDDEN == {"ofot_tpu", "jax"}
