"""The port stands alone: no module of ``ofot_tpu_torch`` nor
``chip_smoke.py`` imports JAX or the JAX package, Pillow is imported only
inside the functions that need it, and the CLI runs on the card unless
told otherwise."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
# the card-side test file runs without JAX too
PORT_FILES = sorted((ROOT / "ofot_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_kernels_cuda.py"]


def _imports(tree):
    """(module name, is top level) of every import in a module."""
    top = set(map(id, tree.body))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, id(node) in top
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or "", id(node) in top


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name, top in _imports(tree):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "ofot_tpu"), (path, name)
        assert not (root == "PIL" and top), (path, name)


def test_importing_the_port_pulls_in_neither_jax_nor_pil():
    # only what the import adds counts: an interpreter set-up hook may
    # have imported something before the port
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import ofot_tpu_torch.cli.main\n"
        "import ofot_tpu_torch.solvers.foto, ofot_tpu_torch.utils.image\n"
        "import ofot_tpu_torch.utils.checkpoint, ofot_tpu_torch.utils.warp\n"
        "import ofot_tpu_torch.ops.kernels.fused_pointwise\n"
        "import ofot_tpu_torch.ops.kernels.dct_solve\n"
        "import ofot_tpu_torch.ops.kernels.cg_operator\n"
        "import ofot_tpu_torch.ops.kernels.projection\n"
        "import ofot_tpu_torch.solvers.wfr\n"
        "import ofot_tpu_torch.solvers.dct, ofot_tpu_torch.solvers.gn\n"
        "import ofot_tpu_torch.solvers.hs, ofot_tpu_torch.solvers.pyramid\n"
        "import ofot_tpu_torch.solvers.sinkhorn\n"
        "import ofot_tpu_torch.solvers.otgrad\n"
        "import ofot_tpu_torch.solvers.implicit\n"
        "import ofot_tpu_torch.solvers.lockstep\n"
        "import ofot_tpu_torch.utils.trace\n"
        "import ofot_tpu_torch.utils.colorwheel\n"
        "import ofot_tpu_torch.cli.pipeline, ofot_tpu_torch.cli.data_diff\n"
        "import ofot_tpu_torch.cli.create_lum_dataset\n"
        "import ofot_tpu_torch.cli.normalize_image\n"
        "import ofot_tpu_torch.cli.print_operators, ofot_tpu_torch.compat\n"
        "import ofot_tpu_torch.parallel.sweep\n"
        "import ofot_tpu_torch.parallel.multihost\n"
        "bad = sorted(m for m in set(sys.modules) - before\n"
        "             if m.split('.')[0] in ('jax', 'ofot_tpu', 'PIL'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cli_raises_without_a_card_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default platform works")
    from ofot_tpu_torch.cli import main as cli
    from ofot_tpu_torch.utils import image
    import numpy as np
    f = np.full((6, 7), 0.5)
    image.save_grayscale(f, str(tmp_path / "a.pgm"))
    argv = [str(tmp_path / "a.pgm"), str(tmp_path / "a.pgm"), "--algo=foto",
            "--Nt=3", "--max-it=1", "--quiet", "--stepA-solver=dct"]
    with pytest.raises(RuntimeError, match="--platform=cpu"):
        cli.main(argv)
    assert cli.main(argv + ["--platform=cpu"]) == 0


def test_chip_smoke_refuses_to_run_without_a_card():
    """chip_smoke.py exits non-zero, with no result line, on a machine
    without CUDA."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
