"""ofot_tpu_torch — the PyTorch/CUDA port of ofot_tpu.

Same layout and names as ``ofot_tpu``, one module for each counterpart
there; plain torch functions on tensors with an explicit device and dtype.
Every TPU kernel on the port's path is a hand-written CUDA kernel under
``csrc/``, built with nvcc at first use and bound with ctypes
(``ops/kernels/_build.py``); each has a plain torch version beside it,
which runs for CPU tensors.  The port imports neither JAX nor ``ofot_tpu``.

Importing the package touches no card: it initialises no CUDA context,
builds or loads no kernel library and starts no process group (the
kernels are built at their first launch).  ``examples/`` and ``tools/``
hold the runnable demonstrations (``python -m ofot_tpu_torch.examples.
quickstart --platform cpu``).
"""

__version__ = "0.1.0"

from ofot_tpu_torch import ops, solvers, utils, parallel  # noqa: F401
from ofot_tpu_torch.solvers.foto import solve as solve_foto  # noqa: F401
from ofot_tpu_torch.solvers.gn import solve_fields as solve_gn  # noqa: F401
