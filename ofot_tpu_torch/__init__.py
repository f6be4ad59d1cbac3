"""ofot_tpu_torch — the PyTorch/CUDA port of ofot_tpu.

Same layout and names as ``ofot_tpu``, one module for each counterpart
there; plain torch functions on tensors with an explicit device and dtype.
Every TPU kernel on the port's path is a hand-written CUDA kernel under
``csrc/``, built with nvcc at first use and bound with ctypes
(``ops/kernels/_build.py``); each has a plain torch version beside it,
which runs for CPU tensors.  The port imports neither JAX nor ``ofot_tpu``.
"""

__version__ = "0.1.0"
