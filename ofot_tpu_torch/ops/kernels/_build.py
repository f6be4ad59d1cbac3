"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source has a plain C interface and includes no PyTorch
header, so one ``nvcc`` call compiles them all into one shared library in
seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o ofot_tpu_torch/_build/libofot_kernels.so \\
         ofot_tpu_torch/csrc/*.cu

The library is built at first use (and again when a source is newer than
it) into ``ofot_tpu_torch/_build/``, which git ignores, and loaded with
``ctypes``.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
SRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
LIB_NAME = "libofot_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
BUILD_TIMEOUT_S = 300


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME/bin or in "
                       "/usr/local/cuda/bin: the CUDA kernels cannot be "
                       "built")


def sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def library_path() -> Path:
    return BUILD_DIR / LIB_NAME


def is_stale() -> bool:
    lib = library_path()
    return (not lib.exists() or lib.stat().st_mtime
            < max(s.stat().st_mtime for s in sources()))


def build(extra_flags=()) -> str:
    """Compile every source into the shared library; returns nvcc's
    diagnostics (e.g. ptxas' register report with ``-Xptxas -v``).
    Raises RuntimeError with nvcc's stderr when the build fails."""
    BUILD_DIR.mkdir(exist_ok=True)
    # build under a private name, then rename: a concurrent loader never
    # sees a half-written library
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp),
           *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=BUILD_TIMEOUT_S)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, library_path())
    return proc.stdout + proc.stderr


@functools.cache
def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built first if missing or stale."""
    if is_stale():
        build()
    lib = ctypes.CDLL(str(library_path()))
    vp, c_int = ctypes.c_void_p, ctypes.c_int
    lib.ofot_fused_pointwise.argtypes = [
        vp, vp, vp, vp, vp, vp, vp,           # gphi mu qprev q mu' parts sums
        c_int, ctypes.c_longlong, c_int,      # ncomp, L, nblocks
        ctypes.c_float, ctypes.c_float, vp]   # r, alpha, stream
    lib.ofot_fused_pointwise.restype = c_int
    lib.ofot_fused_pointwise_threads.argtypes = []
    lib.ofot_fused_pointwise_threads.restype = c_int
    lib.ofot_cuda_error_string.argtypes = [c_int]
    lib.ofot_cuda_error_string.restype = ctypes.c_char_p
    return lib
