"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source has a plain C interface and includes no PyTorch
header (they share device code through ``csrc/*.cuh`` headers), so one
``nvcc`` call compiles them all into one shared library in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o ofot_tpu_torch/_build/libofot_kernels.so \\
         ofot_tpu_torch/csrc/*.cu

The library is built at first use (and again when a source or a header is
newer than it) into ``ofot_tpu_torch/_build/``, which git ignores, and
loaded with ``ctypes``, with argument and result types declared for every
symbol.  The kernel wrappers share the operand checks and the launch-error
check below.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path

import torch

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


def headers() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    return BUILD_DIR / LIB_NAME


def is_stale() -> bool:
    """True when the library is missing or older than a source or header."""
    lib = library_path()
    return (not lib.exists() or lib.stat().st_mtime
            < max(s.stat().st_mtime for s in sources() + headers()))


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
    c_ll, c_float = ctypes.c_longlong, ctypes.c_float
    signatures = {
        "ofot_fused_pointwise": [
            vp, vp, vp, vp, vp, vp, vp,       # gphi mu qprev q mu' parts sums
            c_int, c_ll, c_int,               # ncomp, L, nblocks
            c_float, c_float, vp],            # r, alpha, stream
        "ofot_fused_pointwise_threads": [],
        "ofot_project_paraboloid": [
            vp, vp, c_int, c_ll, vp],         # p out ncomp L stream
        "ofot_cg_operator": [
            vp, vp, c_int, c_int, c_int,      # x y Nt Ny Nx
            c_float, c_float, vp],            # r, r*eps, stream
        "ofot_dct_solve": [
            vp, vp, vp,                       # Fz out tmp
            vp, vp, vp, vp,                   # Cy CyT Cx CxT
            vp, vp, vp,                       # lt ly lx
            c_int, c_int, c_int,              # Nt Ny Nx
            c_float, c_float, vp],            # r, r*eps, stream
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = c_int
    lib.ofot_cuda_error_string.argtypes = [c_int]
    lib.ofot_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_cuda(t: torch.Tensor, what: str) -> None:
    """Raise unless ``t`` is a CUDA tensor (CPU tensors take the plain
    versions before any launch is prepared)."""
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors, got "
                         f"{t.device}")


def check_operand(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    """Raise unless ``t`` is a contiguous float32 tensor with ``like``'s
    device and shape (``like`` is the launch's first operand)."""
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, the first operand on "
                         f"{like.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32 for the CUDA kernel, "
                        f"got {t.dtype}")
    if t.shape != like.shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, the first "
                         f"operand {tuple(like.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of the current CUDA stream on ``t``'s device."""
    with torch.cuda.device(t.device):
        return torch.cuda.current_stream().cuda_stream


def check_launch(lib, err: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: CUDA error {err} "
            f"({lib.ofot_cuda_error_string(err).decode()})")
