"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source has a plain C interface and includes no PyTorch
header (they share device code through ``csrc/*.cuh`` headers), so plain
``nvcc`` builds them in seconds: one compile per source, all started
together, then one link into a shared library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -c -o <source>.o ofot_tpu_torch/csrc/<source>.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o ofot_tpu_torch/_build/libofot_kernels.so *.o

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


def _run_all(cmds) -> str:
    """Start every command at once, wait for all; returns their output.
    Raises RuntimeError with nvcc's stderr when one fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    try:
        outs = [p.communicate(timeout=BUILD_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:         # a timeout leaves no compiler running
            if p.poll() is None:
                p.kill()
                p.wait()
    for cmd, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed with exit code {p.returncode}:"
                               f"\n{' '.join(cmd)}\n{err}")
    return "".join(out + err for out, err in outs)


def build(extra_flags=()) -> str:
    """Compile every source (one ``nvcc`` each, in parallel) and link the
    shared library; returns nvcc's diagnostics (e.g. ptxas' register
    report with ``-Xptxas -v``).  Raises RuntimeError with nvcc's stderr
    when the build fails."""
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc, pid = find_nvcc(), os.getpid()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    # objects and library under private names, then rename: a concurrent
    # loader never sees a half-written library
    objs = [BUILD_DIR / f"{s.stem}.{pid}.o" for s in sources()]
    tmp = BUILD_DIR / f"{LIB_NAME}.{pid}.tmp"
    try:
        report = _run_all([[nvcc, *compile_flags, *extra_flags, "-c", "-o",
                            str(o), str(s)]
                           for s, o in zip(sources(), objs)])
        report += _run_all([[nvcc, *NVCC_FLAGS, "-o", str(tmp),
                             *map(str, objs)]])
        os.replace(tmp, library_path())
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
    return report


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
            c_int, c_ll, c_int, c_int,        # ncomp, L, nblocks, batch
            c_float, vp, c_float, vp],        # r, r_pairs, alpha, stream
        "ofot_fused_pointwise_threads": [],
        "ofot_project_paraboloid": [
            vp, vp, c_int, c_ll, vp],         # p out ncomp L stream
        "ofot_cg_operator": [
            vp, vp, c_int, c_int, c_int, c_int,   # x y batch Nt Ny Nx
            c_float, c_float, vp, vp,         # r r*eps r_pairs reps_pairs
            vp],                              # stream
        "ofot_dct_solve": [
            vp, vp, vp,                       # Fz out tmp
            vp, vp, vp, vp,                   # Cy CyT Cx CxT
            vp, vp, vp,                       # lt ly lx
            c_int, c_int, c_int, c_int,       # batch Nt Ny Nx
            c_float, c_float, vp, vp,         # r r*eps r_pairs reps_pairs
            vp],                              # stream
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


def pair_scalars(r, reg_epsilon, x: torch.Tensor):
    """(r, r*eps) for ``x``: floats, or for a per-pair ``r`` (a (B,)
    tensor) two (B,) tensors in x's dtype, r*eps formed in float64 as a
    single pair's float arithmetic forms it."""
    if not isinstance(r, torch.Tensor) or r.dim() == 0:
        return r, r * reg_epsilon
    if x.dim() != 4 or r.shape != x.shape[:1]:
        raise ValueError(f"a per-pair r of shape {tuple(r.shape)} needs a "
                         f"(B, Nt, Ny, Nx) batch, got {tuple(x.shape)}")
    reps = (r.to(torch.float64) * float(reg_epsilon)).to(x.device, x.dtype)
    return r.to(x.device, x.dtype), reps


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
