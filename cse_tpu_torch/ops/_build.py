"""Build ``cse_tpu_torch/csrc`` into a shared library and load it with ctypes.

The sources have a plain C interface (no PyTorch headers), so ``nvcc``
builds them in seconds. The library is built for ``sm_90a`` (Hopper) on
first use into ``cse_tpu_torch/_build/`` (listed in ``.gitignore``), under a
name that hashes the sources and flags, so an edited source is rebuilt. A
failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("fused_stack.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry points of csrc/fused_stack.cu: name -> argtypes (all return the
# launch's cudaError_t as int; 0 means the kernel was launched)
SIGNATURES = {
    "cse_layer_norm": (P, P, P, P, I, LL, I, F, P),
    "cse_linear": (P, P, P, P, I, I, LL, I, I, P),
    "cse_attention": (P, P, I, I, I, I, I, F, P),
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cand.append(shutil.which("nvcc") or "")
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("cse_tpu_torch: nvcc not found (set CUDA_HOME)")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(p.name for p in CSRC.iterdir()):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libcse_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels if this exact build is not there yet; return the
    library's path. ``verbose`` adds ``-Xptxas -v`` and prints its report
    (registers, shared memory, spills per kernel)."""
    out = library_path()
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, *(str(CSRC / s) for s in SOURCES)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"cse_tpu_torch: kernel build failed ({' '.join(cmd)}):\n"
                f"{res.stdout}\n{res.stderr}"
            )
        if verbose:
            print(res.stdout + res.stderr, flush=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
