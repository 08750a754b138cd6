"""Build ``cse_tpu_torch/csrc`` into a shared library and load it with ctypes.

The sources have a plain C interface (no PyTorch headers), so ``nvcc``
builds them in seconds: one ``nvcc -c`` per source, all started together,
then one link. The library is built for ``sm_90a`` (Hopper) on first use
into ``cse_tpu_torch/_build/`` (listed in ``.gitignore``), under a name that
hashes the sources and flags, so an edited source is rebuilt. A failed build
raises.
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
SOURCES = ("fused_stack.cu", "fused_train.cu", "attention.cu", "fused_stack_w8a8.cu", "kernel_parts.cu", "mla.cu")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")
NVCC_FLAGS = (*COMPILE_FLAGS, "-shared")

P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry points of csrc/*.cu: name -> argtypes (all return the launch's
# cudaError_t as int; 0 means the kernels were launched)
SIGNATURES = {
    # fused_stack.cu
    "cse_layer_norm": (P, P, P, P, I, LL, I, F, P),
    "cse_linear": (P, P, P, P, I, I, LL, I, I, P),
    "cse_attention": (P, P, I, I, I, I, I, F, P, P),
    "cse_attention_info": (I, I, I, P),
    "cse_linear_relu_grad": (P, P, P, P, P, P, P, I, LL, I, I, P),
    # fused_train.cu
    "cse_weight_grad": (P, P, P, P, I, LL, I, I, I, I, P),
    "cse_layer_norm_bwd": (P, P, P, P, P, P, P, P, I, I, LL, I, F, I, P),
    "cse_layer_norm_bwd_info": (I, I, I, I, P),
    "cse_attention_bwd": (P, P, P, P, P, P, P, I, I, I, I, I, F, P),
    "cse_attention_bwd_info": (I, I, P),
    # attention.cu
    "cse_flash_fwd": (P, P, P, P, P, I, I, I, I, F, P),
    "cse_flash_fwd_info": (I, I, P),
    "cse_flash_bwd": (P, P, P, P, P, P, P, P, P, P, I, I, I, I, F, P),
    "cse_flash_bwd_info": (I, I, P),
    # fused_stack_w8a8.cu
    "cse_quantize_rows": (P, P, P, LL, I, P),
    "cse_linear_w8a8": (P, P, P, P, P, P, I, LL, I, I, P),
    "cse_layer_norm_quant": (P, P, P, P, P, LL, I, F, P),
    "cse_ffn_w8a8": (P, P, P, P, P, P, P, P, P, LL, I, I, P),
    "cse_w8a8_kernel_info": (I, P),
    # kernel_parts.cu
    "cse_kp_layer_norm": (P, P, I, P, I, I, LL, I, F, P),
    "cse_kp_layer_norm_info": (I, I, I, P),
    "cse_kp_attention": (P, P, I, P, I, I, I, I, I, I, F, P),
    "cse_kp_attention_info": (I, I, I, P),
    # mla.cu
    "cse_mla_prefill": (P, P, P, P, P, I, I, I, I, I, I, F, P),
    "cse_mla_prefill_info": (I, I, I, P),
}


# what an attention launcher's *_info entry point writes, in order
INFO_KEYS = ("key_blocks", "threads", "rows_per_block", "smem_bytes", "registers", "local_bytes", "blocks_per_sm")


def query(entry: str, keys: tuple[str, ...], *args) -> dict:
    """Call the ``cse_*_info`` entry point ``entry`` with ``args`` and the
    output array last; name its ``len(keys)`` ints. Raises if it fails."""
    out = (ctypes.c_int * len(keys))()
    err = getattr(library(), entry)(*args, out)
    if err != 0:
        raise RuntimeError(f"cse_tpu_torch: {entry}{args} failed (cudaError {err})")
    return dict(zip(keys, out))


def launch_info(entry: str, *args) -> dict:
    """The launch an attention ``cse_*_info`` entry point describes: key
    blocks held in registers, threads, query rows and dynamic shared bytes a
    block, and the kernel's registers and local-memory bytes a thread and
    resident blocks per SM (``cudaFuncGetAttributes``,
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``). ``route`` is "strip"
    (the scores of a strip in registers, L <= 256) or "passes"."""
    info = query(entry, INFO_KEYS, *args)
    info["route"] = "strip" if info["key_blocks"] else "passes"
    return info


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
    tmpdir = tempfile.mkdtemp(dir=BUILD_DIR)
    nvcc, procs = _nvcc(), []
    objs = [os.path.join(tmpdir, src + ".o") for src in SOURCES]
    try:
        for src, obj in zip(SOURCES, objs):
            cmd = [nvcc, *COMPILE_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-c",
                   "-o", obj, str(CSRC / src)]
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
        for cmd, proc in procs:
            _finish(cmd, proc.communicate()[0], proc.returncode, verbose)
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", os.path.join(tmpdir, out.name), *objs]
        res = subprocess.run(link, capture_output=True, text=True)
        _finish(link, res.stdout + res.stderr, res.returncode, False)
        os.replace(os.path.join(tmpdir, out.name), out)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmpdir, ignore_errors=True)
    return out


def _finish(cmd, output: str, returncode: int, verbose: bool):
    if returncode != 0:
        raise RuntimeError(f"cse_tpu_torch: kernel build failed ({' '.join(cmd)}):\n{output}")
    if verbose:
        print(output, flush=True)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
