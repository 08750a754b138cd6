"""ctypes bindings for the native audio runtime (``audio_io.cc``).

The port's copy of ``cse_tpu/native/audio_native.py``. The shared library is
built with ``g++`` on first use into ``cse_tpu_torch/_build/`` (listed in
``.gitignore``; nothing is written beside the source), and rebuilt when the
source or this loader is newer than it. Every entry point is mirrored by the
pure Python reader in :mod:`cse_tpu_torch.data.audio_io`: the native path is
an accelerator, never a requirement, and a failed build leaves the callers
on the Python reader.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCE = os.path.join(_DIR, "audio_io.cc")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libcse_audio.so")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")
_LIB = None  # the loaded library; False once a build has failed in this process


def _build() -> bool:
    """g++ into a temporary name, then an atomic rename: processes that build
    at once never load a half-written library."""
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix="libcse_audio.", suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, _SOURCE, "-lpthread"], check=True,
                           capture_output=True, timeout=120)
            os.replace(tmp, LIB_PATH)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        print(f"[cse_tpu_torch.native] build failed: {e}", file=sys.stderr)
        return False


def _stale() -> bool:
    """True when the source or this loader is newer than the built library:
    ctypes checks no signature, so a stale library would keep an old C ABI."""
    try:
        so = os.path.getmtime(LIB_PATH)
        return any(os.path.getmtime(f) > so for f in (_SOURCE, os.path.abspath(__file__)))
    except OSError:
        return True


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB or None
    if (not os.path.exists(LIB_PATH) or _stale()) and not _build():
        _LIB = False
        return None
    try:
        lib = ctypes.CDLL(LIB_PATH)
    except OSError as e:
        print(f"[cse_tpu_torch.native] load failed: {e}", file=sys.stderr)
        _LIB = False
        return None
    lib.cse_read_wav.restype = ctypes.c_int64
    lib.cse_read_wav.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.cse_wav_info.restype = ctypes.c_int64
    lib.cse_wav_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32)]
    lib.cse_batch_load.restype = ctypes.c_int32
    lib.cse_batch_load.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_float, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.cse_batch_load_ptrs.restype = ctypes.c_int32
    lib.cse_batch_load_ptrs.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_float, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.cse_write_wav.restype = ctypes.c_int32
    lib.cse_write_wav.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.c_int32,
    ]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def read_wav(path: str):
    """Decode -> (float32 mono, sr); None if the native path can't handle it."""
    lib = _load()
    if lib is None:
        return None
    sr = ctypes.c_int32(0)
    n_total = lib.cse_wav_info(path.encode(), ctypes.byref(sr))
    if n_total < 0:
        return None
    buf = np.empty(max(n_total, 1), np.float32)
    got = lib.cse_read_wav(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        buf.size, ctypes.byref(sr),
    )
    if got <= 0 and n_total > 0:
        return None
    return buf[:got], int(sr.value)


def batch_load(
    paths: list[str], buf: np.ndarray, peak_target: float = 0.9, n_threads: int = 0,
    zero_tail: bool = True,
):
    """Parallel decode into buf [N, T] (C-contig float32).

    Returns (lengths [N] int32, sample_rates [N] int32). Rows that fail decode
    get length 0 (and are fully zeroed). peak_target <= 0 disables
    normalization. ``zero_tail=False`` skips zeroing past each decoded
    length — pass it ONLY for freshly allocated (np.zeros) destinations,
    where the pages past the data are zero-mapped already and touching them
    would dirty memory for nothing; with a reused buffer keep the default.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("cse_tpu_torch.native: the native library is unavailable")
    if buf.dtype != np.float32 or not buf.flags.c_contiguous or buf.ndim != 2 or buf.shape[0] != len(paths):
        raise ValueError(f"need a C-contiguous float32 [{len(paths)}, T] buffer")
    n = len(paths)
    lens = np.zeros(n, np.int32)
    srs = np.zeros(n, np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.cse_batch_load(
        arr, n, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), buf.shape[1],
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        srs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_float(peak_target), n_threads, int(zero_tail),
    )
    return lens, srs


def batch_load_rows(
    paths: list[str], rows: list[np.ndarray], peak_target: float = 0.9,
    n_threads: int = 0, zero_tail: bool = True,
):
    """Scatter form of :func:`batch_load`: file i decodes into ``rows[i]``, a
    1-D C-contiguous float32 view of a common length — so one call (and one
    thread pool spanning ALL files) can fill rows of SEVERAL destination
    arrays (mix/gt/noise...) in a single batch decode. Same length/sr/
    zero_tail semantics as :func:`batch_load`."""
    lib = _load()
    if lib is None:
        raise RuntimeError("cse_tpu_torch.native: the native library is unavailable")
    n = len(paths)
    if n != len(rows):
        raise ValueError(f"{n} paths but {len(rows)} rows")
    width = rows[0].shape[0]
    ptrs = (ctypes.POINTER(ctypes.c_float) * n)()
    for i, r in enumerate(rows):
        if not (r.dtype == np.float32 and r.ndim == 1 and r.shape[0] == width and r.flags.c_contiguous):
            raise ValueError(f"row {i}: need C-contiguous float32 [*{width}]")
        ptrs[i] = r.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    lens = np.zeros(n, np.int32)
    srs = np.zeros(n, np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.cse_batch_load_ptrs(
        arr, n, ptrs, width,
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        srs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_float(peak_target), n_threads, int(zero_tail),
    )
    return lens, srs


def write_wav(path: str, x: np.ndarray, sr: int) -> bool:
    lib = _load()
    if lib is None:
        return False
    x = np.ascontiguousarray(x, np.float32)
    return bool(
        lib.cse_write_wav(
            path.encode(), x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            x.size, sr,
        )
    )
