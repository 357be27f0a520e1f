"""Build and load the port's CUDA kernels (frave_tpu_torch/csrc/*.cu).

The sources have a plain C interface, so they compile with nvcc alone —
no PyTorch headers — into one shared library that ctypes loads:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o frave_tpu_torch/_build/libfrave_kernels_<key>.so
         frave_tpu_torch/csrc/*.cu

The build runs on first use (a few seconds), never at import. Its output
goes to ``frave_tpu_torch/_build/``, named by a hash of the sources and
flags, so an edited source rebuilds and an unchanged one loads the cached
library. Every pointer and the stream cross as ``c_void_p``; each C entry
point returns ``cudaGetLastError()`` after its launch, and the wrappers
raise on a nonzero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry point -> argument types (all return int: a cudaError_t, the
# launches cudaGetLastError())
_SIGNATURES = {
    "frave_fwd_lift_quant": [_P, _P, _I, _P, _P, _I, _I, _P],
    "frave_inv_lift": [_P, _P, _P, _I, _P, _P, _I, _I, _P],
    "frave_rans_encode": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "frave_rans_decode_wave": [_P] * 11 + [_I] * 5 + [_P],
    "frave_rans_decode_states_fit": [_I, _I, _I, ctypes.POINTER(_I)],
}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the build (None: loaded from cache)


def _sources():
    return sorted(SRC_DIR.glob("*.cu"))


def _cache_key(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raises on failure."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        sources = _sources()
        if not sources:
            raise RuntimeError(f"no CUDA sources under {SRC_DIR}")
        out = BUILD_DIR / f"libfrave_kernels_{_cache_key(sources)}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    "nvcc failed:\n" + " ".join(cmd) + "\n" + proc.stderr
                )
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(out))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check(code: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code}")


def current_stream(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
