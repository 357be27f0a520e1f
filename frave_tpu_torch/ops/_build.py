"""Build and load the port's CUDA kernels (frave_tpu_torch/csrc/*.cu, with
the headers they share, csrc/*.cuh).

The sources have a plain C interface, so they compile with nvcc alone —
no PyTorch headers — into one shared library that ctypes loads: one nvcc
per source, all started together,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c -o <source>.o frave_tpu_torch/csrc/<source>.cu

then one link, ``nvcc -shared -o frave_tpu_torch/_build/libfrave_kernels_<key>.so
*.o``. ``ptxas_report`` keeps what ptxas printed per source (registers,
shared memory and spills of every kernel).

The build runs on first use (a few seconds), never at import. Its output
goes to ``frave_tpu_torch/_build/``, named by a hash of the sources, the
headers and the flags, so an edited source or header rebuilds and an
unchanged tree loads the cached library. Every pointer and the stream cross as ``c_void_p``; each C entry
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry point -> argument types (all return int: a cudaError_t, the
# launches cudaGetLastError())
_SIGNATURES = {
    "frave_fwd_lift_pixels": [_P] * 5 + [_L, _L] + [_I] * 4 + [_P],
    "frave_inv_lift_pixels": [_P, _L, _L] + [_P] * 6 + [_L] + [_I] * 3 + [_P],
    "frave_rans_encode": [_P] * 10 + [_I] * 8 + [_P],
    "frave_rans_encode_lanes": [_P] * 10 + [_I] * 9 + [_P],
    "frave_rans_encode_plan": [_I, _I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)],
    "frave_rans_decode_wave": [_P] * 11 + [_I] * 7 + [_P],
    "frave_rans_decode_plan": [_I, _I, _I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)],
    "frave_exchange_loop": [_I, _I, _P, _P],
    "frave_rans_decode_steps": [_P] * 14 + [_I] * 6 + [_L] * 2 + [_I] * 5 + [_P],
    "frave_rans_decode_steps_plan": [_I] * 7 + [ctypes.POINTER(_I)],
    "frave_step_floor_loop": [_I, _P, _P, _P],
    "frave_tp_decode_row": [_P] * 11 + [_I] * 9 + [_P],
    "frave_tp_decode_step": [_P] * 14 + [_I] * 10 + [_L] * 2 + [_I] * 3 + [_P],
    "frave_tp_fits": [_I, _I, _I, _L, ctypes.POINTER(_I)],
    "frave_tp_empty": [_I, _I, _L, _P],
    "frave_wave_contexts": [_P, _L] + [_P] * 6 + [_I] * 13 + [_P],
    "frave_wave_finish": [_P] + [_L] * 4 + [_I] + [_P] * 4 + [_L] + [_I] * 7 + [_P],
    "frave_wave_occupancy": [_I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)],
    "frave_wave_empty": [_I, _I, _I, _P],
    "frave_transform_counts": [_P, _P] + [_I] * 5 + [_P],
    "frave_fit_pass": [_P, _L, _I, _P, _L, _P, _P, _I, _P, _I, _P, _P],
    "frave_fit_solve": [_P, _P] + [_I] * 4 + [_P, _P],
}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the build (None: loaded from cache)
ptxas_report = {}  # source name -> ptxas's output (empty: loaded from cache)


def _sources():
    return sorted(SRC_DIR.glob("*.cu"))


def _headers():
    return sorted(list(SRC_DIR.glob("*.cuh")) + list(SRC_DIR.glob("*.h")))


def _cache_key(sources) -> str:
    """A hash of the flags, the sources and every header beside them (an
    edited header must not load a library built from the old one)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in list(sources) + _headers():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _compile(sources, out: Path) -> None:
    """One nvcc per source, all at once, then the link into `out`."""
    nvcc = _nvcc()
    objdir = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        procs = []
        for src in sources:
            obj = objdir / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            procs.append((src, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed = []
        for src, cmd, proc in procs:
            _, err = proc.communicate()
            ptxas_report[src.name] = err
            if proc.returncode != 0:
                failed.append(" ".join(cmd) + "\n" + err)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = objdir / out.name
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(objdir / (s.stem + ".o")) for s in sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + " ".join(cmd) + "\n" + proc.stderr)
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    finally:
        shutil.rmtree(objdir, ignore_errors=True)


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
            t0 = time.perf_counter()
            _compile(sources, out)
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
