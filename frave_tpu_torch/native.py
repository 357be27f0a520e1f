"""The native host library: ctypes bindings of csrc/ (geometry.cpp,
refbase.cpp, frif.cpp), built with g++ on first use.

The port's counterpart of frave_tpu/native.py, over the same sources
(read, never written): the fractal-geometry builder and the Kahn
layering (``fg_*``), the single-thread C reference-baseline codec
(``rb_*``) and the independent C++ frif codec (``frif_*``, the
``backend="native"`` of the encoder and decoder, and the cross-
implementation oracle of ``chip_smoke.py``).

The build: one ``g++ -O3 -std=c++17 -fPIC -ffp-contract=off -c`` per
source, all started together, with ``-DFG_SRC_SHA`` set to the SHA-256
of geometry.cpp, geometry_core.h, refbase.cpp and frif.cpp concatenated
in that order (csrc/Makefile's flags, less its ``-march=native`` and
warnings), then one ``g++ -shared`` link into
``frave_tpu_torch/_build/libfrave_host_<key>.so``, where the key hashes
the sources, the flags and the compiler's version. Concurrent builders
(processes or threads) serialise on an ``fcntl`` lock in the build
directory; the library is linked under a temporary name and moved into
place with ``os.replace``. A binary that does not carry the sources'
hash is rebuilt, never loaded, and the loaded library's
``fg_source_sha()`` must equal it.

There is no fallback: a failed build or load raises, with g++'s output.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
CSRC = _PKG.parent / "csrc"
BUILD_DIR = _PKG / "_build"
# the order of csrc/Makefile's SRC_SHA (the concatenation is hashed)
SHA_SOURCES = ("geometry.cpp", "geometry_core.h", "refbase.cpp", "frif.cpp")
UNITS = ("geometry.cpp", "refbase.cpp", "frif.cpp")
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-ffp-contract=off")

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_PI = ctypes.POINTER(_I)
# entry point -> (restype, argtypes), as frave_tpu/native.py binds them
_SIGNATURES = {
    "fg_source_sha": (ctypes.c_char_p, []),
    "fg_num_tiles": (_I64, [_I] * 3),
    "fg_layer_waves": (_I, [_I64, _P, _P]),
    "fg_build": (_I, [_I, _I, _I, _I64] + [_P] * 7),
    "rb_encode": (_I, [_I] * 3 + [_P, ctypes.POINTER(_P), ctypes.POINTER(_I64)]),
    "rb_decode": (_I, [_P, _I64, _P]),
    "rb_free": (None, [_P]),
    "rb_use_cache": (None, [_I]),
    "frif_probe": (_I, [_P, _I64, _PI, _PI, _PI]),
    "frif_decode": (_I, [_P, _I64, _P]),
    "frif_encode": (_I, [_I] * 3 + [_P] + [_I] * 4 + [ctypes.POINTER(_P), ctypes.POINTER(_I64)]),
    "frif_free": (None, [_P]),
}
FRIF_MODES = {"parallel": 0, "grid": 2}  # frif_encode's mode numbers

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of this process's build (None: loaded a built library)


def source_sha() -> str:
    """SHA-256 of the sources in csrc/Makefile's order: what the library
    bakes in and fg_source_sha() returns."""
    h = hashlib.sha256()
    for name in SHA_SOURCES:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()


def _compiler_version() -> str:
    proc = subprocess.run([CXX, "--version"], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{CXX} --version failed:\n{proc.stderr}")
    return proc.stdout.splitlines()[0]


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    """Where the library of the current sources, flags and compiler lives."""
    h = hashlib.sha256(source_sha().encode())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_compiler_version().encode())
    return Path(build_dir) / f"libfrave_host_{h.hexdigest()[:16]}.so"


def _compile(out: Path, sha: str) -> None:
    """One g++ per source, all at once, then the link under a temporary
    name, moved to `out`. Raises with g++'s output on failure."""
    objdir = Path(tempfile.mkdtemp(dir=out.parent))
    try:
        flags = [*CXX_FLAGS, f'-DFG_SRC_SHA="{sha}"']
        procs = []
        for unit in UNITS:
            cmd = [CXX, *flags, "-c", "-o", str(objdir / (unit + ".o")), str(CSRC / unit)]
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
        failed = []
        for cmd, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(" ".join(cmd) + "\n" + err)
        if failed:
            raise RuntimeError("g++ failed on the native library:\n" + "\n".join(failed))
        tmp = objdir / out.name
        cmd = [CXX, "-shared", "-o", str(tmp), *(str(objdir / (u + ".o")) for u in UNITS)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("g++ link failed:\n" + " ".join(cmd) + "\n" + proc.stderr)
        os.replace(tmp, out)
    finally:
        shutil.rmtree(objdir, ignore_errors=True)


def load_library(build_dir: Path = BUILD_DIR) -> ctypes.CDLL:
    """Build the library into `build_dir` unless a binary of the current
    sources is there, then load and bind it. The check reads the file for
    the sources' hash before loading it: a process that loaded a stale
    binary could not load its replacement under the same path."""
    global build_seconds
    build_dir = Path(build_dir)
    build_dir.mkdir(parents=True, exist_ok=True)
    sha = source_sha()
    out = library_path(build_dir)
    with open(build_dir / "libfrave_host.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not (out.exists() and sha.encode() in out.read_bytes()):
                t0 = time.perf_counter()
                _compile(out, sha)
                build_seconds = time.perf_counter() - t0
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    lib = ctypes.CDLL(str(out))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    built = lib.fg_source_sha().decode("ascii")
    if built != sha:
        raise RuntimeError(f"{out} reports source sha {built}, the sources are {sha}")
    return lib


def get_lib() -> ctypes.CDLL:
    """The process's native library (built on first use); raises when it
    cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load_library()
        return _lib


def build_geometry_native(height: int, width: int, depth: int):
    """The fractal geometry of (height, width, depth) by the native
    builder: a fractal.geometry.FractalGeometry, every field equal to
    fractal.geometry_fast.build_geometry_fast's."""
    from .fractal import geometry as G

    lib = get_lib()
    T = int(lib.fg_num_tiles(height, width, depth))
    if T < 0:
        raise ValueError(f"native geometry plan failed for {height}x{width}")
    n = 1 << depth
    centers = np.empty((T, 2), dtype=np.int32)
    pixel_gather = np.empty((T, n), dtype=np.int32)
    coef_mask = np.empty((T, n), dtype=np.uint8)
    nbr_idx = np.empty((T * n, 6), dtype=np.int32)
    nbr_par = np.empty((T * n, 6), dtype=np.int32)
    tile_nbr = np.empty((T, 6), dtype=np.int32)
    level_slots_flat = np.empty(T * n, dtype=np.int32)
    rc = lib.fg_build(
        height, width, depth, T, centers.ctypes.data, pixel_gather.ctypes.data,
        coef_mask.ctypes.data, nbr_idx.ctypes.data, nbr_par.ctypes.data,
        tile_nbr.ctypes.data, level_slots_flat.ctypes.data,
    )
    if rc != 0:
        raise RuntimeError(f"native geometry build failed (rc={rc})")
    # level 0 holds T slots, level L >= 1 T * 2^L
    ends = np.cumsum([T] + [T << L for L in range(1, depth)])
    level_slots = [s.copy() for s in np.split(level_slots_flat[: ends[-1]], ends[:-1])]
    level_of_haar = np.zeros(n, dtype=np.int32)
    if n > 1:
        level_of_haar[1:] = np.floor(np.log2(np.arange(1, n))).astype(np.int32)
    return G.FractalGeometry(
        height=height, width=width, depth=depth, num_tiles=T, centers=centers,
        offsets=G.tree_offsets(depth).astype(np.int32), pixel_gather=pixel_gather,
        coef_mask=coef_mask.astype(bool), nbr_idx=nbr_idx, nbr_par=nbr_par,
        level_of_haar=level_of_haar, level_slots=level_slots, tile_nbr=tile_nbr,
    )


def layer_waves_native(deps) -> np.ndarray:
    """Native Kahn longest-path layering of deps [n, 3] (node ids, -1
    absent) -> int32 waves; raises AssertionError on a cycle or an id out
    of range, as the numpy layering does on a cycle."""
    d = np.ascontiguousarray(deps, dtype=np.int32)
    n = d.shape[0]
    if d.shape != (n, 3):
        raise ValueError(f"deps must be [n, 3], got {d.shape}")
    out = np.empty(n, dtype=np.int32)
    rc = get_lib().fg_layer_waves(n, d.ctypes.data, out.ctypes.data)
    if rc == 2:
        raise AssertionError("dependency id out of range in deps array")
    if rc != 0:
        raise AssertionError("cycle in causal dependency graph")
    return out


def refbase_roundtrip(image, cache_geometry: bool = False):
    """Encode and decode `image` [H, W, C] uint8 with the single-thread C
    reference-baseline codec (csrc/refbase.cpp); raises unless lossless.
    cache_geometry=False rebuilds the tile lattice a call, as the
    reference codec does. Returns (encode s, decode s, container bytes)."""
    lib = get_lib()
    img = np.ascontiguousarray(image, dtype=np.uint8)
    h, w, c = img.shape
    lib.rb_use_cache(1 if cache_geometry else 0)
    blob, blen = ctypes.c_void_p(), ctypes.c_int64()
    t0 = time.perf_counter()
    rc = lib.rb_encode(h, w, c, img.ctypes.data, ctypes.byref(blob), ctypes.byref(blen))
    t1 = time.perf_counter()
    if rc != 0:
        raise RuntimeError(f"refbase encode failed (rc={rc})")
    try:
        out = np.empty((h, w, c), dtype=np.uint8)
        t2 = time.perf_counter()
        rc = lib.rb_decode(blob, blen.value, out.ctypes.data)
        t3 = time.perf_counter()
        if rc != 0:
            raise RuntimeError(f"refbase decode failed (rc={rc})")
    finally:
        lib.rb_free(blob)
    if not np.array_equal(out, img):
        raise AssertionError("refbase baseline round trip is not lossless")
    return t1 - t0, t3 - t2, int(blen.value)


def frif_decode_native(blob: bytes) -> np.ndarray:
    """Decode a frif v8/v9 grid-mode container with the C++ codec ->
    [h, w, C] uint8. Raises ValueError on a container it refuses (its
    diagnostic code in the message)."""
    lib = get_lib()
    buf = np.frombuffer(blob, dtype=np.uint8)
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.frif_probe(buf.ctypes.data, len(blob), ctypes.byref(h), ctypes.byref(w),
                        ctypes.byref(c))
    if rc != 0:
        raise ValueError(f"frif_probe failed (rc={rc})")
    out = np.empty((h.value, w.value, c.value), dtype=np.uint8)
    rc = lib.frif_decode(buf.ctypes.data, len(blob), out.ctypes.data)
    if rc != 0:
        raise ValueError(f"frif_decode failed (rc={rc})")
    return out


def frif_encode_native(pixels, quality: int = 3, transform: int = 0, num_lanes: int = 0,
                       mode: str = "grid") -> bytes:
    """Encode [h, w] or [h, w, C] uint8 pixels into a frif v9 container
    (mode "grid" or "parallel"; num_lanes 0: the default count) with the
    C++ codec."""
    if mode not in FRIF_MODES:
        raise ValueError(f"the native codec has no mode {mode!r} (it has {sorted(FRIF_MODES)})")
    lib = get_lib()
    arr = np.ascontiguousarray(pixels, dtype=np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    ptr, n = ctypes.c_void_p(), ctypes.c_int64()
    rc = lib.frif_encode(h, w, c, arr.ctypes.data, quality, transform, num_lanes,
                         FRIF_MODES[mode], ctypes.byref(ptr), ctypes.byref(n))
    if rc != 0:
        raise ValueError(f"frif_encode failed (rc={rc})")
    try:
        return ctypes.string_at(ptr.value, n.value)
    finally:
        lib.frif_free(ptr)
