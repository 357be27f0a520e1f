#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (frave_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reporting on its own lines; any failed check raises and the
script exits nonzero without printing a result:

  1. build   — compile the CUDA kernels (frave_tpu_torch/csrc, one nvcc
               per source, all at once) and, beside them, the C++ frif
               oracle (csrc/frif.cpp + csrc/geometry.cpp, g++) into
               frave_tpu_torch/_build/, bound with ctypes here;
  2. kernels — each image's CodecProgram built (timed); each kernel
               against its plain PyTorch version on the same card
               tensors, bit-equal, at the shapes every image of the main
               path gives it (forward_lift_quantize_pixels on the image's
               own program, every transform id at C = 3, lossless and
               lossy qdiv, and at every tiles a block; encode_scan's grid
               under a row map of several waves with partly filled last
               rows, and at every design point: rows loaded ahead x lanes
               a block; dequantize_inverse_lift_pixels on the image's own
               program, every transform id at C = 3; the largest decode
               wave);
               decode_scan_wave also on valid and garbage waves up to
               32,768 lanes, at its launch rule's cluster size and forced
               to 1, 2, 4, 8 and 16 blocks; then every kernel on whole
               batches in one launch: 768x512 RGB at B = 4 (mixed
               transform ids and qdivs), kernel 3 on (30, 3, 16384) waves
               at B = 12 (more 16-block clusters than the card holds at
               once), and, timed last (the kernels line reports them),
               256x256 gray at B = 64. Kernel times are device times
               of back-to-back calls (kernel_check.device_ms), beside the
               wrapper's and the plain version's CUDA-event medians per
               call; the byte bound of each; the empty cross-block
               exchange loop at 2, 4, 8 and 16 blocks;
  3. main    — the port's public encode -> decode (seeded
               natural-statistics images), five paths (a-e), each with the
               launch counts zeroed just before it and read just after it
               (every kernel launched, forward_lift_quantize_pixels and
               encode_scan once an encode, dequantize_inverse_lift_pixels
               once a decode,
               decode_scan_wave once per non-empty wave of a dense grid
               decode, decode_steps once every other decode, the plain
               decode row never; every container at the lane count the kernels
               phase checked). Every image is held
               against the reference by sources that are not the JAX
               package's Python: the C++ oracle decodes the port's
               container to the port's pixels, and the port decodes the
               oracle's own container of the image to the oracle's pixels;
               where tests/data/torch_port_refs.json has the image, the
               port's encode with the reference's parameters pinned must
               match its length and SHA-256 (made by frave_tpu's jax
               backend, tests/make_torch_refs.py):
               a. 256x256 gray and 768x512 RGB, lossless, the golden v9
                  grid fixtures decoded, 16 byte flips decoded without a
                  crash; then a color_transform="trial" encode of 768x512
                  RGB, one kernel A and one kernel C launch a candidate;
               b. 512x512 gray at HIGH, MEDIUM and LOW;
               c. 2048x2048 RGB, lossless, first-call time and peak
                  device memory;
               d. the batch surface: 64 256x256 gray images in one batch
                  (each container byte-equal to its one-image container,
                  each decode the image; one kernel A and C launch for the
                  encode batch, one kernel B and one kernel 3 per
                  non-empty wave for the decode batch) and its encode,
                  decode and round-trip MP/s (median of 5 warm runs)
                  beside one image's; 4 768x512 RGB images encoded at
                  HIGH with forced transform ids 0-3 and at LOSSLESS,
                  decoded in one batch that mixes the two presets, the
                  oracle cross-decoding two of them both ways; the
                  256-image stream round trip in batches of 64, with
                  device_verify reading 0 mismatches and without;
               e. the step-tensor codec (kernel D, never kernel 3):
                  e1 2048x2048 RGB in parallel mode and e2 768x512 RGB
                  in parity mode, lossless (three timed round trips, the
                  oracle both ways where it has the mode, the pinned
                  encode against the jax hash, kernel D bit-equal to its
                  plain version on the container's wire and on garbage
                  at every design it can run: the launch rule, its
                  cluster variant at every size it takes, its one-block
                  variant where that fits; timed beside its byte bound,
                  the exchange floor and the empty-step floor, and its
                  design sweep, each feature switched off in turn); e3 4
                  256x256 gray parity images in one encode and one
                  decode batch (one kernel D launch, each container
                  byte-equal to its own, D at every design); e4
                  the v7/v8 fixtures; e5 the grid shapes 1x1, 2x511,
                  511x2 and 16x16, gray and RGB (kernel D where there is
                  no dense lattice), the oracle where it takes the shape;
                  e6 16 byte flips of the e2 container;
  4. report  — encode/decode ms and MP/s, per-stage ms at every image, kernel
               3's device time per 2048x2048 RGB decode at the launch rule
               and forced to one block, kernel A's device time with and
               without its pixel reads, kernel B's with and without its
               pixel stores, peak device memory, the card's
               name and power limit, then one JSON line of kernels and,
               last, the result line.

Needs CUDA (exits 1 without it); imports neither jax nor frave_tpu.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np
import torch

import frave_tpu_torch
from frave_tpu_torch import EncoderOptions, EncoderQuality, RasterImage, kernel_check
from frave_tpu_torch.codec import grid_decode as GD
from frave_tpu_torch.codec import pipeline_torch as PT
from frave_tpu_torch.codec.channel_transform import choose_transform
from frave_tpu_torch.codec.container import SerializeError, deserialize, serialize
from frave_tpu_torch.entropy.tables import (
    CONTEXT_AMOUNT,
    ENC_FREQ_BITS_CAP,
    MIN_FREQ_BITS,
    _GRID_LOG2,
    _LAPLACE_GRID_ROWS,
)
from frave_tpu_torch.fractal.geometry import get_geometry
from frave_tpu_torch.fractal.schedule import default_num_lanes, get_schedule
from frave_tpu_torch.ops import _build
from frave_tpu_torch.ops import lifting as L
from frave_tpu_torch.ops import rans_torch as RT
from frave_tpu_torch.ops import step_decode as SD
from frave_tpu_torch.testing import REF_IMAGES, natural_image

HERE = os.path.dirname(os.path.abspath(__file__))
REFS = os.path.join(HERE, "tests", "data", "torch_port_refs.json")
ORACLE_SOURCES = ("csrc/frif.cpp", "csrc/geometry.cpp")
ORACLE_HEADERS = ("csrc/geometry_core.h",)
ORACLE_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off")
CLUSTERS = (0,) + kernel_check.CLUSTERS  # 0: the launch rule
EXCHANGE_ROWS = 266  # rows of one 2048x2048 RGB decode
BATCH = 64  # bench.py's batch: 64 256x256 gray images
GRAY = (256, 256)  # (h, w) of its images
RGB = (512, 768)  # (h, w) of path d's RGB batch
CORPUS = 256  # bench.py's corpus, four batches of BATCH
RUNS = 5  # warm runs a batch timing takes the median of
# path e, the step-tensor codec: (case, image label, mode, the oracle's mode
# number or None where it has no such mode) at full width
E_IMAGES = (("e1", "2048x2048 RGB", "parallel", 0), ("e2", "768x512 RGB", "parity", None))
E_BATCH = 4  # e3: 256x256 gray parity images in one decode batch
TINY = ((1, 1), (2, 511), (511, 2), (16, 16))  # e5: grid shapes with few cells
ORACLE_GRID = 2  # the oracle's mode number of grid mode


# ---------------------------------------------------------------- oracle


def start_oracle_build():
    """Start g++ on the C++ frif oracle (nothing is written under csrc/).
    Returns (process or None when already built, library path)."""
    h = hashlib.sha256(" ".join(ORACLE_FLAGS).encode())
    for rel in ORACLE_SOURCES + ORACLE_HEADERS:
        h.update(open(os.path.join(HERE, rel), "rb").read())
    out = _build.BUILD_DIR / f"libfrif_oracle_{h.hexdigest()[:16]}.so"
    if out.exists():
        return None, out
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = ["g++", *ORACLE_FLAGS, "-I", os.path.join(HERE, "csrc"),
           *(os.path.join(HERE, s) for s in ORACLE_SOURCES), "-o", str(out) + ".tmp"]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), out


def finish_oracle_build(proc, out):
    if proc is not None:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on the frif oracle:\n{err}")
        os.replace(str(out) + ".tmp", out)
    return Oracle(out)


class Oracle:
    """ctypes binding of the C++ frif oracle's plain C interface
    (frif_probe, frif_decode, frif_encode, frif_free)."""

    def __init__(self, path):
        lib = ctypes.CDLL(str(path))
        P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.frif_probe.argtypes = [P, I64, ctypes.POINTER(I), ctypes.POINTER(I), ctypes.POINTER(I)]
        lib.frif_decode.argtypes = [P, I64, P]
        lib.frif_encode.argtypes = [I, I, I, P, I, I, I, I, ctypes.POINTER(P), ctypes.POINTER(I64)]
        lib.frif_free.argtypes = [P]
        for fn in (lib.frif_probe, lib.frif_decode, lib.frif_encode):
            fn.restype = I
        lib.frif_free.restype = None
        self.lib = lib

    def decode(self, blob: bytes) -> np.ndarray:
        buf = np.frombuffer(blob, dtype=np.uint8)
        h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        rc = self.lib.frif_probe(buf.ctypes.data, len(blob), ctypes.byref(h),
                                 ctypes.byref(w), ctypes.byref(c))
        if rc != 0:
            raise AssertionError(f"oracle frif_probe failed (rc={rc})")
        out = np.empty((h.value, w.value, c.value), dtype=np.uint8)
        rc = self.lib.frif_decode(buf.ctypes.data, len(blob), out.ctypes.data)
        if rc != 0:
            raise AssertionError(f"oracle frif_decode failed (rc={rc})")
        return out

    def encode(self, px: np.ndarray, quality: EncoderQuality, transform: int,
               mode: int = ORACLE_GRID) -> bytes:
        """The oracle's container of px (mode 0: parallel, 2: grid) at its
        default lane count."""
        arr = np.ascontiguousarray(px, dtype=np.uint8)
        h, w, c = arr.shape
        ptr, n = ctypes.c_void_p(), ctypes.c_int64()
        rc = self.lib.frif_encode(h, w, c, arr.ctypes.data, quality.value, transform, 0, mode,
                                  ctypes.byref(ptr), ctypes.byref(n))
        if rc != 0:
            raise AssertionError(f"oracle frif_encode failed (rc={rc})")
        try:
            return ctypes.string_at(ptr.value, n.value)
        finally:
            self.lib.frif_free(ptr)


def oracle_checks(label, px, blob, port_px, quality, oracle, mode: int = ORACLE_GRID):
    """The oracle decodes the port's container to the port's pixels (the
    input where lossless); the port decodes the oracle's own container of
    the image (in the oracle's `mode`) to the oracle's pixels."""
    lossless = quality == EncoderQuality.LOSSLESS
    t = time.perf_counter()
    if not np.array_equal(oracle.decode(blob), port_px):
        raise AssertionError(f"{label}: the oracle decodes the port's container differently")
    if lossless and not np.array_equal(port_px, px):
        raise AssertionError(f"{label}: lossless round trip does not give the input")
    if not lossless and np.array_equal(port_px, px):
        raise AssertionError(f"{label}: a lossy preset decoded to the input")
    tid = choose_transform(px, "auto", lossless) if px.shape[2] == 3 else 0
    oblob = oracle.encode(px, quality, tid, mode)
    ref = oracle.decode(oblob)
    if not np.array_equal(frave_tpu_torch.decode(oblob, device="cuda").data, ref):
        raise AssertionError(f"{label}: the port decodes the oracle's container differently")
    if lossless and not np.array_equal(ref, px):
        raise AssertionError(f"{label}: the oracle's own lossless container is not lossless")
    print(f"main {label}: oracle decodes the port's container to the port's pixels, the port "
          f"the oracle's ({len(oblob)} B, transform {tid}) to the oracle's "
          f"({time.perf_counter() - t:.3f} s)")


# ---------------------------------------------------------------- refs


def scale_gains(hist: np.ndarray, idx: int):
    """(f32 host-formula gain, f64 gain) of grid scale `idx` for one
    context histogram (entropy/tables.select_scale)."""
    tot = int(hist.sum())
    bits = max(MIN_FREQ_BITS, min(tot.bit_length() - 1, ENC_FREQ_BITS_CAP))
    b = bits - MIN_FREQ_BITS
    data = hist > 0
    zero = _LAPLACE_GRID_ROWS[idx, b] == 0
    g32 = np.float32(_GRID_LOG2[idx, b] @ hist.astype(np.float32)) - np.float32(16.0) * np.float32(
        zero.astype(np.float32) @ data.astype(np.float32)
    )
    g64 = float(_GRID_LOG2[idx, b].astype(np.float64) @ hist.astype(np.float64)) - 16.0 * float(
        (zero & data).sum()
    )
    return float(g32), g64


def compare_ref(entry, px, oracle):
    """Encode `px` on the card with the reference entry's parameters and
    lane count pinned; the container's length and SHA-256 must match the
    jax backend's. The one allowed difference is a scale-gain near-tie,
    which jax resolves in f32 and the port exactly: each differing context
    must be one (the port's pick the exact argmax, the two gains within
    f32 rounding of each other), is printed with both gains, and then the
    container must decode to the same pixels on the oracle (None: a mode
    it has not) and the port."""
    label = f"{entry['label']} {entry['quality']}"
    q = EncoderQuality[entry["quality"]]
    opts = EncoderOptions(
        quality=q, num_lanes=entry["num_lanes"], mode=entry["mode"],
        value_prediction_params=np.asarray(entry["value_prediction_params"], np.float32),
        width_prediction_params=np.asarray(entry["width_prediction_params"], np.float32),
    )
    blob = frave_tpu_torch.encode(px, opts, device="cuda")
    digest = hashlib.sha256(blob).hexdigest()
    if len(blob) == entry["length"] and digest == entry["sha256"]:
        print(f"main {label}: pinned encode matches the reference hash ({len(blob)} B, "
              f"sha256 {digest[:16]}...)")
        return
    ci = deserialize(blob)
    hist = PT._encode_dispatch([RasterImage.from_array(px)], opts, "cuda").hist[0].cpu().numpy()
    ties, other = [], []
    for c, rows in enumerate(entry["contexts"]):
        for k, (rb, rs) in enumerate(rows):
            t = ci.channel_data[c].ans_contexts[k]
            if (t.max_freq_bits, t.scale_idx) == (rb, rs):
                continue
            gp, gr = scale_gains(hist[c, k], t.scale_idx), scale_gains(hist[c, k], rs)
            near = gp[1] >= gr[1] and gp[1] - gr[1] <= 1e-5 * max(abs(gp[1]), 1.0)
            (ties if near and hist[c, k].sum() else other).append((c, k, t.scale_idx, rs, gp, gr))
    for c, k, sp, sr, gp, gr in ties + other:
        print(f"main {label}: ch{c} ctx{k}: port picks scale {sp} (gain f32 {gp[0]!r}, "
              f"f64 {gp[1]!r}), the reference {sr} (gain f32 {gr[0]!r}, f64 {gr[1]!r})")
    if other or not ties:
        raise AssertionError(f"{label}: pinned container ({len(blob)} B, {digest}) differs from "
                             f"the reference ({entry['length']} B, {entry['sha256']})")
    port_px = frave_tpu_torch.decode(blob, device="cuda").data
    if oracle is not None and not np.array_equal(oracle.decode(blob), port_px):
        raise AssertionError(f"{label}: near-tie container decodes differently on the oracle")
    if q == EncoderQuality.LOSSLESS and not np.array_equal(port_px, px):
        raise AssertionError(f"{label}: near-tie container is not lossless")
    print(f"main {label}: {len(ties)} scale near-tie(s); the container decodes to the same "
          "pixels on the oracle and the port")


# ---------------------------------------------------------------- counts

WRAPPERS = {n: k[0] for n, k in kernel_check.KERNELS.items()}


def zero_counts():
    """Set every kernel's launch count and the plain decode row's call
    count to 0."""
    for fn in WRAPPERS.values():
        fn.launches = 0
    RT.decode_row.calls = 0


def read_counts(label: str, encodes: int, decodes: int, waves: int, steps: int = 0) -> dict:
    """The counts since zero_counts() over `encodes` encode batches and
    `decodes` decode batches (a one-image call is a batch of one): exactly
    one forward_lift_quantize_pixels and one encode_scan launch an encode
    batch, one dequantize_inverse_lift_pixels a decode batch, one
    decode_scan_wave per non-empty wave of each grid decode batch with a
    dense lattice (`waves` in all), one decode_steps each other decode
    batch (`steps` in all), whatever the batch size; the plain decode row
    never."""
    launches = {n: fn.launches for n, fn in WRAPPERS.items()}
    want = {"forward_lift_quantize_pixels": encodes, "encode_scan": encodes,
            "dequantize_inverse_lift_pixels": decodes, "decode_scan_wave": waves,
            "decode_steps": steps}
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected {want}")
    if RT.decode_row.calls:
        raise AssertionError(f"{label}: the plain decode row ran {RT.decode_row.calls} times")
    print(f"main {label}: launches {json.dumps(launches)} (one kernel A and C an encode "
          f"batch, one kernel B a decode batch, one kernel 3 per non-empty wave of a dense "
          f"grid decode batch, one kernel D each other decode batch); plain decode rows 0")
    return launches


# ---------------------------------------------------------------- main path


def first_call(label, px, opts):
    """The first encode -> decode of a shape (its program was built in the
    kernels phase)."""
    t = time.perf_counter()
    blob = frave_tpu_torch.encode(px, opts, device="cuda")
    t_enc = time.perf_counter() - t
    t = time.perf_counter()
    frave_tpu_torch.decode(blob, device="cuda")
    t_dec = time.perf_counter() - t
    print(f"main {label}: first call (program built before) encode {t_enc:.3f} s "
          f"decode {t_dec:.3f} s")


def timed_round_trips(label, px, opts, reps, dev):
    """`reps` synchronised encode -> decode calls; the decode must equal
    the input (lossless) or the first decode (lossy). Returns (blob,
    decoded pixels, median encode s, median decode s)."""
    enc_s, dec_s, first = [], [], None
    for _ in range(reps):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        blob = frave_tpu_torch.encode(px, opts, device="cuda")
        enc_s.append(time.perf_counter() - t)
        t = time.perf_counter()
        out = frave_tpu_torch.decode(blob, device="cuda").data
        torch.cuda.synchronize(dev)
        dec_s.append(time.perf_counter() - t)
        ref = px.reshape(out.shape) if opts.quality == EncoderQuality.LOSSLESS else first
        if ref is not None and not np.array_equal(out, ref):
            raise AssertionError(f"{label}: port round trip does not give the expected pixels")
        first = out if first is None else first
    return blob, first, float(np.median(enc_s)), float(np.median(dec_s))


def stage_ms(px, opts, dev) -> dict:
    """Per-stage ms of one synchronised encode and decode."""
    img = RasterImage.from_array(px)
    st_e = PT.StageTimes(dev)
    ci = PT.encode_pipeline_torch(img, opts, "cuda", stages=st_e)
    st_d = PT.StageTimes(dev)
    PT.decode_pipeline_torch(ci, "cuda", stages=st_d)
    return {k: round(v, 3) for k, v in {**st_e.ms, **st_d.ms}.items()}


def same_lanes(label: str, shape: dict, *blobs: bytes) -> None:
    """Each container has the lane count that the kernels phase checked
    the kernels at (a rate-adaptive re-encode would lower it)."""
    for blob in blobs:
        nl = deserialize(blob).num_lanes
        if nl != shape["grid"][2]:
            raise AssertionError(
                f"{label}: a container has {nl} lanes, the kernels were "
                f"checked at {shape['grid'][2]}"
            )


def run_checks(plan: dict, dev, checks: dict) -> None:
    """Each kernel against its plain version at the shapes of `plan`
    ({name: [(shape, problem kind, timed, cluster sizes, images)]}, images
    0 for one image without a batch axis, else the batch size, the
    transform ids and qdivs mixed across it); appends to `checks`."""
    for name, cases in plan.items():
        for sh, pk, timed, clusters, images in cases:
            r = kernel_check.check(name, sh, dev, seed=7, timed=timed, kind=pk,
                                   clusters=clusters, images=images)
            desc = f"kernel {name} {tuple(sh)}{'' if pk is None else f' {pk}'}"
            if name == "dequantize_inverse_lift_pixels":
                desc = f"kernel {name} {sh[0]}x{sh[1]}x{sh[2]} program, transform {pk}"
            if name == "forward_lift_quantize_pixels":
                desc = (f"kernel {name} {sh[0]}x{sh[1]}x{sh[2]} program, transform {pk[0]}, "
                        f"{pk[1]} qdiv")
            if images:
                desc += f", batch of {images} in one launch"
            if name == "decode_scan_wave":
                desc += f" clusters {list(clusters)} (rule: {r['cluster']})"
            times = ""
            if timed:
                times = (f" kernel {r['ms']:.4f} ms (wrapper {r['wrapper_ms']:.4f}) plain "
                         f"{r['plain_ms']:.4f} ms bound {r['bound_ms']:.5f} ms")
            print(f"{desc}: max_abs_err {r['max_abs_err']}{times}")
            if "cluster_ms" in r:
                print(f"kernel {name} {tuple(sh)} device ms by cluster size (0: the rule): "
                      + json.dumps({str(k): round(v, 4) for k, v in r["cluster_ms"].items()}))
            if r["max_abs_err"] != 0:
                raise AssertionError(f"{name} {sh} {pk}: kernel disagrees with its plain version "
                                     f"({r['errs']})")
            checks.setdefault(name, []).append(r)


def exchange_floor(dev) -> dict:
    """Device ms of EXCHANGE_ROWS rows of kernel 3's cross-block exchange
    alone (frave_exchange_loop) at 2, 4, 8 and 16 blocks."""
    out = {}
    for size in kernel_check.CLUSTERS[1:]:
        ms = kernel_check.device_ms(lambda: RT.exchange_loop(EXCHANGE_ROWS, size, dev))
        out[size] = ms
        print(f"kernel exchange floor: {EXCHANGE_ROWS} rows at {size} blocks {ms:.4f} ms "
              f"({ms / EXCHANGE_ROWS * 1e3:.3f} us a row)")
    return out


def decode_kernel_ms(blob: bytes, dev) -> tuple:
    """Kernel 3 over one decode of `blob`: every decode_scan_wave call of
    the decode is recorded, then each is timed alone (kernel_check.device_ms)
    at the launch rule and forced to one block. Returns (rule ms, one-block
    ms, byte-bound ms), each summed over the waves."""
    calls = []

    def record(*args):
        calls.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args))
        return RT.decode_scan_wave(*args)

    wave = GD.decode_scan_wave
    GD.decode_scan_wave = record
    try:
        frave_tpu_torch.decode(blob, device="cuda")
    finally:
        GD.decode_scan_wave = wave
    rule, one = (
        sum(kernel_check.device_ms(lambda: RT.decode_scan_wave(*args, cluster=size))
            for args in calls)
        for size in (0, 1)
    )
    nbytes = sum(kernel_check.bytes_moved("decode_scan_wave", args, RT.decode_scan_wave(*args))
                 for args in calls)
    return rule, one, nbytes / kernel_check.HBM_BYTES_PER_S * 1e3


# ---------------------------------------------------------------- batches


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sync_times(fn, dev, runs: int = 0) -> list:
    """Wall seconds of `runs` (0: RUNS) synchronised calls of fn after one
    warm call."""
    runs = runs or RUNS
    fn()
    out = []
    for _ in range(runs):
        sync(dev)
        t = time.perf_counter()
        fn()
        sync(dev)
        out.append(time.perf_counter() - t)
    return out


def dispatch_syncs(fn) -> list:
    """Where fn() makes a synchronising torch call: the distinct file:line
    of the innermost frame of the port (else of torch) under each warning
    of torch.cuda.set_sync_debug_mode "warn" (the kernels' own launches go
    through ctypes and are not torch calls)."""
    sites = set()

    def record(message, category, filename, lineno, file=None, line=None):
        stack = [f for f in traceback.extract_stack()[:-1]
                 if os.path.basename(f.filename) != "warnings.py"]
        port = [f for f in stack if f.filename.startswith(os.path.join(HERE, "frave_tpu_torch"))]
        f = port[-1] if port else stack[-1]
        sites.add(f"{os.path.relpath(f.filename, HERE)}:{f.lineno}")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sorted(sites)


def rate_line(label: str, mpix: float, secs: list) -> str:
    """MP/s of `mpix` megapixels: the median of the runs and their spread."""
    rates = sorted(mpix / t for t in secs)
    return (f"{label} {float(np.median(rates)):.3f} MP/s (median of {len(rates)}, "
            f"spread {rates[0]:.3f}-{rates[-1]:.3f}; {float(np.median(secs)) * 1e3:.3f} ms)")


def path_d_gray(dev, totals: dict) -> dict:
    """64 256x256 gray images in one batch: each container byte-equal to its
    one-image container, each decode its image, the exact launch counts;
    then the B = 64 encode, decode and round-trip MP/s beside one
    image's, and the batch's peak device memory."""
    label = f"d {BATCH}x {GRAY[0]}x{GRAY[1]} gray"
    px = [natural_image(*GRAY, 1, seed) for seed in range(BATCH)]
    imgs = [RasterImage.from_array(p) for p in px]
    opts = EncoderOptions()
    waves = kernel_check.grid_shapes(*GRAY, 1)["waves"]
    solo = [frave_tpu_torch.encode(p, opts, device=dev) for p in px]
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    cis = PT.encode_pipeline_torch_batch(imgs, opts, dev)
    outs = PT.decode_pipeline_torch_batch(cis, dev)
    sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    for n, k in read_counts(label, 1, 1, waves).items():
        totals[n] += k
    blobs = [serialize(ci) for ci in cis]
    for i, (blob, one, out) in enumerate(zip(blobs, solo, outs)):
        if blob != one:
            raise AssertionError(f"{label}: image {i}'s batch container differs from its "
                                 "one-image container")
        if not np.array_equal(out.data, px[i]):
            raise AssertionError(f"{label}: image {i} does not decode to itself")
    if dev.type == "cuda":
        for stage, fn in (("encode", lambda: PT._encode_dispatch(imgs, opts, dev)),
                          ("decode", lambda: PT._decode_dispatch(cis, dev))):
            syncs = dispatch_syncs(fn)
            print(f"main {label}: {stage} dispatch makes {len(syncs)} synchronising torch "
                  f"call(s){': ' + json.dumps(syncs) if syncs else ''}")
    nbytes = sum(len(b) for b in blobs)
    print(f"main {label}: {BATCH} containers ({nbytes} B, "
          f"{8.0 * nbytes / (BATCH * GRAY[0] * GRAY[1]):.4f} "
          f"bpp) byte-equal to the one-image containers, each decoding to its image; peak "
          f"device memory {peak} B (torch.cuda.max_memory_allocated)")

    def round_trip(batch):
        cs = PT.encode_pipeline_torch_batch(batch, opts, dev)
        return PT.decode_pipeline_torch_batch([deserialize(serialize(c)) for c in cs], dev)

    mp = GRAY[0] * GRAY[1] / 1e6
    rates = {
        "encode": (sync_times(lambda: PT.encode_pipeline_torch_batch(imgs, opts, dev), dev),
                   sync_times(lambda: PT.encode_pipeline_torch_batch(imgs[:1], opts, dev), dev)),
        "decode": (sync_times(lambda: PT.decode_pipeline_torch_batch(cis, dev), dev),
                   sync_times(lambda: PT.decode_pipeline_torch_batch(cis[:1], dev), dev)),
        "round trip": (sync_times(lambda: round_trip(imgs), dev),
                       sync_times(lambda: round_trip(imgs[:1]), dev)),
    }
    out = {"peak_bytes": peak}
    for stage, (batch_s, one_s) in rates.items():
        print(f"report {label} {stage}: " + rate_line(f"B={BATCH}", BATCH * mp, batch_s) + "; "
              + rate_line("B=1", mp, one_s))
        out[stage] = (float(np.median([BATCH * mp / t for t in batch_s])),
                      float(np.median([mp / t for t in one_s])))
    return out


def path_d_rgb(dev, totals: dict, oracle) -> None:
    """4 768x512 RGB images encoded in one batch at HIGH with forced
    transform ids 0-3 and in one at LOSSLESS (auto transforms), then one
    decode batch mixing the two presets: every container byte-equal to
    its one-image container, every decode to its one-image decode (the
    input where lossless), the exact launch counts; the oracle
    cross-decodes two of the batch's containers both ways."""
    label = f"d 4x {RGB[1]}x{RGB[0]} RGB"
    px = [natural_image(*RGB, 3, 10 + i) for i in range(4)]
    imgs = [RasterImage.from_array(p) for p in px]
    high, lossless = EncoderOptions(quality=EncoderQuality.HIGH), EncoderOptions()
    waves = kernel_check.grid_shapes(*RGB, 3)["waves"]
    solo_h = [serialize(PT._encode_finish(PT._encode_dispatch([im], high, dev, tids=[t]),
                                          high)[0]) for t, im in enumerate(imgs)]
    solo_l = [serialize(PT.encode_pipeline_torch(im, lossless, dev)) for im in imgs]
    zero_counts()
    cis_h = PT._encode_finish(PT._encode_dispatch(imgs, high, dev, tids=[0, 1, 2, 3]), high)
    cis_l = PT.encode_pipeline_torch_batch(imgs, lossless, dev)
    mixed = [cis_h[0], cis_l[1], cis_h[2], cis_l[3]]
    outs = PT.decode_pipeline_torch_batch(mixed, dev)
    sync(dev)
    for n, k in read_counts(label, 2, 1, waves).items():
        totals[n] += k
    if [serialize(c) for c in cis_h] != solo_h or [serialize(c) for c in cis_l] != solo_l:
        raise AssertionError(f"{label}: a batch container differs from its one-image container")
    if [c.transform for c in cis_h] != [0, 1, 2, 3]:
        raise AssertionError(f"{label}: the forced transform ids did not reach the containers")
    for i, (ci, out) in enumerate(zip(mixed, outs)):
        if not np.array_equal(out.data, PT.decode_pipeline_torch(ci, dev).data):
            raise AssertionError(f"{label}: image {i}'s batch decode differs from its own")
        if np.array_equal(out.data, px[i]) != (i % 2 == 1):
            raise AssertionError(f"{label}: image {i} decodes to the input iff lossless, not so")
    print(f"main {label}: HIGH with transforms [0, 1, 2, 3], LOSSLESS with "
          f"{[c.transform for c in cis_l]}; the mixed decode batch (HIGH, LOSSLESS, HIGH, "
          f"LOSSLESS) gives each image's own decode, the lossless ones the input")
    for i, q in ((2, EncoderQuality.HIGH), (1, EncoderQuality.LOSSLESS)):
        oracle_checks(f"{label} image {i}", px[i], serialize(mixed[i]), outs[i].data, q, oracle)


def path_d_stream(dev, totals: dict) -> dict:
    """The CORPUS-image stream round trip in batches of BATCH (bench.py's
    headline corpus): with device_verify the mismatch count is 0 and the
    launch counts exact; timed with and without device_verify (the
    decoded images are then each its input)."""
    label = f"d {CORPUS}-image stream round trip"
    px = [natural_image(*GRAY, 1, seed) for seed in range(CORPUS)]
    imgs = [RasterImage.from_array(p) for p in px]
    opts = EncoderOptions()
    batches = -(-CORPUS // BATCH)
    zero_counts()
    blobs, mism = PT.roundtrip_pipeline_torch_stream(imgs, opts, BATCH, dev, device_verify=True)
    sync(dev)
    for n, k in read_counts(label, batches, batches,
                             batches * kernel_check.grid_shapes(*GRAY, 1)["waves"]).items():
        totals[n] += k
    if mism != 0 or len(blobs) != CORPUS:
        raise AssertionError(f"{label}: {mism} mismatches over {len(blobs)} containers")
    _, outs = PT.roundtrip_pipeline_torch_stream(imgs, opts, BATCH, dev)
    for i, (p, o) in enumerate(zip(px, outs)):
        if not np.array_equal(o.data, p):
            raise AssertionError(f"{label}: image {i} does not come back")
    print(f"main {label}: {CORPUS} containers, device_verify 0 mismatches; without it every "
          "image comes back")
    mp = CORPUS * GRAY[0] * GRAY[1] / 1e6
    out = {}
    for verify in (True, False):
        secs = sync_times(lambda: PT.roundtrip_pipeline_torch_stream(
            imgs, opts, BATCH, dev, device_verify=verify), dev, runs=3)
        print(f"report {label} (batch_size {BATCH}, device_verify {verify}): "
              + rate_line("", mp, secs))
        out[verify] = float(np.median([mp / t for t in secs]))
    return out


# ---------------------------------------------------------------- path e


def d_report(label: str, r: dict, floor: dict, steps: int) -> None:
    """Print kernel D's check `r` of one case: its device time beside the
    byte bound (and the bound's share of it), the plan it ran, its two
    chain floors and the plain version's time; records the floors in r.
    The exchange floor is `steps` rows of kernel 3's empty exchange loop at
    the cluster size the cluster variant runs at this width (the rule's
    size; one block has none); the empty-step floor `steps` empty steps of
    the one-block variant (one dependent L2 load, a warp ballot and the
    block barrier a step, step_decode.step_floor_loop)."""
    cnl = r["shape"][2] * r["nl"]
    size = 1
    while size < 16 and -(-cnl // size) > 2048:
        size *= 2
    per_step = floor.get(size, 0.0) / EXCHANGE_ROWS
    r["steps"], r["exchange_floor_ms"] = steps, steps * per_step
    r["step_floor_ms"] = kernel_check.step_floor_ms(steps, torch.device("cuda"))
    print(f"report {label}: decode_steps ({steps} steps, {r['images']} image(s), "
          f"{r['variant']} variant, cluster {r['cluster']}, {r['per']} a thread, prefetch "
          f"{r['prefetch']}) max_abs_err {r['max_abs_err']}, device "
          f"{r['ms']:.4f} ms (wrapper {r['wrapper_ms']:.4f}), byte bound {r['bound_ms']:.5f} ms "
          f"({r['bytes']} B at 3.35 TB/s, {100.0 * r['bound_ms'] / r['ms']:.3f}% of the device "
          f"time), exchange floor at {size} blocks {r['exchange_floor_ms']:.4f} ms "
          f"({per_step * 1e3:.3f} us a step), empty-step floor {r['step_floor_ms']:.4f} ms "
          f"({r['step_floor_ms'] / max(steps, 1) * 1e3:.3f} us a step), plain "
          f"{r['plain_ms']:.3f} ms")


def d_designs(ops) -> list:
    """Every design kernel D can run on operands `ops`: the launch rule (0),
    each cluster size its cluster variant takes, and "block" where the rule
    picks a cluster but the one-block variant fits."""
    x, steps, vparams, tabs = ops[0], ops[2], ops[3], ops[6]
    dims = (x.shape[-2], x.shape[-1], tabs["bits"].shape[-1], vparams.shape[-2], steps.max_len)
    out = [0]
    for size in kernel_check.CLUSTERS:
        try:
            SD.decode_steps_plan(*dims, cluster=size)
            out.append(size)
        except RuntimeError:
            pass
    if SD.decode_steps_plan(*dims).variant != "block":
        try:
            SD.decode_steps_plan(*dims, flags=SD.FORCE_BLOCK)
            out.append("block")
        except RuntimeError:
            pass
    return out


def d_check(label: str, cis, dev, kind: str = "valid", timed: bool = True,
            rng=None) -> dict:
    """Kernel D against decode_steps_plain on the wire of the containers
    `cis` (one decode batch; kind "garbage": random states and words on
    their tables), at every design it can run (d_designs; the rule first,
    timed): plane, final states and stream position bit-equal."""
    ops = kernel_check.step_operands(cis, dev, kind, rng, images=len(cis))
    meta = cis[0].metadata
    designs = d_designs(ops)
    r = kernel_check.check_args(
        "decode_steps", ops[:-1], ops[-1:], dev, timed=timed, clusters=designs,
        info={"shape": [meta.height, meta.width, meta.num_channels, cis[0].mode],
              "images": len(cis), "kind": kind, "nl": cis[0].num_lanes},
    )
    if r["max_abs_err"] != 0:
        raise AssertionError(f"{label}: decode_steps disagrees with its plain version "
                             f"({r['errs']})")
    if "cluster_ms" in r:
        print(f"kernel decode_steps {label} device ms by design (0: the rule; n: the cluster "
              f"variant at n blocks; block: the one-block variant): "
              + json.dumps({str(k): round(v, 4) for k, v in r["cluster_ms"].items()}))
    print(f"main {label}: decode_steps bit-equal to decode_steps_plain ({kind}, designs "
          f"{designs}; plane, final lane states, stream position)")
    if timed:
        for name, (plan, ms) in kernel_check.step_design_ms(ops[:-1], ops[-1:], dev).items():
            if plan is None:
                print(f"kernel decode_steps design {label} {name}: refused ({ms})")
                continue
            print(f"kernel decode_steps design {label} {name}: {ms:.4f} ms ({plan.variant} "
                  f"variant, cluster {plan.cluster}, {plan.per} a thread, prefetch "
                  f"{plan.prefetch}; bit-equal)")
    return r


def path_e_image(case, label, mode, oracle_mode, oracle, refs, dev, totals, floor, checks):
    """e1 / e2: one full-width image in a step-tensor mode, lossless: the
    program (timed), three encode -> decode round trips (one kernel A, C,
    D and B launch each, kernel 3 none), the oracle both ways where it has
    the mode, the pinned encode against the jax hash, kernel D bit-equal
    to its plain version on the container's wire (timed) and on garbage.
    Returns the container."""
    h, w, c, seed, _, _ = REF_IMAGES[label]
    px = natural_image(h, w, c, seed)
    lab = f"{case} {label} {mode}"
    opts = EncoderOptions(mode=mode)
    t = time.perf_counter()
    prog = PT.get_program(h, w, default_num_lanes(get_schedule(h, w, mode=mode).num_symbols),
                          c, dev, mode)
    print(f"program {lab}: CodecProgram.from_host {time.perf_counter() - t:.3f} s "
          f"({prog.num_steps} steps of {prog.nl} lanes)")
    first_call(lab, px, opts)
    zero_counts()
    blob, out, te, td = timed_round_trips(lab, px, opts, 3, dev)
    for n, k in read_counts(lab, 3, 3, 0, 3).items():
        totals[n] += k
    mp = h * w / 1e6
    print(f"report {lab}: encode {te * 1e3:.3f} ms ({mp / te:.3f} MP/s) decode {td * 1e3:.3f} "
          f"ms ({mp / td:.3f} MP/s), median of 3; lossless, {len(blob)} B, "
          f"{8.0 * len(blob) / (h * w):.4f} bpp")
    if oracle_mode is None:
        print(f"main {lab}: the oracle has no {mode} mode; the jax hash and the lossless round "
              "trip hold the container")
    else:
        oracle_checks(lab, px, blob, out, EncoderQuality.LOSSLESS, oracle, oracle_mode)
    entries = [e for e in refs if e["label"] == f"{label} {mode}"]
    if not entries:
        raise AssertionError(f"{lab}: no reference hash in {REFS}")
    for entry in entries:
        compare_ref(entry, px, None if oracle_mode is None else oracle)
    ci = deserialize(blob)
    r = d_check(lab, [ci], dev)
    d_report(lab, r, floor, prog.num_steps)
    checks.setdefault("decode_steps", []).append(r)
    d_check(f"{lab} garbage", [ci], dev, "garbage", timed=False, rng=np.random.default_rng(12))
    return blob


def path_e_batch(dev, totals, floor, checks) -> None:
    """e3: E_BATCH 256x256 gray parity images: one encode batch and one
    decode batch (one kernel D launch of E_BATCH clusters), each container
    byte-equal to its one-image container, each decode the image; timed;
    kernel D bit-equal to its plain version on the batch at every cluster
    size and on garbage."""
    lab = f"e3 {E_BATCH}x 256x256 gray parity"
    px = [natural_image(*GRAY, 1, 200 + i) for i in range(E_BATCH)]
    imgs = [RasterImage.from_array(p) for p in px]
    opts = EncoderOptions(mode="parity")
    solo = [serialize(PT.encode_pipeline_torch(im, opts, dev)) for im in imgs]
    zero_counts()
    cis = PT.encode_pipeline_torch_batch(imgs, opts, dev)
    outs = PT.decode_pipeline_torch_batch(cis, dev)
    sync(dev)
    for n, k in read_counts(lab, 1, 1, 0, 1).items():
        totals[n] += k
    for i, (ci, one, out) in enumerate(zip(cis, solo, outs)):
        if serialize(ci) != one:
            raise AssertionError(f"{lab}: image {i}'s batch container differs from its own")
        if not np.array_equal(out.data, px[i]):
            raise AssertionError(f"{lab}: image {i} does not decode to itself")
    print(f"main {lab}: containers byte-equal to the one-image containers, each decoding to "
          "its image")
    mp = E_BATCH * GRAY[0] * GRAY[1] / 1e6
    enc = sync_times(lambda: PT.encode_pipeline_torch_batch(imgs, opts, dev), dev, runs=3)
    dec = sync_times(lambda: PT.decode_pipeline_torch_batch(cis, dev), dev, runs=3)
    print(f"report {lab}: encode " + rate_line(f"B={E_BATCH}", mp, enc) + "; decode "
          + rate_line(f"B={E_BATCH}", mp, dec))
    r = d_check(lab, cis, dev)
    d_report(lab, r, floor, PT.get_program(*GRAY, cis[0].num_lanes, 1, dev, "parity").num_steps)
    checks.setdefault("decode_steps", []).append(r)
    d_check(f"{lab} garbage", cis, dev, "garbage", timed=False, rng=np.random.default_rng(13))


def path_e_small(dev, totals, oracle, e2_blob) -> list:
    """e4: the four v7/v8 fixtures (parallel, 32 lanes) decode to their
    .npy; e5: the tiny grid shapes, gray and RGB, round-trip (kernel D
    where the shape has no dense lattice, kernel 3 where it has one), the
    oracle cross-decoding where it takes the shape; e6: 16 byte flips of
    the e2 container decode without a crash. Returns the oracle's
    rejections [(case, reason)]."""
    zero_counts()
    times = {}
    for name in ("v7_gray", "v7_rgb", "v8_gray", "v8_rgb"):
        blob = open(os.path.join(HERE, "tests", "data", f"{name}.frv"), "rb").read()
        ref = np.load(os.path.join(HERE, "tests", "data", f"{name}.npy"))
        secs = []
        for _ in range(3):
            sync(dev)
            t = time.perf_counter()
            out = frave_tpu_torch.decode(blob, device="cuda").data
            secs.append(time.perf_counter() - t)
            if not np.array_equal(out, ref):
                raise AssertionError(f"e4 golden {name} does not decode to its .npy")
        times[name] = float(np.median(secs)) * 1e3
    for n, k in read_counts("e4 golden v7/v8", 0, 12, 0, 12).items():
        totals[n] += k
    print("report e4 golden v7/v8 decode ms (median of 3, each to its .npy): "
          + json.dumps({k: round(v, 3) for k, v in times.items()}))

    rejected = []
    for h, w in TINY:
        for c in (1, 3):
            lab = f"e5 {h}x{w} {'RGB' if c == 3 else 'gray'} grid"
            px = natural_image(h, w, c, 300 + h + w + c)
            nl = default_num_lanes(get_schedule(h, w, mode="grid").num_symbols)
            dense = PT.get_program(h, w, nl, c, dev, "grid").steps is None
            zero_counts()
            blob, out, te, td = timed_round_trips(lab, px, EncoderOptions(), 3, dev)
            waves = 3 * kernel_check.grid_shapes(h, w, c)["waves"] if dense else 0
            for n, k in read_counts(lab, 3, 3, waves, 0 if dense else 3).items():
                totals[n] += k
            print(f"report {lab} ({'dense lattice, kernel 3' if dense else 'step tensors, kernel D'}"
                  f"): encode {te * 1e3:.3f} ms decode {td * 1e3:.3f} ms, median of 3; lossless, "
                  f"{len(blob)} B")
            try:
                oracle_checks(lab, px, blob, out, EncoderQuality.LOSSLESS, oracle)
            except AssertionError as e:
                if not str(e).startswith("oracle frif_"):
                    raise
                rejected.append((lab, str(e)))
                print(f"main {lab}: the oracle rejects the shape ({e})")

    rng = np.random.default_rng(14)
    meta = deserialize(e2_blob).metadata
    shape = (meta.height, meta.width, meta.num_channels)
    decoded = refused = 0
    for _ in range(16):
        b = bytearray(e2_blob)
        b[int(rng.integers(90, len(e2_blob)))] ^= 1 << int(rng.integers(0, 8))
        try:
            if frave_tpu_torch.decode(bytes(b), device="cuda").data.shape != shape:
                raise AssertionError("e6: a corrupted container decoded to another shape")
            decoded += 1
        except (SerializeError, ValueError):
            refused += 1
    sync(dev)
    print(f"main e6 robustness: 16 byte flips of the e2 parity container -> {decoded} decoded, "
          f"{refused} rejected, no crash")
    return rejected


def path_e(dev, totals, oracle, refs, floor, checks) -> list:
    """The step-tensor codec at full width (e1-e6); returns the oracle's
    rejections of e5."""
    t0 = time.perf_counter()
    for src, report in _build.ptxas_report.items():
        if src == "rans_step_decode.cu":
            for line in report.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"report e ptxas {src}: {line.strip()}")
    blobs = {}
    for case, label, mode, omode in E_IMAGES:
        blobs[case] = path_e_image(case, label, mode, omode, oracle, refs, dev, totals, floor,
                                   checks)
    checks["decode_steps"][0]["line"] = True  # e1 is the kernels line's
    path_e_batch(dev, totals, floor, checks)
    rejected = path_e_small(dev, totals, oracle, blobs["e2"])
    print(f"phase main steps (path e) took {time.perf_counter() - t0:.1f} s")
    return rejected


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    t_start = time.perf_counter()

    # ---- 1. build: nvcc per kernel source and g++ on the oracle, together
    t0 = time.perf_counter()
    oracle_proc, oracle_path = start_oracle_build()
    _build.load_library()
    oracle = finish_oracle_build(oracle_proc, oracle_path)
    print(f"build: {time.perf_counter() - t0:.3f} s (nvcc "
          f"{_build.build_seconds if _build.build_seconds is not None else 'cached'}; "
          f"oracle {oracle_path.name})")
    for src, report in _build.ptxas_report.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build ptxas {src}: {line.strip()}")

    # ---- 2. kernels against their plain versions on the card
    images = {
        "256x256 gray": natural_image(256, 256, 1, seed=1),
        "768x512 RGB": natural_image(512, 768, 3, seed=2),
    }
    preset_label, preset_px = "512x512 gray", natural_image(512, 512, 1, seed=3)
    big_label, big_px = "2048x2048 RGB", natural_image(2048, 2048, 3, seed=4)
    for label, px in {**images, preset_label: preset_px, big_label: big_px}.items():
        h, w, c, seed, _, _ = REF_IMAGES[label]
        if not np.array_equal(px, natural_image(h, w, c, seed)):
            raise AssertionError(f"{label}: not the image the reference hashes were made from")
    all_images = {**images, preset_label: preset_px, big_label: big_px}
    shapes = {label: kernel_check.grid_shapes(*px.shape) for label, px in images.items()}
    shapes[preset_label] = kernel_check.grid_shapes(*preset_px.shape)
    t = time.perf_counter()
    shapes[big_label] = kernel_check.grid_shapes(*big_px.shape)
    print(f"host schedule and geometry {big_label}: {time.perf_counter() - t:.3f} s "
          "(cached: the first call below does not rebuild them)")
    # (shape, problem kind, timed, cluster sizes, images): every kernel at
    # the shapes each image gives it at the default lane count, timed;
    # decode_scan_wave at every cluster size it can run; the last timed
    # shape of each kernel (the batch below) is the one the kernels line
    # reports
    plan = {name: [] for name in kernel_check.KERNELS}
    plan["decode_scan_wave"] = [
        (sh, k, False, CLUSTERS, 0)
        for sh in ((138, 1, 512), (60, 3, 2048), (30, 3, 16384), (4, 3, 32768))
        for k in kernel_check.DECODE_KINDS
    ] + [((40, 1, 512), "valid", True, CLUSTERS, 0)]  # a small one-block wave, timed
    for label, px in all_images.items():
        sh = shapes[label]
        # kernels A and B on the image's own program, every transform id at
        # C = 3; A at the lossy qdiv and then the lossless one (the main
        # path's, so the kernels line reports it)
        tids = range(4) if px.shape[2] == 3 else (0,)
        for q in kernel_check.QDIV_KINDS[::-1]:
            for tid in tids:
                plan["forward_lift_quantize_pixels"].append((px.shape, (tid, q), True, (0,), 0))
        for tid in tids:
            plan["dequantize_inverse_lift_pixels"].append((px.shape, tid, True, (0,), 0))
        plan["encode_scan"].append((sh["grid"], None, True, (0,), 0))
        plan["decode_scan_wave"].append((sh["wave"], "garbage", False, CLUSTERS, 0))
        plan["decode_scan_wave"].append((sh["wave"], "valid", True, CLUSTERS, 0))
    # whole batches in one launch: 768x512 RGB at B = 4 and kernel 3 with
    # more clusters than are resident, untimed; then 256x256 gray at
    # B = 64, bench.py's batch, timed last (the kernels line reports it)
    for (h, w, c), nimg, timed in (((512, 768, 3), 4, False), ((*GRAY, 1), BATCH, True)):
        sh = kernel_check.grid_shapes(h, w, c)
        plan["forward_lift_quantize_pixels"].append(((h, w, c), (1, "lossless"), timed, (0,), nimg))
        plan["dequantize_inverse_lift_pixels"].append(((h, w, c), 0, timed, (0,), nimg))
        plan["encode_scan"].append((sh["grid"], None, timed, (0,), nimg))
        if not timed:
            plan["decode_scan_wave"] += [(sh["wave"], k, False, (0,), nimg)
                                         for k in kernel_check.DECODE_KINDS]
            # garbage waves (cheap to draw; tests/test_torch_cuda.py has the
            # valid ones) of 12 images, more 16-block clusters than resident
            plan["decode_scan_wave"].append(((30, 3, 16384), "garbage", False, (0, 16), 12))
        else:
            plan["decode_scan_wave"].append((sh["wave"], "valid", True, (0,), nimg))
    for label, px in all_images.items():
        t = time.perf_counter()
        kernel_check.program(*px.shape, dev)
        print(f"program {label}: CodecProgram.from_host {time.perf_counter() - t:.3f} s "
              "(kernel B's checks and the main path share it)")
    checks = {}
    run_checks(plan, dev, checks)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, shape, nimg in [(label, px.shape, 0) for label, px in all_images.items()] + [
            (f"{BATCH}x 256x256 gray", (*GRAY, 1), BATCH)]:
        sweep = kernel_check.lift_head_tiles_ms(shape, dev, images=nimg)
        rule = L.forward_lift_plan(shape[2], get_geometry(*shape[:2]).num_tiles, sms, max(nimg, 1))
        print(f"kernel forward_lift_quantize_pixels {label} device ms by tiles a block, each "
              f"bit-equal to the plain version (rule: {rule}): "
              + json.dumps({str(k): round(ms, 4) for k, ms in sweep.items()}))
    for label in all_images:
        R, C, NL = shapes[label]["grid"]
        sweep = kernel_check.encode_design_ms((R, C, NL), dev)
        rule = RT.encode_plan(C, NL, CONTEXT_AMOUNT)
        print(f"kernel encode_scan {(R, C, NL)} device ms by (rows ahead, lanes a block), "
              f"each bit-equal to the plain version (rule: {rule}): "
              + json.dumps({f"{a},{t}": round(ms, 4) for (a, t), ms in sweep.items()}))
    floor = exchange_floor(dev)
    torch.cuda.synchronize(dev)
    print(f"phase kernels done at {time.perf_counter() - t_start:.1f} s")

    refs = json.load(open(REFS))["entries"]

    # ---- 3a. lossless at 256x256 gray and 768x512 RGB
    lossless = EncoderOptions()
    for label, px in images.items():
        first_call(label, px, lossless)
    totals = {n: 0 for n in WRAPPERS}
    zero_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev)
    reps = 3
    runs = {}
    for label, px in images.items():
        blob, out, te, td = timed_round_trips(label, px, lossless, reps, dev)
        runs[label] = (blob, te, td, out)
    waves = reps * sum(shapes[label]["waves"] for label in images)
    trips = reps * len(images)
    for n, k in read_counts("lossless 256x256 gray + 768x512 RGB", trips, trips, waves).items():
        totals[n] += k
    peak = torch.cuda.max_memory_allocated(dev)

    for label, px in images.items():
        blob, _, _, out = runs[label]
        same_lanes(label, shapes[label], blob)
        oracle_checks(label, px, blob, out, EncoderQuality.LOSSLESS, oracle)
        print(f"main {label}: lossless ({len(blob)} B, "
              f"{8.0 * len(blob) / (px.shape[0] * px.shape[1]):.4f} bpp)")
        for entry in refs:
            if entry["label"] == label:
                compare_ref(entry, px, oracle)

    for name in ("v9grid_gray", "v9grid_rgb"):
        blob = open(os.path.join(HERE, "tests", "data", f"{name}.frv"), "rb").read()
        ref = np.load(os.path.join(HERE, "tests", "data", f"{name}.npy"))
        if not np.array_equal(frave_tpu_torch.decode(blob, device="cuda").data, ref):
            raise AssertionError(f"golden {name} does not decode to its .npy")
        print(f"main golden {name}: decodes to its .npy")

    # robustness contract on the card: a corrupted payload decodes to a
    # garbage image of the right shape or raises a typed error
    rng = np.random.default_rng(3)
    arr = rng.integers(0, 256, size=(40, 40, 1), dtype=np.uint8)
    data = frave_tpu_torch.encode(arr, device="cuda")
    decoded = rejected = 0
    for _ in range(16):
        b = bytearray(data)
        b[int(rng.integers(90, len(data)))] ^= 1 << int(rng.integers(0, 8))
        try:
            if frave_tpu_torch.decode(bytes(b), device="cuda").data.shape != arr.shape:
                raise AssertionError("a corrupted container decoded to another shape")
            decoded += 1
        except (SerializeError, ValueError):
            rejected += 1
    torch.cuda.synchronize(dev)
    print(f"main robustness: 16 byte flips -> {decoded} decoded, {rejected} rejected, no crash")

    # color_transform="trial": one encode, so one kernel A and one kernel C
    # launch, a candidate transform (three at LOSSLESS)
    trial_label = "768x512 RGB"
    zero_counts()
    blob = frave_tpu_torch.encode(images[trial_label], EncoderOptions(color_transform="trial"),
                                  device="cuda")
    got = {n: WRAPPERS[n].launches for n in ("forward_lift_quantize_pixels", "encode_scan")}
    if got != {n: 3 for n in got}:
        raise AssertionError(f"{trial_label} trial: launches {got}, expected 3 each")
    if not np.array_equal(frave_tpu_torch.decode(blob, device="cuda").data, images[trial_label]):
        raise AssertionError(f"{trial_label} trial: the container does not round-trip")
    print(f"main {trial_label} trial: launches {json.dumps(got)} (one each a candidate "
          f"transform, three at LOSSLESS); the smallest container ({len(blob)} B) round-trips")
    print(f"phase main lossless done at {time.perf_counter() - t_start:.1f} s")

    # ---- 3b. the three lossy presets at 512x512 gray
    presets = {q: EncoderOptions(quality=q) for q in
               (EncoderQuality.HIGH, EncoderQuality.MEDIUM, EncoderQuality.LOW)}
    for q, opts in presets.items():
        first_call(f"{preset_label} {q.name}", preset_px, opts)
    zero_counts()
    preset_runs = {}
    for q, opts in presets.items():
        preset_runs[q] = timed_round_trips(f"{preset_label} {q.name}", preset_px, opts, reps, dev)
    waves = reps * len(presets) * shapes[preset_label]["waves"]
    trips = reps * len(presets)
    for n, k in read_counts(f"{preset_label} HIGH/MEDIUM/LOW", trips, trips, waves).items():
        totals[n] += k
    for q, opts in presets.items():
        label = f"{preset_label} {q.name}"
        blob, out_port, _, _ = preset_runs[q]
        same_lanes(label, shapes[preset_label], blob)
        oracle_checks(label, preset_px, blob, out_port, q, oracle)
        psnr = 10 * np.log10(255.0**2 / np.mean((out_port.astype(np.float64) - preset_px) ** 2))
        print(f"main {label}: {len(blob)} B, {8.0 * len(blob) / preset_px[..., 0].size:.4f} bpp, "
              f"PSNR {psnr:.3f} dB")
        for entry in refs:
            if entry["label"] == preset_label and entry["quality"] == q.name:
                compare_ref(entry, preset_px, oracle)
    print(f"phase main presets done at {time.perf_counter() - t_start:.1f} s")

    # ---- 3c. 2048x2048 RGB, lossless
    first_call(big_label, big_px, lossless)
    zero_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    big_blob, big_out, big_te, big_td = timed_round_trips(big_label, big_px, lossless, reps, dev)
    big_peak = torch.cuda.max_memory_allocated(dev)
    for n, k in read_counts(big_label, reps, reps, reps * shapes[big_label]["waves"]).items():
        totals[n] += k
    print(f"main {big_label}: lossless; {shapes[big_label]['waves']} decode_scan_wave "
          f"launches per decode ({len(big_blob)} B, "
          f"{8.0 * len(big_blob) / (2048 * 2048):.4f} bpp)")
    same_lanes(big_label, shapes[big_label], big_blob)
    oracle_checks(big_label, big_px, big_blob, big_out, EncoderQuality.LOSSLESS, oracle)
    for entry in refs:
        if entry["label"] == big_label:
            compare_ref(entry, big_px, oracle)
    print(f"phase main 2048x2048 done at {time.perf_counter() - t_start:.1f} s")

    # ---- 3d. the batch surface
    path_d_gray(dev, totals)
    path_d_rgb(dev, totals, oracle)
    path_d_stream(dev, totals)
    print(f"phase main batches done at {time.perf_counter() - t_start:.1f} s")

    # ---- 3e. the step-tensor codec
    rejected = path_e(dev, totals, oracle, refs, floor, checks)
    print(f"phase main steps done at {time.perf_counter() - t_start:.1f} s")

    # ---- 4. report
    rows = [(label, px, runs[label][1], runs[label][2], lossless) for label, px in images.items()]
    rows += [(f"{preset_label} {q.name}", preset_px, preset_runs[q][2], preset_runs[q][3], opts)
             for q, opts in presets.items()]
    rows.append((big_label, big_px, big_te, big_td, lossless))
    for label, px, te, td, opts in rows:
        mp = px.shape[0] * px.shape[1] / 1e6
        print(f"report {label}: encode {te * 1e3:.3f} ms ({mp / te:.3f} MP/s) "
              f"decode {td * 1e3:.3f} ms ({mp / td:.3f} MP/s), median of {reps}")
        print(f"report {label} stages ms: {json.dumps(stage_ms(px, opts, dev))}")
    for label, blob in [(label, runs[label][0]) for label in images] + [(big_label, big_blob)]:
        rule_ms, one_ms, bound_ms = decode_kernel_ms(blob, dev)
        print(f"report {label}: decode_scan_wave device ms per decode "
              f"({shapes[label]['waves']} launches): launch rule {rule_ms:.4f}, one block "
              f"{one_ms:.4f}, byte bound {bound_ms:.5f}")
    for label, px in all_images.items():
        full, skip = kernel_check.lift_head_read_ms(px.shape, dev)
        print(f"report {label}: forward_lift_quantize_pixels device ms {full:.4f}, "
              f"{skip:.4f} with every pixel read skipped (leaf_pix all -1)")
    for label, px in all_images.items():
        full, skip = kernel_check.lift_pixels_store_ms(px.shape, dev)
        print(f"report {label}: dequantize_inverse_lift_pixels device ms {full:.4f}, "
              f"{skip:.4f} with every pixel store skipped (leaf_pix all -1)")
    floor16 = floor[16] * shapes[big_label]["grid"][0] / EXCHANGE_ROWS
    print(f"report {big_label}: exchange floor of its {shapes[big_label]['grid'][0]} rows at "
          f"16 blocks {floor16:.4f} ms")
    print(f"report peak device memory: {peak} B at 256x256 gray + 768x512 RGB, "
          f"{big_peak} B at {big_label} (torch.cuda.max_memory_allocated; {resident} B "
          "was allocated before the first, every image's program among it)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    foreign = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                     or m == "frave_tpu" or m.startswith("frave_tpu."))
    if foreign:
        raise AssertionError(f"the smoke imported {foreign[:5]}")

    for lab, why in rejected:
        print(f"report {lab}: the oracle rejects the shape ({why})")
    kernels = []
    for name, (_, _, src, replaces) in kernel_check.KERNELS.items():
        rs = checks[name]
        at = ([r for r in rs if r.get("line")] or [r for r in rs if r["ms"] is not None])[-1]
        entry = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                 "launches": totals[name],
                 "max_abs_err": max(r["max_abs_err"] for r in rs),
                 "ms": at["ms"], "plain_ms": at["plain_ms"], "bound_ms": at["bound_ms"],
                 "bound_by": "bytes", "library_ms": None, "shape": at["shape"],
                 "images": at["images"]}
        if name in kernel_check.CLUSTERED:
            entry["cluster"] = at["cluster"]
        if name == "decode_steps":
            entry.update({k: at[k] for k in ("variant", "per", "prefetch", "steps",
                                             "exchange_floor_ms", "step_floor_ms")})
        kernels.append(entry)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
