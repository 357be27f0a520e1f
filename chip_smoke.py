#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (frave_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reporting on its own lines; any failed check raises and the
script exits nonzero without printing a result:

  1. build   — compile the CUDA kernels (frave_tpu_torch/csrc, one nvcc
               per source, all at once) and, beside them, the native host
               library (frave_tpu_torch/native.py: csrc/geometry.cpp,
               refbase.cpp and frif.cpp, one g++ each) into
               frave_tpu_torch/_build/; its C++ frif codec is the oracle;
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
               wave; wave_contexts (kernel W) on every image's program in
               both modes, its largest decode wave and its statistics, on
               the image's coefficients and on garbage, and wave_finish
               (kernel V) on its largest wave, on residual-like and on
               garbage symbols);
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
               call; the byte bound of each (W and V also beside an empty
               launch of their grid); the empty cross-block exchange loop
               at 2, 4, 8 and 16 blocks; V in schedule and in slot order,
               each bit-equal to its plain version, on waves from the
               smallest to the largest at 2048x2048 RGB and at B = 64
               (kernel_check.finish_orders_ms), with its store sectors a
               warp in both orders; the predictor fits (fit_stats, four
               launches) at the benchmark cells' shapes (256x256 gray
               alone and 64 a batch, 768x512 RGB alone and 8, 2048x2048
               RGB), timed beside their byte bound, their plain version
               and the einsum chain they replace (library_ms), and with
               pinned parameters on stripes and noise;
  3. main    — the port's public encode -> decode (seeded
               natural-statistics images), five paths (a-e), each with the
               launch counts zeroed just before it and read just after it
               (every kernel launched, forward_lift_quantize_pixels,
               wave_contexts and encode_scan once an encode, fit_stats
               four times an encode (two where the predictor search pins
               the value parameters),
               dequantize_inverse_lift_pixels once a decode,
               wave_contexts, decode_scan_wave and wave_finish once per
               non-empty wave of a dense grid decode, decode_steps once
               every other decode, the plain decode row never; every
               container at the lane count the kernels phase checked). Every image is held
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
                  design sweep, each feature switched off in turn; kernel
                  W's statistics bit-equal on the program, valid and
                  garbage); e3 4
                  256x256 gray parity images in one encode and one
                  decode batch (one kernel D launch, each container
                  byte-equal to its own, D at every design); e4
                  the v7/v8 fixtures; e5 the grid shapes 1x1, 2x511,
                  511x2 and 16x16, gray and RGB (kernel D where there is
                  no dense lattice), the oracle where it takes the shape;
                  e6 16 byte flips of the e2 container;
               f. the host surfaces: f1 the native host library's build
                  seconds, the 2048x2048 geometry by the native builder and
                  by build_geometry_fast (every field bit-equal), the grid
                  lattice build and the parity schedule with the native and
                  the numpy layering (bit-equal), each timed cold; f2 the
                  CLI at full width, each command in a fresh process (its
                  wall time the user's cold start, its launch counts
                  read back): 2048x2048 RGB grid encode (byte-equal to
                  the in-process encode of 3c), decode (the input), decode
                  --backend native (the input); 768x512 RGB --mode parity
                  encode (byte-equal to e2's) and decode; f3 bench over
                  eight 256x256 gray and two 768x512 RGB .npy; f4 the
                  quality sweep at 512x512 gray, the predictor search at
                  64x64 gray over 16 vectors on the card and on the CPU
                  (same scores, same best vector), then over 64 at 256x256
                  gray on the card, timed; f5 the metrics sink (encode/bpp,
                  the verbose context entropies) and a profiling.trace of a
                  768x512 RGB encode and decode that names the port's
                  kernels;
               g. the parallel layer (frave_tpu_torch.parallel): g0 the
                  tp decode's step kernels 3T and DT chained over whole
                  decodes with the lanes split over 2 ranks, bit-equal to
                  their plain versions chained the same way and to the
                  one-card plain decode, at every design the plan runs
                  (the launch rule, one block, each cluster size, the
                  tables by threads and by TMA, one block with the tables
                  by threads): 3T on the largest 2048x2048 RGB wave
                  (valid and garbage) and, the rule and one block with
                  the tables by threads, on 768x512 RGB's and 256x256
                  gray's; DT on e1's parallel and e2's parity programs
                  (valid and garbage) and, those two, e3's gray parity
                  one; each plan printed, one launch's device ms per
                  design beside its empty launch's and its byte bound;
                  g1 a gloo world of 2 ranks on
                  the card: the dp 1 x tp 2 encode of the 2048x2048 RGB
                  image (halo rings, tp-summed fits and histogram, kernel
                  C over each rank's lane window) byte-equal to 3c's
                  one-card container and decoded by the oracle, the tp
                  decode of it (kernel 3T a row) and of e1's and e2's
                  containers (kernel DT a step), each the input, and the
                  dp decode of 4 768x512 RGB containers; every rank's
                  launch counts read back; the per-row and per-step
                  exchange's wall; g2 a 1-rank NCCL world, the same
                  encode and dp decode; g3 the CorpusRunner on 2 ranks
                  over a .npy corpus and a resume that re-encodes none;
  4. report  — encode/decode ms and MP/s, per-stage ms at every image
               (encode/stats and decode/waves among them), the launches of
               the port's kernels and the torch operators of one grid
               decode at each image, kernel
               3's device time per 2048x2048 RGB decode at the launch rule
               and forced to one block, kernel A's device time with and
               without its pixel reads, kernel B's with and without its
               pixel stores, peak device memory, the card's
               name and power limit, then one JSON line of kernels and,
               last, the result line.

Needs CUDA (exits 1 without it); imports neither jax nor frave_tpu.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import importlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import frave_tpu_torch
from frave_tpu_torch import EncoderOptions, EncoderQuality, RasterImage, kernel_check
from frave_tpu_torch import native as N
from frave_tpu_torch import profiling
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
from frave_tpu_torch.fractal import geometry_fast as GF
from frave_tpu_torch.fractal import lattice as LT
from frave_tpu_torch.fractal import schedule as S
from frave_tpu_torch.fractal.geometry import BASE_FRAC_DEPTH, get_geometry
from frave_tpu_torch.fractal.schedule import default_num_lanes, get_schedule
from frave_tpu_torch.metrics import get_metrics
from frave_tpu_torch.ops import _build
from frave_tpu_torch.ops import lifting as L
from frave_tpu_torch.ops import rans_torch as RT
from frave_tpu_torch.ops import step_decode as SD
from frave_tpu_torch.ops import wave_ctx as WC
from frave_tpu_torch.testing import REF_IMAGES, natural_image

HERE = os.path.dirname(os.path.abspath(__file__))
REFS = os.path.join(HERE, "tests", "data", "torch_port_refs.json")
CLI = importlib.import_module("frave_tpu_torch.cli.main")  # the module, not cli.main()
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
# path f: (h, w, c, seed) of each image; F_GRID and F_PARITY are 3c's and
# e2's images, F_BENCH (shape, count) the bench corpus
F_GRID = (2048, 2048, 3, 4)
F_PARITY = (512, 768, 3, 2)
F_BENCH = (((256, 256, 1), 8), ((512, 768, 3), 2))
F_SWEEP = (512, 512, 1, 3)
F_SEARCH = ((64, 64, 1, 21), 16)  # on the card and on the CPU
F_SEARCH_CARD = ((256, 256, 1, 1), 64)
F_TRACE = (512, 768, 3, 2)
F_KERNELS = ("fwd_lift_pixels", "rans_encode", "rans_decode_wave", "inv_lift_pixels",
             "transform_counts", "fit_pass", "fit_solve")
# one fresh process that runs the CLI's __main__ (what `python -m
# frave_tpu_torch.cli ARGS` runs), then prints the kernels' launch counts
# as the last line of its stderr
CLI_RUNNER = (
    "import json, runpy, sys\n"
    "from frave_tpu_torch import kernel_check\n"
    "sys.argv = ['fri'] + sys.argv[1:]\n"
    "rc = 0\n"
    "try:\n"
    "    runpy.run_module('frave_tpu_torch.cli', run_name='__main__')\n"
    "except SystemExit as e:\n"
    "    rc = e.code\n"
    "print(json.dumps({n: k[0].launches for n, k in kernel_check.KERNELS.items()}),"
    " file=sys.stderr)\n"
    "sys.exit(rc)\n"
)


# ---------------------------------------------------------------- oracle


class Oracle:
    """The C++ frif codec of the native host library (native.py) as the
    oracle: a container or shape it refuses raises AssertionError
    ("oracle frif_...")."""

    def decode(self, blob: bytes) -> np.ndarray:
        try:
            return N.frif_decode_native(blob)
        except ValueError as e:
            raise AssertionError(f"oracle {e}") from None

    def encode(self, px: np.ndarray, quality: EncoderQuality, transform: int,
               mode: int = ORACLE_GRID) -> bytes:
        """The oracle's container of px (mode 0: parallel, 2: grid) at its
        default lane count."""
        name = {v: k for k, v in N.FRIF_MODES.items()}[mode]
        try:
            return N.frif_encode_native(px, quality.value, transform, 0, name)
        except ValueError as e:
            raise AssertionError(f"oracle {e}") from None


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


def read_counts(label: str, encodes: int, decodes: int, waves: int, steps: int = 0,
                choices: int = 0) -> dict:
    """The counts since zero_counts() over `encodes` encode batches and
    `decodes` decode batches (a one-image call is a batch of one): exactly
    one forward_lift_quantize_pixels, one wave_contexts (the statistics),
    four fit_stats (the fits) and one encode_scan launch an encode batch,
    one transform_counts launch each of the `choices` RGB encode batches
    under "auto", one dequantize_inverse_lift_pixels a decode batch, one
    wave_contexts, one decode_scan_wave and one wave_finish per non-empty
    wave of each grid decode batch with a dense lattice (`waves` in all),
    one decode_steps each other decode batch (`steps` in all), whatever
    the batch size; the plain decode row never."""
    launches = {n: fn.launches for n, fn in WRAPPERS.items()}
    want = {"forward_lift_quantize_pixels": encodes, "encode_scan": encodes,
            "dequantize_inverse_lift_pixels": decodes, "decode_scan_wave": waves,
            "decode_steps": steps, "wave_contexts": encodes + waves, "wave_finish": waves,
            "transform_counts": choices,
            "fit_stats": kernel_check.FIT_LAUNCHES["none"] * encodes}
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected {want}")
    if RT.decode_row.calls:
        raise AssertionError(f"{label}: the plain decode row ran {RT.decode_row.calls} times")
    print(f"main {label}: launches {json.dumps(launches)} (one kernel A, W and C and four "
          f"fit launches an encode batch, one count kernel an \"auto\" RGB encode batch, one kernel B a decode batch, one kernel W, 3 and V per non-empty wave of a "
          f"dense grid decode batch, one kernel D each other decode batch); plain decode "
          f"rows 0")
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
                desc += f", batch of {images} in one launch{' set' if name == 'fit_stats' else ''}"
            if name == "decode_scan_wave":
                desc += f" clusters {list(clusters)} (rule: {r['cluster']})"
            times = ""
            if timed:
                times = (f" kernel {r['ms']:.4f} ms (wrapper {r['wrapper_ms']:.4f}) plain "
                         f"{r['plain_ms']:.4f} ms bound {r['bound_ms']:.5f} ms")
                if "floor_ms" in r:
                    times += f" empty-launch floor {r['floor_ms']:.5f} ms"
                if "library_ms" in r:
                    times += f" library (the einsum chain) {r['library_ms']:.4f} ms"
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


class OpCount(TorchDispatchMode):
    """Counts the torch operators dispatched under it (views included)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def decode_launches(blob: bytes, dev) -> tuple:
    """One decode of `blob`: the launches of the port's kernels (their
    counters; zeroed first) and the torch operators it dispatches."""
    zero_counts()
    with OpCount() as ops:
        frave_tpu_torch.decode(blob, device="cuda")
    sync(dev)
    return {n: fn.launches for n, fn in WRAPPERS.items() if fn.launches}, ops.n


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
    for n, k in read_counts(label, 2, 1, waves, choices=1).items():
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


def wave_designs(dev) -> None:
    """Kernel V's two walks of a wave (schedule and slot order), each
    bit-equal to its plain version, on waves from the smallest to the
    largest at 2048x2048 RGB and at B = 64 256x256 gray, and the store
    sectors a warp of its largest wave touches either way."""
    for label, shape, images in (("2048x2048 RGB", (2048, 2048, 3), 0),
                                 (f"{BATCH}x 256x256 gray", (*GRAY, 1), BATCH)):
        rows = kernel_check.finish_orders_ms(shape, dev, images, count=4)
        print(f"kernel wave_finish {label} device ms by walk (rule: slot order from "
              f"{WC.SLOT_ORDER_MIN} pairs): " + json.dumps(rows))
        sectors = kernel_check.finish_sectors(kernel_check.program(*shape, dev))
        print(f"kernel wave_finish {label} largest wave: distinct 32-byte sectors a warp "
              f"touches {json.dumps(sectors)}")


def w_stats_check(label: str, shape, images: int, dev, checks: dict) -> None:
    """Kernel W's statistics (the encode mode) against its plain version on
    a step-tensor program (shape (h, w, c, mode)), on an image's
    coefficients (timed) and on garbage, bit-equal."""
    for kind in kernel_check.DECODE_KINDS:
        r = kernel_check.check("wave_contexts", shape, dev, seed=7, timed=kind == "valid",
                               kind=("encode", kind), images=images)
        times = ""
        if r["ms"] is not None:
            times = (f" kernel {r['ms']:.4f} ms (wrapper {r['wrapper_ms']:.4f}) plain "
                     f"{r['plain_ms']:.4f} ms bound {r['bound_ms']:.5f} ms empty-launch floor "
                     f"{r['floor_ms']:.5f} ms")
        print(f"kernel wave_contexts {label} statistics {kind}: max_abs_err "
              f"{r['max_abs_err']}{times}")
        if r["max_abs_err"] != 0:
            raise AssertionError(f"{label}: wave_contexts disagrees with its plain version")
        checks.setdefault("wave_contexts", []).append(r)


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
    for n, k in read_counts(lab, 3, 3, 0, 3, choices=3 if c == 3 else 0).items():
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
    w_stats_check(lab, (h, w, c, mode), 0, dev, checks)
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
    w_stats_check(lab, (*GRAY, 1, "parity"), E_BATCH, dev, checks)


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
            for n, k in read_counts(lab, 3, 3, waves, 0 if dense else 3,
                                    choices=3 if c == 3 else 0).items():
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


def path_e(dev, totals, oracle, refs, floor, checks) -> tuple:
    """The step-tensor codec at full width (e1-e6); returns the oracle's
    rejections of e5 and the e1 and e2 containers."""
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
    return rejected, blobs


# ---------------------------------------------------------------- path f


def same_fields(label: str, a, b) -> None:
    """Every field of dataclasses a and b equal: arrays by dtype, shape and
    value, lists element by element, the rest by ==."""
    def equal(x, y):
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            return (isinstance(x, np.ndarray) and isinstance(y, np.ndarray)
                    and x.dtype == y.dtype and np.array_equal(x, y))
        return x == y

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        xs, ys = (x, y) if isinstance(x, list) else ([x], [y])
        if len(xs) != len(ys) or not all(equal(p, q) for p, q in zip(xs, ys)):
            raise AssertionError(f"{label}: field {f.name} differs")


def timed(fn):
    t = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t


def path_f_native(h: int, w: int) -> dict:
    """f1: the native host library at h x w, cold (the builders, not the
    caches paths a-e filled): the geometry by the native builder and by
    build_geometry_fast, every field bit-equal; the grid lattice build;
    the parity schedule with the native layering and with the numpy one,
    every field bit-equal. Returns the seconds of each."""
    lab = f"f1 {w}x{h}"
    nat, t_nat = timed(lambda: N.build_geometry_native(h, w, BASE_FRAC_DEPTH))
    ref, t_np = timed(lambda: GF.build_geometry_fast(h, w, BASE_FRAC_DEPTH))
    same_fields(f"{lab} geometry", nat, ref)
    del ref
    _, t_lat = timed(lambda: LT.build_lattice_grids(nat))
    par_nat, t_par_nat = timed(lambda: S.build_schedule(nat, "parity"))
    layer = S._layer_waves
    S._layer_waves = S.layer_waves_plain
    try:
        par_np, t_par_np = timed(lambda: S.build_schedule(nat, "parity"))
    finally:
        S._layer_waves = layer
    same_fields(f"{lab} parity schedule", par_nat, par_np)
    out = {"geometry_native": t_nat, "geometry_numpy": t_np, "lattice": t_lat,
           "parity_schedule_native": t_par_nat, "parity_schedule_numpy": t_par_np}
    print(f"main {lab}: native geometry bit-equal to build_geometry_fast ({nat.num_tiles} "
          f"tiles), the parity schedule with the native layering bit-equal to the numpy "
          f"layering's ({par_nat.num_symbols} symbols, {len(par_nat.wave_sizes)} waves)")
    print(f"report {lab} host build s (cold, one process): native library build "
          f"{N.build_seconds if N.build_seconds is not None else 'cached'}; "
          + json.dumps({k: round(v, 3) for k, v in out.items()}))
    return out


def run_cli(group, cwd) -> dict:
    """Fresh processes running the CLI (CLI_RUNNER) in `cwd`, one for each
    (label, args, want) of `group`, all started together; each must exit 0
    with exactly the launch counts `want` (a kernel not named: 0). Returns
    {label: wall seconds}."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [HERE] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", CLI_RUNNER, *map(str, args)], cwd=cwd,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _, args, _ in group]
    walls, failed = {}, []
    for (label, args, want), proc in zip(group, procs):
        try:
            _, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
        walls[label] = time.perf_counter() - t
        cmd = f"`fri {' '.join(map(str, args))}`"
        if proc.returncode != 0:
            failed.append(f"{label}: {cmd} exited {proc.returncode}:\n{err[-3000:]}")
            continue
        launches = json.loads(err.strip().splitlines()[-1])
        expect = {n: want.get(n, 0) for n in WRAPPERS}
        if launches != expect:
            failed.append(f"{label}: {cmd} launches {launches}, expected {expect}")
    if failed:
        raise AssertionError("\n".join(failed))
    return walls


def cli_in_process(label: str, args) -> tuple:
    """CLI.main(args) in this process -> (stdout lines, seconds); fails
    unless it returns 0."""
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = CLI.main([str(a) for a in args])
    secs = time.perf_counter() - t
    if rc != 0:
        raise AssertionError(f"{label}: `fri {' '.join(map(str, args))}` returned {rc}")
    return buf.getvalue().splitlines(), secs


def path_f_cli(dev, tmp, totals: dict, big_blob: bytes) -> dict:
    """f2: the CLI at full width, each command in a fresh process with its
    launch counts checked: F_GRID encoded (byte-equal to 3c's in-process
    container), decoded (the input) and decoded with --backend native (the
    input, no kernel); F_PARITY encoded with --mode parity (byte-equal to
    the in-process encode) and decoded (the input). Returns the walls."""
    dflag = [] if dev.type == "cuda" else ["--device", "cpu"]
    grid_px, par_px = natural_image(*F_GRID), natural_image(*F_PARITY)
    np.save(tmp / "grid.npy", grid_px)
    np.save(tmp / "parity.npy", par_px)
    waves = kernel_check.grid_shapes(*F_GRID[:3])["waves"]
    enc = {"forward_lift_quantize_pixels": 1, "encode_scan": 1, "wave_contexts": 1,
           "transform_counts": 1, "fit_stats": kernel_check.FIT_LAUNCHES["none"]}
    # the grid encode and decode each alone (their walls are the cold
    # starts), then the native decode beside the parity encode
    groups = [
        [("grid encode", ["encode", "grid.npy", "-o", "grid.frv"], enc)],
        [("grid decode", ["decode", "grid.frv", "-o", "grid_out.npy"],
          {"dequantize_inverse_lift_pixels": 1, "decode_scan_wave": waves,
           "wave_contexts": waves, "wave_finish": waves})],
        [("grid decode --backend native (beside the parity encode)",
          ["decode", "grid.frv", "-o", "grid_native.npy", "--backend", "native"], {}),
         ("parity encode (beside the native decode)",
          ["encode", "parity.npy", "-o", "parity.frv", "--mode", "parity"], enc)],
        [("parity decode", ["decode", "parity.frv", "-o", "parity_out.npy"],
          {"dequantize_inverse_lift_pixels": 1, "decode_steps": 1})],
    ]
    walls = {}
    for group in groups:
        walls.update(run_cli([(f"f2 {label}", args + dflag, want) for label, args, want in group],
                             tmp))
        for _, _, want in group:
            for n, k in want.items():
                totals[n] += k
    if (tmp / "grid.frv").read_bytes() != big_blob:
        raise AssertionError("f2: the CLI's grid container differs from the in-process encode")
    par_blob = frave_tpu_torch.encode(par_px, EncoderOptions(mode="parity"), device=dev)
    if (tmp / "parity.frv").read_bytes() != par_blob:
        raise AssertionError("f2: the CLI's parity container differs from the in-process encode")
    for name, px in (("grid_out", grid_px), ("grid_native", grid_px), ("parity_out", par_px)):
        if not np.array_equal(np.load(tmp / f"{name}.npy"), px):
            raise AssertionError(f"f2: {name}.npy is not the input")
    print(f"main f2 CLI: {F_GRID[1]}x{F_GRID[0]} RGB grid and {F_PARITY[1]}x{F_PARITY[0]} RGB "
          "parity encode -> decode in fresh processes, each container byte-equal to the "
          "in-process encode, each decode (the native codec's too) the input; launches as "
          "expected in each process")
    print("report f2 CLI fresh-process wall s (the user's cold start: interpreter, imports, "
          "CUDA context, program build, the call): "
          + json.dumps({k[3:]: round(v, 3) for k, v in walls.items()}))
    return walls


def path_f_bench(dev, tmp, totals: dict) -> None:
    """f3: `fri bench` over F_BENCH's .npy files, in this process: exit 0,
    every image lossless, one kernel A, C and B launch a file and kernel 3
    once per non-empty wave."""
    corpus = tmp / "corpus"
    corpus.mkdir()
    want = {"encodes": 0, "waves": 0, "choices": 0}
    for (h, w, c), count in F_BENCH:
        for i in range(count):
            np.save(corpus / f"{w}x{h}x{c}_{i}.npy", natural_image(h, w, c, 500 + i))
        want["encodes"] += count
        want["choices"] += count if c == 3 else 0
        want["waves"] += count * kernel_check.grid_shapes(h, w, c)["waves"]
    dflag = [] if dev.type == "cuda" else ["--device", "cpu"]
    zero_counts()
    lines, secs = cli_in_process("f3 bench", ["bench", corpus, "-o", tmp / "bench_out", *dflag])
    sync(dev)
    for n, k in read_counts("f3 bench", want["encodes"], want["encodes"],
                            want["waves"], choices=want["choices"]).items():
        totals[n] += k
    for line in lines:
        print(f"report f3 bench: {line}")
    print(f"main f3 bench: exit 0 over {want['encodes']} .npy images ({secs:.3f} s)")


def path_f_optimize(dev, tmp, totals: dict) -> None:
    """f4: the quality sweep at F_SWEEP; the predictor search at F_SEARCH
    on the card and on the CPU (same scores, same best vector); then over
    F_SEARCH_CARD on the card through the CLI, timed."""
    dflag = [] if dev.type == "cuda" else ["--device", "cpu"]
    h, w, c, seed = F_SWEEP
    np.save(tmp / "sweep.npy", natural_image(h, w, c, seed))
    zero_counts()
    lines, secs = cli_in_process("f4 sweep", ["optimize", tmp / "sweep.npy", *dflag])
    sync(dev)
    for n, k in read_counts("f4 sweep", 4, 4, 4 * kernel_check.grid_shapes(h, w, c)["waves"]
                            ).items():
        totals[n] += k
    for line in lines:
        print(f"report f4 sweep: {line}")
    (h, w, c, seed), n_cands = F_SEARCH
    img = RasterImage.from_array(natural_image(h, w, c, seed))
    cands = CLI.find_predictor_vectors(n_cands)
    zero_counts()
    (best, res), t_dev = timed(lambda: CLI.search_predictors(img, cands, device=dev))
    sync(dev)
    got = {n: fn.launches for n, fn in WRAPPERS.items()}
    runs = got["forward_lift_quantize_pixels"]
    fits = kernel_check.FIT_LAUNCHES["vp"] * runs  # the search pins the value parameters
    if dev.type == "cuda" and (runs < n_cands or got != {**{n: 0 for n in got},
                                                         "forward_lift_quantize_pixels": runs,
                                                         "encode_scan": runs,
                                                         "wave_contexts": runs,
                                                         "fit_stats": fits}):
        raise AssertionError(f"f4 search: launches {got}, expected one A, W and C and two fit "
                             "launches an encode")
    for n, k in got.items():
        totals[n] += k
    (best_cpu, res_cpu), t_cpu = timed(lambda: CLI.search_predictors(img, cands, device="cpu"))
    if not np.array_equal(best, best_cpu) or [(s, tuple(v)) for s, _, v in res] != [
            (s, tuple(v)) for s, _, v in res_cpu]:
        raise AssertionError("f4 search: the card's and the CPU's searches disagree")
    print(f"main f4 search {w}x{h}: {n_cands} vectors, the card's scores and best vector "
          f"{best.astype(int).tolist()} equal the CPU's (card {t_dev:.3f} s, CPU {t_cpu:.3f} s; "
          f"bytes card {[b for _, b, _ in res[:3]]}, CPU {[b for _, b, _ in res_cpu[:3]]})")
    (h, w, c, seed), n_cands = F_SEARCH_CARD
    np.save(tmp / "search.npy", natural_image(h, w, c, seed))
    lines, secs = cli_in_process("f4 search", ["optimize", tmp / "search.npy",
                                               "--search-predictors", "--search-limit",
                                               n_cands, *dflag])
    for line in lines:
        print(f"report f4 search: {line}")
    print(f"report f4 search {w}x{h} over {n_cands} vectors: {secs:.3f} s "
          f"({secs / n_cands * 1e3:.1f} ms a trial encode)")


def path_f_observe(dev, tmp, totals: dict) -> None:
    """f5: an encode records encode/bpp and the residual means, a verbose
    one the context entropies; a profiling.trace around one F_TRACE encode
    and decode writes a trace naming the port's kernels (F_KERNELS)."""
    m = get_metrics()
    px = natural_image(256, 256, 1, 1)
    m.reset()
    frave_tpu_torch.encode(px, device=dev)
    snap = m.snapshot()
    if "encode/bpp" not in snap or "encode/mean_abs_residual_ch0" not in snap:
        raise AssertionError(f"f5: an encode recorded only {sorted(snap)}")
    m.reset()
    with contextlib.redirect_stdout(io.StringIO()):
        frave_tpu_torch.encode(px, EncoderOptions(verbose=True), device=dev)
    m.verbose = False
    ents = [n for n in m.snapshot() if n.startswith("encode/context_entropy_ch0_")]
    if not ents:
        raise AssertionError("f5: a verbose encode recorded no context entropy")
    print(f"main f5 metrics: encode/bpp {snap['encode/bpp'][0]:.4f}, mean |residual| "
          f"{snap['encode/mean_abs_residual_ch0'][0]:.4f}; verbose: {len(ents)} context "
          "entropies")
    m.reset()
    tpx = natural_image(*F_TRACE)
    zero_counts()
    with profiling.trace(str(tmp / "trace"), device=dev):
        blob = frave_tpu_torch.encode(tpx, device=dev)
        out = frave_tpu_torch.decode(blob, device=dev).data
        sync(dev)
    for n, k in read_counts("f5 traced", 1, 1,
                            kernel_check.grid_shapes(*F_TRACE[:3])["waves"], choices=1).items():
        totals[n] += k
    if not np.array_equal(out, tpx):
        raise AssertionError("f5: the traced round trip is not lossless")
    (path,) = (tmp / "trace").iterdir()
    events = json.loads(path.read_text())["traceEvents"]
    kern = {}
    for e in events:
        if e.get("cat") == "kernel":
            kern[e["name"]] = kern.get(e["name"], 0.0) + float(e.get("dur", 0.0))
    if dev.type == "cuda":
        missing = [k for k in F_KERNELS if not any(k in n for n in kern)]
        if missing:
            raise AssertionError(f"f5: the trace names no kernel like {missing} "
                                 f"({len(kern)} kernel names)")
        ours = {n: round(us, 1) for n, us in kern.items() if any(k in n for k in F_KERNELS)}
        print(f"main f5 trace ({path.stat().st_size} B, {len(events)} events, {len(kern)} "
              f"kernel names): the port's kernels' device us " + json.dumps(ours))


def path_f(dev, totals: dict, big_blob: bytes) -> None:
    """The host surfaces (f1-f5)."""
    t0 = time.perf_counter()
    path_f_native(*F_GRID[:2])
    with tempfile.TemporaryDirectory(prefix="frave_smoke_f_") as d:
        tmp = Path(d)
        path_f_cli(dev, tmp, totals, big_blob)
        path_f_bench(dev, tmp, totals)
        path_f_optimize(dev, tmp, totals)
        path_f_observe(dev, tmp, totals)
    print(f"phase main host surfaces (path f) took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------- path g


G_RANKS = 2  # ranks of g1's gloo world (and g3's), all on the one card
G_DP = 4  # g1's ShardedDecoder batch: 768x512 RGB images
G_CORPUS = ((256, 256, 1), 6)  # g3's .npy corpus: image shape, images
G_TIMEOUT = 600  # seconds a world of path g may take
# g0's problems: 3T on the largest grid wave of each image (2048x2048 RGB,
# 768x512 RGB, 256x256 gray), DT on e1's parallel, e2's parity and e3's
# gray parity programs; (kernel, shape, kinds, every design or the rule and
# one block with the tables by threads alone)
G_TP_CASES = (
    ("tp_decode_row", (2048, 2048, 3), ("valid", "garbage"), True),
    ("tp_decode_row", (512, 768, 3), ("valid",), False),
    ("tp_decode_row", (256, 256, 1), ("valid",), False),
    ("tp_decode_step", (2048, 2048, 3, "parallel"), ("valid", "garbage"), True),
    ("tp_decode_step", (512, 768, 3, "parity"), ("valid", "garbage"), True),
    ("tp_decode_step", (256, 256, 1, "parity"), ("valid",), False),
)
# the shapes of the kernels line (3T on the 2048x2048 RGB wave,
# DT on e2's program)
G_LINE = {"tp_decode_row": (2048, 2048, 3), "tp_decode_step": (512, 768, 3, "parity")}
G_DEVICE, G_NCCL = "cuda", "nccl"  # the worlds' device and g2's backend


def g_kernels(dev, checks: dict) -> None:
    """Kernels 3T and DT chained over whole decodes with the lanes split
    over G_RANKS simulated ranks, against their plain versions chained the
    same way and against the one-card plain decode, bit-equal, at every
    case of G_TP_CASES: every design of kernel_check.TP_DESIGNS that the
    plan runs at the shape (the launch rule, one block, each cluster size,
    the tables by threads and by TMA, one block with the tables by
    threads), or the rule and the last; the valid problem timed per
    design (one launch's device ms and its empty launch's, beside the
    byte bound)."""
    for name, sh, kinds, every in G_TP_CASES:
        shape = kernel_check.grid_shapes(*sh)["wave"] if name == "tp_decode_row" else sh
        designs = (tuple(kernel_check.TP_DESIGNS) if every
                   else ("rule", "one block, tables by threads"))
        for kind in kinds:
            timed = kind == "valid"
            r = kernel_check.tp_check(name, shape, kind, dev, ranks=G_RANKS, timed=timed,
                                      designs=designs)
            plans = {d: (f"{p.variant} {p.cluster}x{p.per} {'TMA' if p.tma else 'threads'}"
                         if not isinstance(p, str) else f"refused ({p})")
                     for d, p in r["plans"].items()}
            print(f"kernel {name} {tuple(shape)} {kind}: chained over {r['launches']} launches "
                  f"a rank on {G_RANKS} ranks, max_abs_err {r['max_abs_err']} against the "
                  f"chained plain version and the one-card plain decode at every design run; "
                  f"plans {json.dumps(plans)}")
            if timed:
                print(f"kernel {name} {tuple(shape)} one launch device ms by design (empty "
                      f"launch floor): " + json.dumps(
                          {d: [round(ms, 5), round(r['design_floor_ms'][d], 5)]
                           for d, ms in r["design_ms"].items()})
                      + f"; bound {r['bound_ms']:.5f} ms ({r['bytes']} B), plain "
                      f"{r['plain_ms']:.4f} ms")
            if r["max_abs_err"] != 0:
                raise AssertionError(f"{name} {shape} {kind}: kernel disagrees with its plain "
                                     f"version: {r['errs']}")
            if timed and sh == G_LINE[name]:
                r["line"] = True
            checks.setdefault(name, []).append(r)


def g_counts(label: str, legs: list, want: dict) -> dict:
    """Every rank's launch counts of one leg (each zeroed when the leg
    began) against `want` (the rest 0) and no plain decode row; returns
    the counts summed over the ranks."""
    total = {}
    for rank, leg in enumerate(legs):
        exp = {n: want.get(n, 0) for n in leg["launches"]}
        if leg["launches"] != exp or leg["plain_rows"]:
            raise AssertionError(f"{label} rank {rank}: launches {leg['launches']} (plain rows "
                                 f"{leg['plain_rows']}), expected {exp}")
        for n, k in leg["launches"].items():
            total[n] = total.get(n, 0) + k
    print(f"main {label}: launches a rank {json.dumps({n: k for n, k in want.items() if k})}, "
          "every other kernel 0, plain decode rows 0")
    return total


def g_exchange(label: str, leg: dict, phase: str) -> str:
    """The per-step exchange of a tp decode leg: its count and the median
    wall ms of one (the kernel's wait, the staging copies and the gather)."""
    secs = [s for c, s in zip(leg["collectives"], leg["collective_s"]) if c[4] == phase]
    return (f"{len(secs)} {phase} exchanges, median {1e3 * float(np.median(secs)):.4f} ms "
            f"(wall of the gather with its staging), {leg['wall_s']:.3f} s the decode")


def live_steps(blob: bytes, dev) -> int:
    """The non-empty steps of a step-tensor container's program."""
    im = deserialize(blob)
    m = im.metadata
    prog = PT.get_program(m.height, m.width, im.num_lanes, m.num_channels, dev, im.mode)
    return int((prog.steps.step_map[:, 2] > 0).sum())


def path_g(dev, big_px, big_blob, e_blobs, oracle, big_shapes, totals, checks) -> None:
    """The parallel layer (frave_tpu_torch.parallel) on the one card:
    g0 kernels 3T and DT against their plain versions (g_kernels); g1 a
    gloo world of G_RANKS ranks: ShardedEncoder (dp 1, tp G_RANKS) of the
    2048x2048 RGB image, byte-equal to the one-card container of 3c and
    decoded by the oracle, TPShardedDecoder of it (kernel 3T a row) and of
    e1's parallel and e2's parity containers (kernel DT a step), each the
    input, and ShardedDecoder over G_DP 768x512 RGB containers; g2 a
    1-rank NCCL world: the same encode and dp decode; g3 a 2-rank
    CorpusRunner over a .npy corpus, then a resume that re-encodes
    nothing. Every rank's launch counts are read back from its leg."""
    from frave_tpu_torch.parallel.multihost import merged_manifest
    from frave_tpu_torch.parallel.world import launch

    t0 = time.perf_counter()
    g_kernels(dev, checks)
    print(f"phase g kernels took {time.perf_counter() - t0:.1f} s")
    h, w, c = big_px.shape
    e2_px = natural_image(*REF_IMAGES[E_IMAGES[1][1]][:4])
    rgb = [natural_image(*RGB, 3, 30 + i) for i in range(G_DP)]
    with tempfile.TemporaryDirectory(prefix="frave_smoke_g_") as d:
        t = Path(d)
        np.save(t / "big.npy", big_px[None])
        for k in ("e1", "e2"):
            (t / f"{k}.frv").write_bytes(e_blobs[k])
        for i, px in enumerate(rgb):
            (t / f"rgb{i}.frv").write_bytes(frave_tpu_torch.encode(px, device=G_DEVICE))
        dp_leg = {"op": "dp_decode", "blobs": [str(t / f"rgb{i}.frv") for i in range(G_DP)],
                  "shape": (RGB[0], RGB[1], 3), "out": str(t / "dp.npy")}
        enc_leg = {"op": "encode", "images": str(t / "big.npy"), "out": str(t / "enc")}
        legs = [enc_leg,
                {"op": "tp_decode", "blob": str(t / "enc" / "0.frv"), "shape": (h, w, c),
                 "out": str(t / "tp_grid.npy")},
                {"op": "tp_decode", "blob": str(t / "e1.frv"), "shape": (h, w, c),
                 "out": str(t / "tp_e1.npy")},
                {"op": "tp_decode", "blob": str(t / "e2.frv"), "shape": e2_px.shape,
                 "out": str(t / "tp_e2.npy")},
                dp_leg]
        t1 = time.perf_counter()
        res = launch(G_RANKS, "frave_tpu_torch.parallel.dryrun:run_legs",
                     {"legs": legs, "dp": 1, "tp": G_RANKS}, backend="gloo",
                     device=G_DEVICE, timeout=G_TIMEOUT)
        g1_s = time.perf_counter() - t1
        per = list(zip(*res))  # per leg: every rank's result
        sharded = (t / "enc" / "0.frv").read_bytes()
        if sharded != big_blob:
            raise AssertionError("g1: the sharded 2048x2048 RGB container differs from the "
                                 "one-card container")
        if not np.array_equal(oracle.decode(sharded).reshape(big_px.shape), big_px):
            raise AssertionError("g1: the oracle does not decode the sharded container")
        for name, want in (("tp_grid", big_px), ("tp_e1", big_px), ("tp_e2", e2_px)):
            if not np.array_equal(np.load(t / f"{name}.npy"), want):
                raise AssertionError(f"g1: {name} does not decode to its image")
        if not np.array_equal(np.load(t / "dp.npy"), np.stack(rgb)):
            raise AssertionError("g1: the dp decode does not give the images")
        rows = big_shapes["grid"][0]
        rgb_waves = kernel_check.grid_shapes(*RGB, 3)["waves"]
        g_counts("g1 encode 2048x2048 RGB dp 1 x tp 2", per[0],
                 {"forward_lift_quantize_pixels": 1, "encode_scan": 1, "wave_contexts": 1})
        big_waves = big_shapes["waves"]
        tot = g_counts("g1 tp decode 2048x2048 RGB grid", per[1],
                       {"tp_decode_row": rows + 1, "dequantize_inverse_lift_pixels": 1,
                        "wave_contexts": big_waves, "wave_finish": big_waves})
        totals["tp_decode_row"] = tot["tp_decode_row"]
        steps = 0
        for k, leg in (("e1", per[2]), ("e2", per[3])):
            tot = g_counts(f"g1 tp decode {k}", leg,
                           {"tp_decode_step": live_steps(e_blobs[k], dev) + 1,
                            "dequantize_inverse_lift_pixels": 1})
            steps += tot["tp_decode_step"]
        totals["tp_decode_step"] = steps
        g_counts(f"g1 dp decode {G_DP}x 768x512 RGB", per[4],
                 {"decode_scan_wave": rgb_waves, "dequantize_inverse_lift_pixels": 1,
                  "wave_contexts": rgb_waves, "wave_finish": rgb_waves})
        r0 = res[0]
        print(f"main g1 gloo world of {G_RANKS} ranks: sharded encode byte-equal to the one-card "
              f"container ({len(sharded)} B, halo {r0[0]['halo']}), the oracle decodes it; tp "
              "decodes of it, e1 and e2 and the dp decode give their images")
        print(f"report g1 walls s: world {g1_s:.3f}; encode build {r0[0]['build_s']:.3f} encode "
              f"{r0[0]['encode_s']:.3f}; tp grid {r0[1]['wall_s']:.3f}, e1 {r0[2]['wall_s']:.3f}, "
              f"e2 {r0[3]['wall_s']:.3f}; dp decode {r0[4]['wall_s']:.3f} (rank 0, program "
              "builds included)")
        print(f"report g1 tp grid 2048x2048 RGB: {g_exchange('grid', r0[1], 'row')}")
        print(f"report g1 tp e1 parallel: {g_exchange('e1', r0[2], 'step')}")
        print(f"report g1 tp e2 parity: {g_exchange('e2', r0[3], 'step')}")
        enc_phases = {}
        for cl, sec in zip(r0[0]["collectives"], r0[0]["collective_s"]):
            enc_phases[cl[4]] = enc_phases.get(cl[4], 0.0) + sec
        print("report g1 encode collectives s by phase (rank 0): "
              + json.dumps({k: round(v, 4) for k, v in enc_phases.items()}))

        # g2: a one-rank NCCL world, the same encode and dp decode
        enc_leg["out"] = str(t / "enc_nccl")
        dp_leg["out"] = str(t / "dp_nccl.npy")
        t1 = time.perf_counter()
        res = launch(1, "frave_tpu_torch.parallel.dryrun:run_legs",
                     {"legs": [enc_leg, dp_leg], "dp": 1, "tp": 1},
                     backend=G_NCCL, device=G_DEVICE, timeout=G_TIMEOUT)
        g2_s = time.perf_counter() - t1
        if (t / "enc_nccl" / "0.frv").read_bytes() != big_blob:
            raise AssertionError("g2: the NCCL world's container differs from the one-card one")
        if not np.array_equal(np.load(t / "dp_nccl.npy"), np.stack(rgb)):
            raise AssertionError("g2: the NCCL dp decode does not give the images")
        g_counts("g2 nccl encode", [res[0][0]], {"forward_lift_quantize_pixels": 1,
                                                 "encode_scan": 1, "wave_contexts": 1})
        g_counts("g2 nccl dp decode", [res[0][1]], {"decode_scan_wave": rgb_waves,
                                                    "dequantize_inverse_lift_pixels": 1,
                                                    "wave_contexts": rgb_waves,
                                                    "wave_finish": rgb_waves})
        print(f"main g2 NCCL world of 1 rank: encode byte-equal, dp decode the images; world "
              f"{g2_s:.3f} s, encode {res[0][0]['encode_s']:.3f} s")

        # g3: the corpus runner, two ranks a host each, then a resume
        (shape, n) = G_CORPUS
        corpus = t / "corpus"
        corpus.mkdir()
        imgs = {}
        for i in range(n):
            px = natural_image(*shape[:2], shape[2], 40 + i)
            np.save(corpus / f"img{i}.npy", px[..., 0] if shape[2] == 1 else px)
            imgs[f"img{i}"] = px
        kw = {"corpus_dir": str(corpus), "output_dir": str(t / "corpus_out"), "batch_size": 2}
        t1 = time.perf_counter()
        first = launch(G_RANKS, "frave_tpu_torch.parallel.multihost:run_corpus", kw,
                       backend="gloo", device=G_DEVICE, timeout=G_TIMEOUT)
        g3_s = time.perf_counter() - t1
        again = launch(G_RANKS, "frave_tpu_torch.parallel.multihost:run_corpus", kw,
                       backend="gloo", device=G_DEVICE, timeout=G_TIMEOUT)
        merged = merged_manifest(str(t / "corpus_out"))
        if merged["num_done"] != n or merged["num_failed"] or sorted(merged["hosts"]) != [0, 1]:
            raise AssertionError(f"g3: merged manifest {merged['num_done']} done, "
                                 f"{merged['num_failed']} failed, hosts {merged['hosts']}")
        if [r["ts"] for r in again] != [r["ts"] for r in first]:
            raise AssertionError("g3: the resume re-encoded images")
        for stem, px in imgs.items():
            out = frave_tpu_torch.decode((t / "corpus_out" / f"{stem}.frv").read_bytes(),
                                         device=G_DEVICE).data
            if not np.array_equal(out, px):
                raise AssertionError(f"g3: {stem} does not decode to its image")
        print(f"main g3 CorpusRunner on {G_RANKS} ranks: {n} {shape} .npy images done, each "
              f"decodes to its image; the resume re-encodes none; run {g3_s:.3f} s")
    print(f"phase main parallel layer (path g) took {time.perf_counter() - t0:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {card}")
    t_start = time.perf_counter()

    # ---- 1. build: nvcc per kernel source and g++ on the native host
    # library, together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        native = pool.submit(N.get_lib)
        _build.load_library()
        native.result()
    oracle = Oracle()
    print(f"build: {time.perf_counter() - t0:.3f} s (nvcc "
          f"{_build.build_seconds if _build.build_seconds is not None else 'cached'}; "
          f"g++ {N.build_seconds if N.build_seconds is not None else 'cached'}: "
          f"{N.library_path().name})")
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
        # W on the image's program: its largest decode wave and its
        # statistics, on its coefficients (timed) and on garbage; V on the
        # largest wave
        for mode in kernel_check.WAVE_MODES:
            for pk in kernel_check.DECODE_KINDS[::-1]:
                plan["wave_contexts"].append((px.shape, (mode, pk), pk == "valid", (0,), 0))
        for pk in kernel_check.DECODE_KINDS[::-1]:
            plan["wave_finish"].append((px.shape, pk, pk == "valid", (0,), 0))
    # the transform choice's counts: 768x512 and 2048x2048 RGB (stride 4)
    # alone, lossless (timed) and lossy; 768x512 at B = 8, timed last (the
    # kernels line reports it)
    for label in (big_label, "768x512 RGB"):
        for q in kernel_check.QDIV_KINDS:
            plan["transform_counts"].append((all_images[label].shape[:2], q, q == "lossless",
                                             (0,), 0))
    plan["transform_counts"].append((RGB, "lossless", True, (0,), 8))
    # the predictor fits at the cells' shapes, timed (2048x2048 RGB last:
    # the kernels line reports it); pinned parameters on 768x512 RGB
    plan["fit_stats"] = [((*GRAY, 1), ("valid", "none"), True, (0,), n) for n in (0, BATCH)]
    plan["fit_stats"] += [((*RGB, 3), kind, kind[1] == "none", (0,), n)
                          for kind in (("valid", "none"), ("stripes", "vp"), ("noise", "vpwp"))
                          for n in (0, 8)]
    plan["fit_stats"].append((all_images[big_label].shape, ("valid", "none"), True, (0,), 0))
    # whole batches in one launch: 768x512 RGB at B = 4 and kernel 3 with
    # more clusters than are resident, untimed; then 256x256 gray at
    # B = 64, bench.py's batch, timed last (the kernels line reports it)
    for (h, w, c), nimg, timed in (((512, 768, 3), 4, False), ((*GRAY, 1), BATCH, True)):
        sh = kernel_check.grid_shapes(h, w, c)
        plan["forward_lift_quantize_pixels"].append(((h, w, c), (1, "lossless"), timed, (0,), nimg))
        plan["dequantize_inverse_lift_pixels"].append(((h, w, c), 0, timed, (0,), nimg))
        plan["encode_scan"].append((sh["grid"], None, timed, (0,), nimg))
        for mode in kernel_check.WAVE_MODES[::-1]:
            plan["wave_contexts"].append(((h, w, c), (mode, "valid"), timed, (0,), nimg))
        plan["wave_finish"].append(((h, w, c), "valid", timed, (0,), nimg))
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
    for name in kernel_check.WAVE_KERNELS:  # the B = 64 batch's decode wave: the kernels line's
        checks[name][-1]["line"] = True
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
    wave_designs(dev)
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
    choices = reps * sum(px.shape[2] == 3 for px in images.values())
    for n, k in read_counts("lossless 256x256 gray + 768x512 RGB", trips, trips, waves,
                            choices=choices).items():
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
    for n, k in read_counts(big_label, reps, reps, reps * shapes[big_label]["waves"],
                            choices=reps).items():
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
    rejected, e_blobs = path_e(dev, totals, oracle, refs, floor, checks)
    print(f"phase main steps done at {time.perf_counter() - t_start:.1f} s")

    # ---- 3f. the host surfaces
    path_f(dev, totals, big_blob)
    print(f"phase main host surfaces done at {time.perf_counter() - t_start:.1f} s")

    # ---- 3g. the parallel layer
    path_g(dev, big_px, big_blob, e_blobs, oracle, shapes[big_label], totals, checks)
    print(f"phase main parallel layer done at {time.perf_counter() - t_start:.1f} s")

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
        ours, ops = decode_launches(blob, dev)
        print(f"report {label}: one grid decode launches {json.dumps(ours)} of the port's "
              f"kernels ({sum(ours.values())}) and dispatches {ops} torch operators")
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
                 "bound_by": "bytes", "library_ms": at.get("library_ms"), "shape": at["shape"],
                 "images": at["images"]}
        if name in kernel_check.CLUSTERED:
            entry["cluster"] = at["cluster"]
        if name == "decode_steps":
            entry.update({k: at[k] for k in ("variant", "per", "prefetch", "steps",
                                             "exchange_floor_ms", "step_floor_ms")})
        if name in kernel_check.WAVE_KERNELS:
            entry.update({"kind": at["kind"], "floor_ms": at["floor_ms"]})
        kernels.append(entry)
    for name, (_, _, src, replaces) in kernel_check.TP_KERNELS.items():
        rs = checks[name]
        at = [r for r in rs if r.get("line")][0]
        plan = at["plans"]["rule"]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": totals[name],
                        "max_abs_err": max(r["max_abs_err"] for r in rs),
                        "ms": at["ms"], "plain_ms": at["plain_ms"], "bound_ms": at["bound_ms"],
                        "bound_by": "bytes", "library_ms": None, "shape": at["shape"],
                        "ranks": at["ranks"], "variant": plan.variant, "cluster": plan.cluster,
                        "tma": plan.tma, "floor_ms": at["floor_ms"]})
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
