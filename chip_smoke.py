#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (frave_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reporting on its own lines; any failed check raises and the
script exits nonzero without printing a result:

  1. build   — compile the CUDA kernels (frave_tpu_torch/csrc) with nvcc;
  2. kernels — each kernel against its plain PyTorch version on the same
               card tensors at the slice's shapes: bit-equal, median time
               of 20 launches each (CUDA events);
  3. main    — the port's public encode -> decode at 256x256 gray and
               768x512 RGB (seeded natural-statistics images): lossless,
               every kernel launched, containers cross-decoded with
               frave_tpu's numpy backend both ways, a numpy re-encode with
               the port's parameters pinned compared byte for byte, and
               the golden v9 grid fixtures decoded;
  4. report  — encode/decode ms and MP/s, per-stage ms, peak device
               memory, the card's name and power limit, then one JSON
               line of kernels and, last, the result line.

Needs CUDA (exits 1 without it) and imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

import frave_tpu_torch
from frave_tpu import EncoderOptions, RasterImage
from frave_tpu.codec.container import SerializeError, deserialize, serialize
from frave_tpu.codec.pipeline_np import decode_pipeline_np, encode_pipeline_np
from frave_tpu.entropy.tables import (
    ENC_FREQ_BITS_CAP,
    MIN_FREQ_BITS,
    _GRID_LOG2,
    _LAPLACE_GRID_ROWS,
)
from frave_tpu.fractal.schedule import default_num_lanes, get_schedule, grid_row_lane
from frave_tpu_torch import kernel_check
from frave_tpu_torch.codec import pipeline_torch as PT
from frave_tpu_torch.ops import _build

HERE = os.path.dirname(os.path.abspath(__file__))


def natural_image(h: int, w: int, c: int, seed: int) -> np.ndarray:
    """Seeded photo-like content: smooth illumination, edges, a
    random-walk texture and sensor noise, channels correlated as in RGB
    photographs."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    light = 110 + 60 * np.sin(xx / 97.0 + 0.7) * np.cos(yy / 73.0)
    edges = 40.0 * ((xx + 0.6 * yy) % 181 < 90) - 25.0 * ((yy - 0.3 * xx) % 127 < 40)
    texture = np.cumsum(rng.normal(0, 1.2, (h, w)), axis=1)
    texture -= texture.mean(axis=1, keepdims=True)
    base = light + edges + texture
    planes = []
    for k in range(c):
        gain = (1.0, 0.92, 0.81)[k]
        offset = (0.0, 8.0, -12.0)[k]
        planes.append(gain * base + offset + rng.normal(0, 2.0, (h, w)))
    return np.clip(np.stack(planes, axis=-1), 0, 255).astype(np.uint8)


def scale_gains(hist: np.ndarray, idx: int):
    """(f32 host-formula gain, f64 gain) of grid scale `idx` for one
    context histogram (entropy/tables.select_scale)."""
    tot = int(hist.sum())
    bits = max(MIN_FREQ_BITS, min(tot.bit_length() - 1, ENC_FREQ_BITS_CAP))
    b = bits - MIN_FREQ_BITS
    data = (hist > 0)
    zero = _LAPLACE_GRID_ROWS[idx, b] == 0
    g32 = np.float32(_GRID_LOG2[idx, b] @ hist.astype(np.float32)) - np.float32(16.0) * np.float32(
        zero.astype(np.float32) @ data.astype(np.float32)
    )
    g64 = float(_GRID_LOG2[idx, b].astype(np.float64) @ hist.astype(np.float64)) - 16.0 * float(
        (zero & data).sum()
    )
    return float(g32), g64


def compare_pinned(label, img, blob_port, hist, device):
    """Re-encode on frave_tpu's numpy backend with the port's parameters
    and lane count pinned; the containers must be byte-equal, except
    where the encode-only Laplace scale index legitimately differs:
      * empty contexts (no symbol coded): the host keeps the bucket's own
        row, the device twins (jax, the port) row 0 — the stream does not
        depend on it, so after taking the port's (bits, scale) for those
        contexts the bytes must match;
      * near-ties of the scale gains, chosen in f32 by the host and
        exactly by the port: printed with both gains; both containers
        must then decode to identical pixels on both sides."""
    ci_p = deserialize(blob_port)
    C = img.metadata.num_channels
    vp = np.stack([ci_p.channel_data[c].value_prediction_parameters for c in range(C)])
    wp = np.stack([ci_p.channel_data[c].width_prediction_parameters for c in range(C)])
    opts = EncoderOptions(
        backend="numpy", num_lanes=ci_p.num_lanes,
        value_prediction_params=vp, width_prediction_params=wp,
    )
    blob_np = serialize(encode_pipeline_np(img, opts))
    if blob_np == blob_port:
        print(f"main {label}: pinned numpy re-encode byte-equal ({len(blob_np)} B)")
        return
    ci_n = deserialize(blob_np)
    empty, ties = 0, []
    for c in range(C):
        for k, (tp, tn) in enumerate(
            zip(ci_p.channel_data[c].ans_contexts, ci_n.channel_data[c].ans_contexts)
        ):
            if tp.scale_idx == tn.scale_idx:
                continue
            if hist[c, k].sum() == 0:
                tn.scale_idx, tn.max_freq_bits = tp.scale_idx, tp.max_freq_bits
                empty += 1
            else:
                gp, gn = scale_gains(hist[c, k], tp.scale_idx), scale_gains(hist[c, k], tn.scale_idx)
                ties.append((c, k, tp.scale_idx, tn.scale_idx, gp, gn))
    for c, k, sp, sn, gp, gn in ties:
        print(
            f"main {label}: scale near-tie ch{c} ctx{k}: port picks {sp} "
            f"(gain f32 {gp[0]!r}, f64 {gp[1]!r}), numpy picks {sn} "
            f"(gain f32 {gn[0]!r}, f64 {gn[1]!r})"
        )
    if not ties:
        if serialize(ci_n) != blob_port:
            raise AssertionError(f"{label}: pinned numpy container differs from the port's")
        print(
            f"main {label}: pinned numpy re-encode byte-equal after taking the "
            f"port's row for {empty} empty context(s) ({len(blob_port)} B)"
        )
        return
    ref = img.data
    for name, blob in (("port", blob_port), ("numpy", blob_np)):
        out_n = decode_pipeline_np(deserialize(blob)).data
        out_p = frave_tpu_torch.decode(blob, device=device).data
        if not (np.array_equal(out_n, ref) and np.array_equal(out_p, ref)):
            raise AssertionError(f"{label}: {name} container does not cross-decode")
    print(f"main {label}: {len(ties)} scale near-tie(s); both containers cross-decode")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    # ---- 1. build
    t0 = time.perf_counter()
    _build.load_library()
    print(
        f"build: {time.perf_counter() - t0:.3f} s "
        f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'})"
    )

    # ---- 2. kernels against their plain versions on the card
    shapes = {
        "forward_lift_quantize": [(160, 160), (2532, 844)],
        "dequantize_inverse_lift": [(160, 160), (2532, 844)],
        "encode_scan": [],  # filled from the programs below (real grids)
    }
    images = {
        "256x256 gray": natural_image(256, 256, 1, seed=1),
        "768x512 RGB": natural_image(512, 768, 3, seed=2),
    }
    for px in images.values():
        h, w, c = px.shape
        sched = get_schedule(h, w, mode="grid")
        nl = default_num_lanes(sched.num_symbols)
        shapes["encode_scan"].append((grid_row_lane(sched, nl)[2], c, nl))
    checks = {}
    for name, shs in shapes.items():
        for sh in shs:
            r = kernel_check.check(name, sh, dev, seed=7, timed=True)
            print(
                f"kernel {name} {tuple(sh)}: max_abs_err {r['max_abs_err']} "
                f"kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms"
            )
            if r["max_abs_err"] != 0:
                raise AssertionError(f"{name} {sh}: kernel disagrees with its plain version")
            checks.setdefault(name, []).append(r)

    # ---- 3. main path: warm-up (builds the programs), then the counted run
    cold = {}
    for label, px in images.items():
        t = time.perf_counter()
        blob = frave_tpu_torch.encode(px, device="cuda")
        t_enc = time.perf_counter() - t
        t = time.perf_counter()
        frave_tpu_torch.decode(blob, device="cuda")
        cold[label] = (t_enc, time.perf_counter() - t)
        print(f"main {label}: first call (program build included) encode {t_enc:.3f} s "
              f"decode {cold[label][1]:.3f} s")

    wrappers = {n: k[0] for n, k in kernel_check.KERNELS.items()}
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    reps = 3
    runs = {}
    for label, px in images.items():
        enc_s, dec_s = [], []
        for _ in range(reps):
            torch.cuda.synchronize(dev)
            t = time.perf_counter()
            blob = frave_tpu_torch.encode(px, device="cuda")
            enc_s.append(time.perf_counter() - t)
            t = time.perf_counter()
            out = frave_tpu_torch.decode(blob, device="cuda")
            torch.cuda.synchronize(dev)
            dec_s.append(time.perf_counter() - t)
            if not np.array_equal(out.data, px.reshape(out.data.shape)):
                raise AssertionError(f"{label}: port round trip is not lossless")
        runs[label] = (blob, float(np.median(enc_s)), float(np.median(dec_s)))
    launches = {n: fn.launches for n, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    for n, k in launches.items():
        if k <= 0:
            raise AssertionError(f"kernel {n} was not launched on the main path")
    print(f"main: launches on the main path {json.dumps(launches)}")

    for label, px in images.items():
        blob = runs[label][0]
        img = RasterImage.from_array(px)
        if not np.array_equal(decode_pipeline_np(deserialize(blob)).data, img.data):
            raise AssertionError(f"{label}: numpy backend does not decode the port's container")
        nblob = serialize(encode_pipeline_np(img, EncoderOptions(backend="numpy")))
        if not np.array_equal(frave_tpu_torch.decode(nblob, device="cuda").data, img.data):
            raise AssertionError(f"{label}: the port does not decode a numpy container")
        print(f"main {label}: lossless; cross-decodes with the numpy backend both ways "
              f"({len(blob)} B, {8.0 * len(blob) / (px.shape[0] * px.shape[1]):.4f} bpp)")
        _, (_, hist), _, _ = PT._encode_dispatch(img, EncoderOptions(), "cuda")
        compare_pinned(label, img, blob, hist.cpu().numpy(), "cuda")

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

    # ---- 4. report
    for label, px in images.items():
        mp = px.shape[0] * px.shape[1] / 1e6
        _, te, td = runs[label]
        print(f"report {label}: encode {te * 1e3:.3f} ms ({mp / te:.3f} MP/s) "
              f"decode {td * 1e3:.3f} ms ({mp / td:.3f} MP/s), median of {reps}")
        img = RasterImage.from_array(px)
        st_e = PT.StageTimes(dev)
        ci = PT.encode_pipeline_torch(img, EncoderOptions(), "cuda", stages=st_e)
        st_d = PT.StageTimes(dev)
        PT.decode_pipeline_torch(ci, "cuda", stages=st_d)
        stages = {k: round(v, 3) for k, v in {**st_e.ms, **st_d.ms}.items()}
        print(f"report {label} stages ms: {json.dumps(stages)}")
    print(f"report peak device memory: {peak} B (torch.cuda.max_memory_allocated)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    if "jax" in sys.modules:
        raise AssertionError("the smoke imported jax")

    kernels = []
    for name, (_, _, src, replaces) in kernel_check.KERNELS.items():
        rs = checks[name]
        at = rs[-1]  # times at the 768x512 RGB shape
        kernels.append(
            {"name": name, "route": "cuda", "source": src, "replaces": replaces,
             "launches": launches[name],
             "max_abs_err": max(r["max_abs_err"] for r in rs),
             "ms": at["ms"], "plain_ms": at["plain_ms"]}
        )
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
