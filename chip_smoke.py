#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (frave_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reporting on its own lines; any failed check raises and the
script exits nonzero without printing a result:

  1. build   — compile the CUDA kernels (frave_tpu_torch/csrc) with nvcc;
  2. kernels — each kernel against its plain PyTorch version on the same
               card tensors, bit-equal, at the shapes every image of the
               main path gives it (lifting rows, encode grid, largest
               decode wave), median time of 20 launches each (CUDA
               events); decode_scan_wave also on a valid and a garbage
               wave at the slice's listed shapes, up to 32,768 lanes;
  3. main    — the port's public encode -> decode (seeded
               natural-statistics images), three paths (a-c), each with the
               launch counts zeroed just before it and read just after it
               (every kernel launched, decode_scan_wave once per non-empty
               wave, the plain decode row never; every container at the
               lane count the kernels phase checked):
               a. 256x256 gray and 768x512 RGB, lossless: containers
                  cross-decoded with frave_tpu's numpy backend both ways, a
                  numpy re-encode with the port's parameters pinned compared
                  byte for byte, the golden v9 grid fixtures decoded, 16
                  byte flips decoded without a crash;
               b. 512x512 gray at HIGH, MEDIUM and LOW: the same cross-decodes
                  (pixels equal to the numpy decode of the same container)
                  and pinned re-encodes;
               c. 2048x2048 RGB, lossless: the round trip, the numpy backend's
                  decode of the port's container, the pinned re-encode, the
                  first-call time and the peak device memory;
  4. report  — encode/decode ms and MP/s, per-stage ms at every image, peak
               device memory, the card's name and power limit, then one JSON
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
from frave_tpu import EncoderOptions, EncoderQuality, RasterImage
from frave_tpu.codec.container import SerializeError, deserialize, serialize
from frave_tpu.codec.pipeline_np import decode_pipeline_np, encode_pipeline_np
from frave_tpu.entropy.tables import (
    ENC_FREQ_BITS_CAP,
    MIN_FREQ_BITS,
    _GRID_LOG2,
    _LAPLACE_GRID_ROWS,
)
from frave_tpu.fractal.geometry import get_geometry
from frave_tpu.fractal.schedule import default_num_lanes, get_schedule, grid_row_lane
from frave_tpu_torch import kernel_check
from frave_tpu_torch.codec import pipeline_torch as PT
from frave_tpu_torch.ops import _build
from frave_tpu_torch.ops import rans_torch as RT

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


def compare_pinned(label, img, blob_port, hist, device, quality=EncoderQuality.LOSSLESS):
    """Re-encode on frave_tpu's numpy backend at `quality` with the port's
    parameters and lane count pinned; the containers must be byte-equal, except
    where the encode-only Laplace scale index legitimately differs:
      * empty contexts (no symbol coded): the host keeps the bucket's own
        row, the device twins (jax, the port) row 0 — the stream does not
        depend on it, so after taking the port's (bits, scale) for those
        contexts the bytes must match;
      * near-ties of the scale gains, chosen in f32 by the host and
        exactly by the port: printed with both gains; both containers
        must then decode to the numpy decode of the port's container on
        both sides."""
    ci_p = deserialize(blob_port)
    C = img.metadata.num_channels
    vp = np.stack([ci_p.channel_data[c].value_prediction_parameters for c in range(C)])
    wp = np.stack([ci_p.channel_data[c].width_prediction_parameters for c in range(C)])
    opts = EncoderOptions(
        backend="numpy", quality=quality, num_lanes=ci_p.num_lanes,
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
    ref = decode_pipeline_np(ci_p).data
    for name, blob in (("port", blob_port), ("numpy", blob_np)):
        out_n = decode_pipeline_np(deserialize(blob)).data
        out_p = frave_tpu_torch.decode(blob, device=device).data
        if not (np.array_equal(out_n, ref) and np.array_equal(out_p, ref)):
            raise AssertionError(f"{label}: {name} container does not cross-decode")
    print(f"main {label}: {len(ties)} scale near-tie(s); both containers cross-decode")


WRAPPERS = {n: k[0] for n, k in kernel_check.KERNELS.items()}


def zero_counts():
    """Set every kernel's launch count and the plain decode row's call
    count to 0."""
    for fn in WRAPPERS.values():
        fn.launches = 0
    RT.decode_row.calls = 0


def read_counts(label: str, waves: int) -> dict:
    """The counts since zero_counts(): every kernel must have launched,
    decode_scan_wave exactly once per non-empty wave of the decodes
    (`waves` in all), and the plain decode row must not have run."""
    launches = {n: fn.launches for n, fn in WRAPPERS.items()}
    for n, k in launches.items():
        if k <= 0:
            raise AssertionError(f"{label}: kernel {n} was not launched on the main path")
    if launches["decode_scan_wave"] != waves:
        raise AssertionError(
            f"{label}: {launches['decode_scan_wave']} decode_scan_wave launches, "
            f"one per non-empty wave is {waves}"
        )
    if RT.decode_row.calls:
        raise AssertionError(f"{label}: the plain decode row ran {RT.decode_row.calls} times")
    print(f"main {label}: launches {json.dumps(launches)} (decode_scan_wave: one per "
          f"non-empty wave); plain decode rows 0")
    return launches


def first_call(label, px, opts):
    """The first encode -> decode of a shape (program build included)."""
    t = time.perf_counter()
    blob = frave_tpu_torch.encode(px, opts, device="cuda")
    t_enc = time.perf_counter() - t
    t = time.perf_counter()
    frave_tpu_torch.decode(blob, device="cuda")
    t_dec = time.perf_counter() - t
    print(f"main {label}: first call (program build included) encode {t_enc:.3f} s "
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


def grid_shapes(h: int, w: int, c: int, nl: int = 0) -> dict:
    """The shapes the main path gives the kernels at an h x w x c image
    with nl lanes (0: the default count): "lift" (rows, mask rows) of
    both lifting kernels, "grid" (R, C, NL) of encode_scan, "wave" the
    largest decode wave (rows, C, NL), and "waves" the number of
    non-empty waves, one decode_scan_wave launch each."""
    sched = get_schedule(h, w, mode="grid")
    nl = nl or default_num_lanes(sched.num_symbols)
    tiles = get_geometry(h, w).num_tiles
    _, _, rows, per_wave = grid_row_lane(sched, nl)
    return {"lift": (c * tiles, tiles), "grid": (int(rows), c, nl),
            "wave": (int(per_wave.max()), c, nl), "waves": int((per_wave > 0).sum())}


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
    ({name: [(shape, problem kind, timed)]}); appends to `checks`."""
    for name, cases in plan.items():
        for sh, pk, timed in cases:
            r = kernel_check.check(name, sh, dev, seed=7, timed=timed, kind=pk)
            times = f" kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms" if timed else ""
            print(f"kernel {name} {tuple(sh)}{' ' + pk if pk else ''}: "
                  f"max_abs_err {r['max_abs_err']}{times}")
            if r["max_abs_err"] != 0:
                raise AssertionError(f"{name} {sh} {pk}: kernel disagrees with its plain version")
            checks.setdefault(name, []).append(r)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    t_start = time.perf_counter()

    # ---- 1. build
    t0 = time.perf_counter()
    _build.load_library()
    print(
        f"build: {time.perf_counter() - t0:.3f} s "
        f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'})"
    )

    # ---- 2. kernels against their plain versions on the card
    images = {
        "256x256 gray": natural_image(256, 256, 1, seed=1),
        "768x512 RGB": natural_image(512, 768, 3, seed=2),
    }
    preset_label, preset_px = "512x512 gray", natural_image(512, 512, 1, seed=3)
    big_label, big_px = "2048x2048 RGB", natural_image(2048, 2048, 3, seed=4)
    all_images = {**images, preset_label: preset_px, big_label: big_px}
    shapes = {label: grid_shapes(*px.shape) for label, px in images.items()}
    shapes[preset_label] = grid_shapes(*preset_px.shape)
    t = time.perf_counter()
    shapes[big_label] = grid_shapes(*big_px.shape)
    print(f"host schedule and geometry {big_label}: {time.perf_counter() - t:.3f} s "
          "(cached: the first call below does not rebuild them)")
    # (shape, problem kind, timed): every kernel at the shapes each image
    # gives it at the default lane count, timed; the last timed shape of
    # each kernel (2048x2048 RGB) is the one the kernels line reports
    plan = {name: [] for name in kernel_check.KERNELS}
    plan["decode_scan_wave"] = [
        (sh, k, False)
        for sh in ((138, 1, 512), (60, 3, 2048), (30, 3, 16384), (4, 3, 32768))
        for k in kernel_check.DECODE_KINDS
    ]
    for label in all_images:
        sh = shapes[label]
        plan["forward_lift_quantize"].append((sh["lift"], None, True))
        plan["dequantize_inverse_lift"].append((sh["lift"], None, True))
        plan["encode_scan"].append((sh["grid"], None, True))
        plan["decode_scan_wave"].append((sh["wave"], "valid", True))
    checks = {}
    run_checks(plan, dev, checks)
    torch.cuda.synchronize(dev)
    print(f"phase kernels done at {time.perf_counter() - t_start:.1f} s")

    # ---- 3a. lossless at 256x256 gray and 768x512 RGB
    lossless = EncoderOptions()
    for label, px in images.items():
        first_call(label, px, lossless)
    totals = {n: 0 for n in WRAPPERS}
    zero_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    reps = 3
    runs = {}
    for label, px in images.items():
        blob, _, te, td = timed_round_trips(label, px, lossless, reps, dev)
        runs[label] = (blob, te, td)
    waves = reps * sum(shapes[label]["waves"] for label in images)
    for n, k in read_counts("lossless 256x256 gray + 768x512 RGB", waves).items():
        totals[n] += k
    peak = torch.cuda.max_memory_allocated(dev)

    for label, px in images.items():
        blob = runs[label][0]
        img = RasterImage.from_array(px)
        if not np.array_equal(decode_pipeline_np(deserialize(blob)).data, img.data):
            raise AssertionError(f"{label}: numpy backend does not decode the port's container")
        nblob = serialize(encode_pipeline_np(img, EncoderOptions(backend="numpy")))
        same_lanes(label, shapes[label], blob, nblob)
        if not np.array_equal(frave_tpu_torch.decode(nblob, device="cuda").data, img.data):
            raise AssertionError(f"{label}: the port does not decode a numpy container")
        print(f"main {label}: lossless; cross-decodes with the numpy backend both ways "
              f"({len(blob)} B, {8.0 * len(blob) / (px.shape[0] * px.shape[1]):.4f} bpp)")
        _, (_, hist), _, _ = PT._encode_dispatch(img, lossless, "cuda")
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
    for n, k in read_counts(f"{preset_label} HIGH/MEDIUM/LOW", waves).items():
        totals[n] += k
    img = RasterImage.from_array(preset_px)
    for q, opts in presets.items():
        label = f"{preset_label} {q.name}"
        blob, out_port, _, _ = preset_runs[q]
        out_np = decode_pipeline_np(deserialize(blob)).data
        if not np.array_equal(out_port, out_np):
            raise AssertionError(f"{label}: the port's pixels differ from the numpy decode")
        if np.array_equal(out_np, img.data):
            raise AssertionError(f"{label}: a lossy preset decoded to the input")
        nblob = serialize(encode_pipeline_np(img, EncoderOptions(backend="numpy", quality=q)))
        same_lanes(label, shapes[preset_label], blob, nblob)
        if not np.array_equal(frave_tpu_torch.decode(nblob, device="cuda").data,
                              decode_pipeline_np(deserialize(nblob)).data):
            raise AssertionError(f"{label}: the port decodes a numpy container differently")
        psnr = 10 * np.log10(255.0**2 / np.mean((out_np.astype(np.float64) - img.data) ** 2))
        print(f"main {label}: port pixels equal the numpy decode both ways "
              f"({len(blob)} B, {8.0 * len(blob) / img.data[..., 0].size:.4f} bpp, "
              f"PSNR {psnr:.3f} dB)")
        _, (_, hist), _, _ = PT._encode_dispatch(img, opts, "cuda")
        compare_pinned(label, img, blob, hist.cpu().numpy(), "cuda", quality=q)
    print(f"phase main presets done at {time.perf_counter() - t_start:.1f} s")

    # ---- 3c. 2048x2048 RGB, lossless
    first_call(big_label, big_px, lossless)
    zero_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    big_blob, _, big_te, big_td = timed_round_trips(big_label, big_px, lossless, reps, dev)
    big_peak = torch.cuda.max_memory_allocated(dev)
    for n, k in read_counts(big_label, reps * shapes[big_label]["waves"]).items():
        totals[n] += k
    print(f"main {big_label}: lossless; {shapes[big_label]['waves']} decode_scan_wave "
          "launches per decode")
    same_lanes(big_label, shapes[big_label], big_blob)
    img = RasterImage.from_array(big_px)
    t = time.perf_counter()
    if not np.array_equal(decode_pipeline_np(deserialize(big_blob)).data, img.data):
        raise AssertionError(f"{big_label}: numpy backend does not decode the port's container")
    print(f"main {big_label}: the numpy backend decodes the port's container to the input "
          f"({time.perf_counter() - t:.3f} s; {len(big_blob)} B, "
          f"{8.0 * len(big_blob) / (2048 * 2048):.4f} bpp)")
    t = time.perf_counter()
    _, (_, hist), _, _ = PT._encode_dispatch(img, lossless, "cuda")
    compare_pinned(big_label, img, big_blob, hist.cpu().numpy(), "cuda")
    print(f"main {big_label}: pinned compare took {time.perf_counter() - t:.3f} s")
    print(f"phase main 2048x2048 done at {time.perf_counter() - t_start:.1f} s")


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
    print(f"report peak device memory: {peak} B at 256x256 gray + 768x512 RGB, "
          f"{big_peak} B at {big_label} (torch.cuda.max_memory_allocated)")
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
        at = [r for r in rs if r["ms"] is not None][-1]
        kernels.append(
            {"name": name, "route": "cuda", "source": src, "replaces": replaces,
             "launches": totals[name],
             "max_abs_err": max(r["max_abs_err"] for r in rs),
             "ms": at["ms"], "plain_ms": at["plain_ms"]}
        )
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
