"""CLI driver: encode / decode / bench / optimize, the port of
frave_tpu/cli/main.py with the same subcommands, flags and output lines.

Where it differs from the JAX package's CLI:
  * ``--backend`` takes ``auto`` (= ``torch``), ``torch`` or ``native``
    (the C++ frif codec, csrc/frif.cpp); ``--device`` takes ``cuda`` (the
    default) or ``cpu``, where every kernel runs its plain PyTorch
    version. The JAX package's ``numpy`` backend is ``--device cpu``.
  * Images: ``.npy`` files are always accepted ([h, w] or [h, w, 1|3]
    uint8; a decoded image is written as [h, w, C]); PNG, BMP, JPEG and
    GIF go through PIL where it imports. An image the CLI cannot read or
    write ends it with exit code 2 and a message naming the file.
  * ``optimize --search-predictors`` runs the trial encodes through the
    torch backend on ``--device`` (the native codec fits its own
    parameters and takes no pinned ones, so it is refused there).
"""

from __future__ import annotations

import argparse
import itertools
import sys
import time
from pathlib import Path

import numpy as np

PIL_EXTS = (".png", ".bmp", ".jpg", ".jpeg", ".gif")


class ImageIOError(Exception):
    """An image file the CLI cannot read or write (main() exits 2)."""


def _pil(path):
    try:
        from PIL import Image
    except ImportError:
        raise ImageIOError(f"{path}: PIL is not installed here; use a .npy image") from None
    return Image


def _load_image(path: str):
    from ..images import ColorSpace, RasterImage

    if Path(path).suffix.lower() == ".npy":
        try:
            arr = np.load(path, allow_pickle=False)
        except (OSError, ValueError) as e:
            raise ImageIOError(f"{path}: {e}") from None
        if arr.dtype != np.uint8 or not (
            arr.ndim == 2 or (arr.ndim == 3 and arr.shape[2] in (1, 3))
        ):
            raise ImageIOError(
                f"{path}: want [h, w] or [h, w, 1|3] uint8, got {arr.dtype} {list(arr.shape)}"
            )
        return RasterImage.from_array(arr)
    Image = _pil(path)
    try:
        im = Image.open(path)
        if im.mode == "L":
            arr, cs = np.asarray(im)[:, :, None], ColorSpace.LUMA
        else:
            arr, cs = np.asarray(im.convert("RGB")), ColorSpace.RGB
    except OSError as e:
        raise ImageIOError(f"{path}: {e}") from None
    return RasterImage.from_array(arr.astype(np.uint8), cs)


def _save_image(path: str, image) -> None:
    arr = image.data
    if Path(path).suffix.lower() == ".npy":
        np.save(path, arr)
        return
    Image = _pil(path)
    try:
        if arr.shape[2] == 1:
            Image.fromarray(arr[:, :, 0], mode="L").save(path)
        else:
            Image.fromarray(arr, mode="RGB").save(path)
    except (OSError, ValueError) as e:
        raise ImageIOError(f"{path}: {e}") from None


def _opts(args):
    from ..codec.options import EncoderOptions, EncoderQuality

    return EncoderOptions(
        quality=EncoderQuality[args.quality.upper()],
        backend=args.backend,
        verbose=args.verbose,
        color_transform=args.color_transform,
        mode=args.mode,
    )


def cmd_encode(args) -> int:
    from ..codec.encoder import FRIEncoder

    img = _load_image(args.input)
    t0 = time.perf_counter()
    data = FRIEncoder(_opts(args), args.device).encode(img)
    dt = time.perf_counter() - t0
    out = args.output or "a.frv"
    Path(out).write_bytes(data)
    raw = img.data.size
    if not args.quiet:
        print(f"Uncompressed size: {raw} bytes")
        print(f"frif size: {len(data)} bytes")
        print(f"Compression rate: {100.0 * len(data) / raw:.2f}%")
        print(f"Encode time: {dt * 1e3:.1f} ms")
        print(f"Wrote {out}")
    return 0


def cmd_decode(args) -> int:
    from ..codec.decoder import FRIDecoder

    data = Path(args.input).read_bytes()
    t0 = time.perf_counter()
    img = FRIDecoder(args.backend, args.device).decode(data)
    dt = time.perf_counter() - t0
    out = args.output or "a.png"
    _save_image(out, img)
    if not args.quiet:
        print(f"Decode time: {dt * 1e3:.1f} ms")
        print(f"Wrote {out} ({img.metadata.width}x{img.metadata.height})")
    return 0


def cmd_bench(args) -> int:
    from ..codec.decoder import FRIDecoder
    from ..codec.encoder import FRIEncoder

    exts = set(PIL_EXTS) | {".npy"}
    files = sorted(p for p in Path(args.dir).iterdir() if p.suffix.lower() in exts)
    if not files:
        print(f"no images found in {args.dir}", file=sys.stderr)
        return 1

    enc = FRIEncoder(_opts(args), args.device)
    dec = FRIDecoder(args.backend, args.device)
    outdir = Path(args.output or "./output")
    outdir.mkdir(parents=True, exist_ok=True)

    tot_raw = tot_frif = tot_src = 0
    tot_mse = 0.0
    tot_px = 0
    tot_enc_s = tot_dec_s = 0.0
    failures = 0
    for p in files:
        try:
            img = _load_image(str(p))
        except ImageIOError as e:  # unreadable files are skipped (bench.rs:25-28)
            print(f"skipping {p.name}: {e}", file=sys.stderr)
            continue
        h, w, c = img.data.shape
        raw = img.data.size
        t0 = time.perf_counter()
        data = enc.encode(img)
        t1 = time.perf_counter()
        out = dec.decode(data)
        t2 = time.perf_counter()
        mse = float(np.mean((out.data.astype(np.float64) - img.data) ** 2))
        src_size = p.stat().st_size
        _save_image(str(outdir / (p.stem + (".npy" if p.suffix.lower() == ".npy" else ".png"))),
                    out)

        tot_raw += raw
        tot_frif += len(data)
        tot_src += src_size
        tot_mse += mse * raw
        tot_px += h * w
        tot_enc_s += t1 - t0
        tot_dec_s += t2 - t1
        if args.quality.upper() == "LOSSLESS" and mse != 0.0:
            failures += 1
        if not args.quiet:
            print(
                f"{p.name}: raw={raw} frif={len(data)} "
                f"({100.0 * len(data) / raw:.2f}%, {8.0 * len(data) / (h * w):.3f} bpp) "
                f"src={src_size} ({8.0 * src_size / (h * w):.3f} bpp) "
                f"mse={mse:.4f} enc={1e3 * (t1 - t0):.1f}ms dec={1e3 * (t2 - t1):.1f}ms"
            )

    n = max(tot_px, 1)
    print("--- corpus averages ---")
    print(f"files: {len(files)}  pixels: {tot_px}")
    print(f"frif: {100.0 * tot_frif / max(tot_raw, 1):.2f}% of raw, {8.0 * tot_frif / n:.3f} bpp")
    print(f"source files: {8.0 * tot_src / n:.3f} bpp")
    print(f"mean MSE: {tot_mse / max(tot_raw, 1):.6f}")
    print(
        f"throughput: encode {tot_px / 1e6 / max(tot_enc_s, 1e-9):.2f} MP/s, "
        f"decode {tot_px / 1e6 / max(tot_dec_s, 1e-9):.2f} MP/s"
    )
    if failures:
        print(f"LOSSLESS FAILURES: {failures}", file=sys.stderr)
        return 1
    return 0


def find_predictor_vectors(limit=None):
    """The reference's brute-force candidate generator (optimize.rs:16-32):
    every 6-tap integer coefficient vector in [-3, 3]^6 summing to 6.
    `limit` deterministically decimates the full ~4.3k-vector grid."""
    out = [
        np.asarray(v, dtype=np.float32)
        for v in itertools.product(range(-3, 4), repeat=6)
        if sum(v) == 6
    ]
    if limit is not None and limit < len(out):
        stride = len(out) / float(limit)
        out = [out[int(i * stride)] for i in range(limit)]
    return out


def search_predictors(img, candidates, quality=None, device="cuda"):
    """Outer predictor-vector search (optimize.rs:16-32,103-126): each
    candidate 6-tap vector is pinned through
    EncoderOptions.value_prediction_params, one trial encode on `device`
    per candidate, scored by the metrics sink's mean |residual|
    (encode/mean_abs_residual_ch{c}, averaged over the channels), the
    container size the tie-break. Returns (best_vector, [(score, bytes,
    vector), ...] sorted by (score, bytes, vector))."""
    from ..codec.encoder import FRIEncoder
    from ..codec.options import EncoderOptions, EncoderQuality
    from ..metrics import get_metrics

    quality = quality or EncoderQuality.LOSSLESS
    m = get_metrics()
    results = []
    for vec in candidates:
        params = np.broadcast_to(vec, (3, 6)).astype(np.float32)
        opts = EncoderOptions(quality=quality, value_prediction_params=params)
        m.reset()
        blob = FRIEncoder(opts, device).encode(img)
        res = [
            vals
            for name, vals in m.snapshot().items()
            if name.startswith("encode/mean_abs_residual")
        ]
        score = float(np.mean([np.mean(v) for v in res])) if res else float(len(blob))
        results.append((score, len(blob), vec))
    results.sort(key=lambda t: (t[0], t[1], tuple(t[2])))
    return results[0][2], results


def cmd_optimize(args) -> int:
    from ..codec.decoder import FRIDecoder
    from ..codec.encoder import FRIEncoder
    from ..codec.options import EncoderOptions, EncoderQuality

    img = _load_image(args.input)
    h, w, _ = img.data.shape

    if args.search_predictors:
        if args.backend == "native":
            print("--search-predictors pins the torch backend's parameters; the native codec "
                  "takes none", file=sys.stderr)
            return 2
        cands = find_predictor_vectors(
            limit=args.search_limit if args.search_limit > 0 else None
        )
        best, results = search_predictors(img, cands, device=args.device)
        print(
            f"{args.input}: searched {len(results)} predictor vectors "
            f"(reference grid: optimize.rs:16-32)"
        )
        print(f"{'score':>12} {'bytes':>10}  vector")
        for score, nbytes, vec in results[:10]:
            print(f"{score:>12.4f} {nbytes:>10}  {vec.astype(int).tolist()}")
        print(f"best: {best.astype(int).tolist()}")
        return 0

    dec = FRIDecoder(args.backend, args.device)
    print(f"{args.input}: {w}x{h}")
    print(f"{'quality':<10} {'bytes':>10} {'bpp':>8} {'MSE':>10} {'PSNR dB':>9}")
    for q in (
        EncoderQuality.LOSSLESS,
        EncoderQuality.HIGH,
        EncoderQuality.MEDIUM,
        EncoderQuality.LOW,
    ):
        data = FRIEncoder(EncoderOptions(quality=q, backend=args.backend), args.device).encode(img)
        out = dec.decode(data)
        mse = float(np.mean((out.data.astype(np.float64) - img.data) ** 2))
        psnr = float("inf") if mse == 0 else 10.0 * np.log10(255.0**2 / mse)
        print(
            f"{q.name:<10} {len(data):>10} {8.0 * len(data) / (h * w):>8.3f} "
            f"{mse:>10.4f} {psnr:>9.2f}"
        )
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="fri", description="frave_tpu_torch fractal-wavelet image codec (PyTorch/CUDA)"
    )
    parser.add_argument("-v", "--verbose", action="store_true")
    parser.add_argument("-q", "--quiet", action="store_true")
    sub = parser.add_subparsers(dest="cmd", required=True)

    def backend(p):
        p.add_argument("--backend", default="auto", choices=["auto", "torch", "native"],
                       help="auto = torch; native = the C++ frif codec (csrc/frif.cpp)")
        p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                       help="the torch backend's device (cpu: every kernel's plain version)")

    def quality(p):
        p.add_argument("--quality", default="lossless",
                       choices=["lossless", "high", "medium", "low"])

    def color(p):
        p.add_argument(
            "--color-transform", dest="color_transform", default="auto",
            choices=["auto", "trial", "none", "subtract-green", "ycocg"],
            help="RGB coding transform: auto = per-image proxy selection, "
            "trial = exact (encodes every candidate, keeps smallest)",
        )

    def mode(p):
        p.add_argument(
            "--mode", default="grid", choices=["grid", "parallel", "parity"],
            help="context-model / coefficient-layout mode (codec/options.py): grid "
            "(default) = dense lattice-grid lanes, parallel = per-level waves with the "
            "step-tensor decode, parity = the reference's causal taps",
        )

    pe = sub.add_parser("encode", help="encode an image to .frv")
    pe.add_argument("input")
    pe.add_argument("-o", "--output")
    for add in (backend, quality, color, mode):
        add(pe)
    pe.set_defaults(fn=cmd_encode)

    pd = sub.add_parser("decode", help="decode a .frv file")
    pd.add_argument("input")
    pd.add_argument("-o", "--output")
    backend(pd)
    pd.set_defaults(fn=cmd_decode)

    pb = sub.add_parser("bench", help="round-trip benchmark over a directory")
    pb.add_argument("dir")
    pb.add_argument("-o", "--output", help="decoded-output dir (default ./output)")
    for add in (backend, quality, color, mode):
        add(pb)
    pb.set_defaults(fn=cmd_bench)

    po = sub.add_parser("optimize", help="rate/distortion sweep across qualities")
    po.add_argument("input")
    backend(po)
    po.add_argument(
        "--search-predictors", action="store_true",
        help="brute-force the reference's 6-tap predictor-vector grid "
        "(optimize.rs:16-32) via trial encodes with pinned parameters",
    )
    po.add_argument(
        "--search-limit", type=int, default=64,
        help="deterministic decimation of the ~4.3k-vector grid (0 = full sweep)",
    )
    po.set_defaults(fn=cmd_optimize)

    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except ImageIOError as e:
        print(f"fri: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
