"""Each CUDA kernel of the port against its plain PyTorch version.

Seeded inputs at a given shape, the kernel wrapper and the plain version
run on the same device tensors, the largest absolute difference of their
outputs (the kernels are integer, so anything but 0 is a fault), the
bytes the function must move and, optionally, times: the wrapper's device
time per call (device_ms: back-to-back calls the host enqueues behind a
sleep kernel, CUDA events), and the wrapper's and the plain version's
median time per call with the host's share (CUDA events). Used by
chip_smoke.py and by the card-only test.

Every problem comes for one image without a batch axis (images=0) or for
a same-shape batch of `images` images: seeded per image, with the
transform ids, qdivs and decode problems mixed across the batch, and the
row map and row activity shared, as the pipeline's batches have them.
decode_steps' problems are real: the step tensors of an image's program
and the wire of the port's own containers of seeded images (or garbage
states and streams on that program).
"""

from __future__ import annotations

import numpy as np
import torch

from .codec import channel_transform as CT
from .entropy.tables import ALPHABET_SIZE, CONTEXT_AMOUNT, _LAPLACE_GRID_ROWS
from .entropy.tables_torch import finalize_contexts_device
from .ops import fit_stats as FS
from .ops import lifting as L
from .ops import rans_torch as RT
from .ops import step_decode as SD
from .ops import tp_decode as TD
from .ops import transform_counts as TC
from .ops import wave_ctx as WC
from .testing import natural_image

# name -> (wrapper, plain version, CUDA source, the TPU kernel it replaces)
KERNELS = {
    "forward_lift_quantize_pixels": (
        L.forward_lift_quantize_pixels,
        L.forward_lift_quantize_pixels_plain,
        "frave_tpu_torch/csrc/lifting.cu",
        "frave_tpu/ops/pallas_lifting.py:120 + frave_tpu/codec/pipeline_jax.py:423-428",
    ),
    "dequantize_inverse_lift_pixels": (
        L.dequantize_inverse_lift_pixels,
        L.dequantize_inverse_lift_pixels_plain,
        "frave_tpu_torch/csrc/lifting.cu",
        "frave_tpu/ops/pallas_lifting.py:148 + frave_tpu/codec/grid_decode.py:511-514",
    ),
    "encode_scan": (
        RT.encode_scan,
        RT.encode_scan_plain,
        "frave_tpu_torch/csrc/rans_encode.cu",
        "frave_tpu/ops/rans_jax.py:52",
    ),
    "decode_scan_wave": (
        RT.decode_scan_wave,
        RT.decode_scan_wave_plain,
        "frave_tpu_torch/csrc/rans_decode.cu",
        "frave_tpu/ops/pallas_rans.py:328",
    ),
    "decode_steps": (
        SD.decode_steps,
        SD.decode_steps_plain,
        "frave_tpu_torch/csrc/rans_step_decode.cu",
        "frave_tpu/codec/pipeline_jax.py:820-868 + frave_tpu/ops/rans_jax.py:555",
    ),
    "wave_contexts": (
        WC.wave_contexts,
        WC.wave_contexts_plain,
        "frave_tpu_torch/csrc/wave_context.cu",
        "frave_tpu/codec/grid_decode.py:426-447 (decode_fused_grid :326) + :598 + "
        "frave_tpu/codec/pipeline_jax.py:469",
    ),
    "wave_finish": (
        WC.wave_finish,
        WC.wave_finish_plain,
        "frave_tpu_torch/csrc/wave_context.cu",
        "frave_tpu/codec/grid_decode.py:401-424 + :448-458 (decode_fused_grid :326)",
    ),
    "transform_counts": (
        TC.transform_counts,
        TC.transform_counts_plain,
        "frave_tpu_torch/csrc/transform_counts.cu",
        "none (frave_tpu/codec/channel_transform.py select_transform counts on the host)",
    ),
    "fit_stats": (
        FS.fit_stats,
        FS.fit_stats_plain,
        "frave_tpu_torch/csrc/fit_stats.cu",
        "none (XLA einsums: frave_tpu/codec/grid_decode.py:646-676 + "
        "frave_tpu/codec/pipeline_jax.py:496-530, _gram_solve :100)",
    ),
}
# the kernels with a forced cluster size (the others run their launch rule)
CLUSTERED = ("decode_scan_wave", "decode_steps")
# the grid wave chain's kernels W and V (timed beside an empty launch's floor)
WAVE_KERNELS = ("wave_contexts", "wave_finish")
# the card's memory rate the byte bound is taken at (H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
# cluster sizes kernel 3 can be forced to
CLUSTERS = (1, 2, 4, 8, 16)
# problem kinds of decode_scan_wave (kernel B's kind is its transform id,
# kernel A's a (transform id, qdiv) pair from QDIV_KINDS, W's a (mode,
# kind) pair from WAVE_MODES and DECODE_KINDS, V's one of DECODE_KINDS,
# transform_counts' one of QDIV_KINDS; the other kernels have one kind,
# None)
DECODE_KINDS = ("valid", "garbage")
WAVE_MODES = ("decode", "encode")
QDIV_KINDS = ("lossless", "lossy")
# fit_stats' kinds: a (plane, overrides) pair. The plane's images through
# plain kernel A, lossless: "valid" seeded natural images, "flat" one gray
# level an image, "noise" uniform pixels, "stripes" 0/255 columns (taps
# of 255 and Gram entries near 2^28, the largest of the 0/255 patterns
# tried: checkerboards, row stripes, binary noise); the overrides: "none",
# "vp" (the value parameters pinned) or "vpwp" (both pinned)
FIT_PLANES = ("valid", "flat", "noise", "stripes")
FIT_OVERRIDES = ("none", "vp", "vpwp")
# fit_stats' launches an encode batch by overrides kind
FIT_LAUNCHES = {"none": 4, "vp": 2, "vpwp": 0}
# kernel C's design points: rows loaded ahead, lanes a block
ENCODE_AHEAD = (4, 8, 16)
ENCODE_THREADS = (32, 64, 128, 256)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _lossy_qdiv(n: int) -> torch.Tensor:
    """qdiv [n] int32: 1 on the top quarter of the haar indices, then 2,
    then 3 on the finest level."""
    qdiv = np.ones(n, np.int32)
    qdiv[n // 2 :] = 3
    qdiv[n // 4 : n // 2] = 2
    return _t(qdiv)


def draw_wave_sizes(rng, R: int, NL: int) -> list:
    """Symbols per wave of a few seeded waves (one of them empty) that fill
    R rows of NL lanes, each wave's last row partly filled, as the grid's
    are."""
    cuts = np.sort(rng.choice(np.arange(1, R), size=min(R - 1, max(1, R // 20)), replace=False))
    rows = np.diff(np.concatenate([[0], cuts, [R]]))
    sizes = [int((rw - 1) * NL + (rng.integers(1, NL) if NL > 1 else 1)) for rw in rows]
    sizes.insert(len(sizes) // 2, 0)
    return sizes


def schedule_problem(rng, wave_sizes, C: int, NL: int):
    """encode_scan's operands (symbols, buckets, row_k0, row_len, freqs,
    cdfs, bits) on the CPU for waves of these sizes: seeded schedule-order
    [C, K] symbols and buckets, the row map, and tables that give every
    drawn symbol a nonzero frequency."""
    row_k0, row_len = RT.row_map(wave_sizes, NL)
    K = int(row_len.sum())
    sym = np.minimum(rng.geometric(0.08, size=(C, K)) - 1, ALPHABET_SIZE - 1)
    bkt = rng.integers(0, CONTEXT_AMOUNT, size=(C, K))
    ids = (np.arange(C)[:, None] * CONTEXT_AMOUNT + bkt) * ALPHABET_SIZE + sym
    hist = np.bincount(ids.reshape(-1), minlength=C * CONTEXT_AMOUNT * ALPHABET_SIZE)
    hist = _t(hist.reshape(C, CONTEXT_AMOUNT, ALPHABET_SIZE))
    bits, freqs, cdfs, _ = finalize_contexts_device(hist, _t(_LAPLACE_GRID_ROWS))
    i32 = torch.int32
    return (
        _t(sym.astype(np.int32)), _t(bkt.astype(np.int32)), _t(row_k0), _t(row_len),
        freqs.to(i32), cdfs.to(i32), bits.to(i32),
    )


def rans_problem(rng, R: int, C: int, NL: int):
    """schedule_problem on draw_wave_sizes(rng, R, NL): R rows of NL
    lanes."""
    return schedule_problem(rng, draw_wave_sizes(rng, R, NL), C, NL)


def random_staircases(rng, C: int):
    """Monotone cdf staircases [C, CA, 1024] int32 with 3-59 coded symbols
    each, so long runs of equal cdfs (zero-frequency symbols), and scale
    bits [C, CA] int32 in [8, 14] — no freqs table."""
    bits = rng.integers(8, 15, size=(C, CONTEXT_AMOUNT)).astype(np.int32)
    cdfs = np.zeros((C, CONTEXT_AMOUNT, ALPHABET_SIZE), np.int32)
    for c in range(C):
        for b in range(CONTEXT_AMOUNT):
            tot = 1 << int(bits[c, b])
            on = np.sort(rng.choice(ALPHABET_SIZE, size=int(rng.integers(3, 60)), replace=False))
            w = rng.random(on.size)
            f = np.floor(w / w.sum() * tot).astype(np.int64)
            f[0] += tot - f.sum()
            freqs = np.zeros(ALPHABET_SIZE, np.int64)
            freqs[on] = f
            cdfs[c, b] = np.concatenate([[0], np.cumsum(freqs)[:-1]])
    return cdfs, bits


def garbage_wave(rng, R: int, C: int, NL: int):
    """Numpy inputs of a wave that is not valid rANS, as
    tests/test_pallas_rans.py draws them: states in [2^16, 2^32), random
    buckets, 80% active lanes, random u16 stream words (zero-padded by
    C*NL), random staircases. Returns (x0 [C, NL] int64, buckets
    [R, C, NL] int32, active [R, NL] bool, stream [W] int32, cdfs, bits)."""
    cdfs, bits = random_staircases(rng, C)
    x0 = rng.integers(1 << 16, 1 << 32, size=(C, NL), dtype=np.int64)
    buckets = rng.integers(0, CONTEXT_AMOUNT, size=(R, C, NL)).astype(np.int32)
    active = rng.random((R, NL)) < 0.8
    words = rng.integers(0, 1 << 16, size=R * C * NL)
    stream = np.concatenate([words, np.zeros(C * NL, np.int64)]).astype(np.int32)
    return x0, buckets, active, stream, cdfs, bits


def step_operands(cis, device, kind: str = "valid", rng=None, images: int = 0):
    """decode_steps' operands (x, gptr, steps, vparams, wparams, stream,
    tabs, n_slots) for the port's containers `cis` (one shape, mode and
    lane count) on their program on `device`: "valid" their own wire;
    "garbage" the same tables and parameters with states drawn from
    [2^16, 2^32) and random stream words (the zero padding kept). images
    0: one image without the batch axis (cis holds one container)."""
    from .codec import pipeline_torch as PT

    meta, nl = cis[0].metadata, cis[0].num_lanes
    prog = PT.get_program(meta.height, meta.width, nl, meta.num_channels, device, cis[0].mode)
    states, streams, bits, offpk, scales, vp, wp, _, _ = PT.assemble_wire_batch(cis, nl)
    if kind == "garbage":
        states = rng.integers(1 << 16, 1 << 32, size=states.shape, dtype=np.int64)
        pad = meta.num_channels * nl
        streams = streams.astype(np.int64)
        streams[:, :-pad] = rng.integers(0, 1 << 16, size=(streams.shape[0], streams.shape[1] - pad))
    elif kind != "valid":
        raise ValueError(f"unknown decode problem kind {kind!r}")
    dev = prog.device
    wire = [torch.as_tensor(np.ascontiguousarray(a), device=dev) for a in (
        states.astype(np.int64), streams.astype(np.int32), bits.astype(np.int64),
        offpk.astype(np.int64), scales.astype(np.int64), vp, wp)]
    ops = prog.step_operands(*wire)
    if images:
        return ops
    x, gptr, steps, vparams, wparams, stream, tabs, n_slots = ops
    return (x[0], gptr[0], steps, vparams[0], wparams[0], stream[0],
            {k: v[0] for k, v in tabs.items()}, n_slots)


def step_problem(rng, h: int, w: int, c: int, mode: str, kind: str, device, images: int = 0):
    """decode_steps' operands on the program of an h x w x c image in
    `mode` at its default lane count: step_operands of the port's
    containers of seeded natural images (one, or `images` in one encode
    batch), "valid" or "garbage"."""
    from .codec import pipeline_torch as PT
    from .codec.options import EncoderOptions
    from .fractal.schedule import default_num_lanes, get_schedule
    from .images import RasterImage
    from .testing import natural_image

    seeds = rng.integers(0, 1 << 30, size=max(images, 1))
    imgs = [RasterImage.from_array(natural_image(h, w, c, int(sd))) for sd in seeds]
    nl = default_num_lanes(get_schedule(h, w, mode=mode).num_symbols)
    cis = PT.encode_pipeline_torch_batch(imgs, EncoderOptions(mode=mode, num_lanes=nl), device)
    return step_operands(cis, device, kind, rng, images)


def _one_decode_problem(rng, wave_sizes, R: int, C: int, NL: int, kind: str):
    """One image's decode_scan_wave operands as numpy-convertible tensors:
    (x0, buckets, active, stream, cdfs, bits); "valid" on the row map of
    `wave_sizes`."""
    i32 = torch.int32
    if kind == "garbage":
        return tuple(_t(a) for a in garbage_wave(rng, R, C, NL))
    if kind != "valid":
        raise ValueError(f"unknown decode problem kind {kind!r}")
    sym, bkt_k, row_k0, row_len, freqs, cdfs, bits = schedule_problem(rng, wave_sizes, C, NL)
    x0, words, flags = RT.encode_scan_plain(sym, bkt_k, row_k0, row_len, freqs, cdfs, bits, NL)
    kc = R * C * NL
    packed, total = RT.stream_compact_grid(words, flags, kc)
    stream = torch.zeros(int(total) + C * NL, dtype=i32)
    stream[: int(total)] = packed[: int(total)].to(i32) & 0xFFFF
    bkt, act = RT.schedule_grid(bkt_k, row_k0, row_len, NL)
    return x0, bkt, act, stream, cdfs, bits


def decode_problem(rng, R: int, C: int, NL: int, kind: str, images: int = 0):
    """decode_scan_wave's operands (x0, gptr0, buckets, active, stream,
    tabs) on the CPU. "valid": a schedule_problem on draw_wave_sizes
    encoded by the plain encode_scan and compacted, its buckets and slot
    validity laid out on the lane grid (schedule_grid), so the wave decodes
    back to its symbols and to states 2^16; "garbage": garbage_wave.
    images > 0: a batch, every image its own problem of `kind` on one
    shared row activity (the first image's), streams zero-padded to the
    longest."""
    wave_sizes = draw_wave_sizes(rng, R, NL) if kind == "valid" else None
    if not images:
        x0, bkt, act, stream, cdfs, bits = _one_decode_problem(rng, wave_sizes, R, C, NL, kind)
        return x0, torch.zeros((), dtype=torch.int64), bkt, act, stream, RT.decode_tables(cdfs, bits)
    probs = [_one_decode_problem(rng, wave_sizes, R, C, NL, kind) for _ in range(images)]
    W = max(p[3].shape[0] for p in probs)
    streams = torch.zeros((images, W), dtype=torch.int32)
    for b, p in enumerate(probs):
        streams[b, : p[3].shape[0]] = p[3]
    x0, bkt, cdfs, bits = (torch.stack([p[k] for p in probs]) for k in (0, 1, 4, 5))
    act = probs[0][2]
    gptr0 = torch.zeros((images,), dtype=torch.int64)
    return x0, gptr0, bkt, act, streams, RT.decode_tables(cdfs, bits)


def _batch_tids(tid: int, images: int, C: int):
    """Transform ids of a batch: `tid` for one image (images=0); at C = 3
    the batch runs tid, tid + 1, ... mod 4, at C = 1 zeros."""
    if not images:
        return tid
    if C != 3:
        return torch.zeros(images, dtype=torch.int32)
    return torch.tensor([(tid + b) % 4 for b in range(images)], dtype=torch.int32)


def lift_pixels_problem(rng, prog, tid: int, images: int = 0):
    """dequantize_inverse_lift_pixels' operands from a CodecProgram (its
    masks and both directions of its pixel map) on the program's device:
    the coefficient plane [C, T*512] of seeded leaves in [0, 255] through
    the plain forward lifting and a lossy qdiv, with 1% of coefficients
    pushed by up to +-40 so the clamp binds. images > 0: planes
    [B, C, T*512], each image its own leaves, qdiv [B, 512] alternating
    lossy and lossless, the transform ids _batch_tids. Returns (args,
    (tids,))."""
    C, Tn, dev = prog.channels, prog.num_tiles, prog.device
    n = Tn * 512
    lm = prog.leaf_mask_u8
    planes, qdivs = [], []
    for b in range(max(images, 1)):
        qdiv = _lossy_qdiv(512) if b % 2 == 0 else torch.ones(512, dtype=torch.int32)
        leaves = _t(rng.integers(0, 256, size=(C * Tn, 512)).astype(np.int32)).to(dev)
        leaves = torch.where(lm.to(torch.bool).repeat(C, 1), leaves, 0)
        push = rng.integers(-40, 41, size=(C, n)) * (rng.random((C, n)) < 0.01)
        qplane = L.forward_lift_quantize_plain(leaves, lm, qdiv.to(dev), 9).reshape(C, n)
        planes.append(qplane + _t(push.astype(np.int32)).to(dev))
        qdivs.append(qdiv.to(dev))
    tids = _batch_tids(tid, images, C)
    if images:
        qplane, qdiv, tids = torch.stack(planes), torch.stack(qdivs), tids.to(dev)
    else:
        qplane, qdiv = planes[0], qdivs[0]
    args = (qplane, prog.node_mask_u8, lm, qdiv, prog.leaf_pix, prog.pix_inv)
    return args, (tids,)


def lift_head_problem(rng, prog, tid: int, qkind: str = "lossy", images: int = 0):
    """forward_lift_quantize_pixels' operands from a CodecProgram (its pixel
    map) on the program's device: seeded pixels [H*W, C] uint8 (images > 0:
    [B, H*W, C], the transform ids _batch_tids), leaf_pix, and qdiv all
    ones ("lossless") or _lossy_qdiv ("lossy"). Returns (args, (tids,))."""
    C, dev = prog.channels, prog.device
    if qkind not in QDIV_KINDS:
        raise ValueError(f"unknown qdiv kind {qkind!r}")
    qdiv = _lossy_qdiv(512) if qkind == "lossy" else torch.ones(512, dtype=torch.int32)
    lead = (images,) if images else ()
    pixels = _t(rng.integers(0, 256, size=lead + (prog.height * prog.width, C), dtype=np.uint8))
    tids = _batch_tids(tid, images, C)
    if images:
        tids = tids.to(dev)
    return (pixels.to(dev), prog.leaf_pix, qdiv.to(dev)), (tids,)


def counts_problem(rng, h: int, w: int, kind: str = "lossless", images: int = 0):
    """transform_counts' operands on the CPU: a seeded RGB image [h*w, 3]
    (images > 0: [B, h*w, 3], image b of content b % 4: photo-like,
    photo-like with a saturated red corner (where the mod-256 wraps cost),
    uniform noise, gray R = G = B (the tie of SUBGREEN and YCOCG)), h, w
    and lossless (kind "lossless" or "lossy")."""
    if kind not in QDIV_KINDS:
        raise ValueError(f"unknown counts kind {kind!r}")
    pxs = []
    for b in range(max(images, 1)):
        seed = int(rng.integers(1 << 31))
        if b % 4 == 2:
            px = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        elif b % 4 == 3:
            px = np.repeat(natural_image(h, w, 1, seed), 3, axis=2)
        else:
            px = natural_image(h, w, 3, seed)
            if b % 4 == 1:
                px[: h // 4, : w // 4, 0] = 255
        pxs.append(px.reshape(h * w, 3))
    pixels = _t(np.stack(pxs)) if images else _t(pxs[0])
    return pixels, h, w, kind == "lossless"


def grid_shapes(h: int, w: int, c: int, nl: int = 0) -> dict:
    """The shapes the main path gives the kernels at an h x w x c image
    with nl lanes (0: the default count): "grid" (R, C, NL) of
    encode_scan, "wave" the largest decode wave (rows, C, NL), and "waves"
    the number of non-empty waves, one decode_scan_wave launch each
    (kernels A and B run on the image's program itself)."""
    from .fractal.schedule import default_num_lanes, get_schedule, grid_row_lane

    sched = get_schedule(h, w, mode="grid")
    nl = nl or default_num_lanes(sched.num_symbols)
    _, _, rows, per_wave = grid_row_lane(sched, nl)
    return {"grid": (int(rows), c, nl),
            "wave": (int(per_wave.max()), c, nl), "waves": int((per_wave > 0).sum())}


def program(h: int, w: int, c: int, device, mode: str = "grid"):
    """The cached CodecProgram of an h x w x c image in `mode` at its
    default lane count (the main path's)."""
    from .codec.pipeline_torch import get_program
    from .fractal.schedule import default_num_lanes, get_schedule

    nl = default_num_lanes(get_schedule(h, w, mode=mode).num_symbols)
    return get_program(h, w, nl, c, device, mode)


def largest_wave(prog):
    """(k0, kw, nl) and the grid_decode.Wave of the program's largest grid
    wave."""
    from .codec.grid_decode import wave_starts

    wd, k0 = max(zip(prog.waves, wave_starts(prog.waves)), key=lambda t: t[0].kw)
    return (k0, wd.kw, prog.nl), wd


def _wave_plane(rng, prog, kind: str, images: int):
    """Plane rows [B*C, n_slots + 1] int32 on the program's device, a view
    of rows 16-byte aligned as the main path's (the zero slot 0):
    "valid" the quantized coefficients of seeded natural images (plain
    kernel A, lossless), "garbage" values drawn from [-2^20, 2^20)."""
    from .testing import natural_image

    B, C, n, dev = max(images, 1), prog.channels, prog.n_slots, prog.device
    plane = L.zero_plane(B, C, n, dev)
    if kind == "valid":
        px = np.stack([natural_image(prog.height, prog.width, C, int(sd)).reshape(-1, C)
                       for sd in rng.integers(0, 1 << 30, size=B)])
        q = L.forward_lift_quantize_pixels_plain(
            _t(px).to(dev), prog.leaf_pix, torch.ones(512, dtype=torch.int32, device=dev),
            torch.zeros(B, dtype=torch.int32, device=dev))
        plane[..., :n] = q[..., :n]
    elif kind == "garbage":
        vals = rng.integers(-(1 << 20), 1 << 20, size=(B, C, n)).astype(np.int32)
        plane[..., :n] = _t(vals).to(dev)
    else:
        raise ValueError(f"unknown problem kind {kind!r}")
    return plane.reshape(B * C, n + 1)


def fit_plane(rng, prog, kind: str, images: int = 0):
    """Plane rows [B*C, n_slots + 1] int32 on the program's device, rows
    16-byte aligned as kernel A leaves them: the coefficients of FIT_PLANES'
    `kind` of image through plain kernel A, lossless."""
    B, C, n, dev = max(images, 1), prog.channels, prog.n_slots, prog.device
    h, w = prog.height, prog.width
    if kind == "valid":
        px = np.stack([natural_image(h, w, C, int(sd)) for sd in rng.integers(0, 1 << 30, size=B)])
    elif kind == "flat":
        px = np.broadcast_to(rng.integers(0, 256, size=(B, 1, 1, C)), (B, h, w, C))
    elif kind == "noise":
        px = rng.integers(0, 256, size=(B, h, w, C))
    elif kind == "stripes":
        px = np.broadcast_to((np.arange(w) % 2 * 255)[None, None, :, None], (B, h, w, C))
    else:
        raise ValueError(f"unknown fit plane kind {kind!r}")
    px = _t(px.astype(np.uint8).reshape(B, h * w, C)).to(dev)
    q = L.forward_lift_quantize_pixels_plain(
        px, prog.leaf_pix, torch.ones(512, dtype=torch.int32, device=dev),
        torch.zeros(B, dtype=torch.int32, device=dev))
    plane = L.zero_plane(B, C, n, dev)
    plane[..., :n] = q[..., :n]
    return plane.reshape(B * C, n + 1)


def fit_problem(rng, shape, kind, device, images: int = 0):
    """fit_stats' operands (args, extra) on the program of `shape` (h, w,
    c): fit_plane's rows of the plane kind, the FitTable of the sample set
    the program's statistics use (strided where it has the grid
    statistics), and the overrides of the kind (pinned values drawn from
    [-1.5, 1.5) a row, None unpinned)."""
    plane_kind, ovr = kind
    prog = program(*shape, device)
    rows = fit_plane(rng, prog, plane_kind, images)
    table = prog.fit_table(prog.grid_enc is not None)
    R, F = rows.shape[0], prog.num_fine
    if ovr == "none":
        overrides = None
    elif ovr in FIT_OVERRIDES:
        vp, wp = (_t(rng.uniform(-1.5, 1.5, size=(R, F, 6)).astype(np.float32)).to(prog.device)
                  for _ in range(2))
        overrides = (vp, wp, ovr == "vpwp")
    else:
        raise ValueError(f"unknown fit overrides kind {ovr!r}")
    return (rows, table, overrides), ()


def wave_problem(rng, shape, kind, device, images: int = 0):
    """wave_contexts' operands (args, extra) on the program of `shape`
    (h, w, c[, mode]), kind (mode, problem kind): the plane rows of
    _wave_plane, the program's records, and "valid" the f16 wire fits of
    the plane's own symbols, "garbage" parameters drawn from [-4, 4) with
    a few NaN and inf; the decode mode on the largest wave, the encode
    mode on every symbol."""
    mode, pk = kind
    prog = program(*shape[:3], device, *shape[3:])
    rows = _wave_plane(rng, prog, pk, images)
    R, F = rows.shape[0], prog.num_fine
    if pk == "valid":
        from .codec.pipeline_torch import fit_predictors

        taps, target, ks = prog.fit_samples[False]
        sizes = [k.shape[0] for k in ks]
        vp, wp = fit_predictors(torch.split(rows[:, taps], sizes, dim=1),
                                torch.split(rows[:, target], sizes, dim=1), None)
    else:
        par = rng.uniform(-4, 4, size=(2, R, F, 6)).astype(np.float32)
        par.reshape(-1)[rng.choice(par.size, size=max(1, par.size // 50), replace=False)] = (
            np.float32("nan"))
        par.reshape(-1)[rng.choice(par.size, size=max(1, par.size // 50), replace=False)] = (
            np.float32("inf"))
        vp, wp = (_t(p).to(prog.device) for p in par)
    if mode == "decode":
        return (rows, prog.records, vp, wp, prog.channels, largest_wave(prog)[0]), ()
    if mode != "encode":
        raise ValueError(f"unknown wave_contexts mode {mode!r}")
    return (rows, prog.records, vp, wp, prog.channels), ()


def finish_problem(rng, shape, kind, device, images: int = 0):
    """wave_finish's operands (args, extra) on the largest wave of the grid
    program of `shape`: kernel 3's [1, B, rows, C, NL] symbols ("valid"
    small, geometric as residuals are; "garbage" uniform over [0, 1024),
    what kernel 3 decodes from a garbage stream), predictions from
    [-255, 255], the program's records (with V's slot order) and zeroed
    plane rows of the main path's layout."""
    prog = program(*shape[:3], device, *shape[3:])
    wave, wd = largest_wave(prog)
    B, C, nl, dev = max(images, 1), prog.channels, prog.nl, prog.device
    size = (1, B, wd.rows, C, nl)
    if kind == "valid":
        syms = np.minimum(rng.geometric(0.1, size=size) - 1, ALPHABET_SIZE - 1)
    elif kind == "garbage":
        syms = rng.integers(0, ALPHABET_SIZE, size=size)
    else:
        raise ValueError(f"unknown problem kind {kind!r}")
    syms = _t(syms.astype(np.int32)).to(dev)
    preds = _t(rng.integers(-255, 256, size=(B * C, wd.kw)).astype(np.int32)).to(dev)
    plane = L.zero_plane(B, C, prog.n_slots, dev).reshape(B * C, -1)
    return (syms, preds, prog.records, wave, plane, C), ()


def encode_problem(rng, R: int, C: int, NL: int, images: int = 0):
    """encode_scan's operands on the CPU: rans_problem, or for images > 0 a
    batch of schedule_problems on one shared row map ([B, C, K] symbols
    and buckets, [B, C, ...] tables)."""
    if not images:
        return rans_problem(rng, R, C, NL)
    sizes = draw_wave_sizes(rng, R, NL)
    probs = [schedule_problem(rng, sizes, C, NL) for _ in range(images)]
    sym, bkt, row_k0, row_len = (torch.stack([p[k] for p in probs]) for k in range(4))
    freqs, cdfs, bits = (torch.stack([p[k] for p in probs]) for k in range(4, 7))
    return sym, bkt, row_k0[0], row_len[0], freqs, cdfs, bits


def problem(name: str, rng, shape, kind=None, device="cpu", images: int = 0):
    """(positional args, extra args) for kernel `name` at `shape`:
    encode_scan and decode_scan_wave (R, C, NL), on the CPU; decode_steps
    (h, w, c, mode) on `device` (step_problem);
    forward_lift_quantize_pixels and dequantize_inverse_lift_pixels
    (h, w, c) on `device`, the program of that image; wave_contexts (h, w,
    c[, mode]) and wave_finish (h, w, c) on `device` (wave_problem,
    finish_problem). `kind` picks decode_scan_wave's and wave_finish's
    problem (DECODE_KINDS), W's (mode, problem kind) (default ("decode",
    "valid")), kernel B's transform id (0-3) and kernel A's (transform id,
    qdiv kind) (default (0, "lossy")); transform_counts (h, w) on the CPU
    (counts_problem; kind "lossless", the default, or "lossy"); fit_stats
    (h, w, c) on `device`, kind a (FIT_PLANES, FIT_OVERRIDES) pair
    (fit_problem; default ("valid", "none")).
    images: 0 for one image without a batch axis, else the batch size."""
    if name == "decode_scan_wave":
        return decode_problem(rng, *shape, kind, images), ()
    if name == "decode_steps":
        ops = step_problem(rng, *shape, kind or "valid", device, images)
        return ops[:-1], ops[-1:]
    if name == "dequantize_inverse_lift_pixels":
        return lift_pixels_problem(rng, program(*shape, device), kind or 0, images)
    if name == "forward_lift_quantize_pixels":
        kind = kind or (0,)
        return lift_head_problem(rng, program(*shape, device), *kind, images=images)
    if name == "wave_contexts":
        return wave_problem(rng, shape, kind or ("decode", "valid"), device, images)
    if name == "wave_finish":
        return finish_problem(rng, shape, kind or "valid", device, images)
    if name == "transform_counts":
        return counts_problem(rng, *shape, kind or "lossless", images), ()
    if name == "fit_stats":
        return fit_problem(rng, shape, kind or ("valid", "none"), device, images)
    if kind is not None:
        raise ValueError(f"{name} has no problem kinds")
    if name == "encode_scan":
        return encode_problem(rng, *shape, images), (shape[2],)
    raise KeyError(name)


def _to(a, device):
    if isinstance(a, dict):
        return {k: v.to(device) for k, v in a.items()}
    if isinstance(a, tuple):
        return tuple(_to(x, device) for x in a)
    return (a.to(device) if isinstance(a, (torch.Tensor, SD.StepOperands, WC.Records, FS.FitTable))
            else a)


def _max_abs_err(a, b) -> int:
    """The largest difference of two outputs: of integers their values, of
    float32 their bit patterns (0: bit-equal, NaNs included)."""
    if isinstance(a, tuple):
        return max(_max_abs_err(x, y) for x, y in zip(a, b))
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.dtype == torch.bool:
        a, b = a.to(torch.int64), b.to(torch.int64)
    if a.dtype == torch.float32:
        a, b = a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median time of fn() on the current CUDA stream, CUDA events (host
    work inside fn counts where the device waits for it)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, reps: int = 20) -> float:
    """Device time (ms) per fn() of `reps` calls run back to back: a sleep
    kernel keeps the device busy while the host enqueues them, so the host's
    share per call drops out. Raises if the host cannot get ahead."""
    import time

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    cycles = int(2e9 * (2 * reps * (time.perf_counter() - t) + 1e-3))
    for _ in range(4):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t) * 1e3
        ev[2].record()
        ev[2].synchronize()
        if host_ms < ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / reps
        cycles *= 2
    raise RuntimeError("the host did not get ahead of the device")


def _nbytes(a) -> int:
    if isinstance(a, (tuple, list)):
        return sum(_nbytes(x) for x in a)
    if isinstance(a, dict):
        return sum(_nbytes(x) for x in a.values())
    return a.numel() * a.element_size() if isinstance(a, torch.Tensor) else 0


def bytes_moved(name: str, args, out) -> int:
    """The bytes kernel `name` must move on these operands: every input
    read once and every output written once; of decode_scan_wave's stream,
    only the words the wave consumes (the rest is padding it never reads);
    of kernel B's, the T*512 columns of each coefficient row and not
    pix_inv, which only the plain version reads; of kernel A's, the pixels,
    leaf_pix, qdiv and the T*512 + 1 columns it writes a channel; of
    transform_counts', the pixels of the proxy's subsample and the counts."""
    if name == "dequantize_inverse_lift_pixels":
        qplane, nm, lm, qdiv, leaf_pix, _ = args
        used = qplane.shape[0] * nm.numel() * qplane.element_size()
        return used + _nbytes((nm, lm, qdiv, leaf_pix)) + _nbytes(out)
    if name == "decode_steps":
        # the work's bytes, whatever the layout: 32 bytes of fields an active
        # symbol and the step map, once for the batch; per image and channel
        # 4 bytes a tap of an active symbol and the words consumed; the
        # states, tables and parameters; the plane (the output) written once
        x, gptr, steps, vparams, wparams, stream, tabs = args[:7]
        rows = x.numel() // x.shape[-1]  # images x channels
        taps = int((steps.rec[:, 1:1 + SD.TAPS] >= 0).sum()) * rows * 4
        used = int((out[2] - gptr).sum())
        return (steps.num_symbols * SD.REC_WORDS * 4 + _nbytes(steps.step_map) + taps
                + _nbytes((x, gptr, vparams, wparams, tabs)) + used * stream.element_size()
                + _nbytes(out))
    if name == "wave_contexts":
        # the records of the symbols, each distinct tap value a row needs
        # (an absent tap reads the zero slot, no memory traffic) and the
        # encode mode's targets, the parameters, the outputs
        plane, records, vparams, wparams = args[:4]
        wave = args[5] if len(args) > 5 else None
        k0, kw = (wave[0], wave[1]) if wave is not None else (0, records.num_symbols)
        rec = records.rec[k0:k0 + kw]
        taps = rec[:, 1:1 + WC.TAPS]
        reads = torch.unique(taps[taps < records.n_slots]).numel()
        if wave is None:
            reads += kw
        return (kw * WC.REC_WORDS * 4 + reads * plane.shape[0] * 4
                + _nbytes((vparams, wparams)) + _nbytes(out))
    if name == "transform_counts":
        pixels, h, w = args[:3]
        s = CT._proxy_stride(h, w)
        images = pixels.shape[0] if pixels.dim() == 3 else 1
        return images * -(-h // s) * -(-w // s) * 3 + _nbytes(out)
    if name == "fit_stats":
        # each pass: the 28 B of slots a sample once for the batch and the
        # 28 B of values a sample and row; the pinned and fitted
        # parameters; the outputs
        rows, table, overrides = args
        vp, _, use_w = overrides if overrides is not None else (None, None, False)
        passes = (vp is None) + (not use_w)
        n = table.samples.shape[1]
        return (passes * 28 * n * (1 + rows.shape[0])
                + (_nbytes(overrides[:2]) if overrides is not None else 0) + _nbytes(out))
    if name == "wave_finish":
        # the wave's slots, its symbols and predictions, the stored values
        syms, preds = args[:2]
        return 3 * preds.numel() * 4 + preds.shape[1] * 4
    if name != "decode_scan_wave":
        return _nbytes(args) + _nbytes(out)
    x, gptr, buckets, active, stream, tabs = args
    used = int((out[2] - gptr).sum())  # the words every image consumes
    return (_nbytes((x, gptr, buckets, active, tabs)) + used * stream.element_size()
            + _nbytes(out))


def check(name: str, shape, device, seed: int = 0, timed: bool = False,
          kind=None, clusters=(0,), images: int = 0) -> dict:
    """Kernel `name` vs its plain version on the same `device` tensors at
    `shape` (problem `kind`, see problem(); a batch of `images` images, 0:
    one without a batch axis): check_args on problem()'s operands."""
    args, extra = problem(name, np.random.default_rng(seed), shape, kind, device, images)
    return check_args(name, args, extra, device, timed, clusters,
                      {"shape": list(shape), "images": images, "kind": kind})


def _design_kw(name: str, size) -> dict:
    """The wrapper's keywords for an entry of check_args' `clusters`: a
    cluster size (0: the launch rule) or, for decode_steps, "block" (the
    one-block variant forced)."""
    if name not in CLUSTERED:
        return {}
    if size == "block":
        if name != "decode_steps":
            raise ValueError(f"{name} has no one-block variant to force")
        return {"flags": SD.FORCE_BLOCK}
    return {"cluster": size}


def _fresh(name: str, args) -> tuple:
    """The operands of one call: wave_finish stores into its plane, so
    each compared call gets its own copy."""
    if name == "wave_finish":
        return args[:4] + (args[4].clone(),) + args[5:]
    return args


def check_args(name: str, args, extra, device, timed: bool = False, clusters=(0,),
               info=None) -> dict:
    """Kernel `name` vs its plain version on operands (args, extra), moved
    to `device`. decode_scan_wave and decode_steps run at each entry of
    `clusters` (a cluster size, 0: the launch rule; for decode_steps also
    "block", its one-block variant) against one plain result. Returns
    {**info ("shape", "images", "kind"), "cluster" (the size the first of
    `clusters` ran at; None for the other kernels; decode_steps also
    "variant", "per" and "prefetch" of its plan), "max_abs_err" (the
    largest over `clusters`), "errs" ({entry: err}), "bytes", "bound_ms",
    "ms" (device_ms of the wrapper), "wrapper_ms" (median_ms of the
    wrapper, the host's share included), "plain_ms"} (times None unless
    timed; a timed clustered kernel also gives "cluster_ms" {entry: device
    ms}; W and V also "floor_ms", wave_floor_ms; fit_stats "library_ms",
    fit_predictors' median_ms on the samples gathered beforehand)."""
    wrapper, plain, _, _ = KERNELS[name]
    args = tuple(_to(a, device) for a in args)
    extra = tuple(_to(a, device) for a in extra)
    clustered = name in CLUSTERED
    if not clustered and tuple(clusters) != (0,):
        raise ValueError(f"{name} has no cluster size")
    ref = plain(*_fresh(name, args), *extra)
    errs = {}
    for size in clusters:
        errs[size] = _max_abs_err(wrapper(*_fresh(name, args), *extra, **_design_kw(name, size)),
                                  ref)
    ran, plan = None, {}
    if clustered and device.type == "cuda":
        ca = args[-1]["bits"].shape[-1]
        x = args[0]
        if name == "decode_scan_wave":
            ran = RT.decode_plan(x.shape[-2], x.shape[-1], ca, clusters[0])[0]
        else:
            p = SD.decode_steps_plan(x.shape[-2], x.shape[-1], ca, args[3].shape[-2],
                                     args[2].max_len, **_design_kw(name, clusters[0]))
            ran, plan = p.cluster, {"variant": p.variant, "per": p.per, "prefetch": p.prefetch}
    nbytes = bytes_moved(name, args, ref)
    out = {**(info or {}), "name": name, "cluster": ran, **plan,
           "max_abs_err": max(errs.values()), "errs": errs, "bytes": nbytes,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "ms": None, "wrapper_ms": None, "plain_ms": None}
    if timed:
        kw = _design_kw(name, clusters[0])
        call = lambda: wrapper(*args, *extra, **kw)  # noqa: E731
        out["ms"] = device_ms(call)
        out["wrapper_ms"] = median_ms(call)
        slow = name == "decode_steps"  # a torch loop over thousands of steps
        out["plain_ms"] = median_ms(lambda: plain(*args, *extra), reps=3 if slow else 20,
                                    warmup=1 if slow else 3)
        if name in WAVE_KERNELS:
            out["floor_ms"] = wave_floor_ms(name, args, device)
        if name == "fit_stats":
            # the library chain the kernels replace: fit_predictors' einsums,
            # casts and cuBLAS/cuSOLVER solves on the gathered samples
            Xs, ys = FS._gather(args[0], args[1])
            out["library_ms"] = median_ms(lambda: FS.fit_predictors(Xs, ys, args[2]))
        if clustered:
            out["cluster_ms"] = {
                size: device_ms(lambda: wrapper(*args, *extra, **_design_kw(name, size)))
                for size in clusters
            }
    return out


def wave_floor_ms(name: str, args, device) -> float:
    """Device ms of an empty launch of kernel W's or V's grid at the
    operands `args` (check_args'): the launch plan's persistent blocks
    with the kernel's shared memory, the floor of one launch of it
    (ops/wave_ctx.launch_floor)."""
    if name == "wave_contexts":
        plane, records, _, _, C = args[:5]
        wave = args[5] if len(args) > 5 else None
        symbols = records.num_symbols if wave is None else -(-wave[1] // wave[2]) * wave[2]
        images, encode = plane.shape[0] // C, wave is None
    else:
        syms, _, _, wave, _, C = args
        symbols, images, encode = wave[1], syms.shape[1], False
    return device_ms(lambda: WC.launch_floor(name, symbols, images, C, device, encode))


def finish_orders_ms(shape, device, images: int = 0, count: int = 6) -> list:
    """Kernel V walking a wave in schedule order and in slot order on
    `count` waves of the grid program of `shape` spread over its wave
    sizes (the smallest to the largest), valid symbols of `images` images
    (0: one): [{"pairs": the wave's (symbol, image) pairs, "schedule": ms,
    "slot": ms}] (device_ms), what wave_ctx.SLOT_ORDER_MIN is set from.
    Raises unless both walks are bit-equal to the plain version."""
    from .codec.grid_decode import wave_starts

    prog = program(*shape, device)
    B, C, nl = max(images, 1), prog.channels, prog.nl
    waves = sorted((wd.kw, k0, wd.rows) for wd, k0 in zip(prog.waves, wave_starts(prog.waves))
                   if wd.kw)
    pick = sorted({round(i * (len(waves) - 1) / max(count - 1, 1)) for i in range(count)})
    rng = np.random.default_rng(11)
    out = []
    for kw, k0, rows in (waves[i] for i in pick):
        syms = np.minimum(rng.geometric(0.1, size=(1, B, rows, C, nl)) - 1, ALPHABET_SIZE - 1)
        syms = _t(syms.astype(np.int32)).to(device)
        preds = _t(rng.integers(-255, 256, size=(B * C, kw)).astype(np.int32)).to(device)
        plane = L.zero_plane(B, C, prog.n_slots, device).reshape(B * C, -1)
        args = (syms, preds, prog.records, (k0, kw, nl), plane, C)
        ref = WC.wave_finish_plain(*args[:4], plane.clone(), C)
        row = {"pairs": kw * B}
        for walk, slot in (("schedule", False), ("slot", True)):
            got = WC.wave_finish(*args[:4], plane.clone(), C, slot_order=slot)
            if not bool((got == ref).all()):
                raise AssertionError(f"wave_finish in {walk} order disagrees on wave {k0}")
            row[walk] = device_ms(lambda s=slot: WC.wave_finish(*args, slot_order=s))
        out.append(row)
    return out


def finish_sectors(prog) -> dict:
    """The distinct 32-byte sectors a warp's 32 stores of V touch in a
    plane row, on average over the warps of the program's largest wave
    (counted from the records on the host), walking the wave in schedule
    order ("schedule") and in slot order ("slot order"); and, in slot
    order, the sectors of the warp's prediction loads (schedule order
    reads 4 consecutive sectors)."""
    (k0, kw, _), _ = largest_wave(prog)
    slots = prog.records.slots[k0:k0 + kw].cpu().numpy().astype(np.int64)
    order = np.argsort(slots, kind="stable")

    def per_warp(idx):
        n = -(-idx.size // 32) * 32
        pad = np.concatenate([idx, np.full(n - idx.size, idx[-1])]).reshape(-1, 32) // 8
        srt = np.sort(pad, axis=1)
        return float(np.mean(1 + (np.diff(srt, axis=1) != 0).sum(axis=1)))

    return {"schedule": per_warp(slots), "slot order": per_warp(slots[order]),
            "slot order preds": per_warp(order), "kw": int(kw)}


# kernel D's design sweep: name -> (cluster size, flags, operands' layout);
# each switches one feature of the launch rule's design off
STEP_DESIGNS = {
    "rule": (0, 0, None),
    "no prefetch": (0, SD.NO_PREFETCH, None),
    "prefetch": (0, SD.PREFETCH, None),
    "slot taps (no schedule-order plane)": (0, 0, SD.slot_records),
    "padded [S, NL] records (PR 7's operands)": (0, 0, SD.padded_records),
    "one block forced": (0, SD.FORCE_BLOCK, None),
    **{f"cluster {s} forced": (s, 0, None) for s in CLUSTERS},
    **{f"cluster {s} forced, prefetch": (s, SD.PREFETCH, None) for s in CLUSTERS},
}


def step_design_ms(args, extra, device, designs=None) -> dict:
    """Kernel D at each design of `designs` (names of STEP_DESIGNS, all by
    default) on one problem (args, extra as check_args takes them): each
    must be bit-equal to the plain version (raises otherwise). Returns
    {name: (StepPlan, device ms)}, (None, reason) where the plan refuses
    the design."""
    args = tuple(_to(a, device) for a in args)
    extra = tuple(_to(a, device) for a in extra)
    x, gptr, steps, vparams = args[:4]
    ca = args[6]["bits"].shape[-1]
    ref = SD.decode_steps_plain(*args, *extra)
    out = {}
    for name in designs or STEP_DESIGNS:
        cluster, flags, layout = STEP_DESIGNS[name]
        ops = layout(steps) if layout else steps
        try:
            plan = SD.decode_steps_plan(x.shape[-2], x.shape[-1], ca, vparams.shape[-2],
                                        steps.max_len, cluster, flags | ops.flags)
        except RuntimeError as e:
            out[name] = (None, str(e))
            continue
        a = args[:2] + (ops,) + args[3:]

        def call():
            return SD.decode_steps(*a, *extra, cluster=cluster, flags=flags)

        err = _max_abs_err(call(), ref)
        if err:
            raise AssertionError(f"decode_steps design {name!r}: disagrees with its plain "
                                 f"version ({err})")
        out[name] = (plan, device_ms(call))
    return out


def step_floor_ms(steps: int, device) -> float:
    """Device ms of `steps` empty steps of kernel D's one-block variant
    (step_decode.step_floor_loop)."""
    return device_ms(lambda: SD.step_floor_loop(steps, device))


def encode_design_ms(shape, device, seed: int = 7) -> dict:
    """Kernel C at each design point (ENCODE_AHEAD x ENCODE_THREADS) on one
    seeded problem at `shape` (R, C, NL): each must be bit-equal to the
    plain version (raises otherwise). Returns {(ahead, threads): device
    ms}."""
    args, extra = problem("encode_scan", np.random.default_rng(seed), shape)
    args = tuple(a.to(device) for a in args)
    ref = RT.encode_scan_plain(*args, *extra)
    out = {}
    for ahead in ENCODE_AHEAD:
        for threads in ENCODE_THREADS:
            def call():
                return RT.encode_scan(*args, *extra, ahead=ahead, threads=threads)

            err = _max_abs_err(call(), ref)
            if err:
                raise AssertionError(f"encode_scan {tuple(shape)} ahead {ahead} threads "
                                     f"{threads}: disagrees with its plain version ({err})")
            out[(ahead, threads)] = device_ms(call)
    return out


def lift_pixels_store_ms(shape, device, seed: int = 7) -> tuple:
    """Kernel B's pixel scatter in isolation, on the program of the h x w
    x c image `shape`: (device ms of the kernel, device ms with every
    leaf out of bounds, leaf_pix all -1, so that it does all its work but
    the byte stores)."""
    args, extra = problem("dequantize_inverse_lift_pixels", np.random.default_rng(seed),
                          shape, 0, device)
    skip = args[:4] + (torch.full_like(args[4], -1),) + args[5:]
    return tuple(device_ms(lambda a=a: L.dequantize_inverse_lift_pixels(*a, *extra))
                 for a in (args, skip))


def lift_head_read_ms(shape, device, seed: int = 7) -> tuple:
    """Kernel A's pixel reads in isolation, on the program of the h x w x c
    image `shape` (lossless qdiv): (device ms of the kernel, device ms with
    every leaf out of bounds, leaf_pix all -1, so that it reads leaf_pix,
    lifts zeros and writes the whole plane but reads no pixel)."""
    args, extra = problem("forward_lift_quantize_pixels", np.random.default_rng(seed),
                          shape, (0, "lossless"), device)
    skip = (args[0], torch.full_like(args[1], -1), args[2])
    return tuple(device_ms(lambda a=a: L.forward_lift_quantize_pixels(*a, *extra))
                 for a in (args, skip))


def lift_head_tiles_ms(shape, device, seed: int = 7, images: int = 0) -> dict:
    """Kernel A at every tiles a block (1 .. 16 // C) on the program of the
    h x w x c image `shape` (a batch of `images`, 0: one image), transform
    3 at C = 3, lossy qdiv: each must be bit-equal to the plain version
    (raises otherwise). Returns {tiles: device ms}."""
    kind = (3 if shape[2] == 3 else 0, "lossy")
    args, extra = problem("forward_lift_quantize_pixels", np.random.default_rng(seed),
                          shape, kind, device, images)
    ref = L.forward_lift_quantize_pixels_plain(*args, *extra)
    out = {}
    for tpb in range(1, L.WARPS_BLOCK // shape[2] + 1):
        def call():
            return L.forward_lift_quantize_pixels(*args, *extra, tiles=tpb)

        err = _max_abs_err(call(), ref)
        if err:
            raise AssertionError(f"forward_lift_quantize_pixels {tuple(shape)} tiles {tpb}: "
                                 f"disagrees with its plain version ({err})")
        out[tpb] = device_ms(call)
    return out


# the tp-sharded decode's step kernels (in place on their lane states, so
# checked by chaining them over a decode: tp_check) -> (wrapper, plain
# version, CUDA source, the TPU loop body it replaces)
TP_KERNELS = {
    "tp_decode_row": (
        TD.tp_decode_row,
        TD.tp_decode_row_plain,
        "frave_tpu_torch/csrc/rans_tp_decode.cu",
        "frave_tpu/parallel/sharded.py:926-963 (scanned at :965)",
    ),
    "tp_decode_step": (
        TD.tp_decode_step,
        TD.tp_decode_step_plain,
        "frave_tpu_torch/csrc/rans_tp_decode.cu",
        "frave_tpu/parallel/sharded.py:1203-1280 (scanned at :1282)",
    ),
}


def _tp_kw(fn, wrapper, tabs, dev, design) -> dict:
    """The keywords a chain passes `fn`: the wrapper's slot tables on the
    CPU, or its table image (once a chain) and design (cluster, flags) on
    the card; nothing to a plain version."""
    if fn is not wrapper:
        return {}
    if dev.type == "cpu":
        return {"rtabs": RT._row_tables({k: v[None] for k, v in tabs.items()})}
    cluster, flags = design or (0, 0)
    return {"image": TD.table_image(tabs), "cluster": cluster, "flags": flags}


def tp_row_chain(fn, args, ranks: int, design=None):
    """decode_scan_wave's operands of one image (x0 [C, NL], gptr0, buckets
    [R, C, NL], active [R, NL], stream [W], tabs) decoded by `fn`
    (tp_decode_row or its plain version) with the lanes split over `ranks`
    simulated ranks: each row, every rank's launch, then the counts
    stacked as the gather would, and a last launch a rank that finishes
    the last row; the wrapper at `design` (cluster, flags; None: the
    rule). Returns (syms [R, C, NL] int32, x' [C, NL], gptr' 0-d, launches
    a rank)."""
    x0, gptr0, bkt, act, stream, tabs = args
    R, C, NL = bkt.shape
    L_ = NL // ranks
    dev = x0.device
    win = [slice(s * L_, (s + 1) * L_) for s in range(ranks)]
    xs = [x0[:, w].clone() for w in win]
    need = [torch.zeros((C, L_), dtype=torch.bool, device=dev) for _ in win]
    gptr = [gptr0.reshape(1).clone() for _ in win]
    counts = torch.zeros((ranks, C), dtype=torch.int32, device=dev)
    kw = _tp_kw(fn, TD.tp_decode_row, tabs, dev, design)
    act = act.to(torch.bool)
    syms = torch.zeros((R, C, NL), dtype=torch.int32, device=dev)
    for t in range(R + 1):
        cnts = []
        for s, w in enumerate(win):
            b = bkt[t, :, w].contiguous() if t < R else None
            a = act[t, w].contiguous() if t < R else None
            sy, c, gptr[s] = fn(xs[s], need[s], gptr[s], counts, s, b, a, stream, tabs, **kw)
            if t < R:
                syms[t, :, w] = sy
            cnts.append(c)
        counts = torch.stack(cnts)
    if any(not torch.equal(g, gptr[0]) for g in gptr):
        raise AssertionError("the ranks disagree on the stream position")
    return syms, torch.cat(xs, dim=1), gptr[0][0], R + 1


def tp_step_chain(fn, ops, ranks: int, design=None):
    """decode_steps' operands of one image (x0 [C, NL], gptr0, steps,
    vparams, wparams, stream, tabs, n_slots) decoded by `fn`
    (tp_decode_step or its plain version) with the lanes split over
    `ranks` simulated ranks, each with its own replicated planes: each
    non-empty step, every rank's launch, then the (value, need) outputs
    joined along the lanes as the gather would; a last launch a rank; the
    wrapper at `design` (cluster, flags; None: the rule). Returns (plane
    [C, n_slots] int32, x' [C, NL], gptr' 0-d, launches a rank); raises
    unless every rank's planes agree."""
    x0, gptr0, steps, vparams, wparams, stream, tabs, n_slots = ops
    C, NL = x0.shape
    L_ = NL // ranks
    dev = x0.device
    K = max(steps.num_symbols, 1)
    xs = [x0[:, s * L_:(s + 1) * L_].clone() for s in range(ranks)]
    gptr = [gptr0.reshape(1).clone() for _ in range(ranks)]
    planes = [torch.zeros((C, n_slots), dtype=torch.int32, device=dev) for _ in range(ranks)]
    splanes = [torch.zeros((C, K), dtype=torch.int32, device=dev) for _ in range(ranks)]
    kw = _tp_kw(fn, TD.tp_decode_step, tabs, dev, design)
    todo = [t for t, n in enumerate(steps.step_map[:, 2].tolist()) if n > 0] + [-1]
    gathered, prev = None, -1
    for t in todo:
        outs = []
        for s in range(ranks):
            o, gptr[s] = fn(xs[s], gptr[s], steps, prev, t, gathered, s * L_, vparams, wparams,
                            stream, tabs, planes[s], splanes[s], **kw)
            outs.append(o)
        if t >= 0:
            gathered = torch.cat(outs, dim=2).contiguous()
        prev = t
    for s in range(1, ranks):
        if not (torch.equal(planes[s], planes[0]) and torch.equal(gptr[s], gptr[0])):
            raise AssertionError("the ranks' replicated planes disagree")
    return planes[0], torch.cat(xs, dim=1), gptr[0][0], len(todo)


def tp_problem(name: str, rng, shape, kind: str, device):
    """The operands tp_check chains over: tp_decode_row decode_scan_wave's
    (R, C, NL) problem of `kind` (one image); tp_decode_step decode_steps'
    (h, w, c, mode) one (step_problem)."""
    if name == "tp_decode_row":
        return tuple(_to(a, device) for a in decode_problem(rng, *shape, kind))
    if name == "tp_decode_step":
        return step_problem(rng, *shape, kind, device)
    raise KeyError(name)


def tp_bytes(name: str, ops, ranks: int, words: int) -> int:
    """The bytes one launch of a tp kernel must move for one rank, on
    average over a decode of `words` consumed words: its lane states read
    and written, the row's buckets, activity and symbols (3T) or the
    step's gathered [2, C, NL] and its records (DT), the table image it
    reads (tp_decode.table_image: C channels of image_bytes(CA)) once,
    its output and its share of the words."""
    if name == "tp_decode_row":
        x0, _, bkt, act, _, tabs = ops
        R, C, NL = bkt.shape
        lanes = C * NL // ranks
        per = lanes * (8 * 2 + 2 + 4 + 4) + NL // ranks + ranks * C * 4 + C * 4 + 16
        return per + C * TD.image_bytes(tabs["bits"].shape[-1]) + words * 4 // (R * ranks)
    x0, _, steps, vparams, wparams, _, tabs, _ = ops
    C, NL = x0.shape
    S = max(int((steps.step_map[:, 2] > 0).sum()), 1)
    per = (C * NL // ranks) * (8 * 2 + 4 * 2) + 2 * C * NL * 4 + _nbytes((vparams, wparams))
    per += steps.num_symbols * SD.REC_WORDS * 4 // S  # the records of one step
    return per + C * TD.image_bytes(tabs["bits"].shape[-1]) + words * 4 // (S * ranks)


# the tp kernels' designs: name -> (cluster, flags); each forces a size or
# the tables' copy of the launch rule's design; the last is the first
# kernels' launch shape (one block, a channel's for 3T, the tables copied
# by the threads)
TP_DESIGNS = {
    "rule": (0, 0),
    "one block forced": (0, TD.FORCE_BLOCK),
    **{f"cluster {s} forced": (s, 0) for s in CLUSTERS[1:]},
    "tables by threads": (0, TD.NO_TMA),
    "tables by TMA": (0, TD.TMA),
    "one block, tables by threads": (0, TD.FORCE_BLOCK | TD.NO_TMA),
}


def tp_design_plan(name: str, ops, ranks: int, design):
    """The TPPlan the design (cluster, flags) takes on these operands on
    the card, or the reason the plan refuses it (a str)."""
    C, NL = ops[0].shape
    ca = ops[-1]["bits"].shape[-1] if name == "tp_decode_row" else ops[6]["bits"].shape[-1]
    kind = "row" if name == "tp_decode_row" else "step"
    try:
        return TD.tp_plan(kind, C, NL // ranks, ca, *design, device=ops[0].device)
    except (ValueError, RuntimeError) as e:
        return str(e)


def tp_check(name: str, shape, kind: str, device, ranks: int = 2, seed: int = 0,
             timed: bool = False, cluster: int = 0, flags: int = 0, designs=None) -> dict:
    """A tp kernel chained over a whole decode against its plain version
    chained the same way (bit-equal: states, position, symbols or plane)
    and against the one-card plain decode (decode_scan_wave_plain or
    decode_steps_plain), on `device` tensors, at each design of `designs`
    (names of TP_DESIGNS; default: the one design (cluster, flags), the
    launch rule unless forced; on the card only); a design the plan
    refuses at this shape is skipped and its reason kept. timed: per
    design the device ms of one launch (the middle row of the problem, or
    its widest step, launched back to back on copies of its operands) and
    of an empty launch of its grid, cluster and shared memory (the floor),
    the byte bound and the plain version's median ms. Returns {"name",
    "shape", "kind", "ranks", "max_abs_err" (the largest over the designs
    run), "errs" {design: err}, "plans" {design: TPPlan or the refusal},
    "launches" (a rank), "bytes", "bound_ms", "ms" and "floor_ms" (the
    first design's), "design_ms" and "design_floor_ms" {design: ms},
    "plain_ms"}."""
    wrapper, plain, _, _ = TP_KERNELS[name]
    ops = tp_problem(name, np.random.default_rng(seed), shape, kind, device)
    chain = tp_row_chain if name == "tp_decode_row" else tp_step_chain
    table = {"rule": (cluster, flags)} if designs is None else {d: TP_DESIGNS[d] for d in designs}
    if device.type == "cpu" and any(d != (0, 0) for d in table.values()):
        raise ValueError("the designs are the kernels'; the CPU runs the plain versions")
    ref = chain(plain, ops, ranks)
    one = (RT.decode_scan_wave_plain if name == "tp_decode_row" else SD.decode_steps_plain)(*ops)
    err_one = _max_abs_err(ref[:3], one)
    errs, plans, launches = {}, {}, None
    for d, design in table.items():
        plans[d] = tp_design_plan(name, ops, ranks, design) if device.type == "cuda" else None
        if isinstance(plans[d], str):
            continue
        got = chain(wrapper, ops, ranks, design)
        errs[d] = max(_max_abs_err(got[:3], ref[:3]), err_one)
        launches = got[3]
    words = int(ref[2] - ops[1])  # both problems: (x0, gptr0, ...)
    nbytes = tp_bytes(name, ops, ranks, words)
    out = {"name": name, "shape": list(shape), "kind": kind, "ranks": ranks,
           "max_abs_err": max(errs.values()), "errs": errs, "plans": plans,
           "launches": launches, "bytes": nbytes,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "ms": None, "floor_ms": None,
           "design_ms": {}, "design_floor_ms": {}, "plain_ms": None}
    if timed:
        for d in errs:
            call, call_plain = _tp_one_launch(name, ops, ranks, table[d])
            out["design_ms"][d] = device_ms(call)
            out["design_floor_ms"][d] = tp_floor_ms(name, ops, ranks, table[d])
        first = next(iter(errs))
        out["ms"], out["floor_ms"] = out["design_ms"][first], out["design_floor_ms"][first]
        out["plain_ms"] = median_ms(call_plain, reps=5, warmup=1)
    return out


def tp_floor_ms(name: str, ops, ranks: int, design=(0, 0)) -> float:
    """Device ms of an empty launch of the grid, cluster and dynamic shared
    memory that the design (cluster, flags) takes on these operands
    (tp_decode.launch_floor)."""
    C, NL = ops[0].shape
    kind = "row" if name == "tp_decode_row" else "step"
    ca = (ops[-1] if kind == "row" else ops[6])["bits"].shape[-1]
    dev = ops[0].device
    return device_ms(lambda: TD.launch_floor(kind, C, NL // ranks, ca, dev, *design))


def _tp_one_launch(name: str, ops, ranks: int, design=(0, 0)):
    """Closures that launch one step of rank 0 (the kernel at `design`,
    its table image made once; its plain version) on copies of its
    operands at a representative row or step."""
    cluster, flags = design
    if name == "tp_decode_row":
        x0, g0, bkt, act, stream, tabs = ops
        R, C, NL = bkt.shape
        L_ = NL // ranks
        t = R // 2
        x = x0[:, :L_].clone()
        need = torch.rand((C, L_), device=x.device) < 0.3
        gptr = g0.reshape(1).clone()
        counts = need.sum(1, dtype=torch.int32)[None].repeat(ranks, 1)
        b, a = bkt[t, :, :L_].contiguous(), act[t, :L_].to(torch.bool).contiguous()
        image = TD.table_image(tabs)
        return (lambda: TD.tp_decode_row(x, need, gptr, counts, 0, b, a, stream, tabs,
                                         image=image, cluster=cluster, flags=flags),
                lambda: TD.tp_decode_row_plain(x, need, gptr, counts, 0, b, a, stream, tabs))
    x0, g0, steps, vparams, wparams, stream, tabs, n_slots = ops
    C, NL = x0.shape
    L_ = NL // ranks
    lengths = steps.step_map[:, 2]
    t = int(torch.argmax(lengths))
    prev = max(t - 1, 0)
    x = x0[:, :L_].clone()
    gptr = g0.reshape(1).clone()
    plane = torch.zeros((C, n_slots), dtype=torch.int32, device=x.device)
    splane = torch.zeros((C, max(steps.num_symbols, 1)), dtype=torch.int32, device=x.device)
    gathered = torch.zeros((2, C, NL), dtype=torch.int32, device=x.device)
    gathered[1] = (torch.rand((C, NL), device=x.device) < 0.3).to(torch.int32)
    args = (x, gptr, steps, prev, t, gathered, 0, vparams, wparams, stream, tabs, plane, splane)
    image = TD.table_image(tabs)
    return (lambda: TD.tp_decode_step(*args, image=image, cluster=cluster, flags=flags),
            lambda: TD.tp_decode_step_plain(*args))
