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

from .entropy.tables import ALPHABET_SIZE, CONTEXT_AMOUNT, _LAPLACE_GRID_ROWS
from .entropy.tables_torch import finalize_contexts_device
from .ops import lifting as L
from .ops import rans_torch as RT
from .ops import step_decode as SD

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
}
# the kernels with a forced cluster size (the others run their launch rule)
CLUSTERED = ("decode_scan_wave", "decode_steps")
# the card's memory rate the byte bound is taken at (H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
# cluster sizes kernel 3 can be forced to
CLUSTERS = (1, 2, 4, 8, 16)
# problem kinds of decode_scan_wave (kernel B's kind is its transform id,
# kernel A's a (transform id, qdiv) pair from QDIV_KINDS; the other kernels
# have one kind, None)
DECODE_KINDS = ("valid", "garbage")
QDIV_KINDS = ("lossless", "lossy")
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


def program(h: int, w: int, c: int, device):
    """The cached CodecProgram of an h x w x c image at its default lane
    count (the main path's)."""
    from .codec.pipeline_torch import get_program
    from .fractal.schedule import default_num_lanes, get_schedule

    nl = default_num_lanes(get_schedule(h, w, mode="grid").num_symbols)
    return get_program(h, w, nl, c, device)


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
    (h, w, c) on `device`, the program of that image. `kind` picks
    decode_scan_wave's problem (DECODE_KINDS), kernel B's transform id
    (0-3) and kernel A's (transform id, qdiv kind) (default (0, "lossy")).
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
    if kind is not None:
        raise ValueError(f"{name} has no problem kinds")
    if name == "encode_scan":
        return encode_problem(rng, *shape, images), (shape[2],)
    raise KeyError(name)


def _to(a, device):
    if isinstance(a, dict):
        return {k: v.to(device) for k, v in a.items()}
    return a.to(device) if isinstance(a, (torch.Tensor, SD.StepOperands)) else a


def _max_abs_err(a, b) -> int:
    if isinstance(a, tuple):
        return max(_max_abs_err(x, y) for x, y in zip(a, b))
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.dtype == torch.bool:
        a, b = a.to(torch.int64), b.to(torch.int64)
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
    leaf_pix, qdiv and the T*512 + 1 columns it writes a channel."""
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
    ms})."""
    wrapper, plain, _, _ = KERNELS[name]
    args = tuple(_to(a, device) for a in args)
    extra = tuple(_to(a, device) for a in extra)
    clustered = name in CLUSTERED
    if not clustered and tuple(clusters) != (0,):
        raise ValueError(f"{name} has no cluster size")
    ref = plain(*args, *extra)
    errs = {}
    for size in clusters:
        errs[size] = _max_abs_err(wrapper(*args, *extra, **_design_kw(name, size)), ref)
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
        if clustered:
            out["cluster_ms"] = {
                size: device_ms(lambda: wrapper(*args, *extra, **_design_kw(name, size)))
                for size in clusters
            }
    return out


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
