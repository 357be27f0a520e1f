"""Interleaved-lane rANS in PyTorch: the port of frave_tpu/ops/rans_jax.py.

Same wire semantics as the numpy host coder (frave_tpu/ops/rans.py):
32-bit lane states in [2^16, 2^32), 16-bit renorm words, per-context
scale bits <= 14, so each symbol moves at most one word either way. The
u32 states are carried in int64 (torch has no full uint32 arithmetic)
and masked back to 32 bits where a wrap could occur.

  * encode_scan — the reverse scan over the [R, C, NL] lane grid of a
    row map (row_map), reading the symbols in schedule order: kernel C
    (csrc/rans_encode.cu frave_rans_encode) on the card, the plain row
    loop encode_scan_plain (over the grid schedule_grid builds) on the
    CPU.
  * stream_compact_grid — grid mode's decode order IS the flat
    [R, C, NL] order, so compaction is an exclusive prefix sum over the
    emit flags plus one scatter, per image; stream_compact — the parallel
    and parity modes' decode order is schedule.get_stream_perm's, so the
    grid is first gathered into that order, then compacted the same way.
  * pack_u16_pairs — the u16 stream as u32 words (bitcast of pairs).
  * decode_scan_wave — every decode row of one grid wave: kernel 3
    (csrc/rans_decode.cu frave_rans_decode_wave) on the card, the plain
    loop of decode_row on the CPU. decode_tables builds the kernel's
    tables from the cdf staircases and scale bits alone; the plain loop
    derives from them, once per wave, a per-(channel, context) slot ->
    symbol table of 2^14 entries that resolves the symbol ("last symbol
    whose cdf <= slot": zero-frequency symbols own no slot), and hands out
    renorm words in channel-major, lane-minor rank order from the global
    stream.

Every function takes a same-shape batch of B images on a leading axis
(the JAX program's vmap over B), and kernels C and 3 run it in one launch;
one image may come without that axis. What is per image keeps it: the
symbols, buckets, tables, lane states, emission grids, streams and the
stream position. The row map and the row activity are shared.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..entropy.tables import ALPHABET_SIZE, MAX_FREQ_BITS_CAP
from . import _build

RANS_L = 1 << 16
WORD_BITS = 16
_U32 = 0xFFFFFFFF


def _check_grid(name, t, shape, dtypes):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def row_map(wave_sizes, nl: int):
    """The row map for lane count nl: each wave's symbols fill rows of nl
    lanes back to back in schedule order, so row r holds schedule
    positions row_k0[r] .. row_k0[r] + row_len[r] - 1 in lanes
    0 .. row_len[r] - 1 (empty waves take no row). Grid mode passes its
    wave sizes (schedule.grid_row_lane); the parallel and parity modes
    pack all K symbols tightly, row r holding [r*nl, (r+1)*nl), which is
    the map of the one "wave" [K]. Returns (row_k0, row_len) [R] int32
    numpy arrays."""
    k0s, lens = [], []
    k0 = 0
    for ws in (int(w) for w in wave_sizes):
        for i in range(0, ws, nl):
            k0s.append(k0 + i)
            lens.append(min(nl, ws - i))
        k0 += ws
    return np.asarray(k0s, dtype=np.int32), np.asarray(lens, dtype=np.int32)


def schedule_grid(a, row_k0, row_len, nl: int):
    """[..., K] schedule-order values -> the [R, ..., NL] lane grid of the
    row map (0 in the padding slots), and the [R, NL] bool validity of
    its slots."""
    dev = a.device
    lane = torch.arange(nl, device=dev, dtype=torch.int64)
    valid = lane[None, :] < row_len.to(torch.int64)[:, None]
    k = torch.where(valid, row_k0.to(torch.int64)[:, None] + lane[None, :], 0)
    g = torch.where(valid, a[..., k], torch.zeros((), dtype=a.dtype, device=dev))
    return g.movedim(-2, 0).contiguous(), valid


def encode_scan_plain(symbols, buckets, row_k0, row_len, freqs, cdfs, scale_bits, nl,
                      lane0: int = 0, lanes: int = 0):
    """encode_scan as a row loop over [B*C, NL] tensors of the lane grid
    that schedule_grid builds (only the window [lane0, lane0 + lanes) of it
    where `lanes` is given). Returns (states [B, C, NL] int64 in [0, 2^32),
    words [B, R, C, NL] int16 (u16 bits), flags [B, R, C, NL] bool; NL the
    window's width); one image without its batch axis gives them without
    it."""
    if symbols.dim() == 2:
        out = encode_scan_plain(
            symbols[None], buckets[None], row_k0, row_len, freqs[None], cdfs[None],
            scale_bits[None], nl, lane0, lanes,
        )
        return tuple(t[0] for t in out)
    B, C, K = symbols.shape
    win = slice(lane0, lane0 + (lanes or nl - lane0))
    sym_grid, valid_grid = schedule_grid(symbols.reshape(B * C, K), row_k0, row_len, nl)
    bkt_grid, _ = schedule_grid(buckets.reshape(B * C, K), row_k0, row_len, nl)
    sym_grid, valid_grid, bkt_grid = sym_grid[..., win], valid_grid[..., win], bkt_grid[..., win]
    R, BC, NL = sym_grid.shape
    ca = freqs.shape[-2]
    dev = sym_grid.device
    f = freqs.to(torch.int64).reshape(-1) & 0xFFFF
    cd = cdfs.to(torch.int64).reshape(-1) & 0xFFFF
    b = scale_bits.to(torch.int64).reshape(-1)
    chan = torch.arange(BC, device=dev, dtype=torch.int64)[:, None]
    x = torch.full((BC, NL), RANS_L, dtype=torch.int64, device=dev)
    words = torch.empty((R, BC, NL), dtype=torch.int64, device=dev)
    flags = torch.empty((R, BC, NL), dtype=torch.bool, device=dev)
    one = torch.ones((), dtype=torch.int64, device=dev)
    for r in range(R - 1, -1, -1):
        v = valid_grid[r][None, :]
        s = torch.clamp(sym_grid[r].to(torch.int64), 0, ALPHABET_SIZE - 1)
        k = torch.clamp(bkt_grid[r].to(torch.int64), 0, ca - 1)
        ctx = chan * ca + k
        t = ctx * ALPHABET_SIZE + s
        fr = torch.where(v, f[t], one)
        cdv = torch.where(v, cd[t], 0 * one)
        bi = torch.where(v, b[ctx], 8 * one)
        emit = v & ((x >> (32 - bi)) >= fr)
        words[r] = x & 0xFFFF
        flags[r] = emit
        x1 = torch.where(emit, x >> WORD_BITS, x)
        q = torch.div(x1, fr, rounding_mode="floor")
        x2 = ((q << bi) + (x1 - q * fr) + cdv) & _U32
        x = torch.where(v, x2, x1)
    words = (words - ((words >> 15) & 1) * (1 << 16)).to(torch.int16)

    def per_image(g):  # [R, B*C, NL] -> [B, R, C, NL]
        return g.reshape(R, B, C, NL).transpose(0, 1).contiguous()

    return x.reshape(B, C, NL), per_image(words), per_image(flags)


def _check_aligned(name, t):
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def encode_plan(channels: int, lanes: int, contexts: int):
    """Kernel C's launch rule on the current CUDA device: (rows loaded
    ahead, lanes a block) for a grid of channels x lanes, channels the
    lane sets of the whole batch, B * C (csrc/rans_encode.cu plan)."""
    lib = _build.load_library()
    ahead, threads = ctypes.c_int(0), ctypes.c_int(0)
    code = lib.frave_rans_encode_plan(
        channels, lanes, contexts, ctypes.byref(ahead), ctypes.byref(threads)
    )
    _build.check(code, "frave_rans_encode_plan")
    return ahead.value, threads.value


def encode_scan(symbols, buckets, row_k0, row_len, freqs, cdfs, scale_bits, nl: int,
                ahead: int = 0, threads: int = 0, lane0: int = 0, lanes: int = 0):
    """Reverse-scan rANS encode (replaces rans_jax.encode_scan) of a
    same-shape batch over the lane grid of a row map, read in schedule
    order.

    symbols / buckets [B, C, K] int32 (zig-zag symbols / context buckets in
    schedule order); row_k0 / row_len [R] int32 (row_map, shared by the
    batch: row r holds positions row_k0[r] + l in lanes l < row_len[r] <=
    nl, the rest of its nl lanes are padding); freqs / cdfs [B, C, CA,
    1024] int32, read mod 2^16 (the coder's are at most 2^14); scale_bits
    [B, C, CA] int32. The scan runs rows R-1 .. 0; a padding slot emits
    nothing and keeps the state. Returns (final states [B, C, NL] int64 in
    [0, 2^32), words [B, R, C, NL] int16 holding the u16 words, flags
    [B, R, C, NL] bool): words[b, r] is valid where flags[b, r]; decode
    consumes image b's flagged words in increasing r, each image's grid
    contiguous in its flat decode order. One image may come without its
    batch axis (and gets its results without it). Kernel C
    (csrc/rans_encode.cu frave_rans_encode, one launch over the B * C lane
    sets) on the card, encode_scan_plain on the CPU. `ahead` (rows loaded
    ahead: 4, 8 or 16) and `threads` (lanes a block), given together,
    force the kernel's design point for the sweeps; 0 and 0 take its
    launch rule (encode_plan). `lane0` and `lanes` > 0 take only the lanes
    [lane0, lane0 + lanes) of every row (one rank's window of a tp-sharded
    encode; kernel C's frave_rans_encode_lanes): the results then hold
    those lanes alone, NL = lanes."""
    if symbols.dim() == 2:
        out = encode_scan(
            symbols[None], buckets[None], row_k0, row_len, freqs[None], cdfs[None],
            scale_bits[None], nl, ahead, threads, lane0, lanes,
        )
        return tuple(t[0] for t in out)
    if symbols.dim() != 3:
        raise ValueError(f"symbols must be [B, C, K] or [C, K], got {tuple(symbols.shape)}")
    B, C, K = symbols.shape
    R = row_k0.shape[0]
    ca = freqs.shape[-2]
    i32 = (torch.int32,)
    _check_grid("symbols", symbols, (B, C, K), i32)
    _check_grid("buckets", buckets, (B, C, K), i32)
    _check_grid("row_k0", row_k0, (R,), i32)
    _check_grid("row_len", row_len, (R,), i32)
    _check_grid("freqs", freqs, (B, C, ca, ALPHABET_SIZE), i32)
    _check_grid("cdfs", cdfs, (B, C, ca, ALPHABET_SIZE), i32)
    _check_grid("scale_bits", scale_bits, (B, C, ca), i32)
    if not 1 <= nl < 1 << 31:
        raise ValueError(f"nl must be positive, got {nl}")
    width = lanes or nl
    if lanes < 0 or lane0 < 0 or lane0 + width > nl or (lane0 and not lanes):
        raise ValueError(f"lane window [{lane0}, {lane0} + {lanes}) is not within {nl} lanes")
    if not 1 <= B * C <= 65535:
        raise ValueError(f"a launch takes 1 to 65535 lane sets (B * C), got {B * C}")
    if (ahead == 0) != (threads == 0):
        raise ValueError("ahead and threads force a design point together")
    dev = symbols.device
    if dev.type == "cpu":
        return encode_scan_plain(
            symbols, buckets, row_k0, row_len, freqs, cdfs, scale_bits, nl, lane0, lanes
        )
    if dev.type != "cuda":
        raise RuntimeError(f"no kernel for device {dev}")
    ops = (buckets, row_k0, row_len, freqs, cdfs, scale_bits)
    if any(t.device != dev for t in ops):
        raise ValueError(f"all operands must lie on {dev}")
    _check_aligned("freqs", freqs)
    _check_aligned("cdfs", cdfs)
    if K == 0:  # the kernel reads position 0 of every padding slot
        symbols = buckets = torch.zeros((B, C, 1), dtype=torch.int32, device=dev)
    lib = _build.load_library()
    words = torch.empty((B, R, C, width), dtype=torch.int16, device=dev)
    flags = torch.empty((B, R, C, width), dtype=torch.uint8, device=dev)
    states = torch.empty((B, C, width), dtype=torch.int64, device=dev)
    ptrs = (symbols.data_ptr(), buckets.data_ptr(), row_k0.data_ptr(), row_len.data_ptr(),
            freqs.data_ptr(), cdfs.data_ptr(), scale_bits.data_ptr(),
            words.data_ptr(), flags.data_ptr(), states.data_ptr())
    if lanes:
        code = lib.frave_rans_encode_lanes(
            *ptrs, R, C, B, width, ca, symbols.shape[2], lane0, ahead, threads,
            _build.current_stream(dev),
        )
    else:
        code = lib.frave_rans_encode(
            *ptrs, R, C, B, nl, ca, symbols.shape[2], ahead, threads, _build.current_stream(dev),
        )
    _build.check(code, "frave_rans_encode")
    encode_scan.launches += 1
    return states, words, flags.view(torch.bool)


encode_scan.launches = 0


def stream_compact_grid(words: torch.Tensor, flags: torch.Tensor, kc: int):
    """Pack the flagged words of each image's [R, C, NL] emission grid
    (words / flags [B, R, C, NL]), in flat (decode) order, into the image's
    stream: an exclusive prefix sum of the image's flags gives each flagged
    word its position; one scatter writes them all (the unflagged ones land
    on the discard slot kc). Returns (streams [B, kc] int16 with zero
    tails, totals [B] int64); one image's grid [R, C, NL] gives ([kc], a
    0-d total)."""
    if words.dim() == 3:
        stream, total = stream_compact_grid(words[None], flags[None], kc)
        return stream[0], total[0]
    B = words.shape[0]  # [B, R, C, NL], or [B, N] already flat
    f = flags.reshape(B, -1)
    w = words.reshape(B, -1)
    csum = torch.cumsum(f.to(torch.int64), dim=1)
    dst = torch.where(f, csum - 1, torch.full_like(csum, kc))
    buf = torch.zeros((B, kc + 1), dtype=words.dtype, device=words.device)
    buf.scatter_(1, dst, w)
    total = csum[:, -1] if csum.shape[1] else csum.new_zeros((B,))
    return buf[:, :kc], total


def stream_compact(words: torch.Tensor, flags: torch.Tensor, perm: torch.Tensor, kc: int):
    """stream_compact_grid for the parallel and parity modes, whose decode
    order is not the flat grid order: the [B, R, C, NL] words and flags
    are gathered into decode-rank order through perm [kc] int64
    (schedule.get_stream_perm: rank j -> flat grid slot), then packed by a
    prefix sum and one scatter. Returns (streams [B, kc], totals [B]); one
    image's grid [R, C, NL] gives ([kc], a 0-d total)."""
    if words.dim() == 3:
        stream, total = stream_compact(words[None], flags[None], perm, kc)
        return stream[0], total[0]
    B = words.shape[0]
    w = words.reshape(B, -1)[:, perm]
    f = flags.reshape(B, -1)[:, perm]
    return stream_compact_grid(w, f, kc)


def pack_u16_pairs(stream: torch.Tensor) -> torch.Tensor:
    """[..., W] int16 (u16 words) -> [..., ceil(W/2)] int32 with word 2i in
    the low half and word 2i+1 in the high half (the JAX bitcast pack)."""
    W = stream.shape[-1]
    out = stream.new_zeros(stream.shape[:-1] + (W + W % 2,))
    out[..., :W] = stream
    return out.view(torch.int32)


def decode_tables(cdfs: torch.Tensor, scale_bits: torch.Tensor):
    """Cdf staircases [..., C, CA, 1024] and scale bits [..., C, CA] (nothing else,
    as pallas_rans.prepare_scan_tables) -> the decode tables "cdf"
    [C, CA, 1024] int32 and "bits" [C, CA] int32, clamped to the coder's
    range (bits <= 14, cdf <= 2^14) so that both versions read the same
    values."""
    bits = scale_bits.to(torch.int64).clamp(0, MAX_FREQ_BITS_CAP)
    cd = cdfs.to(torch.int64).clamp(0, 1 << MAX_FREQ_BITS_CAP)
    return {"cdf": cd.to(torch.int32).contiguous(), "bits": bits.to(torch.int32).contiguous()}


def _row_tables(tabs):
    """The plain row's lookup tables from decode_tables': "slot_sym"
    [..., C, CA, 2^14] int64, slot -> the last symbol whose cdf <= slot (0
    where none is), and "cdf_ext" [..., C, CA, 1025] int64, the staircase
    with 2^bits appended, so that cdf_ext[sym + 1] bounds sym's run."""
    cd = tabs["cdf"].to(torch.int64)
    bits = tabs["bits"].to(torch.int64)
    slots = torch.arange(1 << MAX_FREQ_BITS_CAP, device=cd.device, dtype=torch.int64)
    slot_sym = (
        torch.searchsorted(cd, slots.expand(cd.shape[:-1] + (-1,)).contiguous(), right=True) - 1
    )
    return {
        "bits": bits,
        "slot_sym": slot_sym.clamp(0, ALPHABET_SIZE - 1),
        "cdf_ext": torch.cat([cd, (1 << bits)[..., None]], dim=-1),
    }


def row_symbols(x, buckets, active, rtabs):
    """The symbol half of a decode row: x [B, C, NL] int64 lane states,
    buckets [B, C, NL] context ids (clamped to 0..CA-1), active [NL] bool,
    rtabs from _row_tables ([B, C, ...]) -> (sym [B, C, NL] int64 on every
    lane, the pre-renorm states x', need = active & (x' < 2^16))."""
    B, C, NL = x.shape
    ca = rtabs["bits"].shape[-1]
    chan = torch.arange(B * C, device=x.device, dtype=torch.int64).reshape(B, C, 1)
    ctx = chan * ca + buckets.to(torch.int64).clamp(0, ca - 1)
    bi = rtabs["bits"].reshape(-1)[ctx]
    top = 1 << bi
    slot = x & (top - 1)
    sym = rtabs["slot_sym"].reshape(-1)[(ctx << MAX_FREQ_BITS_CAP) + slot]
    t = ctx * (ALPHABET_SIZE + 1) + sym
    ext = rtabs["cdf_ext"].reshape(-1)
    cd = ext[t]
    fr = torch.minimum(ext[t + 1], top) - cd
    x_new = (fr * (x >> bi) + slot - cd) & _U32
    return sym, x_new, active & (x_new < RANS_L)


def row_renorm(x_new, need, idx, stream):
    """The renorm half of a decode row: the lanes that need a word (need
    [B, C, NL]) shift in stream[b, idx] (idx [B, C, NL] int64, clamped to
    [0, W - 1]); the others keep x_new. Returns the states."""
    B = x_new.shape[0]
    idx = torch.clamp(idx, 0, stream.shape[1] - 1).reshape(B, -1)
    w = torch.gather(stream, 1, idx).to(torch.int64).reshape(x_new.shape)
    return torch.where(need, ((x_new << WORD_BITS) | w) & _U32, x_new)


def decode_row(x, gptr, buckets, active, stream, rtabs):
    """One rANS decode row for all images x channels x lanes
    (decode_scan_wave's semantics, see there): row_symbols, then
    row_renorm with the words ranked channel-major, lane-minor per image.

    x [B, C, NL] int64 lane states; gptr [B] int64 stream positions;
    buckets [B, C, NL] context ids (clamped to 0..CA-1); active [NL] bool;
    stream [B, W] int32 u16 words; rtabs from _row_tables ([B, C, ...]).
    Returns (sym [B, C, NL] int64, x', gptr')."""
    decode_row.calls += 1
    B = x.shape[0]
    sym, x_new, need = row_symbols(x, buckets, active, rtabs)
    nf = need.reshape(B, -1).to(torch.int64)
    pos = torch.cumsum(nf, dim=1) - 1  # channel-major, lane-minor ranks per image
    x_new = row_renorm(x_new, need, (gptr[:, None] + pos).reshape(x.shape), stream)
    x = torch.where(active, x_new, x)
    return sym, x, gptr + nf.sum(dim=1)


decode_row.calls = 0


def decode_scan_wave_plain(x, gptr, buckets, active, stream, tabs):
    """decode_scan_wave as a Python loop of decode_row over the rows."""
    if gptr.dim() == 0:
        syms, x, gptr = decode_scan_wave_plain(
            x[None], gptr[None], buckets[None], active, stream[None],
            {k: v[None] for k, v in tabs.items()},
        )
        return syms[0], x[0], gptr[0]
    B, R, C, NL = buckets.shape
    act = active.to(torch.bool)
    rtabs = _row_tables(tabs)
    syms = torch.empty((B, R, C, NL), dtype=torch.int32, device=x.device)
    for r in range(R):
        s, x, gptr = decode_row(x, gptr, buckets[:, r], act[r], stream, rtabs)
        syms[:, r] = s
    return syms, x, gptr


def decode_plan(channels: int, lanes: int, contexts: int, cluster: int = 0):
    """Kernel 3's launch plan on the current CUDA device for one image's
    wave of channels x lanes (every image of a batch runs one such
    cluster): (the cluster size it runs, the u32 words of device-memory
    state buffer it needs an image). `cluster`
    0 takes the launch rule (csrc/rans_decode.cu); a power of two up to 16
    forces that size, for the kernel checks, and raises where it cannot be
    resident."""
    lib = _build.load_library()
    size, words = ctypes.c_int(0), ctypes.c_int(0)
    code = lib.frave_rans_decode_plan(
        channels, lanes, contexts, cluster, ctypes.byref(size), ctypes.byref(words)
    )
    _build.check(code, "frave_rans_decode_plan")
    return size.value, words.value


def decode_scan_wave(x, gptr, buckets, active, stream, tabs, cluster: int = 0):
    """Every rANS decode row of one grid wave of a same-shape batch
    (replaces pallas_rans.decode_scan_wave): kernel 3 (csrc/rans_decode.cu
    frave_rans_decode_wave, one launch of B thread-block clusters, one an
    image, for all R rows) on the card, the plain row loop
    decode_scan_wave_plain on the CPU.

    x [B, C, NL] int64 lane states (u32 values); gptr [B] int64 stream
    positions (a device tensor: nothing is read back to the host); buckets
    [B, R, C, NL] int32 context ids, row-major in that order within an
    image (the JAX kernel's layout, which kernel W writes directly:
    wave_ctx.wave_contexts); active [R, NL] bool or uint8 lane
    activity (shared by every image and channel); stream [B, W] int32 u16
    words; tabs from decode_tables ([B, C, ...]). Per image, row and
    (channel, lane):
      slot = x & (2^bits - 1); sym = the last symbol whose cdf <= slot;
      freq = min(cdf[sym + 1], 2^bits) - cdf[sym] (2^bits past the end);
      x' = freq * (x >> bits) + slot - cdf[sym]  (mod 2^32);
    active lanes with x' < 2^16 take one word each, stream[b, gptr[b] +
    rank] with the rank channel-major, lane-minor within the image
    (schedule.build_stream_perm) and the index clamped to [0, W-1];
    inactive lanes keep x. Symbols are computed on every lane. One image
    may come without its batch axis (x [C, NL], gptr 0-d, buckets
    [R, C, NL], stream [W], tabs [C, ...]) and gets its results without
    it. `cluster` forces the kernel's cluster size (decode_plan; 0, the
    launch rule, everywhere but the kernel checks). Returns (syms
    [B, R, C, NL] int32, x', gptr')."""
    if gptr.dim() == 0:
        syms, x, gptr = decode_scan_wave(
            x[None], gptr[None], buckets[None], active, stream[None],
            {k: v[None] for k, v in tabs.items()}, cluster,
        )
        return syms[0], x[0], gptr[0]
    if buckets.dim() != 4:
        raise ValueError(f"buckets must be [B, R, C, NL], got {tuple(buckets.shape)}")
    B, R, C, NL = buckets.shape
    ca = tabs["bits"].shape[-1]
    _check_grid("x", x, (B, C, NL), (torch.int64,))
    _check_grid("gptr", gptr, (B,), (torch.int64,))
    _check_grid("buckets", buckets, (B, R, C, NL), (torch.int32,))
    _check_grid("active", active, (R, NL), (torch.bool, torch.uint8))
    if stream.dim() != 2 or stream.shape[0] != B or not 1 <= stream.shape[1] < 1 << 31:
        raise ValueError(
            f"stream must be [{B}, W] with 1 to 2^31 - 1 words, got {tuple(stream.shape)}"
        )
    _check_grid("stream", stream, tuple(stream.shape), (torch.int32,))
    _check_grid("cdf", tabs["cdf"], (B, C, ca, ALPHABET_SIZE), (torch.int32,))
    _check_grid("bits", tabs["bits"], (B, C, ca), (torch.int32,))
    if not 1 <= B <= 65535:
        raise ValueError(f"a batch holds 1 to 65535 images, got {B}")
    dev = x.device
    if dev.type == "cpu":
        return decode_scan_wave_plain(x, gptr, buckets, active, stream, tabs)
    if dev.type != "cuda":
        raise RuntimeError(f"no kernel for device {dev}")
    ops = (gptr, buckets, active, stream, tabs["cdf"], tabs["bits"])
    if any(t.device != dev for t in ops):
        raise ValueError(f"all operands must lie on {dev}")
    lib = _build.load_library()
    size, words = decode_plan(C, NL, ca, cluster)
    act = active.view(torch.uint8) if active.dtype == torch.bool else active
    syms = torch.empty((B, R, C, NL), dtype=torch.int32, device=dev)
    x_out = torch.empty_like(x)
    g_out = torch.empty_like(gptr)
    # the lane states of several-tile blocks (a forced small cluster)
    work = torch.empty(B * words, dtype=torch.int32, device=dev) if words else None
    code = lib.frave_rans_decode_wave(
        x.data_ptr(), gptr.data_ptr(), buckets.data_ptr(), act.data_ptr(),
        stream.data_ptr(), tabs["cdf"].data_ptr(), tabs["bits"].data_ptr(),
        syms.data_ptr(), x_out.data_ptr(), g_out.data_ptr(),
        None if work is None else work.data_ptr(),
        R, C, NL, ca, stream.shape[1], B, size, _build.current_stream(dev),
    )
    _build.check(code, "frave_rans_decode_wave")
    decode_scan_wave.launches += 1
    return syms, x_out, g_out


decode_scan_wave.launches = 0


def exchange_loop(iters: int, cluster: int, device) -> None:
    """Launch `iters` rows of kernel 3's cross-block exchange alone on one
    cluster of `cluster` blocks (csrc/rans_decode.cu frave_exchange_loop):
    the dependency floor of a wave, timed by chip_smoke.py. Not a kernel of
    the codec path: it has no launch count."""
    lib = _build.load_library()
    sink = torch.zeros(1, dtype=torch.int32, device=device)
    code = lib.frave_exchange_loop(iters, cluster, sink.data_ptr(), _build.current_stream(device))
    _build.check(code, "frave_exchange_loop")
