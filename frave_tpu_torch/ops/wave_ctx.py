"""The grid wave chain and the encode statistics from schedule records:
kernels W and V (csrc/wave_context.cu) with their plain versions.

Replaces the device work that XLA fused in frave_tpu/codec/grid_decode.py
decode_fused_grid (:326; ctx_of, to_grid and scatter_coefs, :403-471),
the dense grid statistics (:598) and frave_tpu/codec/pipeline_jax.py
step_stats (:469). The JAX package computed each wave's six context taps
as unit shifts of dense lattice grids (gathers were costly on the TPU).
Every tap is a coefficient slot that the schedule already names
(sched_nbr), so a symbol's contexts need only its record and six values of
the plane:

  * Records (records_host, built once a program): rec [K, 8] int32, one
    32-byte record a schedule symbol — the coefficient slot, the six tap
    slots (an absent tap names the zero slot n_slots, which reads 0) and
    lf | (group & 0xFF) << 8 | (fbkt & 0xFF) << 16 — and slots [K] int32,
    the coefficient slots alone (what V reads); a grid program's also
    order [K, 2] int32 (slot_order_host: each wave's symbols in slot
    order, what V walks on large waves).
  * wave_contexts — kernel W (frave_wave_contexts). With wave=(k0, kw,
    nl), the decode of one grid wave (schedule indices [k0, k0 + kw),
    contiguous in schedule order, on rows of nl lanes): buckets in kernel
    3's [B, rows, C, lanes] layout (zero in the pad lanes; the lanes of a
    window for the tp decoder) and predictions [B*C, kw]. With wave=None,
    the statistics of an encode batch: buckets and zig-zag symbols
    [B*C, K] in schedule order. wave_contexts_plain is its plain version
    (torch_ops.contexts on the gathered taps, then the fixed-bucket
    override).
  * wave_finish — kernel V (frave_wave_finish): a wave's values,
    unpack_signed(sym) + pred, stored at the wave's slots of the plane;
    wave_finish_plain is its plain version.
  * The launch plan (plan_rule, launch_plan): both kernels run a
    persistent grid of blocks of BLOCK threads, a few resident on each SM
    (the SM count and the occupancy read once a device and cached), that
    walk tiles of BLOCK / groups consecutive symbols with every image of
    the batch inside the block (groups image groups of threads).

Each wrapper runs its plain version on CPU tensors and its kernel on CUDA
tensors (or raises); the plane is [B*C, >= n_slots + 1] int32 rows with
the zero slot at n_slots, the rows of a same-shape batch image-major.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from . import _build
from . import torch_ops as T

_I32 = torch.int32
_I64 = torch.int64
REC_WORDS = 8  # int32 words of a record (32 bytes)
TAPS = 6
BLOCK = 256  # threads a block of W and V (csrc/wave_context.cu kBlock)
MAX_GROUPS = 8  # image groups a block: tiles of 32 symbols or more
# V walks a wave in slot order (Records.order) from this many (symbol,
# image) pairs on: below it a wave is a few blocks whose time is the loads'
# latency, and the permutation adds a load that the others wait for
SLOT_ORDER_MIN = 1 << 16
# the kernel ids of frave_wave_occupancy / frave_wave_empty
_KERNEL_IDS = {("wave_contexts", False): 0, ("wave_contexts", True): 1, ("wave_finish", False): 2}


@dataclasses.dataclass
class Records:
    """A program's schedule records on one device: rec [K, 8] int32 and
    slots [K] int32 (see the module docstring); n_slots, the plane's zero
    slot; order, V's slot order of the program's waves (with_slot_order;
    None where V never runs: the step programs, the sharded encoder)."""

    rec: torch.Tensor
    slots: torch.Tensor
    n_slots: int
    order: torch.Tensor | None = None

    @property
    def num_symbols(self) -> int:
        return self.rec.shape[0]

    def to(self, device) -> "Records":
        order = None if self.order is None else self.order.to(device)
        return dataclasses.replace(self, rec=self.rec.to(device), slots=self.slots.to(device),
                                   order=order)


def records_host(sched_coef, sched_nbr, sched_lf, sched_group, sched_fbkt,
                 n_slots: int) -> np.ndarray:
    """rec [K, 8] int32 from a schedule's arrays (absent taps, -1, name the
    zero slot n_slots). Raises unless every slot and tap lies in
    [0, n_slots]: W and V touch nothing else of a plane row (a padding
    symbol of the sharded encoder names the zero slot as its own)."""
    coef = np.asarray(sched_coef, np.int64)
    nbr = np.asarray(sched_nbr, np.int64)
    taps = np.where(nbr >= 0, nbr, n_slots)
    refs = np.concatenate([coef[:, None], taps], axis=1)
    if refs.size and (refs.min() < 0 or refs.max() > n_slots):
        raise AssertionError("a record names a slot past the coefficient plane")
    meta = (np.asarray(sched_lf, np.int64) | (np.asarray(sched_group, np.int64) & 0xFF) << 8
            | (np.asarray(sched_fbkt, np.int64) & 0xFF) << 16)
    return np.concatenate([coef[:, None], taps, meta[:, None]], axis=1).astype(np.int32)


def upload(rec: np.ndarray, n_slots: int, device) -> Records:
    """Records on `device` from records_host's array."""
    r = torch.as_tensor(np.ascontiguousarray(rec), device=device).contiguous()
    return Records(r, r[:, 0].contiguous(), n_slots)


def slot_order_host(rec: np.ndarray, waves) -> np.ndarray:
    """[K, 2] int32: for each wave (k0, kw) of `waves` (contiguous schedule
    ranges that cover [0, K) in order), entry k0 + i holds (q, slot) of
    the wave's i-th symbol in slot order, q its position in the wave. V
    walks a large wave through it (wave_finish)."""
    slots = np.asarray(rec)[:, 0]
    k0s = np.array([k0 for k0, _ in waves], dtype=np.int64)
    kws = np.array([kw for _, kw in waves], dtype=np.int64)
    if (k0s != np.concatenate([[0], np.cumsum(kws)[:-1]])).any() or kws.sum() != slots.shape[0]:
        raise ValueError(f"waves {list(waves)[:4]}... do not cover the {slots.shape[0]} symbols "
                         "in order")
    wave_of = np.repeat(np.arange(len(kws)), kws)
    idx = np.lexsort((slots, wave_of))  # by wave, then by slot
    return np.stack([idx - k0s[wave_of], slots[idx]], axis=1).astype(np.int32)


def with_slot_order(records: Records, rec: np.ndarray, waves) -> Records:
    """The records with V's slot order of `waves` attached, on the
    records' device: slot_order_host of `rec`, the host array they were
    uploaded from."""
    order = slot_order_host(rec, waves)
    return dataclasses.replace(records, order=torch.as_tensor(order, device=records.rec.device))


@dataclasses.dataclass(frozen=True)
class WavePlan:
    """A launch of W or V: `groups` image groups of BLOCK / groups threads
    a block, tiles of `tile` consecutive symbols (`tiles` of them over the
    launch's symbols), `blocks` persistent blocks walking them."""

    groups: int
    tile: int
    tiles: int
    blocks: int


def plan_rule(images: int, symbols: int, sms: int, per_sm: int) -> WavePlan:
    """The launch rule on the card's SM count and the blocks of the kernel
    resident on one SM: the most image groups up to the batch size (at
    most MAX_GROUPS, a power of two: a symbol's images spread over that
    many threads of one block, each reading the record once and reusing it
    for its images), and no more blocks than are resident at once or than
    there are tiles."""
    if images < 1 or symbols < 1 or sms < 1 or per_sm < 1:
        raise ValueError(f"no plan for {images} images, {symbols} symbols, {sms} x {per_sm}")
    groups = 1 << (min(images, MAX_GROUPS).bit_length() - 1)
    tile = BLOCK // groups
    tiles = -(-symbols // tile)
    return WavePlan(groups, tile, tiles, min(tiles, sms * per_sm))


@functools.lru_cache(maxsize=None)
def _occupancy(index: int, kernel: int, channels: int) -> tuple:
    """(SMs, blocks resident on one SM) of a kernel instantiation on card
    `index`, read once."""
    lib = _build.load_library()
    sms, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(index):
        code = lib.frave_wave_occupancy(kernel, channels, ctypes.byref(sms), ctypes.byref(per_sm))
    _build.check(code, "frave_wave_occupancy")
    return sms.value, per_sm.value


def launch_plan(name: str, images: int, symbols: int, channels: int, device,
                encode: bool = False) -> WavePlan:
    """plan_rule for kernel `name` ("wave_contexts", its encode mode with
    encode=True, or "wave_finish") at this batch on the card `device`."""
    dev = torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return plan_rule(images, symbols, *_occupancy(index, _KERNEL_IDS[(name, encode)], channels))


def _unpack_meta(meta: torch.Tensor):
    """A record's last word -> (lf bool, group, fbkt) int64."""
    meta = meta.to(_I64)

    def i8(v):
        return v - ((v & 0x80) << 1)

    return (meta & 0xFF) != 0, i8((meta >> 8) & 0xFF), i8((meta >> 16) & 0xFF)


def _layout(plane, records, vparams, wparams, channels: int, wave, lanes):
    """Check W's operands; returns (B, k0, kw, nl, rows, lane_lo,
    lanes_w)."""
    if plane.dim() != 2 or plane.dtype != _I32 or plane.stride(1) != 1:
        raise ValueError("plane must be int32 rows [B*C, S] with a contiguous last dim")
    R = plane.shape[0]
    if channels < 1 or R % channels:
        raise ValueError(f"{R} plane rows are not whole images of {channels} channels")
    B = R // channels
    if not 1 <= B <= 65535:
        raise ValueError(f"a batch holds 1 to 65535 images, got {B}")
    if plane.shape[1] < records.n_slots + 1:
        raise ValueError(f"plane rows must hold the zero slot {records.n_slots}")
    F = vparams.shape[-2] if vparams.dim() == 3 else -1
    for name, p in (("vparams", vparams), ("wparams", wparams)):
        if tuple(p.shape) != (R, F, TAPS) or p.dtype != torch.float32:
            raise ValueError(f"{name} must be f32 [{R}, F, 6], got {p.dtype} {tuple(p.shape)}")
    K = records.num_symbols
    if wave is None:
        if lanes is not None:
            raise ValueError("a lane window is the decode mode's")
        return B, 0, K, 0, 0, 0, 0
    k0, kw, nl = (int(v) for v in wave)
    if not (0 <= k0 and 0 <= kw and k0 + kw <= K and nl >= 1):
        raise ValueError(f"wave {wave} does not lie in the {K} schedule symbols")
    rows = -(-kw // nl)
    lo, width = (0, nl) if lanes is None else (int(v) for v in lanes)
    if not (0 <= lo and 1 <= width and lo + width <= nl):
        raise ValueError(f"lane window {lanes} does not lie in {nl} lanes")
    return B, k0, kw, nl, rows, lo, width


def _contexts(plane, rec, vparams, wparams):
    """Buckets and predictions [R, n] of the records rec [n, 8] int64 on
    the plane rows (torch_ops.contexts, then the fixed-bucket override)."""
    vals = plane[:, rec[:, 1:1 + TAPS]]  # [R, n, 6]
    lf, grp, fbkt = _unpack_meta(rec[:, REC_WORDS - 1])
    bk, pred = T.contexts(vals, lf, grp, vparams, wparams)
    return torch.where(fbkt >= 0, fbkt.to(bk.dtype), bk).to(_I32), pred.to(_I32)


def wave_contexts_plain(plane, records, vparams, wparams, channels: int, wave=None,
                        lanes=None):
    """wave_contexts as torch ops (see there)."""
    B, k0, kw, nl, rows, lo, width = _layout(plane, records, vparams, wparams, channels, wave,
                                             lanes)
    rec = records.rec[k0:k0 + kw].to(_I64)
    bk, pred = _contexts(plane, rec, vparams, wparams)
    if wave is None:
        target = plane[:, rec[:, 0]]
        return bk, T.pack_signed(target - pred).to(_I32)
    bk = torch.nn.functional.pad(bk, (0, rows * nl - kw)).reshape(B, channels, rows, nl)
    return bk.transpose(1, 2)[..., lo:lo + width].contiguous(), pred


def wave_contexts(plane, records: Records, vparams, wparams, channels: int, wave=None,
                  lanes=None):
    """Kernel W (csrc/wave_context.cu frave_wave_contexts) on the card, its
    plain version on the CPU: the contexts of schedule symbols from their
    records (see the module docstring) on a batch's plane rows.

    plane [B*C, S] int32 (S >= n_slots + 1, the zero slot at n_slots
    reading 0; any row stride, last dim contiguous), records a Records,
    vparams / wparams [B*C, F, 6] f32, channels C. Per symbol and (image,
    channel) row: the six tap values at the record's slots, torch_ops.
    contexts with its LF flag and group row, a fixed bucket >= 0 replacing
    the computed one.

    wave=(k0, kw, nl), the decode of one grid wave: returns (buckets
    [B, rows, C, width] int32 — symbol k0 + j on row j // nl, lane j % nl,
    zero past kw; the lanes [lo, lo + width) of lanes=(lo, width), every
    lane by default — and predictions [B*C, kw] int32). wave=None, the
    statistics of an encode batch: returns (buckets, symbols
    pack_signed(plane[slot] - prediction)) [B*C, K] int32 in schedule
    order. One launch either way (none for an empty wave) on the launch
    plan's persistent grid."""
    B, k0, kw, nl, rows, lo, width = _layout(plane, records, vparams, wparams, channels, wave,
                                             lanes)
    dev = plane.device
    if dev.type == "cpu":
        return wave_contexts_plain(plane, records, vparams, wparams, channels, wave, lanes)
    if dev.type != "cuda":
        raise RuntimeError(f"no kernel for device {dev}")
    if any(t.device != dev for t in (records.rec, vparams, wparams)):
        raise ValueError(f"all operands must lie on {dev}")
    R = plane.shape[0]
    if wave is None:
        out0 = torch.empty((R, kw), dtype=_I32, device=dev)
        out1 = torch.empty((R, kw), dtype=_I32, device=dev)
    else:
        out0 = torch.empty((B, rows, channels, width), dtype=_I32, device=dev)
        out1 = torch.empty((R, kw), dtype=_I32, device=dev)
    if kw == 0:
        if out0.numel():
            out0.zero_()
        return out0, out1
    # contiguous rows read as float2 (8-byte aligned)
    vparams, wparams = (p if p.is_contiguous() and p.data_ptr() % 8 == 0
                        else p.clone(memory_format=torch.contiguous_format)
                        for p in (vparams, wparams))
    edges = T._bucket_edges(dev)
    plan = launch_plan("wave_contexts", B, rows * nl if wave is not None else kw, channels, dev,
                       encode=wave is None)
    lib = _build.load_library()
    code = lib.frave_wave_contexts(
        plane.data_ptr(), plane.stride(0), records.rec.data_ptr(), vparams.data_ptr(),
        wparams.data_ptr(), edges.data_ptr(), out0.data_ptr(), out1.data_ptr(), k0, kw, nl,
        lo, width, rows, channels, B, vparams.shape[1], edges.shape[0] + 1,
        0 if wave is not None else 1, plan.groups, plan.blocks, _build.current_stream(dev),
    )
    _build.check(code, "frave_wave_contexts")
    wave_contexts.launches += 1
    return out0, out1


wave_contexts.launches = 0


def _finish_layout(syms, preds, records, wave, plane, channels: int):
    """Check V's operands; returns (k0, kw, nl)."""
    k0, kw, nl = (int(v) for v in wave)
    if syms.dim() != 5 or syms.dtype != _I32 or syms.stride(-1) != 1:
        raise ValueError("syms must be an int32 [parts, B, rows, C, lanes_p] view with "
                         "contiguous lanes")
    P, B, rows, C, Lp = syms.shape
    if C != channels or P * Lp != nl or rows * nl < kw or (rows - 1) * nl >= max(kw, 1):
        raise ValueError(f"syms {tuple(syms.shape)} do not hold the wave {wave}")
    if plane.dim() != 2 or plane.dtype != _I32 or plane.stride(1) != 1 or (
            plane.shape[0] != B * C or plane.shape[1] < records.n_slots):
        raise ValueError(f"plane must be int32 rows [{B * C}, >= {records.n_slots}]")
    if preds.shape != (B * C, kw) or preds.dtype != _I32:
        raise ValueError(f"preds must be int32 [{B * C}, {kw}]")
    if not (0 <= k0 and k0 + kw <= records.num_symbols):
        raise ValueError(f"wave {wave} does not lie in the schedule")
    return k0, kw, nl


def wave_finish_plain(syms, preds, records, wave, plane, channels: int,
                      slot_order: bool = False):
    """wave_finish as torch ops (see there); with slot_order through
    records.order, as the kernel walks it."""
    k0, kw, nl = _finish_layout(syms, preds, records, wave, plane, channels)
    P, B, rows, C, Lp = syms.shape
    s = syms.permute(1, 3, 2, 0, 4).reshape(B * C, rows * nl)[:, :kw]
    vals = (T.unpack_signed(s) + preds).to(_I32)
    if slot_order:
        order = records.order[k0:k0 + kw].to(_I64)
        plane[:, order[:, 1]] = vals[:, order[:, 0]]
    else:
        plane[:, records.slots[k0:k0 + kw].to(_I64)] = vals
    return plane


def wave_finish(syms, preds, records: Records, wave, plane, channels: int,
                slot_order: bool | None = None):
    """Kernel V (csrc/wave_context.cu frave_wave_finish) on the card, its
    plain version on the CPU: the values of the grid wave wave=(k0, kw, nl)
    stored into the plane rows, plane[b*C + c, slot[k0 + j]] =
    unpack_signed(sym) + preds[b*C + c, j], in place.

    syms is kernel 3's output read through its strides as an int32
    [parts, B, rows, C, lanes_p] view (parts * lanes_p = nl; lane
    p * lanes_p + i of a row is part p's lane i): decode_scan_wave's
    [B, rows, C, nl] as one part (syms[None]); the tp decoder's gathered
    [ranks, rows, C, nl / ranks] as ranks parts of one image. preds
    [B*C, kw] int32 (wave_contexts'), plane [B*C, S >= n_slots] int32 with
    a contiguous last dim. Returns the plane. One launch (none for an
    empty wave) on the launch plan's persistent grid, walking the wave in
    slot order where the records have one (records.order, with_slot_order:
    a grid program's) and the wave holds SLOT_ORDER_MIN (symbol, image)
    pairs or more, else in schedule order; slot_order=True / False forces
    one walk (both store the same values; sweeps only)."""
    k0, kw, nl = _finish_layout(syms, preds, records, wave, plane, channels)
    if slot_order is None:
        slot_order = records.order is not None and kw * syms.shape[1] >= SLOT_ORDER_MIN
    if slot_order and records.order is None:
        raise ValueError("slot order needs records.order (with_slot_order)")
    dev = plane.device
    if dev.type == "cpu":
        return wave_finish_plain(syms, preds, records, wave, plane, channels, slot_order)
    if dev.type != "cuda":
        raise RuntimeError(f"no kernel for device {dev}")
    if any(t.device != dev for t in (syms, preds, records.slots)) or (
            slot_order and records.order.device != dev):
        raise ValueError(f"all operands must lie on {dev}")
    if kw == 0:
        return plane
    preds = preds.contiguous()
    P, B, rows, C, Lp = syms.shape
    plan = launch_plan("wave_finish", B, kw, C, dev)
    order = records.order.data_ptr() if slot_order else None
    lib = _build.load_library()
    code = lib.frave_wave_finish(
        syms.data_ptr(), syms.stride(0), syms.stride(1), syms.stride(2), syms.stride(3), Lp,
        preds.data_ptr(), records.slots.data_ptr(), order, plane.data_ptr(), plane.stride(0),
        k0, kw, nl, C, B, plan.groups, plan.blocks, _build.current_stream(dev),
    )
    _build.check(code, "frave_wave_finish")
    wave_finish.launches += 1
    return plane


wave_finish.launches = 0


def launch_floor(name: str, symbols: int, images: int, channels: int, device,
                 encode: bool = False) -> None:
    """One empty launch of W's (name "wave_contexts", its encode mode with
    encode=True) or V's ("wave_finish") grid for `symbols` symbols of
    `images` images: the launch plan's blocks with the kernel's shared
    memory, the floor of a launch of either at that shape, timed by
    kernel_check. Not a kernel of the codec: no launch count."""
    plan = launch_plan(name, images, symbols, channels, device, encode)
    lib = _build.load_library()
    code = lib.frave_wave_empty(_KERNEL_IDS[(name, encode)], channels, plan.blocks,
                                _build.current_stream(device))
    _build.check(code, "frave_wave_empty")
