"""The step-tensor rANS decode: the port of the lax.scan body of
frave_tpu/codec/pipeline_jax.py decode_fused (with ops/rans_jax.py
decode_step_merged).

The parallel and parity modes, and grid-mode shapes too small for a dense
lattice, decode step by step (fractal/schedule.py LaneSteps): step s
decodes one symbol on each of its lanes, for every image and channel of a
batch. Each step can read what earlier steps wrote, so the steps run in
order. A step is a run of consecutive schedule indices [k0, k0 + len) on
the lanes (lane0 + o) mod NL, o < len, so the decode reads its work from
schedule-order operands (StepOperands, built once a program by
step_operands_host):

  * the step map [S, 4] int32: k0, lane0, len and the lanes past the wrap
    (lane0 + len - NL, else 0): a wrapped band ranks its words in
    ascending lane order, the wrapped tail [0, wrapped) first;
  * one 32-byte record a schedule symbol [K, 8] int32: the coefficient
    slot, the six taps as schedule indices (-1: the slot is no schedule
    symbol's and reads 0) and lf | group << 8 | fbkt << 16 (int8 fields);
    the taps read a plane in schedule order, which the decode writes
    beside the coefficient plane.

  * decode_steps — kernel D (csrc/rans_step_decode.cu
    frave_rans_decode_steps): every step of the batch in one launch, one
    block an image where a step's (channel, lane) pairs fit one block, else
    one thread-block cluster an image; decode_steps_plan says which;
  * decode_steps_plain — its plain version, a torch loop over the steps:
    the 6-tap gather from the schedule-order plane, torch_ops.contexts, the
    fixed-bucket override, rans_torch.decode_row over the step's lanes and
    the stores of the values. decode_steps runs it on CPU tensors.

Both take a same-shape batch on a leading axis (one image may come without
it); the step operands and the bucket edges are shared by the batch.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from . import rans_torch as RT
from . import torch_ops as T

_I32 = torch.int32
_I64 = torch.int64
REC_WORDS = 8  # int32 words of a record (32 bytes)
TAPS = 6
# design switches of kernel D (the sweeps; the plain version takes none):
NO_PREFETCH = 1  # no bulk copies: records and words loaded when needed
SLOT_TAPS = 2  # records from slot_records: taps read the coefficient plane
PADDED = 4  # records from padded_records: [S, NL] by lane, inactive lanes too
FORCE_BLOCK = 8  # the one-block variant whatever the step width
PREFETCH = 16  # bulk copies ahead where the rule would not make them
VARIANTS = ("block", "cluster")


@dataclasses.dataclass
class StepOperands:
    """Kernel D's operands of a program (shared by every decode batch on
    it): step_map [S, 4] int32 and rec [K, 8] int32 (module docstring),
    the lane count, the widest step's length and the schedule's symbol
    count. `flags` is SLOT_TAPS or PADDED where rec is laid out so (the
    sweeps' operands, kernel only)."""

    step_map: torch.Tensor
    rec: torch.Tensor
    lanes: int
    max_len: int
    num_symbols: int
    flags: int = 0

    def to(self, device) -> "StepOperands":
        return dataclasses.replace(self, step_map=self.step_map.to(device),
                                   rec=self.rec.to(device))


def step_operands_host(sched, steps, n_slots: int):
    """(step_map [S, 4] int64, rec [K, 8] int64) of a WavefrontSchedule and
    its LaneSteps, numpy. Raises unless every step is a run of consecutive
    schedule indices on consecutive lanes mod NL and the steps tile the
    schedule in order, which the step map relies on."""
    slot = steps.step_slot.astype(np.int64)
    S, nl = slot.shape
    act = slot >= 0
    length = act.sum(1)
    k0 = np.cumsum(length) - length
    s_idx, l_idx = np.nonzero(act)
    k = slot[act]
    first = k == k0[s_idx]
    lane0 = np.zeros(S, np.int64)
    lane0[s_idx[first]] = l_idx[first]
    o = k - k0[s_idx]
    if (int(length.sum()) != sched.num_symbols or np.any(o < 0) or np.any(o >= length[s_idx])
            or np.any((lane0[s_idx] + o) % nl != l_idx) or first.sum() != (length > 0).sum()):
        raise AssertionError("a step is not a run of consecutive schedule indices and lanes")
    step_map = np.stack([k0, lane0, length, np.maximum(lane0 + length - nl, 0)], axis=1)
    coef = sched.sched_coef.astype(np.int64)
    writer = np.full(n_slots, -1, np.int64)
    writer[coef] = np.arange(coef.shape[0])
    nb = sched.sched_nbr.astype(np.int64)
    taps = np.where((nb >= 0) & (nb < n_slots), writer[np.clip(nb, 0, n_slots - 1)], -1)
    meta = (sched.sched_lf.astype(np.int64) | (sched.sched_group.astype(np.int64) & 0xFF) << 8
            | (sched.sched_fbkt.astype(np.int64) & 0xFF) << 16)
    rec = np.concatenate([coef[:, None], taps, meta[:, None]], axis=1)
    return step_map, rec


def upload(step_map, rec, nl: int, device) -> StepOperands:
    """StepOperands on `device` from step_operands_host's arrays."""
    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device).to(_I32).contiguous()

    return StepOperands(put(step_map), put(rec), nl, int(step_map[:, 2].max(initial=0)),
                        int(rec.shape[0]))


def unpack_meta(meta: torch.Tensor):
    """A record's last word -> (lf bool, group, fbkt) int64."""
    meta = meta.to(_I64)

    def i8(v):
        return v - ((v & 0x80) << 1)

    return (meta & 0xFF) != 0, i8((meta >> 8) & 0xFF), i8((meta >> 16) & 0xFF)


def lane_grid(steps: StepOperands):
    """(k [S, NL] int64 schedule index or -1, the [S, NL, 8] records laid
    out by lane, inactive lanes (coef -1, taps -1, fbkt -1) included): the
    LaneSteps layout rebuilt from the step map."""
    smap = steps.step_map.to(_I64).cpu()
    rec = steps.rec.to(_I64).cpu()
    S, nl = smap.shape[0], steps.lanes
    k = torch.full((S, nl), -1, dtype=_I64)
    s_idx = torch.repeat_interleave(torch.arange(S), smap[:, 2])
    ks = torch.arange(int(smap[:, 2].sum()))
    lanes = (smap[s_idx, 1] + ks - smap[s_idx, 0]) % nl
    k[s_idx, lanes] = ks
    idle = torch.tensor([-1] * (REC_WORDS - 1) + [0xFF << 16], dtype=_I64)
    grid = torch.where((k >= 0)[..., None], rec[k.clamp(min=0)], idle)
    return k, grid


def slot_records(steps: StepOperands) -> StepOperands:
    """The same operands with each tap a coefficient slot (SLOT_TAPS): the
    kernel then reads its taps from the coefficient plane, as PR 7's
    step tensors had it."""
    rec = steps.rec.clone()
    taps = rec[:, 1:1 + TAPS].to(_I64)
    rec[:, 1:1 + TAPS] = torch.where(taps >= 0, rec[taps.clamp(min=0), 0], -1).to(_I32)
    return dataclasses.replace(steps, rec=rec, flags=steps.flags | SLOT_TAPS)


def padded_records(steps: StepOperands) -> StepOperands:
    """The same operands with the records laid out [S * NL, 8] by lane
    (PADDED): every lane of every step, as PR 7's padded step tensors."""
    _, grid = lane_grid(steps)
    rec = grid.reshape(-1, REC_WORDS).to(_I32).to(steps.rec.device).contiguous()
    return dataclasses.replace(steps, rec=rec, flags=steps.flags | PADDED)


def step_contexts(splane, rec, ks, vparams, wparams):
    """The contexts of the schedule indices ks [n] int64 of a batch, from
    its plane in schedule order splane [B, C, K] int32 (a tap -1 reads 0):
    the six taps, torch_ops.contexts with each symbol's LF flag and
    predictor row (vparams / wparams [B, C, F, 6]), a fixed bucket >= 0
    replacing the computed one. rec [K, 8] int64 records. Returns (buckets,
    predictions) [B, C, n]."""
    taps = rec[ks, 1:1 + TAPS]
    vals = torch.where(taps >= 0, splane[:, :, taps.clamp(min=0)], 0)  # [B, C, n, 6]
    lf, grp, fbkt = unpack_meta(rec[ks, REC_WORDS - 1])
    bk, pred = T.contexts(vals, lf, grp, vparams, wparams)
    return torch.where(fbkt >= 0, fbkt.to(bk.dtype), bk), pred


def decode_steps_plain(x, gptr, steps, vparams, wparams, stream, tabs, n_slots: int):
    """decode_steps as a torch loop over the steps (see there): per step
    step_contexts, then rans_torch.decode_row over the step's lanes, then
    the stores of its values. Returns (plane [B, C, n_slots] int32, x',
    gptr')."""
    if gptr.dim() == 0:
        plane, x, gptr = decode_steps_plain(
            x[None], gptr[None], steps, vparams[None], wparams[None], stream[None],
            {k: v[None] for k, v in tabs.items()}, n_slots,
        )
        return plane[0], x[0], gptr[0]
    if steps.flags:
        raise ValueError("the design switches are kernel D's; the plain version takes none")
    B, C, NL = x.shape
    dev = x.device
    rtabs = RT._row_tables(tabs)
    rec = steps.rec.to(_I64)
    K = rec.shape[0]
    coef = rec[:, 0]
    # the planes: schedule order (the taps' reads) and coefficient slots
    # (the output)
    splane = torch.zeros((B, C, max(K, 1)), dtype=_I32, device=dev)
    plane = torch.zeros((B, C, n_slots), dtype=_I32, device=dev)
    lanes = torch.arange(NL, device=dev)
    for k0, lane0, length, _ in steps.step_map.tolist():
        if length == 0:
            continue
        ks = torch.arange(k0, k0 + length, device=dev)
        n = (lane0 + ks - k0) % NL
        bk, pred = step_contexts(splane, rec, ks, vparams, wparams)
        # onto the lanes: the rank order is channel-major, ascending lane
        bk_lanes = torch.zeros((B, C, NL), dtype=bk.dtype, device=dev)
        bk_lanes[:, :, n] = bk
        act = torch.isin(lanes, n)
        sym, x, gptr = RT.decode_row(x, gptr, bk_lanes, act, stream, rtabs)
        vals_out = (T.unpack_signed(sym[:, :, n]) + pred).to(_I32)
        splane[:, :, ks] = vals_out
        plane[:, :, coef[ks]] = vals_out
    return plane, x, gptr


class StepPlan(NamedTuple):
    """Kernel D's launch plan for one image: the variant ("block": one
    block, the lane states in shared memory; "cluster": a thread-block
    cluster of `cluster` blocks, the lane states in registers), the
    blocks, the (channel, lane) pairs a thread, whether the next step's
    records (and, one block, the step's words) are copied ahead in
    bulk."""

    variant: str
    cluster: int
    per: int
    prefetch: bool


def decode_steps_plan(channels: int, lanes: int, contexts: int, fine: int, max_len: int,
                      cluster: int = 0, flags: int = 0) -> StepPlan:
    """Kernel D's launch plan on the current CUDA device for one image of
    channels x lanes whose widest step has max_len lanes (every image of a
    batch runs one such block or cluster). `cluster` 0 takes the launch
    rule (csrc/rans_step_decode.cu): one block where channels * max_len
    pairs (at most 2048) fit it and its shared memory holds the lane
    states, with prefetch where a step needs two pairs a thread and the
    buffers fit; else the smallest cluster with at most 2048 lanes a
    block, without prefetch. A
    power of two up to 16 forces the cluster variant at that size (the
    kernel checks), and raises where it cannot be resident; `flags` take
    the design switches (FORCE_BLOCK forces the one-block variant, and
    raises where it does not fit). Raises where C * NL exceeds 16 * 8192
    lanes."""
    lib = _build.load_library()
    out = (ctypes.c_int * 4)()
    code = lib.frave_rans_decode_steps_plan(channels, lanes, contexts, fine, max_len, cluster,
                                            flags, out)
    _build.check(code, "frave_rans_decode_steps_plan")
    return StepPlan(VARIANTS[out[0]], out[1], out[2], bool(out[3]))


def decode_steps(x, gptr, steps, vparams, wparams, stream, tabs, n_slots: int,
                 cluster: int = 0, flags: int = 0):
    """Every step of a decode of a same-shape batch (replaces the
    decode_fused scan of pipeline_jax): kernel D on the card, one launch
    of B blocks or B thread-block clusters, one an image
    (decode_steps_plan); decode_steps_plain on the CPU.

    x [B, C, NL] int64 lane states (u32 values); gptr [B] int64 stream
    positions; steps the program's StepOperands (shared by the batch);
    vparams / wparams [B, C, F, 6] f32 predictor rows; stream [B, W] int32
    u16 words, zero-padded by C * NL; tabs from rans_torch.decode_tables
    ([B, C, ...]); n_slots the plane's width. Per image, step and
    (channel, lane) of the step: the 6 taps from the image's plane (tap -1
    reads 0), torch_ops.contexts on them with the symbol's LF flag and
    predictor row, fbkt >= 0 replacing the bucket, then decode_scan_wave's
    symbol and renorm (words ranked channel-major, lane-minor within the
    image, the stream index clamped to [0, W - 1]); the lane's state
    advances and unpack_signed(sym) + prediction is stored at plane[b, c,
    coef]. One image may come without its batch axis. `cluster` forces
    the cluster variant's size and `flags` the design switches
    (decode_steps_plan; both 0 everywhere but the checks and sweeps).
    Returns (plane [B, C, n_slots] int32, zero where no step stored, x',
    gptr')."""
    if gptr.dim() == 0:
        plane, x, gptr = decode_steps(
            x[None], gptr[None], steps, vparams[None], wparams[None], stream[None],
            {k: v[None] for k, v in tabs.items()}, n_slots, cluster, flags,
        )
        return plane[0], x[0], gptr[0]
    if x.dim() != 3:
        raise ValueError(f"x must be [B, C, NL], got {tuple(x.shape)}")
    B, C, NL = x.shape
    S = steps.step_map.shape[0]
    K = steps.num_symbols
    ca = tabs["bits"].shape[-1]
    F = vparams.shape[-2]
    check = RT._check_grid
    if steps.lanes != NL:
        raise ValueError(f"the step operands are for {steps.lanes} lanes, x has {NL}")
    check("step_map", steps.step_map, (S, 4), (_I32,))
    check("rec", steps.rec, (S * NL if steps.flags & PADDED else K, REC_WORDS), (_I32,))
    check("x", x, (B, C, NL), (_I64,))
    check("gptr", gptr, (B,), (_I64,))
    check("vparams", vparams, (B, C, F, 6), (torch.float32,))
    check("wparams", wparams, (B, C, F, 6), (torch.float32,))
    if stream.dim() != 2 or stream.shape[0] != B or not 1 <= stream.shape[1] < 1 << 31:
        raise ValueError(
            f"stream must be [{B}, W] with 1 to 2^31 - 1 words, got {tuple(stream.shape)}"
        )
    check("stream", stream, tuple(stream.shape), (_I32,))
    check("cdf", tabs["cdf"], (B, C, ca, RT.ALPHABET_SIZE), (_I32,))
    check("bits", tabs["bits"], (B, C, ca), (_I32,))
    if not 1 <= n_slots < 1 << 31:
        raise ValueError(f"n_slots must be in [1, 2^31), got {n_slots}")
    if not 1 <= B <= 65535:
        raise ValueError(f"a batch holds 1 to 65535 images, got {B}")
    dev = x.device
    if dev.type == "cpu":
        if cluster or flags:
            raise ValueError("cluster and flags choose kernel D's design; the CPU has none")
        return decode_steps_plain(x, gptr, steps, vparams, wparams, stream, tabs, n_slots)
    if dev.type != "cuda":
        raise RuntimeError(f"no kernel for device {dev}")
    ops = (gptr, vparams, wparams, stream, tabs["cdf"], tabs["bits"], steps.step_map, steps.rec)
    if any(t.device != dev for t in ops):
        raise ValueError(f"all operands must lie on {dev}")
    lib = _build.load_library()
    flags |= steps.flags
    plan = decode_steps_plan(C, NL, ca, F, steps.max_len, cluster, flags)
    edges = T._bucket_edges(dev)
    if edges.shape[0] != ca - 1:
        raise ValueError(f"{ca} contexts need {ca - 1} bucket edges, not {edges.shape[0]}")
    plane = torch.zeros((B, C, n_slots), dtype=_I32, device=dev)
    splane = torch.empty((B, C, max(K, 1)), dtype=_I32, device=dev)  # the kernel's scratch
    x_out = torch.empty_like(x)
    g_out = torch.empty_like(gptr)
    code = lib.frave_rans_decode_steps(
        x.data_ptr(), gptr.data_ptr(), steps.step_map.data_ptr(), steps.rec.data_ptr(),
        vparams.data_ptr(), wparams.data_ptr(), edges.data_ptr(), stream.data_ptr(),
        tabs["cdf"].data_ptr(), tabs["bits"].data_ptr(), plane.data_ptr(), splane.data_ptr(),
        x_out.data_ptr(), g_out.data_ptr(), S, C, NL, ca, F, steps.max_len, n_slots, K,
        stream.shape[1], B, VARIANTS.index(plan.variant), plan.cluster, flags,
        _build.current_stream(dev),
    )
    _build.check(code, "frave_rans_decode_steps")
    decode_steps.launches += 1
    return plane, x_out, g_out


decode_steps.launches = 0


def step_floor_loop(steps: int, device) -> None:
    """Launch `steps` empty steps of the one-block variant's chain on one
    block (csrc/rans_step_decode.cu frave_step_floor_loop): one dependent
    L2 load, a warp ballot, its store to shared memory and the block
    barrier a step, the floor of a one-block decode whose steps need no
    closing barrier; timed by chip_smoke.py. Not a kernel of the codec
    path: it has no launch count."""
    lib = _build.load_library()
    scratch = torch.zeros(1024, dtype=_I32, device=device)
    sink = torch.zeros(1, dtype=_I32, device=device)
    code = lib.frave_step_floor_loop(steps, scratch.data_ptr(), sink.data_ptr(),
                                     _build.current_stream(device))
    _build.check(code, "frave_step_floor_loop")
