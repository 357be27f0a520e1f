"""The tp-sharded rANS decode steps: the port of the lax.scan bodies of
frave_tpu/parallel/sharded.py TPShardedDecoder (_build_grid's, :926-963,
and _build's, :1203-1280).

One image's NL lanes are split over the n ranks of a world, rank s owning
[s * NLl, (s + 1) * NLl). A row or step ranks its renorm words
channel-major, lane-minor over all NL lanes, so a rank can place its words
only once the other ranks' needs are known: a collective between steps,
which no kernel can hold. Each kernel therefore takes ONE row or step a
launch and finishes the previous one's renorm from what the collective
gathered:

  * tp_decode_row — kernel 3T (csrc/rans_tp_decode.cu
    frave_tp_decode_row), the grid path: row t-1's renorm from the
    gathered [n, C] int32 counts, then row t's symbols on the rank's lanes
    (kernel 3's search); its [C] counts are the next gather, the only
    thing a row exchanges;
  * tp_decode_step — kernel DT (frave_tp_decode_step), the step-tensor
    path: step t-1's gathered (value, need) [2, C, NL] into the
    replicated planes and the rank's renorm, then step t on the rank's
    lanes (kernel D's taps and f32 context chain); its [2, C, NLl] is the
    next gather.

On the card each launch is one block or one thread-block cluster (3T: one
a channel) by the host's plan (tp_plan: one block up to 1024 of the rank's
(channel, lane) pairs, else up to 16 blocks of at most 1024 (3T) or 512
(DT) pairs), and copies its tables from an image built once a decode
(table_image: the padded u16 layout the search reads) into shared memory,
by TMA bulk copies or, in a cluster of 16 blocks where that measured
faster, by the block's threads. The design switches (FORCE_BLOCK, NO_TMA, TMA) and a
forced `cluster` serve the checks and sweeps only.

Their plain versions, tp_decode_row_plain and tp_decode_step_plain, are
the per-step halves of rans_torch.decode_row (row_symbols, row_renorm) and
of step_decode.decode_steps_plain (step_contexts): chained over the rows
or steps with the collective between, they give decode_scan_wave_plain's
and decode_steps_plain's results. The wrappers run them on CPU tensors.
Both update the lane states (and flags, planes) in place; a launch
without a row or step only finishes the last.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from . import rans_torch as RT
from . import step_decode as SD
from . import torch_ops as T

_I32 = torch.int32
_I64 = torch.int64


_check = RT._check_grid

# design switches of kernels 3T and DT (the sweeps; the plain versions take
# none)
FORCE_BLOCK = 1  # one block (3T: one a channel)
NO_TMA = 2  # the tables copied from the image by the block's threads
TMA = 4  # the tables copied by TMA bulk copies
KINDS = ("row", "step")
# the launch rule (PERF.md: the sweep on an H100): one block where the
# pairs are at most ONE_BLOCK_PAIRS, one a thread; else a cluster of blocks
# of at most CLUSTER_PAIRS[kind] pairs (DT's carry the taps and the context
# chain, so it spreads them thinner)
ONE_BLOCK_PAIRS = 1024
CLUSTER_PAIRS = {"row": 1024, "step": 512}
MAX_CLUSTER = 16
# the tables' copy (PERF.md: the sweep on an H100): TMA bulk copies in a
# cluster of at most this many blocks; in a larger one (16, the
# non-portable size) the blocks' threads copy them faster, at every shape
TMA_MAX_CLUSTER = 8
MAX_CHANNELS = 4  # DT's
MAX_PER = 4  # pairs a thread
THREADS = 1024
# the shared-memory layout of a cdf staircase (csrc/rans_common.cuh): 32
# windows of 32 u16 entries, each window padded to 34 slots, each row to
# 32 * 34 + 2
_WIN, _WIN_STRIDE = 32, 34
ROW_STRIDE = RT.ALPHABET_SIZE // _WIN * _WIN_STRIDE + 2
MAX_BITS = 14


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def image_bytes(contexts: int) -> int:
    """Bytes of one channel's table image (csrc table_bytes): the bits
    [CA] u32, then the padded staircases [CA * ROW_STRIDE] u16, each part
    16-byte aligned."""
    return _align16(contexts * 4) + _align16(contexts * ROW_STRIDE * 2)


def cdf_slots() -> torch.Tensor:
    """[1024] int64: the u16 slot of each staircase entry in its padded row
    (csrc cdf_slot)."""
    e = torch.arange(RT.ALPHABET_SIZE)
    return (e // _WIN) * _WIN_STRIDE + e % _WIN


def table_image(tabs) -> torch.Tensor:
    """The tables of rans_torch.decode_tables ([C, ...]) as the image that
    kernels 3T and DT copy into shared memory: [C, image_bytes(CA)] uint8
    on their device, channel c's bits (clamped to 14) then its staircases
    (clamped to 2^14) at cdf_slots() of rows ROW_STRIDE apart, the padding
    0. Built once a decode."""
    cdf, bits = tabs["cdf"], tabs["bits"]
    C, CA = bits.shape
    dev = cdf.device
    head = _align16(CA * 4)
    b = torch.zeros((C, head // 4), dtype=_I32, device=dev)
    b[:, :CA] = bits.clamp(0, MAX_BITS)
    rows = torch.zeros((C, (image_bytes(CA) - head) // 2), dtype=torch.int16, device=dev)
    idx = (torch.arange(CA)[:, None] * ROW_STRIDE + cdf_slots()[None]).reshape(-1).to(dev)
    rows[:, idx] = cdf.clamp(0, 1 << MAX_BITS).to(torch.int16).reshape(C, -1)
    return torch.cat([b.view(torch.uint8), rows.view(torch.uint8)], dim=1).contiguous()


class TPPlan(NamedTuple):
    """A launch of kernel 3T or DT: the variant ("block" or "cluster"),
    the blocks of the cluster (3T: of each channel's), the pairs a thread
    and whether TMA copies the tables (else the block's threads)."""

    variant: str
    cluster: int
    per: int
    tma: bool = True


def plan_rule(kind: str, channels: int, local: int, cluster: int = 0, flags: int = 0) -> TPPlan:
    """The launch rule of kernel 3T (kind "row": a channel's `local` lanes)
    or DT ("step": the rank's channels x local pairs), by shape alone:
    one block where the pairs are at most ONE_BLOCK_PAIRS, else the
    smallest power-of-two cluster with at most CLUSTER_PAIRS[kind] a
    block, at most MAX_CLUSTER; then the fewest pairs a thread (1, 2 or 4)
    that cover a block's; the tables by TMA in a cluster of at most
    TMA_MAX_CLUSTER blocks, else by the threads. `cluster` forces the
    size, FORCE_BLOCK one block, NO_TMA and TMA the copy. Raises where a
    block would need more than MAX_PER pairs a thread (and, DT, past
    MAX_CHANNELS channels)."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    if kind == "step" and channels > MAX_CHANNELS:
        raise ValueError(f"kernel DT takes at most {MAX_CHANNELS} channels, got {channels}")
    if flags & NO_TMA and flags & TMA:
        raise ValueError("NO_TMA and TMA exclude each other")
    pairs = local if kind == "row" else channels * local
    if flags & FORCE_BLOCK:
        if cluster not in (0, 1):
            raise ValueError("FORCE_BLOCK and a cluster size exclude each other")
        s = 1
    elif cluster:
        if not (1 <= cluster <= MAX_CLUSTER and cluster & (cluster - 1) == 0):
            raise ValueError(f"cluster must be a power of two up to {MAX_CLUSTER}, got {cluster}")
        s = cluster
    elif pairs <= ONE_BLOCK_PAIRS:
        s = 1
    else:
        s = 2
        while s < MAX_CLUSTER and -(-pairs // s) > CLUSTER_PAIRS[kind]:
            s *= 2
    chunk = -(-pairs // s)
    per = next((p for p in (1, 2, MAX_PER) if chunk <= p * THREADS), 0)
    if not per:
        raise ValueError(f"{pairs} pairs over {s} blocks need more than {MAX_PER} a thread")
    tma = bool(flags & TMA) or (not flags & NO_TMA and s <= TMA_MAX_CLUSTER)
    return TPPlan("block" if s == 1 else "cluster", s, per, tma)


def _dyn(kind: str, channels: int, contexts: int) -> int:
    """The launch's dynamic shared memory: the staged tables."""
    return image_bytes(contexts) * (1 if kind == "row" else channels)


@functools.lru_cache(maxsize=None)
def _planned(kind, channels, local, contexts, cluster, flags, device_index):
    plan = plan_rule(kind, channels, local, cluster, flags)
    if plan.variant != "cluster":
        return plan
    lib = _build.load_library()
    fits = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        while True:
            code = lib.frave_tp_fits(KINDS.index(kind), plan.per, plan.cluster,
                                     _dyn(kind, channels, contexts), ctypes.byref(fits))
            _build.check(code, "frave_tp_fits")
            if fits.value:
                return plan
            if cluster or plan.cluster == 1:
                raise RuntimeError(f"a cluster of {plan.cluster} blocks of kernel "
                                   f"{'3T' if kind == 'row' else 'DT'} cannot be resident")
            plan = plan_rule(kind, channels, local, plan.cluster // 2, flags)


def tp_plan(kind: str, channels: int, local: int, contexts: int, cluster: int = 0,
            flags: int = 0, device=None) -> TPPlan:
    """plan_rule on the CUDA `device` (the current one by default), the
    rule's cluster halved (the copy chosen again) while its blocks cannot
    be resident at once
    (cudaOccupancyMaxActiveClusters); a forced size that cannot be
    resident raises. Cached by shape."""
    dev = torch.device(device) if device is not None else torch.device(
        "cuda", torch.cuda.current_device())
    return _planned(kind, channels, local, contexts, cluster, flags, dev.index or 0)


def launch_floor(kind: str, channels: int, local: int, contexts: int, device,
                 cluster: int = 0, flags: int = 0) -> TPPlan:
    """One empty launch of the grid, cluster and dynamic shared memory of
    tp_plan's launch (the floor of a launch-per-step design; timed by
    kernel_check). Not a kernel of the decode: no launch count."""
    plan = tp_plan(kind, channels, local, contexts, cluster, flags, device)
    ys = channels if kind == "row" else 1
    lib = _build.load_library()
    code = lib.frave_tp_empty(plan.cluster, ys, _dyn(kind, channels, contexts),
                              _build.current_stream(device))
    _build.check(code, "frave_tp_empty")
    return plan


def _kernel_flags(plan: TPPlan, flags: int) -> int:
    """The kernels' switches for a plan (csrc kForceBlock, kNoTma)."""
    return (flags & FORCE_BLOCK) | (0 if plan.tma else NO_TMA)


def _image(image, tabs, C, ca, dev):
    if image is None:
        return table_image(tabs)
    _check("image", image, (C, image_bytes(ca)), (torch.uint8,))
    if image.device != dev:
        raise ValueError(f"the table image must lie on {dev}")
    return image


def tp_decode_row_plain(x, need, gptr, counts, rank, buckets, active, stream, tabs,
                        rtabs=None):
    """tp_decode_row as torch ops (see there); rtabs: rans_torch._row_tables
    of tabs, made here where not given."""
    C, NLl = x.shape
    cnt = counts.to(_I64)
    chan = cnt.sum(0)
    base = gptr + (torch.cumsum(chan, 0) - chan) + cnt[:rank].sum(0)  # [C]
    pos = base[:, None] + torch.cumsum(need.to(_I64), dim=1) - 1
    x.copy_(RT.row_renorm(x[None], need[None], pos[None], stream[None])[0])
    gptr_out = gptr + cnt.sum()
    if buckets is None:
        need.zero_()
        return None, torch.zeros(C, dtype=_I32, device=x.device), gptr_out
    if rtabs is None:
        rtabs = RT._row_tables({k: v[None] for k, v in tabs.items()})
    act = active.to(torch.bool)
    sym, x_new, nd = RT.row_symbols(x[None], buckets[None], act, rtabs)
    x.copy_(torch.where(act, x_new[0], x))
    need.copy_(nd[0])
    return sym[0].to(_I32), nd[0].sum(dim=1, dtype=_I32), gptr_out


def tp_decode_row(x, need, gptr, counts, rank, buckets, active, stream, tabs, rtabs=None,
                  image=None, cluster: int = 0, flags: int = 0):
    """One decode row of a rank's lanes (kernel 3T on the card, its plain
    version on the CPU).

    x [C, NLl] int64 lane states (u32 values) and need [C, NLl] bool (row
    t-1's renorm flags), both updated in place; gptr [1] int64, the stream
    position before row t-1's words; counts [n, C] int32, row t-1's renorm
    counts of every rank (row 0: zeros); rank this rank's index; buckets
    [C, NLl] int32, row t's contexts (None: finish row t-1 alone; in the
    grid decode row t of the [1, rows, C, NLl] lane window that kernel W
    writes, wave_ctx.wave_contexts(..., lanes=)); active
    [NLl] bool, row t's lane activity; stream [W] int32 u16 words; tabs
    from rans_torch.decode_tables ([C, ...]). Row t-1's flagged lanes take
    the words stream[gptr + offset] (clamped to [0, W - 1]), offset the
    counts of every rank in the channels before, then of the ranks before
    this one in the channel, then the lane's rank within this rank's
    flagged lanes; then every lane's symbol of row t and, where active,
    its pre-renorm state, need = active & (x' < 2^16). On the card: image
    the table_image of tabs (made here where not given: pass it once a
    decode), `cluster` and `flags` the design (tp_plan; 0 but in checks
    and sweeps); rtabs the CPU's. Returns (syms [C, NLl] int32 (None
    without a row), counts [C] int32 of need, gptr after row t-1's words
    [1])."""
    C, NLl = x.shape
    n = counts.shape[0]
    ca = tabs["bits"].shape[-1]
    _check("x", x, (C, NLl), (_I64,))
    _check("need", need, (C, NLl), (torch.bool,))
    _check("gptr", gptr, (1,), (_I64,))
    _check("counts", counts, (n, C), (_I32,))
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} is not one of {n}")
    if buckets is not None:
        _check("buckets", buckets, (C, NLl), (_I32,))
        _check("active", active, (NLl,), (torch.bool,))
    if stream.dim() != 1 or not 1 <= stream.shape[0] < 1 << 31:
        raise ValueError(f"stream must be [W] with 1 to 2^31 - 1 words, got {tuple(stream.shape)}")
    _check("cdf", tabs["cdf"], (C, ca, RT.ALPHABET_SIZE), (_I32,))
    _check("bits", tabs["bits"], (C, ca), (_I32,))
    dev = x.device
    if dev.type == "cpu":
        if cluster or flags:
            raise ValueError("cluster and flags choose kernel 3T's design; the CPU has none")
        return tp_decode_row_plain(x, need, gptr, counts, rank, buckets, active, stream, tabs,
                                   rtabs)
    if dev.type != "cuda":
        raise RuntimeError(f"no kernel for device {dev}")
    lib = _build.load_library()
    plan = tp_plan("row", C, NLl, ca, cluster, flags, dev)
    image = _image(image, tabs, C, ca, dev)
    g_out = torch.empty_like(gptr)
    syms = torch.empty((C, NLl), dtype=_I32, device=dev) if buckets is not None else None
    cnt = torch.empty((C,), dtype=_I32, device=dev)
    code = lib.frave_tp_decode_row(
        x.data_ptr(), need.data_ptr(), gptr.data_ptr(), g_out.data_ptr(), counts.data_ptr(),
        None if buckets is None else buckets.data_ptr(),
        None if buckets is None else active.data_ptr(), stream.data_ptr(), image.data_ptr(),
        None if syms is None else syms.data_ptr(), cnt.data_ptr(),
        C, NLl, ca, stream.shape[0], rank, n, plan.cluster, plan.per, _kernel_flags(plan, flags),
        _build.current_stream(dev),
    )
    _build.check(code, "frave_tp_decode_row")
    tp_decode_row.launches += 1
    return syms, cnt, g_out


tp_decode_row.launches = 0


def tp_decode_step_plain(x, gptr, steps, prev, step, gathered, lane_lo, vparams, wparams,
                         stream, tabs, plane, splane, rtabs=None):
    """tp_decode_step as torch ops (see there)."""
    C, NLl = x.shape
    NL = steps.lanes
    dev = x.device
    rec = steps.rec.to(_I64)
    K = rec.shape[0]
    gptr_out = gptr
    if prev >= 0:
        k0, lane0, length, _ = steps.step_map[prev].tolist()
        ks = torch.arange(k0, k0 + length, device=dev)
        n = (lane0 + ks - k0) % NL
        v = gathered[0][:, n]
        splane[:, ks] = v
        coef = rec[ks, 0]
        ok = (coef >= 0) & (coef < plane.shape[1])
        plane[:, coef[ok]] = v[:, ok]
        need_all = gathered[1] != 0
        pos = (torch.cumsum(need_all.reshape(-1).to(_I64), 0) - 1).reshape(C, NL)
        win = slice(lane_lo, lane_lo + NLl)
        x.copy_(RT.row_renorm(x[None], need_all[None, :, win], (gptr + pos[:, win])[None],
                              stream[None])[0])
        gptr_out = gptr + need_all.sum()
    if step < 0:
        return None, gptr_out
    if rtabs is None:
        rtabs = RT._row_tables({k: v[None] for k, v in tabs.items()})
    k0, lane0, length, _ = steps.step_map[step].tolist()
    o = (lane_lo + torch.arange(NLl, device=dev) - lane0) % NL
    act = o < length
    ks = torch.where(act, k0 + o, 0).clamp(max=max(K - 1, 0))
    bk, pred = SD.step_contexts(splane[None], rec, ks, vparams[None], wparams[None])
    sym, x_new, need = RT.row_symbols(x[None], bk, act, rtabs)
    x.copy_(torch.where(act, x_new[0], x))
    vals = torch.where(act, (T.unpack_signed(sym[0]) + pred[0]).to(_I32), 0)
    return torch.stack([vals, need[0].to(_I32)]), gptr_out


def tp_decode_step(x, gptr, steps, prev, step, gathered, lane_lo, vparams, wparams, stream,
                   tabs, plane, splane, rtabs=None, image=None, cluster: int = 0,
                   flags: int = 0):
    """One step of a rank's lanes (kernel DT on the card, its plain version
    on the CPU).

    x [C, NLl] int64 lane states of the lanes [lane_lo, lane_lo + NLl),
    updated in place; gptr [1] int64, the stream position before step
    prev's words; steps the program's step_decode.StepOperands; prev the
    step whose gathered (value, need) [2, C, NL] int32 `gathered` holds
    (-1: none, gathered may be None): its values go to the replicated
    planes, plane [C, n_slots] int32 at each symbol's coefficient slot and
    splane [C, K] int32 at its schedule index (both in place), and its
    flagged lanes of this rank take their words, ranked channel-major,
    lane-minor over all NL lanes, each index clamped to [0, W - 1]; step
    the step to decode on this rank's lanes (-1: none): kernel D's taps,
    contexts, fixed bucket and symbol (vparams / wparams [C, F, 6] f32,
    stream [W] int32, tabs from rans_torch.decode_tables [C, ...]).
    image, cluster and flags as tp_decode_row's. Returns (out [2, C, NLl]
    int32, each lane's value and need flag, 0 off the step (None without a
    step), gptr after step prev's words [1])."""
    C, NLl = x.shape
    NL, S, K = steps.lanes, steps.step_map.shape[0], steps.num_symbols
    ca = tabs["bits"].shape[-1]
    F = vparams.shape[-2]
    n_slots = plane.shape[1]
    if steps.flags:
        raise ValueError("the design switches are kernel D's; the tp step takes none")
    _check("x", x, (C, NLl), (_I64,))
    _check("gptr", gptr, (1,), (_I64,))
    _check("step_map", steps.step_map, (S, 4), (_I32,))
    _check("rec", steps.rec, (K, SD.REC_WORDS), (_I32,))
    _check("vparams", vparams, (C, F, 6), (torch.float32,))
    _check("wparams", wparams, (C, F, 6), (torch.float32,))
    _check("plane", plane, (C, n_slots), (_I32,))
    _check("splane", splane, (C, max(K, 1)), (_I32,))
    if not (-1 <= prev < S and -1 <= step < S and 0 <= lane_lo and lane_lo + NLl <= NL):
        raise ValueError(f"steps ({prev}, {step}) of {S} or lanes [{lane_lo}, +{NLl}) of {NL}")
    if prev >= 0:
        _check("gathered", gathered, (2, C, NL), (_I32,))
    if stream.dim() != 1 or not 1 <= stream.shape[0] < 1 << 31:
        raise ValueError(f"stream must be [W] with 1 to 2^31 - 1 words, got {tuple(stream.shape)}")
    _check("cdf", tabs["cdf"], (C, ca, RT.ALPHABET_SIZE), (_I32,))
    _check("bits", tabs["bits"], (C, ca), (_I32,))
    dev = x.device
    if dev.type == "cpu":
        if cluster or flags:
            raise ValueError("cluster and flags choose kernel DT's design; the CPU has none")
        return tp_decode_step_plain(x, gptr, steps, prev, step, gathered, lane_lo, vparams,
                                    wparams, stream, tabs, plane, splane, rtabs)
    if dev.type != "cuda":
        raise RuntimeError(f"no kernel for device {dev}")
    lib = _build.load_library()
    plan = tp_plan("step", C, NLl, ca, cluster, flags, dev)
    image = _image(image, tabs, C, ca, dev)
    edges = T._bucket_edges(dev)
    if edges.shape[0] != ca - 1:
        raise ValueError(f"{ca} contexts need {ca - 1} bucket edges, not {edges.shape[0]}")
    g_out = torch.empty_like(gptr)
    out = torch.empty((2, C, NLl), dtype=_I32, device=dev) if step >= 0 else None
    code = lib.frave_tp_decode_step(
        x.data_ptr(), gptr.data_ptr(), g_out.data_ptr(), steps.step_map.data_ptr(),
        steps.rec.data_ptr(), vparams.data_ptr(), wparams.data_ptr(), edges.data_ptr(),
        stream.data_ptr(), image.data_ptr(), plane.data_ptr(), splane.data_ptr(),
        None if gathered is None else gathered.data_ptr(),
        None if out is None else out.data_ptr(), prev, step, S, C, NL, lane_lo, NLl, ca, F,
        stream.shape[0], n_slots, max(K, 1), plan.cluster, plan.per, _kernel_flags(plan, flags),
        _build.current_stream(dev),
    )
    _build.check(code, "frave_tp_decode_step")
    tp_decode_step.launches += 1
    return out, g_out


tp_decode_step.launches = 0
