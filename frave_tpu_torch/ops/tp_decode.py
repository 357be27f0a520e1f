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

Their plain versions, tp_decode_row_plain and tp_decode_step_plain, are
the per-step halves of rans_torch.decode_row (row_symbols, row_renorm) and
of step_decode.decode_steps_plain (step_contexts): chained over the rows
or steps with the collective between, they give decode_scan_wave_plain's
and decode_steps_plain's results. The wrappers run them on CPU tensors.
Both update the lane states (and flags, planes) in place; a launch
without a row or step only finishes the last.
"""

from __future__ import annotations

import torch

from . import _build
from . import rans_torch as RT
from . import step_decode as SD
from . import torch_ops as T

_I32 = torch.int32
_I64 = torch.int64


_check = RT._check_grid


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


def tp_decode_row(x, need, gptr, counts, rank, buckets, active, stream, tabs, rtabs=None):
    """One decode row of a rank's lanes (kernel 3T on the card, its plain
    version on the CPU).

    x [C, NLl] int64 lane states (u32 values) and need [C, NLl] bool (row
    t-1's renorm flags), both updated in place; gptr [1] int64, the stream
    position before row t-1's words; counts [n, C] int32, row t-1's renorm
    counts of every rank (row 0: zeros); rank this rank's index; buckets
    [C, NLl] int32, row t's contexts (None: finish row t-1 alone); active
    [NLl] bool, row t's lane activity; stream [W] int32 u16 words; tabs
    from rans_torch.decode_tables ([C, ...]). Row t-1's flagged lanes take
    the words stream[gptr + offset] (clamped to [0, W - 1]), offset the
    counts of every rank in the channels before, then of the ranks before
    this one in the channel, then the lane's rank within this rank's
    flagged lanes; then every lane's symbol of row t and, where active,
    its pre-renorm state, need = active & (x' < 2^16). Returns (syms
    [C, NLl] int32 (None without a row), counts [C] int32 of need, gptr
    after row t-1's words [1])."""
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
        return tp_decode_row_plain(x, need, gptr, counts, rank, buckets, active, stream, tabs,
                                   rtabs)
    if dev.type != "cuda":
        raise RuntimeError(f"no kernel for device {dev}")
    lib = _build.load_library()
    g_out = torch.empty_like(gptr)
    syms = torch.empty((C, NLl), dtype=_I32, device=dev) if buckets is not None else None
    cnt = torch.empty((C,), dtype=_I32, device=dev)
    code = lib.frave_tp_decode_row(
        x.data_ptr(), need.data_ptr(), gptr.data_ptr(), g_out.data_ptr(), counts.data_ptr(),
        None if buckets is None else buckets.data_ptr(),
        None if buckets is None else active.data_ptr(), stream.data_ptr(),
        tabs["cdf"].data_ptr(), tabs["bits"].data_ptr(),
        None if syms is None else syms.data_ptr(), cnt.data_ptr(),
        C, NLl, ca, stream.shape[0], rank, n, _build.current_stream(dev),
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
                   tabs, plane, splane, rtabs=None):
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
    Returns (out [2, C, NLl] int32, each lane's value and need flag, 0 off
    the step (None without a step), gptr after step prev's words [1])."""
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
        return tp_decode_step_plain(x, gptr, steps, prev, step, gathered, lane_lo, vparams,
                                    wparams, stream, tabs, plane, splane, rtabs)
    if dev.type != "cuda":
        raise RuntimeError(f"no kernel for device {dev}")
    lib = _build.load_library()
    edges = T._bucket_edges(dev)
    if edges.shape[0] != ca - 1:
        raise ValueError(f"{ca} contexts need {ca - 1} bucket edges, not {edges.shape[0]}")
    g_out = torch.empty_like(gptr)
    out = torch.empty((2, C, NLl), dtype=_I32, device=dev) if step >= 0 else None
    code = lib.frave_tp_decode_step(
        x.data_ptr(), gptr.data_ptr(), g_out.data_ptr(), steps.step_map.data_ptr(),
        steps.rec.data_ptr(), vparams.data_ptr(), wparams.data_ptr(), edges.data_ptr(),
        stream.data_ptr(), tabs["cdf"].data_ptr(), tabs["bits"].data_ptr(), plane.data_ptr(),
        splane.data_ptr(), None if gathered is None else gathered.data_ptr(),
        None if out is None else out.data_ptr(), prev, step, S, C, NL, lane_lo, NLl, ca, F,
        stream.shape[0], n_slots, max(K, 1), _build.current_stream(dev),
    )
    _build.check(code, "frave_tp_decode_step")
    tp_decode_step.launches += 1
    return out, g_out


tp_decode_step.launches = 0
