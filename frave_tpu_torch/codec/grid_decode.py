"""Dense grid-mode decode and encode statistics: the port of
frave_tpu/codec/grid_decode.py.

Coefficients live in dense per-level [A, B] lattice grids
(fractal/lattice.py); the 6 context taps of a whole wave are
unit shifts of the parent value grid after a polyphase parent->child
broadcast (fractal/gridplan plans, run by gridplan_torch.apply_plan),
plus a short list of scale-2 fixups. The rANS lanes are packed per wave
(rank within the wave), so symbols <-> lanes is one static gather per
wave, outside the row loop.

Differences from the JAX module, none of which changes an integer:
value grids are int32 per channel ([C, A, B], fill 0) instead of the
TPU's packed 10-bit u32 (RGB) / int16 (gray) planes, and each wave's
rANS rows are one ops/rans_torch.decode_scan_wave call (kernel 3 on the
card: an integer cdf search and a block scan for the word ranks) instead
of the XLA scan of bf16 one-hot staircase steps.

Both take a same-shape batch (the JAX program's vmap over B): every stage
whose channels are independent runs over B*C rows (the tap planes,
contexts, fits and tables take any leading row count), and what is per
image keeps its [B] axis (the streams and their positions, the lane
states, qdiv and the transform ids).
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from ..entropy.tables import ALPHABET_SIZE, CONTEXT_AMOUNT
from ..entropy.tables_torch import finalize_contexts_device
from ..fractal.gridplan import GridPlan
from ..fractal.gridplan_torch import apply_plan
from ..fractal.lattice import build_wave_plans, get_lattice_grids
from ..ops import torch_ops as T
from ..ops.lifting import dequantize_inverse_lift_pixels
from ..ops.rans_torch import decode_scan_wave, decode_tables

_I64 = torch.int64


def _dev_plan(plan: GridPlan, device) -> GridPlan:
    """A plan whose "take" index arrays already live on `device`."""
    ops = []
    for op in plan.ops:
        if op[0] == "take":
            _, i0, i1, m = op
            op = (
                "take",
                torch.as_tensor(i0, dtype=_I64, device=device),
                torch.as_tensor(i1, dtype=_I64, device=device),
                torch.as_tensor(m, dtype=torch.bool, device=device),
            )
        ops.append(op)
    return GridPlan(ops=ops, out_shape=plan.out_shape, gathers=plan.gathers)


class WaveDev:
    """Device-resident constants for one grid wave (packed rows), shared
    by the dense decode and the dense encode statistics."""

    def __init__(self, wp, nl: int, n_slots: int, device):
        put = lambda a, dt=_I64: torch.as_tensor(  # noqa: E731
            np.ascontiguousarray(a), dtype=dt, device=device
        )
        A, B = wp.shape
        pidx = np.nonzero(wp.active.reshape(-1))[0]
        kw = int(pidx.shape[0])
        rows = -(-kw // nl)  # 0 for empty waves
        self.wp = wp
        self.shape = (A, B)
        self.cells = A * B
        self.kw = kw
        self.rows = rows
        self.group = wp.group
        self.fbkt = wp.fbkt
        self.m = wp.m
        self.tap_shift = [
            (int(wp.tap_shift[k, 0]), int(wp.tap_shift[k, 1])) for k in range(6)
        ]
        # raster rank within the wave IS the packed lane order
        self.pack_idx = put(pidx)
        act = np.zeros(max(rows, 1) * nl, dtype=bool)
        act[:kw] = True
        self.active_rows = put(act[: rows * nl].reshape(rows, nl), torch.bool)
        self.tap_valid = put(wp.tap_valid.reshape(6, A * B).T[pidx], torch.bool)
        slot = wp.slot_grid.reshape(-1)[pidx]
        if not (slot >= 0).all():
            raise AssertionError("active grid cell without a coefficient slot")
        self.wslot = put(slot)
        self.active_dense = put(wp.active, torch.bool)
        self.slot_safe = put(
            np.where(wp.active.reshape(-1), wp.slot_grid.reshape(-1), n_slots)
        )
        self.tap_valid_dense = put(wp.tap_valid, torch.bool)
        self.fix = {}
        for k in range(6):
            sel = wp.fix_tap == k
            if sel.any():
                self.fix[k] = (put(wp.fix_tgt[sel]), put(wp.fix_src[sel]))
        self.classes = [(r1, r2, _dev_plan(p, device)) for r1, r2, p in wp.classes]


def get_wave_devs(geo, sched, nl: int, n_slots: int, device) -> List[WaveDev]:
    """Wave constants for one (shape, nl) on `device`, built from the same
    numpy lattice.build_wave_plans output as the JAX package. Raises
    lattice.DenseGridUnavailable at tiny shapes."""
    lg = get_lattice_grids(geo.height, geo.width, geo.depth)
    plans = build_wave_plans(geo, lg)
    if len(plans) != sched.max_wave:
        raise AssertionError("wave plans disagree with the schedule")
    return [WaveDev(wp, nl, n_slots, device) for wp in plans]


def _shift2(g: torch.Tensor, s0: int, s1: int, fill=0) -> torch.Tensor:
    """out[..., a, b] = g[..., a + s0, b + s1]; out of bounds -> fill."""
    A, B = g.shape[-2:]
    p0, q0 = max(0, -s0), max(0, -s1)
    padded = torch.nn.functional.pad(
        g, (q0, max(0, s1), p0, max(0, s0)), value=fill
    )
    i0, j0 = s0 + p0, s1 + q0
    return padded[..., i0 : i0 + A, j0 : j0 + B]


def _broadcast_parent(wd: WaveDev, parent_vg: torch.Tensor) -> torch.Tensor:
    """Polyphase parent->child value broadcast: each residue class
    (a % m, b % m) applies its plan to the parent value grid [C, A', B'];
    the classes interleave by stack + permute + reshape. Classes absent
    from the plan read 0 (tap validity + fixups make that exact)."""
    A, B = wd.shape
    m = wd.m
    Imax, Jmax = -(-A // m), -(-B // m)
    C = parent_vg.shape[0]
    by_class = {}
    for r1, r2, plan in wd.classes:
        out = apply_plan(plan, parent_vg)
        oi, oj = plan.out_shape
        by_class[(r1, r2)] = torch.nn.functional.pad(out, (0, Jmax - oj, 0, Imax - oi))
    blank = parent_vg.new_zeros((C, Imax, Jmax))
    outs = [by_class.get((r1, r2), blank) for r1 in range(m) for r2 in range(m)]
    pv = (
        torch.stack(outs)
        .reshape(m, m, C, Imax, Jmax)
        .permute(2, 3, 0, 4, 1)
        .reshape(C, Imax * m, Jmax * m)
    )
    return pv[:, :A, :B]


def _tap_planes(wd: WaveDev, pv: torch.Tensor, parent_vg) -> List[torch.Tensor]:
    """The 6 tap-value planes [C, A, B] of a wave: unit shifts of the
    (broadcast) parent value grid, then the scale-2 fixups read from the
    raw parent grid."""
    C = pv.shape[0]
    planes = []
    for k in range(6):
        t = _shift2(pv, *wd.tap_shift[k])
        if parent_vg is not None and k in wd.fix:
            tgt, src = wd.fix[k]
            t = t.reshape(C, -1).clone()
            t[:, tgt] = parent_vg.reshape(C, -1)[:, src]
            t = t.reshape((C,) + wd.shape)
        planes.append(t)
    return planes


def _pack_tap_vals(wd: WaveDev, planes, cells=None, tap_valid=None) -> torch.Tensor:
    """The 6 tap planes gathered at the wave's active cells (or `cells`)
    and masked by tap validity -> [C, kw, 6] int32."""
    cells = wd.pack_idx if cells is None else cells
    tap_valid = wd.tap_valid if tap_valid is None else tap_valid
    C = planes[0].shape[0]
    ts = torch.stack(planes, dim=-1).reshape(C, wd.cells, 6)[:, cells]
    return torch.where(tap_valid[None], ts, torch.zeros_like(ts))


def _wave_contexts(wd: WaveDev, vals, vparams, wparams):
    """Context buckets + predictions [C, kw] from packed taps [C, kw, 6]."""
    C = vals.shape[0]
    vp = vparams[:, wd.group].reshape(C, 1, 6)
    wp = wparams[:, wd.group].reshape(C, 1, 6)
    bk, pr = T.contexts_static(vals, vp, wp, False)
    if wd.fbkt >= 0:
        bk = torch.full_like(bk, wd.fbkt)
    return bk, pr


def _plane_contexts(wd: WaveDev, planes, vparams, wparams):
    """Contexts computed ON the dense grid, then packed: the same values as
    _wave_contexts(_pack_tap_vals(...)) with two [kw] gathers instead of
    one [kw, 6] gather. Returns ([C, kw] buckets, [C, kw] predictions)."""
    C = planes[0].shape[0]
    tvd = wd.tap_valid_dense
    vals = torch.stack(
        [torch.where(tvd[k][None], planes[k], torch.zeros_like(planes[k])) for k in range(6)],
        dim=-1,
    )  # [C, A, B, 6]
    vp = vparams[:, wd.group].reshape(C, 1, 1, 6)
    wp = wparams[:, wd.group].reshape(C, 1, 1, 6)
    bk, pr = T.contexts_static(vals, vp, wp, False)
    if wd.fbkt >= 0:
        bk = torch.full_like(bk, wd.fbkt)
    return bk.reshape(C, -1)[:, wd.pack_idx], pr.reshape(C, -1)[:, wd.pack_idx]


def _to_grid(wd: WaveDev, values: torch.Tensor, base=None) -> torch.Tensor:
    """Scatter packed values [C, kw] onto the wave's dense grid (or into
    `base`, for the DC phase-B merge)."""
    C = values.shape[0]
    flat = (
        values.new_zeros((C, wd.cells)) if base is None else base.reshape(C, -1).clone()
    )
    flat[:, wd.pack_idx] = values
    return flat.reshape((C,) + wd.shape)


def wire_tables(lap, wire_bits, offpk, scpk):
    """The decode tables of a batch's wire fields (context_from_wire twin:
    zero histogram, wire bits, wire off-mask, wire scale indices):
    wire_bits / scpk [B, C, CA] and offpk [B, C, CA, 32] int64 on the
    device, lap the Laplace grid -> rans_torch.decode_tables ([B, C, ...])."""
    B, C = wire_bits.shape[:2]
    shifts32 = torch.arange(32, device=wire_bits.device, dtype=_I64)
    off_mask = (((offpk[..., None] >> shifts32) & 1) > 0).reshape(
        B, C, CONTEXT_AMOUNT, ALPHABET_SIZE
    )
    zero_hist = torch.zeros((B, C, CONTEXT_AMOUNT, ALPHABET_SIZE), dtype=_I64,
                            device=wire_bits.device)
    bits, _, cdfs, _ = finalize_contexts_device(
        zero_hist, lap, bits0=wire_bits, off_mask_in=off_mask, scale_idx=scpk,
    )
    return decode_tables(cdfs, bits)


def build_grid_decode(prog, geo, waves: List[WaveDev]):
    """The dense decode for a grid-mode CodecProgram. Returns
    decode(states [B, C, NL] int64, stream [B, W] int32, wire_bits
    [B, C, CA], offpk [B, C, CA, 32], scales [B, C, CA], vparams / wparams
    [B, C, F, 6] f32, qdiv [B, 512] int32, tids [B] int32) -> pixels
    [B, C, HW] uint8 (all tensors on the program's device): one
    decode_scan_wave launch per non-empty wave and one kernel B launch for
    the whole batch."""
    n_slots = prog.n_slots
    C = prog.channels
    nl = prog.nl
    if sum(wd.rows for wd in waves) != prog.rows:
        raise AssertionError("wave rows disagree with the program's row count")
    if geo.depth != 9:
        raise NotImplementedError(f"depth {geo.depth}: kernel B takes depth 9 only")
    dev = prog.device

    def decode(states, stream, wire_bits, offpk, scpk, vparams, wparams, qdiv, tids,
               stages=None):
        B = states.shape[0]
        BC = B * C
        tabs = wire_tables(prog.lap, wire_bits, offpk, scpk)
        if stages is not None:
            stages.mark("decode/tables")

        # the fits of every (image, channel) row
        vparams = vparams.reshape((BC,) + vparams.shape[2:])
        wparams = wparams.reshape((BC,) + wparams.shape[2:])
        x = states
        gptr = torch.zeros((B,), dtype=_I64, device=dev)
        # [B, C, n_slots] (n_slots = 512 T: rows 16-byte aligned for kernel
        # B's vector loads), written through its [B*C, n_slots] view
        qplane = torch.zeros((B, C, n_slots), dtype=torch.int32, device=dev)
        qrows = qplane.view(BC, n_slots)

        def scan_wave(wd, buckets, preds, x, gptr):
            """The wave's rows for [B*C, kw] buckets and predictions ->
            values [B*C, kw]; one decode_scan_wave launch for the batch."""
            if wd.rows == 0:
                return preds.new_zeros((BC, 0)), x, gptr
            pad = wd.rows * nl - wd.kw
            bk = torch.nn.functional.pad(buckets.to(torch.int32), (0, pad))
            bk = bk.reshape(B, C, wd.rows, nl).transpose(1, 2).contiguous()  # [B, rows, C, NL]
            syms, x, gptr = decode_scan_wave(x, gptr, bk, wd.active_rows, stream, tabs)
            syms = syms.transpose(1, 2).reshape(BC, wd.rows * nl)[:, : wd.kw]
            values = (T.unpack_signed(syms) + preds).to(torch.int32)
            return values, x, gptr

        # wave 0 (DC phase A: context-free) + wave 1 (phase B)
        w0, w1, w2 = waves[0], waves[1], waves[2]
        z = torch.zeros((BC, w0.kw, 6), dtype=torch.int32, device=dev)
        bk0, pr0 = _wave_contexts(w0, z, vparams, wparams)
        v0, x, gptr = scan_wave(w0, bk0, pr0, x, gptr)
        qrows[:, w0.wslot] = v0
        dcA = _to_grid(w0, v0)

        planes = _tap_planes(w1, dcA, None)
        bk1, pr1 = _wave_contexts(w1, _pack_tap_vals(w1, planes), vparams, wparams)
        v1, x, gptr = scan_wave(w1, bk1, pr1, x, gptr)
        qrows[:, w1.wslot] = v1
        dc = _to_grid(w1, v1, base=dcA)

        # wave 2 (root-HF: taps = neighbour DC values)
        planes = _tap_planes(w2, dc, None)
        bk2, pr2 = _wave_contexts(w2, _pack_tap_vals(w2, planes), vparams, wparams)
        v2, x, gptr = scan_wave(w2, bk2, pr2, x, gptr)
        qrows[:, w2.wslot] = v2

        # HF levels: parent broadcast -> shifts -> rows
        parent = _to_grid(w2, v2)
        for wd in waves[3:]:
            pv = _broadcast_parent(wd, parent)
            planes = _tap_planes(wd, pv, parent)
            bk, pr = _wave_contexts(wd, _pack_tap_vals(wd, planes), vparams, wparams)
            vv, x, gptr = scan_wave(wd, bk, pr, x, gptr)
            qrows[:, wd.wslot] = vv
            parent = _to_grid(wd, vv)
        if stages is not None:
            stages.mark("decode/waves")

        # dequantize + inverse lifting, clamp, inverse transform and the
        # pixel scatter of every image: kernel B, on the planes where they lie
        out = dequantize_inverse_lift_pixels(
            qplane, prog.node_mask_u8, prog.leaf_mask_u8, qdiv, prog.leaf_pix,
            prog.pix_inv, tids,
        )
        if stages is not None:
            stages.mark("decode/pixels")
        return out

    return decode


def build_grid_encode(prog, geo, sched, waves: List[WaveDev]):
    """Dense grid-mode encode statistics (grid_decode.build_grid_encode):
    tap planes from shifts of the known coefficient plane in wave order,
    predictor fits on a subsample of at most FRAVE_FIT_CAP cells per wave,
    contexts evaluated on the dense grid. Returns
    stats(qplane [rows, n_slots + 1] int32, overrides) ->
    (vparams [rows, F, 6] f32, wparams, buckets [rows, K], symbols
    [rows, K]), rows the B*C (image, channel) rows of a batch; `overrides`
    as fit_predictors takes them, [rows, F, 6]."""
    from .pipeline_torch import fit_predictors

    n_slots = prog.n_slots
    if sched.num_fine != len(waves):
        raise AssertionError("one predictor group per wave expected")
    dev = prog.device
    # FRAVE_FIT_CAP, read as the JAX package reads it: the Gram-sample cap
    # per predictor group (0 = none); the fitted values travel on the
    # wire, so subsampling moves only the rate
    cap = int(os.environ.get("FRAVE_FIT_CAP", str(1 << 17)))
    sub_idx = []
    for wd in waves:
        stride = -(-wd.kw // cap) if (cap > 0 and wd.kw > cap) else 1
        if stride == 1:
            sub_idx.append((wd.pack_idx, wd.tap_valid, wd.wslot))
            continue
        pidx = np.nonzero(wd.wp.active.reshape(-1))[0]
        sel = pidx[::stride]
        tv = wd.wp.tap_valid.reshape(6, -1).T[sel]
        slot = wd.wp.slot_grid.reshape(-1)[sel]
        sub_idx.append(
            (
                torch.as_tensor(sel, dtype=_I64, device=dev),
                torch.as_tensor(tv, dtype=torch.bool, device=dev),
                torch.as_tensor(slot, dtype=_I64, device=dev),
            )
        )

    def stats(qplane, overrides):
        C = qplane.shape[0]

        def vgrid(wd):
            return qplane[:, wd.slot_safe].reshape((C,) + wd.shape)

        w1, w2 = waves[1], waves[2]
        g0 = vgrid(waves[0])
        g1 = vgrid(w1)
        dc = torch.where(w1.active_dense[None], g1, g0)
        planes = [None] * len(waves)
        planes[1] = _tap_planes(w1, g0, None)
        planes[2] = _tap_planes(w2, dc, None)
        parent = vgrid(w2)
        for i in range(3, len(waves)):
            wd = waves[i]
            pv = _broadcast_parent(wd, parent)
            planes[i] = _tap_planes(wd, pv, parent)
            parent = vgrid(wd)

        # predictor fits on the (subsampled) packed taps
        Xs_l, ys_l = [], []
        for i, wd in enumerate(waves):
            cells_s, tv_s, slot_s = sub_idx[i]
            if planes[i] is None:  # wave 0: all taps absent
                Xs = torch.zeros((C, cells_s.shape[0], 6), dtype=torch.float32, device=dev)
            else:
                Xs = _pack_tap_vals(wd, planes[i], cells_s, tv_s).to(torch.float32)
            Xs_l.append(Xs)
            ys_l.append(qplane[:, slot_s].to(torch.float32))
        vparams, wparams = fit_predictors(Xs_l, ys_l, overrides)

        # per-wave contexts + symbols, packed in schedule order
        bks, syms = [], []
        for i, wd in enumerate(waves):
            if planes[i] is None:
                z = torch.zeros((C, wd.kw, 6), dtype=torch.int32, device=dev)
                bk, pr = _wave_contexts(wd, z, vparams, wparams)
            else:
                bk, pr = _plane_contexts(wd, planes[i], vparams, wparams)
            tgt = qplane[:, wd.wslot]
            bks.append(bk)
            syms.append(T.pack_signed(tgt - pr))
        return vparams, wparams, torch.cat(bks, dim=1), torch.cat(syms, dim=1)

    return stats
