"""The grid-mode decode of a program whose lattice has exact parent maps:
per non-empty wave, kernel W (ops/wave_ctx.py) computes the wave's
contexts and predictions from the schedule records, kernel 3
(ops/rans_torch.decode_scan_wave) decodes its rANS rows, and kernel V
stores its values into the coefficient plane; then kernel B dequantizes,
inverse-lifts and scatters the pixels of every image.

A wave's symbols are contiguous in schedule order (schedule.wave_sizes)
and fill rows of NL interleaved lanes back to back, so a wave is its
symbol count, its row count and the [rows, NL] mask of its live lanes.
Shapes whose lattice has no exact parent maps (tiny ones) have no such
table: grid_waves raises lattice.DenseGridUnavailable and the program
decodes them through kernel D's step tensors instead.

The decode takes a same-shape batch: W and V run over the B*C (image,
channel) rows of the plane, and what is per image keeps its [B] axis
(the streams and their positions, the lane states, qdiv and the
transform ids).
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from ..entropy.tables import ALPHABET_SIZE, CONTEXT_AMOUNT
from ..entropy.tables_torch import finalize_contexts_device
from ..fractal.lattice import DenseGridUnavailable, get_lattice_grids
from ..ops.lifting import dequantize_inverse_lift_pixels, zero_plane
from ..ops.rans_torch import decode_scan_wave, decode_tables
from ..ops.wave_ctx import wave_contexts, wave_finish

_I64 = torch.int64


class Wave(NamedTuple):
    """One grid wave: kw symbols on `rows` rows of NL lanes, and
    active_rows [rows, NL] bool on the device (the first kw lanes of
    rows x NL), kernel 3's live lanes."""

    kw: int
    rows: int
    active_rows: torch.Tensor


def grid_waves(geo, sched, nl: int, device) -> List[Wave]:
    """The wave table of a grid program on `device`, from the schedule's
    wave sizes. Raises lattice.DenseGridUnavailable where the lattice
    has no exact parent maps (tiny shapes)."""
    if get_lattice_grids(geo.height, geo.width, geo.depth).fixups is None:
        raise DenseGridUnavailable("no exact parent polyphase maps at this shape")
    sizes = sched.wave_sizes.tolist()
    if len(sizes) != sched.max_wave or sum(sizes) != sched.num_symbols:
        raise AssertionError("wave sizes disagree with the schedule")
    waves = []
    for kw in sizes:
        rows = -(-kw // nl)  # 0 for empty waves
        lanes = torch.arange(rows * nl, device=device).reshape(rows, nl)
        waves.append(Wave(kw, rows, lanes < kw))
    return waves


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


def wave_starts(waves: List[Wave]) -> List[int]:
    """Each wave's first schedule index: the waves' symbols are contiguous
    in schedule order, in raster order within a wave (the packed lanes)."""
    return np.cumsum([0] + [wd.kw for wd in waves])[:-1].tolist()


def build_grid_decode(prog, geo, waves: List[Wave]):
    """The decode of a grid-mode CodecProgram with a wave table. Returns
    decode(states [B, C, NL] int64, stream [B, W] int32, wire_bits
    [B, C, CA], offpk [B, C, CA, 32], scales [B, C, CA], vparams / wparams
    [B, C, F, 6] f32, qdiv [B, 512] int32, tids [B] int32) -> pixels
    [B, C, HW] uint8 (all tensors on the program's device): per non-empty
    wave one launch each of kernel W (its contexts from the schedule
    records, ops/wave_ctx.py), kernel 3 (its rANS rows) and kernel V (its
    values into the plane), then one kernel B launch for the whole batch."""
    n_slots = prog.n_slots
    C = prog.channels
    nl = prog.nl
    if sum(wd.rows for wd in waves) != prog.rows:
        raise AssertionError("wave rows disagree with the program's row count")
    if geo.depth != 9:
        raise NotImplementedError(f"depth {geo.depth}: kernel B takes depth 9 only")
    dev = prog.device
    live = [(wd, (k0, wd.kw, nl)) for wd, k0 in zip(waves, wave_starts(waves)) if wd.kw]

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
        x, gptr = states, torch.zeros((B,), dtype=_I64, device=dev)
        # kernel B reads the planes [B, C, n_slots + 1], W and V their rows
        qplane = zero_plane(B, C, n_slots, dev)
        rows = qplane.reshape(BC, n_slots + 1)
        for wd, wave in live:
            buckets, preds = wave_contexts(rows, prog.records, vparams, wparams, C, wave)
            syms, x, gptr = decode_scan_wave(x, gptr, buckets, wd.active_rows, stream, tabs)
            wave_finish(syms[None], preds, prog.records, wave, rows, C)
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
