"""The codec's device pipeline in PyTorch: the port of
frave_tpu/codec/pipeline_jax.py, every mode, over same-shape batches.

A batch is the JAX package's: images of one shape and colorspace, each
with its own channel transform (and, on decode, its own quantizer), one
EncoderOptions per encode batch. Every device stage whose channels are
independent runs over the B*C (image, channel) rows; what is per image
(the stream, its total and position, the transform ids, qdiv on decode,
the header row) keeps a leading [B] axis. Each of the four kernels takes
the whole batch in one launch. The one-image calls are batches of one.

Encode (CodecProgram.encode_exec): channel transform, leaf gather,
forward lifting + quantize (one launch, kernel A) -> statistics: the
predictor fits over the fit samples (every HF symbol; in grid mode from
K = 2^18 symbols up every fit_stride-th of a wave, as the JAX program's
dense grid statistics subsample), Gram/Cholesky rounded to the f16 wire
values (four launches, ops/fit_stats.py) -> contexts and zig-zag symbols from
the schedule records (one launch, kernel W, ops/wave_ctx.py) ->
exact histogram -> context tables -> reverse rANS scan (kernel C) over
the program's row map (grid mode: each wave's rows; the parallel and
parity modes: K symbols packed tightly) -> stream compaction per image
(grid mode: the flat grid order; the others: schedule.get_stream_perm's
decode order) -> one packed int32 row per image (headers + stream) that
the host unpacks into a container.

Decode (CodecProgram.decode_exec): table regeneration -> grid mode with a
wave table (codec/grid_decode.py): per wave, the contexts from the
schedule records (kernel W), the rANS rows (kernel 3), the values into
the plane (kernel V); every other program (the parallel and parity
modes, and grid-mode shapes under ~32 px a side): every step of the step
tensors in one launch of kernel D (ops/step_decode.py) -> dequantize +
inverse lifting, clamp, inverse transform and pixel scatter (kernel B).

Everything the JAX program uploads once per shape (geometry gathers,
masks, schedule tensors, Laplace grid) is built from the same
numpy host structures (the port's copies of frave_tpu's host modules)
and kept on the program's device.

The _stream drivers overlap the host's work on one batch (fetch, unpack,
serialize) with the device's on the next: uploads go through pinned host
memory as non_blocking copies on the current stream, and every fetch runs
on a side CUDA stream that waits only for the event recorded after its
own batch, so it never waits behind work queued later. The host blocks
only on those fetches: each batch's headers (with each image's residual
sums, and its histograms under verbose or emit_coefficients), then its
stream prefix (two per encode batch), its pixels or mismatch count (one
per decode batch); and, before an RGB batch under the "auto" transform
policy is queued, its gradient counts: the pixels' upload and the count
kernel (ops/transform_counts.py) run on a stream of their own
(_count_stream), so that wait covers them alone, and the host decides
each image's transform from the counts (transform_from_counts).

Metrics (metrics.get_metrics()), as the JAX pipeline records them:
encode/bpp and encode/mean_abs_residual_ch{c} an image; the context
entropies (and, under emit_coefficients, histograms) on request; and the
stage times of a StageTimes a caller passes.

Spans (profiling.annotate; recorded only while a torch.profiler session
is): one a batch or call for each host step, frave.encode.{dispatch,
transform (the choice; under "auto" the count launch, its fetch and the
decision), upload, launch, finish, unpack, reencode},
frave.decode.{dispatch, assemble, upload, launch, finish, wrap},
frave.fetch (each blocking fetch), frave.container.{serialize, parse}
and frave.stream.wait (the stream's main thread waiting on a worker);
inside those, the host's per-pixel copies: frave.encode.stack (the
pixels stacked into one array), frave.decode.widen (the uploaded wire
arrays cast to the decode's dtypes, on the device) and frave.pin (each
pinned staging copy of an upload). transfer_bytes counts the bytes
handed to _upload ("h2d") and returned by _fetch ("d2h"), on any device;
quantized_images the images dispatched for an encode ("encode") with,
and assembled for a decode ("decode") from, a quantization matrix that
is not all ones (a lossy preset), whose divisors upload under
frave.encode.upload and are laid out under frave.decode.assemble.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np
import torch

from ..entropy.tables import ALPHABET_SIZE, CONTEXT_AMOUNT, _GRID_LOG2, _LAPLACE_GRID_ROWS
from ..entropy.tables_torch import finalize_contexts_device, select_scales_device
from ..fractal.geometry import BASE_FRAC_DEPTH, get_geometry
from ..fractal.lattice import DenseGridUnavailable
from ..fractal.schedule import (
    default_num_lanes,
    get_lane_steps,
    get_schedule,
    get_stream_perm,
    grid_row_lane,
    rate_adaptive_lanes,
)
from ..images import AnsContextTables, ChannelData, ColorSpace, CompressedImage, RasterImage
from ..metrics import get_metrics
from ..ops import fit_stats as FS
from ..ops import torch_ops as T
from ..ops.fit_stats import fit_predictors  # noqa: F401  (the sharded encoder's fits)
from ..ops.lifting import dequantize_inverse_lift_pixels, forward_lift_quantize_pixels
from ..ops.rans_torch import (
    encode_scan,
    pack_u16_pairs,
    row_map,
    stream_compact,
    stream_compact_grid,
)
from ..ops import step_decode as SD
from ..ops import wave_ctx as WC
from ..ops.step_decode import decode_steps
from ..ops.transform_counts import transform_counts
from ..profiling import annotate
from .channel_transform import choose_transform, transform_from_counts
from .grid_decode import build_grid_decode, grid_waves, wave_starts, wire_tables
from .container import deserialize, serialize
from .options import EncoderOptions, quantization_matrix

_I64 = torch.int64
_I32 = torch.int32
_F32 = torch.float32
# per channel: bits [CA] + off bitmask [CA, 32] + Laplace-grid scales [CA]
_HDR_TABLES = CONTEXT_AMOUNT + CONTEXT_AMOUNT * (ALPHABET_SIZE // 32) + CONTEXT_AMOUNT
# the statistics gate of the JAX program: the strided fits from this many
# symbols up (FRAVE_GRID_ENC="force" always, "0" never)
GRID_ENC_MIN_K = 1 << 18


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA device without CUDA raises (the
    port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' requested but torch.cuda.is_available() is false"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise RuntimeError(f"unsupported device {dev}")
    return dev


class StageTimes:
    """Optional per-stage wall times (ms) of one encode or decode batch: each
    mark() synchronises the device, charges the time since the last mark
    to its stage and records it (in seconds) in the metrics sink under the
    stage's name. Costs one synchronisation per stage when passed, nothing
    when not."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.ms: Dict[str, float] = {}
        self._t = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        self._sync()
        self._t = time.perf_counter()

    def mark(self, name: str):
        self._sync()
        now = time.perf_counter()
        self.ms[name] = self.ms.get(name, 0.0) + (now - self._t) * 1e3
        get_metrics().record(name, now - self._t)
        self._t = now


def _u32_to_i32(t: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same 32 bits."""
    t = t.to(_I64)
    return (t - ((t >> 31) & 1) * (1 << 32)).to(_I32)


def pixel_inverse(leaf_pix: np.ndarray, hw: int) -> np.ndarray:
    """The leaf of each of the hw pixels [hw] int64, from the pixel of
    each leaf (-1 out of bounds). Raises unless the in-bounds leaves cover
    every pixel exactly once: only then does kernel B's scatter through
    leaf_pix equal the reference's gather through this inverse."""
    inb = leaf_pix >= 0
    counts = np.bincount(leaf_pix[inb], minlength=hw)
    if counts.shape[0] != hw or not (counts == 1).all():
        raise AssertionError("the in-bounds leaves do not cover each pixel exactly once")
    inv = np.zeros(hw, dtype=np.int64)
    inv[leaf_pix[inb]] = np.nonzero(inb)[0]
    return inv


def check_step_order(steps, n_slots: int, step_map=None, rec=None) -> None:
    """Raise unless the step tensors store each plane slot at most once and
    every tap of step s reads a slot that an earlier step stores, or that
    no step stores (it reads 0); with kernel D's operands (step_map, rec
    of step_decode.step_operands_host), also unless every tap of step s
    is a schedule index below the step's own first index k0 (or -1).
    Kernel D needs this: it stores a step's values before the step's
    barrier (the block scan's, or the cluster exchange's) and reads the
    next step's taps after it, and nothing orders a read against a store
    of the same step."""
    coef = steps.step_coef
    act = coef >= 0
    s_of = np.nonzero(act)[0]
    slots = coef[act].astype(np.int64)
    if slots.size and (slots.max() >= n_slots or np.unique(slots).size != slots.size):
        raise AssertionError("a plane slot is stored twice, or past the plane")
    written = np.full(n_slots, np.iinfo(np.int64).max, dtype=np.int64)
    written[slots] = s_of
    nb = steps.step_nbr
    taps = nb >= 0
    reader = np.broadcast_to(np.arange(nb.shape[0])[:, None, None], nb.shape)[taps]
    stored = written[np.clip(nb[taps], 0, n_slots - 1)]
    if np.any((stored >= reader) & (stored != np.iinfo(np.int64).max)):
        raise AssertionError("a step reads a slot that the same or a later step stores")
    if step_map is None:
        return
    k0 = np.repeat(step_map[:, 0], step_map[:, 2])
    if k0.shape[0] != rec.shape[0] or np.any(rec[:, 1:7] >= k0[:, None]):
        raise AssertionError("a step's tap reads a schedule index at or past the step's first")


def fit_stride(kw: int) -> int:
    """The subsampling stride of a predictor group of kw symbols in grid
    mode's strided fits: FRAVE_FIT_CAP, read as the JAX package reads it,
    caps the Gram samples of a group (0 = none) at every stride-th symbol
    in lane order; the fitted values travel on the wire, so subsampling
    moves only the rate."""
    cap = int(os.environ.get("FRAVE_FIT_CAP", str(1 << 17)))
    return -(-kw // cap) if (cap > 0 and kw > cap) else 1


class CodecProgram:
    """The codec for one (height, width, num_lanes, channels, mode) on one
    device, over same-shape batches of any size. Build with
    CodecProgram.from_host."""

    @classmethod
    def from_host(cls, height: int, width: int, nl: int, channels: int, device,
                  mode: str = "grid"):
        """Build every device constant from the numpy structures that
        pipeline_jax.CodecProgram uploads: the pixel gather and masks, the
        schedule tensors, the pixel map (leaf_pix and pix_inv), the
        Laplace grid and the row map; in grid mode the wave table
        (grid_decode.grid_waves), or, at shapes whose lattice has no exact
        parent maps (under ~32 px a side), the grid lane steps of kernel D;
        in the parallel and parity modes the lane steps and the stream
        permutation. An unknown mode raises ValueError
        (schedule.build_schedule)."""
        self = cls()
        dev = resolve_device(device)
        depth = BASE_FRAC_DEPTH
        C, h, w = channels, height, width
        geo = get_geometry(h, w, depth)
        sched = get_schedule(h, w, depth, mode=mode)
        K = sched.num_symbols
        if mode == "grid":
            # every wave's symbols are contiguous in schedule order and
            # fill rows of NL lanes back to back (grid_row_lane)
            _, _, R, _ = grid_row_lane(sched, nl)
            row_k0, row_len = row_map(sched.wave_sizes, nl)
        else:
            # K symbols packed tightly: row r holds [r*NL, (r+1)*NL)
            R = -(-K // nl)
            row_k0, row_len = row_map([K], nl)
        Tn, N = geo.num_tiles, geo.nodes_per_tile
        n_slots = Tn * N
        self.height, self.width, self.depth = h, w, depth
        self.nl, self.channels, self.device, self.mode = nl, C, dev, mode
        self.num_tiles, self.num_symbols, self.rows = Tn, K, R
        self.n_slots = n_slots
        self.kc = K * C
        self.num_fine = sched.num_fine
        self.legacy_of_fine = sched.legacy_of_fine.astype(np.int64)
        # + 1: per-channel expected-code-length f32 (rate-adaptive lanes)
        self.chan_hdr = 12 * sched.num_fine + _HDR_TABLES + nl + 1
        self.hdr_words = C * self.chan_hdr + 1  # + global stream total

        def put(a, dt=_I64):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)

        pg = geo.pixel_gather.astype(np.int64)  # [T, N]
        self.leaf_mask_u8 = put(pg >= 0, torch.uint8)
        # the schedule's symbols on the host (absent taps at the zero slot);
        # on the device kernels W and V read one 32-byte record a symbol
        self.sc = sched.sched_coef.astype(np.int64)
        self.snbr_safe = np.where(sched.sched_nbr >= 0, sched.sched_nbr, n_slots).astype(np.int64)
        self.slf = sched.sched_lf.astype(bool)
        self.sgrp = sched.sched_group.astype(np.int64)
        self.sfbkt = sched.sched_fbkt.astype(np.int64)
        rec = WC.records_host(self.sc, sched.sched_nbr, self.slf, self.sgrp, self.sfbkt, n_slots)
        self.records = WC.upload(rec, n_slots, dev)
        self.lap = put(_LAPLACE_GRID_ROWS)  # [NUM_SCALES, 7, 1024]
        self.glog2 = put(_GRID_LOG2, _F32)
        self.gzero = put(_LAPLACE_GRID_ROWS == 0, _F32)
        # predictor groups occupy contiguous schedule ranges (HF symbols)
        hf = ~sched.sched_lf
        grp = sched.sched_group.astype(np.int64)
        self.group_ranges = []
        for g in range(sched.num_fine):
            idx = np.nonzero(hf & (grp == g))[0]
            if idx.size == 0:
                self.group_ranges.append((0, 0))
                continue
            lo, hi = int(idx.min()), int(idx.max()) + 1
            if idx.size != hi - lo:
                raise AssertionError(f"predictor group {g} not contiguous")
            self.group_ranges.append((lo, hi))
        # kernel C reads the symbols in schedule order through the row map
        if row_k0.shape[0] != R or int(row_len.sum()) != K:
            raise AssertionError("row map disagrees with the row count")
        self.row_k0 = put(row_k0, _I32)
        self.row_len = put(row_len, _I32)
        # the pixel map: kernel A gathers leaf i from pixel leaf_pix[i] and
        # kernel B scatters it back (-1 out of bounds); B's plain version
        # gathers pixel p from leaf pix_inv[p]
        pgf = pg.reshape(-1)
        self.leaf_pix = put(pgf, _I32)
        self.pix_inv = put(pixel_inverse(pgf, h * w))
        self.node_mask = put(geo.coef_mask, torch.bool)
        self.node_mask_u8 = put(geo.coef_mask, torch.uint8)

        self.grid_enc = None
        self.steps = self.perm = None
        self.num_steps = 0
        self.fit_samples = {False: self._fit_samples(put, strided=False)}
        self._fit_tables = {}
        waves = None
        if mode == "grid":
            try:
                waves = grid_waves(geo, sched, nl, dev)
            except DenseGridUnavailable:
                pass  # tiny shapes: the step tensors below decode the same wire
        self.waves = waves
        if waves is not None:
            # kernel V walks each wave in slot order
            self.records = WC.with_slot_order(
                self.records, rec, [(k0, wd.kw) for wd, k0 in zip(waves, wave_starts(waves))])
            self.decode_fn = build_grid_decode(self, geo, waves)
            genc = os.environ.get("FRAVE_GRID_ENC", "1")
            if genc == "force" or (genc == "1" and K >= GRID_ENC_MIN_K):
                self.fit_samples[True] = self._fit_samples(put, strided=True)
                self.grid_enc = self._grid_stats
            return self
        lane_steps = get_lane_steps(h, w, nl, depth, mode)
        if lane_steps.rows_are_steps != (mode == "grid") or (
            mode == "grid" and lane_steps.num_steps != R
        ):
            raise AssertionError("lane steps disagree with the row map")
        # kernel D's operands: the step map and the schedule-order records
        step_map, rec = SD.step_operands_host(sched, lane_steps, n_slots)
        check_step_order(lane_steps, n_slots, step_map, rec)
        self.steps = SD.upload(step_map, rec, nl, dev)
        self.num_steps = lane_steps.num_steps
        if mode != "grid":
            # decode rank -> emission-grid slot (grid mode's decode order
            # is the flat grid order itself)
            self.perm = put(get_stream_perm(h, w, nl, depth, mode, C))
        self.decode_fn = self._decode_steps
        return self

    def _overrides(self, overrides, images: int):
        """EncoderOptions.prediction_overrides(C) -> device tensors [B*C,
        F, 6], shared by the batch's `images` images (3-row legacy sets
        expand to the fine ids)."""
        if overrides is None:
            return None
        vp_np, wp_np, use_w = overrides
        F = self.num_fine

        def exp(p):
            p = np.asarray(p, dtype=np.float32)
            if p.shape[-2] == 3 and F != 3:
                p = p[..., self.legacy_of_fine, :]
            if p.shape[-2:] != (F, 6):
                raise ValueError(f"override params must have 3 or {F} rows")
            return _upload([p], self.device)[0].repeat(images, 1, 1)

        return exp(vp_np), exp(wp_np), bool(use_w)

    def _fit_samples(self, put, strided: bool):
        """The fit samples of every predictor group: (tap slots [n, 6] and
        target slots [n] on the device, the schedule indices [n_g] of each
        group on the host), the groups' schedule ranges in order. Every HF
        symbol of a group, or, strided (grid mode's statistics from
        GRID_ENC_MIN_K symbols up, as the JAX program's dense grid
        statistics subsample), every fit_stride-th symbol of its range (a
        grid wave, in raster order)."""
        ks = [np.arange(lo, hi, fit_stride(hi - lo) if strided else 1)
              for lo, hi in self.group_ranges]
        idx = np.concatenate(ks)
        return put(self.snbr_safe[idx]), put(self.sc[idx]), ks

    def fit_table(self, strided: bool):
        """The FitTable (ops/fit_stats.py) of fit_samples[strided], built
        at its first use and kept: a program fits with one of its sample
        sets, and the other's table never reaches the card."""
        table = self._fit_tables.get(strided)
        if table is None:
            taps, target, ks = self.fit_samples[strided]
            table = FS.fit_table(taps, target, [k.shape[0] for k in ks])
            self._fit_tables[strided] = table
        return table

    def _stats(self, qplane, overrides, strided: bool):
        """The statistics of qplane [rows, n_slots + 1], a row one (image,
        channel) of a batch: the per-group fits of the sample set's table
        (ops/fit_stats.py: four launches on the card), then every symbol's
        bucket and zig-zag symbol in one launch of kernel W
        (ops/wave_ctx.py)."""
        vparams, wparams = FS.fit_stats(qplane, self.fit_table(strided), overrides)
        buckets, symbols = WC.wave_contexts(qplane, self.records, vparams, wparams,
                                            self.channels)
        return vparams, wparams, buckets, symbols

    def _step_stats(self, qplane, overrides):
        """The statistics with every HF symbol in its group's fit (the
        JAX program's step_stats)."""
        return self._stats(qplane, overrides, strided=False)

    def _grid_stats(self, qplane, overrides):
        """The statistics with grid mode's subsampled fits (the JAX
        program's dense grid statistics, frave_tpu/codec/grid_decode.py
        :598; FRAVE_FIT_CAP)."""
        return self._stats(qplane, overrides, strided=True)

    def encode_exec(self, pixels, qdiv, overrides=None, tids=None, stages=None):
        """pixels [B, HW, C] uint8 on the device, qdiv [512] int32, tids [B]
        int32 channel-transform ids on the device (None: 0) -> (packed
        [B, hdr_words + ceil(K*C/2)] int32, hist [B, C, CA, 1024] int32),
        the layout of pipeline_jax's encode output: per image and channel
        vparams, wparams (f32 bits), bits, off-list bitmask, scale indices,
        lane states, expected code length (f32 bits); then the image's
        stream total and its u16 stream packed in pairs. `overrides` pin
        the parameters of every image of the batch. One launch each of
        kernels A and C for the batch."""
        B = pixels.shape[0]
        C = self.channels
        BC = B * C
        dev = self.device
        if tids is None:
            tids = torch.zeros((B,), dtype=_I32, device=dev)
        if stages is not None:
            stages.start()
        # channel transform, leaf gather, lifting, quantize and the zero
        # slot of every image: kernel A -> [B, C, n_slots + 1], statistics
        # over its [B*C, n_slots + 1] rows (a view)
        qplane = forward_lift_quantize_pixels(pixels, self.leaf_pix, qdiv, tids)
        rows = qplane.reshape(BC, qplane.shape[-1])
        if stages is not None:
            stages.mark("encode/lift")
        ovr = self._overrides(overrides, B)
        stats = self.grid_enc or self._step_stats
        vparams, wparams, buckets, symbols = stats(rows, ovr)  # int32, schedule order
        if stages is not None:
            stages.mark("encode/stats")

        hist = self.histogram(buckets, symbols, B)
        tables = self.tables(hist)
        if stages is not None:
            stages.mark("encode/tables")

        K = self.num_symbols
        bits, freqs, cdfs = tables[:3]
        states, words, flags = encode_scan(
            symbols.view(B, C, K), buckets.view(B, C, K), self.row_k0, self.row_len,
            freqs.to(_I32), cdfs.to(_I32), bits.to(_I32), self.nl,
        )
        if stages is not None:
            stages.mark("encode/rans")
        packed = self.pack(states, words, flags, tables, vparams, wparams)
        if stages is not None:
            stages.mark("encode/compact")
        return packed, hist.to(_I32)

    def histogram(self, buckets, symbols, images: int, valid=None):
        """The exact histogram [B, C, CA, 1024] int64 of (row, bucket,
        symbol) over buckets / symbols [B*C, K'] (the rows of `images`
        images; `valid` [K'] bool counts only those positions), into a
        buffer of known size (bincount would read the largest id back to
        size its output)."""
        BC, dev = buckets.shape[0], buckets.device
        row = torch.arange(BC, device=dev, dtype=_I64)[:, None]
        ids = (row * CONTEXT_AMOUNT + buckets.to(_I64)) * ALPHABET_SIZE + torch.clamp(
            symbols.to(_I64), 0, ALPHABET_SIZE - 1
        )
        ones = torch.ones_like(ids)
        if valid is not None:
            ones = ones * valid.to(_I64)
        hist = torch.zeros(BC * CONTEXT_AMOUNT * ALPHABET_SIZE, dtype=_I64, device=dev)
        hist = hist.index_add_(0, ids.reshape(-1), ones.reshape(-1))
        return hist.reshape(images, BC // images, CONTEXT_AMOUNT, ALPHABET_SIZE)

    def tables(self, hist):
        """A batch's histogram -> (bits, freqs, cdfs, off_mask, scales,
        exp_bits): the context tables of every (image, channel) and the
        expected code length under them (f32 a channel)."""
        scales = select_scales_device(hist, self.glog2, self.gzero)
        bits, freqs, cdfs, off_mask = finalize_contexts_device(hist, self.lap, scale_idx=scales)
        hf = hist.to(_F32)
        exp_bits = torch.where(
            hist > 0,
            hf * (bits.to(_F32)[..., None] - torch.log2(torch.clamp(freqs.to(_F32), min=1.0))),
            torch.zeros((), dtype=_F32, device=hist.device),
        ).sum(dim=(2, 3))
        return bits, freqs, cdfs, off_mask, scales, exp_bits

    def pack(self, states, words, flags, tables, vparams, wparams):
        """Kernel C's output of a batch (states [B, C, NL], words / flags
        [B, R, C, NL]), its tables and fits -> packed [B, hdr_words +
        ceil(K*C/2)] int32 (encode_exec's layout): each image's stream
        compacted in its decode order, then the header row."""
        B, C = states.shape[:2]
        dev = states.device
        bits, _, _, off_mask, scales, exp_bits = tables
        if self.perm is None:
            stream, total = stream_compact_grid(words, flags, self.kc)  # [B, K*C], [B]
        else:
            stream, total = stream_compact(words, flags, self.perm, self.kc)
        spk = pack_u16_pairs(stream)  # [B, ceil(K*C/2)]
        om = off_mask.reshape(B, C, CONTEXT_AMOUNT, ALPHABET_SIZE // 32, 32).to(_I64)
        ompk = (om << torch.arange(32, device=dev, dtype=_I64)).sum(-1)
        headers = torch.cat(
            [
                vparams.contiguous().view(_I32).reshape(B, C, -1),
                wparams.contiguous().view(_I32).reshape(B, C, -1),
                bits.to(_I32),
                _u32_to_i32(ompk).reshape(B, C, -1),
                scales.to(_I32),
                _u32_to_i32(states),
                exp_bits.contiguous().view(_I32)[..., None],
            ],
            dim=2,
        )
        return torch.cat([headers.reshape(B, -1), total.to(_I32)[:, None], spk], dim=1)

    def step_operands(self, states, stream, wire_bits, offpk, scales, vparams, wparams):
        """A batch's wire fields (as decode_exec takes them) -> the operands
        of ops/step_decode.decode_steps over this program's step operands:
        (x, gptr, steps, vparams, wparams, stream, tabs, n_slots)."""
        if self.steps is None:
            raise ValueError("this program decodes with the grid waves, not steps")
        tabs = wire_tables(self.lap, wire_bits, offpk, scales)
        gptr = torch.zeros((states.shape[0],), dtype=_I64, device=self.device)
        return (states, gptr, self.steps, vparams, wparams, stream, tabs, self.n_slots)

    def _decode_steps(self, states, stream, wire_bits, offpk, scales, vparams, wparams,
                      qdiv, tids, stages=None):
        """decode_exec over the step tensors: the wire tables, every step in
        one launch of kernel D, then kernel B on the plane it wrote."""
        ops = self.step_operands(states, stream, wire_bits, offpk, scales, vparams, wparams)
        if stages is not None:
            stages.mark("decode/tables")
        plane, _, _ = decode_steps(*ops)
        if stages is not None:
            stages.mark("decode/steps")
        out = dequantize_inverse_lift_pixels(
            plane, self.node_mask_u8, self.leaf_mask_u8, qdiv, self.leaf_pix, self.pix_inv, tids,
        )
        if stages is not None:
            stages.mark("decode/pixels")
        return out

    def decode_exec(self, states, stream, wire_bits, offpk, scales, vparams,
                    wparams, qdiv, tids, stages=None):
        """Wire fields of a batch (device tensors: states [B, C, NL] int64,
        stream [B, W] int32 u16 words zero-padded by >= C*NL, wire_bits /
        offpk / scales [B, C, CA(, 32)] int64, vparams / wparams
        [B, C, F, 6] f32, qdiv [B, 512] int32, one quantizer an image, tids
        [B] int32) -> pixels [B, C, HW] uint8, each image's inverse channel
        transform applied."""
        if stages is not None:
            stages.start()
        return self.decode_fn(
            states, stream, wire_bits, offpk, scales, vparams, wparams, qdiv,
            tids, stages=stages,
        )


_program_cache: Dict[tuple, CodecProgram] = {}
_cache_lock = threading.Lock()


def get_program(height, width, nl, channels, device, mode: str = "grid") -> CodecProgram:
    """Cached CodecProgram.from_host per (shape, lanes, channels, device,
    mode)."""
    dev = resolve_device(device)
    key = (height, width, nl, channels, str(dev), mode)
    with _cache_lock:
        p = _program_cache.get(key)
    if p is None:
        p = CodecProgram.from_host(height, width, nl, channels, dev, mode)
        with _cache_lock:
            _program_cache[key] = p
    return p


def _qdiv_array(qm: np.ndarray, depth: int) -> np.ndarray:
    """Per-haar-index divisor: qm[floor(log2(i + 1))]."""
    n = 1 << depth
    layers = np.floor(np.log2(np.arange(n) + 1)).astype(np.int32)
    return np.asarray(qm, dtype=np.int32)[layers]


def _unpack_channels(head: np.ndarray, prog: CodecProgram):
    """One image's header row -> (channel_data list, est_payload_bytes)."""
    C, nl = prog.channels, prog.nl
    out = []
    est_bits = 0.0
    arr = head[: C * prog.chan_hdr].reshape(C, prog.chan_hdr)
    npar = 6 * prog.num_fine
    nmask = CONTEXT_AMOUNT * (ALPHABET_SIZE // 32)
    for c in range(C):
        v = arr[c]
        o = 0
        vp = v[o : o + npar].view(np.float32).reshape(-1, 6).copy(); o += npar
        wp = v[o : o + npar].view(np.float32).reshape(-1, 6).copy(); o += npar
        bits = v[o : o + CONTEXT_AMOUNT].copy(); o += CONTEXT_AMOUNT
        ompk = v[o : o + nmask].view(np.uint32).reshape(CONTEXT_AMOUNT, -1); o += nmask
        scales = v[o : o + CONTEXT_AMOUNT].copy(); o += CONTEXT_AMOUNT
        states = v[o : o + nl].view(np.uint32).copy(); o += nl
        est_bits += float(v[o : o + 1].view(np.float32)[0])
        contexts = []
        for b in range(CONTEXT_AMOUNT):
            mask_bits = (
                (ompk[b][:, None] >> np.arange(32, dtype=np.uint32)) & 1
            ).astype(bool).reshape(-1)
            contexts.append(
                AnsContextTables(
                    max_freq_bits=int(bits[b]),
                    off_distribution_values=np.nonzero(mask_bits)[0].astype(np.uint16),
                    freqs=None,
                    cdf=None,
                    scale_idx=int(scales[b]),
                )
            )
        out.append(
            ChannelData(
                ans_contexts=contexts,
                lane_states=states,
                value_prediction_parameters=vp,
                width_prediction_parameters=wp,
            )
        )
    return out, est_bits / 8.0


# ---------------------------------------------------------------- transfers


# bytes handed to _upload ("h2d") and returned by _fetch ("d2h") in this
# process, on any device
transfer_bytes = {"h2d": 0, "d2h": 0}
_transfer_lock = threading.Lock()


def _count_transfer(side: str, arrays) -> None:
    n = sum(a.nbytes for a in arrays)
    with _transfer_lock:
        transfer_bytes[side] += n


# images dispatched for an encode ("encode") with, and assembled for a
# decode ("decode") from, a quantization matrix that is not all ones, in
# this process
quantized_images = {"encode": 0, "decode": 0}
_quantized_lock = threading.Lock()


def _count_quantized(side: str, matrices) -> None:
    n = sum(1 for qm in matrices if (np.asarray(qm) != 1).any())
    with _quantized_lock:
        quantized_images[side] += n


def _upload(arrays, device):
    """numpy arrays -> tensors on `device`: on the card each goes through
    pinned host memory as a non_blocking copy on the current stream (the
    caching host allocator keeps the pinned block until the copy is done),
    so the host does not wait for the device."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    _count_transfer("h2d", arrays)
    ts = [torch.from_numpy(a) for a in arrays]
    if device.type == "cpu":
        return ts
    out = []
    for t in ts:
        with annotate("frave.pin"):
            t = t.pin_memory()
        out.append(t.to(device, non_blocking=True))
    return out


def _ready_event(device):
    """An event recorded on the current stream after the work just queued
    (None on the CPU): what a fetch of that work waits for."""
    if device.type == "cpu":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def _fetch(t, ready):
    """Copy device tensor `t` (or each of a tuple of tensors, in one wait)
    to the host once the work before `ready` is done, and wait for those
    copies alone: on a side stream of the device that waits for `ready`,
    into pinned memory, so work queued after `ready` (the next batch) keeps
    the device busy meanwhile. Safe from worker threads."""
    with annotate("frave.fetch"):
        ts = (t,) if isinstance(t, torch.Tensor) else tuple(t)
        if ts[0].device.type == "cpu":
            hosts = [x.numpy() for x in ts]
        else:
            side = torch.cuda.Stream(device=ts[0].device)
            side.wait_event(ready)
            with torch.cuda.stream(side):
                hosts = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True) for x in ts]
                for h, x in zip(hosts, ts):
                    h.copy_(x, non_blocking=True)
                done = torch.cuda.Event()
                done.record(side)
            done.synchronize()
            hosts = [h.numpy() for h in hosts]
        _count_transfer("d2h", hosts)
        return hosts[0] if isinstance(t, torch.Tensor) else hosts


# ---------------------------------------------------------------- encode


@dataclasses.dataclass
class _EncodeBatch:
    """One dispatched encode batch: its program, the device outputs
    (packed [B, ...], hist, each (image, channel)'s sum of |residual| [B,
    C] int64), the quantization matrix, the images' metadata and transform
    ids, the uploaded pixels [B, HW, C] (the device-verified round trip
    compares against them) and the event after its work."""

    prog: CodecProgram
    packed: torch.Tensor
    hist: torch.Tensor
    resid: torch.Tensor
    qm: np.ndarray
    meta: object
    tids: List[int]
    pixels: torch.Tensor
    ready: object


@functools.lru_cache(maxsize=None)
def _count_stream(device: torch.device):
    """The stream of device on which an "auto" RGB batch's pixel upload and
    gradient counts run, so that the host's wait for the counts covers
    them alone: on the current stream they would queue behind what was
    queued before (in the stream drivers, the decode of an earlier batch).
    A high-priority pool stream: the fetches' side streams come from the
    other pool, so none of them shares it."""
    return torch.cuda.Stream(device=device, priority=-1)


def _counted_tids(images: List[RasterImage], pixels: torch.Tensor, lossless: bool,
                  side) -> List[int]:
    """Each image's transform id from the gradient counts of its uploaded
    pixels [B, HW, 3] (the count kernel, on stream `side`; the plain
    version on the CPU, where `side` is None), decided on the host by
    transform_from_counts (which falls back to the exact proxy on
    im.data on a near tie)."""
    meta = images[0].metadata
    with torch.cuda.stream(side):
        counts = transform_counts(pixels, meta.height, meta.width, lossless)
        ready = _ready_event(pixels.device)
    counts = _fetch(counts, ready)
    return [transform_from_counts(im.data, c, lossless) for im, c in zip(images, counts)]


def _encode_dispatch(images: List[RasterImage], opts: EncoderOptions, device,
                     stages=None, tids=None) -> _EncodeBatch:
    """Upload + queue the fused encode of one same-shape batch without
    waiting for it but for the transform choice: the host resolves each
    image's transform (`tids` forces them, one id 0-3 an RGB image); under
    "auto" it decides from gradient counts that the device makes from the
    uploaded pixels (_counted_tids). The device does the rest."""
    with annotate("frave.encode.dispatch"):
        if not images:
            raise ValueError("an encode batch needs at least one image")
        meta = images[0].metadata
        for im in images:
            if im.metadata != meta:
                raise ValueError("batch images must share shape and colorspace")
        C = meta.num_channels
        lossless = opts.quality.name == "LOSSLESS"
        counted = False
        if meta.colorspace != ColorSpace.RGB:
            tids = [0] * len(images)
        elif tids is None:
            counted = opts.color_transform == "auto"
            if not counted:
                with annotate("frave.encode.transform"):
                    tids = [choose_transform(im.data, opts.color_transform, lossless)
                            for im in images]
        elif len(tids) != len(images) or not all(0 <= t <= 3 for t in tids):
            raise ValueError("tids must give one transform id 0-3 an image")
        sched = get_schedule(meta.height, meta.width, mode=opts.mode)
        nl = opts.num_lanes or default_num_lanes(sched.num_symbols)
        prog = get_program(meta.height, meta.width, nl, C, device, opts.mode)
        qm = quantization_matrix(opts.quality)
        _count_quantized("encode", [qm] * len(images))
        side = _count_stream(prog.device) if counted and prog.device.type == "cuda" else None
        with annotate("frave.encode.upload"):
            with annotate("frave.encode.stack"):
                px = np.stack([im.data.reshape(-1, C) for im in images])  # [B, HW, C] uint8
            with torch.cuda.stream(side):
                (pixels,) = _upload((px,), prog.device)
            (qdiv,) = _upload((_qdiv_array(qm, BASE_FRAC_DEPTH),), prog.device)
        if counted:
            with annotate("frave.encode.transform"):
                tids = _counted_tids(images, pixels, lossless, side)
        with annotate("frave.encode.launch"):
            (tids_dev,) = _upload((np.asarray(tids, np.int32),), prog.device)
            if side is not None:  # the encode reads the pixels uploaded on `side`
                main = torch.cuda.current_stream(prog.device)
                main.wait_stream(side)
                pixels.record_stream(main)
            packed, hist = prog.encode_exec(
                pixels, qdiv, opts.prediction_overrides(C), tids_dev, stages
            )
            resid = residual_sums(hist)
            ready = _ready_event(prog.device)
        return _EncodeBatch(prog, packed, hist, resid, qm, meta, tids, pixels, ready)


def residual_sums(hist: torch.Tensor) -> torch.Tensor:
    """Each (image, channel)'s sum of |residual| over its K symbols, [B, C]
    int64 on the device, from the exact histogram hist [B, C, CA, A]: a
    zig-zag symbol s unpacks to a residual of magnitude (s + 1) >> 1. (The
    histogram counts a symbol at or past ALPHABET_SIZE, which the format
    cannot code, as ALPHABET_SIZE - 1.)"""
    mag = (torch.arange(ALPHABET_SIZE, device=hist.device, dtype=_I64) + 1) >> 1
    return (hist.to(_I64).sum(dim=2) * mag).sum(dim=-1)


def _record_context_stats(hist_i: np.ndarray, C: int, emit: bool) -> None:
    """The per-context entropies of a batch's histograms [B, C, CA, A]
    (and, with `emit`, the histograms) into the metrics sink, as
    pipeline_jax._encode_finish records them."""
    m = get_metrics()
    hist = hist_i.astype(np.float64)
    tot = hist.sum(axis=-1, keepdims=True)
    p = np.where(tot > 0, hist / np.maximum(tot, 1), 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        ent = -np.where(p > 0, p * np.log2(p), 0.0).sum(axis=-1)
    for b in range(hist.shape[0]):
        for c in range(C):
            for k in range(hist.shape[2]):
                if tot[b, c, k, 0] > 0:
                    m.record(f"encode/context_entropy_ch{c}_b{k}", float(ent[b, c, k]))
            if emit:
                for k in range(hist.shape[2]):
                    m.record_array(f"encode/context_hist_ch{c}_b{k}", hist_i[b, c, k])


def _encode_finish(enc: _EncodeBatch, opts: EncoderOptions) -> List[CompressedImage]:
    """Fetch one batch's headers (with each image's stream total and
    residual sums, and under verbose or emit_coefficients its histograms),
    then the stream prefix the largest total needs; record the metrics and
    unpack one container an image."""
    with annotate("frave.encode.finish"):
        prog = enc.prog
        hw = prog.hdr_words
        stats = opts.verbose or opts.emit_coefficients
        first = _fetch((enc.packed[:, :hw], enc.resid) + ((enc.hist,) if stats else ()),
                       enc.ready)
        head, resid = first[0], first[1]
        totals = head[:, hw - 1].astype(np.int64)
        need = int((totals.max() + 1) // 2)
        tail = _fetch(enc.packed[:, hw : hw + need], enc.ready)
        C = prog.channels
        m = get_metrics()
        m.verbose = m.verbose or opts.verbose
        if stats:
            _record_context_stats(first[2], C, opts.emit_coefficients)
        out = []
        with annotate("frave.encode.unpack"):
            for b in range(head.shape[0]):
                for c in range(C):
                    m.record(f"encode/mean_abs_residual_ch{c}",
                             int(resid[b, c]) / prog.num_symbols)
                m.record("encode/bpp", 16.0 * int(totals[b]) / (prog.height * prog.width))
                stream = np.ascontiguousarray(tail[b]).view(np.uint16)[: totals[b]].copy()
                channel_data, est_payload = _unpack_channels(head[b], prog)
                out.append(
                    CompressedImage(
                        metadata=enc.meta,
                        channel_data=list(channel_data) + [None] * (3 - C),
                        quality=opts.quality.value,
                        num_lanes=prog.nl,
                        quantization_matrix=np.asarray(enc.qm, dtype=np.uint16),
                        mode=prog.mode,
                        stream=stream,
                        transform=enc.tids[b],
                        est_payload_bytes=est_payload,
                    )
                )
        return out


def _maybe_reencode_flat(images, cis, opts, device) -> List[CompressedImage]:
    """Rate fix for flat content: where the per-lane wire overhead would
    dominate an image's expected payload (computed on the device),
    re-encode it at the rate-adaptive lane count
    (schedule.rate_adaptive_lanes), one batch for each such count."""
    if opts.num_lanes is not None:
        return cis  # caller pinned lanes (also the re-encode's guard)
    groups: Dict[int, List[int]] = {}
    for i, ci in enumerate(cis):
        if ci.est_payload_bytes is None:
            continue
        nl = rate_adaptive_lanes(ci.num_lanes, ci.est_payload_bytes, ci.metadata.num_channels)
        if nl < ci.num_lanes:
            groups.setdefault(nl, []).append(i)
    if not groups:
        return cis
    with annotate("frave.encode.reencode"):
        for nl, idxs in groups.items():
            redo = encode_pipeline_torch_batch(
                [images[i] for i in idxs], dataclasses.replace(opts, num_lanes=nl), device
            )
            for i, ci in zip(idxs, redo):
                cis[i] = ci
    return cis


def encode_pipeline_torch_batch(
    images: List[RasterImage], opts: EncoderOptions, device="cuda", stages=None
) -> List[CompressedImage]:
    """Encode a batch of same-shape images on `device`: one dispatch (one
    launch of each kernel for the batch), one fetch of the headers and one
    of the streams."""
    enc = _encode_dispatch(images, opts, device, stages)
    cis = _encode_finish(enc, opts)
    if stages is not None:
        stages.mark("encode/fetch")
    return _maybe_reencode_flat(images, cis, opts, device)


def encode_pipeline_torch_stream(
    images: List[RasterImage], opts: EncoderOptions, batch_size: int = 8, device="cuda"
) -> List[CompressedImage]:
    """Host/device-pipelined encode over same-shape images: batch i+1 is
    queued on the device before batch i is fetched and unpacked (double
    buffering). Containers come back in the images' order."""
    out: List[CompressedImage] = []
    pending = None
    for i in range(0, len(images), batch_size):
        enc = _encode_dispatch(images[i : i + batch_size], opts, device)
        if pending is not None:
            out.extend(_encode_finish(pending, opts))
        pending = enc
    if pending is not None:
        out.extend(_encode_finish(pending, opts))
    return _maybe_reencode_flat(images, out, opts, device)


def encode_pipeline_torch(
    image: RasterImage, opts: EncoderOptions, device="cuda", stages=None
) -> CompressedImage:
    """Encode one image on `device` into a CompressedImage (a batch of one)."""
    return encode_pipeline_torch_batch([image], opts, device, stages)[0]


# ---------------------------------------------------------------- decode


def assemble_wire_batch(images, nl: int):
    """Stack a same-shape batch's container fields into the arrays
    decode_exec consumes: (states, streams, bits, offpk, scales, vparams,
    wparams, qdiv, tids) as numpy arrays; streams zero-padded by C*NL
    words past the longest (the decode row's read window)."""
    meta = images[0].metadata
    C = meta.num_channels
    B = len(images)
    maxw = max([1] + [int(np.asarray(im.stream).shape[0]) for im in images])
    Wpad = maxw + C * nl
    sched = get_schedule(meta.height, meta.width, mode=images[0].mode)
    F = sched.num_fine
    bits = np.zeros((B, C, CONTEXT_AMOUNT), dtype=np.int32)
    offpk = np.zeros((B, C, CONTEXT_AMOUNT, ALPHABET_SIZE // 32), dtype=np.uint32)
    # legacy (v<=8) containers select the per-bucket grid row
    scales = np.broadcast_to(
        np.arange(CONTEXT_AMOUNT, dtype=np.int32), (B, C, CONTEXT_AMOUNT)
    ).copy()
    states = np.zeros((B, C, nl), dtype=np.uint32)
    streams = np.zeros((B, Wpad), dtype=np.uint16)
    vparams = np.zeros((B, C, F, 6), dtype=np.float32)
    wparams = np.zeros((B, C, F, 6), dtype=np.float32)
    for b, im in enumerate(images):
        st = np.asarray(im.stream, dtype=np.uint16)
        streams[b, : st.shape[0]] = st
        for c in range(C):
            cd = im.channel_data[c]
            for k, t in enumerate(cd.ans_contexts):
                bits[b, c, k] = t.max_freq_bits
                if t.scale_idx >= 0:
                    scales[b, c, k] = t.scale_idx
                off = np.asarray(t.off_distribution_values, dtype=np.int64)
                if off.size:
                    np.bitwise_or.at(
                        offpk[b, c, k],
                        off // 32,
                        np.uint32(1) << (off % 32).astype(np.uint32),
                    )
            states[b, c] = np.asarray(cd.lane_states, dtype=np.uint32)
            vparams[b, c] = sched.expand_params(cd.value_prediction_parameters)
            wparams[b, c] = sched.expand_params(cd.width_prediction_parameters)
    qdiv = np.stack(
        [
            _qdiv_array(np.asarray(im.quantization_matrix, dtype=np.int32), BASE_FRAC_DEPTH)
            for im in images
        ]
    )
    tids = np.asarray([im.transform for im in images], dtype=np.int32)
    return states, streams, bits, offpk, scales, vparams, wparams, qdiv, tids


def _widen_wire(states, streams, bits, offpk, scales):
    """The uploaded wire arrays (states and offpk: u32 bits as int32;
    streams: u16 bits as int16; bits and scales int32) in the dtypes
    decode_exec takes, on their device: states, bits, offpk and scales
    int64, streams int32."""
    return (states.to(_I64) & 0xFFFFFFFF, streams.to(_I32) & 0xFFFF, bits.to(_I64),
            offpk.to(_I64) & 0xFFFFFFFF, scales.to(_I64))


@dataclasses.dataclass
class _DecodeBatch:
    """One dispatched decode batch: the device pixels [B, C, HW], the
    images' metadata and the event after its work."""

    pixels: torch.Tensor
    meta: object
    ready: object


def _decode_dispatch(images: List[CompressedImage], device, stages=None) -> _DecodeBatch:
    """Upload + queue the decode of one same-shape batch (the images may mix
    quality presets and transforms) without waiting for it."""
    with annotate("frave.decode.dispatch"):
        if not images:
            raise ValueError("a decode batch needs at least one image")
        meta = images[0].metadata
        nl, mode = images[0].num_lanes, images[0].mode
        for im in images:
            if im.metadata != meta or im.num_lanes != nl or im.mode != mode:
                raise ValueError("batch must share shape, colorspace, lanes and mode")
        prog = get_program(meta.height, meta.width, nl, meta.num_channels, device, mode)
        with annotate("frave.decode.assemble"):
            states, streams, bits, offpk, scales, vp, wp, qdiv, tids = assemble_wire_batch(
                images, nl)
            _count_quantized("decode", [im.quantization_matrix for im in images])
        with annotate("frave.decode.upload"):
            # the wire arrays go up in their own widths (the unsigned ones
            # as the signed view of the same bits)
            up = _upload((states.view(np.int32), streams.view(np.int16), bits,
                          offpk.view(np.int32), scales, vp, wp, qdiv, tids), prog.device)
            with annotate("frave.decode.widen"):
                args = _widen_wire(*up[:5]) + tuple(up[5:])
        with annotate("frave.decode.launch"):
            pixels = prog.decode_exec(*args, stages=stages)
            ready = _ready_event(prog.device)
        return _DecodeBatch(pixels, meta, ready)


def _decode_finish(dec: _DecodeBatch, stages=None) -> List[RasterImage]:
    """Fetch a batch's [B, C, HW] device pixels and wrap each image as a
    RasterImage (a transpose on the host)."""
    with annotate("frave.decode.finish"):
        px = _fetch(dec.pixels, dec.ready)
        if stages is not None:
            stages.mark("decode/fetch")
        meta = dec.meta
        C = meta.num_channels
        with annotate("frave.decode.wrap"):
            return [
                RasterImage(metadata=meta, data=px[b].T.reshape(meta.height, meta.width, C))
                for b in range(px.shape[0])
            ]


def decode_pipeline_torch_batch(
    images: List[CompressedImage], device="cuda", stages=None
) -> List[RasterImage]:
    """Decode a batch of same-shape containers of one mode and lane count
    on `device` (they may mix quality presets and transforms): one
    dispatch; one launch of kernel 3 per non-empty wave (grid mode with a
    dense lattice) or one of kernel D (every other program), and one of
    kernel B, for the batch; one fetch."""
    return _decode_finish(_decode_dispatch(images, device, stages), stages)


def decode_pipeline_torch_stream(
    images: List[CompressedImage], batch_size: int = 8, device="cuda"
) -> List[RasterImage]:
    """Host/device-pipelined decode (double buffering, as
    encode_pipeline_torch_stream). Images come back in order."""
    out: List[RasterImage] = []
    pending = None
    for i in range(0, len(images), batch_size):
        dec = _decode_dispatch(images[i : i + batch_size], device)
        if pending is not None:
            out.extend(_decode_finish(pending))
        pending = dec
    if pending is not None:
        out.extend(_decode_finish(pending))
    return out


def decode_pipeline_torch(image: CompressedImage, device="cuda", stages=None) -> RasterImage:
    """Decode one container on `device` (a batch of one)."""
    return decode_pipeline_torch_batch([image], device, stages)[0]


# ---------------------------------------------------------------- round trip


def _device_verify_batch(dec: _DecodeBatch, pixels_in: torch.Tensor):
    """Queue the count of decoded pixels [B, C, HW] that differ from the
    encode's upload [B, HW, C] on the device. Returns a callable that
    fetches it: one scalar crosses to the host instead of the pixels."""
    count = (dec.pixels != pixels_in.transpose(1, 2)).sum()
    ready = _ready_event(count.device)
    return lambda: int(_fetch(count, ready))


def roundtrip_pipeline_torch_stream(
    images: List[RasterImage],
    opts: EncoderOptions,
    batch_size: int = 8,
    device="cuda",
    device_verify: bool = False,
):
    """Software-pipelined encode -> container bytes -> decode over a
    same-shape corpus; returns (blobs, decoded images), or with
    device_verify (blobs, total mismatch count): the decoded pixels are
    compared with the encode's uploaded pixels on the device and never
    fetched.

    The main thread queues the device work in the order enc_i, dec_(i-1);
    two worker threads fetch: one batch's containers (then serialize and
    parse them) while the device runs the next encode, and the decoded
    pixels or mismatch count of the batch before. A fetch waits only for
    its own batch's event (see _fetch), so the host's work rides the
    device's."""
    blobs: List[bytes] = []
    outs: List[RasterImage] = []
    mismatches = 0

    def enc_finish(enc):
        cis = _encode_finish(enc, opts)
        with annotate("frave.container.serialize"):
            bl = [serialize(ci) for ci in cis]
        with annotate("frave.container.parse"):
            parsed = [deserialize(b) for b in bl]
        return bl, parsed, enc.pixels

    def wait(fut):
        with annotate("frave.stream.wait"):
            return fut.result()

    def collect(fut):
        nonlocal mismatches
        if device_verify:
            mismatches += wait(fut)
        else:
            outs.extend(wait(fut))

    with ThreadPoolExecutor(max_workers=2) as pool:

        def launch_decode(cis, pixels_in):
            dec = _decode_dispatch(cis, device)
            if device_verify:
                return pool.submit(_device_verify_batch(dec, pixels_in))
            return pool.submit(_decode_finish, dec)

        enc_fut = dec_fut = None
        for i in range(0, len(images), batch_size):
            enc = _encode_dispatch(images[i : i + batch_size], opts, device)  # enc_i
            new_dec = None
            if enc_fut is not None:
                bl, cis, px_in = wait(enc_fut)
                blobs.extend(bl)
                new_dec = launch_decode(cis, px_in)  # dec_(i-1)
            if dec_fut is not None:
                collect(dec_fut)
            dec_fut = new_dec
            enc_fut = pool.submit(enc_finish, enc)
        if enc_fut is not None:  # drain: the last encode's decode
            bl, cis, px_in = wait(enc_fut)
            blobs.extend(bl)
            last = launch_decode(cis, px_in)
            for fut in (dec_fut, last):
                if fut is not None:
                    collect(fut)
    if device_verify:
        return blobs, mismatches
    return blobs, outs
