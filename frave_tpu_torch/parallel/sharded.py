"""The sharded codec on torch.distributed: the port of
frave_tpu/parallel/sharded.py.

The JAX module runs one shard_map program over a device mesh; here every
rank of a world runs the same Python over its own shard and meets the
others in the Mesh's collectives (mesh.py):

  * ShardedEncoder — images over dp, fractal tiles over tp. Each rank
    lifts its band of tiles (kernel A over the band's rows of the
    program's leaf_pix), receives the cross-band taps it needs over one
    halo ring a shard offset (the static boundary-halo plan of the JAX
    module, ported as host numpy: the schedule re-grouped so each rank
    analyzes the symbols whose coefficient it owns; a plane all_gather
    only where the halo would not be smaller), sums its float64 Gram
    partials of the predictor fits and its histogram over tp, and then
    reshards explicitly (owner-grouped -> schedule order) for kernel C
    over its window of the lanes; the words go to the tp group's first
    rank, which compacts and packs the containers. Every rank returns all
    B containers. The fits use the one-card encode's samples (every HF
    symbol of a group, or the dense path's subsample where the one-card
    program takes it), and the value Grams of integer taps are exact in
    float64 in any order, so a container equals the one-card encode's.
  * ShardedDecoder — images over every rank (pure dp, no collective but
    the pixels' gather); the batch pads to a multiple of the ranks by
    repeating its last image.
  * TPShardedDecoder — ONE image, its lanes split over every rank. The
    grid path runs kernel 3T a row, whose only exchange is the [n, C]
    int32 renorm counts (an all_gather a row), and one values all_gather
    a wave; the step-tensor path (parallel, parity and tiny grid shapes)
    runs kernel DT a step and gathers each step's (value, need) [2, C,
    NL]. The tables, the tap planes and the inverse lifting stay
    replicated on every rank (the JAX module shards the table build and
    the lifting over tiles; on one card that buys nothing), so the
    coefficient plane needs no gather at the end: every rank runs kernel
    B on its own copy.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..codec import grid_decode as GD
from ..codec import pipeline_torch as PT
from ..codec.channel_transform import choose_transform
from ..codec.container import deserialize, serialize
from ..codec.options import EncoderOptions, quantization_matrix
from ..fractal.geometry import BASE_FRAC_DEPTH, get_geometry
from ..fractal.schedule import default_num_lanes, get_schedule, grid_row_lane
from ..images import ColorSpace, ImageMetadata, RasterImage
from ..ops import rans_torch as RT
from ..ops.lifting import dequantize_inverse_lift_pixels, forward_lift_quantize_pixels, zero_plane
from ..ops.tp_decode import table_image, tp_decode_row, tp_decode_step
from ..ops import wave_ctx as WC
from .mesh import Mesh

_I32 = torch.int32
_I64 = torch.int64


def _pad_to(x: np.ndarray, size: int, fill, axis: int = 0) -> np.ndarray:
    pad = size - x.shape[axis]
    if pad <= 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return np.concatenate([x, np.full(shape, fill, dtype=x.dtype)], axis=axis)


@dataclasses.dataclass
class EncodePlan:
    """The host plan of a dp x tp encode (ShardedEncoder.__post_init__ of
    the JAX module, bit-equal): the lane count nl (a multiple of tp), the
    rows R and symbols K, the padded tile count Tp, the nodes a tile N,
    each rank's slot range own_size; the per-symbol schedule tensors [Kp]
    in analysis order (sc, snbr [Kp, 6], svalid, slf, sgrp, sfbkt:
    owner-grouped, indices into a rank's local plane + halo, where the
    halo plan is active; else schedule order padded to Kp, indices into
    the whole plane); halo = (deltas, sizes, send_idx [tp * H_d] a delta)
    or None; inv_perm [Kp0] (schedule index -> grouped position) or None;
    order [Kp] (grouped position -> schedule index, -1 padding). Kernel C
    reads schedule order through the program's row map, so the JAX
    module's grid lay-out has no counterpart."""

    nl: int
    rows: int
    num_symbols: int
    Tp: int
    N: int
    own_size: int
    sc: np.ndarray
    snbr: np.ndarray
    svalid: np.ndarray
    slf: np.ndarray
    sgrp: np.ndarray
    sfbkt: np.ndarray
    halo: Optional[tuple]
    inv_perm: Optional[np.ndarray]
    order: np.ndarray


def encode_plan(height: int, width: int, tp: int, depth: int = BASE_FRAC_DEPTH,
                num_lanes: Optional[int] = None, mode: str = "grid") -> EncodePlan:
    """The static plan of a tp-sharded encode, as the JAX module builds it:
    tiles shard contiguously over tp; the schedule is RE-GROUPED so each
    shard analyzes exactly the symbols whose target coefficient it owns;
    remote references are then only the taps that cross a band boundary —
    a halo known statically — shipped by one ring a shard offset, unless
    the halo would not be smaller than a shard's plane."""
    h, w = height, width
    geo = get_geometry(h, w, depth)
    sched = get_schedule(h, w, depth, mode=mode)
    T_, N = geo.num_tiles, geo.nodes_per_tile
    K = sched.num_symbols
    nl = num_lanes or default_num_lanes(K)
    nl = max(nl, tp)
    nl = -(-nl // tp) * tp
    R = grid_row_lane(sched, nl)[2] if sched.cell_pos is not None else -(-K // nl)
    Kp = -(-K // nl) * nl
    Tp = -(-T_ // tp) * tp
    n_slots_pad = Tp * N

    sc = sched.sched_coef.astype(np.int32)
    snbr = sched.sched_nbr.astype(np.int32)
    svalid = _pad_to(np.ones(K, dtype=bool), Kp, False)
    sc_p = _pad_to(np.where(sc >= 0, sc, n_slots_pad), Kp, n_slots_pad)
    snbr_p = _pad_to(np.where(snbr >= 0, snbr, n_slots_pad).astype(np.int32), Kp, n_slots_pad)
    slf_p = _pad_to(sched.sched_lf.astype(bool), Kp, False)
    sgrp_p = _pad_to(sched.sched_group.astype(np.int32), Kp, 0)
    sfbkt_p = _pad_to(sched.sched_fbkt.astype(np.int32), Kp, -1)

    own_size = (Tp // tp) * N
    halo = inv_perm = None
    order = np.where(np.arange(Kp) < K, np.arange(Kp), -1)
    if tp > 1:
        refs0 = np.concatenate([sc_p[:, None], snbr_p], axis=1).astype(np.int64)
        owner_k = np.where(sc_p < n_slots_pad, sc_p // own_size, tp - 1).astype(np.int64)
        counts = np.bincount(owner_k, minlength=tp)
        Kg = int(counts.max())
        Kp2 = Kg * tp
        # grouped k-order: shard-major, original order within a shard
        korder = np.argsort(owner_k, kind="stable")
        perm_g = np.full(Kp2, -1, dtype=np.int64)
        start = 0
        for s in range(tp):
            cnt = int(counts[s])
            perm_g[s * Kg : s * Kg + cnt] = korder[start : start + cnt]
            start += cnt
        pad_g = perm_g < 0
        safe_g = np.where(pad_g, 0, perm_g)
        inv = np.empty(Kp, dtype=np.int64)
        inv[perm_g[~pad_g]] = np.nonzero(~pad_g)[0]

        refs = np.where(pad_g[:, None], n_slots_pad, refs0[safe_g])
        send: dict = {}  # delta -> per-src local slot arrays
        for s in range(tp):
            r = refs[s * Kg : (s + 1) * Kg].reshape(-1)
            r = r[r < n_slots_pad]
            remote = np.unique(r[r // own_size != s])
            owners = remote // own_size
            for o in np.unique(owners):
                delta = int((s - o) % tp)
                lst = send.setdefault(delta, [None] * tp)
                lst[int(o)] = remote[owners == o] - o * own_size
        deltas = sorted(send)
        Hs = [max(len(a) for a in send[d] if a is not None) for d in deltas]
        if int(sum(Hs)) < own_size:
            base = {}
            acc = own_size
            for d, Hd in zip(deltas, Hs):
                base[d] = acc
                acc += Hd
            zero_idx = acc  # one zero slot at the end of the local plane
            send_idx = []
            for d, Hd in zip(deltas, Hs):
                arr = np.zeros((tp, Hd), dtype=np.int32)
                for src in range(tp):
                    a = send[d][src]
                    if a is not None:
                        arr[src, : len(a)] = a
                send_idx.append(arr.reshape(-1))
            # remap grouped references to local-plane indices per shard
            remap = np.full((Kp2, 7), zero_idx, dtype=np.int64)
            for s in range(tp):
                r = refs[s * Kg : (s + 1) * Kg]
                o = r // own_size
                out = np.full(r.shape, zero_idx, dtype=np.int64)
                mine = o == s
                out[mine] = r[mine] - s * own_size
                for d in deltas:
                    src = (s - d) % tp
                    a = send[d][src]
                    if a is None or src == s:
                        continue
                    m = (o == src) & (r < n_slots_pad)
                    if not m.any():
                        continue
                    glob = a + src * own_size  # sorted
                    out[m] = base[d] + np.searchsorted(glob, r[m])
                remap[s * Kg : (s + 1) * Kg] = out
            halo = (tuple(deltas), tuple(Hs), send_idx)
            inv_perm = inv
            sc_p = remap[:, 0].astype(np.int32)
            snbr_p = remap[:, 1:].astype(np.int32)
            svalid = np.where(pad_g, False, svalid[safe_g])
            slf_p = np.where(pad_g, False, slf_p[safe_g])
            sgrp_p = np.where(pad_g, 0, sgrp_p[safe_g])
            sfbkt_p = np.where(pad_g, -1, sfbkt_p[safe_g])
            order = np.where(pad_g | (perm_g >= K), -1, perm_g)
    return EncodePlan(nl, R, K, Tp, N, own_size, sc_p, snbr_p, svalid, slf_p, sgrp_p, sfbkt_p,
                      halo, inv_perm, order)


def fit_samples(prog) -> np.ndarray:
    """[F, K] bool in schedule order: the symbols each predictor group's
    fit reads in the one-card encode of `prog` — every HF symbol of the
    group (the step-tensor statistics), or, where the program takes the
    dense shift-plane statistics, every fit_stride-th symbol of the
    group's wave in lane order."""
    K, F = prog.num_symbols, prog.num_fine
    m = np.zeros((F, K), dtype=bool)
    if prog.grid_enc is not None:
        k0 = 0
        for g, wd in enumerate(prog.waves):
            m[g, k0 + np.arange(0, wd.kw, GD.fit_stride(wd.kw))] = True
            k0 += wd.kw
        if k0 != K:
            raise AssertionError("the waves do not cover the schedule")
    else:
        for g, (lo, hi) in enumerate(prog.group_ranges):
            m[g, lo:hi] = True
    return m


@dataclasses.dataclass
class ShardedEncoder:
    """The dp x tp encode of `batch` same-shape images (batch divisible by
    the mesh's dp) on every rank of `mesh`: rank (i, s) encodes images
    [i * B/dp, (i + 1) * B/dp) with tile band s."""

    height: int
    width: int
    channels: int
    batch: int
    mesh: Mesh
    depth: int = BASE_FRAC_DEPTH
    num_lanes: Optional[int] = None
    mode: str = "grid"

    def __post_init__(self):
        mesh = self.mesh
        dp, tp, s = mesh.dp, mesh.tp, mesh.tp_index
        if self.batch % dp != 0:
            raise ValueError(f"batch {self.batch} not divisible by dp={dp}")
        if self.depth != BASE_FRAC_DEPTH:
            raise NotImplementedError(f"depth {self.depth}: the kernels take depth 9 only")
        plan = encode_plan(self.height, self.width, tp, self.depth, self.num_lanes, self.mode)
        self.plan = plan
        self.nl, self.rows, self.num_symbols = plan.nl, plan.rows, plan.num_symbols
        self.halo_enabled = plan.halo is not None
        self._halo = plan.halo
        self._inv_perm = plan.inv_perm
        dev = mesh.device
        prog = PT.get_program(self.height, self.width, plan.nl, self.channels, dev, self.mode)
        self.prog = prog

        def put(a, dt=_I64):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)

        # kernel A over this rank's tile band (padding tiles: leaf_pix -1)
        own = plan.own_size
        lp = _pad_to(prog.leaf_pix.cpu().numpy(), plan.Tp * plan.N, -1)
        self._leaf_band = put(lp[s * own:(s + 1) * own], _I32)
        # this rank's analysis slice
        Kl = plan.sc.shape[0] // tp
        sl = slice(s * Kl, (s + 1) * Kl)
        self._sc, self._snbr = put(plan.sc[sl]), put(plan.snbr[sl])
        self._svalid = put(plan.svalid[sl], torch.bool)
        # kernel W's records of this rank's symbols on its analysis plane,
        # whose last slot reads 0 (padding symbols name it everywhere)
        zero = plan.own_size + sum(plan.halo[1]) if plan.halo is not None else plan.Tp * plan.N
        self._records = WC.upload(WC.records_host(plan.sc[sl], plan.snbr[sl], plan.slf[sl],
                                                  plan.sgrp[sl], plan.sfbkt[sl], zero), zero, dev)
        self._send = ([put(a.reshape(tp, -1)[s]) for a in plan.halo[2]]
                      if plan.halo is not None else [])
        # the fit samples of each group among this rank's symbols
        fit = fit_samples(prog)
        order = plan.order[sl]
        mine = np.zeros((fit.shape[0], Kl), dtype=bool)
        mine[:, order >= 0] = fit[:, order[order >= 0]]
        self._fit_idx = [put(np.nonzero(m)[0]) for m in mine]
        # the reshard: grouped position of each schedule index
        pos = plan.inv_perm if plan.inv_perm is not None else np.arange(plan.sc.shape[0])
        self._kpos = put(pos[: plan.num_symbols])
        self._lanes = plan.nl // tp
        self._lane0 = s * self._lanes
        self._qn = np.floor(np.log2(np.arange(plan.N) + 1)).astype(np.int32)

    # ------------------------------------------------------------------
    def planes(self, pixels: torch.Tensor, qdiv: torch.Tensor, tids: torch.Tensor):
        """pixels [Bl, HW, C] uint8, qdiv [512] int32, tids [Bl] int32 on the
        device -> this rank's analysis plane [Bl * C, ...] int32: its band's
        quantized coefficients (kernel A), then the halo each ring brings
        (or, without a halo plan, every rank's band in order), then a zero
        slot."""
        mesh = self.mesh
        q = forward_lift_quantize_pixels(pixels, self._leaf_band, qdiv, tids)
        rows = q.shape[0] * q.shape[1]
        local = q[..., : self.plan.own_size].reshape(rows, self.plan.own_size)
        with mesh.phase("halo"):
            if self._halo is not None:
                parts = [local] + [mesh.ring(local[:, idx], d, "tp")
                                   for d, idx in zip(self._halo[0], self._send)]
            else:
                full = mesh.all_gather(local, "tp")  # [tp, rows, own]
                parts = [full.permute(1, 0, 2).reshape(rows, -1)]
        parts.append(local.new_zeros((rows, 1)))
        return torch.cat(parts, dim=1)

    def inputs(self, batch: np.ndarray, opts: EncoderOptions):
        """This rank's images of `batch` on the device: (pixels [Bl, HW, C]
        uint8, qdiv [512] int32, tids [Bl] int32, the transform ids as a
        list, the quantization matrix); each RGB image's transform chosen
        on the host, as the one-card encode chooses it."""
        Bl, C = self.batch // self.mesh.dp, self.channels
        local = batch[self.mesh.dp_index * Bl:(self.mesh.dp_index + 1) * Bl]
        lossless = opts.quality.name == "LOSSLESS"
        tids = ([choose_transform(im, opts.color_transform, lossless) for im in local]
                if C == 3 else [0] * Bl)
        qm = quantization_matrix(opts.quality)
        pixels, qdiv, tids_dev = PT._upload(
            (local.reshape(Bl, -1, C).astype(np.uint8), qm.astype(np.int32)[self._qn],
             np.asarray(tids, np.int32)), self.mesh.device)
        return pixels, qdiv, tids_dev, tids, qm

    def encode_batch(self, batch: np.ndarray, opts: Optional[EncoderOptions] = None) -> List[bytes]:
        """batch: [B, H, W, C] uint8 -> the B frif containers, on every rank."""
        opts = opts or EncoderOptions()
        if not isinstance(opts, EncoderOptions):
            raise TypeError("opts must be frave_tpu_torch.EncoderOptions")
        if opts.mode != self.mode:
            raise ValueError(f"encoder built for mode={self.mode!r}, opts request {opts.mode!r}")
        mesh, prog, plan = self.mesh, self.prog, self.plan
        B, C = self.batch, self.channels
        if batch.shape != (B, self.height, self.width, C):
            raise ValueError(f"batch must be {(B, self.height, self.width, C)}, got {batch.shape}")
        dev = mesh.device
        Bl = B // mesh.dp
        cs = ColorSpace.LUMA if C == 1 else ColorSpace.RGB
        pixels, qdiv, tids_dev, tids, qm = self.inputs(batch, opts)

        # analysis of this rank's symbols: taps, fits summed over tp,
        # contexts and symbols, the histogram summed over tp
        qpad = self.planes(pixels, qdiv, tids_dev)
        ovr = prog._overrides(opts.prediction_overrides(C), Bl)
        with mesh.phase("fit"):
            vparams, wparams = PT.fit_predictors(
                [qpad[:, self._snbr[i]] for i in self._fit_idx],
                [qpad[:, self._sc[i]] for i in self._fit_idx], ovr,
                reduce=lambda G, b: mesh.sum_many(G, b, axis="tp"))
        buckets, symbols = WC.wave_contexts(qpad, self._records, vparams, wparams, C)
        symbols = torch.where(self._svalid, symbols, 0).to(_I64)
        buckets = torch.where(self._svalid, buckets, 0).to(_I64)
        hist = prog.histogram(buckets, symbols, Bl, valid=self._svalid)
        with mesh.phase("hist"):
            mesh.sum(hist, "tp")
        tables = prog.tables(hist)
        bits, freqs, cdfs = tables[:3]

        # the reshard: owner-grouped -> schedule order, one gather of
        # (symbol, bucket) pairs
        with mesh.phase("reshard"):
            pairs = mesh.all_gather(symbols | (buckets << 32), "tp")  # [tp, Bl * C, Kl]
        pairs = pairs.permute(1, 0, 2).reshape(Bl * C, -1)[:, self._kpos]
        K = self.num_symbols
        sym_k = (pairs & 0xFFFFFFFF).to(_I32).reshape(Bl, C, K).contiguous()
        bkt_k = (pairs >> 32).to(_I32).reshape(Bl, C, K).contiguous()
        states, words, flags = RT.encode_scan(
            sym_k, bkt_k, prog.row_k0, prog.row_len, freqs.to(_I32), cdfs.to(_I32),
            bits.to(_I32), self.nl, lane0=self._lane0, lanes=self._lanes)

        # the words of every lane window to the tp group's first rank
        wf = (words.to(_I32) & 0xFFFF) | (flags.to(_I32) << 16)
        with mesh.phase("gather"):
            g_wf = mesh.gather(wf, "tp")  # [tp, Bl, R, C, NLl]
            g_st = mesh.gather(states, "tp")  # [tp, Bl, C, NLl]
        blobs = None
        if mesh.tp_index == 0:
            R = wf.shape[1]
            wf = g_wf.permute(1, 2, 3, 0, 4).reshape(Bl, R, C, self.nl)
            w16 = wf & 0xFFFF
            words = (w16 - ((w16 >> 15) & 1) * (1 << 16)).to(torch.int16)
            flags = ((wf >> 16) & 1).to(torch.bool)
            states = g_st.permute(1, 2, 0, 3).reshape(Bl, C, self.nl)
            packed = prog.pack(states, words, flags, tables, vparams, wparams)
            meta = ImageMetadata(height=self.height, width=self.width, colorspace=cs)
            enc = PT._EncodeBatch(prog, packed, hist.to(_I32), PT.residual_sums(hist), qm, meta,
                                  tids, pixels, PT._ready_event(dev))
            blobs = [serialize(ci) for ci in PT._encode_finish(enc, opts)]
        with mesh.phase("containers"):
            got = mesh.all_gather_object((mesh.dp_index, blobs) if blobs is not None else None)
        out: List[Optional[bytes]] = [None] * mesh.dp
        for item in got:
            if item is not None:
                out[item[0]] = item[1]
        return [b for part in out for b in part]


def _wire(im, prog, dev):
    """One container's wire fields on the device, as _decode_dispatch
    uploads them (with the batch axis of one)."""
    states, streams, bits, offpk, scales, vp, wp, qdiv, tids = PT.assemble_wire_batch(
        [im], im.num_lanes)
    return PT._upload(
        (states.astype(np.int64), streams.astype(np.int32), bits.astype(np.int64),
         offpk.astype(np.int64), scales.astype(np.int64), vp, wp, qdiv, tids), dev)


@dataclasses.dataclass
class TPShardedDecoder:
    """The decode of ONE image with its lanes split over every rank of
    `mesh` (rank r owns lanes [r * NL/n, (r + 1) * NL/n)); every rank
    returns the whole image. Grid containers with a dense lattice take
    kernel 3T a row, every other program kernel DT a step."""

    height: int
    width: int
    channels: int
    mesh: Mesh
    depth: int = BASE_FRAC_DEPTH

    def decode(self, blob: bytes) -> RasterImage:
        im = deserialize(blob)
        meta = im.metadata
        if (meta.height, meta.width, meta.num_channels) != (self.height, self.width,
                                                            self.channels):
            raise ValueError("decoder built for a different image shape")
        mesh = self.mesh
        nl, n = im.num_lanes, mesh.size
        if nl % n != 0:
            raise ValueError(f"num_lanes {nl} must divide over {n} ranks")
        dev = mesh.device
        prog = PT.get_program(self.height, self.width, nl, self.channels, dev, im.mode)
        states, stream, bits, offpk, scales, vp, wp, qdiv, tids = _wire(im, prog, dev)
        tabs = {k: v[0].contiguous() for k, v in
                GD.wire_tables(prog.lap, bits, offpk, scales).items()}
        # once a decode: the plain versions' slot -> symbol tables on the
        # CPU, the kernels' shared-memory table image on the card
        cpu = dev.type == "cpu"
        rtabs = RT._row_tables({k: v[None] for k, v in tabs.items()}) if cpu else None
        image = None if cpu else table_image(tabs)
        local = nl // n
        lo = mesh.rank * local
        x = states[0][:, lo:lo + local].contiguous()
        args = (x, stream[0], vp[0], wp[0], tabs, rtabs, image, lo, local)
        if prog.waves is not None:
            plane = self._grid(prog, *args)
        else:
            plane = self._steps(prog, *args)
        out = dequantize_inverse_lift_pixels(
            plane[None], prog.node_mask_u8, prog.leaf_mask_u8, qdiv, prog.leaf_pix,
            prog.pix_inv, tids)
        px = PT._fetch(out, PT._ready_event(dev))[0]
        return RasterImage(metadata=meta, data=px.T.reshape(self.height, self.width,
                                                            self.channels))

    def _grid(self, prog, x, stream, vparams, wparams, tabs, rtabs, image, lo, local):
        """The dense-grid decode with lanes split: per wave one kernel W
        launch (the wave's contexts on every rank, the buckets of this
        rank's lanes in kernel 3T's [rows, C, NL/n] layout), per row one
        kernel 3T launch and the [n, C] count gather, per wave one symbols
        gather and one kernel V launch (every rank stores the whole wave)."""
        mesh, C, nl, dev = self.mesh, self.channels, prog.nl, x.device
        st = {"x": x, "need": torch.zeros(x.shape, dtype=torch.bool, device=dev),
              "gptr": torch.zeros((1,), dtype=_I64, device=dev),
              "counts": torch.zeros((mesh.size, C), dtype=_I32, device=dev)}
        qplane = zero_plane(1, C, prog.n_slots, dev)[0]
        win = slice(lo, lo + local)
        for wd, k0 in zip(prog.waves, GD.wave_starts(prog.waves)):
            if wd.kw == 0:
                continue
            wave = (k0, wd.kw, nl)
            bk, preds = WC.wave_contexts(qplane, prog.records, vparams, wparams, C, wave,
                                      lanes=(lo, local))  # [1, rows, C, NL/n]
            syms = []
            for t in range(wd.rows):
                sym, cnt, st["gptr"] = tp_decode_row(
                    st["x"], st["need"], st["gptr"], st["counts"], mesh.rank, bk[0, t],
                    wd.active_rows[t, win], stream, tabs, rtabs, image)
                with mesh.phase("row"):
                    st["counts"] = mesh.all_gather(cnt, "world")  # THE per-row collective
                syms.append(sym)
            with mesh.phase("wave"):
                s_all = mesh.all_gather(torch.stack(syms, 1), "world")  # [n, C, rows, NL/n]
            WC.wave_finish(s_all.permute(0, 2, 1, 3)[:, None], preds, prog.records, wave, qplane,
                           C)
        # the last row's renorm: the final lane states
        _, _, st["gptr"] = tp_decode_row(st["x"], st["need"], st["gptr"], st["counts"],
                                         mesh.rank, None, None, stream, tabs, rtabs, image)
        self.final = (st["x"], st["gptr"])
        return qplane

    def _steps(self, prog, x, stream, vparams, wparams, tabs, rtabs, image, lo, local):
        """The step-tensor decode with lanes split: per step one kernel DT
        launch and the (value, need) [2, C, NL] gather."""
        mesh, C, nl, dev = self.mesh, self.channels, prog.nl, x.device
        steps = prog.steps
        plane = torch.zeros((C, prog.n_slots), dtype=_I32, device=dev)
        splane = torch.zeros((C, max(steps.num_symbols, 1)), dtype=_I32, device=dev)
        gptr = torch.zeros((1,), dtype=_I64, device=dev)
        gathered, prev = None, -1
        lengths = steps.step_map[:, 2].tolist()
        for t in (t for t, ln in enumerate(lengths) if ln > 0):
            out, gptr = tp_decode_step(x, gptr, steps, prev, t, gathered, lo, vparams, wparams,
                                       stream, tabs, plane, splane, rtabs, image)
            with mesh.phase("step"):
                g = mesh.all_gather(out, "world")  # [n, 2, C, NLl]
            gathered = g.permute(1, 2, 0, 3).reshape(2, C, nl).contiguous()
            prev = t
        _, gptr = tp_decode_step(x, gptr, steps, prev, -1, gathered, lo, vparams, wparams,
                                 stream, tabs, plane, splane, rtabs, image)
        self.final = (x, gptr)
        return plane


@dataclasses.dataclass
class ShardedDecoder:
    """The dp decode of same-shape containers: images over every rank of
    `mesh` (pure dp), each rank decoding its slice as one batch
    (decode_pipeline_torch_batch's kernels), the pixels gathered so every
    rank returns all of them. Quality may vary per container."""

    height: int
    width: int
    channels: int
    mesh: Mesh

    def decode_batch(self, blobs: List[bytes]) -> List[RasterImage]:
        images = [deserialize(b) for b in blobs]
        B0 = len(images)
        if B0 == 0:
            return []
        meta = images[0].metadata
        if (meta.height, meta.width, meta.num_channels) != (self.height, self.width,
                                                            self.channels):
            raise ValueError("decoder built for a different image shape")
        mesh = self.mesh
        n = mesh.size
        # pad to a multiple of the ranks (each decodes an equal slice):
        # padding repeats the last image and is dropped
        B = -(-B0 // n) * n
        padded = images + [images[-1]] * (B - B0)
        Bl = B // n
        dec = PT._decode_dispatch(padded[mesh.rank * Bl:(mesh.rank + 1) * Bl], mesh.device)
        with mesh.phase("pixels"):
            px = mesh.all_gather(dec.pixels, "world")  # [n, Bl, C, HW]
        full = PT._DecodeBatch(px.reshape((B,) + tuple(px.shape[2:])), meta,
                               PT._ready_event(mesh.device))
        return PT._decode_finish(full)[:B0]
