"""The plain reference decoder for a container of any quality preset:
a frif container's bytes -> pixels, the coefficient plane dequantized
by the container's own matrix before the inverse lifting.

NumPy only, importing nothing outside this folder. The wave loop is a
copy of decode.py's, which refuses every lossy container: the benchmark
grows by new files only, so the loop is repeated here rather than given
a dequantize step there. A later change to the benchmark itself may fold
the two into one decoder. A lossless container's matrix is all ones, for
which the dequantize is the identity, so this decodes those as decode.py
does. Grid mode, format v9, as decode.py.

`ctx_dtype` sets the precision of the learned contexts. The format states
float32; float16 is the benchmark's control, the lower precision that
has to decode the same containers wrongly.
"""

from __future__ import annotations

import numpy as np

from .channel_transform import inverse as channel_inverse
from .container import deserialize, ensure_tables
from .geometry import get_geometry
from .images import RasterImage
from .lifting import inverse_lifting_np
from .prediction import contexts_np, gather_neighbour_values
from .quantization import dequantize_np
from .rans import StreamDecoder
from .schedule import get_lane_steps, get_schedule
from .utils import unpack_signed


def decode(blob: bytes, ctx_dtype=np.float32) -> np.ndarray:
    """Decode container bytes into [h, w, c] uint8 pixels."""
    image = deserialize(blob)
    qm = np.asarray(image.quantization_matrix, dtype=np.int64)
    meta = image.metadata
    geo = get_geometry(meta.height, meta.width)
    sched = get_schedule(meta.height, meta.width, mode=image.mode)
    steps = get_lane_steps(meta.height, meta.width, image.num_lanes, mode=image.mode)
    C = meta.num_channels

    qflat = np.zeros((C, geo.num_coef_slots), dtype=np.int64)
    vparams, wparams = [], []
    all_freqs, all_cdfs, all_bits, all_states = [], [], [], []
    for ch in range(C):
        cd = image.channel_data[ch]
        ensure_tables(cd.ans_contexts)
        all_freqs.append(np.stack([c.freqs for c in cd.ans_contexts]))
        all_cdfs.append(np.stack([c.cdf for c in cd.ans_contexts]))
        all_bits.append(np.asarray([c.max_freq_bits for c in cd.ans_contexts], dtype=np.int32))
        all_states.append(np.asarray(cd.lane_states, dtype=np.uint32))
        vparams.append(sched.expand_params(cd.value_prediction_parameters))
        wparams.append(sched.expand_params(cd.width_prediction_parameters))
    decoder = StreamDecoder(
        np.stack(all_states), np.asarray(image.stream, dtype=np.uint16),
        np.stack(all_freqs), np.stack(all_cdfs), np.stack(all_bits),
    )

    # Wave by wave: a symbol's context taps only read symbols of earlier
    # waves, so each wave's contexts are one call a channel; the rANS
    # state machine then advances step by step in the stream's (step,
    # channel, lane) word order. The contexts read the quantized values.
    wave_of = steps.step_wave.astype(np.int64)
    wstart = np.concatenate([[0], np.cumsum(sched.wave_sizes.astype(np.int64))])
    s = 0
    with np.errstate(over="ignore", invalid="ignore"):
        while s < steps.num_steps:
            wv = int(wave_of[s])
            s1 = s
            while s1 < steps.num_steps and int(wave_of[s1]) == wv:
                s1 += 1
            k0, k1 = int(wstart[wv]), int(wstart[wv + 1])
            nbr_w = sched.sched_nbr[k0:k1].astype(np.int64)
            lf_w = sched.sched_lf[k0:k1]
            grp_w = sched.sched_group[k0:k1].astype(np.int64)
            fb_w = sched.sched_fbkt[k0:k1].astype(np.int64)
            coef_w = sched.sched_coef[k0:k1].astype(np.int64)
            bks, prs = [], []
            for ch in range(C):
                vals = gather_neighbour_values(qflat[ch], nbr_w)
                buckets, preds = contexts_np(vals, lf_w, grp_w, vparams[ch], wparams[ch],
                                             dtype=ctx_dtype)
                bks.append(np.where(fb_w >= 0, fb_w, buckets.astype(np.int64)))
                prs.append(preds.astype(np.int64))
            for srow in range(s, s1):
                slots = steps.step_slot[srow].astype(np.int64)  # [NL] k | -1
                active = slots >= 0
                ks = np.where(active, slots - k0, 0)
                for ch in range(C):
                    bk = np.where(active, bks[ch][ks], -1)
                    syms = decoder.decode_step(ch, bk)
                    values = unpack_signed(syms) + prs[ch][ks]
                    qflat[ch][coef_w[ks[active]]] = values[active]
            s = s1

    qcoef = qflat.reshape(C, geo.num_tiles, geo.nodes_per_tile)
    pixels = inverse_lifting_np(dequantize_np(qcoef, qm, geo), geo)  # [C, H*W] uint8
    data = pixels.T.reshape(meta.height, meta.width, C)
    out = channel_inverse(RasterImage(metadata=meta, data=data), image.transform)
    return np.asarray(out.data, dtype=np.uint8).reshape(meta.height, meta.width, C)
