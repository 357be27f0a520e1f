"""`frif` v2 container: host-side bitstream mux/demux.

Byte-level redesign of the reference's frif format (serialize.rs:40-115):
same structure — magic, metadata word, then per channel a PRD predictor
segment, 10 EHD context headers (frequency tables are *not* serialized;
the decoder regenerates them from (max_freq_bits, off-list), mirroring
serialize.rs:230-236), a DAT payload and an EOC, finally EOI — but the DAT
payload carries NL interleaved-lane rANS streams (per-lane final state +
word counts + u16 words) instead of one opaque `rans`-crate blob, and the
header additionally records version, quality, lane count and the
quantization matrix (the reference hardcodes its all-ones matrix,
quantization.rs:3-5).

Everything here is plain host bytes — the entropy-coded payload never
needs device residency (SURVEY.md section 5, communication backend note).
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np

from .images import (
    ChannelData,
    ColorSpace,
    CompressedImage,
    FractalVariant,
    ImageMetadata,
    AnsContextTables,
)
from .tables import (
    ALPHABET_SIZE,
    CONTEXT_AMOUNT,
    NUM_SCALES,
    context_from_wire,
)

MAGIC = b"frif"
# v9: a channel-transform byte in the header; the PRD carries per-segment
#     predictor fits (an n_fits byte, then [n, 6] f16 value and width
#     rows, one row a schedule segment); each EHD carries a Laplace-grid
#     scale byte after max_freq_bits.
VERSION = 9  # the only version read here: what the program writes
_MAX_TRANSFORM = 3  # codec/channel_transform.py T_* ids
_MODES = ("parallel", "parity", "grid")  # wire encodings 0, 1, 2
MARKER_PRD = 0xFFBB
MARKER_EHD = 0xFFB2
MARKER_STT = 0xFFB5  # per-channel lane states
MARKER_SDT = 0xFFB6  # image-level global word stream
MARKER_EOC = 0xFFB8
MARKER_EOI = 0xFFDF


class SerializeError(ValueError):
    """Parse failures (reference serialize.rs:12-37)."""


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise SerializeError("unexpected end of stream")
        b = self.data[self.pos : self.pos + n]
        self.pos += n
        return b

    def u8(self) -> int:
        return self.take(1)[0]

    def u16(self) -> int:
        return struct.unpack("<H", self.take(2))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]


def ensure_tables(contexts) -> None:
    """Regenerate freq/cdf tables in place for host-side decoders
    (reference decode-side finalize_context, serialize.rs:230-236)."""
    for bucket, ctx in enumerate(contexts):
        if ctx.freqs is None:
            tab = context_from_wire(
                bucket, int(ctx.max_freq_bits), np.asarray(
                    ctx.off_distribution_values, dtype=np.int64
                ).tolist(),
                scale_idx=int(getattr(ctx, "scale_idx", -1)),
            )
            ctx.freqs = tab.freqs
            ctx.cdf = tab.cdf


def deserialize(data: bytes) -> CompressedImage:
    r = _Reader(data)
    if r.take(4) != MAGIC:
        raise SerializeError("bad magic")
    version = r.u8()
    if version != VERSION:
        raise SerializeError(f"unsupported container version {version}")
    height = r.u32()
    width = r.u32()
    mdat = r.u8()
    colorspace = ColorSpace.from_encoding(mdat >> 4)
    variant = FractalVariant.from_encoding(mdat & 0xF)
    quality = r.u8()
    mode_enc = r.u8()
    if mode_enc >= len(_MODES):
        raise SerializeError(f"invalid context-model mode {mode_enc}")
    mode = _MODES[mode_enc]
    if mode != "grid":
        raise SerializeError(f"the reference decodes grid mode only, not {mode!r}")
    nl = r.u16()
    if nl < 1:
        raise SerializeError("lane count must be >= 1")
    transform = r.u8()
    if transform > _MAX_TRANSFORM:
        raise SerializeError(f"unknown channel transform id {transform}")
    qm = np.frombuffer(r.take(64), dtype="<u2").astype(np.int32)
    meta = ImageMetadata(height=height, width=width, colorspace=colorspace, variant=variant)

    channel_data: List[ChannelData] = []
    for ch in range(meta.num_channels):
        if r.u16() != MARKER_PRD:
            raise SerializeError("expected PRD segment")
        nfit = r.u8()
        if nfit < 1:
            raise SerializeError("PRD must carry at least one fit")
        vp = np.frombuffer(r.take(nfit * 6 * 2), dtype="<f2").reshape(nfit, 6).astype(np.float32)
        wp = np.frombuffer(r.take(nfit * 6 * 2), dtype="<f2").reshape(nfit, 6).astype(np.float32)
        # NaN/inf params would poison every prediction downstream
        if not (np.isfinite(vp).all() and np.isfinite(wp).all()):
            raise SerializeError("non-finite predictor parameters")

        contexts = []
        for _ in range(CONTEXT_AMOUNT):
            if r.u16() != MARKER_EHD:
                raise SerializeError("expected EHD segment")
            bits = r.u8()
            scale = r.u8()
            if scale >= NUM_SCALES:
                raise SerializeError(f"Laplace scale index {scale} outside the grid")
            off_len = r.u32()
            off = np.frombuffer(r.take(2 * off_len), dtype="<u2")
            if off.size and int(off.max()) >= ALPHABET_SIZE:
                raise SerializeError(
                    "off-distribution value outside the symbol alphabet"
                )
            # freqs/cdf are regenerated lazily by the decoder backends
            # (ensure_tables below / on-device twin) — deserialization
            # stays cheap.
            contexts.append(
                AnsContextTables(
                    max_freq_bits=bits,
                    off_distribution_values=off.copy(),
                    freqs=None,
                    cdf=None,
                    scale_idx=scale,
                )
            )

        if r.u16() != MARKER_STT:
            raise SerializeError("expected STT segment")
        state_width = r.u8()
        if state_width == 2:
            states = np.frombuffer(r.take(2 * nl), dtype="<u2").astype(
                np.uint32
            ) + (1 << 16)
        elif state_width == 4:
            states = np.frombuffer(r.take(4 * nl), dtype="<u4").astype(
                np.uint32
            )
        else:
            raise SerializeError(f"invalid lane-state width {state_width}")
        if r.u16() != MARKER_EOC:
            raise SerializeError("expected EOC")
        channel_data.append(
            ChannelData(
                ans_contexts=contexts,
                lane_states=states,
                value_prediction_parameters=vp,
                width_prediction_parameters=wp,
            )
        )

    if r.u16() != MARKER_SDT:
        raise SerializeError("expected SDT segment")
    total = r.u32()
    stream = np.frombuffer(r.take(2 * total), dtype="<u2").copy()
    if r.u16() != MARKER_EOI:
        raise SerializeError("expected EOI")
    return CompressedImage(
        metadata=meta,
        channel_data=list(channel_data) + [None] * (3 - len(channel_data)),
        quality=quality,
        num_lanes=nl,
        quantization_matrix=qm,
        mode=mode,
        stream=stream,
        transform=transform,
    )
