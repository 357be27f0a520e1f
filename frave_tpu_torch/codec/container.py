"""`frif` container: host-side bitstream mux/demux.

The port's copy of frave_tpu/codec/container.py (versions 7-9 read,
version 9 written), less ensure_tables: the port regenerates the
frequency tables on the device. Magic, metadata word, then per channel a
PRD predictor segment, one EHD context header per bucket (the frequency
tables are not serialized; decoders regenerate them from the bits,
off-list and scale index), the lane states and an EOC; then the global
word stream and EOI.
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np

from ..images import (
    ChannelData,
    ColorSpace,
    CompressedImage,
    FractalVariant,
    ImageMetadata,
    AnsContextTables,
)
from ..entropy.tables import ALPHABET_SIZE, CONTEXT_AMOUNT, NUM_SCALES

MAGIC = b"frif"
# v7: explicit per-image channel-transform byte
# v8: PRD carries per-level predictor fits — an n_fits byte followed by
#     [n, 6] f16 value + width parameter rows (one row per contiguous
#     schedule segment, schedule.WavefrontSchedule.sched_group), replacing
#     v7's fixed [3, 6] f32 coarse groups. v7 containers still decode:
#     their 3 rows are expanded via schedule.legacy_of_fine.
# v9: each EHD carries a Laplace-grid scale byte after max_freq_bits —
#     the per-image scale the encoder selected for that context
#     (entropy/tables.py GRID_WIDTHS; rows 0..CONTEXT_AMOUNT-1 are the
#     legacy per-bucket scales, which is what v7/v8 decode falls back to).
VERSION = 9
_MIN_VERSION = 7
_MAX_TRANSFORM = 3  # codec/channel_transform.py T_* ids
_MODES = ("parallel", "parity", "grid")  # wire encodings 0, 1, 2
MARKER_PRD = 0xFFBB
MARKER_EHD = 0xFFB2
MARKER_STT = 0xFFB5  # per-channel lane states
MARKER_SDT = 0xFFB6  # image-level global word stream
MARKER_EOC = 0xFFB8
MARKER_EOI = 0xFFDF


class SerializeError(ValueError):
    """Parse failures."""


def serialize(image: CompressedImage) -> bytes:
    meta = image.metadata
    out = bytearray()
    out += MAGIC
    out += struct.pack("<B", VERSION)
    out += struct.pack("<II", meta.height, meta.width)
    mdat = (meta.colorspace.encoding() << 4) | meta.variant.encoding()
    out += struct.pack("<B", mdat)
    out += struct.pack("<B", image.quality)
    out += struct.pack("<B", _MODES.index(image.mode))
    out += struct.pack("<H", image.num_lanes)
    out += struct.pack("<B", image.transform)
    qm = np.asarray(image.quantization_matrix, dtype=np.uint16)
    assert qm.shape == (32,)
    out += qm.astype("<u2").tobytes()

    for ch in range(meta.num_channels):
        cd = image.channel_data[ch]
        if cd is None:
            raise SerializeError(f"missing channel {ch}")
        out += struct.pack("<H", MARKER_PRD)
        vp = np.asarray(cd.value_prediction_parameters, dtype="<f2")
        wp = np.asarray(cd.width_prediction_parameters, dtype="<f2")
        assert vp.ndim == 2 and vp.shape[1] == 6 and vp.shape == wp.shape
        assert vp.shape[0] <= 255
        out += struct.pack("<B", vp.shape[0])
        out += vp.tobytes() + wp.tobytes()

        for bucket, ctx in enumerate(cd.ans_contexts):
            out += struct.pack("<H", MARKER_EHD)
            out += struct.pack("<B", ctx.max_freq_bits)
            scale = int(getattr(ctx, "scale_idx", -1))
            out += struct.pack("<B", bucket if scale < 0 else scale)
            off = np.asarray(ctx.off_distribution_values, dtype="<u2")
            out += struct.pack("<I", off.shape[0])
            out += off.tobytes()

        out += struct.pack("<H", MARKER_STT)
        nl = image.num_lanes
        states = np.asarray(cd.lane_states, dtype=np.uint32)
        assert states.shape == (nl,)
        # compact state width (v7): rANS states live in [2^16, 2^32); on
        # cheap content they stay below 2^17 (each lane's state grows by
        # its lanes' total information), so (state - 2^16) fits u16 —
        # halves the dominant overhead of flat images. Width byte: 2 or 4.
        if states.size and int(states.max()) < (1 << 17) and int(states.min()) >= (1 << 16):
            out += struct.pack("<B", 2)
            out += (states - (1 << 16)).astype("<u2").tobytes()
        else:
            out += struct.pack("<B", 4)
            out += states.astype("<u4").tobytes()
        out += struct.pack("<H", MARKER_EOC)

    stream = np.asarray(
        image.stream if image.stream is not None else [], dtype="<u2"
    )
    out += struct.pack("<H", MARKER_SDT)
    out += struct.pack("<I", stream.shape[0])
    out += stream.tobytes()
    out += struct.pack("<H", MARKER_EOI)
    return bytes(out)


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


def deserialize(data: bytes) -> CompressedImage:
    r = _Reader(data)
    if r.take(4) != MAGIC:
        raise SerializeError("bad magic")
    version = r.u8()
    if not (_MIN_VERSION <= version <= VERSION):
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
        if version >= 8:
            nfit = r.u8()
            if nfit < 1:
                raise SerializeError("PRD must carry at least one fit")
            vp = (
                np.frombuffer(r.take(nfit * 6 * 2), dtype="<f2")
                .reshape(nfit, 6)
                .astype(np.float32)
            )
            wp = (
                np.frombuffer(r.take(nfit * 6 * 2), dtype="<f2")
                .reshape(nfit, 6)
                .astype(np.float32)
            )
            # NaN/inf params would poison every prediction downstream
            if not (np.isfinite(vp).all() and np.isfinite(wp).all()):
                raise SerializeError("non-finite predictor parameters")
        else:  # v7: fixed 3 coarse groups, f32; expanded by the decoders
            vp = (
                np.frombuffer(r.take(3 * 6 * 4), dtype="<f4")
                .reshape(3, 6)
                .copy()
            )
            wp = (
                np.frombuffer(r.take(3 * 6 * 4), dtype="<f4")
                .reshape(3, 6)
                .copy()
            )

        contexts = []
        for bucket in range(CONTEXT_AMOUNT):
            if r.u16() != MARKER_EHD:
                raise SerializeError("expected EHD segment")
            bits = r.u8()
            if version >= 9:
                scale = r.u8()
                if scale >= NUM_SCALES:
                    raise SerializeError(
                        f"Laplace scale index {scale} outside the grid"
                    )
            else:
                scale = bucket  # legacy per-bucket row
            off_len = r.u32()
            off = np.frombuffer(r.take(2 * off_len), dtype="<u2")
            if off.size and int(off.max()) >= ALPHABET_SIZE:
                raise SerializeError(
                    "off-distribution value outside the symbol alphabet"
                )
            # freqs/cdf are regenerated on the device by the decoder
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
