"""Image data model: colorspaces, metadata, raster and compressed images.

Reference: pagmerek/frave crates/libfri/src/images.rs:8-125. Pixel data is
kept as a numpy/jax array of shape [h, w, channels] (uint8) instead of the
reference's interleaved Vec<u8>; wire encodings for ColorSpace and
FractalVariant keep the same 2-bit values for container compatibility of
intent (our container is version 2 and not byte-compatible; see
frave_tpu/codec/container.py).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

import numpy as np


class ColorSpace(enum.Enum):
    """Reference images.rs:8-39 (2-bit wire encodings preserved)."""

    LUMA = 0b01
    RGB = 0b10
    YCBCR = 0b11

    @property
    def num_channels(self) -> int:
        return 1 if self is ColorSpace.LUMA else 3

    def encoding(self) -> int:
        return self.value

    @staticmethod
    def from_encoding(val: int) -> "ColorSpace":
        try:
            return ColorSpace(val)
        except ValueError:
            raise ValueError(f"invalid colorspace encoding {val!r}")


class FractalVariant(enum.Enum):
    """Reference images.rs:42-65. Only TAME_TWINDRAGON is implemented, as in
    the reference (the other variants are declared but never constructed,
    encoder.rs:96)."""

    TAME_TWINDRAGON = 0b01
    TWINDRAGON = 0b10
    BOXES = 0b11

    def encoding(self) -> int:
        return self.value

    @staticmethod
    def from_encoding(val: int) -> "FractalVariant":
        try:
            return FractalVariant(val)
        except ValueError:
            raise ValueError(f"invalid fractal variant encoding {val!r}")


@dataclasses.dataclass(frozen=True)
class ImageMetadata:
    """Reference images.rs:68-79."""

    height: int
    width: int
    colorspace: ColorSpace = ColorSpace.RGB
    variant: FractalVariant = FractalVariant.TAME_TWINDRAGON

    @property
    def num_channels(self) -> int:
        return self.colorspace.num_channels


@dataclasses.dataclass
class RasterImage:
    """A decoded image: uint8 array [h, w, channels].

    Reference images.rs:82-111 keeps interleaved bytes with bounds-checked
    get_pixel/set_pixel; here pixel access is tensor indexing and
    out-of-bounds handling lives in the geometry index tensors
    (frave_tpu/fractal/geometry.py).
    """

    metadata: ImageMetadata
    data: np.ndarray  # [h, w, c] uint8

    def __post_init__(self):
        h, w, c = (
            self.metadata.height,
            self.metadata.width,
            self.metadata.num_channels,
        )
        self.data = np.asarray(self.data, dtype=np.uint8).reshape(h, w, c)

    @staticmethod
    def from_array(arr: np.ndarray, colorspace: Optional[ColorSpace] = None) -> "RasterImage":
        arr = np.asarray(arr, dtype=np.uint8)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        h, w, c = arr.shape
        if colorspace is None:
            colorspace = ColorSpace.LUMA if c == 1 else ColorSpace.RGB
        meta = ImageMetadata(height=h, width=w, colorspace=colorspace)
        return RasterImage(metadata=meta, data=arr)


@dataclasses.dataclass
class AnsContextTables:
    """Finalized per-bucket rANS tables (reference entropy_coding.rs:31-53).

    freqs/cdf are regenerated deterministically from (max_freq_bits,
    off_distribution_values, scale_idx) on both the encode and decode side
    — only those items travel in the container (reference
    serialize.rs:93-105; scale_idx is the v9 Laplace-grid row, -1 = legacy
    per-bucket row).
    """

    max_freq_bits: int
    off_distribution_values: np.ndarray  # u16 list
    freqs: np.ndarray  # [1024] u32
    cdf: np.ndarray  # [1024] u32
    scale_idx: int = -1


@dataclasses.dataclass
class ChannelData:
    """Per-channel compressed metadata (reference images.rs:114-119).

    The entropy-coded words themselves live in the image-level global
    stream (CompressedImage.stream, decode order — see
    frave_tpu/ops/rans.py); per channel only the per-lane final states
    and the context/predictor wire fields remain.
    """

    ans_contexts: List[AnsContextTables]
    lane_states: np.ndarray  # [NL] u32 final encoder states
    value_prediction_parameters: np.ndarray  # [3, 6] f32
    width_prediction_parameters: np.ndarray  # [3, 6] f32


@dataclasses.dataclass
class CompressedImage:
    """Reference images.rs:121-124."""

    metadata: ImageMetadata
    channel_data: List[Optional[ChannelData]]
    quality: int = 0  # EncoderQuality wire value
    num_lanes: int = 0
    quantization_matrix: Optional[np.ndarray] = None  # [32] u16
    mode: str = "parallel"  # context-model mode (see EncoderOptions.mode)
    stream: Optional[np.ndarray] = None  # [W] u16 global word stream
    # channel-transform id applied before coding (format v7; see
    # codec/channel_transform.py T_* constants)
    transform: int = 0
    # transient (NOT serialized): exact expected entropy-coded payload
    # under the finalized tables, computed on device by the jax encode —
    # drives the rate-adaptive lane re-encode for flat content
    # (pipeline_jax._maybe_reencode_flat, ADVICE r4)
    est_payload_bytes: Optional[float] = None
