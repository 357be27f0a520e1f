"""Encoder options and quality presets.

The port's copy of frave_tpu/codec/options.py, with the fields the port
reads: each preset selects a per-tree-layer quantization table, LOSSLESS
the all-ones table that guarantees bit-exact round trips. The JAX
package's `backend`, `emit_coefficients` and `verbose` are left out: the
port is the backend and has no metrics sink.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np


class EncoderQuality(enum.Enum):
    LOW = 0
    MEDIUM = 1
    HIGH = 2
    LOSSLESS = 3


# Per-tree-layer divisors, layer = floor(log2(haar_index + 1)) in [0, 10]
# for depth 9 (quantization.rs:16); padded to 32 entries like the
# reference's matrix. Coarse layers (DC, root) stay exact; fine layers
# (leaf differences) quantize harder at lower quality.
_QUANT_TABLES = {
    EncoderQuality.LOSSLESS: [1] * 32,
    EncoderQuality.HIGH: [1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 3] + [3] * 21,
    EncoderQuality.MEDIUM: [1, 1, 1, 1, 1, 2, 2, 3, 4, 6, 8] + [8] * 21,
    EncoderQuality.LOW: [1, 1, 2, 2, 3, 4, 6, 8, 12, 16, 24] + [24] * 21,
}


def quantization_matrix(quality: EncoderQuality) -> np.ndarray:
    return np.asarray(_QUANT_TABLES[quality], dtype=np.int32)


@dataclasses.dataclass
class EncoderOptions:
    """What an encode does (frave_tpu.codec.options.EncoderOptions less
    the fields above).

    num_lanes: interleaved rANS lanes; None picks
    schedule.default_num_lanes (then the rate-adaptive re-encode).
    mode: the context-model mode: "grid" (the default), "parallel" (the
    JAX package's default schedule) or "parity" (the reference codec's
    causal context model).
    color_transform: RGB coding transform (codec/channel_transform.py):
    "auto" (the cheapest by a gradient proxy), "none", "subtract-green",
    "ycocg" (lossless only) or "trial" (encode every candidate, keep the
    smallest container).
    value_prediction_params / width_prediction_params: pinned predictor
    parameters, [n, 6] or [C, n, 6] f32 with n = 3 (legacy coarse groups)
    or the schedule's num_fine; the in-encoder fit is skipped and these
    travel on the wire as f16 (rounded accordingly before use).
    """

    quality: EncoderQuality = EncoderQuality.LOSSLESS
    num_lanes: Optional[int] = None
    mode: str = "grid"
    color_transform: str = "auto"
    value_prediction_params: Optional[np.ndarray] = None
    width_prediction_params: Optional[np.ndarray] = None

    def prediction_overrides(self, channels: int):
        """Normalized ([C,n,6] f32 vp, wp, use_flag) for the pipelines.
        Both-or-neither: a value override without a width override keeps
        the width fit (widths only shape rate, never correctness)."""
        if self.value_prediction_params is None:
            return None

        vref = np.asarray(self.value_prediction_params)
        nrows = vref.shape[-2]

        def norm(p):
            if p is None:
                return np.zeros((channels, nrows, 6), dtype=np.float32)
            a = np.asarray(p, dtype=np.float32)
            if a.shape == (nrows, 6):
                a = np.broadcast_to(a, (channels, nrows, 6))
            if a.shape != (channels, nrows, 6):
                raise ValueError(
                    f"prediction params must be [{nrows},6] or "
                    f"[{channels},{nrows},6]"
                )
            return np.ascontiguousarray(a)

        return norm(self.value_prediction_params), norm(
            self.width_prediction_params
        ), self.width_prediction_params is not None
