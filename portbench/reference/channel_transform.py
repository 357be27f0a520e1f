"""Channel transform stage.

Reference: crates/libfri/src/stages/channel_transform.rs:3-10 — an identity
placeholder with RGB->YCbCr left as a TODO. Here the stage is functional
and ADAPTIVE (format v7): each image carries an explicit transform id and
the encoder picks the cheapest candidate by a gradient-entropy proxy.

Transforms (all keep every coding plane in [0, 255], so the shared
1024-symbol residual alphabet still covers all residuals):
  0 NONE              identity
  1 SUBGREEN          R' = (R-G) mod 256, B' = (B-G) mod 256 (WebP-style)
  2 SUBGREEN_CLAMPED  lossy-mode variant: clamped difference (a
                      quantization error in G cannot wrap R/B by 256)
  3 YCOCG             YCoCg-R lifting with mod-256 wrap on Y/Co/Cg —
                      exactly invertible, usually decorrelates better
                      than subtract-green

The mod-256 wrap trick sidesteps the chroma range expansion that a plain
reversible YCbCr would need (+-255 chroma -> per-channel alphabet); the
cost is that content with saturated chroma steps can wrap, inflating
gradients — exactly what the adaptive proxy detects, falling back to
NONE/SUBGREEN per image.
"""

from __future__ import annotations

import numpy as np

from .images import RasterImage

T_NONE = 0
T_SUBGREEN = 1
T_SUBGREEN_CLAMPED = 2
T_YCOCG = 3


def add_green(arr: np.ndarray) -> np.ndarray:
    """Inverse of subtract_green."""
    out = arr.astype(np.int32).copy()
    out[:, :, 0] = (out[:, :, 0] + out[:, :, 1]) & 255
    out[:, :, 2] = (out[:, :, 2] + out[:, :, 1]) & 255
    return out.astype(np.uint8)


def add_green_clamped(arr: np.ndarray) -> np.ndarray:
    """Inverse of subtract_green_clamped (up to its clamp)."""
    out = arr.astype(np.int32).copy()
    out[:, :, 0] = np.clip(out[:, :, 0] + out[:, :, 1] - 128, 0, 255)
    out[:, :, 2] = np.clip(out[:, :, 2] + out[:, :, 1] - 128, 0, 255)
    return out.astype(np.uint8)


def _signed(x: np.ndarray) -> np.ndarray:
    """Mod-256 value -> signed representative in [-128, 127]."""
    return ((x + 128) & 255) - 128


def ycocg_inverse(arr: np.ndarray) -> np.ndarray:
    """Exact inverse of ycocg: lifting steps reversed in Z/256."""
    y = arr[:, :, 0].astype(np.int32)
    co = arr[:, :, 1].astype(np.int32)
    cg = arr[:, :, 2].astype(np.int32)
    t = (y - (_signed(cg) >> 1)) & 255
    g = (cg + t) & 255
    b = (t - (_signed(co) >> 1)) & 255
    r = (co + b) & 255
    return np.stack([r, g, b], axis=-1).astype(np.uint8)


_INVERSE = {
    T_NONE: lambda a: a,
    T_SUBGREEN: add_green,
    T_SUBGREEN_CLAMPED: add_green_clamped,
    T_YCOCG: ycocg_inverse,
}


def inverse(image: RasterImage, transform: int) -> RasterImage:
    """Decode-side inverse selected by the container's transform byte."""
    if transform == T_NONE:
        return image
    fn = _INVERSE.get(int(transform))
    if fn is None:
        raise ValueError(f"unknown channel transform id {transform}")
    return RasterImage(metadata=image.metadata, data=fn(image.data))
