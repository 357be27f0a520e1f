"""The quality presets' per-layer divisors, the forward lifting, quantize
and dequantize, and the decode a lossy preset guarantees.

NumPy only; frozen copies of the JAX package's host functions
(frave_tpu/codec/options.py `_QUANT_TABLES`, frave_tpu/ops/lifting.py
`forward_lifting_np`, `quantize_np`, `dequantize_np`), rewritten to
import nothing outside this folder.

Quantize is a truncated divide by the divisor of the coefficient's tree
layer (layer of haar index i: floor(log2(i + 1))); dequantize multiplies
back and adds the midpoint bias sign(c) * ((q - 1) // 2). The entropy
stages code the quantized plane losslessly, so a container's pixels are
fixed by its input and its preset's table: `expected_round_trip`.
"""

from __future__ import annotations

import numpy as np

from .geometry import FractalGeometry, get_geometry
from .lifting import inverse_lifting_np
from .utils import trunc_div

# EncoderQuality name -> the divisor of each tree layer
QUANT_TABLES = {
    "LOSSLESS": [1] * 32,
    "HIGH": [1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 3] + [3] * 21,
    "MEDIUM": [1, 1, 1, 1, 1, 2, 2, 3, 4, 6, 8] + [8] * 21,
    "LOW": [1, 1, 2, 2, 3, 4, 6, 8, 12, 16, 24] + [24] * 21,
}


def quantization_matrix(preset: str) -> np.ndarray:
    """The preset's 32 per-layer divisors, as a container carries them."""
    return np.asarray(QUANT_TABLES[preset], dtype=np.int32)


def forward_lifting_np(pixels: np.ndarray, geo: FractalGeometry) -> np.ndarray:
    """pixels: [C, H*W] integer array. Returns coefficients [C, T, N] int32
    (0 at mask-false slots). Where exactly one child is present the
    difference is coded as 0 and the low passes the present value
    through; the inverse (lifting.inverse_lifting_np) mirrors the choice."""
    n = geo.nodes_per_tile
    depth = geo.depth
    P = geo.pixel_gather.astype(np.int64)  # [T, N]
    inb = P >= 0
    leaves = np.where(inb[None], pixels[:, np.clip(P, 0, None)], 0).astype(np.int64)

    C = pixels.shape[0]
    T = geo.num_tiles
    coef = np.zeros((C, T, n), dtype=np.int64)

    vals = leaves  # children values of the current level
    mask = np.broadcast_to(inb[None], leaves.shape)
    for level in range(depth - 1, -1, -1):
        lo, hi = 1 << level, 1 << (level + 1)
        L = vals[..., 0::2]
        R = vals[..., 1::2]
        Lm = mask[..., 0::2]
        Rm = mask[..., 1::2]
        l0 = np.where(Lm, L, 0)
        r0 = np.where(Rm, R, 0)
        both = Lm & Rm
        c = np.where(both, l0 - r0, 0)
        low = np.where(both, r0 + trunc_div(c, 2), l0 + r0)
        coef[..., lo:hi] = c
        vals = low
        mask = Lm | Rm
    coef[..., 0] = np.where(mask[..., 0], vals[..., 0], 0)
    return coef.astype(np.int32)


def _layer_divisors(qmatrix: np.ndarray, geo: FractalGeometry) -> np.ndarray:
    """[N] the divisor of each haar index's layer, floor(log2(i + 1))."""
    n = geo.nodes_per_tile
    layers = np.floor(np.log2(np.arange(n, dtype=np.float64) + 1)).astype(np.int64)
    return np.asarray(qmatrix).astype(np.int64)[layers]


def quantize_np(coef: np.ndarray, qmatrix: np.ndarray, geo: FractalGeometry) -> np.ndarray:
    """Per-tree-layer truncated divide."""
    q = _layer_divisors(qmatrix, geo)
    return trunc_div(coef.astype(np.int64), q[None, None, :]).astype(np.int32)


def dequantize_np(coef: np.ndarray, qmatrix: np.ndarray, geo: FractalGeometry) -> np.ndarray:
    """Multiply back with the midpoint bias toward the bin's centre; the
    identity where the divisor is 1, so lossless containers pass through."""
    q = _layer_divisors(qmatrix, geo)[None, None, :]
    c = coef.astype(np.int64)
    bias = np.sign(c) * ((q - 1) // 2)
    return (c * q + bias).astype(np.int32)


def expected_round_trip(pixels: np.ndarray, preset: str) -> np.ndarray:
    """The decode that `preset` guarantees for [h, w, c] uint8 pixels coded
    without a channel transform (every gray image):
    clip(inverse_lift(dequantize(quantize(forward_lift(pixels))))), [h, w, c]
    uint8. LOSSLESS gives the pixels back."""
    h, w, c = pixels.shape
    geo = get_geometry(h, w)
    qm = quantization_matrix(preset)
    planes = np.asarray(pixels, dtype=np.int64).reshape(h * w, c).T  # [C, H*W]
    q = quantize_np(forward_lifting_np(planes, geo), qm, geo)
    out = inverse_lifting_np(dequantize_np(q, qm, geo), geo)  # [C, H*W] uint8, clipped
    return out.T.reshape(h, w, c)
