"""Haar-style lifting over fractal tile trees (numpy host implementation).

Forward (reference extract_coefficients, wavelet_transform.rs:179-225):
bottom-up over the per-tile binary tree,
    coef[p] = L - R            (missing side reads as 0)
    low[p]  = R + coef[p] / 2  (Rust truncated division)
with DC stored at index 0 (coef[0] = low[1]).

Inverse (extract_values, wavelet_transform.rs:358-381): top-down,
    R = low - coef/2 ; L = coef + R.

The Option<i32> missing-value semantics (try_apply,
wavelet_transform.rs:14-26) are carried by geometry masks: a node's
coefficient exists iff any in-bounds leaf lies under it, and a missing
side contributes 0. Values under mask-false nodes are never written to
pixels, so the vectorized inverse can compute them unmasked.

Data layout: coefficients are [..., T, N] with N = 2**depth; node p's
children occupy 2p, 2p+1 so each level is a strided slice — the lifting is
log2(N) vectorized passes with zero gathers.
"""

from __future__ import annotations

import numpy as np

from .utils import trunc_div
from .geometry import FractalGeometry


def child_masks(geo: FractalGeometry):
    """Per level l in [0, depth): (Lm, Rm) [T, 2**l] bool — presence of the
    left/right child of each node expanded at that level. Children of
    level depth-1 nodes are leaves (pixel in-bounds mask)."""
    depth = geo.depth
    inb = geo.pixel_gather >= 0
    node = geo.coef_mask  # [T, N] node presence
    out = []
    for level in range(depth):
        lo, hi = 1 << level, 1 << (level + 1)
        if level == depth - 1:
            Lm = inb[:, 0::2]
            Rm = inb[:, 1::2]
        else:
            Lm = node[:, 2 * lo : 2 * hi : 2]
            Rm = node[:, 2 * lo + 1 : 2 * hi : 2]
        out.append((Lm, Rm))
    return out


def inverse_lifting_np(coef: np.ndarray, geo: FractalGeometry) -> np.ndarray:
    """coef: [C, T, N] int. Returns pixels [C, H*W] uint8 (values clamped to
    0..255 as RasterImage::set_pixel does, images.rs:109). Mask-aware
    mirror of forward_lifting_np: single-child nodes pass the low through."""
    n = geo.nodes_per_tile
    depth = geo.depth
    coef = coef.astype(np.int64)
    C, T, _ = coef.shape
    cm = child_masks(geo)

    vals = coef[..., 0:1].copy()  # low of node 1
    for level in range(depth):
        lo, hi = 1 << level, 1 << (level + 1)
        c = coef[..., lo:hi]
        Lm, Rm = cm[level]
        both = (Lm & Rm)[None]
        right = np.where(both, vals - trunc_div(c, 2), vals)
        left = np.where(both, c + right, vals)
        nxt = np.empty((C, T, 2 * (hi - lo)), dtype=np.int64)
        nxt[..., 0::2] = left
        nxt[..., 1::2] = right
        vals = nxt

    P = geo.pixel_gather.astype(np.int64)
    inb = P >= 0
    pixels = np.zeros((C, geo.height * geo.width), dtype=np.int64)
    flat_idx = P[inb]
    for ch in range(C):
        pixels[ch, flat_idx] = vals[ch][inb]
    return np.clip(pixels, 0, 255).astype(np.uint8)
