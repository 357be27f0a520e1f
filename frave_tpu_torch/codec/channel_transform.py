"""Channel transform choice.

The port's copy of the host half of frave_tpu/codec/channel_transform.py:
the per-image choice among the reversible transforms by a
gradient-entropy proxy. The transforms themselves run on the device
(ops/torch_ops.channel_transform and its inverse, which kernel B also
runs); the forward ones here only feed the proxy. Every transform keeps
each coding plane in [0, 255]:
  0 NONE              identity
  1 SUBGREEN          R' = (R-G) mod 256, B' = (B-G) mod 256
  2 SUBGREEN_CLAMPED  lossy-mode variant: clamped difference
  3 YCOCG             YCoCg-R lifting with mod-256 wrap on Y/Co/Cg
"""

from __future__ import annotations

import numpy as np

T_NONE = 0
T_SUBGREEN = 1
T_SUBGREEN_CLAMPED = 2
T_YCOCG = 3


def subtract_green(arr: np.ndarray) -> np.ndarray:
    """[h, w, 3] uint8 RGB -> coding planes (G-relative, mod 256)."""
    out = arr.astype(np.int32).copy()
    out[:, :, 0] = (out[:, :, 0] - out[:, :, 1]) & 255
    out[:, :, 2] = (out[:, :, 2] - out[:, :, 1]) & 255
    return out.astype(np.uint8)


def subtract_green_clamped(arr: np.ndarray) -> np.ndarray:
    """Lossy-mode variant: clamped difference instead of mod-256 — a
    quantization error in G cannot wrap R/B by 256 (error stays bounded).
    Slightly lossy itself only where |R-G| or |B-G| > 127 (clamp)."""
    out = arr.astype(np.int32).copy()
    out[:, :, 0] = np.clip(out[:, :, 0] - out[:, :, 1] + 128, 0, 255)
    out[:, :, 2] = np.clip(out[:, :, 2] - out[:, :, 1] + 128, 0, 255)
    return out.astype(np.uint8)


def _signed(x: np.ndarray) -> np.ndarray:
    """Mod-256 value -> signed representative in [-128, 127]."""
    return ((x + 128) & 255) - 128


def ycocg(arr: np.ndarray) -> np.ndarray:
    """YCoCg-R-style lifting computed entirely in Z/256: every lifting
    step wraps mod 256 and half-steps use the SIGNED REPRESENTATIVE of
    the wrapped plane, so each step is a bijection on uint8 and the whole
    transform is exactly invertible without chroma range expansion.
    Behaves identically to true YCoCg-R wherever |R-B| and |G-t| < 128
    (the common case); elsewhere it wraps like subtract-green does."""
    r = arr[:, :, 0].astype(np.int32)
    g = arr[:, :, 1].astype(np.int32)
    b = arr[:, :, 2].astype(np.int32)
    co = (r - b) & 255
    t = (b + (_signed(co) >> 1)) & 255
    cg = (g - t) & 255
    y = (t + (_signed(cg) >> 1)) & 255
    return np.stack([y, co, cg], axis=-1).astype(np.uint8)


_FORWARD = {
    T_NONE: lambda a: a,
    T_SUBGREEN: subtract_green,
    T_SUBGREEN_CLAMPED: subtract_green_clamped,
    T_YCOCG: ycocg,
}


def _proxy_stride(h: int, w: int) -> int:
    """Subsample stride for the selection proxy: images up to 512x512 use
    every pixel (stride 1 — unchanged behavior), larger ones sample a
    ~512x512 grid. The proxy only picks among 2-3 transforms whose cost
    gap on real content is large (tens of percent), so decimated gradients
    rank them identically while the host work stays O(512^2) instead of
    O(h*w) — the full-image proxy was the single largest host cost of a
    2048x2048 RGB encode (~1.7s, more than the device compute)."""
    return max(1, int(round((h * w / 262144.0) ** 0.5)))


def _proxy_cost(planes: np.ndarray) -> float:
    """Gradient-entropy proxy for coded size: sum of log2(1+|dx|)+
    log2(1+|dy|) over all planes (subsampled for large images, see
    _proxy_stride). Wrap artifacts show up as large gradients, which is
    exactly what makes them expensive to code."""
    s = _proxy_stride(planes.shape[0], planes.shape[1])
    a = planes[::s, ::s].astype(np.int32)
    dx = np.abs(np.diff(a, axis=1))
    dy = np.abs(np.diff(a, axis=0))
    return float(np.log2(1.0 + dx).sum() + np.log2(1.0 + dy).sum())


def select_transform(arr: np.ndarray, lossless: bool) -> int:
    """Adaptive per-image choice by the gradient proxy. Lossless
    candidates: NONE / SUBGREEN / YCOCG (all exactly invertible). Lossy:
    NONE / SUBGREEN_CLAMPED (mod-256 wraps amplify quantization error,
    so wrapping transforms are excluded — see round-1 regression test)."""
    if lossless:
        cands = (T_NONE, T_SUBGREEN, T_YCOCG)
    else:
        cands = (T_NONE, T_SUBGREEN_CLAMPED)
    costs = {t: _proxy_cost(_FORWARD[t](arr)) for t in cands}
    return min(costs, key=costs.get)


def choose_transform(
    arr: np.ndarray, color_transform: str, lossless: bool
) -> int:
    """Resolve an EncoderOptions.color_transform policy name to a concrete
    transform id for one RGB image WITHOUT applying it (the JAX pipeline
    applies transforms on device; the host only decides). Shared by
    forward() so every backend resolves policies identically — the id
    travels in the container's transform byte and any decoder inverts it."""
    if color_transform == "none":
        return T_NONE
    if color_transform == "auto":
        return select_transform(arr, lossless)
    if color_transform == "subtract-green":
        return T_SUBGREEN if lossless else T_SUBGREEN_CLAMPED
    if color_transform == "ycocg":
        if not lossless:
            raise ValueError("ycocg transform is lossless-only; use auto")
        return T_YCOCG
    raise ValueError(f"unknown color transform {color_transform!r}")
