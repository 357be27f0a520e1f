"""Channel transform choice.

The port's copy of the host half of frave_tpu/codec/channel_transform.py:
the per-image choice among the reversible transforms by a
gradient-entropy proxy, computed from integer counts of the
gradients (select_transform). The transforms themselves run on the device
(ops/torch_ops.channel_transform and its inverse, which kernel B also
runs); the forward ones here only feed the proxy. Every transform keeps
each coding plane in [0, 255]:
  0 NONE              identity
  1 SUBGREEN          R' = (R-G) mod 256, B' = (B-G) mod 256
  2 SUBGREEN_CLAMPED  lossy-mode variant: clamped difference
  3 YCOCG             YCoCg-R lifting with mod-256 wrap on Y/Co/Cg
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..profiling import annotate

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


# log2(1 + k) for every |gradient| k that a uint8 plane can hold
_LOG2_1P = np.log2(1.0 + np.arange(256, dtype=np.float64))

# select_transform calls that the counted costs left to the exact proxy
# (a near or exact tie); each also opens a frave.encode.transform.exact span
exact_fallbacks = 0
_fallbacks_lock = threading.Lock()


def _proxy_choice(arr: np.ndarray, cands) -> int:
    """The choice by the exact proxy: the first of `cands` (in order) with
    the least _proxy_cost."""
    costs = {t: _proxy_cost(_FORWARD[t](arr)) for t in cands}
    return min(costs, key=costs.get)


def _candidate_planes(arr: np.ndarray, lossless: bool):
    """Every distinct coding plane of the candidates, built once in uint8
    on the proxy's subsample arr[::s, ::s] -> ([n, h', w'] uint8, {id:
    indices of its three planes}). Each plane equals the matching channel
    of _FORWARD[t](arr)[::s, ::s]: the mod-256 wraps are uint8's own, and
    the YCoCg half-steps shift the int8 view (the signed representative).
    Lossless: R, G, B, R-G, B-G, Y, Co, Cg (NONE and SUBGREEN share G);
    lossy: R, G, B and the two clamped differences."""
    s = _proxy_stride(arr.shape[0], arr.shape[1])
    sub = arr[::s, ::s]
    n = 8 if lossless else 5
    p = np.empty((n,) + sub.shape[:2], np.uint8)
    p[:3] = sub.transpose(2, 0, 1)
    r, g, b = p[0], p[1], p[2]
    if not lossless:
        p[3] = np.clip(r.astype(np.int16) - g + 128, 0, 255)
        p[4] = np.clip(b.astype(np.int16) - g + 128, 0, 255)
        return p, {T_NONE: (0, 1, 2), T_SUBGREEN_CLAMPED: (3, 1, 4)}
    np.subtract(r, g, out=p[3])
    np.subtract(b, g, out=p[4])
    y, co, cg = p[5], p[6], p[7]
    np.subtract(r, b, out=co)
    t = b + (co.view(np.int8) >> 1).view(np.uint8)
    np.subtract(g, t, out=cg)
    np.add(t, (cg.view(np.int8) >> 1).view(np.uint8), out=y)
    return p, {T_NONE: (0, 1, 2), T_SUBGREEN: (3, 1, 4), T_YCOCG: (5, 6, 7)}


def _gradient_counts(planes: np.ndarray) -> np.ndarray:
    """[n, h, w] uint8 -> [n, 256] int64: each plane's counts of |dx| and
    |dy|, each |d| taken as max - min in uint8 (no plane is widened)."""
    t = torch.from_numpy(planes)
    a, b = t[:, :, 1:], t[:, :, :-1]
    dx = torch.maximum(a, b).sub_(torch.minimum(a, b))
    a, b = t[:, 1:], t[:, :-1]
    dy = torch.maximum(a, b).sub_(torch.minimum(a, b))
    return np.stack([
        (torch.bincount(dx[i].reshape(-1), minlength=256)
         + torch.bincount(dy[i].reshape(-1), minlength=256)).numpy()
        for i in range(len(planes))
    ])


def _counted_costs(arr: np.ndarray, lossless: bool):
    """Each candidate's proxy cost from integer counts -> ({id: cost}, N):
    the candidate's summed counts of |d| = k dotted in float64 with
    log2(1 + k); N is the number of gradients a candidate's cost sums."""
    planes, cands = _candidate_planes(arr, lossless)
    counts = _gradient_counts(planes)
    costs = {t: float(counts[list(ix)].sum(axis=0).astype(np.float64) @ _LOG2_1P)
             for t, ix in cands.items()}
    _, h, w = planes.shape
    return costs, 3 * (h * (w - 1) + (h - 1) * w)


def _tie_bound(n_terms: int) -> float:
    """Relative bound under which two counted costs may order differently
    from _proxy_cost's: 4 (N + 512) u, u = 2^-53, of the larger cost.

    Let C be a candidate's exact real sum of its N terms log2(1 + |d|) >= 0.
    _proxy_cost takes each term from np.log2 (within 4 ulps: 8u relative),
    sums the dx and the dy terms in float64 in whatever order NumPy takes
    (any order of non-negative terms: at most (n - 1)u of the sum, to first
    order) and adds the two: |P - C| <= (N + 9)u C. The counted cost rounds
    each table entry (8u), multiplies it by an exact integer count (u) and
    sums 256 products (255u): |Q - C| <= 264u C. So |Q - P| <= (N + 273)u C,
    and where two counted costs lie more than 2 (N + 273)u max(C) apart,
    their proxy costs order as they do. The bound doubles that, which
    covers max(C) against max(Q) and the second-order terms: at 768x512 (N =
    2,355,456) it is 1.05e-9 of the larger cost."""
    return 4.0 * (n_terms + 512) * 2.0 ** -53


def select_transform(arr: np.ndarray, lossless: bool) -> int:
    """Adaptive per-image choice by the gradient proxy. Lossless
    candidates: NONE / SUBGREEN / YCOCG (all exactly invertible). Lossy:
    NONE / SUBGREEN_CLAMPED (mod-256 wraps amplify quantization error,
    so wrapping transforms are excluded — see round-1 regression test).

    Every |gradient| of a uint8 plane is an integer in [0, 255], so each
    candidate's cost is computed from integer counts (_counted_costs).
    Where candidates lie within _tie_bound of the least counted cost, an
    exact tie included, the exact _proxy_cost decides among them, so the
    choice is always _proxy_choice's over every candidate."""
    global exact_fallbacks
    costs, n_terms = _counted_costs(arr, lossless)
    best = min(costs.values())
    tol = _tie_bound(n_terms) * max(costs.values())
    near = [t for t, c in costs.items() if c - best <= tol]
    if len(near) == 1:
        return near[0]
    with _fallbacks_lock:
        exact_fallbacks += 1
    with annotate("frave.encode.transform.exact"):
        return _proxy_choice(arr, near)


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
