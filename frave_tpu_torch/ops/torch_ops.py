"""Elementwise codec ops in PyTorch: the port of frave_tpu/ops/jax_ops.py.

Same integer and IEEE f32 semantics as the JAX functions, op for op:

  * integer lifting uses truncated division (the reference's Rust `/`);
  * context math is a fixed left-to-right chain of f32 multiplies and
    adds with no reductions, so every backend agrees on every bucket and
    prediction bit for bit. Each torch op here is its own kernel and
    stores an f32 result, so nothing is contracted into an FMA.

Functions take tensors on any device and return tensors on that device.
"""

from __future__ import annotations

import functools

import torch

from ..entropy.tables import BUCKET_EDGES as _BUCKET_EDGES

PRED_CLAMP = 255  # see frave_tpu/ops/prediction.py


def trunc_div(a: torch.Tensor, q) -> torch.Tensor:
    """Truncated integer division (toward zero), as Rust's `/`."""
    return torch.div(a, q, rounding_mode="trunc")


def f16_wire_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the IEEE binary16 round-to-nearest-even value, as f32.

    The integer-op twin of jax_ops.f16_wire_round: RNE truncation of the
    mantissa for normal f16 magnitudes (overflow carries to inf), an
    explicit shift onto the 2^-24 grid for subnormals, NaN passed through
    unchanged and the sign reapplied bitwise (so -0 survives). The u32
    bit pattern is carried in int64."""
    bits = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    bits = bits & 0xFFFFFFFF
    sign = bits & 0x80000000
    absb = bits & 0x7FFFFFFF

    lsb = (absb >> 13) & 1
    rounded = (absb + 0xFFF + lsb) & 0xFFFFE000
    rounded = torch.where(
        rounded >= 0x47800000, torch.full_like(rounded, 0x7F800000), rounded
    )

    e = absb >> 23
    m = (absb & 0x7FFFFF) | 0x800000
    shift = torch.clamp(126 - e, 1, 31)
    half = torch.ones_like(shift) << (shift - 1)
    q = (m + half - 1 + ((m >> shift) & 1)) >> shift
    q = torch.where(e == 0, torch.zeros_like(q), q)
    sub = q.to(torch.float32) * (2.0 ** -24)
    sub_bits = sub.view(torch.int32).to(torch.int64) & 0xFFFFFFFF

    out_abs = torch.where(absb >= 0x38800000, rounded, sub_bits)
    out = torch.where(absb > 0x7F800000, bits, sign | out_abs)
    out = out - ((out >> 31) & 1) * (1 << 32)  # u32 pattern -> i32 value
    return out.to(torch.int32).view(torch.float32)


def forward_lifting(
    leaves: torch.Tensor, leaf_mask: torch.Tensor, depth: int
) -> torch.Tensor:
    """Mask-aware Haar lifting, bottom-up: [..., N] int32 leaves ->
    coefficients [..., N] int32 (DC at 0, level-L differences at haar
    indices [2^L, 2^(L+1)))."""
    n = 1 << depth
    if leaves.shape[-1] != n:
        raise ValueError(f"leaves must have {n} nodes per tile")
    parts = [None] * depth
    vals = leaves.to(torch.int32)
    mask = torch.broadcast_to(leaf_mask.to(torch.bool), vals.shape)
    zero = torch.zeros((), dtype=torch.int32, device=vals.device)
    for level in range(depth - 1, -1, -1):
        L, R = vals[..., 0::2], vals[..., 1::2]
        Lm, Rm = mask[..., 0::2], mask[..., 1::2]
        l0 = torch.where(Lm, L, zero)
        r0 = torch.where(Rm, R, zero)
        both = Lm & Rm
        c = torch.where(both, l0 - r0, zero)
        parts[level] = c
        vals = torch.where(both, r0 + trunc_div(c, 2), l0 + r0)
        mask = Lm | Rm
    dc = torch.where(mask[..., 0:1], vals[..., 0:1], zero)
    return torch.cat([dc] + parts, dim=-1)


def inverse_lifting(
    coef: torch.Tensor,
    depth: int,
    node_mask: torch.Tensor,
    leaf_mask: torch.Tensor,
) -> torch.Tensor:
    """Inverse lifting, top-down: coefficients [..., N] -> leaf values
    [..., N] int32 (garbage at mask-false leaves, never read)."""
    n = 1 << depth
    if coef.shape[-1] != n:
        raise ValueError(f"coefficients must have {n} nodes per tile")
    node_mask = node_mask.to(torch.bool)
    leaf_mask = leaf_mask.to(torch.bool)
    vals = coef[..., 0:1]
    for level in range(depth):
        lo, hi = 1 << level, 1 << (level + 1)
        c = coef[..., lo:hi]
        if level == depth - 1:
            Lm, Rm = leaf_mask[..., 0::2], leaf_mask[..., 1::2]
        else:
            Lm = node_mask[..., 2 * lo : 2 * hi : 2]
            Rm = node_mask[..., 2 * lo + 1 : 2 * hi : 2]
        both = Lm & Rm
        right = torch.where(both, vals - trunc_div(c, 2), vals)
        left = torch.where(both, c + right, vals)
        vals = torch.stack([left, right], dim=-1).reshape(
            c.shape[:-1] + (2 * (hi - lo),)
        )
    return vals


def quantize(coef: torch.Tensor, divisors: torch.Tensor) -> torch.Tensor:
    """Per-haar-index truncated divide."""
    return trunc_div(coef, divisors.to(coef.dtype))


def dequantize(coef: torch.Tensor, divisors: torch.Tensor) -> torch.Tensor:
    """Multiply back with a midpoint bias: c*q + sign(c)*((q-1)//2)."""
    q = divisors.to(torch.int32)
    c = coef.to(torch.int32)
    return c * q + torch.sign(c) * torch.div(q - 1, 2, rounding_mode="floor")


@functools.lru_cache(maxsize=None)
def _bucket_edges(device: torch.device) -> torch.Tensor:
    """The f32 bucket edges on `device`, uploaded once a device: a copy
    from host memory made on every call would wait for the device."""
    return torch.tensor(_BUCKET_EDGES, dtype=torch.float32).to(device)


def assign_bucket_f32(width: torch.Tensor) -> torch.Tensor:
    """Width -> context bucket: the count of f32 edges <= width (NaN and
    negative widths -> bucket 0)."""
    w = torch.where(torch.isnan(width), torch.zeros_like(width), width)
    w = torch.clamp(w, min=0.0)
    return (w[..., None] >= _bucket_edges(w.device)).sum(dim=-1, dtype=torch.int32)


def _med(v: torch.Tensor):
    """LOCO-I/MED prediction + |v0 - v2| width bucket (LF contexts)."""
    v0, v1, v2 = v[..., 0], v[..., 1], v[..., 2]
    mx = torch.maximum(v0, v2)
    mn = torch.minimum(v0, v2)
    med = torch.where(v1 >= mx, mx, torch.where(v1 <= mn, mn, v0 + v2 - v1))
    bucket = assign_bucket_f32(torch.abs(v0 - v2).to(torch.float32))
    return bucket, med


def contexts_hf(vals: torch.Tensor, vp: torch.Tensor, wp: torch.Tensor):
    """HF context bucket + UNCLAMPED int32 prediction, with the predictor
    rows already selected (vp/wp broadcastable to [..., 6])."""
    vf = vals.to(torch.float32)
    g1 = torch.abs(vf[..., 0] - vf[..., 3])
    g2 = torch.abs(vf[..., 1] - vf[..., 2])
    g3 = torch.abs(vf[..., 4] - vf[..., 5])
    g4 = torch.abs(vf[..., 1] - vf[..., 5])
    g5 = torch.abs(vf[..., 2] - vf[..., 4])
    hf_width = (
        wp[..., 0]
        + wp[..., 1] * g1
        + wp[..., 2] * g2
        + wp[..., 3] * g3
        + wp[..., 4] * g4
        + wp[..., 5] * g5
    )
    gsum = g1 + g2 + g3 + g4 + g5
    hf_width = torch.where(gsum == 0.0, torch.zeros_like(hf_width), hf_width)
    hf_bucket = assign_bucket_f32(hf_width)
    hf_pred_f = (
        vf[..., 0] * vp[..., 0]
        + vf[..., 1] * vp[..., 1]
        + vf[..., 2] * vp[..., 2]
        + vf[..., 3] * vp[..., 3]
        + vf[..., 4] * vp[..., 4]
        + vf[..., 5] * vp[..., 5]
    )
    hf_pred_f = torch.where(
        torch.isnan(hf_pred_f), torch.zeros_like(hf_pred_f), hf_pred_f
    )
    hf_pred = torch.trunc(torch.clamp(hf_pred_f, -1e9, 1e9)).to(torch.int32)
    return hf_bucket, hf_pred


def contexts(
    vals: torch.Tensor,  # [..., K, 6] int32 taps (0 where absent)
    lf: torch.Tensor,  # [K] bool
    group: torch.Tensor,  # [K] int64 predictor group
    vparams: torch.Tensor,  # [..., F, 6] f32
    wparams: torch.Tensor,  # [..., F, 6] f32
):
    """Per-symbol context bucket + clamped prediction with a per-symbol
    predictor group (jax_ops.contexts, vmapped there over channels; here
    the leading dims of vals and the params broadcast)."""
    lf_bucket, med = _med(vals.to(torch.int32))
    vp = vparams[..., group, :]
    wp = wparams[..., group, :]
    hf_bucket, hf_pred = contexts_hf(vals, vp, wp)
    bucket = torch.where(lf, lf_bucket, hf_bucket)
    pred = torch.where(lf, med, hf_pred)
    return bucket, torch.clamp(pred, -PRED_CLAMP, PRED_CLAMP)


def contexts_static(
    vals: torch.Tensor, vp: torch.Tensor, wp: torch.Tensor, lf: bool
):
    """`contexts` for one schedule segment, whose phase (lf) and predictor
    row are fixed: vp/wp are the segment's rows, broadcastable to
    [..., 6]."""
    if lf:
        bucket, pred = _med(vals.to(torch.int32))
    else:
        bucket, pred = contexts_hf(vals, vp, wp)
    return bucket, torch.clamp(pred, -PRED_CLAMP, PRED_CLAMP)


def pack_signed(k: torch.Tensor) -> torch.Tensor:
    """Zig-zag signed -> unsigned symbol."""
    return torch.where(k >= 0, 2 * k, -2 * k - 1)


def unpack_signed(k: torch.Tensor) -> torch.Tensor:
    """Inverse zig-zag."""
    return torch.where(
        torch.remainder(k, 2) == 0,
        torch.div(k, 2, rounding_mode="floor"),
        -torch.div(k + 1, 2, rounding_mode="floor"),
    )


def _sgn8(x):
    """Mod-256 value -> signed representative in [-128, 127]."""
    return ((x + 128) & 255) - 128


def channel_transform(planes: torch.Tensor, tid: int) -> torch.Tensor:
    """[3, HW] int32 raw RGB -> coding planes of transform `tid` (exact
    integer twins of codec/channel_transform.py)."""
    r, g, b = planes[0], planes[1], planes[2]
    if tid == 0:
        return planes
    if tid == 1:
        return torch.stack([(r - g) & 255, g, (b - g) & 255])
    if tid == 2:
        return torch.stack(
            [torch.clamp(r - g + 128, 0, 255), g, torch.clamp(b - g + 128, 0, 255)]
        )
    if tid == 3:
        co = (r - b) & 255
        t = (b + (_sgn8(co) >> 1)) & 255
        cg = (g - t) & 255
        y = (t + (_sgn8(cg) >> 1)) & 255
        return torch.stack([y, co, cg])
    raise ValueError(f"unknown channel transform id {tid}")


def inverse_channel_transform(planes: torch.Tensor, tid: int) -> torch.Tensor:
    """Inverse of channel_transform on [3, HW] int32 coding planes."""
    a, g, c = planes[0], planes[1], planes[2]
    if tid == 0:
        return planes
    if tid == 1:
        return torch.stack([(a + g) & 255, g, (c + g) & 255])
    if tid == 2:
        return torch.stack(
            [torch.clamp(a + g - 128, 0, 255), g, torch.clamp(c + g - 128, 0, 255)]
        )
    if tid == 3:
        t = (a - (_sgn8(c) >> 1)) & 255  # y, co, cg = a, g, c
        gg = (c + t) & 255
        b = (t - (_sgn8(g) >> 1)) & 255
        r = (g + b) & 255
        return torch.stack([r, gg, b])
    raise ValueError(f"unknown channel transform id {tid}")
