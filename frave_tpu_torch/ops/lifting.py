"""Fused lifting kernels: the port of frave_tpu/ops/pallas_lifting.py.

Two wrappers, each with its plain PyTorch version beside it:

  * forward_lift_quantize — bottom-up Haar lifting + truncated quantize
    (kernel A, csrc/lifting.cu frave_fwd_lift_quant; replaces
    pallas_lifting.forward_lift_quantize / _fwd_kernel);
  * dequantize_inverse_lift_pixels — midpoint dequantize + top-down
    inverse lifting, then the decode tail: clamp, inverse channel
    transform, pixels (kernel B, csrc/lifting.cu frave_inv_lift_pixels;
    replaces pallas_lifting.dequantize_inverse_lift / _inv_kernel and
    the pix_inv gather after it). Its lifting step alone stays as
    dequantize_inverse_lift_plain.

Layout: [rows, N] with one tile's N = 2^depth nodes contiguous (rows =
channels x tiles) — the layout of ops/torch_ops.forward_lifting, so the
pipeline needs none of the [N, C*T] transposes of the TPU layout. Masks
are [mask_rows, N] uint8/bool and row r reads mask row r % mask_rows, so
a per-tile mask serves every channel without being broadcast; kernel B
reads the coefficient plane [C, T*N] where it lies.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises. Each launch adds one to the wrapper's `launches` count.
"""

from __future__ import annotations

import torch

from . import _build
from . import torch_ops as T


def _check_rows(x: torch.Tensor, depth: int, name: str):
    n = 1 << depth
    if x.dim() != 2 or x.shape[1] != n:
        raise ValueError(f"{name} must be [rows, {n}], got {tuple(x.shape)}")
    if x.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_mask(m: torch.Tensor, x: torch.Tensor, name: str):
    if m.dim() != 2 or m.shape[1] != x.shape[1]:
        raise ValueError(f"{name} must be [mask_rows, {x.shape[1]}]")
    if x.shape[0] % m.shape[0]:
        raise ValueError(f"{name} rows must divide the data rows")
    if m.dtype not in (torch.uint8, torch.bool) or not m.is_contiguous():
        raise TypeError(f"{name} must be a contiguous uint8/bool tensor")


def _check_qdiv(q: torch.Tensor, x: torch.Tensor):
    if q.shape != (x.shape[1],) or q.dtype != torch.int32:
        raise ValueError(f"qdiv must be int32 [{x.shape[1]}]")
    if not q.is_contiguous():
        raise ValueError("qdiv must be contiguous")


def _check_device(x: torch.Tensor, *others: torch.Tensor):
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    if any(o.device != x.device for o in others):
        raise ValueError(f"all operands must lie on {x.device}")


def _expand_mask(m: torch.Tensor, rows: int) -> torch.Tensor:
    return m.to(torch.bool).repeat(rows // m.shape[0], 1)


def forward_lift_quantize_plain(leaves, leaf_mask, qdiv, depth):
    mask = _expand_mask(leaf_mask, leaves.shape[0])
    return T.quantize(T.forward_lifting(leaves, mask, depth), qdiv)


def forward_lift_quantize(
    leaves: torch.Tensor, leaf_mask: torch.Tensor, qdiv: torch.Tensor, depth: int
) -> torch.Tensor:
    """leaves [rows, N] int32 (pre-masked), leaf_mask [mask_rows, N],
    qdiv [N] int32 -> quantized coefficients [rows, N] int32."""
    _check_rows(leaves, depth, "leaves")
    _check_mask(leaf_mask, leaves, "leaf_mask")
    _check_qdiv(qdiv, leaves)
    if leaves.device.type == "cpu":
        return forward_lift_quantize_plain(leaves, leaf_mask, qdiv, depth)
    _check_device(leaves, leaf_mask, qdiv)
    lib = _build.load_library()
    mask = leaf_mask.view(torch.uint8) if leaf_mask.dtype == torch.bool else leaf_mask
    out = torch.empty_like(leaves)
    code = lib.frave_fwd_lift_quant(
        leaves.data_ptr(), mask.data_ptr(), mask.shape[0], qdiv.data_ptr(),
        out.data_ptr(), leaves.shape[0], depth,
        _build.current_stream(leaves.device),
    )
    _build.check(code, "frave_fwd_lift_quant")
    forward_lift_quantize.launches += 1
    return out


forward_lift_quantize.launches = 0


def dequantize_inverse_lift_plain(qcoef, node_mask, leaf_mask, qdiv, depth):
    rows = qcoef.shape[0]
    coef = T.dequantize(qcoef, qdiv)
    return T.inverse_lifting(
        coef, depth, _expand_mask(node_mask, rows), _expand_mask(leaf_mask, rows)
    )


def dequantize_inverse_lift_pixels_plain(
    qplane, node_mask, leaf_mask, qdiv, leaf_pix, pix_inv, tid: int
):
    """dequantize_inverse_lift_pixels as the reference's steps: the
    dequantize + inverse lifting of every channel row, then the pixel
    gather through pix_inv, the clamp to [0, 255] and the inverse channel
    transform (leaf_pix is not read)."""
    C = qplane.shape[0]
    Tn, N = node_mask.shape
    qcoef = qplane[:, : Tn * N].reshape(C * Tn, N)
    leaves = dequantize_inverse_lift_plain(
        qcoef, node_mask, leaf_mask, qdiv, N.bit_length() - 1
    )
    planes = torch.clamp(leaves.reshape(C, -1)[:, pix_inv], 0, 255)
    if C == 3:
        planes = T.inverse_channel_transform(planes, tid)
    return planes.to(torch.uint8)


def dequantize_inverse_lift_pixels(
    qplane: torch.Tensor,
    node_mask: torch.Tensor,
    leaf_mask: torch.Tensor,
    qdiv: torch.Tensor,
    leaf_pix: torch.Tensor,
    pix_inv: torch.Tensor,
    tid: int,
) -> torch.Tensor:
    """The decode after the rANS waves, depth 9: qplane [C, >= T*512]
    int32 coefficient plane (tile t of channel c at columns 512t..512t+511;
    last dim contiguous, and on the card rows 16-byte aligned), node /
    leaf masks [T, 512],
    qdiv [512] int32, and the pixel map in both directions: leaf_pix
    [T*512] int32 (the pixel of each leaf, -1 out of bounds) and pix_inv
    [H*W] int64 (the leaf of each pixel); CodecProgram.from_host checks
    that they are inverse bijections. -> pixels [C, H*W] uint8: every
    leaf dequantized and inverse-lifted, clamped to [0, 255], and for
    C = 3 the inverse channel transform `tid` (0-3). Kernel B
    (csrc/lifting.cu frave_inv_lift_pixels, which scatters through
    leaf_pix and reads pix_inv only for H*W) on the card; the plain
    version, which gathers through pix_inv, on the CPU."""
    C = qplane.shape[0]
    if node_mask.shape != (node_mask.shape[0], 512):
        raise ValueError(f"kernel B takes depth 9 only, got masks {tuple(node_mask.shape)}")
    Tn = node_mask.shape[0]
    if C not in (1, 3):
        raise ValueError(f"channels must be 1 or 3, got {C}")
    if C == 3 and not 0 <= tid <= 3:
        raise ValueError(f"unknown channel transform id {tid}")
    if qplane.dim() != 2 or qplane.shape[1] < Tn * 512 or qplane.stride(1) != 1:
        raise ValueError(f"qplane must be [C, >= {Tn * 512}] with contiguous rows")
    if qplane.dtype != torch.int32:
        raise TypeError(f"qplane must be int32, got {qplane.dtype}")
    for name, m in (("node_mask", node_mask), ("leaf_mask", leaf_mask)):
        if m.shape != node_mask.shape or m.dtype not in (torch.uint8, torch.bool):
            raise TypeError(f"{name} must be uint8/bool [{Tn}, 512]")
        if not m.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    _check_qdiv(qdiv, node_mask)
    if leaf_pix.shape != (Tn * 512,) or leaf_pix.dtype != torch.int32:
        raise ValueError(f"leaf_pix must be int32 [{Tn * 512}]")
    if pix_inv.dim() != 1 or pix_inv.dtype != torch.int64:
        raise ValueError("pix_inv must be int64 [H*W]")
    if qplane.device.type == "cpu":
        return dequantize_inverse_lift_pixels_plain(
            qplane, node_mask, leaf_mask, qdiv, leaf_pix, pix_inv, tid
        )
    _check_device(qplane, node_mask, leaf_mask, qdiv, leaf_pix, pix_inv)
    nm = node_mask.view(torch.uint8) if node_mask.dtype == torch.bool else node_mask
    lm = leaf_mask.view(torch.uint8) if leaf_mask.dtype == torch.bool else leaf_mask
    for name, t in (("node_mask", nm), ("leaf_mask", lm), ("leaf_pix", leaf_pix)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if qplane.data_ptr() % 16 or qplane.stride(0) % 4:
        raise ValueError("qplane rows must be 16-byte aligned")
    lib = _build.load_library()
    hw = pix_inv.shape[0]
    out = torch.empty((C, hw), dtype=torch.uint8, device=qplane.device)
    code = lib.frave_inv_lift_pixels(
        qplane.data_ptr(), qplane.stride(0), nm.data_ptr(), lm.data_ptr(), qdiv.data_ptr(),
        leaf_pix.data_ptr(), out.data_ptr(), hw, Tn, C, tid if C == 3 else 0,
        _build.current_stream(qplane.device),
    )
    _build.check(code, "frave_inv_lift_pixels")
    dequantize_inverse_lift_pixels.launches += 1
    return out


dequantize_inverse_lift_pixels.launches = 0
