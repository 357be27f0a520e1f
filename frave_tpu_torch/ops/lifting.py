"""Fused lifting kernels: the port of frave_tpu/ops/pallas_lifting.py.

Two wrappers, each with its plain PyTorch version beside it:

  * forward_lift_quantize — bottom-up Haar lifting + truncated quantize
    (kernel A, csrc/lifting.cu frave_fwd_lift_quant; replaces
    pallas_lifting.forward_lift_quantize / _fwd_kernel);
  * dequantize_inverse_lift — midpoint dequantize + top-down inverse
    lifting (kernel B, csrc/lifting.cu frave_inv_lift; replaces
    pallas_lifting.dequantize_inverse_lift / _inv_kernel).

Layout: [rows, N] with one tile's N = 2^depth nodes contiguous (rows =
channels x tiles) — the layout of ops/torch_ops.forward_lifting, so the
pipeline needs none of the [N, C*T] transposes of the TPU layout. Masks
are [mask_rows, N] uint8/bool and row r reads mask row r % mask_rows, so
a per-tile mask serves every channel without being broadcast.

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


def dequantize_inverse_lift(
    qcoef: torch.Tensor,
    node_mask: torch.Tensor,
    leaf_mask: torch.Tensor,
    qdiv: torch.Tensor,
    depth: int,
) -> torch.Tensor:
    """qcoef [rows, N] int32, node/leaf masks [mask_rows, N], qdiv [N]
    int32 -> leaves [rows, N] int32 (garbage at mask-false leaves)."""
    _check_rows(qcoef, depth, "qcoef")
    _check_mask(node_mask, qcoef, "node_mask")
    _check_mask(leaf_mask, qcoef, "leaf_mask")
    if node_mask.shape != leaf_mask.shape:
        raise ValueError("node_mask and leaf_mask must share a shape")
    _check_qdiv(qdiv, qcoef)
    if qcoef.device.type == "cpu":
        return dequantize_inverse_lift_plain(
            qcoef, node_mask, leaf_mask, qdiv, depth
        )
    _check_device(qcoef, node_mask, leaf_mask, qdiv)
    lib = _build.load_library()
    nm = node_mask.view(torch.uint8) if node_mask.dtype == torch.bool else node_mask
    lm = leaf_mask.view(torch.uint8) if leaf_mask.dtype == torch.bool else leaf_mask
    out = torch.empty_like(qcoef)
    code = lib.frave_inv_lift(
        qcoef.data_ptr(), nm.data_ptr(), lm.data_ptr(), nm.shape[0],
        qdiv.data_ptr(), out.data_ptr(), qcoef.shape[0], depth,
        _build.current_stream(qcoef.device),
    )
    _build.check(code, "frave_inv_lift")
    dequantize_inverse_lift.launches += 1
    return out


dequantize_inverse_lift.launches = 0
