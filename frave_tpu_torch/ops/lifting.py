"""Fused lifting kernels: the port of frave_tpu/ops/pallas_lifting.py.

Two wrappers, each with its plain PyTorch version beside it:

  * forward_lift_quantize_pixels — the encode head: channel transform,
    leaf gather through the pixel map, bottom-up Haar lifting, truncated
    quantize and the zero slot the statistics read (kernel A,
    csrc/lifting.cu frave_fwd_lift_pixels; replaces
    pallas_lifting.forward_lift_quantize / _fwd_kernel and the transform
    and leaf gather before it in pipeline_jax's encode). Its lifting step
    alone stays as forward_lift_quantize_plain;
  * dequantize_inverse_lift_pixels — midpoint dequantize + top-down
    inverse lifting, then the decode tail: clamp, inverse channel
    transform, pixels (kernel B, csrc/lifting.cu frave_inv_lift_pixels;
    replaces pallas_lifting.dequantize_inverse_lift / _inv_kernel and
    the pix_inv gather after it). Its lifting step alone stays as
    dequantize_inverse_lift_plain.

Layout: one tile's 512 nodes contiguous, the coefficient plane [C, T*512]
(kernel A appends the zero slot: [C, T*512 + 1]), so the pipeline needs
none of the [N, C*T] transposes of the TPU layout. The plain lifting
steps take rows [rows, N] and masks [mask_rows, N] uint8/bool, row r
reading mask row r % mask_rows, so a per-tile mask serves every channel
without being broadcast.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises. Each launch adds one to the wrapper's `launches` count.
"""

from __future__ import annotations

import torch

from . import _build
from . import torch_ops as T

WARPS_BLOCK = 16  # kernel A's block: 16 warps, at most 16 // C tiles of C rows


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
    """leaves [rows, N] int32 (0 where masked), leaf_mask [mask_rows, N],
    qdiv [N] int32 -> quantized coefficients [rows, N] int32."""
    mask = _expand_mask(leaf_mask, leaves.shape[0])
    return T.quantize(T.forward_lifting(leaves, mask, depth), qdiv)


def forward_lift_quantize_pixels_plain(pixels, leaf_pix, qdiv, tid: int):
    """forward_lift_quantize_pixels as the reference's steps: the [C, H*W]
    int32 planes, the channel transform `tid` at C = 3, the leaf gather
    (a leaf with leaf_pix < 0 is out of bounds and 0), the masked forward
    lifting and quantize of every channel row, and the zero slot."""
    C = pixels.shape[1]
    Tn = leaf_pix.shape[0] // 512
    planes = pixels.T.to(torch.int32)
    if C == 3:
        planes = T.channel_transform(planes, tid)
    inb = leaf_pix >= 0
    leaves = torch.where(inb, planes[:, leaf_pix.clamp(min=0).to(torch.int64)], 0)
    qcoef = forward_lift_quantize_plain(
        leaves.reshape(C * Tn, 512), inb.reshape(Tn, 512), qdiv, 9
    )
    return torch.cat([qcoef.reshape(C, Tn * 512), qcoef.new_zeros((C, 1))], dim=1)


def forward_lift_plan(C: int, tiles: int, sms: int) -> int:
    """Tiles a block of kernel A at its launch rule: of 2 .. 16 // C, the
    count k that puts the fewest tiles on the busiest SM,
    ceil(ceil(tiles / k) / sms) * k; a tie goes to the larger k. A
    thread's loads of k tiles overlap, so a block of k tiles costs less
    than k blocks of one (the smoke's sweep of every k)."""
    best = (0, 0)
    for k in range(2, WARPS_BLOCK // C + 1):
        load = -(-(-(-tiles // k)) // sms) * k
        if not best[1] or load <= best[0]:
            best = (load, k)
    return best[1]


def forward_lift_quantize_pixels(
    pixels: torch.Tensor,
    leaf_pix: torch.Tensor,
    qdiv: torch.Tensor,
    tid: int,
    tiles: int = 0,
) -> torch.Tensor:
    """The encode head, depth 9: pixels [H*W, C] uint8 (the image, HWC,
    contiguous; C 1 or 3), leaf_pix [T*512] int32 (the pixel of each leaf,
    -1 out of bounds), qdiv [512] int32 and the channel transform `tid`
    (0-3, applied at C = 3) -> qplane [C, T*512 + 1] int32: every channel
    row transformed, gathered into its tiles, lifted and quantized, and a
    last column of zeros (the missing neighbour the statistics read).
    Kernel A (csrc/lifting.cu frave_fwd_lift_pixels) on the card, where the
    result is a view of a [C, S] buffer with S = T*512 + 1 rounded up to a
    multiple of 4 (16-byte aligned rows); the plain version on the CPU.
    `tiles` forces the tiles a block (1 .. 16 // C; sweeps only), 0 takes
    the launch rule (forward_lift_plan)."""
    if pixels.dim() != 2 or pixels.dtype != torch.uint8:
        raise TypeError(f"pixels must be uint8 [H*W, C], got {pixels.dtype} {tuple(pixels.shape)}")
    C = pixels.shape[1]
    if C not in (1, 3):
        raise ValueError(f"channels must be 1 or 3, got {C}")
    if C == 3 and not 0 <= tid <= 3:
        raise ValueError(f"unknown channel transform id {tid}")
    if not pixels.is_contiguous():
        raise ValueError("pixels must be contiguous")
    if leaf_pix.dtype != torch.int32:
        raise TypeError(f"leaf_pix must be int32, got {leaf_pix.dtype}")
    if leaf_pix.dim() != 1 or leaf_pix.shape[0] % 512 or not leaf_pix.is_contiguous():
        raise ValueError(f"leaf_pix must be a contiguous [T*512], got {tuple(leaf_pix.shape)}")
    if qdiv.shape != (512,) or qdiv.dtype != torch.int32 or not qdiv.is_contiguous():
        raise ValueError("qdiv must be a contiguous int32 [512]")
    Tn = leaf_pix.shape[0] // 512
    if pixels.device.type == "cpu":
        return forward_lift_quantize_pixels_plain(pixels, leaf_pix, qdiv, tid)
    _check_device(pixels, leaf_pix, qdiv)
    if tiles:
        tpb = tiles
        if not 1 <= tpb <= WARPS_BLOCK // C:
            raise ValueError(f"tiles a block must be 1 .. {WARPS_BLOCK // C}, got {tpb}")
    else:
        sms = torch.cuda.get_device_properties(pixels.device).multi_processor_count
        tpb = forward_lift_plan(C, Tn, sms)
    n = Tn * 512
    stride = (n + 4) // 4 * 4
    out = torch.empty((C, stride), dtype=torch.int32, device=pixels.device)
    lib = _build.load_library()
    code = lib.frave_fwd_lift_pixels(
        pixels.data_ptr(), leaf_pix.data_ptr(), qdiv.data_ptr(), out.data_ptr(), stride,
        pixels.shape[0], Tn, C, tid if C == 3 else 0, tpb,
        _build.current_stream(pixels.device),
    )
    _build.check(code, "frave_fwd_lift_pixels")
    forward_lift_quantize_pixels.launches += 1
    return out[:, : n + 1]


forward_lift_quantize_pixels.launches = 0


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
