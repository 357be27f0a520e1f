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

Both take a whole same-shape batch in one launch (the JAX program's vmap
over B), each image with its own transform id, read on the device (and,
in kernel B, its own qdiv). Layout: one tile's 512 nodes contiguous, the
coefficient planes [B, C, T*512] (kernel A appends the zero slot:
[B, C, T*512 + 1]), so the pipeline needs none of the [N, C*T] transposes
of the TPU layout. The plain lifting
steps take rows [rows, N] and masks [mask_rows, N] uint8/bool, row r
reading mask row r % mask_rows, so a per-tile mask serves every channel
without being broadcast.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises. Each launch adds one to the wrapper's `launches` count.
"""

from __future__ import annotations

import functools

import torch

from . import _build
from . import torch_ops as T

WARPS_BLOCK = 16  # kernel A's block: 16 warps, at most 16 // C tiles of C rows


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


@functools.lru_cache(maxsize=None)
def _tid_table(device: torch.device) -> torch.Tensor:
    """The ids 0-3 as int32 on `device`, made once a device: one image's id
    is a one-element slice of it, so an int id costs no launch."""
    return torch.arange(4, dtype=torch.int32).to(device)


def _tids(tids, images: int, channels: int, device) -> torch.Tensor:
    """The per-image transform ids as an int32 [images] tensor on `device`:
    an int is every image's; a tensor is taken as it is. The ids are
    checked (0-3) where that needs no read from the card: an int, or a CPU
    tensor. On the card an id outside 0-3 runs as 0, as in the plain
    version."""
    if isinstance(tids, torch.Tensor):
        if tids.shape != (images,) or tids.dtype != torch.int32:
            raise ValueError(f"tids must be int32 [{images}], got {tids.dtype} {tuple(tids.shape)}")
        if tids.device != device:
            raise ValueError(f"tids must lie on {device}")
        bad = channels == 3 and tids.device.type == "cpu" and bool(((tids < 0) | (tids > 3)).any())
        if bad:
            raise ValueError("unknown channel transform id (0-3)")
        return tids.contiguous()
    t = int(tids) if channels == 3 else 0
    if not 0 <= t <= 3:
        raise ValueError(f"unknown channel transform id {t} (0-3)")
    if images == 1:
        return _tid_table(device)[t : t + 1]
    return torch.full((images,), t, dtype=torch.int32, device=device)


def _per_image(fn, planes: torch.Tensor, tids: torch.Tensor) -> torch.Tensor:
    """fn(planes [3, ...], tid) applied to each image of planes [B, 3, HW]
    with its own tids[b]; an id outside 1-3 is the identity (0)."""
    p = planes.transpose(0, 1)  # [3, B, HW]: fn reads the channel planes
    out = p
    for t in (1, 2, 3):
        out = torch.where((tids == t)[None, :, None], fn(p, t), out)
    return out.transpose(0, 1)


def forward_lift_quantize_pixels_plain(pixels, leaf_pix, qdiv, tids):
    """forward_lift_quantize_pixels on a batch ([B, H*W, C] pixels, tids
    [B] int32) as the reference's steps: the [B, C, H*W] int32 planes, each
    image's channel transform at C = 3, the leaf gather (a leaf with
    leaf_pix < 0 is out of bounds and 0), the masked forward lifting and
    quantize of every channel row, and the zero slot -> [B, C, T*512 + 1].
    Takes what the wrapper takes: one image without its batch axis, and
    tids as one int."""
    if pixels.dim() == 2:
        return forward_lift_quantize_pixels_plain(pixels[None], leaf_pix, qdiv, tids)[0]
    B, _, C = pixels.shape
    tids = _tids(tids, B, C, pixels.device)
    Tn = leaf_pix.shape[0] // 512
    planes = pixels.transpose(1, 2).to(torch.int32)
    if C == 3:
        planes = _per_image(T.channel_transform, planes, tids)
    inb = leaf_pix >= 0
    leaves = torch.where(inb, planes[..., leaf_pix.clamp(min=0).to(torch.int64)], 0)
    qcoef = forward_lift_quantize_plain(
        leaves.reshape(B * C * Tn, 512), inb.reshape(Tn, 512), qdiv, 9
    )
    return torch.cat([qcoef.reshape(B, C, Tn * 512), qcoef.new_zeros((B, C, 1))], dim=2)


def forward_lift_plan(C: int, tiles: int, sms: int, images: int = 1) -> int:
    """Tiles a block of kernel A at its launch rule for `images` images of
    `tiles` tiles: of 2 .. 16 // C, the count k that gives the busiest SM
    the least work, ceil(images * ceil(tiles / k) / sms) blocks of cost
    5 + k * C each; a tie goes to the larger k. A block costs a fixed part
    (its launch, qdiv, the barrier) and a part per (tile, channel) row, and
    a thread's loads of k tiles overlap, so a block of k tiles costs much
    less than k blocks of one: the 5 is the fixed part in row units, fitted
    to the smoke's sweeps of every k on an H100 (one image at 256², 512²
    gray, 768x512 and 2048² RGB; 64 images at 256² gray)."""
    best = (0, 0)
    for k in range(2, WARPS_BLOCK // C + 1):
        load = -(-(images * -(-tiles // k)) // sms) * (5 + k * C)
        if not best[1] or load <= best[0]:
            best = (load, k)
    return best[1]


def plane_stride(n_slots: int) -> int:
    """The int32 row stride of a coefficient plane on the card: n_slots + 1
    columns (the last the zero slot that absent taps read) rounded up to 16
    bytes, for kernel B's vector loads."""
    return (n_slots + 4) // 4 * 4


def zero_plane(images: int, channels: int, n_slots: int, device) -> torch.Tensor:
    """A zeroed coefficient plane [images, channels, n_slots + 1] int32, a
    view of rows of plane_stride: the layout kernel A writes."""
    buf = torch.zeros((images, channels, plane_stride(n_slots)), dtype=torch.int32,
                      device=device)
    return buf[..., : n_slots + 1]


def forward_lift_quantize_pixels(
    pixels: torch.Tensor,
    leaf_pix: torch.Tensor,
    qdiv: torch.Tensor,
    tids,
    tiles: int = 0,
) -> torch.Tensor:
    """The encode head of a same-shape batch, depth 9: pixels [B, H*W, C]
    uint8 (the images, HWC, contiguous; C 1 or 3), leaf_pix [T*512] int32
    (the pixel of each leaf, -1 out of bounds), qdiv [512] int32 and the
    channel transforms `tids` (int32 [B] on the pixels' device, or one int
    for every image; 0-3, applied at C = 3) -> qplane [B, C, T*512 + 1]
    int32: every channel row of every image transformed, gathered into its
    tiles, lifted and quantized, and a last column of zeros (the missing
    neighbour the statistics read). One image may come without its batch
    axis ([H*W, C] -> [C, T*512 + 1]). Kernel A (csrc/lifting.cu
    frave_fwd_lift_pixels, one launch for the batch) on the card, where the
    result is a view of a [B, C, S] buffer with S = T*512 + 1 rounded up to
    a multiple of 4 (16-byte aligned rows); the plain version on the CPU.
    `tiles` forces the tiles a block (1 .. 16 // C; sweeps only), 0 takes
    the launch rule (forward_lift_plan over the batch's tiles)."""
    if pixels.dim() not in (2, 3) or pixels.dtype != torch.uint8:
        raise TypeError(
            f"pixels must be uint8 [B, H*W, C] or [H*W, C], got {pixels.dtype} {tuple(pixels.shape)}"
        )
    if pixels.dim() == 2:
        return forward_lift_quantize_pixels(pixels[None], leaf_pix, qdiv, tids, tiles)[0]
    B, hw, C = pixels.shape
    if C not in (1, 3):
        raise ValueError(f"channels must be 1 or 3, got {C}")
    if not 1 <= B <= 65535:
        raise ValueError(f"a batch holds 1 to 65535 images, got {B}")
    if not pixels.is_contiguous():
        raise ValueError("pixels must be contiguous")
    if leaf_pix.dtype != torch.int32:
        raise TypeError(f"leaf_pix must be int32, got {leaf_pix.dtype}")
    if leaf_pix.dim() != 1 or leaf_pix.shape[0] % 512 or not leaf_pix.is_contiguous():
        raise ValueError(f"leaf_pix must be a contiguous [T*512], got {tuple(leaf_pix.shape)}")
    if qdiv.shape != (512,) or qdiv.dtype != torch.int32 or not qdiv.is_contiguous():
        raise ValueError("qdiv must be a contiguous int32 [512]")
    tids = _tids(tids, B, C, pixels.device)
    Tn = leaf_pix.shape[0] // 512
    if pixels.device.type == "cpu":
        return forward_lift_quantize_pixels_plain(pixels, leaf_pix, qdiv, tids)
    _check_device(pixels, leaf_pix, qdiv)
    if tiles:
        tpb = tiles
        if not 1 <= tpb <= WARPS_BLOCK // C:
            raise ValueError(f"tiles a block must be 1 .. {WARPS_BLOCK // C}, got {tpb}")
    else:
        sms = torch.cuda.get_device_properties(pixels.device).multi_processor_count
        tpb = forward_lift_plan(C, Tn, sms, B)
    n = Tn * 512
    stride = plane_stride(n)
    out = torch.empty((B, C, stride), dtype=torch.int32, device=pixels.device)
    lib = _build.load_library()
    code = lib.frave_fwd_lift_pixels(
        pixels.data_ptr(), leaf_pix.data_ptr(), qdiv.data_ptr(), tids.data_ptr(), out.data_ptr(),
        stride, hw, Tn, C, B, tpb, _build.current_stream(pixels.device),
    )
    _build.check(code, "frave_fwd_lift_pixels")
    forward_lift_quantize_pixels.launches += 1
    return out[..., : n + 1]


forward_lift_quantize_pixels.launches = 0


def dequantize_inverse_lift_plain(qcoef, node_mask, leaf_mask, qdiv, depth):
    rows = qcoef.shape[0]
    coef = T.dequantize(qcoef, qdiv)
    return T.inverse_lifting(
        coef, depth, _expand_mask(node_mask, rows), _expand_mask(leaf_mask, rows)
    )


def dequantize_inverse_lift_pixels_plain(
    qplane, node_mask, leaf_mask, qdiv, leaf_pix, pix_inv, tids
):
    """dequantize_inverse_lift_pixels on a batch (qplane [B, C, >= T*512],
    qdiv [B, 512], tids [B] int32) as the reference's steps: the dequantize
    (each image with its own qdiv) + inverse lifting of every channel row,
    then the pixel gather through pix_inv, the clamp to [0, 255] and each
    image's inverse channel transform (leaf_pix is not read) -> [B, C, H*W].
    Takes what the wrapper takes: one image without its batch axis, and
    tids as one int."""
    if qplane.dim() == 2:
        return dequantize_inverse_lift_pixels_plain(
            qplane[None], node_mask, leaf_mask, qdiv[None], leaf_pix, pix_inv, tids
        )[0]
    B, C = qplane.shape[:2]
    tids = _tids(tids, B, C, qplane.device)
    Tn, N = node_mask.shape
    qcoef = qplane[..., : Tn * N].reshape(B, C * Tn, N)
    coef = T.dequantize(qcoef, qdiv[:, None, :]).reshape(B * C * Tn, N)
    leaves = T.inverse_lifting(
        coef, N.bit_length() - 1, _expand_mask(node_mask, B * C * Tn),
        _expand_mask(leaf_mask, B * C * Tn),
    )
    planes = torch.clamp(leaves.reshape(B, C, -1)[..., pix_inv], 0, 255)
    if C == 3:
        planes = _per_image(T.inverse_channel_transform, planes, tids)
    return planes.to(torch.uint8)


def dequantize_inverse_lift_pixels(
    qplane: torch.Tensor,
    node_mask: torch.Tensor,
    leaf_mask: torch.Tensor,
    qdiv: torch.Tensor,
    leaf_pix: torch.Tensor,
    pix_inv: torch.Tensor,
    tids,
) -> torch.Tensor:
    """The decode after the rANS waves of a same-shape batch, depth 9:
    qplane [B, C, >= T*512] int32 coefficient planes (tile t of channel c
    of image b at columns 512t..512t+511; last dim contiguous, and on the
    card rows and image strides 16-byte aligned), node / leaf masks
    [T, 512], qdiv [B, 512] int32 (each image's own quantizer), the pixel
    map in both directions: leaf_pix [T*512] int32 (the pixel of each
    leaf, -1 out of bounds) and pix_inv [H*W] int64 (the leaf of each
    pixel); CodecProgram.from_host checks that they are inverse
    bijections; and the inverse channel transforms `tids` (int32 [B] on the
    plane's device, or one int for every image; 0-3, at C = 3) -> pixels
    [B, C, H*W] uint8: every leaf dequantized and inverse-lifted, clamped to
    [0, 255], and the inverse transform applied. One image may come without
    its batch axis (qplane [C, ...], qdiv [512] -> [C, H*W]). Kernel B
    (csrc/lifting.cu frave_inv_lift_pixels, one launch for the batch, which
    scatters through leaf_pix and reads pix_inv only for H*W) on the card;
    the plain version, which gathers through pix_inv, on the CPU."""
    if qplane.dim() == 2:
        if qdiv.dim() != 1:
            raise ValueError("one image's qplane [C, S] takes qdiv [512]")
        return dequantize_inverse_lift_pixels(
            qplane[None], node_mask, leaf_mask, qdiv[None], leaf_pix, pix_inv, tids
        )[0]
    if qplane.dim() != 3:
        raise ValueError(f"qplane must be [B, C, S] or [C, S], got {tuple(qplane.shape)}")
    B, C = qplane.shape[:2]
    if node_mask.shape != (node_mask.shape[0], 512):
        raise ValueError(f"kernel B takes depth 9 only, got masks {tuple(node_mask.shape)}")
    Tn = node_mask.shape[0]
    if C not in (1, 3):
        raise ValueError(f"channels must be 1 or 3, got {C}")
    if not 1 <= B <= 65535:
        raise ValueError(f"a batch holds 1 to 65535 images, got {B}")
    if qplane.shape[2] < Tn * 512 or qplane.stride(2) != 1:
        raise ValueError(f"qplane must be [B, C, >= {Tn * 512}] with contiguous rows")
    if qplane.dtype != torch.int32:
        raise TypeError(f"qplane must be int32, got {qplane.dtype}")
    for name, m in (("node_mask", node_mask), ("leaf_mask", leaf_mask)):
        if m.shape != node_mask.shape or m.dtype not in (torch.uint8, torch.bool):
            raise TypeError(f"{name} must be uint8/bool [{Tn}, 512]")
        if not m.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if qdiv.shape != (B, 512) or qdiv.dtype != torch.int32 or not qdiv.is_contiguous():
        raise ValueError(f"qdiv must be a contiguous int32 [{B}, 512]")
    if leaf_pix.shape != (Tn * 512,) or leaf_pix.dtype != torch.int32:
        raise ValueError(f"leaf_pix must be int32 [{Tn * 512}]")
    if pix_inv.dim() != 1 or pix_inv.dtype != torch.int64:
        raise ValueError("pix_inv must be int64 [H*W]")
    tids = _tids(tids, B, C, qplane.device)
    if qplane.device.type == "cpu":
        return dequantize_inverse_lift_pixels_plain(
            qplane, node_mask, leaf_mask, qdiv, leaf_pix, pix_inv, tids
        )
    _check_device(qplane, node_mask, leaf_mask, qdiv, leaf_pix, pix_inv)
    nm = node_mask.view(torch.uint8) if node_mask.dtype == torch.bool else node_mask
    lm = leaf_mask.view(torch.uint8) if leaf_mask.dtype == torch.bool else leaf_mask
    for name, t in (("node_mask", nm), ("leaf_mask", lm), ("leaf_pix", leaf_pix)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if qplane.data_ptr() % 16 or qplane.stride(1) % 4 or qplane.stride(0) % 4:
        raise ValueError("qplane rows must be 16-byte aligned")
    if qplane.stride(0) < C * qplane.stride(1):
        raise ValueError("qplane images must not overlap")
    lib = _build.load_library()
    hw = pix_inv.shape[0]
    out = torch.empty((B, C, hw), dtype=torch.uint8, device=qplane.device)
    code = lib.frave_inv_lift_pixels(
        qplane.data_ptr(), qplane.stride(0), qplane.stride(1), nm.data_ptr(), lm.data_ptr(),
        qdiv.data_ptr(), tids.data_ptr(), leaf_pix.data_ptr(), out.data_ptr(), hw, Tn, C, B,
        _build.current_stream(qplane.device),
    )
    _build.check(code, "frave_inv_lift_pixels")
    dequantize_inverse_lift_pixels.launches += 1
    return out


dequantize_inverse_lift_pixels.launches = 0
