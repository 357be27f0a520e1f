"""The gradient counts of the RGB transform choice, for a batch of images
on their device.

transform_counts(pixels, h, w, lossless) -> [B, N, 256] int32: entry
[b, p, k] counts |dx| = k plus |dy| = k of coding plane p of image b on
the transform proxy's subsample (codec/channel_transform.py:
_candidate_planes' N = 8 lossless or 5 lossy planes, _proxy_stride's
stride), the counts from which transform_from_counts decides each
image's transform. A CUDA tensor launches csrc/transform_counts.cu
frave_transform_counts, one launch for the batch, or raises; a CPU
tensor takes the plain version, transform_counts_plain (the host's
_gradient_counts, image by image). Each launch adds one to
transform_counts.launches.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codec import channel_transform as CT
from . import _build


def transform_counts_plain(pixels: torch.Tensor, h: int, w: int, lossless: bool) -> torch.Tensor:
    """transform_counts as the host computes it: each image's candidate
    planes (_candidate_planes) and their counts (_gradient_counts), on the
    pixels' device. Takes what the wrapper takes: one image [h*w, 3]
    without its batch axis too."""
    if pixels.dim() == 2:
        return transform_counts_plain(pixels[None], h, w, lossless)[0]
    counts = [CT._gradient_counts(CT._candidate_planes(img.reshape(h, w, 3), lossless)[0])
              for img in pixels.cpu().numpy()]
    return torch.from_numpy(np.stack(counts).astype(np.int32)).to(pixels.device)


def transform_counts(pixels: torch.Tensor, h: int, w: int, lossless: bool) -> torch.Tensor:
    """pixels [B, h*w, 3] uint8 (a same-shape batch of RGB images, HWC,
    contiguous; one image may come as [h*w, 3]) -> [B, N, 256] int32 on
    the pixels' device, N = 8 lossless or 5: each candidate coding plane's
    counts of |dx| = k plus |dy| = k on the proxy's subsample
    arr[::s, ::s], s = _proxy_stride(h, w), equal to
    _gradient_counts(_candidate_planes(arr, lossless)[0]) for each image
    arr. The kernel on the card, the plain version on the CPU."""
    if pixels.dtype != torch.uint8 or pixels.dim() not in (2, 3):
        raise TypeError(f"pixels must be uint8 [B, H*W, 3] or [H*W, 3], got {pixels.dtype} "
                        f"{tuple(pixels.shape)}")
    if pixels.dim() == 2:
        return transform_counts(pixels[None], h, w, lossless)[0]
    B = pixels.shape[0]
    if h < 1 or w < 1 or pixels.shape[1:] != (h * w, 3):
        raise ValueError(f"pixels must be [B, {h}*{w}, 3], got {tuple(pixels.shape)}")
    if not 1 <= B <= 65535:
        raise ValueError(f"a batch holds 1 to 65535 images, got {B}")
    if pixels.device.type == "cpu":
        return transform_counts_plain(pixels, h, w, lossless)
    if pixels.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {pixels.device}")
    if not pixels.is_contiguous():
        raise ValueError("pixels must be contiguous")
    s = CT._proxy_stride(h, w)
    if 2 * -(-h // s) * -(-w // s) >= 1 << 31:
        raise ValueError(f"a {h}x{w} image has too many gradients for int32 counts")
    out = torch.zeros((B, 8 if lossless else 5, 256), dtype=torch.int32, device=pixels.device)
    lib = _build.load_library()
    code = lib.frave_transform_counts(pixels.data_ptr(), out.data_ptr(), h, w, s, B,
                                      int(bool(lossless)), _build.current_stream(pixels.device))
    _build.check(code, "frave_transform_counts")
    transform_counts.launches += 1
    return out


transform_counts.launches = 0
