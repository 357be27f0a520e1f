"""Encoder driver: the port of frave_tpu/codec/encoder.py (FRIEncoder).
The "torch" backend runs the PyTorch pipeline and serializes through
codec/container.py; "native" runs the C++ frif codec (csrc/frif.cpp)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np

from ..images import ColorSpace, RasterImage
from .container import serialize
from .options import EncoderOptions
from .pipeline_torch import encode_pipeline_torch

BACKENDS = ("auto", "torch", "native")


def select_backend(backend: str) -> str:
    """"auto" -> "torch"; an unknown name raises ValueError."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (one of {BACKENDS})")
    return "torch" if backend == "auto" else backend


class FRIEncoder:
    """Encodes images on one torch device, in the mode of its options."""

    def __init__(self, opts: Optional[EncoderOptions] = None, device="cuda"):
        if opts is not None and not isinstance(opts, EncoderOptions):
            raise TypeError(
                f"opts must be frave_tpu_torch.EncoderOptions, got {type(opts).__name__}"
            )
        self.opts = opts or EncoderOptions()
        self.device = device

    def encode(
        self,
        data: Union[np.ndarray, RasterImage],
        height: Optional[int] = None,
        width: Optional[int] = None,
        colorspace: Optional[ColorSpace] = None,
    ) -> bytes:
        if isinstance(data, RasterImage):
            image = data
        else:
            arr = np.asarray(data, dtype=np.uint8)
            if height is not None and width is not None:
                arr = arr.reshape(height, width, arr.size // (height * width))
            image = RasterImage.from_array(arr, colorspace)
        backend = select_backend(self.opts.backend)
        if self.opts.color_transform == "trial" and image.metadata.colorspace == ColorSpace.RGB:
            return self._encode_trial(image, backend)
        return self._encode_one(image, backend, self.opts)

    def _encode_one(self, image: RasterImage, backend: str, opts: EncoderOptions) -> bytes:
        if backend == "native":
            from ..native import frif_encode_native
            from .channel_transform import choose_transform

            tid = 0
            if image.metadata.colorspace == ColorSpace.RGB:
                ct = opts.color_transform
                tid = choose_transform(image.data, "auto" if ct == "trial" else ct,
                                       opts.quality.name == "LOSSLESS")
            return frif_encode_native(image.data, quality=opts.quality.value, transform=tid,
                                      num_lanes=opts.num_lanes or 0, mode=opts.mode)
        return serialize(encode_pipeline_torch(image, opts, self.device))

    def _encode_trial(self, image: RasterImage, backend: str) -> bytes:
        """color_transform="trial" (frave_tpu FRIEncoder._encode_trial):
        encode with every candidate transform and keep the smallest
        container (the first of equal sizes). Gray images never get here:
        they have no transform to try."""
        if self.opts.quality.name == "LOSSLESS":
            cands = ("none", "subtract-green", "ycocg")
        else:
            cands = ("none", "subtract-green")
        best = None
        for ctf in cands:
            blob = self._encode_one(image, backend,
                                    dataclasses.replace(self.opts, color_transform=ctf))
            if best is None or len(blob) < len(best):
                best = blob
        return best


def encode(
    data: Union[np.ndarray, RasterImage],
    opts: Optional[EncoderOptions] = None,
    device="cuda",
    **kwargs,
) -> bytes:
    """Encode an image ([h, w] / [h, w, c] uint8 array or RasterImage) into
    a frif container with the port's EncoderOptions `opts` (None: the
    defaults)."""
    return FRIEncoder(opts, device).encode(data, **kwargs)
