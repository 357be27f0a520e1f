"""Encoder driver: the port of frave_tpu/codec/encoder.py (FRIEncoder)
for the torch backend. Serializes through codec/container.py."""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np

from ..images import ColorSpace, RasterImage
from .container import serialize
from .options import EncoderOptions
from .pipeline_torch import encode_pipeline_torch


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
        if self.opts.color_transform == "trial" and image.metadata.colorspace == ColorSpace.RGB:
            return self._encode_trial(image)
        return serialize(encode_pipeline_torch(image, self.opts, self.device))

    def _encode_trial(self, image: RasterImage) -> bytes:
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
            opts = dataclasses.replace(self.opts, color_transform=ctf)
            blob = serialize(encode_pipeline_torch(image, opts, self.device))
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
