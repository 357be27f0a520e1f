"""Decoder driver: the port of frave_tpu/codec/decoder.py (FRIDecoder).
The "torch" backend parses through codec/container.py and decodes with
the PyTorch pipeline; "native" decodes with the C++ frif codec
(csrc/frif.cpp, grid containers only)."""

from __future__ import annotations

from ..images import ColorSpace, ImageMetadata, RasterImage
from .container import deserialize
from .encoder import select_backend
from .pipeline_torch import decode_pipeline_torch


class FRIDecoder:
    """Decodes frif containers (v7-v9, every mode) on one torch device, or
    with the C++ codec (backend="native")."""

    def __init__(self, backend: str = "auto", device="cuda"):
        self.backend = select_backend(backend)
        self.device = device

    def decode(self, data: bytes) -> RasterImage:
        if self.backend == "native":
            from ..native import frif_decode_native

            out = frif_decode_native(data)
            meta = ImageMetadata(
                height=out.shape[0], width=out.shape[1],
                colorspace=ColorSpace.LUMA if out.shape[2] == 1 else ColorSpace.RGB,
            )
            return RasterImage(metadata=meta, data=out)
        return decode_pipeline_torch(deserialize(data), self.device)


def decode(blob: bytes, device="cuda", backend: str = "auto") -> RasterImage:
    """Decode a frif container into a RasterImage."""
    return FRIDecoder(backend, device).decode(blob)
