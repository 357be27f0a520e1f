"""Decoder driver: the port of frave_tpu/codec/decoder.py (FRIDecoder)
for the torch backend. Parses through codec/container.py."""

from __future__ import annotations

from ..images import RasterImage
from .container import deserialize
from .pipeline_torch import decode_pipeline_torch


class FRIDecoder:
    """Decodes frif containers (v7-v9, every mode) on one torch device."""

    def __init__(self, device="cuda"):
        self.device = device

    def decode(self, data: bytes) -> RasterImage:
        return decode_pipeline_torch(deserialize(data), self.device)


def decode(blob: bytes, device="cuda") -> RasterImage:
    """Decode a frif container into a RasterImage."""
    return FRIDecoder(device).decode(blob)
