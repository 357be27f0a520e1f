"""frave_tpu_torch — the frave_tpu codec in PyTorch and CUDA, for one
NVIDIA H100.

A port of the JAX package ``frave_tpu``, which stays beside it as the
reference. The port stands alone: it imports nothing of ``frave_tpu``.
Its host-side numpy modules (fractal geometry, lattice grids, the
schedules of every mode, host entropy tables, the frif container,
options, images) are its own copies of the JAX package's; everything that
ran on the TPU is rewritten here on torch tensors, and the TPU's Pallas
kernels (the two lifting kernels and the whole-wave rANS decode), the
rANS encode loop and the step-tensor decode scan are CUDA C++ kernels
under ``csrc/`` (built with nvcc on first use, see ``ops/_build.py``).

Public API (every mode: ``EncoderOptions(mode=...)`` "grid", the default,
"parallel" or "parity"; the decoder reads the mode, and the v7/v8
legacy containers, from the container)::

    blob = frave_tpu_torch.encode(img, opts=None, device="cuda")
    out = frave_tpu_torch.decode(blob, device="cuda")   # a RasterImage

``opts`` is the port's own ``EncoderOptions``, the image a numpy array or
the port's ``RasterImage``.

Same-shape batches (one launch of each kernel for the whole batch) and
the host/device-pipelined drivers over many images::

    cis = encode_pipeline_torch_batch(images, opts, device="cuda")
    cis = encode_pipeline_torch_stream(images, opts, batch_size=8, device="cuda")
    outs = decode_pipeline_torch_batch(cis, device="cuda")
    outs = decode_pipeline_torch_stream(cis, batch_size=8, device="cuda")
    blobs, outs = roundtrip_pipeline_torch_stream(images, opts, batch_size=8,
                                                  device="cuda", device_verify=False)

``images`` are RasterImages of one shape and colorspace, ``cis``
CompressedImages (``codec.container.serialize`` / ``deserialize`` turn
them into bytes and back); with ``device_verify=True`` the round trip
compares the decoded pixels with the input on the card and returns the
mismatch count instead of the images.

``device="cpu"`` runs every kernel's plain PyTorch version instead (the
tests use it); ``device="cuda"`` without CUDA raises.
"""

from .codec.decoder import FRIDecoder, decode
from .codec.encoder import FRIEncoder, encode
from .codec.options import EncoderOptions, EncoderQuality
from .codec.pipeline_torch import (
    decode_pipeline_torch_batch,
    decode_pipeline_torch_stream,
    encode_pipeline_torch_batch,
    encode_pipeline_torch_stream,
    roundtrip_pipeline_torch_stream,
)
from .images import RasterImage

__all__ = [
    "EncoderOptions",
    "EncoderQuality",
    "RasterImage",
    "FRIEncoder",
    "FRIDecoder",
    "encode",
    "decode",
    "encode_pipeline_torch_batch",
    "encode_pipeline_torch_stream",
    "decode_pipeline_torch_batch",
    "decode_pipeline_torch_stream",
    "roundtrip_pipeline_torch_stream",
]
