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

``EncoderOptions(backend="native")`` and ``FRIDecoder(backend="native")``
(or ``decode(blob, backend="native")``) run the C++ frif codec of
``csrc/frif.cpp`` instead (grid containers; the encoder also the
parallel mode). It and the host geometry builder live in the native host
library (``native.py``), built with g++ from ``csrc/`` into ``_build/``
on first use; a failed build raises.

The command line (``cli/``), with the JAX package's subcommands::

    python -m frave_tpu_torch.cli encode x.npy -o x.frv [--device cpu]
    python -m frave_tpu_torch.cli decode x.frv -o y.npy [--backend native]
    python -m frave_tpu_torch.cli bench DIR        # .npy (and PIL) images
    python -m frave_tpu_torch.cli optimize x.npy [--search-predictors --search-limit 64]

Observability: ``metrics.get_metrics()`` holds what an encode records
(``encode/bpp``, ``encode/mean_abs_residual_ch{c}``, the per-context
entropies under ``verbose``) and the stage timers'; ``profiling.trace(dir)``
writes a torch.profiler Chrome trace of a region, ``profiling.stage_timer``
and ``profiling.annotate`` time and name stages.
"""

__version__ = "0.1.0"

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
from .images import ChannelData, ColorSpace, CompressedImage, FractalVariant, ImageMetadata, RasterImage

__all__ = [
    "ColorSpace",
    "FractalVariant",
    "ImageMetadata",
    "CompressedImage",
    "ChannelData",
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
