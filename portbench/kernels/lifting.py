"""The bytes that the lifting kernels' work needs in a traced stream call,
counted from the work and not from any kernel's operands, so that the
share reads the same work whatever implements it.

Each traced batch is encoded once and decoded once. For each image and
channel, from the containers alone (parsed by the plain reference) and
the reference's geometry of their shape:
- the forward lifting and quantize read each pixel at a byte and write
  each present node's coefficient at 2 bytes (a quantized coefficient of
  8-bit pixels is at most 255 in magnitude);
- the dequantize and inverse lifting read each present node's
  coefficient at 2 bytes and write each pixel at a byte;
and for each batch, each side reads each quantization matrix of its
images once, each divisor at 2 bytes (as the container carries them).
What a kernel of today moves besides (4-byte coefficients, the leaf
map, the node masks, a divisor for each of a tile's 512 nodes) is not
work: it is what a better kernel would not move.
"""

import numpy as np

from portbench.reference import container, geometry

PIXEL_BYTES = 1
COEF_BYTES = 2
DIVISOR_BYTES = 2
SIDES = 2  # the encode's kernel A and the decode's kernel B


def pixels_and_nodes(height: int, width: int):
    """Pixels of an image channel, and its present coefficient nodes."""
    geo = geometry.get_geometry(height, width)
    return height * width, int(np.count_nonzero(geo.coef_mask))


def batch_bytes(blobs) -> int:
    """One batch: the images encoded together, then decoded together."""
    total = 0
    tables = set()
    for blob in blobs:
        ci = container.deserialize(blob)
        meta = ci.metadata
        px, nodes = pixels_and_nodes(meta.height, meta.width)
        total += SIDES * meta.num_channels * (PIXEL_BYTES * px + COEF_BYTES * nodes)
        tables.add(tuple(int(q) for q in ci.quantization_matrix))
    return total + SIDES * DIVISOR_BYTES * sum(len(t) for t in tables)


def bytes_needed(batches) -> int:
    """The profiled pass's batches (core.loop.Batch)."""
    return sum(batch_bytes(b.blobs) for b in batches)
