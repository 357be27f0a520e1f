"""The port's stream path at a lossy preset, the path of the benchmark's
gray512_lossy.bulk16 cell.

  * on the CPU, a 64x64 gray stream round trip at MEDIUM counts every
    image in pipeline_torch.quantized_images on both sides (a LOSSLESS one
    counts none), and decodes to exactly frave_tpu's round trip through
    the preset's table (frave_tpu/ops/lifting.py);
  * the benchmark's frozen copy of that round trip
    (portbench/reference/quantization.py) equals frave_tpu's at 512x512
    gray for every preset, so the card test below may use it: the card's
    machine runs no part of frave_tpu;
  * on the card, 512x512 gray at MEDIUM in batches of 16 through
    roundtrip_pipeline_torch_stream decodes to exactly that round trip,
    and the port's CPU path decodes the card's containers to the same
    pixels. Run it there with `python -m pytest tests/test_torch_lossy_stream.py -q -m cuda`.
"""

import numpy as np
import pytest
import torch

from frave_tpu_torch.codec import pipeline_torch as PT
from frave_tpu_torch.codec.container import deserialize
from frave_tpu_torch.codec.options import EncoderOptions, EncoderQuality
from frave_tpu_torch.images import RasterImage
from frave_tpu_torch.testing import natural_image


def _frave_tpu_round_trip(img: np.ndarray, preset: str) -> np.ndarray:
    """clip(inverse_lift(dequantize(quantize(forward_lift(img))))) of a gray
    [h, w, 1] image, by frave_tpu's own host functions."""
    from frave_tpu.codec.options import EncoderQuality as Q
    from frave_tpu.codec.options import quantization_matrix
    from frave_tpu.fractal.geometry import get_geometry
    from frave_tpu.ops import lifting as L

    h, w, _ = img.shape
    geo = get_geometry(h, w)
    qm = quantization_matrix(Q[preset])
    q = L.quantize_np(L.forward_lifting_np(img.reshape(1, h * w).astype(np.int64), geo), qm, geo)
    return L.inverse_lifting_np(L.dequantize_np(q, qm, geo), geo).reshape(h, w, 1)


@pytest.mark.parametrize("quality", ["MEDIUM", "LOSSLESS"])
def test_stream_counts_quantized_images_and_decodes_the_round_trip(quality):
    imgs = [natural_image(64, 64, 1, seed=40 + i) for i in range(5)]
    opts = EncoderOptions(quality=EncoderQuality[quality])
    before = dict(PT.quantized_images)
    blobs, outs = PT.roundtrip_pipeline_torch_stream(
        [RasterImage.from_array(a) for a in imgs], opts, batch_size=2, device="cpu")
    got = {k: PT.quantized_images[k] - before[k] for k in before}
    n = len(imgs) if quality != "LOSSLESS" else 0
    assert got == {"encode": n, "decode": n}
    for img, blob, out in zip(imgs, blobs, outs):
        want = _frave_tpu_round_trip(img, quality)
        np.testing.assert_array_equal(out.data.reshape(64, 64, 1), want)
        assert deserialize(blob).quality == EncoderQuality[quality].value
    if quality != "LOSSLESS":
        assert not all(np.array_equal(o.data.reshape(64, 64, 1), a) for o, a in zip(outs, imgs))


def test_benchmark_round_trip_is_frave_tpus():
    from portbench.reference.quantization import expected_round_trip

    img = natural_image(512, 512, 1, seed=41)
    for preset in ("LOW", "MEDIUM", "HIGH", "LOSSLESS"):
        np.testing.assert_array_equal(expected_round_trip(img, preset),
                                      _frave_tpu_round_trip(img, preset))


@pytest.mark.cuda
def test_cuda_stream_at_medium_decodes_the_round_trip():
    """16 a batch at 512x512 gray MEDIUM, as the benchmark's cell: the
    card's decodes are the preset's round trip, every image counted as
    quantized on both sides, and the CPU decodes the card's containers
    to the same pixels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    from portbench.reference.quantization import expected_round_trip

    imgs = [natural_image(512, 512, 1, seed=50 + i) for i in range(32)]
    opts = EncoderOptions(quality=EncoderQuality.MEDIUM)
    before = dict(PT.quantized_images)
    blobs, outs = PT.roundtrip_pipeline_torch_stream(
        [RasterImage.from_array(a) for a in imgs], opts, batch_size=16, device="cuda")
    assert {k: PT.quantized_images[k] - before[k] for k in before} == {"encode": 32,
                                                                      "decode": 32}
    cpu = PT.decode_pipeline_torch_batch([deserialize(b) for b in blobs[:16]], "cpu")
    for i, (img, out) in enumerate(zip(imgs, outs)):
        want = expected_round_trip(img, "MEDIUM")
        np.testing.assert_array_equal(out.data.reshape(512, 512, 1), want)
        if i < len(cpu):
            np.testing.assert_array_equal(cpu[i].data.reshape(512, 512, 1), want)
