"""The port's batch decode and pipelined drivers against frave_tpu's, on
the CPU: decode_pipeline_torch_batch on a batch that mixes presets and
transforms, the _stream drivers, the device-verified round trip and the
flat image's re-encode inside a batch (tests/test_torch_batch.py has the
encode batches; a separate file so the two run on different test
workers). Tolerance 0: every byte and pixel is equal.
"""

import numpy as np

import frave_tpu
from frave_tpu import EncoderOptions, EncoderQuality, RasterImage
from frave_tpu.codec import pipeline_jax as PJ
from frave_tpu.codec.container import deserialize as jax_deserialize
from frave_tpu.codec.container import serialize
from frave_tpu_torch import images as PI
from frave_tpu_torch.codec import options as PO
from frave_tpu_torch.codec import pipeline_torch as PT
from frave_tpu_torch.codec.container import deserialize as port_deserialize
from frave_tpu_torch.codec.container import serialize as port_serialize
from frave_tpu_torch.testing import natural_image
from test_torch_batch import _default_nl


def test_decode_batch_mixed_quality_matches_frave_tpu():
    """One decode batch mixing LOSSLESS, HIGH and LOW containers and
    transforms (frave_tpu's, at one lane count) gives frave_tpu's
    decode_pipeline_jax_stream pixels, image by image, the lossless ones
    the input."""
    h, w = 96, 80
    nl = _default_nl(h, w)
    plan = [("LOSSLESS", "auto", 0), ("HIGH", "none", 1), ("LOW", "subtract-green", 2),
            ("LOSSLESS", "subtract-green", 3), ("HIGH", "auto", 4)]
    pxs, blobs = [], []
    for q, ctf, seed in plan:
        px = natural_image(h, w, 3, 40 + seed)
        opts = EncoderOptions(quality=EncoderQuality[q], color_transform=ctf, num_lanes=nl)
        pxs.append(px)
        blobs.append(serialize(PJ.encode_pipeline_jax(RasterImage.from_array(px), opts)))
    assert len({jax_deserialize(b).transform for b in blobs}) >= 3
    ref = PJ.decode_pipeline_jax_stream([jax_deserialize(b) for b in blobs], batch_size=5)
    outs = PT.decode_pipeline_torch_batch([port_deserialize(b) for b in blobs], "cpu")
    for (q, _, _), px, r, o in zip(plan, pxs, ref, outs):
        np.testing.assert_array_equal(o.data, r.data)
        assert np.array_equal(o.data, px) == (q == "LOSSLESS")


def test_stream_variants_keep_order():
    """encode_pipeline_torch_stream and decode_pipeline_torch_stream over 5
    images in batches of 2 (the last one short): the one-image containers
    and the images, in order."""
    pxs = [natural_image(64, 64, 1, 50 + i) for i in range(5)]
    imgs = [PI.RasterImage.from_array(px) for px in pxs]
    opts = PO.EncoderOptions()
    cis = PT.encode_pipeline_torch_stream(imgs, opts, batch_size=2, device="cpu")
    blobs = [port_serialize(ci) for ci in cis]
    assert blobs == [port_serialize(PT.encode_pipeline_torch(im, opts, "cpu")) for im in imgs]
    outs = PT.decode_pipeline_torch_stream(
        [port_deserialize(b) for b in blobs], batch_size=2, device="cpu"
    )
    for px, out in zip(pxs, outs):
        np.testing.assert_array_equal(out.data, px)


def test_roundtrip_stream_device_verify():
    """roundtrip_pipeline_torch_stream: with device_verify the mismatch
    count is 0 (lossless) and the count of differing pixels (lossy);
    without it, the decoded images (the input where lossless); the
    containers are the same either way and decode on frave_tpu."""
    pxs = [natural_image(64, 64, 1, 60 + i) for i in range(5)]
    imgs = [PI.RasterImage.from_array(px) for px in pxs]
    for q in ("LOSSLESS", "LOW"):
        opts = PO.EncoderOptions(quality=PO.EncoderQuality[q])
        blobs, outs = PT.roundtrip_pipeline_torch_stream(imgs, opts, batch_size=2, device="cpu")
        blobs2, mism = PT.roundtrip_pipeline_torch_stream(
            imgs, opts, batch_size=2, device="cpu", device_verify=True
        )
        assert blobs == blobs2 and len(blobs) == 5
        want = sum(int((o.data != px).sum()) for o, px in zip(outs, pxs))
        assert mism == want
        assert (mism == 0) == (q == "LOSSLESS")
        for blob, out in zip(blobs, outs):
            np.testing.assert_array_equal(frave_tpu.decode(blob, backend="numpy").data, out.data)


def test_flat_image_in_batch_reencodes_at_jax_lanes():
    """A flat image among natural ones: the batch re-encodes it alone at
    the rate-adaptive lane count frave_tpu's batch picks; the natural ones
    keep the default count."""
    flat = np.full((256, 256, 1), 77, dtype=np.uint8)
    flat[100:140, 60:200] = 200
    pxs = [natural_image(256, 256, 1, 70), flat]
    jax_cis = PJ.encode_pipeline_jax_batch([RasterImage.from_array(p) for p in pxs],
                                           EncoderOptions())
    cis = PT.encode_pipeline_torch_batch([PI.RasterImage.from_array(p) for p in pxs],
                                         PO.EncoderOptions(), "cpu")
    assert [c.num_lanes for c in cis] == [c.num_lanes for c in jax_cis]
    assert cis[1].num_lanes < cis[0].num_lanes == _default_nl(256, 256)
    for px, ci in zip(pxs, cis):
        np.testing.assert_array_equal(PT.decode_pipeline_torch(ci, "cpu").data, px)
