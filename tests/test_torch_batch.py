"""The port's batch surface against frave_tpu's, on the CPU (the plain
version of every kernel): encode_pipeline_torch_batch, the batch
checks, each batched kernel's plain version against stacking its
one-image calls, and the tables' closed-form drain
(tests/test_torch_batch_stream.py has the decode batches and the
pipelined drivers). Tolerance 0 everywhere: every integer, byte and
pixel is equal.

A batch is the JAX package's: same shape and colorspace, one
EncoderOptions per encode batch (pinned parameters are shared by the
batch), each image its own transform and, on decode, its own quantizer.
"""

import dataclasses

import numpy as np
import pytest
import torch

from frave_tpu import EncoderOptions, RasterImage
from frave_tpu.codec import pipeline_jax as PJ
from frave_tpu.codec.container import serialize
from frave_tpu.fractal.schedule import default_num_lanes, get_schedule
from frave_tpu_torch import images as PI
from frave_tpu_torch import kernel_check as KC
from frave_tpu_torch.codec import options as PO
from frave_tpu_torch.codec import pipeline_torch as PT
from frave_tpu_torch.codec.container import deserialize as port_deserialize
from frave_tpu_torch.codec.container import serialize as port_serialize
from frave_tpu_torch.entropy import tables_torch as TT
from frave_tpu_torch.entropy.tables import _LAPLACE_GRID_ROWS
from frave_tpu_torch.testing import natural_image
from test_torch_pipeline import _natural, env, port_image, port_opts  # noqa: F401 (env: fixture)


def _pinned_batch_opts(img, nl, **kw):
    """EncoderOptions pinned to frave_tpu's jax fit of `img` at `nl` lanes:
    the parameters the whole batch shares."""
    ci = PJ.encode_pipeline_jax(img, EncoderOptions(num_lanes=nl, **kw))
    C = img.metadata.num_channels
    return EncoderOptions(
        num_lanes=nl,
        value_prediction_params=np.stack(
            [ci.channel_data[i].value_prediction_parameters for i in range(C)]
        ),
        width_prediction_params=np.stack(
            [ci.channel_data[i].width_prediction_parameters for i in range(C)]
        ),
        **kw,
    )


def _default_nl(h, w):
    return default_num_lanes(get_schedule(h, w, mode="grid").num_symbols)


# (h, w, c, images, FRAVE_GRID_ENC): 64x64 gray at B = 3; 96x80 RGB at
# B = 2 whose images pick different transforms (3 and 0); the
# strided-fit statistics at B = 2
BATCH_CASES = [(64, 64, 1, 3, "1"), (96, 80, 3, 2, "1"), (64, 64, 1, 2, "force")]


def _batch_images(h, w, c, n):
    if c == 3:  # natural_image picks YCoCg, _natural no transform
        return [natural_image(h, w, c, 30 + i) if i % 2 == 0 else _natural(h, w, c, 30 + i)
                for i in range(n)]
    return [natural_image(h, w, c, 30 + i) for i in range(n)]


@pytest.mark.parametrize("h,w,c,n,genc", BATCH_CASES)
def test_batch_containers_match_frave_tpu_and_b1(env, h, w, c, n, genc):  # noqa: F811
    """Pinned to one fit shared by the batch, the port's batch containers
    are byte-equal to frave_tpu's encode_pipeline_jax_batch and to the
    port's own one-image encodes; unpinned, the port's batch containers
    are byte-equal to its one-image containers (the fits do not depend on
    the batch) and decode to the images."""
    env.setenv("FRAVE_GRID_ENC", genc)
    if genc == "force":
        env.setenv("FRAVE_FIT_CAP", "700")
    pxs = _batch_images(h, w, c, n)
    imgs = [RasterImage.from_array(px) for px in pxs]
    if c == 3:
        tids = [PT.choose_transform(px, "auto", True) for px in pxs]
        assert len(set(tids)) > 1, tids
    opts = _pinned_batch_opts(imgs[0], _default_nl(h, w))
    blobs_j = [serialize(ci) for ci in PJ.encode_pipeline_jax_batch(imgs, opts)]
    port = [port_image(im) for im in imgs]
    cis = PT.encode_pipeline_torch_batch(port, port_opts(opts), "cpu")
    assert (PT.get_program(h, w, opts.num_lanes, c, "cpu").grid_enc is not None) == (
        genc == "force"
    )
    assert [port_serialize(ci) for ci in cis] == blobs_j
    for im, blob in zip(port, blobs_j):
        assert port_serialize(PT.encode_pipeline_torch(im, port_opts(opts), "cpu")) == blob

    free = PO.EncoderOptions()
    batch = [port_serialize(ci) for ci in PT.encode_pipeline_torch_batch(port, free, "cpu")]
    solo = [port_serialize(PT.encode_pipeline_torch(im, free, "cpu")) for im in port]
    assert batch == solo
    outs = PT.decode_pipeline_torch_batch([port_deserialize(b) for b in batch], "cpu")
    for px, out in zip(pxs, outs):
        np.testing.assert_array_equal(out.data, px)


def test_mixed_batches_raise():
    """A batch of two shapes (or colorspaces) raises ValueError, as does a
    decode batch of two lane counts and an empty batch."""
    a = PI.RasterImage.from_array(natural_image(64, 64, 1, 80))
    b = PI.RasterImage.from_array(natural_image(64, 96, 1, 81))
    rgb = PI.RasterImage.from_array(natural_image(64, 64, 3, 82))
    opts = PO.EncoderOptions()
    for batch in ([a, b], [a, rgb], []):
        with pytest.raises(ValueError):
            PT.encode_pipeline_torch_batch(batch, opts, "cpu")
    ci = PT.encode_pipeline_torch(a, opts, "cpu")
    other = PT.encode_pipeline_torch(a, dataclasses.replace(opts, num_lanes=64), "cpu")
    for batch in ([ci, PT.encode_pipeline_torch(b, opts, "cpu")], [ci, other], []):
        with pytest.raises(ValueError):
            PT.decode_pipeline_torch_batch(batch, "cpu")


def _split(a, b):
    """Image b of a batched operand (dicts of tables too)."""
    if isinstance(a, dict):
        return {k: v[b] for k, v in a.items()}
    return a[b]


# kernel -> (problem shape, kind, the operands that are per image: the
# rest, e.g. the row map, the masks and qdiv of kernel A, are shared)
PLAIN_CASES = {
    "forward_lift_quantize_pixels": ((96, 80, 3), (1, "lossy"), (0,)),
    "dequantize_inverse_lift_pixels": ((96, 80, 3), 2, (0, 3)),
    "encode_scan": ((20, 3, 64), None, (0, 1, 4, 5, 6)),
    "decode_scan_wave": ((12, 3, 64), "valid", (0, 1, 2, 4, 5)),
}


@pytest.mark.parametrize("name", sorted(PLAIN_CASES))
def test_batched_plain_kernel_equals_stacked_one_image_calls(name):
    """Each kernel's plain version on a batch of 3 (mixed transform ids and
    qdivs) equals its one-image calls stacked, every output."""
    shape, kind, per_image = PLAIN_CASES[name]
    plain = KC.KERNELS[name][1]
    args, extra = KC.problem(name, np.random.default_rng(5), shape, kind, "cpu", images=3)
    out = plain(*args, *extra)
    outs = out if isinstance(out, tuple) else (out,)
    for b in range(3):
        one = [_split(a, b) if i in per_image else a for i, a in enumerate(args)]
        ex = [int(e[b]) if isinstance(e, torch.Tensor) else e for e in extra]
        got = plain(*one, *ex)
        got = got if isinstance(got, tuple) else (got,)
        assert len(got) == len(outs)
        for g, o in zip(got, outs):
            assert torch.equal(g, o[b]), (name, b)


def _drain_loop(s, diff):
    """tables._normalize_freqs' drain as the loop it is."""
    while bool((diff < 0).any()):
        j = torch.argmax(s, dim=-1, keepdim=True)
        sj = torch.gather(s, -1, j)[..., 0]
        take = torch.clamp(torch.minimum(-diff, sj - 1), min=0)
        s = s.scatter_add(-1, j, -take[..., None])
        diff = diff + take
    return s


def test_drain_excess_closed_form_equals_loop():
    """finalize_contexts_device drains the normalisation's excess in closed
    form (no read of the device from the host): the same frequencies as
    the loop, on rows with ties, zeros and ones, excesses from none to all
    the rows can give; and finalized tables still sum to 2^bits."""
    rng = np.random.default_rng(9)
    rows = 600
    s = rng.integers(0, 6, size=(rows, 1024)) * (rng.random((rows, 1024)) < 0.3)
    s[:, 0] += rng.integers(0, 3000, size=rows)  # a large entry, sometimes tied
    s[rows // 2 :, 1] = s[rows // 2 :, 0]
    room = np.clip(s - 1, 0, None).sum(-1)
    diff = -np.floor(rng.random(rows) * (room + 1)).astype(np.int64)
    diff[:50] = 0
    diff[50:100] = -room[50:100]
    s, diff = torch.from_numpy(s), torch.from_numpy(diff)
    np.testing.assert_array_equal(TT.drain_excess(s, diff).numpy(), _drain_loop(s, diff).numpy())

    hist = torch.from_numpy(rng.integers(0, 3, size=(2, 15, 1024)) * (rng.random((2, 15, 1024)) < 0.9))
    bits, freqs, _, _ = TT.finalize_contexts_device(hist, torch.from_numpy(_LAPLACE_GRID_ROWS))
    np.testing.assert_array_equal(freqs.sum(-1).numpy(), (1 << bits).numpy())
