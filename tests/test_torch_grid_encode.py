"""The slice cross-checks of test_torch_pipeline.py (check_slice) with
FRAVE_GRID_ENC=force: grid mode's statistics with strided fits
(CodecProgram._grid_stats) at 96x80, gray and RGB, with a fit cap small
enough that the largest waves are subsampled. A separate file so
the JAX compiles of these cases run on another test worker."""

import numpy as np
import pytest

from test_torch_pipeline import check_slice, env  # noqa: F401  (env: fixture)


@pytest.mark.parametrize("c,seed", [(1, 15), (3, 16)])
def test_grid_encode_slice_matches_frave_tpu(env, c, seed):  # noqa: F811
    check_slice(env, 96, 80, c, "force", seed)


@pytest.mark.parametrize("quality", ["HIGH", "LOW"])
def test_grid_encode_rgb_lossy_matches_frave_tpu(env, quality):  # noqa: F811
    """RGB lossy on the strided-fit statistics, with the clamped
    subtract-green transform: pinned to frave_tpu's fit, the container is
    byte-equal to frave_tpu's; unpinned, each package decodes the other's
    container to the pixels its own decoder gives."""
    import frave_tpu
    import frave_tpu_torch
    from frave_tpu import EncoderOptions, EncoderQuality, RasterImage
    from frave_tpu.codec import pipeline_jax as PJ
    from frave_tpu.codec.container import serialize
    from frave_tpu_torch.codec import pipeline_torch as PT
    from frave_tpu_torch.codec.container import serialize as port_serialize
    from test_torch_pipeline import _natural, _pinned_opts, port_image, port_opts

    env.setenv("FRAVE_GRID_ENC", "force")
    env.setenv("FRAVE_FIT_CAP", "700")
    px = _natural(96, 80, 3, 17 + (quality == "LOW"))
    img = RasterImage.from_array(px)
    q = EncoderQuality[quality]
    opts = _pinned_opts(img, q, color_transform="subtract-green")
    ci_t = PT.encode_pipeline_torch(port_image(img), port_opts(opts), "cpu")
    assert ci_t.transform == 2  # subtract-green, clamped at a lossy preset
    assert PT.get_program(96, 80, opts.num_lanes, 3, "cpu").grid_enc is not None
    assert port_serialize(ci_t) == serialize(PJ.encode_pipeline_jax(img, opts))

    free = EncoderOptions(quality=q, color_transform="subtract-green")
    blob_t = port_serialize(PT.encode_pipeline_torch(port_image(img), port_opts(free), "cpu"))
    blob_j = serialize(PJ.encode_pipeline_jax(img, free))
    for blob in (blob_t, blob_j):
        ref = frave_tpu.decode(blob, backend="jax").data
        assert not np.array_equal(ref, px)
        np.testing.assert_array_equal(frave_tpu_torch.decode(blob, device="cpu").data, ref)
