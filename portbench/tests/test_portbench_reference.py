"""The plain reference decodes the port's containers losslessly, refuses
corrupted ones and those of a mode or quality it does not hold, and its
float16 control decodes them wrongly."""

import numpy as np
import pytest

from portbench.core import manifest as M
from portbench.core.pool import natural_image
from portbench.reference import decode as R

J = M.load_judge("lossless")

SHAPES = [(256, 256, 1), (96, 160, 3)]


@pytest.fixture(scope="module")
def containers():
    import frave_tpu_torch as F

    out = {}
    for h, w, c in SHAPES:
        img = natural_image(h, w, c, [11, h])
        out[(h, w, c)] = (img, F.encode(img, F.EncoderOptions(), device="cpu"))
    return out


@pytest.mark.parametrize("shape", SHAPES)
def test_reference_decodes_port_containers_losslessly(containers, shape):
    img, blob = containers[shape]
    assert np.array_equal(R.decode(blob), img)
    assert J.reference_px_wrong(blob, img) == 0


@pytest.mark.parametrize("shape", SHAPES)
def test_reference_refuses_corrupted_container(containers, shape):
    img, blob = containers[shape]
    bad = bytearray(blob)
    bad[len(bad) // 2] ^= 0x5A  # a stream word
    assert J.reference_px_wrong(bytes(bad), img) > 0
    assert J.reference_px_wrong(b"frif" + blob[4:12], img) == img.size  # cut short
    assert J.reference_px_wrong(b"XXXX" + blob[4:], img) == img.size  # bad magic


@pytest.mark.parametrize("shape", SHAPES)
def test_float16_control_fails(containers, shape):
    img, blob = containers[shape]
    wrong = J.reference_px_wrong(blob, img, np.float16)
    assert wrong > img.size // 10


@pytest.mark.parametrize("shape,opts", [
    ((96, 160, 3), {"color_transform": "none"}),
    ((96, 160, 3), {"color_transform": "subtract-green"}),
    ((96, 160, 3), {"color_transform": "ycocg"}),
    ((16, 16, 1), {}),
    ((2, 511, 1), {}),
])
def test_reference_decodes_every_transform_and_grid_shape(shape, opts):
    """Every channel transform a lossless grid configuration may choose,
    down to the tiny grid shapes, as the port decodes them."""
    import frave_tpu_torch as F

    h, w, c = shape
    img = natural_image(h, w, c, [6, h, w])
    blob = F.encode(img, F.EncoderOptions(**opts), device="cpu")
    port = F.decode(blob, device="cpu").data.reshape(h, w, c)
    assert np.array_equal(R.decode(blob), port)
    assert np.array_equal(port, img)


@pytest.mark.parametrize("opts", [{"mode": "parity"}, {"mode": "parallel"},
                                  {"quality": "HIGH"}])
def test_reference_refuses_what_no_configuration_states(opts):
    """Other modes and lossy presets are refused, and count every pixel
    wrong: a configuration that states one brings its decode."""
    import frave_tpu_torch as F

    img = natural_image(64, 64, 1, [7])
    if "quality" in opts:
        opts = dict(opts, quality=F.EncoderQuality[opts["quality"]])
    blob = F.encode(img, F.EncoderOptions(**opts), device="cpu")
    with pytest.raises(ValueError):
        R.decode(blob)
    assert J.reference_px_wrong(blob, img) == img.size
