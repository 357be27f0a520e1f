"""The frave_tpu_torch slice end to end against frave_tpu, on the CPU.

Grid mode, LOSSLESS, gray and RGB, at 64x64 and 96x80 (both below the
K = 2^18 statistics gate, so the step-tensor statistics run; the dense
shift-plane statistics run in test_torch_grid_encode.py, which reuses
check_slice). Environment knobs are monkeypatched for both packages and
their program caches cleared around each case.

  * pinned predictor parameters: the port's packed encode output and
    histogram equal CodecProgram.encode_exec's bit for bit, except the
    one f32 expected-code-length word per channel (a float sum whose
    order differs), and the serialized containers are byte-equal;
  * unpinned: the fitted f16 wire parameters agree (see
    _assert_fits_agree for the tolerance and its reason);
  * containers cross-decode to identical pixels: the port's on
    frave_tpu's jax, numpy (and native, when built) decoders, and
    frave_tpu's on the port.

The port takes only its own EncoderOptions and RasterImage: port_opts
and port_image convert frave_tpu's field by field.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import frave_tpu
import frave_tpu_torch
from frave_tpu import EncoderOptions, RasterImage
from frave_tpu.codec import grid_decode as GDJ
from frave_tpu.codec import pipeline_jax as PJ
from frave_tpu.codec.channel_transform import choose_transform
from frave_tpu.codec.container import serialize
from frave_tpu.native import have_native
from frave_tpu_torch import images as PI
from frave_tpu_torch.codec import options as PO
from frave_tpu_torch.codec import pipeline_torch as PT
from frave_tpu_torch.codec.container import SerializeError
from frave_tpu_torch.codec.container import serialize as port_serialize

DATA = os.path.join(os.path.dirname(__file__), "data")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_opts(opts: EncoderOptions) -> PO.EncoderOptions:
    """frave_tpu's EncoderOptions as the port's, field by field (the
    fields the port has; the quality preset by name; frave_tpu's "jax",
    "numpy" and "auto" backends as the port's "auto", "native" as
    "native")."""
    kw = {f.name: getattr(opts, f.name) for f in dataclasses.fields(PO.EncoderOptions)}
    kw["quality"] = PO.EncoderQuality[opts.quality.name]
    kw["backend"] = "native" if opts.backend == "native" else "auto"
    return PO.EncoderOptions(**kw)


def port_image(img: RasterImage) -> PI.RasterImage:
    """frave_tpu's RasterImage as the port's (the colorspace by name)."""
    return PI.RasterImage.from_array(img.data, PI.ColorSpace[img.metadata.colorspace.name])


def _natural(h, w, c, seed):
    """Smooth gradients + low-amplitude noise (exercises the predictors)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (
        127
        + 90 * np.sin(xx / 17.0)[..., None]
        + 60 * np.cos(yy / 23.0)[..., None]
        + rng.normal(0, 4, size=(h, w, c))
    )
    return np.clip(base, 0, 255).astype(np.uint8)


def _clear_caches():
    PJ._program_cache.clear()
    GDJ._wavedev_cache.clear()
    PT._program_cache.clear()


@pytest.fixture
def env(monkeypatch):
    _clear_caches()
    yield monkeypatch
    monkeypatch.undo()
    _clear_caches()


def _f16_ulps(a, b):
    """Distance in f16 ulps (monotone integer map of the f16 bits)."""
    def key(x):
        i = np.asarray(x, np.float32).astype(np.float16).view(np.int16).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFF), i)

    return np.abs(key(a) - key(b))


def _assert_fits_agree(ci_t, ci_j, C):
    """Unpinned fits. Value parameters: within 1 f16 ulp (their normal
    equations have integer entries, exact in f32 at these sizes). Width
    parameters regress |residual| with f32 sums whose order differs
    between XLA and torch; for a group with few samples (level 1: ~2 per
    tile) the 6x6 system is near-singular and that rounding can move the
    f16 value by more than an ulp. So: within 1 ulp in all but at most one
    group per channel, and the container size within 1% (the width
    parameters shape only the rate)."""
    for c in range(C):
        dt, dj = ci_t.channel_data[c], ci_j.channel_data[c]
        uv = _f16_ulps(dt.value_prediction_parameters, dj.value_prediction_parameters)
        assert uv.max() <= 1, (c, uv.max(axis=1))
        uw = _f16_ulps(dt.width_prediction_parameters, dj.width_prediction_parameters)
        assert (uw.max(axis=1) > 1).sum() <= 1, (c, uw.max(axis=1))
    nt, nj = len(port_serialize(ci_t)), len(serialize(ci_j))
    assert abs(nt - nj) <= 0.01 * nj, (nt, nj)


def _decoders():
    out = ["jax", "numpy"]
    if have_native():
        out.append("native")
    return out


CASES = [
    (64, 64, 1, "1", 11),
    (64, 64, 3, "1", 12),
    (96, 80, 1, "1", 13),
    (96, 80, 3, "1", 14),
]


@pytest.mark.parametrize("h,w,c,genc,seed", CASES)
def test_slice_matches_frave_tpu(env, h, w, c, genc, seed):
    check_slice(env, h, w, c, genc, seed)


def check_slice(env, h, w, c, genc, seed):
    """One slice case (see the module docstring); FRAVE_GRID_ENC=genc."""
    env.setenv("FRAVE_GRID_ENC", genc)
    if genc == "force":
        env.setenv("FRAVE_FIT_CAP", "700")  # subsample the largest waves
    px = _natural(h, w, c, seed)
    img = RasterImage.from_array(px)
    opts = EncoderOptions()

    # --- unpinned: both fit, then cross-decode everywhere
    ci_j = PJ.encode_pipeline_jax(img, opts)
    ci_t = PT.encode_pipeline_torch(port_image(img), port_opts(opts), "cpu")
    assert ci_t.num_lanes == ci_j.num_lanes and ci_t.transform == ci_j.transform
    prog_t = PT.get_program(h, w, ci_t.num_lanes, c, "cpu")
    assert (prog_t.grid_enc is not None) == (genc == "force")
    _assert_fits_agree(ci_t, ci_j, c)
    blob_t, blob_j = port_serialize(ci_t), serialize(ci_j)
    for backend in _decoders():
        out = frave_tpu.decode(blob_t, backend=backend)
        np.testing.assert_array_equal(out.data, px, err_msg=backend)
    np.testing.assert_array_equal(frave_tpu_torch.decode(blob_j, device="cpu").data, px)
    np.testing.assert_array_equal(frave_tpu_torch.decode(blob_t, device="cpu").data, px)

    # --- pinned to the JAX fit: packed output and containers bit-equal
    nl = ci_j.num_lanes
    vp = np.stack([ci_j.channel_data[i].value_prediction_parameters for i in range(c)])
    wp = np.stack([ci_j.channel_data[i].width_prediction_parameters for i in range(c)])
    opts_p = EncoderOptions(
        num_lanes=nl, value_prediction_params=vp, width_prediction_params=wp
    )
    ovr = opts_p.prediction_overrides(c)
    tid = choose_transform(px, "auto", True) if c == 3 else 0
    qdiv = PT._qdiv_array(np.ones(32, np.int32), 9)
    prog_j = PJ.get_program(h, w, 9, nl, c, "grid")
    packed_j, hist_j = prog_j.encode_exec(
        jnp.asarray(px.reshape(1, -1, c)), jnp.asarray(qdiv), ovr,
        tids=jnp.asarray([tid], jnp.int32),
    )
    packed_t, hist_t = prog_t.encode_exec(
        torch.from_numpy(px.reshape(1, -1, c).copy()), torch.from_numpy(qdiv), ovr,
        torch.tensor([tid], dtype=torch.int32),
    )
    packed_j = np.asarray(packed_j)[0]
    packed_t = packed_t.numpy()[0]
    assert packed_t.shape == packed_j.shape
    exp_bits_words = [(i + 1) * prog_t.chan_hdr - 1 for i in range(c)]
    keep = np.ones(packed_t.shape[0], dtype=bool)
    keep[exp_bits_words] = False
    np.testing.assert_array_equal(packed_t[keep], packed_j[keep])
    np.testing.assert_allclose(
        packed_t[exp_bits_words].view(np.float32),
        packed_j[exp_bits_words].view(np.float32), rtol=1e-5,
    )
    np.testing.assert_array_equal(hist_t.numpy()[0], np.asarray(hist_j)[0])
    blob_tp = port_serialize(PT.encode_pipeline_torch(port_image(img), port_opts(opts_p), "cpu"))
    blob_jp = serialize(PJ.encode_pipeline_jax(img, opts_p))
    assert blob_tp == blob_jp


PRESET_CASES = (
    [(64, 64, 1, q, "auto") for q in ("LOSSLESS", "HIGH", "MEDIUM", "LOW")]
    + [(96, 80, 3, q, "auto") for q in ("LOSSLESS", "HIGH", "MEDIUM", "LOW")]
    + [(96, 80, 3, "LOSSLESS", t) for t in ("none", "subtract-green", "ycocg")]
    + [(96, 80, 3, "HIGH", t) for t in ("none", "subtract-green")]  # clamped
)


def _pinned_opts(img, quality, **kw):
    """EncoderOptions pinned to frave_tpu's jax fit for `img` at `quality`,
    at the shape's default lane count (pinned lanes skip the rate-adaptive
    re-encode, so every preset of a shape shares one program)."""
    from frave_tpu.fractal.schedule import default_num_lanes, get_schedule

    meta = img.metadata
    C = meta.num_channels
    nl = default_num_lanes(get_schedule(meta.height, meta.width, mode="grid").num_symbols)
    ci_j = PJ.encode_pipeline_jax(img, EncoderOptions(quality=quality, num_lanes=nl, **kw))
    return EncoderOptions(
        quality=quality, num_lanes=nl,
        value_prediction_params=np.stack(
            [ci_j.channel_data[i].value_prediction_parameters for i in range(C)]
        ),
        width_prediction_params=np.stack(
            [ci_j.channel_data[i].width_prediction_parameters for i in range(C)]
        ),
        **kw,
    )


@pytest.mark.parametrize("h,w,c,quality,ctf", PRESET_CASES)
def test_lossy_preset_matches_frave_tpu(h, w, c, quality, ctf):
    """Every preset at gray and RGB, and each explicit RGB transform (the
    lossy ones clamped): pinned containers byte-equal to frave_tpu's, and
    the port decodes them to frave_tpu's jax pixels — the input only where
    the preset is lossless. The program caches are kept across cases: the
    preset and transform are run-time inputs of one program per shape."""
    from frave_tpu import EncoderQuality

    q = EncoderQuality[quality]
    px = _natural(h, w, c, 21)
    img = RasterImage.from_array(px)
    opts = _pinned_opts(img, q, color_transform=ctf)
    ci_t = PT.encode_pipeline_torch(port_image(img), port_opts(opts), "cpu")
    if c == 3:
        assert ci_t.transform == choose_transform(px, ctf, quality == "LOSSLESS")
    blob_t = port_serialize(ci_t)
    assert blob_t == serialize(PJ.encode_pipeline_jax(img, opts))
    ref = frave_tpu.decode(blob_t, backend="jax").data
    assert np.array_equal(ref, px) == (quality == "LOSSLESS")
    np.testing.assert_array_equal(frave_tpu_torch.decode(blob_t, device="cpu").data, ref)


@pytest.mark.parametrize("c,quality", [(3, "LOSSLESS"), (3, "LOW"), (1, "LOSSLESS")])
def test_trial_transform_matches_frave_tpu(c, quality):
    """color_transform="trial": with pinned parameters the port's encoder
    keeps the same container as frave_tpu's FRIEncoder (the smallest of
    the candidate transforms); a gray image has no transform to try and
    encodes as with any other policy."""
    from frave_tpu import EncoderQuality
    from frave_tpu.codec.encoder import FRIEncoder

    px = _natural(96, 80, c, 22)
    img = RasterImage.from_array(px)
    opts = _pinned_opts(img, EncoderQuality[quality])
    opts = dataclasses.replace(opts, color_transform="trial", backend="jax")
    blob_t = frave_tpu_torch.encode(port_image(img), port_opts(opts), device="cpu")
    assert blob_t == FRIEncoder(opts).encode(img)
    if c == 1:
        auto = port_opts(dataclasses.replace(opts, color_transform="auto"))
        assert blob_t == frave_tpu_torch.encode(port_image(img), auto, device="cpu")


def test_flat_content_reencodes_at_rate_adaptive_lanes(env):
    """Flat content: the expected payload (computed on the device) is tiny,
    so the encode is redone at schedule.rate_adaptive_lanes' lane count."""
    from frave_tpu.fractal.schedule import default_num_lanes, get_schedule

    px = np.full((256, 256, 1), 77, dtype=np.uint8)
    px[100:140, 60:200] = 200
    ci = PT.encode_pipeline_torch(PI.RasterImage.from_array(px), PO.EncoderOptions(), "cpu")
    assert ci.num_lanes < default_num_lanes(get_schedule(256, 256, mode="grid").num_symbols)
    out = frave_tpu.decode(port_serialize(ci), backend="numpy")
    np.testing.assert_array_equal(out.data, px)


def test_program_constants_match_jax(env):
    h, w, c, nl = 64, 64, 1, 32
    pj = PJ.get_program(h, w, 9, nl, c, "grid")
    pt = PT.CodecProgram.from_host(h, w, nl, c, "cpu")
    # the leaf gather and mask are kernel A's pixel map, leaf_pix
    lp = pt.leaf_pix.numpy().astype(np.int64).reshape(pt.num_tiles, -1)
    enc = (np.where(lp >= 0, lp, 0), lp >= 0, pt.sc, pt.snbr_safe, pt.slf, pt.sgrp,
           pt.sfbkt, pt.lap, pt.glog2, pt.gzero)  # pipeline_jax's _enc_args order
    assert len(enc) == len(pj._enc_args)
    for a, b in zip(enc, pj._enc_args):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip((pt.pix_inv, pt.node_mask, pt.leaf_mask_u8.bool()), pj._dec_args[6:9]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (pt.rows, pt.hdr_words, pt.kc) == (pj.rows, pj.hdr_words, pj.kc)
    assert pt.group_ranges == pj._group_ranges


@pytest.mark.parametrize("h,w", [(64, 64), (96, 80)])
def test_program_pixel_map_is_a_bijection(env, h, w):
    """leaf_pix (kernel B's scatter) and pix_inv (the gather it replaces)
    are inverse maps on the programs of the tests' shapes, and a map that
    hits a pixel twice or misses one is refused."""
    pt = PT.CodecProgram.from_host(h, w, 32, 1, "cpu")
    lp, inv = pt.leaf_pix.numpy(), pt.pix_inv.numpy()
    inb = lp >= 0
    np.testing.assert_array_equal(np.sort(lp[inb]), np.arange(h * w))
    np.testing.assert_array_equal(lp[inv], np.arange(h * w))
    np.testing.assert_array_equal(PT.pixel_inverse(lp, h * w), inv)
    bad = lp.copy()
    bad[np.nonzero(inb)[0][:2]] = lp[np.nonzero(inb)[0][0]]  # one pixel twice
    with pytest.raises(AssertionError):
        PT.pixel_inverse(bad, h * w)
    with pytest.raises(AssertionError):
        PT.pixel_inverse(lp, h * w - 1)  # a leaf past the last pixel


@pytest.mark.parametrize("name", ["v9grid_gray", "v9grid_rgb"])
def test_golden_grid_fixtures_decode(name):
    blob = open(os.path.join(DATA, f"{name}.frv"), "rb").read()
    ref = np.load(os.path.join(DATA, f"{name}.npy"))
    np.testing.assert_array_equal(frave_tpu_torch.decode(blob, device="cpu").data, ref)


def test_byte_flips_decode_without_crash():
    """The robustness contract: a corrupted payload decodes to a garbage
    image of the right shape or raises a typed error — never crashes."""
    rng = np.random.default_rng(3)
    arr = rng.integers(0, 256, size=(40, 40, 1), dtype=np.uint8)
    data = frave_tpu_torch.encode(arr, device="cpu")
    decoded = 0
    for t in range(10):
        b = bytearray(data)
        pos = int(rng.integers(90, len(data)))
        b[pos] ^= 1 << int(rng.integers(0, 8))
        try:
            out = frave_tpu_torch.decode(bytes(b), device="cpu")
            assert out.data.shape == arr.shape
            decoded += 1
        except (SerializeError, ValueError) as e:
            assert str(e)
    assert decoded >= 5


def test_unported_shapes_and_devices_raise():
    """Every mode and shape is ported: a grid shape with no dense lattice
    builds a step-tensor program, and only an unknown mode, a foreign
    options class or a missing device raises."""
    assert PT.get_program(16, 16, 16, 1, "cpu").steps is not None  # no dense lattice grid
    with pytest.raises(ValueError):
        frave_tpu_torch.encode(
            np.zeros((64, 64), np.uint8), PO.EncoderOptions(mode="diagonal"), device="cpu"
        )
    with pytest.raises(TypeError):  # the port takes only its own options
        frave_tpu_torch.encode(np.zeros((64, 64), np.uint8), EncoderOptions(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            frave_tpu_torch.encode(np.zeros((64, 64), np.uint8), device="cuda")


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "assert 'jax' not in sys.modules\n"
        "import numpy as np, frave_tpu_torch\n"
        "rng = np.random.default_rng(0)\n"
        "px = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)\n"
        "out = frave_tpu_torch.decode(frave_tpu_torch.encode(px, device='cpu'), device='cpu')\n"
        "assert np.array_equal(out.data, px)\n"
        "assert 'jax' not in sys.modules, 'the port imported jax'\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
