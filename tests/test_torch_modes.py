"""The step-tensor codec of frave_tpu_torch against frave_tpu, on the CPU.

The parallel and parity modes at 64x64 gray and 96x80 RGB, and grid mode
at tiny shapes: 16x16 and 1x1, which have no dense lattice and decode over
step tensors like the other two modes (kernel D on the card,
decode_steps_plain here), and 2x511 and 511x2, which keep grid mode's dense
decode. The same seeded numpy images go through both packages; the
tolerance is exact everywhere but the unpinned fits: frave_tpu solves the
normal equations in f32, the port in f64 (so that an image's fit does not
depend on its batch), and where a group has few samples or correlated taps
the f16 wire values differ by several ulps (up to 192 at 16x16, 7 on one
group of 96x80 RGB parity). Unpinned, the containers must therefore be
within 1% in size (and 8 bytes) and cross-decode to the input; every
other comparison is bit for bit, the fits pinned:

  * intermediates: the program's step tensors and stream permutation
    equal pipeline_jax.CodecProgram's decode arguments and rank array;
    the encode's buckets and symbols equal jax_ops.contexts on the same
    taps; the packed encode output (headers, lane states, the compacted
    stream) and the histogram equal CodecProgram.encode_exec's, but for
    the f32 expected-code-length word; decode_steps_plain's plane, final
    lane states and stream position equal a jax scan of decode_fused's
    body (pipeline_jax.py:820-868) on the same wire;
  * containers cross-decode to identical pixels: the port's on
    frave_tpu's jax and numpy decoders, frave_tpu's jax container on the
    port;
  * pinned containers are byte-equal to frave_tpu's jax backend's.

Also: the four v7/v8 fixtures decode to their .npy, a batch of 3 decodes
as three one-image decodes, corrupted parity streams decode without a
crash, and the host check that kernel D's one barrier a step relies on.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import frave_tpu
import frave_tpu_torch
from frave_tpu import EncoderOptions, RasterImage
from frave_tpu.codec import pipeline_jax as PJ
from frave_tpu.codec.channel_transform import choose_transform
from frave_tpu.codec.container import serialize
from frave_tpu.entropy.tables import CONTEXT_AMOUNT
from frave_tpu.entropy.tables_jax import finalize_contexts_device
from frave_tpu.ops import jax_ops as J
from frave_tpu.ops.rans_jax import build_merged_decode_table, decode_step_merged
from frave_tpu.ops.rans_jax import stream_compact as stream_compact_jax
from frave_tpu_torch.codec import pipeline_torch as PT
from frave_tpu_torch.codec.container import SerializeError
from frave_tpu_torch.codec.container import deserialize as port_deserialize
from frave_tpu_torch.codec.container import serialize as port_serialize
from frave_tpu_torch.fractal import schedule as ST
from frave_tpu_torch.ops import lifting as L
from frave_tpu_torch.ops import rans_torch as RT
from frave_tpu_torch.ops import step_decode as SD
from test_torch_pipeline import _natural, port_image, port_opts

DATA = os.path.join(os.path.dirname(__file__), "data")

CASES = [
    (64, 64, 1, "parallel", 41),
    (64, 64, 1, "parity", 42),
    (96, 80, 3, "parallel", 43),
    (96, 80, 3, "parity", 44),
    (16, 16, 1, "grid", 45),
    (16, 16, 3, "grid", 46),
    (1, 1, 1, "grid", 47),
    (1, 1, 3, "grid", 48),
    (2, 511, 1, "grid", 49),
    (511, 2, 3, "grid", 50),
]
# the cases that decode over step tensors (2x511 and 511x2 have a dense
# lattice: grid_decode's waves and kernel 3 decode them)
STEP_CASES = [case for case in CASES if case[:2] not in ((2, 511), (511, 2))]


@pytest.fixture
def env(monkeypatch):
    PJ._program_cache.clear()
    PT._program_cache.clear()
    yield monkeypatch
    PJ._program_cache.clear()
    PT._program_cache.clear()


def _pinned(img, mode):
    """frave_tpu's jax fit of `img` in `mode` as pinned EncoderOptions (its
    lane count, value and width parameters)."""
    C = img.metadata.num_channels
    ci = PJ.encode_pipeline_jax(img, EncoderOptions(mode=mode))
    return ci, EncoderOptions(
        mode=mode, num_lanes=ci.num_lanes,
        value_prediction_params=np.stack([ci.channel_data[i].value_prediction_parameters
                                          for i in range(C)]),
        width_prediction_params=np.stack([ci.channel_data[i].width_prediction_parameters
                                          for i in range(C)]),
    )


@pytest.mark.parametrize("h,w,c,mode,seed", CASES)
def test_mode_matches_frave_tpu(env, h, w, c, mode, seed):
    """Unpinned: both fit, the containers cross-decode to the input on
    every decoder. Pinned: the packed encode output and histogram equal
    encode_exec's, the containers are byte-equal."""
    px = _natural(h, w, c, seed)
    img = RasterImage.from_array(px)
    ci_j, opts_p = _pinned(img, mode)
    ci_t = PT.encode_pipeline_torch(port_image(img), port_opts(EncoderOptions(mode=mode)), "cpu")
    assert (ci_t.mode, ci_t.num_lanes, ci_t.transform) == (mode, ci_j.num_lanes, ci_j.transform)
    blob_t, blob_j = port_serialize(ci_t), serialize(ci_j)
    assert abs(len(blob_t) - len(blob_j)) <= 0.01 * len(blob_j) + 8, (len(blob_t), len(blob_j))
    for backend in ("jax", "numpy"):
        np.testing.assert_array_equal(frave_tpu.decode(blob_t, backend=backend).data, px,
                                      err_msg=backend)
    np.testing.assert_array_equal(frave_tpu_torch.decode(blob_j, device="cpu").data, px)

    nl = ci_j.num_lanes
    ovr = opts_p.prediction_overrides(c)
    tid = choose_transform(px, "auto", True) if c == 3 else 0
    qdiv = PT._qdiv_array(np.ones(32, np.int32), 9)
    prog_j = PJ.get_program(h, w, 9, nl, c, mode)
    prog_t = PT.get_program(h, w, nl, c, "cpu", mode)
    packed_j, hist_j = prog_j.encode_exec(jnp.asarray(px.reshape(1, -1, c)), jnp.asarray(qdiv),
                                          ovr, tids=jnp.asarray([tid], jnp.int32))
    packed_t, hist_t = prog_t.encode_exec(torch.from_numpy(px.reshape(1, -1, c).copy()),
                                          torch.from_numpy(qdiv), ovr,
                                          torch.tensor([tid], dtype=torch.int32))
    packed_j, packed_t = np.asarray(packed_j)[0], packed_t.numpy()[0]
    assert packed_t.shape == packed_j.shape
    keep = np.ones(packed_t.shape[0], dtype=bool)
    keep[[(i + 1) * prog_t.chan_hdr - 1 for i in range(c)]] = False  # f32 code-length words
    np.testing.assert_array_equal(packed_t[keep], packed_j[keep])
    np.testing.assert_array_equal(hist_t.numpy()[0], np.asarray(hist_j)[0])
    blob_tp = port_serialize(PT.encode_pipeline_torch(port_image(img), port_opts(opts_p), "cpu"))
    assert blob_tp == serialize(PJ.encode_pipeline_jax(img, opts_p))


@pytest.mark.parametrize("h,w,c,mode,seed", STEP_CASES)
def test_step_tensors_and_stream_perm_match(env, h, w, c, mode, seed):
    """The program's step operands, laid out by lane (step_decode.lane_grid),
    are pipeline_jax's decode arguments (inactive lanes and absent taps
    there point at the zero slot n_slots; a tap is named by the slot of
    the schedule symbol that writes it, and a slot no symbol writes reads
    0 as the zero slot does), its stream permutation the inverse of
    pipeline_jax's rank array."""
    nl = ST.default_num_lanes(ST.get_schedule(h, w, mode=mode).num_symbols)
    prog_j = PJ.get_program(h, w, 9, nl, c, mode)
    prog_t = PT.get_program(h, w, nl, c, "cpu", mode)
    n = prog_t.n_slots
    _, grid = SD.lane_grid(prog_t.steps)
    grid = grid.numpy()
    coef, taps = grid[..., 0], grid[..., 1:7]
    lf, grp, fbkt = (a.numpy() for a in SD.unpack_meta(torch.from_numpy(grid[..., 7])))
    d_coef, d_active, d_nbr, d_lf, d_grp, d_fbkt = (np.asarray(a) for a in prog_j._dec_args[:6])
    np.testing.assert_array_equal(np.where(coef >= 0, coef, n), d_coef)
    np.testing.assert_array_equal(coef >= 0, d_active)
    writer_slot = prog_t.steps.rec[:, 0].numpy()
    written = np.zeros(n + 1, bool)
    written[writer_slot] = True
    np.testing.assert_array_equal(np.where(taps >= 0, writer_slot[np.clip(taps, 0, None)], n),
                                  np.where(written[d_nbr], d_nbr, n))
    np.testing.assert_array_equal(lf, d_lf)
    np.testing.assert_array_equal(grp, d_grp)
    np.testing.assert_array_equal(fbkt, d_fbkt)
    assert prog_t.rows == prog_j.rows and prog_t.num_steps == prog_j.num_steps
    rank = np.asarray(prog_j._inv_perm)
    if mode == "grid":
        assert prog_t.perm is None  # flat grid order
        perm = ST.get_stream_perm(h, w, nl, mode=mode, channels=c)
    else:
        perm = prog_t.perm.numpy()
    np.testing.assert_array_equal(rank[perm], np.arange(perm.shape[0]))


def _jax_step_scan(prog_j, wire, lut_bits):
    """decode_fused's scan body (pipeline_jax.py:820-868) on an int32 plane,
    one image: -> (plane [C, n_slots], final states, stream position)."""
    states, stream, bits, offpk, scales, vp, wp = wire
    C, nl, n_slots = prog_j.channels, prog_j.nl, prog_j.n_slots
    shifts32 = jnp.arange(32, dtype=jnp.uint32)
    off_mask = (((offpk[..., None] >> shifts32) & jnp.uint32(1)) > 0).reshape(
        C, CONTEXT_AMOUNT, -1)
    bits_t, freqs_i, cdfs_i, _ = finalize_contexts_device(
        jnp.zeros(off_mask.shape, jnp.int32), prog_j._lap, bits0=bits, off_mask_in=off_mask,
        scale_idx=scales,
    )
    merged = build_merged_decode_table(freqs_i, cdfs_i, bits_t, lut_bits)

    def body(carry, xs):
        q, x, g = carry
        coef_safe, active, nbr_safe, lf, grp, fbkt = xs
        vals = q[:, nbr_safe]
        bk, pr = jax.vmap(lambda v, a, b: J.contexts(v, lf, grp, a, b, onehot_params=True))(
            vals, vp, wp)
        bk = jnp.where(fbkt[None] >= 0, fbkt[None], bk)
        act = jnp.broadcast_to(active[None], (C, nl))
        sym, x, g = decode_step_merged(x, g, bk, act, stream, merged, bits_t, lut_bits)
        values = J.unpack_signed(sym) + pr
        wslot = jnp.where(act, coef_safe[None], n_slots)
        q = jax.vmap(lambda qq, s, v: qq.at[s].set(v))(q, wslot, jnp.where(act, values, 0))
        return (q, x, g), None

    q0 = jnp.zeros((C, n_slots + 1), jnp.int32)
    (q, x, g), _ = jax.lax.scan(body, (q0, states, jnp.int32(0)), tuple(prog_j._dec_args[:6]))
    return np.asarray(q[:, :n_slots]), np.asarray(x), int(g)


@pytest.mark.parametrize("h,w,c,mode,seed", STEP_CASES)
def test_step_decode_intermediates_match_jax(env, h, w, c, mode, seed):
    """The encode's buckets and symbols against jax_ops.contexts on the
    same taps (pinned parameters); decode_steps_plain's plane, final lane
    states and stream position against the jax scan on the same wire; the
    plane is the encode's quantized plane (lossless)."""
    px = _natural(h, w, c, seed)
    img = RasterImage.from_array(px)
    ci_j, opts_p = _pinned(img, mode)
    nl = ci_j.num_lanes
    prog_t = PT.get_program(h, w, nl, c, "cpu", mode)
    prog_j = PJ.get_program(h, w, 9, nl, c, mode)
    tid = ci_j.transform
    qplane = L.forward_lift_quantize_pixels(
        torch.from_numpy(px.reshape(1, -1, c).copy()), prog_t.leaf_pix,
        torch.ones(512, dtype=torch.int32), torch.tensor([tid], dtype=torch.int32),
    )[0]
    ovr = prog_t._overrides(port_opts(opts_p).prediction_overrides(c), 1)
    vparams, wparams, buckets, symbols = prog_t._step_stats(qplane, ovr)
    sched = ST.get_schedule(h, w, mode=mode)
    vals = qplane.numpy()[:, np.where(sched.sched_nbr >= 0, sched.sched_nbr, prog_t.n_slots)]
    bj, pj = jax.vmap(lambda v, a, b: J.contexts(v, jnp.asarray(sched.sched_lf),
                                                 jnp.asarray(sched.sched_group.astype(np.int32)),
                                                 a, b))(
        jnp.asarray(vals), jnp.asarray(vparams.numpy()), jnp.asarray(wparams.numpy()))
    fb = jnp.asarray(sched.sched_fbkt.astype(np.int32))
    bj = np.asarray(jnp.where(fb[None] >= 0, fb[None], bj))
    sj = np.asarray(J.pack_signed(jnp.asarray(qplane.numpy()[:, sched.sched_coef]) - pj))
    np.testing.assert_array_equal(buckets.numpy(), bj)
    np.testing.assert_array_equal(symbols.numpy(), sj)

    ci_t = PT.encode_pipeline_torch(port_image(img), port_opts(opts_p), "cpu")
    states, streams, bits, offpk, scales, vp, wp, _, _ = PT.assemble_wire_batch([ci_t], nl)
    ops = prog_t.step_operands(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        states.astype(np.int64), streams.astype(np.int32), bits.astype(np.int64),
        offpk.astype(np.int64), scales.astype(np.int64))), torch.from_numpy(vp),
        torch.from_numpy(wp))
    plane, x, g = SD.decode_steps_plain(*ops)
    wj = PJ.assemble_wire_batch([_jax_container(ci_t)], nl)
    wire = tuple(jnp.asarray(a[0]) for a in wj[:7])
    q_j, x_j, g_j = _jax_step_scan(prog_j, wire, PJ.pick_lut_bits(wj[2]))
    np.testing.assert_array_equal(plane.numpy()[0], q_j)
    np.testing.assert_array_equal(x.numpy()[0], x_j.astype(np.int64))
    assert int(g[0]) == g_j == ci_t.stream.shape[0]
    np.testing.assert_array_equal(plane.numpy()[0], qplane.numpy()[:, : prog_t.n_slots])
    assert (x.numpy() == RT.RANS_L).all()  # the encoder's initial states


def _jax_container(ci_t):
    """The port's container as frave_tpu's CompressedImage (through bytes)."""
    from frave_tpu.codec.container import deserialize

    return deserialize(port_serialize(ci_t))


@pytest.mark.parametrize("name", ["v7_gray", "v7_rgb", "v8_gray", "v8_rgb"])
def test_legacy_fixtures_decode(name):
    """The v7 (3 legacy parameter rows) and v8 fixtures, parallel mode at 32
    lanes, decode to their .npy on the port's CPU path."""
    blob = open(os.path.join(DATA, f"{name}.frv"), "rb").read()
    ref = np.load(os.path.join(DATA, f"{name}.npy"))
    assert port_deserialize(blob).mode == "parallel"
    np.testing.assert_array_equal(frave_tpu_torch.decode(blob, device="cpu").data, ref)


@pytest.mark.parametrize("h,w,c,mode", [(64, 64, 1, "parity"), (96, 80, 3, "parallel"),
                                        (2, 511, 1, "grid")])
def test_batch_of_three_equals_one_image_calls(env, h, w, c, mode):
    """An encode batch of 3 gives each image's one-image container, and a
    decode batch of 3 each image's one-image decode."""
    imgs = [port_image(RasterImage.from_array(_natural(h, w, c, 60 + i))) for i in range(3)]
    opts = port_opts(EncoderOptions(mode=mode))
    cis = PT.encode_pipeline_torch_batch(imgs, opts, "cpu")
    solo = [PT.encode_pipeline_torch(im, opts, "cpu") for im in imgs]
    assert [port_serialize(a) for a in cis] == [port_serialize(b) for b in solo]
    outs = PT.decode_pipeline_torch_batch(cis, "cpu")
    for im, ci, out in zip(imgs, cis, outs):
        np.testing.assert_array_equal(out.data, PT.decode_pipeline_torch(ci, "cpu").data)
        np.testing.assert_array_equal(out.data, im.data)


def test_parity_byte_flips_decode_without_crash():
    """Corrupted parity streams decode to an image of the right shape or
    raise a typed error."""
    rng = np.random.default_rng(5)
    arr = _natural(48, 40, 1, 70)
    data = frave_tpu_torch.encode(arr, frave_tpu_torch.EncoderOptions(mode="parity"),
                                  device="cpu")
    decoded = 0
    for _ in range(8):
        b = bytearray(data)
        b[int(rng.integers(90, len(data)))] ^= 1 << int(rng.integers(0, 8))
        try:
            assert frave_tpu_torch.decode(bytes(b), device="cpu").data.shape == arr.shape
            decoded += 1
        except (SerializeError, ValueError) as e:
            assert str(e)
    assert decoded >= 4


def test_step_order_check_refuses_same_step_reads():
    """check_step_order passes the real steps of every mode and refuses a
    step that reads a slot the same step stores, or a slot stored twice."""
    for mode in ST.MODES:
        steps = ST.get_lane_steps(64, 64, 32, mode=mode)
        PT.check_step_order(steps, PT.get_geometry(64, 64).num_coef_slots)
    steps = ST.get_lane_steps(64, 64, 32, mode="parallel")
    n = PT.get_geometry(64, 64).num_coef_slots
    bad = ST.LaneSteps(**{**steps.__dict__, "step_nbr": steps.step_nbr.copy()})
    s = steps.num_steps - 1
    bad.step_nbr[s, 0, 0] = steps.step_coef[s, 1]
    with pytest.raises(AssertionError):
        PT.check_step_order(bad, n)
    twice = ST.LaneSteps(**{**steps.__dict__, "step_coef": steps.step_coef.copy()})
    twice.step_coef[s, 1] = steps.step_coef[s, 0]
    with pytest.raises(AssertionError):
        PT.check_step_order(twice, n)


@pytest.mark.parametrize("seed", range(3))
def test_stream_compact_matches_jax(seed):
    """rans_torch.stream_compact (perm gather, prefix sum, one scatter)
    against rans_jax.stream_compact (one rank-keyed sort) on random grids,
    one image and a batch of 2."""
    rng = np.random.default_rng(seed)
    h, w, nl, c = 64, 64, 32, 3
    perm = ST.get_stream_perm(h, w, nl, mode="parity", channels=c)
    K = ST.get_schedule(h, w, mode="parity").num_symbols
    R = -(-K // nl)
    rank = np.full(R * c * nl, 1 << 30, dtype=np.int32)
    rank[perm] = np.arange(perm.shape[0], dtype=np.int32)
    words = rng.integers(-(1 << 15), 1 << 15, size=(2, R, c, nl)).astype(np.int16)
    flags = rng.random((2, R, c, nl)) < 0.4
    flags.reshape(2, -1)[:, np.setdiff1d(np.arange(R * c * nl), perm)] = False
    st, tot = RT.stream_compact(torch.from_numpy(words), torch.from_numpy(flags),
                                torch.from_numpy(perm.astype(np.int64)), K * c)
    for b in range(2):
        sj, tj = stream_compact_jax(jnp.asarray(words[b].view(np.uint16)), jnp.asarray(flags[b]),
                                    jnp.asarray(rank), K * c)
        np.testing.assert_array_equal(st[b].numpy().view(np.uint16), np.asarray(sj))
        assert int(tot[b]) == int(tj)
    s1, t1 = RT.stream_compact(torch.from_numpy(words[0]), torch.from_numpy(flags[0]),
                               torch.from_numpy(perm.astype(np.int64)), K * c)
    assert torch.equal(s1, st[0]) and int(t1) == int(tot[0])


@pytest.mark.parametrize("label", ["64x64 gray parallel", "256x256 gray parity"])
def test_pinned_encode_matches_reference_hash(label):
    """The port's CPU encode, pinned to an entry of torch_port_refs.json
    (frave_tpu's jax backend, tests/make_torch_refs.py), has its length
    and SHA-256: the hashes chip_smoke.py holds the card's step-mode
    encodes against."""
    import hashlib
    import json

    from frave_tpu_torch.testing import natural_image

    entry = next(e for e in json.load(open(os.path.join(DATA, "torch_port_refs.json")))["entries"]
                 if e["label"] == label)
    h, w, c = entry["shape"]
    opts = frave_tpu_torch.EncoderOptions(
        mode=entry["mode"], num_lanes=entry["num_lanes"],
        value_prediction_params=np.asarray(entry["value_prediction_params"], np.float32),
        width_prediction_params=np.asarray(entry["width_prediction_params"], np.float32),
    )
    blob = frave_tpu_torch.encode(natural_image(h, w, c, entry["seed"]), opts, device="cpu")
    assert (len(blob), hashlib.sha256(blob).hexdigest()) == (entry["length"], entry["sha256"])
