"""The port's parallel layer (frave_tpu_torch.parallel) against frave_tpu's.

Three gloo worlds of fresh processes on the CPU (world.launch running
dryrun.run_legs: inputs and outputs cross as .npy / .frv files), each
serving many tests: (dp, tp) = (2, 2) and (1, 4) of four ranks, (1, 2) of
two. The JAX side runs here, in the test process only.

  * the mesh factorization and the halo plan equal frave_tpu's arrays;
  * each rank's halo-assembled plane equals the numpy build from
    frave_tpu's single-image quantized plane through frave_tpu's
    ShardedEncoder._halo plan, and the halo rides point-to-point rings;
  * sharded containers (32x32 gray, 24x40 RGB; lossless and HIGH; grid,
    parallel and parity) are byte-equal to the port's one-card encode, and decode
    on frave_tpu's numpy and jax decoders; the sharded fits' samples are
    the one-card program's, strided (96x80 RGB under a fit cap) and not;
  * ShardedDecoder and TPShardedDecoder give frave_tpu's pixels on
    containers frave_tpu encoded; the grid tp decode exchanges only the
    [n, C] int32 renorm counts a row and one values gather a wave.
"""

import numpy as np
import pytest

from frave_tpu import EncoderOptions as JOpts
from frave_tpu import EncoderQuality as JQ
from frave_tpu.codec.channel_transform import forward as channel_forward
from frave_tpu.codec.decoder import FRIDecoder
from frave_tpu.codec.encoder import FRIEncoder
from frave_tpu.codec.options import quantization_matrix
from frave_tpu.fractal.geometry import get_geometry as jget_geometry
from frave_tpu.images import RasterImage as JRaster
from frave_tpu.ops.lifting import forward_lifting_np, quantize_np
from frave_tpu.parallel import mesh as jmesh
from frave_tpu.parallel.sharded import ShardedEncoder as JShardedEncoder

from frave_tpu_torch import EncoderOptions, EncoderQuality, RasterImage
from frave_tpu_torch import kernel_check as KC
from frave_tpu_torch.codec import pipeline_torch as PT
from frave_tpu_torch.codec.container import serialize
from frave_tpu_torch.fractal.schedule import default_num_lanes, get_lane_steps, get_schedule
from frave_tpu_torch.parallel import mesh_factorization
from frave_tpu_torch.parallel.sharded import encode_plan, fit_samples
from frave_tpu_torch.parallel.world import launch

# (label, images, mode, quality) of the encode legs; images: (B, h, w, c, seed)
IMAGES = {"gray32": (4, 32, 32, 1, 11), "rgb24x40": (2, 24, 40, 3, 12)}
ENCODES = [
    ("gray32", "grid", "LOSSLESS"),
    ("gray32", "grid", "HIGH"),
    ("gray32", "parallel", "LOSSLESS"),
    ("rgb24x40", "grid", "LOSSLESS"),
    ("rgb24x40", "grid", "HIGH"),
    ("rgb24x40", "parallel", "HIGH"),
    ("rgb24x40", "parity", "HIGH"),
]
WORLDS = {"2x2": (2, 2), "1x2": (1, 2), "1x4": (1, 4)}
# tp decodes: (label, (h, w, c), mode, num_lanes, quality) encoded by frave_tpu
TP_CASES = [
    ("gray64x96", (64, 96, 1), "grid", 64, "LOSSLESS"),
    ("rgb48x64", (48, 64, 3), "grid", 64, "HIGH"),
    ("gray40x48", (40, 48, 1), "parallel", 64, "LOSSLESS"),
    ("rgb24x40", (24, 40, 3), "parity", 32, "HIGH"),
    ("rgb16x16", (16, 16, 3), "grid", 16, "LOSSLESS"),
]
DP_QUALITIES = ("LOSSLESS", "LOW", "HIGH")


def _images(label):
    B, h, w, c, seed = IMAGES[label]
    return np.random.default_rng(seed).integers(0, 256, (B, h, w, c), dtype=np.uint8)


def _jax_mesh(dp, tp):
    return jmesh.make_mesh(dp * tp, shape=(dp, tp))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every world's legs, run once: {world: [rank results]} and the
    directory of their files."""
    d = tmp_path_factory.mktemp("parallel")
    for label in IMAGES:
        np.save(d / f"{label}.npy", _images(label))
    rng = np.random.default_rng(21)
    for label, shape, mode, nl, q in TP_CASES:
        px = rng.integers(0, 256, shape, dtype=np.uint8)
        np.save(d / f"tp_{label}_{mode}.npy", px)
        blob = FRIEncoder(JOpts(backend="numpy", mode=mode, num_lanes=nl, quality=JQ[q])).encode(px)
        (d / f"tp_{label}_{mode}.frv").write_bytes(blob)
    dpx = rng.integers(0, 256, (3, 32, 32, 1), dtype=np.uint8)
    np.save(d / "dp.npy", dpx)
    for i, q in enumerate(DP_QUALITIES):
        blob = FRIEncoder(JOpts(backend="numpy", quality=JQ[q])).encode(dpx[i])
        (d / f"dp_{i}.frv").write_bytes(blob)

    out = {}
    for world, (dp, tp) in WORLDS.items():
        legs = [{"op": "encode", "images": str(d / f"{label}.npy"), "mode": mode, "quality": q,
                 "out": str(d / world / f"{label}_{mode}_{q}"),
                 "planes": str(d / world / f"plane_{label}") if mode == "grid" and q == "HIGH"
                 else None}
                for label, mode, q in ENCODES]
        if world == "2x2":
            legs.append({"op": "dp_decode", "blobs": [str(d / f"dp_{i}.frv") for i in range(3)],
                         "shape": (32, 32, 1), "out": str(d / "dp_out.npy")})
            legs += [{"op": "tp_decode", "blob": str(d / f"tp_{label}_{mode}.frv"), "shape": shape,
                      "out": str(d / f"tp_{label}_{mode}_out.npy")}
                     for label, shape, mode, _, _ in TP_CASES]
        (d / world).mkdir()
        out[world] = launch(dp * tp, "frave_tpu_torch.parallel.dryrun:run_legs",
                            {"legs": legs, "dp": dp, "tp": tp}, device="cpu",
                            timeout=400)
    return out, d


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8, 16, 64])
def test_mesh_factorization_matches_jax(n):
    assert mesh_factorization(n) == jmesh.mesh_factorization(n)


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)])
@pytest.mark.parametrize("shape,mode", [((32, 32), "grid"), ((24, 40), "parallel"),
                                        ((96, 96), "grid"), ((24, 40), "parity")])
def test_halo_plan_equals_jax(mesh, shape, mode):
    """The host plan is frave_tpu's, array for array: lanes, rows, the
    owner-grouped schedule tensors, the halo (deltas, sizes, send
    indices) and the inverse permutation."""
    dp, tp = mesh
    h, w = shape
    ref = JShardedEncoder(height=h, width=w, channels=1, batch=dp, mesh=_jax_mesh(dp, tp),
                          mode=mode)
    plan = encode_plan(h, w, tp, mode=mode)
    assert (plan.nl, plan.rows, plan.num_symbols) == (ref.nl, ref.rows, ref.num_symbols)
    assert (plan.halo is not None) == ref.halo_enabled
    for ours, theirs in zip((plan.sc, plan.snbr, plan.svalid, plan.slf, plan.sgrp, plan.sfbkt),
                            ref._consts[2:]):
        np.testing.assert_array_equal(ours, np.asarray(theirs))
    if ref.halo_enabled:
        assert plan.halo[:2] == ref._halo[:2]
        for a, b in zip(plan.halo[2], ref._halo[2]):
            np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_array_equal(plan.inv_perm, ref._inv_perm)


def _jax_plane(img, q, ref_enc, tp, s):
    """Rank s's analysis plane built in numpy from frave_tpu's quantized
    plane of one image and frave_tpu's halo plan: its band, each delta's
    received slots, a zero."""
    lossless = q == "LOSSLESS"
    im, _ = channel_forward(JRaster.from_array(img), "auto", lossless)
    h, w, c = img.shape
    geo = jget_geometry(h, w)
    coef = forward_lifting_np(im.data.reshape(-1, c).T.astype(np.int64), geo)
    qflat = quantize_np(coef, quantization_matrix(JQ[q]), geo).reshape(c, -1)
    own = ref_enc._consts[0].shape[0] // tp * ref_enc._consts[0].shape[1]
    full = np.zeros((c, own * tp), np.int64)
    full[:, : qflat.shape[1]] = qflat
    parts = [full[:, s * own:(s + 1) * own]]
    for d, idx in zip(ref_enc._halo[0], ref_enc._halo[2]):
        arr = np.asarray(idx).reshape(tp, -1)
        src = (s - d) % tp
        parts.append(full[:, src * own + arr[src]])
    parts.append(np.zeros((c, 1), np.int64))
    return np.concatenate(parts, axis=1)


@pytest.mark.parametrize("world", ["2x2", "1x4"])
@pytest.mark.parametrize("label", sorted(IMAGES))
def test_rank_planes_equal_jax_halo_build(run, world, label):
    """Each rank's halo-assembled plane (its band's quantized coefficients
    by kernel A's plain version, the halo its rings brought, a zero slot)
    equals the numpy build from frave_tpu's single-image quantized plane
    through frave_tpu's ShardedEncoder._halo."""
    res, d = run
    dp, tp = WORLDS[world]
    batch = _images(label)
    B, h, w, c = batch.shape
    ref_enc = JShardedEncoder(height=h, width=w, channels=c, batch=B, mesh=_jax_mesh(dp, tp))
    assert ref_enc.halo_enabled
    Bl = B // dp
    for rank in range(dp * tp):
        i, s = divmod(rank, tp)
        plane = np.load(d / world / f"plane_{label}_{rank}.npy")
        want = np.concatenate([_jax_plane(batch[i * Bl + b], "HIGH", ref_enc, tp, s)
                               for b in range(Bl)])
        np.testing.assert_array_equal(plane, want)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_halo_rides_point_to_point(run, world):
    """Where the plan is active the halo goes by one ring a shard offset
    (batch_isend_irecv), never by a plane all_gather; the rest of an
    encode's traffic is the tp sums, the reshard, the gather to the tp
    group's first rank and the containers."""
    res, _ = run
    dp, tp = WORLDS[world]
    for rank_res in res[world]:
        for leg in rank_res[: len(ENCODES)]:
            assert leg["halo"]
            halo = [c for c in leg["collectives"] if c[4] == "halo"]
            assert halo and all(c[0] == "ring" and c[1] == "tp" for c in halo)
            ops = {(c[0], c[4]) for c in leg["collectives"]}
            assert ops == {("ring", "halo"), ("all_reduce", "fit"), ("all_reduce", "hist"),
                           ("all_gather", "reshard"), ("gather", "gather"),
                           ("all_gather_object", "containers")}
            assert not any(c[0] == "all_gather" and c[4] == "halo" for c in leg["collectives"])


def _one_card(label, mode, q):
    opts = EncoderOptions(mode=mode, quality=EncoderQuality[q])
    imgs = [RasterImage.from_array(a) for a in _images(label)]
    return [serialize(ci) for ci in PT.encode_pipeline_torch_batch(imgs, opts, "cpu")]


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("label,mode,q", ENCODES)
def test_sharded_containers_equal_one_card(run, world, label, mode, q):
    """The dp x tp encode's containers are byte-equal to the port's
    one-card encode of the same images (float64 Gram sums of integer taps
    are exact in any order)."""
    _, d = run
    got = [(d / world / f"{label}_{mode}_{q}" / f"{i}.frv").read_bytes()
           for i in range(IMAGES[label][0])]
    assert got == _one_card(label, mode, q)


@pytest.mark.parametrize("h,w,c,env", [
    (96, 80, 3, {"FRAVE_GRID_ENC": "force", "FRAVE_FIT_CAP": "700"}),
    (64, 64, 1, {}),
])
def test_fit_samples_mark_the_targets_the_program_fits_gather(monkeypatch, h, w, c, env):
    """sharded.fit_samples marks exactly the symbols whose targets the
    one-card program's fits gather, group by group: every fit_stride-th
    of each group's range where the program takes the strided fits (96x80
    RGB under a fit cap of 700), every HF symbol otherwise (64x64 gray)."""
    for k in ("FRAVE_GRID_ENC", "FRAVE_FIT_CAP"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    prog = PT.CodecProgram.from_host(h, w, default_num_lanes(get_schedule(h, w).num_symbols), c,
                                     "cpu")
    strided = prog.grid_enc is not None
    assert strided == bool(env)
    m = fit_samples(prog)
    assert m.shape == (prog.num_fine, prog.num_symbols)
    _, target, ks = prog.fit_samples[strided]
    assert [int(n) for n in m.sum(axis=1)] == [k.shape[0] for k in ks]
    marked = np.concatenate([np.nonzero(row)[0] for row in m])
    np.testing.assert_array_equal(prog.sc[marked], target.numpy())
    full = [hi - lo for lo, hi in prog.group_ranges]
    assert (m.sum(axis=1) < full).any() == strided
    for g, (lo, hi) in enumerate(prog.group_ranges):
        np.testing.assert_array_equal(np.nonzero(m[g])[0],
                                      np.arange(lo, hi, PT.fit_stride(hi - lo) if strided else 1))


@pytest.mark.parametrize("label,mode,q", ENCODES)
def test_sharded_containers_decode_on_frave_tpu(run, label, mode, q):
    """The sharded containers decode on frave_tpu's numpy decoder to the
    input (lossless) or to the port's own decode (HIGH), and on its jax
    decoder to the same pixels."""
    _, d = run
    batch = _images(label)
    jdec, ndec = FRIDecoder(backend="jax"), FRIDecoder(backend="numpy")
    for i in range(batch.shape[0]):
        blob = (d / "2x2" / f"{label}_{mode}_{q}" / f"{i}.frv").read_bytes()
        npx = ndec.decode(blob).data
        if q == "LOSSLESS":
            np.testing.assert_array_equal(npx, batch[i])
        else:
            import frave_tpu_torch

            np.testing.assert_array_equal(npx, frave_tpu_torch.decode(blob, device="cpu").data)
        if i == 0:
            np.testing.assert_array_equal(jdec.decode(blob).data, npx)


def test_sharded_decoder_mixed_quality(run):
    """ShardedDecoder: 3 frave_tpu containers of mixed quality on 4 ranks
    (the batch padded to 4 by its last image) give frave_tpu's pixels."""
    _, d = run
    out = np.load(d / "dp_out.npy")
    assert out.shape == (3, 32, 32, 1)
    dpx = np.load(d / "dp.npy")
    ndec = FRIDecoder(backend="numpy")
    for i in range(3):
        np.testing.assert_array_equal(
            out[i], ndec.decode((d / f"dp_{i}.frv").read_bytes()).data)
    np.testing.assert_array_equal(out[0], dpx[0])


@pytest.mark.parametrize("label,shape,mode,nl,q", TP_CASES)
def test_tp_decoder_equals_jax(run, label, shape, mode, nl, q):
    """TPShardedDecoder over 4 ranks gives frave_tpu's pixels (the input,
    lossless) on a container frave_tpu encoded."""
    _, d = run
    got = np.load(d / f"tp_{label}_{mode}_out.npy")
    blob = (d / f"tp_{label}_{mode}.frv").read_bytes()
    np.testing.assert_array_equal(got, FRIDecoder(backend="numpy").decode(blob).data)
    if q == "LOSSLESS":
        np.testing.assert_array_equal(got, np.load(d / f"tp_{label}_{mode}.npy"))


@pytest.mark.parametrize("label,shape,mode,nl,q", TP_CASES)
def test_tp_decoder_traffic(run, label, shape, mode, nl, q):
    """The grid tp decode (a dense lattice) exchanges per row one [n, C]
    int32 count gather (the rank's [C] counts) and nothing larger, per
    non-empty wave one values gather; the step-tensor tp decode (parallel,
    parity, tiny grid shapes) one (value, need) [2, C, NL/n] gather a
    non-empty step. Every rank issues the same."""
    res, _ = run
    h, w, c = shape
    n = 4
    idx = len(ENCODES) + 1 + [t[0] + t[2] for t in TP_CASES].index(label + mode)
    legs = [r[idx] for r in res["2x2"]]
    assert all(leg["collectives"] == legs[0]["collectives"] for leg in legs)
    coll = legs[0]["collectives"]
    if PT.get_program(h, w, nl, c, "cpu", mode).waves is not None:
        sh = KC.grid_shapes(h, w, c, nl)
        rows = [x for x in coll if x[4] == "row"]
        assert len(rows) == sh["grid"][0]
        assert all(x == ("all_gather", "world", (c,), "int32", "row") for x in rows)
        waves = [x for x in coll if x[4] == "wave"]
        assert len(waves) == sh["waves"]
        assert all(x[0] == "all_gather" and x[2][0] == c and x[2][2] == nl // n for x in waves)
        assert len(coll) == len(rows) + len(waves)
    else:
        steps = get_lane_steps(h, w, nl, mode=mode)
        live = int(((steps.step_slot >= 0).sum(axis=1) > 0).sum())
        assert coll == [("all_gather", "world", (2, c, nl // n), "int32", "step")] * live
