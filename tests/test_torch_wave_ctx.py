"""Kernels W and V's plain versions (frave_tpu_torch/ops/wave_ctx.py: the
contexts from the schedule records, the wave's values into the plane)
against the dense wave chain, on the CPU, bit-equal.

Shapes 64x64 gray, 96x80 RGB and 256x256 gray, with FRAVE_GRID_ENC=force
and a fit cap that subsamples the largest waves (FRAVE_FIT_CAP=700, as
test_torch_grid_encode.py has it). Inputs are seeded numpy images through
the plain kernel A; the parameters are the port's own fits. The JAX
package's functions run as its own tests run them on the CPU.

  * the decode mode of W, wave by wave, on a plane that holds only the
    waves before it (as a decode holds it), against frave_tpu's dense chain
    (grid_decode._tap_planes / _broadcast_parent / _pack_tap_vals, then
    jax_ops.contexts_static and the fixed bucket) and the port's
    grid_decode.wave_chain: buckets in kernel 3's layout (zero past the
    wave) and predictions; every wave, the DC phases (waves 0 and 1) and
    the waves with scale-2 fixups among them; on the coefficients and on
    garbage values;
  * the encode mode of W and the statistics: buckets and symbols against
    frave_tpu's build_grid_encode.stats and its step_stats (jax_ops.contexts
    over the same taps), pinned to the same parameters; the port's fits,
    buckets and symbols against its dense build_grid_encode and its
    step-tensor statistics as they ran before the records;
  * V against the dense chain's scatter, and a whole grid decode through
    W, kernel 3 and V against the dense chain's decode: the plane and the
    pixels, on a container's stream and on garbage.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frave_tpu.codec import grid_decode as GDJ
from frave_tpu.codec import pipeline_jax as PJ
from frave_tpu.fractal.geometry import get_geometry as get_geometry_j
from frave_tpu.fractal.schedule import get_schedule as get_schedule_j
from frave_tpu.ops import jax_ops as J
from frave_tpu_torch.codec import grid_decode as GD
from frave_tpu_torch.codec import pipeline_torch as PT
from frave_tpu_torch.codec.options import EncoderOptions
from frave_tpu_torch.fractal.geometry import get_geometry
from frave_tpu_torch.fractal.schedule import default_num_lanes, get_schedule
from frave_tpu_torch.images import RasterImage
from frave_tpu_torch.ops import lifting as L
from frave_tpu_torch.ops import rans_torch as RT
from frave_tpu_torch.ops import torch_ops as T
from frave_tpu_torch.ops import wave_ctx as WC
from test_torch_pipeline import _natural, env  # noqa: F401  (env: fixture)

SHAPES = [(64, 64, 1, 31), (96, 80, 3, 32), (256, 256, 1, 33)]


def _setup(env, h, w, c, seed):  # noqa: F811
    """The port's program (FRAVE_GRID_ENC=force, FRAVE_FIT_CAP=700), the
    image's quantized plane [C, n_slots + 1] (lossless; the zero slot
    last), its fitted parameters and the wave starts."""
    env.setenv("FRAVE_GRID_ENC", "force")
    env.setenv("FRAVE_FIT_CAP", "700")
    px = _natural(h, w, c, seed)
    nl = default_num_lanes(get_schedule(h, w, mode="grid").num_symbols)
    prog = PT.CodecProgram.from_host(h, w, nl, c, "cpu")
    qplane = L.forward_lift_quantize_pixels(
        torch.from_numpy(px.reshape(1, -1, c).copy()), prog.leaf_pix,
        torch.ones(512, dtype=torch.int32), torch.tensor([1 if c == 3 else 0], dtype=torch.int32),
    )[0]
    vp, wp, _, _ = prog._grid_stats(qplane, None)
    return prog, qplane, vp, wp, GD.wave_starts(prog.waves)


def _jax_plane(plane: np.ndarray, C: int):
    """The JAX program's plane of [C, n_slots + 1] values: packed u32 (RGB)
    or int16 (gray), the zero slot last."""
    n = plane.shape[1] - 1
    if C == 3:
        return jnp.concatenate([PJ._pack3(jnp.asarray(plane[:, :n])),
                                jnp.full((1,), PJ._PACK_ZERO, jnp.uint32)])
    return jnp.asarray(plane.astype(np.int16))


def _jax_wave_contexts_j(waves_j, i, qpad, vp, wp, C):
    """frave_tpu's dense chain for wave i (decode_fused_grid's ctx_of with
    the pack route): the tap planes of the grids of the waves before it,
    packed, contexts_static and the fixed bucket. vp / wp [C, F, 6] jax
    arrays. Returns (buckets, predictions) [C, kw]."""
    packed = C == 3
    fill = PJ._PACK_ZERO if packed else 0
    gdtype = jnp.uint32 if packed else jnp.int16

    def vgrid(wd):  # the wave's values on its grid (decode's to_grid)
        if packed:
            return qpad[wd.slot_safe].reshape(wd.shape)
        return qpad[:, wd.slot_safe].reshape((C,) + wd.shape)

    wd = waves_j[i]
    if i == 0:
        vals = jnp.zeros((C, wd.kw, 6), jnp.int32)
    else:
        if i == 1:
            planes = GDJ._tap_planes(wd, vgrid(waves_j[0]), None, packed, C, fill)
        elif i == 2:
            g0, g1 = vgrid(waves_j[0]), vgrid(waves_j[1])
            act = waves_j[1].active_dense if packed else waves_j[1].active_dense[None]
            planes = GDJ._tap_planes(wd, jnp.where(act, g1, g0), None, packed, C, fill)
        else:
            parent = vgrid(waves_j[i - 1])
            pv = GDJ._broadcast_parent(wd.wp, parent, fill, gdtype)
            planes = GDJ._tap_planes(wd, pv, parent, packed, C, fill)
        vals = GDJ._pack_tap_vals(wd, planes, packed, C)
    vrow = vp[:, wd.group].reshape(C, 1, 6)
    wrow = wp[:, wd.group].reshape(C, 1, 6)
    bk, pr = J.contexts_static(vals, vrow, wrow, False)
    if wd.fbkt >= 0:
        bk = jnp.full_like(bk, wd.fbkt)
    return bk, pr


def _unlayout(bk: torch.Tensor, kw: int) -> torch.Tensor:
    """Kernel 3's [1, rows, C, NL] buckets of a wave -> [C, rows * NL]."""
    _, rows, C, nl = bk.shape
    return bk[0].transpose(0, 1).reshape(C, rows * nl)


_JAX = {}  # (h, w, c, nl, n_slots) -> frave_tpu's references, jitted once a shape


def _jax_refs(h, w, c, nl, n_slots):
    """frave_tpu's references at one shape, each one jitted program (as
    the JAX package runs them): "waves" (qpad, vp, wp) -> every wave's
    (buckets, predictions) by the dense chain; "stats" build_grid_encode's
    stats (qpad, vp, wp) with both parameters pinned; "contexts"
    step_stats' vmapped jax_ops.contexts over given taps."""
    key = (h, w, c, nl, n_slots)
    if key not in _JAX:
        geo, sched = get_geometry_j(h, w, 9), get_schedule_j(h, w, mode="grid")
        waves = GDJ.get_wave_devs(geo, sched, nl, n_slots)
        stats = GDJ.build_grid_encode(types.SimpleNamespace(n_slots=n_slots), geo, sched, nl, c)
        lf, grp = jnp.asarray(sched.sched_lf), jnp.asarray(sched.sched_group.astype(np.int32))
        _JAX[key] = {
            "waves": jax.jit(lambda q, vp, wp: [_jax_wave_contexts_j(waves, i, q, vp, wp, c)
                                                for i in range(len(waves))]),
            "stats": jax.jit(lambda q, vp, wp: stats(q, vp, wp, True, True)),
            "contexts": jax.jit(jax.vmap(lambda v, a, b: J.contexts(v, lf, grp, a, b))),
        }
    return _JAX[key]


@pytest.mark.parametrize("values", ["coefficients", "garbage"])
@pytest.mark.parametrize("h,w,c,seed", SHAPES)
def test_wave_contexts_match_dense_chains(env, h, w, c, seed, values):  # noqa: F811
    """Every wave's buckets and predictions from the records, on the plane
    of the waves before it, equal frave_tpu's dense chain and the port's
    wave_chain; the pad lanes hold 0 and a lane window (the tp decoder's)
    is the matching slice."""
    prog, qplane, vp, wp, starts = _setup(env, h, w, c, seed)
    C, nl, waves = c, prog.nl, prog.waves
    if values == "garbage":  # what a corrupt stream could decode to (10-bit for frave_tpu)
        rng = np.random.default_rng(seed)
        qplane = torch.from_numpy(rng.integers(-500, 500, size=qplane.shape).astype(np.int32))
        qplane[:, -1] = 0
    # the port's dense chain, each wave's (buckets, predictions) recorded
    seen = []

    def scan_wave(wd, buckets, preds):
        seen.append((buckets.to(torch.int32), preds.to(torch.int32)))
        return qplane[:, wd.wslot]

    GD.wave_chain(waves, vp, wp, torch.zeros((C, prog.n_slots), dtype=torch.int32), scan_wave)
    dense_j = _jax_refs(h, w, c, nl, prog.n_slots)["waves"](
        _jax_plane(qplane.numpy(), C), jnp.asarray(vp.numpy()), jnp.asarray(wp.numpy()))
    assert any(wd.fix for wd in waves), "no wave with scale-2 fixups at this shape"
    plane = torch.zeros_like(qplane)
    for i, (wd, k0) in enumerate(zip(waves, starts)):
        bk, pr = WC.wave_contexts(plane, prog.records, vp, wp, C, (k0, wd.kw, nl))
        assert bk.shape == (1, wd.rows, C, nl) and pr.shape == (C, wd.kw)
        flat = _unlayout(bk, wd.kw)
        assert int(flat[:, wd.kw:].abs().sum()) == 0
        np.testing.assert_array_equal(flat[:, : wd.kw].numpy(), seen[i][0].numpy(), err_msg=str(i))
        np.testing.assert_array_equal(pr.numpy(), seen[i][1].numpy(), err_msg=str(i))
        bj, pj = dense_j[i]
        np.testing.assert_array_equal(flat[:, : wd.kw].numpy(), np.asarray(bj), err_msg=str(i))
        np.testing.assert_array_equal(pr.numpy(), np.asarray(pj), err_msg=str(i))
        if wd.kw and nl >= 4:
            lo, width = nl // 4, nl // 2
            bw, pw = WC.wave_contexts(plane, prog.records, vp, wp, C, (k0, wd.kw, nl),
                                      lanes=(lo, width))
            np.testing.assert_array_equal(bw.numpy(), bk[..., lo:lo + width].numpy())
            np.testing.assert_array_equal(pw.numpy(), pr.numpy())
        plane[:, wd.wslot] = qplane[:, wd.wslot]  # the wave decoded


@pytest.mark.parametrize("h,w,c,seed", SHAPES)
def test_stats_match_dense_and_step_stats(env, h, w, c, seed):  # noqa: F811
    """The encode mode of W against frave_tpu's build_grid_encode.stats and
    step_stats pinned to the port's parameters; the port's statistics
    (fits, buckets, symbols) against its dense build_grid_encode and its
    step-tensor statistics as computed before the records."""
    prog, qplane, vp, wp, _ = _setup(env, h, w, c, seed)
    C, n_slots = c, prog.n_slots
    sched = get_schedule(h, w, mode="grid")
    geo = get_geometry(h, w, 9)

    # the dense reference (subsampled fits) and the records' statistics
    ref = GD.build_grid_encode(prog, geo, sched, prog.waves)(qplane, None)
    got = prog._grid_stats(qplane, None)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype or a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), b.to(a.dtype).numpy())
    # the step-tensor statistics as they were: the bulk gather, every HF
    # symbol in its group's fit, torch_ops.contexts and the fixed bucket
    vals = qplane[:, torch.from_numpy(prog.snbr_safe)]
    target = qplane[:, torch.from_numpy(prog.sc)]
    vs, ws = PT.fit_predictors([vals[:, lo:hi] for lo, hi in prog.group_ranges],
                               [target[:, lo:hi] for lo, hi in prog.group_ranges], None)
    lf, grp, fbkt = (torch.from_numpy(a) for a in (prog.slf, prog.sgrp, prog.sfbkt))
    bk, pr = T.contexts(vals, lf, grp, vs, ws)
    bk = torch.where(fbkt >= 0, fbkt.to(bk.dtype), bk)
    got = prog._step_stats(qplane, None)
    for a, b in zip(got, (vs, ws, bk, T.pack_signed(target - pr))):
        np.testing.assert_array_equal(a.numpy(), b.to(a.dtype).numpy())

    # W's encode mode against frave_tpu, pinned to the port's parameters
    buckets, symbols = WC.wave_contexts(qplane, prog.records, vp, wp, C)
    refs = _jax_refs(h, w, c, prog.nl, n_slots)
    vpj, wpj = jnp.asarray(vp.numpy()), jnp.asarray(wp.numpy())
    vj, wj, bj, sj = refs["stats"](_jax_plane(qplane.numpy(), C), vpj, wpj)
    np.testing.assert_array_equal(np.asarray(vj), vp.numpy())
    np.testing.assert_array_equal(np.asarray(wj), wp.numpy())
    np.testing.assert_array_equal(buckets.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(symbols.numpy(), np.asarray(sj))
    vals = qplane.numpy()[:, np.where(sched.sched_nbr >= 0, sched.sched_nbr, n_slots)]
    bs, ps = refs["contexts"](jnp.asarray(vals), vpj, wpj)  # step_stats' contexts
    fb = sched.sched_fbkt.astype(np.int32)[None]
    np.testing.assert_array_equal(buckets.numpy(), np.where(fb >= 0, fb, np.asarray(bs)))
    sym_j = J.pack_signed(jnp.asarray(qplane.numpy()[:, sched.sched_coef]) - ps)
    np.testing.assert_array_equal(symbols.numpy(), np.asarray(sym_j))

    # pinned: the parameters pass through (f16 wire values) unchanged
    ovr_t = (vp.clone(), wp.clone(), True)
    pv, pw, pb, ps_ = prog._grid_stats(qplane, ovr_t)
    np.testing.assert_array_equal(pv.numpy(), vp.numpy())
    np.testing.assert_array_equal(pw.numpy(), wp.numpy())
    np.testing.assert_array_equal(pb.numpy(), buckets.numpy())
    np.testing.assert_array_equal(ps_.numpy(), symbols.numpy())


def _old_decode(prog, states, stream, wire_bits, offpk, scpk, vparams, wparams, qdiv, tids):
    """The dense decode as it ran before the records: grid_decode.wave_chain
    over a [B, C, n_slots] plane, kernel 3's rows a wave, then kernel B.
    Returns (plane, pixels)."""
    B, C, nl = states.shape[0], prog.channels, prog.nl
    tabs = GD.wire_tables(prog.lap, wire_bits, offpk, scpk)
    vparams = vparams.reshape((B * C,) + vparams.shape[2:])
    wparams = wparams.reshape((B * C,) + wparams.shape[2:])
    st = {"x": states, "gptr": torch.zeros((B,), dtype=torch.int64)}
    qplane = torch.zeros((B, C, prog.n_slots), dtype=torch.int32)

    def scan_wave(wd, buckets, preds):
        if wd.rows == 0:
            return preds.new_zeros((B * C, 0)).to(torch.int32)
        bk = torch.nn.functional.pad(buckets.to(torch.int32), (0, wd.rows * nl - wd.kw))
        bk = bk.reshape(B, C, wd.rows, nl).transpose(1, 2).contiguous()
        syms, st["x"], st["gptr"] = RT.decode_scan_wave(st["x"], st["gptr"], bk, wd.active_rows,
                                                        stream, tabs)
        syms = syms.transpose(1, 2).reshape(B * C, wd.rows * nl)[:, : wd.kw]
        return (T.unpack_signed(syms) + preds).to(torch.int32)

    GD.wave_chain(prog.waves, vparams, wparams, qplane.view(B * C, -1), scan_wave)
    out = L.dequantize_inverse_lift_pixels(qplane, prog.node_mask_u8, prog.leaf_mask_u8, qdiv,
                                           prog.leaf_pix, prog.pix_inv, tids)
    return qplane, out


@pytest.mark.parametrize("stream_kind", ["valid", "garbage"])
@pytest.mark.parametrize("h,w,c,seed", SHAPES[:2])
def test_grid_decode_matches_dense_chain(env, monkeypatch, h, w, c, seed,  # noqa: F811
                                         stream_kind):
    """A batch of two containers decoded through W, kernel 3 and V equals
    the dense chain's decode: the plane (the zero slot still 0) and the
    pixels; on garbage streams too; V alone equals the chain's scatter."""
    imgs = [RasterImage.from_array(_natural(h, w, c, seed + i)) for i in range(2)]
    cis = PT.encode_pipeline_torch_batch(imgs, EncoderOptions(), "cpu")
    nl = cis[0].num_lanes
    prog = PT.get_program(h, w, nl, c, "cpu")
    wire = list(PT.assemble_wire_batch(cis, nl))
    if stream_kind == "garbage":
        rng = np.random.default_rng(seed)
        wire[0] = rng.integers(1 << 16, 1 << 32, size=wire[0].shape, dtype=np.int64)
        pad = c * nl
        s = wire[1].astype(np.int64)
        s[:, :-pad] = rng.integers(0, 1 << 16, size=(s.shape[0], s.shape[1] - pad))
        wire[1] = s
    dts = (np.int64, np.int32, np.int64, np.int64, np.int64, np.float32, np.float32, np.int32,
           np.int32)
    ops = [torch.from_numpy(np.ascontiguousarray(a.astype(dt))) for a, dt in zip(wire, dts)]
    planes = []
    real = GD.dequantize_inverse_lift_pixels

    def capture(qplane, *rest):
        planes.append(qplane.clone())
        return real(qplane, *rest)

    monkeypatch.setattr(GD, "dequantize_inverse_lift_pixels", capture)
    out = prog.decode_exec(*ops)
    ref_plane, ref_out = _old_decode(prog, *ops)
    (plane,) = planes
    assert plane.shape == (2, c, prog.n_slots + 1)
    assert int(plane[..., -1].abs().sum()) == 0
    np.testing.assert_array_equal(plane[..., :-1].numpy(), ref_plane.numpy())
    np.testing.assert_array_equal(out.numpy(), ref_out.numpy())
    if stream_kind == "valid":
        for i, im in enumerate(imgs):
            np.testing.assert_array_equal(out[i].numpy().T.reshape(im.data.shape), im.data)

    # V alone: kernel 3's [B, rows, C, NL] layout of a wave's symbols
    rng = np.random.default_rng(seed + 7)
    wd, k0 = max(zip(prog.waves, GD.wave_starts(prog.waves)), key=lambda t: t[0].kw)
    syms = torch.from_numpy(rng.integers(0, 1024, size=(2, wd.rows, c, nl)).astype(np.int32))
    preds = torch.from_numpy(rng.integers(-255, 256, size=(2 * c, wd.kw)).astype(np.int32))
    got = torch.zeros((2 * c, prog.n_slots + 1), dtype=torch.int32)
    WC.wave_finish(syms[None], preds, prog.records, (k0, wd.kw, nl), got, c)
    want = torch.zeros_like(got)
    vals = syms.transpose(1, 2).reshape(2 * c, wd.rows * nl)[:, : wd.kw]
    want[:, wd.wslot] = (T.unpack_signed(vals) + preds).to(torch.int32)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    # and as the tp decoder gathers it: 2 ranks of nl / 2 lanes
    parts = syms.reshape(2, wd.rows, c, 2, nl // 2).permute(3, 0, 1, 2, 4)
    got2 = torch.zeros_like(got)
    WC.wave_finish(parts, preds, prog.records, (k0, wd.kw, nl), got2, c)
    np.testing.assert_array_equal(got2.numpy(), want.numpy())


def test_records_refuse_slots_past_the_plane():
    """records_host raises where a slot or tap names more than the zero
    slot; the wrappers refuse a plane without the zero slot."""
    sched = get_schedule(64, 64, mode="grid")
    n = get_geometry(64, 64, 9).num_tiles * 512
    args = (sched.sched_coef, sched.sched_nbr, sched.sched_lf, sched.sched_group,
            sched.sched_fbkt)
    rec = WC.records_host(*args, n)
    assert rec.shape == (sched.num_symbols, WC.REC_WORDS) and rec.dtype == np.int32
    assert rec[:, 1:7].max() == n
    with pytest.raises(AssertionError):
        WC.records_host(*args, int(sched.sched_coef.max()) - 1)
    records = WC.upload(rec, n, "cpu")
    F = sched.num_fine
    vp = torch.zeros((1, F, 6), dtype=torch.float32)
    with pytest.raises(ValueError):
        WC.wave_contexts(torch.zeros((1, n), dtype=torch.int32), records, vp, vp, 1)


@pytest.mark.parametrize("h,w,c,seed", SHAPES)
def test_slot_order_matches_records_and_dense_scatter(h, w, c, seed):
    """V's slot order (slot_order_host, attached to a grid program's
    records by from_host) holds each wave of records_host as a permutation
    sorted by slot, and the plain V through it (the rule from
    SLOT_ORDER_MIN pairs on) stores what frave_tpu's dense chain scatters
    (its scatter_coefs at the wave's wslot) and what schedule order
    stores."""
    nl = default_num_lanes(get_schedule(h, w, mode="grid").num_symbols)
    prog = PT.get_program(h, w, nl, c, "cpu")
    starts = GD.wave_starts(prog.waves)
    rec = prog.records.rec.numpy()
    order = WC.slot_order_host(rec, [(k0, wd.kw) for wd, k0 in zip(prog.waves, starts)])
    records = prog.records  # from_host attaches the order (V's rule walks it)
    np.testing.assert_array_equal(records.order.numpy(), order)
    waves_j = GDJ.get_wave_devs(get_geometry_j(h, w, 9), get_schedule_j(h, w, mode="grid"), nl,
                                prog.n_slots)
    rng = np.random.default_rng(seed)
    B = 2
    for wd, wj, k0 in zip(prog.waves, waves_j, starts):
        q, slot = order[k0:k0 + wd.kw, 0], order[k0:k0 + wd.kw, 1]
        np.testing.assert_array_equal(np.sort(q), np.arange(wd.kw))
        np.testing.assert_array_equal(slot, rec[k0 + q, 0])
        assert (np.diff(slot) > 0).all()
        if wd.kw == 0:
            continue
        syms = torch.from_numpy(rng.integers(0, 1024, size=(1, B, wd.rows, c, nl)).astype(np.int32))
        preds = torch.from_numpy(rng.integers(-255, 256, size=(B * c, wd.kw)).astype(np.int32))
        got = torch.zeros((B * c, prog.n_slots + 1), dtype=torch.int32)
        WC.wave_finish(syms, preds, records, (k0, wd.kw, nl), got, c, slot_order=True)
        plain = torch.zeros_like(got)
        WC.wave_finish(syms, preds, records, (k0, wd.kw, nl), plain, c, slot_order=False)
        np.testing.assert_array_equal(got.numpy(), plain.numpy())
        vals = syms[0].permute(0, 2, 1, 3).reshape(B * c, wd.rows * nl)[:, :wd.kw]
        vals = (T.unpack_signed(vals) + preds).to(torch.int32).numpy()
        want = jnp.zeros((B * c, prog.n_slots + 1), jnp.int32).at[:, wj.wslot].set(
            jnp.asarray(vals), unique_indices=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("images,symbols", [(1, 1), (1, 2_098_176), (3, 300), (4, 32_896),
                                            (64, 32_896), (64, 5), (7, 1000)])
def test_launch_plan_covers_every_symbol_and_image_once(images, symbols):
    """W's and V's launch rule: a power-of-two image group count up to the
    batch (at most MAX_GROUPS), tiles of BLOCK / groups symbols that cover
    the symbols, no more blocks than are resident or than there are tiles.
    That the kernels' walk of it takes every (symbol, image) pair once is
    the card-only tests' (tests/test_torch_cuda.py: more tiles than
    blocks, waves smaller than a tile)."""
    sms, per_sm = 132, 3
    plan = WC.plan_rule(images, symbols, sms, per_sm)
    assert plan.groups & (plan.groups - 1) == 0 and plan.groups <= min(images, WC.MAX_GROUPS)
    assert plan.groups * 2 > min(images, WC.MAX_GROUPS)
    assert plan.tile * plan.groups == WC.BLOCK
    assert plan.tiles == -(-symbols // plan.tile)
    assert plan.blocks == min(plan.tiles, sms * per_sm)
    assert (plan.tiles - 1) * plan.tile < symbols <= plan.tiles * plan.tile
    with pytest.raises(ValueError):
        WC.plan_rule(images, 0, sms, per_sm)
