"""frave_tpu_torch rANS against frave_tpu's: the reverse encode scan
(schedule-order symbols under a row map, held against rans_jax on the
grids pipeline_jax's wave-segment rule builds), grid stream compaction
and the u32 pair pack bit for bit against rans_jax; the whole-wave
decode bit for bit against rans_jax's compare-free row chain on garbage
waves, and recovering what the port encoded on a valid one."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from frave_tpu.entropy.tables import CONTEXT_AMOUNT
from frave_tpu.fractal.schedule import get_schedule, grid_row_lane
from frave_tpu.ops import rans_jax as RJ
from frave_tpu_torch.kernel_check import (
    decode_problem,
    draw_wave_sizes,
    garbage_wave,
    rans_problem,
    schedule_problem,
)
from frave_tpu_torch.ops import rans_torch as RT


def _wave_segs(wave_sizes, nl):
    """pipeline_jax.CodecProgram's _wave_segs: (k0, ws, padw) a wave."""
    segs, k0 = [], 0
    for ws in wave_sizes:
        segs.append((k0, ws, -(-ws // nl) * nl - ws))
        k0 += ws
    return segs


def _jax_grid(a, fill, segs, R, nl):
    """pipeline_jax.encode_fused's grid(): per-wave slice + pad."""
    C = a.shape[0]
    parts = []
    for k0, ws, padw in segs:
        parts.append(a[:, k0 : k0 + ws])
        if padw:
            parts.append(jnp.full((C, padw), fill, dtype=a.dtype))
    return jnp.concatenate(parts, axis=1).reshape(C, R, nl).transpose(1, 0, 2)


def _jax_encode(args, wave_sizes, nl):
    """rans_jax.encode_scan on the grids of the wave-segment rule."""
    sym, bkt, row_k0, _, freqs, cdfs, bits = (a.numpy() for a in args)
    segs, R = _wave_segs(wave_sizes, nl), row_k0.shape[0]
    C, K = sym.shape
    st, w, f = RJ.encode_scan(
        _jax_grid(jnp.asarray(sym), 0, segs, R, nl),
        _jax_grid(jnp.asarray(bkt), 0, segs, R, nl),
        _jax_grid(jnp.ones((C, K), dtype=jnp.bool_), False, segs, R, nl),
        jnp.asarray(freqs.astype(np.uint32)), jnp.asarray(cdfs.astype(np.uint32)),
        jnp.asarray(bits),
    )
    return np.asarray(st), np.asarray(w), np.asarray(f)


def _assert_encode_matches(args, wave_sizes, nl):
    st, w, f = RT.encode_scan(*args, nl)
    rst, rw, rf = _jax_encode(args, wave_sizes, nl)
    np.testing.assert_array_equal(st.numpy().astype(np.uint32), rst)
    np.testing.assert_array_equal(w.numpy().view(np.uint16), rw)
    np.testing.assert_array_equal(f.numpy(), rf)
    assert f.any() and not f.all()


def test_encode_scan_matches_rans_jax():
    rng = np.random.default_rng(0)
    for R, C, NL in ((9, 1, 32), (14, 3, 64)):
        sizes = draw_wave_sizes(rng, R, NL)
        _assert_encode_matches(schedule_problem(rng, sizes, C, NL), sizes, NL)


@pytest.mark.parametrize("C", [1, 3])
def test_encode_scan_on_many_waves_matches_rans_jax(C):
    """Seven waves: an empty one, one of a single partial row, one of a
    single full row, the others several rows with a partly filled last
    one (NL = 48 is no power of two)."""
    NL = 48
    sizes = [3 * NL + 5, 0, 17, NL, 2 * NL + 47, 1, 4 * NL + 30]
    _assert_encode_matches(schedule_problem(np.random.default_rng(4 + C), sizes, C, NL), sizes, NL)


@pytest.mark.parametrize("h,w,nl", [(64, 64, 32), (96, 80, 128)])
def test_row_map_matches_grid_row_lane(h, w, nl):
    """The port's row map puts schedule position k in the (row, lane) of
    frave_tpu's schedule.grid_row_lane, and pads the rest."""
    sched = get_schedule(h, w, mode="grid")
    row, lane, R, _ = grid_row_lane(sched, nl)
    row_k0, row_len = RT.row_map(sched.wave_sizes, nl)
    assert row_k0.shape == row_len.shape == (R,)
    k = np.arange(sched.num_symbols)
    grid, valid = RT.schedule_grid(torch.from_numpy(k[None]), torch.from_numpy(row_k0),
                                   torch.from_numpy(row_len), nl)
    np.testing.assert_array_equal(grid.numpy()[row, 0, lane], k)
    assert int(valid.sum()) == sched.num_symbols
    assert bool(valid.numpy()[row, lane].all())


def test_encode_scan_rejects_bad_operands():
    args = list(rans_problem(np.random.default_rng(3), 4, 1, 32))
    with pytest.raises(TypeError):
        RT.encode_scan(args[0].to(torch.int64), *args[1:], 32)
    with pytest.raises(ValueError):
        RT.encode_scan(*args[:2], args[2][:-1], *args[3:], 32)
    with pytest.raises(ValueError):
        RT.encode_scan(*args, 0)


def test_stream_compact_and_pair_pack_match_jax():
    rng = np.random.default_rng(1)
    R, C, NL = 11, 3, 32
    args = rans_problem(rng, R, C, NL)
    _, w, f = RT.encode_scan(*args, NL)
    kc = C * int(args[3].sum()) + 1  # odd capacity: the pack pads one word
    stream, total = RT.stream_compact_grid(w, f, kc)
    rstream, rtotal = RJ.stream_compact_grid(
        jnp.asarray(w.numpy().view(np.uint16)), jnp.asarray(f.numpy()), kc=kc
    )
    assert int(total) == int(rtotal) == int(f.sum())
    np.testing.assert_array_equal(stream.numpy().view(np.uint16), np.asarray(rstream))
    packed = RT.pack_u16_pairs(stream)
    ref = jax.lax.bitcast_convert_type(
        jnp.concatenate([rstream, jnp.zeros(1, jnp.uint16)]).reshape(-1, 2), jnp.uint32
    )
    np.testing.assert_array_equal(packed.numpy().view(np.uint32), np.asarray(ref))


def test_decode_rows_recover_symbols_and_initial_states():
    """A valid wave (encode_scan, then stream_compact_grid) decodes in one
    decode_scan_wave call back to the encoded symbols on every valid slot,
    to the encoder's initial states 2^16, and to the end of the stream."""
    R, C, NL = 12, 3, 64
    sym, bkt, row_k0, row_len, _, _, _ = rans_problem(np.random.default_rng(2), R, C, NL)
    x0, gptr0, bkt_d, active, stream, tabs = decode_problem(
        np.random.default_rng(2), R, C, NL, "valid"
    )
    sym_grid, valid = RT.schedule_grid(sym, row_k0, row_len, NL)
    assert torch.equal(bkt_d, RT.schedule_grid(bkt, row_k0, row_len, NL)[0])
    assert torch.equal(active, valid)
    syms, x, gptr = RT.decode_scan_wave(x0, gptr0, bkt_d, active, stream, tabs)
    v = valid[:, None, :].expand(R, C, NL)
    assert torch.equal(syms[v], sym_grid[v])
    assert int(gptr) == stream.shape[0] - C * NL
    assert bool((x == RT.RANS_L).all())


def _comparefree_chain(x0, buckets, active, stream, cdfs, bits):
    """frave_tpu's plain reference for the whole-wave kernel: the row
    chain of rans_jax.decode_step_comparefree (as tests/test_pallas_rans.py
    holds pallas_rans.decode_scan_wave to it)."""
    tabs = RJ.prepare_compare_tables(jnp.asarray(cdfs), jnp.asarray(bits))
    iota_ca = jnp.arange(CONTEXT_AMOUNT, dtype=jnp.int32)
    x = jnp.asarray(x0.astype(np.uint32))
    gptr = jnp.int32(0)
    s16 = jnp.asarray(stream.astype(np.uint16))
    step = jax.jit(RJ.decode_step_comparefree)
    syms = []
    for r in range(buckets.shape[0]):
        oh = jnp.asarray(jnp.asarray(buckets[r])[..., None] == iota_ca, dtype=jnp.bfloat16)
        sym, x, gptr = step(x, gptr, oh, jnp.asarray(active[r]), s16, tabs)
        syms.append(np.asarray(sym))
    return np.stack(syms), np.asarray(x), int(gptr)


@pytest.mark.parametrize("C,NL,R", [(1, 32, 5), (3, 64, 7), (3, 200, 6)])
def test_decode_scan_wave_matches_comparefree_chain(C, NL, R):
    """Seeded garbage waves (random staircases with zero-frequency runs,
    bits in [8, 14], 80% active lanes; NL = 200 is no multiple of 128):
    x' and gptr' equal everywhere, the symbols on active lanes (the JAX
    chain's inactive-lane symbols are its own garbage)."""
    x0, bkt, act, stream, cdfs, bits = garbage_wave(np.random.default_rng(C * 100 + NL), R, C, NL)
    ref_syms, ref_x, ref_g = _comparefree_chain(x0, bkt, act, stream, cdfs, bits)
    syms, x, gptr = RT.decode_scan_wave(
        torch.from_numpy(x0), torch.zeros((), dtype=torch.int64), torch.from_numpy(bkt),
        torch.from_numpy(act), torch.from_numpy(stream),
        RT.decode_tables(torch.from_numpy(cdfs), torch.from_numpy(bits)),
    )
    np.testing.assert_array_equal(x.numpy().astype(np.uint32), ref_x)
    assert int(gptr) == ref_g
    act3 = np.broadcast_to(act[:, None, :], (R, C, NL))
    np.testing.assert_array_equal(syms.numpy()[act3], ref_syms[act3])
    assert 0 < ref_g < R * C * NL  # some lanes renormed, not all
