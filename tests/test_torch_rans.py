"""frave_tpu_torch rANS against frave_tpu's: the reverse encode scan,
grid stream compaction and the u32 pair pack bit for bit against
rans_jax; the whole-wave decode bit for bit against rans_jax's
compare-free row chain on garbage waves, and recovering what the port
encoded on a valid one."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from frave_tpu.entropy.tables import CONTEXT_AMOUNT
from frave_tpu.ops import rans_jax as RJ
from frave_tpu_torch.kernel_check import decode_problem, garbage_wave, rans_problem
from frave_tpu_torch.ops import rans_torch as RT


random_grids = rans_problem


def _jax_encode(args):
    sym, bkt, valid, freqs, cdfs, bits = (a.numpy() for a in args)
    st, w, f = RJ.encode_scan(
        jnp.asarray(sym), jnp.asarray(bkt), jnp.asarray(valid.astype(bool)),
        jnp.asarray(freqs.astype(np.uint32)), jnp.asarray(cdfs.astype(np.uint32)),
        jnp.asarray(bits),
    )
    return np.asarray(st), np.asarray(w), np.asarray(f)


def test_encode_scan_matches_rans_jax():
    rng = np.random.default_rng(0)
    for R, C, NL in ((9, 1, 32), (14, 3, 64)):
        args = random_grids(rng, R, C, NL)
        st, w, f = RT.encode_scan(*args)
        rst, rw, rf = _jax_encode(args)
        np.testing.assert_array_equal(st.numpy().astype(np.uint32), rst)
        np.testing.assert_array_equal(w.numpy().view(np.uint16), rw)
        np.testing.assert_array_equal(f.numpy(), rf)
        assert f.any() and not f.all()


def test_stream_compact_and_pair_pack_match_jax():
    rng = np.random.default_rng(1)
    R, C, NL = 11, 3, 32
    args = random_grids(rng, R, C, NL)
    _, w, f = RT.encode_scan(*args)
    kc = int(args[2].sum()) + 1  # odd capacity: the pack pads one word
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
    sym, bkt, valid, _, _, _ = random_grids(np.random.default_rng(2), R, C, NL)
    x0, gptr0, bkt_d, active, stream, tabs = decode_problem(
        np.random.default_rng(2), R, C, NL, "valid"
    )
    assert torch.equal(bkt_d, bkt)
    syms, x, gptr = RT.decode_scan_wave(x0, gptr0, bkt_d, active, stream, tabs)
    v = valid.to(torch.bool)
    assert torch.equal(syms[v], sym[v])
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
