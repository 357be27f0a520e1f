"""frave_tpu_torch rANS against frave_tpu's: the reverse encode scan,
grid stream compaction and the u32 pair pack bit for bit against
rans_jax, and the port's decode rows recovering what it encoded."""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from frave_tpu.ops import rans_jax as RJ
from frave_tpu_torch.kernel_check import rans_problem
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
    rng = np.random.default_rng(2)
    R, C, NL = 12, 3, 64
    sym, bkt, valid, freqs, cdfs, bits = random_grids(rng, R, C, NL)
    states, w, f = RT.encode_scan(sym, bkt, valid, freqs, cdfs, bits)
    kc = R * C * NL
    stream, total = RT.stream_compact_grid(w, f, kc)
    W = int(total)
    padded = torch.zeros(W + C * NL, dtype=torch.int64)
    padded[:W] = stream[:W].to(torch.int64) & 0xFFFF
    tabs = RT.decode_tables(freqs, cdfs, bits)
    x, gptr = states.clone(), torch.zeros((), dtype=torch.int64)
    active = valid[:, 0].to(torch.bool)  # lane activity is channel-independent
    for r in range(R):
        s, x, gptr = RT.decode_row(x, gptr, bkt[r].to(torch.int64), active[r], padded, tabs)
        v = active[r][None].expand(C, NL)
        assert torch.equal(s[v], sym[r].to(torch.int64)[v])
    assert int(gptr) == W
    assert bool((x == RT.RANS_L).all())
