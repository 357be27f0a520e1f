"""frave_tpu_torch context tables against frave_tpu's device twin
(entropy/tables_jax.py) and the host tables (entropy/tables.py), on the
encode side (from histograms) and the decode side (from wire fields):
bits, frequencies, cdfs and off-lists must be equal, integer for integer."""

import numpy as np
import jax.numpy as jnp
import torch

from frave_tpu.entropy import tables as H
from frave_tpu.entropy import tables_jax as TJ
from frave_tpu.entropy.tables import (
    ALPHABET_SIZE,
    CONTEXT_AMOUNT,
    NUM_SCALES,
    _GRID_LOG2,
    _LAPLACE_GRID_ROWS,
)
from frave_tpu_torch.entropy import tables_torch as TT

LAP = torch.from_numpy(_LAPLACE_GRID_ROWS)
GLOG2 = torch.from_numpy(_GRID_LOG2)
GZERO = torch.from_numpy((_LAPLACE_GRID_ROWS == 0).astype(np.float32))


def _histograms(seed, C=2):
    """Per-context histograms of every regime: empty, one symbol, peaked,
    wide noise (bits bump), sparse outliers far out (off-list)."""
    rng = np.random.default_rng(seed)
    h = np.zeros((C, CONTEXT_AMOUNT, ALPHABET_SIZE), dtype=np.int64)
    for c in range(C):
        for k in range(CONTEXT_AMOUNT):
            kind = (k + c) % 5
            if kind == 1:
                h[c, k, 0] = rng.integers(1, 5000)
            elif kind == 2:
                s = np.minimum(rng.geometric(0.3, 3000) - 1, ALPHABET_SIZE - 1)
                h[c, k] = np.bincount(s, minlength=ALPHABET_SIZE)
            elif kind == 3:
                h[c, k] = rng.integers(0, 40, ALPHABET_SIZE)
            elif kind == 4:
                s = np.minimum(rng.geometric(0.05, 20000) - 1, ALPHABET_SIZE - 1)
                h[c, k] = np.bincount(s, minlength=ALPHABET_SIZE)
                h[c, k, rng.integers(600, ALPHABET_SIZE, 7)] += 1
    return h


def test_select_scales_matches_jax_and_host():
    h = _histograms(0, C=3)
    got = TT.select_scales_device(torch.from_numpy(h), GLOG2, GZERO).numpy()
    ref = np.asarray(
        TJ.select_scales_device(
            jnp.asarray(h.astype(np.int32)), jnp.asarray(_GRID_LOG2),
            jnp.asarray(GZERO.numpy()),
        )
    )
    np.testing.assert_array_equal(got, ref)
    for c in range(h.shape[0]):
        for k in range(CONTEXT_AMOUNT):
            tot = int(h[c, k].sum())
            bits = min(tot.bit_length() - 1, H.ENC_FREQ_BITS_CAP) if tot else H.MIN_FREQ_BITS
            bits = max(bits, H.MIN_FREQ_BITS)
            assert got[c, k] == H.select_scale(h[c, k], bits), (c, k)


def test_finalize_encode_side_matches_jax_and_host():
    h = _histograms(1, C=2)
    scales = TT.select_scales_device(torch.from_numpy(h), GLOG2, GZERO)
    bits, freqs, cdfs, off = TT.finalize_contexts_device(
        torch.from_numpy(h), LAP, scale_idx=scales
    )
    rb, rf, rc, ro = TJ.finalize_contexts_device(
        jnp.asarray(h.astype(np.int32)), jnp.asarray(_LAPLACE_GRID_ROWS),
        scale_idx=jnp.asarray(scales.numpy().astype(np.int32)),
    )
    for a, b in ((bits, rb), (freqs, rf), (cdfs, rc), (off, ro)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for c in range(h.shape[0]):
        for k in range(CONTEXT_AMOUNT):
            if h[c, k].sum():
                ref = H.context_from_histogram(h[c, k].astype(np.uint32), k)
                assert ref.scale_idx == int(scales[c, k])
            else:
                # an empty context codes no symbol: the host keeps the
                # bucket's own row there, the device twins (jax and the
                # port) the argmax of all-zero gains, row 0
                assert int(scales[c, k]) == 0
                ref = H.finalize_context(h[c, k], k, H.MIN_FREQ_BITS, scale_idx=0)
            assert ref.max_freq_bits == int(bits[c, k])
            np.testing.assert_array_equal(freqs[c, k].numpy(), ref.freqs)
            np.testing.assert_array_equal(cdfs[c, k].numpy(), ref.cdf)
            np.testing.assert_array_equal(
                np.nonzero(off[c, k].numpy())[0], ref.off_distribution_values
            )


def test_finalize_decode_side_matches_jax_and_host():
    """Wire fields only: zero histogram, wire bits (13/14-bit legacy
    values included), off-lists and scale indices."""
    rng = np.random.default_rng(2)
    C = 2
    wire_bits = rng.integers(8, 15, size=(C, CONTEXT_AMOUNT))
    scales = rng.integers(0, NUM_SCALES, size=(C, CONTEXT_AMOUNT))
    off = np.zeros((C, CONTEXT_AMOUNT, ALPHABET_SIZE), dtype=bool)
    for c in range(C):
        for k in range(CONTEXT_AMOUNT):
            off[c, k, rng.integers(0, ALPHABET_SIZE, rng.integers(0, 30))] = True
    zero = np.zeros((C, CONTEXT_AMOUNT, ALPHABET_SIZE), dtype=np.int64)
    bits, freqs, cdfs, om = TT.finalize_contexts_device(
        torch.from_numpy(zero), LAP, bits0=torch.from_numpy(wire_bits),
        off_mask_in=torch.from_numpy(off), scale_idx=torch.from_numpy(scales),
    )
    rb, rf, rc, ro = TJ.finalize_contexts_device(
        jnp.asarray(zero.astype(np.int32)), jnp.asarray(_LAPLACE_GRID_ROWS),
        bits0=jnp.asarray(wire_bits.astype(np.int32)), off_mask_in=jnp.asarray(off),
        scale_idx=jnp.asarray(scales.astype(np.int32)),
    )
    for a, b in ((bits, rb), (freqs, rf), (cdfs, rc), (om, ro)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for c in range(C):
        for k in range(CONTEXT_AMOUNT):
            ref = H.context_from_wire(
                k, int(wire_bits[c, k]), np.nonzero(off[c, k])[0].tolist(),
                scale_idx=int(scales[c, k]),
            )
            assert ref.max_freq_bits == int(bits[c, k])
            np.testing.assert_array_equal(freqs[c, k].numpy(), ref.freqs)
            np.testing.assert_array_equal(cdfs[c, k].numpy(), ref.cdf)


def test_finalize_legacy_rows_without_scale_index():
    """scale_idx omitted: every context uses its own legacy grid row."""
    h = _histograms(3, C=1)
    bits, freqs, cdfs, _ = TT.finalize_contexts_device(torch.from_numpy(h), LAP)
    for k in range(CONTEXT_AMOUNT):
        ref = H.context_from_histogram(h[0, k].astype(np.uint32), k, adaptive_scale=False)
        assert ref.max_freq_bits == int(bits[0, k])
        np.testing.assert_array_equal(freqs[0, k].numpy(), ref.freqs)
        np.testing.assert_array_equal(cdfs[0, k].numpy(), ref.cdf)
