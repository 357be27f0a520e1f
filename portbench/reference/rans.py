"""Interleaved-lane rANS entropy coder (numpy host implementation).

Design (TPU-native redesign of entropy_coding.rs:161-352):

  * 32-bit state per lane, 16-bit renormalization words, state domain
    [2^16, 2^32). With per-context scale_bits <= MAX_FREQ_BITS_CAP = 14
    (< 16) each symbol moves at most one 16-bit word in either direction —
    the key invariant that makes both directions branch-free data-parallel
    lane updates. (The reference uses the `rans` crate's 64-bit multi-stream
    coder with byte renorm and one stream per context bucket,
    entropy_coding.rs:278,332-335.)
  * NL lanes; symbol k of the wavefront schedule belongs to lane k mod NL.
    Lane membership is static (unlike the reference, where the stream is
    chosen by the data-dependent bucket, entropy_coding.rs:239), so decode
    can advance all lanes of a wavefront step concurrently; only the
    frequency-table *choice* is data-dependent.
  * Encode pushes each lane's symbols in reverse schedule order
    (LIFO, like the reference's reversed put_at, entropy_coding.rs:332-334)
    and is vectorized over lanes as a reverse scan over the [R, NL] symbol
    grid, emitting a word grid + flag grid.
  * Wire format: ONE global word stream per image, in DECODE order — for
    each wavefront step, for each channel, for each active lane, at most
    one word. By rANS renorm symmetry the word emitted while encoding
    symbol k is the word pulled while decoding symbol k, so the stream
    order is a static permutation of the emission grid
    (frave_tpu/fractal/schedule.build_stream_perm) and no per-lane word
    counts travel in the container.
"""

from __future__ import annotations

import numpy as np

RANS_L = 1 << 16  # lower bound of the normalized state interval


class StreamDecoder:
    """Stateful vectorized decoder over the single global stream.

    Per wavefront step, channels MUST be advanced in ascending order
    (decode_step(ch, ...) for ch = 0..C-1) — that is the stream's word
    order. All lanes of one (step, channel) advance at once.

    The symbol of a slot is the count of cdf entries <= slot, less one.
    That count does not depend on the entries' order, so it is read from
    a table per (channel, context) built once by a binary search over the
    sorted entries, instead of comparing every lane's slot with all 1024.
    """

    MAX_BITS = 16  # a container asking for wider slots is refused

    def __init__(
        self,
        states: np.ndarray,  # [C, NL] u32
        stream: np.ndarray,  # [W] u16 global stream
        freqs: np.ndarray,  # [C, CA, 1024]
        cdfs: np.ndarray,
        scale_bits: np.ndarray,  # [C, CA]
    ):
        self.x = states.astype(np.uint64).copy()
        self.stream = stream.astype(np.uint64)
        self.gptr = 0
        self.freqs = freqs.astype(np.uint64)
        self.cdfs = cdfs.astype(np.uint64)
        self.scale_bits = scale_bits.astype(np.uint64)
        top = int(scale_bits.max(initial=0))
        if top > self.MAX_BITS or int(scale_bits.min(initial=0)) < 0:
            raise ValueError(f"scale bits {top} outside 0..{self.MAX_BITS}")
        slots = np.arange(1 << top, dtype=np.uint64)
        C, CA = scale_bits.shape
        self.slot_sym = np.empty((C, CA, 1 << top), dtype=np.int64)
        for c in range(C):
            for k in range(CA):
                srt = np.sort(self.cdfs[c, k])
                self.slot_sym[c, k] = np.searchsorted(srt, slots, side="right") - 1

    def decode_step(self, ch: int, buckets: np.ndarray) -> np.ndarray:
        """buckets: [NL] int64, -1 = inactive. Returns symbols [NL] int64
        (undefined where inactive)."""
        x = self.x[ch]
        active = buckets >= 0
        k = np.where(active, buckets, 0)
        bi = self.scale_bits[ch][k]
        mask = (np.uint64(1) << bi) - np.uint64(1)
        slot = x & mask
        sym = self.slot_sym[ch][k, slot.astype(np.int64)]
        fr = self.freqs[ch][k, sym]
        cd = self.cdfs[ch][k, sym]
        x_new = fr * (x >> bi) + slot - cd
        need = active & (x_new < RANS_L)
        offs = np.cumsum(need) - 1
        idx = np.clip(self.gptr + offs, 0, max(self.stream.shape[0] - 1, 0))
        w = self.stream[idx] if self.stream.size else np.zeros(len(idx), np.uint64)
        x_new = np.where(need, (x_new << np.uint64(16)) | w, x_new)
        self.gptr += int(need.sum())
        self.x[ch] = np.where(active, x_new, x)
        return sym
