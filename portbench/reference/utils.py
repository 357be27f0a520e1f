"""Small integer utilities with exact reference semantics.

Reference: pagmerek/frave crates/libfri/src/utils.rs:5-48.
All functions here must be bit-exact with their Rust counterparts because
they participate in the coefficient <-> symbol mapping.
"""

from __future__ import annotations

import numpy as np


def unpack_signed(k):
    """Inverse zig-zag map u32 -> i32. Reference utils.rs:42-48."""
    k = np.asarray(k, dtype=np.int64)
    return np.where(k % 2 == 0, k // 2, -((k + 1) // 2)).astype(np.int64)


def trunc_div(a, q):
    """Rust-style truncated integer division (toward zero), vectorized.

    The reference's lifting and quantization use Rust `/` on i32, which
    truncates toward zero (wavelet_transform.rs:211-218, quantization.rs:17).
    numpy's // floors, so negative operands need the sign fix-up.
    """
    a = np.asarray(a)
    q = np.asarray(q)
    return np.where(a < 0, -((-a) // q), a // q)
