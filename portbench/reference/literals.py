"""Tame-twindragon displacement literals.

The codec unfolds each tile's binary tree onto the pixel grid by adding a
per-level integer displacement ("literal") — a rounded power of the
tame-twindragon complex base b = (1 + i*sqrt(7)) / 2, |b|^2 = 2.

Reference: pagmerek/frave crates/libfri/src/fractal.rs:51-86 hardcodes 30
literals (with the float generator left in a comment at fractal.rs:3-23).
We re-derive the generator so depth is not capped by a fixed table, and
keep the same values for the indices the reference can reach.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Tuple

Complexi = Tuple[int, int]  # (re, im)


@lru_cache(maxsize=None)
def generate_literals(n: int, d: float = 1.0) -> Tuple[Complexi, ...]:
    """Re-derivation of the commented-out generator (fractal.rs:3-23).

    base = d/2 + i*sqrt(2 - (d/2)^2); literal[k] for k >= 1 is
    (-1)^k * (round(-pow.re / base.re), round(pow.im / base.im)) with
    pow = base^(k-1); literal[0] = i, and entries 1 and 2 are swapped.
    d=1 gives the tame twindragon (|base|^2 = 2). The odd-power sign flip
    is not in the reference's commented-out generator (fractal.rs:3-23)
    but is required to reproduce its actual LITERALS table — verified
    entry-by-entry in tests/test_literals.py.
    """
    import math

    base_re = d / 2.0
    base_im = math.sqrt(2.0 - (d / 2.0) ** 2)
    out: List[Complexi] = [(0, 0)] * n
    pow_re, pow_im = 1.0, 0.0
    for k in range(1, n):
        sign = -1 if k % 2 == 1 else 1
        out[k] = (
            sign * int(round(-pow_re / base_re)),
            sign * int(round(pow_im / base_im)),
        )
        pow_re, pow_im = (
            pow_re * base_re - pow_im * base_im,
            pow_re * base_im + pow_im * base_re,
        )
    out[0] = (0, 1)
    if n > 2:
        out[1], out[2] = out[2], out[1]
    return tuple(out)


# The working set (reference table, fractal.rs:51-86). BASE_FRAC_DEPTH = 9
# only ever touches indices 0..10 (tree unfold uses depth-level-1 <= 8;
# neighbour vectors use [scale] and [scale+1] with scale <= 9+1).
LITERALS: Tuple[Complexi, ...] = generate_literals(30)
