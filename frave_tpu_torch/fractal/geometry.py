"""Fractal tiling geometry as dense index tensors.

The port's copy of frave_tpu/fractal/geometry.py: one host computation per
(height, width, depth) gives the tile centers, the tree offsets, the pixel
gather, the coefficient masks, the neighbour slots of every mode (nbr_idx,
the parity mode's same-level taps; nbr_par, the parent-resolution taps of
the parallel and grid modes), the per-level canonical slot lists and the
tile-lattice neighbours as numpy arrays. get_geometry builds them with the
native library (native.build_geometry_native, csrc/geometry.cpp); the
vectorized numpy builder (fractal/geometry_fast.py) is its plain version,
which the tests hold it equal to. The JAX package's loop-based reference
builder is left out.

Coordinate conventions: a position is a complex integer (re, im) with
re = x (column) and im = y (row). A "flat coefficient index" is
tile_index * 2**depth + haar_index, indexing the [num_tiles, 2**depth]
coefficient tensor.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Tuple

import numpy as np

from .literals import LITERALS

# Fixed tile depth: 512 pixels per tile (reference wavelet_transform.rs:39).
BASE_FRAC_DEPTH = 9

Pos = Tuple[int, int]


def nearby_vectors(scale: int) -> List[Pos]:
    """Six neighbour displacement vectors at a given scale.

    scale = depth - level, with scales 1-3 special-cased as in the
    reference codec. Order matters: the directional getters index this
    list.
    """
    if scale == 1:
        zl, zmd = (-1, 1), (0, 2)
    elif scale == 2:
        zl, zmd = (-2, 0), (0, -2)
    elif scale == 3:
        zl, zmd = (-3, -1), (-1, -3)
    else:
        zl = LITERALS[scale]
        l1 = LITERALS[scale + 1]
        zmd = (l1[0] + zl[0], l1[1] + zl[1])
    return [
        zl,
        (zl[0] - zmd[0], zl[1] - zmd[1]),
        (-zmd[0], -zmd[1]),
        (-zl[0], -zl[1]),
        (zmd[0] - zl[0], zmd[1] - zl[1]),
        zmd,
    ]


def _add(a: Pos, b: Pos) -> Pos:
    return (a[0] + b[0], a[1] + b[1])


def tree_offsets(depth: int) -> np.ndarray:
    """Per-node displacement from tile center, [2**(depth+1), 2] int32.

    Unfolds the binary tree: off[0] = off[1] = 0; off[2p] = off[p];
    off[2p+1] = off[p] + LITERALS[depth - level - 1]. Shared by every
    tile.
    """
    n = 1 << (depth + 1)
    off = np.zeros((n, 2), dtype=np.int64)
    for level in range(depth):
        lo, hi = 1 << level, 1 << (level + 1)
        lit = np.asarray(LITERALS[depth - level - 1], dtype=np.int64)
        off[2 * lo : 2 * hi : 2] = off[lo:hi]
        off[2 * lo + 1 : 2 * hi : 2] = off[lo:hi] + lit
    return off


def fractal_divide(width: int, height: int, depth: int) -> List[Pos]:
    """BFS over the 6-neighbour tile lattice from the image center.

    Returns candidate tile centers before the any-in-bounds-leaf retention
    filter. The BFS expands every lattice center inside the image
    rectangle dilated by the maximum leaf-offset + neighbour-step radius,
    which contains every tile owning an in-bounds leaf and every lattice
    path between such tiles, so the kept set after retention is exactly
    {tiles with >= 1 in-bounds leaf} (the builder asserts coverage).
    """
    vecs = nearby_vectors(depth)
    off = tree_offsets(depth)
    n = 1 << depth
    radius = int(np.abs(off[n : 2 * n]).max()) + max(
        max(abs(v[0]), abs(v[1])) for v in vecs
    )
    lo_x, hi_x = -radius, width + radius
    lo_y, hi_y = -radius, height + radius
    start = (width // 2, height // 2)
    from collections import deque

    to_add = deque([start])
    queued = {start}
    out: List[Pos] = []
    while to_add:
        pos = to_add.popleft()
        out.append(pos)
        for v in vecs:
            nb = _add(pos, v)
            if nb in queued:
                continue
            if nb[0] < lo_x or nb[0] > hi_x or nb[1] < lo_y or nb[1] > hi_y:
                continue
            queued.add(nb)
            to_add.append(nb)
    return out


@dataclasses.dataclass
class FractalGeometry:
    """All static geometry for one (height, width, depth)."""

    height: int
    width: int
    depth: int
    num_tiles: int  # kept tiles T
    centers: np.ndarray  # [T, 2] int32, canonical (im, re) order
    offsets: np.ndarray  # [2**(depth+1), 2] int32 tree offsets
    pixel_gather: np.ndarray  # [T, 2**depth] int32 flat pixel index or -1 (leaf j)
    coef_mask: np.ndarray  # [T, 2**depth] bool: coefficient present
    # parity mode's taps: same-level {left, up_left, up_right} in columns
    # 0:3, parent-resolution {right, down_left, down_right} in 3:6
    nbr_idx: np.ndarray  # [T * 2**depth, 6] int32, -1 absent
    # all six directional neighbours read at the PARENT haar slot (fully
    # decoded when a level starts), so a whole level is one decode wave
    nbr_par: np.ndarray  # [T * 2**depth, 6] int32, -1 absent
    level_of_haar: np.ndarray  # [2**depth] int32: 0 for haar 0/1, else floor(log2(haar))
    # per-level canonical position lists as flat coefficient slots
    level_slots: List[np.ndarray]  # level L in [0, depth): [n_L] int32
    # tile-lattice neighbours of the two level-0 phases in getter order
    # (left, up_left, up_right, right, down_left, down_right)
    tile_nbr: np.ndarray  # [T, 6] int32 tile index or -1

    @property
    def nodes_per_tile(self) -> int:
        return 1 << self.depth

    @property
    def num_coef_slots(self) -> int:
        return self.num_tiles * self.nodes_per_tile


_geometry_cache: Dict[Tuple[int, int, int], FractalGeometry] = {}
_cache_lock = threading.Lock()


def get_geometry(height: int, width: int, depth: int = BASE_FRAC_DEPTH) -> FractalGeometry:
    """Cached geometry per (h, w, depth), built by the native library
    (native.build_geometry_native)."""
    key = (height, width, depth)
    with _cache_lock:
        geo = _geometry_cache.get(key)
    if geo is None:
        from ..native import build_geometry_native

        geo = build_geometry_native(height, width, depth)
        with _cache_lock:
            _geometry_cache[key] = geo
    return geo
