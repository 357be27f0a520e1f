"""Vectorized geometry construction (numpy, no per-position Python loops).

The port's copy of frave_tpu/fractal/geometry_fast.py. Position "maps"
are sorted int64 key arrays with
searchsorted lookups, and the six directional neighbour getters —
including the scale-2 membership fixups and the reference codec's quirk of
testing membership against the map indexed by *scale* — are evaluated for
all positions of a level at once.
"""

from __future__ import annotations

from typing import List

import numpy as np

from . import geometry as G

_SHIFT = np.int64(1) << 21
_BIAS = np.int64(1) << 20


def _keys(pos: np.ndarray) -> np.ndarray:
    """pos [..., 2] int64 (px, py) -> collision-free int64 keys."""
    px = pos[..., 0].astype(np.int64) + _BIAS
    py = pos[..., 1].astype(np.int64) + _BIAS
    return py * _SHIFT + px


class _LevelMap:
    """Sorted-key lookup table: position -> (tile, haar)."""

    def __init__(self, pos: np.ndarray, tiles: np.ndarray, haars: np.ndarray):
        k = _keys(pos)
        order = np.argsort(k, kind="stable")
        self.keys = k[order]
        if self.keys.size and np.any(self.keys[1:] == self.keys[:-1]):
            raise AssertionError("position collision in level map")
        self.tiles = tiles[order]
        self.haars = haars[order]

    def lookup(self, pos: np.ndarray):
        """pos [..., 2] -> (tile [...], haar [...]) with -1 where absent."""
        k = _keys(pos)
        idx = np.searchsorted(self.keys, k)
        idx_c = np.minimum(idx, max(self.keys.size - 1, 0))
        found = (
            (self.keys.size > 0)
            & (idx < self.keys.size)
            & (self.keys[idx_c] == k)
        )
        t = np.where(found, self.tiles[idx_c], -1)
        q = np.where(found, self.haars[idx_c], -1)
        return t, q

    def contains(self, pos: np.ndarray) -> np.ndarray:
        k = _keys(pos)
        idx = np.searchsorted(self.keys, k)
        idx_c = np.minimum(idx, max(self.keys.size - 1, 0))
        return (self.keys.size > 0) & (idx < self.keys.size) & (self.keys[idx_c] == k)


def _neighbour_positions(
    pos: np.ndarray, scale: int, fixup_map: "_LevelMap"
) -> np.ndarray:
    """All six directional neighbour positions for every input position:
    pos [P, 2] -> [P, 6, 2] in getter order (left, up_left, up_right,
    right, down_left, down_right), with the scale-2 fixups of
    _neighbour_positions_dir."""
    out = np.empty((pos.shape[0], 6, 2), dtype=np.int64)
    for k in range(6):
        out[:, k] = _neighbour_positions_dir(pos, scale, fixup_map, k)
    return out


def _neighbour_positions_dir(
    pos: np.ndarray, scale: int, fixup_map: "_LevelMap", k: int
) -> np.ndarray:
    """One directional neighbour position per input position; k indexes
    getter order (left, up_left, up_right, right, down_left, down_right).
    The scale-2 fixups test membership in `fixup_map` (the map indexed by
    *scale*, i.e. level 2 — the reference codec's quirk)."""
    v = np.asarray(G.nearby_vectors(scale), dtype=np.int64)  # [6, 2]
    if k == 0:
        return pos + v[4]  # left
    if k == 3:
        return pos + v[1]  # right
    if scale != 2:
        return pos + {1: v[5], 2: v[0], 4: v[3], 5: v[2]}[k]
    one = np.asarray([1, 1], dtype=np.int64)
    if k in (4, 5):
        # down fixup: c+v[3] not in map and c+(1,1) in map
        cond = (~fixup_map.contains(pos + v[3])) & fixup_map.contains(pos + one)
        if k == 4:  # down_left
            return np.where(cond[:, None], pos + one, pos + v[3])
        return np.where(cond[:, None], pos + one + v[1], pos + v[2])  # down_right
    # up fixup: c+v[0] not in map and c+(-1,-1) in map
    cond = (~fixup_map.contains(pos + v[0])) & fixup_map.contains(pos - one)
    if k == 2:  # up_right
        return np.where(cond[:, None], pos - one, pos + v[0])
    return np.where(cond[:, None], pos - one + v[4], pos + v[5])  # up_left


def build_geometry_fast(height: int, width: int, depth: int) -> G.FractalGeometry:
    if height <= 0 or width <= 0:
        raise ValueError("empty image")
    n = 1 << depth
    off = G.tree_offsets(depth)  # [2n, 2] int64

    cand = np.asarray(G.fractal_divide(width, height, depth), dtype=np.int64)

    leaf_pos = cand[:, None, :] + off[None, n : 2 * n, :]
    inb = (
        (leaf_pos[..., 0] >= 0)
        & (leaf_pos[..., 0] < width)
        & (leaf_pos[..., 1] >= 0)
        & (leaf_pos[..., 1] < height)
    )
    keep = inb.any(axis=1)
    cand = cand[keep]
    leaf_pos = leaf_pos[keep]
    inb = inb[keep]

    order = np.lexsort((cand[:, 0], cand[:, 1]))
    centers = cand[order]
    leaf_pos = leaf_pos[order]
    inb = inb[order]
    T = centers.shape[0]

    pix_flat = leaf_pos[..., 1] * width + leaf_pos[..., 0]
    pixel_gather = np.where(inb, pix_flat, -1).astype(np.int64)
    covered = pixel_gather[pixel_gather >= 0]
    if covered.size != height * width or np.unique(covered).size != height * width:
        raise AssertionError(
            f"tile leaves do not partition the {height}x{width} image: "
            f"{covered.size} in-bounds leaves, {np.unique(covered).size} unique"
        )

    # coefficient masks, bottom-up
    mask = np.zeros((T, n), dtype=bool)
    half = n // 2
    mask[:, half:] = inb[:, 0::2] | inb[:, 1::2]
    for level in range(depth - 2, -1, -1):
        lo, hi = 1 << level, 1 << (level + 1)
        mask[:, lo:hi] = mask[:, 2 * lo : 2 * hi : 2] | mask[:, 2 * lo + 1 : 2 * hi : 2]
    mask[:, 0] = mask[:, 1]

    # per-level maps (sorted key arrays)
    tids = np.arange(T, dtype=np.int64)
    maps: List[_LevelMap] = []
    for L in range(depth):
        lo, hi = 1 << L, 1 << (L + 1)
        nL = hi - lo
        pos = (centers[:, None, :] + off[None, lo:hi, :]).reshape(-1, 2)
        t_arr = np.repeat(tids, nL)
        q_arr = np.tile(np.arange(lo, hi, dtype=np.int64), T)
        maps.append(_LevelMap(pos, t_arr, q_arr))

    # tile map (centers -> tile index; haar unused)
    tile_map = _LevelMap(centers, tids, np.zeros(T, dtype=np.int64))

    # tile_nbr: 6 directions at scale = depth (the fixup map is unused
    # unless depth == 2)
    tn_pos = _neighbour_positions(centers, depth, maps[2] if len(maps) > 2 else maps[-1])
    tile_nbr, _ = tile_map.lookup(tn_pos)  # [T, 6]

    # getter k -> column k of both tables: nbr_idx[:, 0:3] are the
    # same-level {left, up_left, up_right} slots, nbr_idx[:, 3:6] the
    # parent-resolution {right, down_left, down_right}; nbr_par is the
    # parent slot in every direction. Directions are processed one at a
    # time to keep peak memory low.
    nbr_idx = np.full((T * n, 6), -1, dtype=np.int64)
    nbr_par = np.full((T * n, 6), -1, dtype=np.int64)
    level_slots: List[np.ndarray] = [(np.arange(T, dtype=np.int64) * n).astype(np.int64)]
    for L in range(1, depth):
        lo, hi = 1 << L, 1 << (L + 1)
        nL = hi - lo
        scale = depth - L
        m = maps[L]
        # canonical order of level positions by (im, re)
        pos_all = (centers[:, None, :] + off[None, lo:hi, :]).reshape(-1, 2)
        t_all = np.repeat(tids, nL)
        q_all = np.tile(np.arange(lo, hi, dtype=np.int64), T)
        o = np.lexsort((pos_all[:, 0], pos_all[:, 1]))
        pos_o = pos_all[o]
        slots_o = (t_all[o] * n + q_all[o]).astype(np.int64)
        level_slots.append(slots_o)

        # the scale-2 fixup tests membership in maps[2] (the reference
        # quirk); for any other scale the fixup map is unused
        fix = maps[2] if len(maps) > 2 else maps[-1]
        for k in range(6):
            npos_k = _neighbour_positions_dir(pos_o, scale, fix, k)  # [P, 2]
            t_n, q_n = m.lookup(npos_k)  # [P]
            found = t_n >= 0
            par_slot = np.where(found, t_n * n + q_n // 2, -1)
            if k < 3:
                nbr_idx[slots_o, k] = np.where(found, t_n * n + q_n, -1)
            else:
                nbr_idx[slots_o, k] = par_slot
            nbr_par[slots_o, k] = par_slot

    level_of_haar = np.zeros(n, dtype=np.int64)
    if n > 1:
        level_of_haar[1:] = np.floor(np.log2(np.arange(1, n))).astype(np.int64)

    return G.FractalGeometry(
        height=height,
        width=width,
        depth=depth,
        num_tiles=T,
        centers=centers.astype(np.int32),
        offsets=off.astype(np.int32),
        pixel_gather=pixel_gather.astype(np.int32),
        coef_mask=mask,
        nbr_idx=nbr_idx.astype(np.int32),
        nbr_par=nbr_par.astype(np.int32),
        level_of_haar=level_of_haar.astype(np.int32),
        level_slots=[s.astype(np.int32) for s in level_slots],
        tile_nbr=tile_nbr.astype(np.int32),
    )
