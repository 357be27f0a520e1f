"""Per-level dense lattice grids: the grid schedule's coefficient layout.

The port's copy of the parts of frave_tpu/fractal/lattice.py that the
port's path reaches: the grids (build_lattice_grids, get_lattice_grids)
and DenseGridUnavailable. Every tree level's node positions form (a
coset of) a 2D integer lattice (s = depth - level): the six neighbour
directions of geometry.nearby_vectors are lattice vectors, and the
parent level's positions are an index-2 sublattice. The grid schedule
(fractal/schedule.py) orders each wave's symbols by the raster order of
its level's dense [A, B] grid, and a program decodes whole waves only
where every level's child -> parent cell map is exactly affine on each
residue class (fixups not None); elsewhere (tiny shapes) it decodes
through kernel D's step tensors.

The reference codec's scale-2 conditional neighbour fixups break pure
shift structure for a boundary-proportional handful of nodes; those are
recorded as explicit correction lists. Everything here is host-side
numpy, computed once per (h, w, depth) and verified cell by cell against
geometry.nbr_par.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from .geometry import BASE_FRAC_DEPTH, FractalGeometry, get_geometry, nearby_vectors
from .literals import LITERALS


def _lagrange_reduce(v1: np.ndarray, v2: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Gauss/Lagrange reduction: shortest basis of the 2D lattice."""
    v1, v2 = v1.astype(np.int64), v2.astype(np.int64)
    if v1 @ v1 > v2 @ v2:
        v1, v2 = v2, v1
    while True:
        # round(<v2, v1> / <v1, v1>)
        m = int(np.floor_divide(2 * (v2 @ v1) + (v1 @ v1), 2 * (v1 @ v1)))
        v2 = v2 - m * v1
        if v1 @ v1 <= v2 @ v2:
            return v1, v2
        v1, v2 = v2, v1


def _lattice_basis(vs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Reduced basis of the lattice generated by the rows of vs.

    Textbook row-HNF for an N x 2 integer matrix: Euclid down column 0
    (repeatedly subtract multiples of the row with the smallest nonzero
    |col0| from every other row) until one row u carries column 0; the
    remaining rows lie on the col1 axis and collapse to (0, gcd)."""
    rows = [r for r in np.asarray(vs, dtype=np.int64) if r.any()]
    if not rows:
        raise AssertionError("degenerate lattice")
    rows = np.stack(rows)
    while True:
        nz = rows[rows[:, 0] != 0]
        if nz.shape[0] <= 1:
            break
        pivot = nz[np.abs(nz[:, 0]).argmin()]
        mask = rows[:, 0] != 0
        q = rows[mask, 0] // pivot[0]
        rows[mask] -= q[:, None] * pivot[None, :]
        # keep the pivot itself (its quotient was 1 -> became 0): re-add
        rows = np.concatenate([rows, pivot[None, :]], axis=0)
        rows = rows[rows.any(axis=1)]
    nzc0 = rows[rows[:, 0] != 0]
    if nzc0.shape[0] == 0:
        raise AssertionError("rank-1 lattice")
    u = nzc0[0]
    col1 = rows[rows[:, 0] == 0][:, 1]
    col1 = col1[col1 != 0]
    if col1.size == 0:
        raise AssertionError("rank-1 lattice")
    g = int(np.gcd.reduce(np.abs(col1)))
    v = np.asarray([0, g], dtype=np.int64)
    return _lagrange_reduce(u, v)


def _solve_coords(basis: np.ndarray, rel: np.ndarray) -> np.ndarray:
    """Integer (a, b) with basis @ (a, b) = rel (asserts integrality).

    basis: [2, 2] columns v1, v2; rel: [N, 2]."""
    det = int(basis[0, 0] * basis[1, 1] - basis[0, 1] * basis[1, 0])
    assert det != 0
    a = rel[:, 0] * basis[1, 1] - rel[:, 1] * basis[0, 1]
    b = -rel[:, 0] * basis[1, 0] + rel[:, 1] * basis[0, 0]
    if ((a % det) != 0).any() or ((b % det) != 0).any():
        raise AssertionError("positions not on the claimed lattice")
    return np.stack([a // det, b // det], axis=1)


class DenseGridUnavailable(Exception):
    """No exact parent polyphase maps at this (tiny) shape: the program
    has no wave table (codec/grid_decode.grid_waves) and decodes through
    kernel D's step tensors. Deliberately not AssertionError, so genuine
    consistency failures stay distinct."""


@dataclasses.dataclass
class AffineMap:
    """(a, b) -> (M @ (a, b) + c) // den over one residue class of cells.

    The child->parent coordinate map is affine with rational denominator
    dividing 4 (parent bases span index-2 sublattices, except the
    reference's irregular scale-2 layer where position differences
    generate a lattice of twice the density). Restricted to a
    residue class (a, b) mod m the map is exactly integral: any index-2
    or index-4 sublattice of Z^2 contains mZ^2 for m = its exponent
    (2 or 4), so mod-m classes refine the odd/even-child cosets."""

    M: np.ndarray  # [2, 2] int64 (den * rational linear part)
    c: np.ndarray  # [2] int64 (den * rational offset)
    den: int


@dataclasses.dataclass
class LevelGrid:
    """Dense lattice grid for one tree level (or the tile lattice)."""

    level: int  # tree level L; 0 = tile lattice (phases)
    scale: int  # depth - level
    basis: np.ndarray  # [2, 2] int64, columns v1 v2: pos = origin + a v1 + b v2
    origin: np.ndarray  # [2] int64 pixel position of cell (0, 0)
    shape: Tuple[int, int]  # (A, B)
    occ: np.ndarray  # [A, B] bool: a tree node exists at this cell
    slot: np.ndarray  # [A, B] int64 flat coef slot t*n+q, or -1
    coords: np.ndarray  # [num_nodes, 2] (a, b) per node in slot-list order
    # 6 tap shifts in THIS grid's (a, b) coords (direction order =
    # geometry nbr columns: left, up_left, up_right, right, down_left,
    # down_right)
    tap_shift: np.ndarray  # [6, 2] int64
    # parent polyphase: cells split into residue classes (a % m, b % m);
    # parent_map[(r1, r2)] is each non-empty class's exact affine map
    # into the parent grid's coords
    parent_mod: int  # m in {2, 4}; 0 for level 0
    parent_map: Optional[Dict[Tuple[int, int], AffineMap]]


@dataclasses.dataclass
class LatticeGrids:
    height: int
    width: int
    depth: int
    grids: List[LevelGrid]  # index 0 = tile lattice, 1..depth-1 = levels
    # scale-2 fixup corrections: rows (level, cell_a, cell_b, tap,
    # parent_cell_a, parent_cell_b) where the true tap source differs
    # from the shifted-grid prediction (or is absent: parent cell -1).
    # None when the parent polyphase maps had no exact fit (tiny
    # shapes) — grids/slots stay valid, the dense fast path does not.
    fixups: Optional[np.ndarray]  # [F, 6] int64


def _fit_affine(
    src: np.ndarray, dst: np.ndarray, den: int
) -> Optional[AffineMap]:
    """Fit dst = (M @ src + c) / den exactly; None if not affine."""
    n = src.shape[0]
    if n == 0:
        return None
    A = np.concatenate([src, np.ones((n, 1), np.int64)], axis=1).astype(np.float64)
    sol, *_ = np.linalg.lstsq(A, float(den) * dst.astype(np.float64), rcond=None)
    sol = np.rint(sol).astype(np.int64)
    M = sol[:2].T
    c = sol[2]
    if not np.array_equal(src @ M.T + c, den * dst):
        return None
    return AffineMap(M=M, c=c, den=den)


def _fit_parent_classes(
    cc: np.ndarray, pc: np.ndarray
) -> Tuple[int, Optional[Dict[Tuple[int, int], AffineMap]]]:
    """Fit the child-cell -> parent-cell map per (a % m, b % m) residue
    class, with the smallest m in {2, 4} that is exact everywhere.
    Returns (0, None) when no exact fit exists — tiny boundary-dominated
    shapes (< ~32 px a side) have too few cells per class; the schedule
    and wire layout do not need these maps; a program builds its wave
    table only where they exist (grid_decode.grid_waves raises)."""
    for m in (2, 4):
        out: Dict[Tuple[int, int], AffineMap] = {}
        ok = True
        for r1 in range(m):
            for r2 in range(m):
                sel = (cc[:, 0] % m == r1) & (cc[:, 1] % m == r2)
                if not sel.any():
                    continue
                am = _fit_affine(cc[sel], pc[sel], m)
                if am is None:
                    ok = False
                    break
                out[(r1, r2)] = am
            if not ok:
                break
        if ok:
            return m, out
    return 0, None


def build_lattice_grids(geo: FractalGeometry) -> LatticeGrids:
    depth = geo.depth
    n = 1 << depth
    cen = geo.centers.astype(np.int64)
    off = geo.offsets.astype(np.int64)
    T = geo.num_tiles

    grids: List[LevelGrid] = []
    node_coords: List[np.ndarray] = []  # per level, [num_nodes, 2]

    # ---- per-level grids (level 0 = tile lattice at scale == depth) ----
    for L in range(depth):
        s = depth - L
        if L == 0:
            pos = cen.copy()  # tile centers; slots t*n (+phase handled later)
            slots = np.arange(T, dtype=np.int64) * n
        else:
            lo, hi = 1 << L, 1 << (L + 1)
            pos = (cen[:, None, :] + off[None, lo:hi, :]).reshape(-1, 2)
            slots = (
                np.arange(T, dtype=np.int64)[:, None] * n
                + np.arange(lo, hi, dtype=np.int64)[None, :]
            ).reshape(-1)

        # lattice basis from position differences (a sample generates the
        # full difference lattice; the _solve_coords assert below verifies
        # on every node) + the level's tap vectors
        vecs = [np.asarray(v, dtype=np.int64) for v in nearby_vectors(s)]
        sample = pos[: min(len(pos), 4096)] - pos[0]
        gen = np.concatenate([sample, np.stack(vecs)], axis=0)
        b1, b2 = _lattice_basis(gen)
        basis = np.stack([b1, b2], axis=1)

        origin = pos[0].copy()
        coords = _solve_coords(basis, pos - origin)
        amin, bmin = coords.min(axis=0)
        amax, bmax = coords.max(axis=0)
        origin = origin + basis @ np.asarray([amin, bmin], np.int64)
        coords = coords - np.asarray([amin, bmin], np.int64)
        A, B = int(amax - amin) + 1, int(bmax - bmin) + 1

        occ = np.zeros((A, B), dtype=bool)
        slot = np.full((A, B), -1, dtype=np.int64)
        occ[coords[:, 0], coords[:, 1]] = True
        if occ.sum() != pos.shape[0]:
            raise AssertionError(f"level {L}: coordinate collision")
        slot[coords[:, 0], coords[:, 1]] = slots

        tap_vecs = np.stack(
            [vecs[4], vecs[5], vecs[0], vecs[1], vecs[3], vecs[2]]
        )  # getter base vectors in nbr column order (geometry.py getters)
        tap_shift = _solve_coords(basis, tap_vecs)

        grids.append(
            LevelGrid(
                level=L,
                scale=s,
                basis=basis,
                origin=origin,
                shape=(A, B),
                occ=occ,
                slot=slot,
                coords=coords,
                tap_shift=tap_shift,
                parent_mod=0,
                parent_map=None,
            )
        )
        node_coords.append(coords)

    # ---- parent polyphase maps (level L >= 1 -> level L-1 grid) ----
    for L in range(1, depth):
        g = grids[L]
        gp = grids[L - 1]
        s = depth - L
        lo = 1 << L
        lit = np.asarray(LITERALS[s], dtype=np.int64)
        # pos/odd in the same (t, q) row-major order the grid was built
        # with; parent of child q is q // 2, sitting AT the child's
        # position for even q and at position - LITERALS[s] for odd q
        # (tree_offsets). For L == 1 the
        # parent is the tile root (haar 1), whose grid is the tile
        # lattice.
        pos = (cen[:, None, :] + off[None, lo : 2 * lo, :]).reshape(-1, 2)
        odd = np.tile(np.arange(lo, 2 * lo) % 2, T).astype(bool)
        parent_pos = pos - np.where(odd[:, None], lit[None, :], 0)
        pc = _solve_coords(gp.basis, parent_pos - gp.origin)
        cc = g.coords
        g.parent_mod, g.parent_map = _fit_parent_classes(cc, pc)

    if any(grids[L].parent_map is None for L in range(1, depth)):
        # no exact parent polyphase maps at this (tiny) shape: keep the
        # grids (the schedule/wire layout only needs occupancy + slots)
        # but mark the dense fast path unavailable
        return LatticeGrids(
            height=geo.height,
            width=geo.width,
            depth=depth,
            grids=grids,
            fixups=None,
        )

    # ---- verification + fixup extraction against geometry.nbr_par ----
    # For every level-L node and tap k: shifted-grid prediction =
    # parent slot at parent_grid coords of (cell + tap_shift[k]) (via the
    # containing class's affine map). Where nbr_par differs (scale-2
    # fixups or absent cells), record a correction row.
    fixups: List[Tuple[int, int, int, int, int, int]] = []
    nbr_par = geo.nbr_par.astype(np.int64)
    for L in range(1, depth):
        g = grids[L]
        gp = grids[L - 1]
        Ap, Bp = gp.shape
        lo = 1 << L
        cc = g.coords  # node order = (t, q) row-major as built above
        slots = g.slot[cc[:, 0], cc[:, 1]]
        # parent-slot grid at level L-1: for L-1 == 0 the values live at
        # haar index 1 (root) — parent of haar in [2,4) is 1; for L-1 >= 1
        # the parent slot is the grid slot itself (t*n + q) — but nbr_par
        # stores u*n + q2//2, i.e. the PARENT slot of the neighbour node.
        # Build the map: level-(L-1) cell -> that node's own slot
        # (t*n + qp); the tap's expected value slot is then the
        # neighbour's parent: for neighbour node at level L cell z, its
        # parent cell in gp holds slot u*n + q2//2 directly when L-1 >= 1.
        # For L == 1, q2 // 2 == 1 (the root-HF slot).
        if L == 1:
            pslot = np.where(gp.slot >= 0, gp.slot + 1, -1)  # t*n + 1
        else:
            pslot = gp.slot
        par = (0, 1)
        for k in range(6):
            zc = cc + g.tap_shift[k]
            # neighbour cell residue class -> parent coords. Classes
            # absent from the fit (no real node) may appear among
            # shifted cells; route them far out of bounds (-> absent).
            pred_pc = np.full_like(zc, -(1 << 40))
            mmod = g.parent_mod
            for (r1, r2), am in g.parent_map.items():
                m = (zc[:, 0] % mmod == r1) & (zc[:, 1] % mmod == r2)
                if m.any():
                    zm = zc[m]
                    out = zm @ am.M.T + am.c
                    exact = (out % am.den == 0).all(axis=-1)
                    res = np.where(
                        exact[:, None], out // am.den, -(1 << 40)
                    )
                    pred_pc[m] = res
            inb = (
                (pred_pc[:, 0] >= 0)
                & (pred_pc[:, 0] < Ap)
                & (pred_pc[:, 1] >= 0)
                & (pred_pc[:, 1] < Bp)
            )
            # ALSO require the neighbour cell itself to be occupied at
            # level L (the reference looks the neighbour up in maps[L])
            zin = (
                (zc[:, 0] >= 0)
                & (zc[:, 0] < g.shape[0])
                & (zc[:, 1] >= 0)
                & (zc[:, 1] < g.shape[1])
            )
            zocc = np.zeros(zc.shape[0], dtype=bool)
            zz = zc[zin]
            zocc[zin] = g.occ[zz[:, 0], zz[:, 1]]
            pred_slot = np.full(zc.shape[0], -1, dtype=np.int64)
            mm = inb & zocc
            pred_slot[mm] = pslot[pred_pc[mm, 0], pred_pc[mm, 1]]
            true_slot = nbr_par[slots, k]
            diff = pred_slot != true_slot
            if diff.any():
                # record corrections: target cell + tap + true source
                # parent cell (or -1 for absent)
                d_idx = np.nonzero(diff)[0]
                # invert: parent slot -> parent cell
                pcell = {int(v): (int(a), int(b))
                         for (a, b), v in np.ndenumerate(pslot) if v >= 0}
                for i in d_idx:
                    ts = int(true_slot[i])
                    pa, pb = pcell.get(ts, (-1, -1))
                    if ts >= 0 and pa < 0:
                        raise AssertionError(
                            f"level {L} tap {k}: true neighbour slot {ts} "
                            "not on the parent grid"
                        )
                    fixups.append(
                        (L, int(cc[i, 0]), int(cc[i, 1]), k, pa, pb)
                    )

    fix = (
        np.asarray(fixups, dtype=np.int64).reshape(-1, 6)
        if fixups
        else np.zeros((0, 6), dtype=np.int64)
    )
    return LatticeGrids(
        height=geo.height, width=geo.width, depth=depth, grids=grids, fixups=fix
    )


_cache: Dict[Tuple[int, int, int], LatticeGrids] = {}
_lock = threading.Lock()


def get_lattice_grids(
    height: int, width: int, depth: int = BASE_FRAC_DEPTH
) -> LatticeGrids:
    key = (height, width, depth)
    with _lock:
        g = _cache.get(key)
    if g is None:
        g = build_lattice_grids(get_geometry(height, width, depth))
        with _lock:
            _cache[key] = g
    return g
