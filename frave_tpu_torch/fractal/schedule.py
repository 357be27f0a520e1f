"""Wavefront decode schedule of grid mode, and the rANS lane layout.

The port's copy of the grid-mode half of frave_tpu/fractal/schedule.py:
the schedule of mode="grid" (the only mode the port runs; the parallel and
parity schedules, their Kahn layering and the step-tensor lane layouts are
left out), the packed grid row/lane layout and the lane-count rules.

Symbols are enumerated in schedule order k = 0..K-1: per wave (DC phase
A, DC phase B, root-HF, then HF levels 1..depth-1), in the raster order of
the wave's dense lattice grid. Every symbol's context taps live in
strictly earlier waves, so a whole wave decodes in parallel; within a
wave the symbols fill rows of NL interleaved rANS lanes back to back.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from .geometry import FractalGeometry, get_geometry, BASE_FRAC_DEPTH


@dataclasses.dataclass
class WavefrontSchedule:
    """Static symbol schedule for one geometry (channel-independent)."""

    num_symbols: int  # K
    sched_coef: np.ndarray  # [K] int32 flat coefficient slot
    sched_nbr: np.ndarray  # [K, 6] int32 neighbour value slots (-1 absent)
    sched_lf: np.ndarray  # [K] bool: LF (MED) vs HF (learned linear) context
    # Fine predictor parameter group per symbol: one id per contiguous
    # schedule segment (DC phases, root-HF, then each HF level) — the
    # per-level fits of format v8. The 3 coarse groups of format v7
    # (finest level / next / rest) survive as legacy_of_fine, which
    # expands a v7 container's [3, 6] parameter blocks to [num_fine, 6].
    sched_group: np.ndarray  # [K] int8 fine predictor parameter group
    legacy_of_fine: np.ndarray  # [num_fine] int8 coarse group of each fine id
    num_fine: int
    sched_fbkt: np.ndarray  # [K] int8 fixed context bucket, -1 = computed
    wave_sizes: np.ndarray  # [num_waves] int32, sums to K
    max_wave: int
    # symbols laid out as dense lattice grids (fractal/lattice.py):
    # wave_cells[w] = flat cell count of wave w's grid region;
    # cell_pos[k] = flat cell of symbol k in its wave's region
    wave_cells: Optional[np.ndarray] = None  # [num_waves] int64
    cell_pos: Optional[np.ndarray] = None  # [K] int64

    def expand_params(self, p: np.ndarray) -> np.ndarray:
        """Normalize wire predictor parameters to [..., num_fine, 6]:
        v8 rows pass through, v7's 3 coarse rows expand via
        legacy_of_fine."""
        p = np.asarray(p, dtype=np.float32)
        if p.shape[-2] == self.num_fine:
            return p
        if p.shape[-2] == 3:
            return np.ascontiguousarray(
                p[..., self.legacy_of_fine.astype(np.int64), :]
            )
        raise ValueError(
            f"predictor params have {p.shape[-2]} rows; expected 3 or "
            f"{self.num_fine}"
        )


def _build_schedule_grid(geo: FractalGeometry) -> WavefrontSchedule:
    """The lattice-grid layout of fractal/lattice.py as a wavefront
    schedule: context taps are the nbr_par parent slots, one wave per HF
    level, and a two-phase DC + root-HF over the tile lattice. Symbol
    order within a wave is the raster order of the wave's dense lattice
    grid (cell (a, b) -> flat a*B + b); the DC phase-A/B split is the
    spatial checkerboard (a + b) % 2 on the tile grid, so phase-B tiles
    always have their A-neighbours adjacent on the grid."""
    from ..entropy.tables import CONTEXT_AMOUNT
    from .lattice import get_lattice_grids

    lg = get_lattice_grids(geo.height, geo.width, geo.depth)
    n = geo.nodes_per_tile
    depth = geo.depth
    flat_mask = geo.coef_mask.reshape(-1)

    sched_coef: List[np.ndarray] = []
    sched_nbr: List[np.ndarray] = []
    sched_lf: List[np.ndarray] = []
    sched_group: List[np.ndarray] = []
    sched_fbkt: List[np.ndarray] = []
    wave_sizes: List[int] = []
    wave_cells: List[int] = []
    cell_pos: List[np.ndarray] = []
    legacy_of_fine: List[int] = []

    def fine_group(size: int, legacy: int) -> np.ndarray:
        fid = len(legacy_of_fine)
        legacy_of_fine.append(legacy)
        return np.full(size, fid, dtype=np.int8)

    tg = lg.grids[0]
    At, Bt = tg.shape
    ta, tb = np.nonzero(tg.occ)
    order = np.argsort(ta * Bt + tb, kind="stable")
    ta, tb = ta[order], tb[order]
    tslot = tg.slot[ta, tb]  # t * n (DC slots), raster order
    apar = ((ta + tb) % 2) == 0

    # tile-grid neighbour slots per tap dir (DC slot of the tile at
    # cell + tap_shift, -1 if off-grid/unoccupied)
    def tile_taps(restrict_a: bool) -> np.ndarray:
        out = np.full((ta.shape[0], 6), -1, dtype=np.int64)
        for k in range(6):
            za = ta + tg.tap_shift[k, 0]
            zb = tb + tg.tap_shift[k, 1]
            inb = (za >= 0) & (za < At) & (zb >= 0) & (zb < Bt)
            zs = np.full(ta.shape[0], -1, dtype=np.int64)
            zs[inb] = tg.slot[za[inb], zb[inb]]
            if restrict_a:
                zpar = ((za + zb) % 2) == 0
                zs = np.where(zpar, zs, -1)
            out[:, k] = zs
        return out

    tcell = ta * Bt + tb

    # wave 0: phase A — context-free, widest bucket
    sel = apar
    sched_coef.append(tslot[sel])
    sched_nbr.append(np.full((int(sel.sum()), 6), -1, dtype=np.int64))
    sched_lf.append(np.zeros(int(sel.sum()), dtype=bool))
    sched_group.append(fine_group(int(sel.sum()), 2))
    sched_fbkt.append(np.full(int(sel.sum()), CONTEXT_AMOUNT - 1, dtype=np.int8))
    wave_sizes.append(int(sel.sum()))
    wave_cells.append(At * Bt)
    cell_pos.append(tcell[sel])

    # wave 1: phase B — predicted from decoded A-neighbour DCs
    sel = ~apar
    taps = tile_taps(restrict_a=True)[sel]
    sched_coef.append(tslot[sel])
    sched_nbr.append(taps)
    sched_lf.append(np.zeros(int(sel.sum()), dtype=bool))
    sched_group.append(fine_group(int(sel.sum()), 2))
    sched_fbkt.append(np.full(int(sel.sum()), -1, dtype=np.int8))
    wave_sizes.append(int(sel.sum()))
    wave_cells.append(At * Bt)
    cell_pos.append(tcell[sel])

    # wave 2: root-HF — all tiles, taps = neighbour DCs
    taps = tile_taps(restrict_a=False)
    sched_coef.append(tslot + 1)
    sched_nbr.append(taps)
    sched_lf.append(np.zeros(ta.shape[0], dtype=bool))
    sched_group.append(fine_group(ta.shape[0], 2))
    sched_fbkt.append(np.full(ta.shape[0], -1, dtype=np.int8))
    wave_sizes.append(int(ta.shape[0]))
    wave_cells.append(At * Bt)
    cell_pos.append(tcell)

    # HF levels 1..depth-1: raster order of each level grid, taps from
    # the reference-exact nbr_par tensor (the dense device path
    # reproduces it via grid shifts + the lattice fixup list;
    # differentially tested)
    for L in range(1, depth):
        g = lg.grids[L]
        A, B = g.shape
        ga, gb = np.nonzero(g.occ)
        o = np.argsort(ga * B + gb, kind="stable")
        ga, gb = ga[o], gb[o]
        slots = g.slot[ga, gb]
        present = flat_mask[slots]
        ga, gb, slots = ga[present], gb[present], slots[present]
        nL = slots.shape[0]
        group = 0 if L == depth - 1 else (1 if L == depth - 2 else 2)
        sched_coef.append(slots)
        sched_nbr.append(geo.nbr_par[slots].astype(np.int64))
        sched_lf.append(np.zeros(nL, dtype=bool))
        sched_group.append(fine_group(nL, group))
        sched_fbkt.append(np.full(nL, -1, dtype=np.int8))
        wave_sizes.append(nL)
        wave_cells.append(A * B)
        cell_pos.append(ga * B + gb)

    coef = np.concatenate(sched_coef)
    return WavefrontSchedule(
        num_symbols=int(coef.shape[0]),
        sched_coef=coef.astype(np.int32),
        sched_nbr=np.concatenate(sched_nbr, axis=0).astype(np.int32),
        sched_lf=np.concatenate(sched_lf),
        sched_group=np.concatenate(sched_group),
        legacy_of_fine=np.asarray(legacy_of_fine, dtype=np.int8),
        num_fine=len(legacy_of_fine),
        sched_fbkt=np.concatenate(sched_fbkt).astype(np.int8),
        wave_sizes=np.asarray(wave_sizes, dtype=np.int32),
        max_wave=len(wave_sizes),
        wave_cells=np.asarray(wave_cells, dtype=np.int64),
        cell_pos=np.concatenate(cell_pos).astype(np.int64),
    )


def build_schedule(geo: FractalGeometry, mode: str = "grid") -> WavefrontSchedule:
    """The schedule of `mode`; the port has grid mode's only."""
    if mode != "grid":
        raise NotImplementedError(f"mode={mode!r}: only grid mode is ported")
    return _build_schedule_grid(geo)


def grid_row_lane(sched: WavefrontSchedule, nl: int):
    """Grid mode: (row, lane) of every schedule symbol for lane count nl.

    Packed rows: row = wave base row + rank // nl, lane = rank % nl,
    where rank is the symbol's raster rank WITHIN its wave (= its
    schedule position inside the wave). Returns (row [K], lane [K], total
    rows, rows per wave [num_waves])."""
    assert sched.cell_pos is not None
    sizes = sched.wave_sizes.astype(np.int64)
    rows_per_wave = -(-sizes // nl)  # ceil; 0 rows for empty waves
    base = np.concatenate([[0], np.cumsum(rows_per_wave)])
    wstart = np.concatenate([[0], np.cumsum(sizes)])
    wave_of_sym = np.repeat(np.arange(sched.max_wave, dtype=np.int64), sizes)
    rank = np.arange(sched.num_symbols, dtype=np.int64) - wstart[wave_of_sym]
    row = base[wave_of_sym] + rank // nl
    lane = rank % nl
    return row, lane, int(base[-1]), rows_per_wave


def default_num_lanes(num_symbols: int) -> int:
    """Lane count heuristic: wide enough to keep the decode wavefront fed,
    small enough that per-lane wire overhead (the 4-byte rANS state each
    lane carries in the container) stays under ~0.25 bpp: K // 128 lanes,
    a power of two in [16, 16384]."""
    if num_symbols <= 0:
        return 16
    target = max(16, min(16384, num_symbols // 128))
    return 1 << (int(target).bit_length() - 1)


def rate_adaptive_lanes(
    default_nl: int, est_payload_bytes: float, channels: int
) -> int:
    """Shrink the lane count when per-lane wire overhead would dominate
    the container (flat content). Each lane costs ~2-4 B a channel on the
    wire (the STT state block, plus up to a word of per-lane flush
    rounding); lanes are capped so that overhead stays <= ~12.5% of the
    expected payload, with a floor of 256 so decode keeps a useful
    wavefront."""
    cap = max(256.0, est_payload_bytes / (32.0 * max(channels, 1)))
    nl = 1 << (int(cap).bit_length() - 1)
    return min(default_nl, nl)


_sched_cache: Dict[Tuple[int, int, int, str], WavefrontSchedule] = {}
_lock = threading.Lock()


def get_schedule(
    height: int, width: int, depth: int = BASE_FRAC_DEPTH, mode: str = "grid"
) -> WavefrontSchedule:
    """Cached schedule per (h, w, depth, mode); grid mode only."""
    key = (height, width, depth, mode)
    with _lock:
        s = _sched_cache.get(key)
    if s is None:
        s = build_schedule(get_geometry(height, width, depth), mode)
        with _lock:
            _sched_cache[key] = s
    return s
