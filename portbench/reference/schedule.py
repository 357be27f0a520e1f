"""The grid-mode decode schedule: the symbols of one image channel in
decode order, grouped into waves, and their rANS lane layout.

A coefficient's context depends only on coefficients of earlier waves:
wave 0 is the DC of the tile lattice's phase-A tiles (context-free),
wave 1 the phase-B tiles' DC (taps at their phase-A neighbours), wave 2
the root high-pass of every tile (taps at the neighbour tiles' DC), and
then one wave a high-pass level, its taps at the parent level. Within a
wave symbols follow the raster order of the wave's lattice grid, and
each wave is packed into whole rows of NL lanes. Only grid mode is
here: it is the mode the benchmark's configurations state.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Tuple

import numpy as np

from .geometry import FractalGeometry, get_geometry, BASE_FRAC_DEPTH


@dataclasses.dataclass
class WavefrontSchedule:
    """Static symbol schedule for one geometry (channel-independent)."""

    num_symbols: int  # K
    sched_coef: np.ndarray  # [K] int32 flat coefficient slot
    sched_nbr: np.ndarray  # [K, 6] int32 neighbour value slots (-1 absent)
    sched_lf: np.ndarray  # [K] bool: LF (MED) vs HF (learned linear) context
    sched_group: np.ndarray  # [K] int8 predictor parameter group (one fit a segment)
    num_fine: int
    sched_fbkt: np.ndarray  # [K] int8 fixed context bucket, -1 = computed
    wave_sizes: np.ndarray  # [num_waves] int32, sums to K
    max_wave: int

    def expand_params(self, p: np.ndarray) -> np.ndarray:
        """Wire predictor parameters as [num_fine, 6] float32 (format v9:
        one row a schedule segment)."""
        p = np.asarray(p, dtype=np.float32)
        if p.shape[-2] != self.num_fine:
            raise ValueError(f"predictor params have {p.shape[-2]} rows; expected {self.num_fine}")
        return p


def _build_schedule_grid(geo: FractalGeometry) -> WavefrontSchedule:
    """The grid-mode schedule of a geometry: waves as the module says, a
    phase-A/B checkerboard on the tile grid, taps from the geometry's
    parent-level neighbour slots."""
    from .tables import CONTEXT_AMOUNT
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
    num_fine = 0

    def fine_group(size: int) -> np.ndarray:
        nonlocal num_fine
        num_fine += 1
        return np.full(size, num_fine - 1, dtype=np.int8)

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
    sched_group.append(fine_group(int(sel.sum())))
    sched_fbkt.append(np.full(int(sel.sum()), CONTEXT_AMOUNT - 1, dtype=np.int8))
    wave_sizes.append(int(sel.sum()))

    # wave 1: phase B — predicted from decoded A-neighbour DCs
    sel = ~apar
    taps = tile_taps(restrict_a=True)[sel]
    sched_coef.append(tslot[sel])
    sched_nbr.append(taps)
    sched_lf.append(np.zeros(int(sel.sum()), dtype=bool))
    sched_group.append(fine_group(int(sel.sum())))
    sched_fbkt.append(np.full(int(sel.sum()), -1, dtype=np.int8))
    wave_sizes.append(int(sel.sum()))

    # wave 2: root-HF — all tiles, taps = neighbour DCs
    taps = tile_taps(restrict_a=False)
    sched_coef.append(tslot + 1)
    sched_nbr.append(taps)
    sched_lf.append(np.zeros(ta.shape[0], dtype=bool))
    sched_group.append(fine_group(ta.shape[0]))
    sched_fbkt.append(np.full(ta.shape[0], -1, dtype=np.int8))
    wave_sizes.append(int(ta.shape[0]))

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
        sched_coef.append(slots)
        sched_nbr.append(geo.nbr_par[slots].astype(np.int64))
        sched_lf.append(np.zeros(nL, dtype=bool))
        sched_group.append(fine_group(nL))
        sched_fbkt.append(np.full(nL, -1, dtype=np.int8))
        wave_sizes.append(nL)

    coef = np.concatenate(sched_coef)
    return WavefrontSchedule(
        num_symbols=int(coef.shape[0]),
        sched_coef=coef.astype(np.int32),
        sched_nbr=np.concatenate(sched_nbr, axis=0).astype(np.int32),
        sched_lf=np.concatenate(sched_lf),
        sched_group=np.concatenate(sched_group),
        num_fine=num_fine,
        sched_fbkt=np.concatenate(sched_fbkt).astype(np.int8),
        wave_sizes=np.asarray(wave_sizes, dtype=np.int32),
        max_wave=len(wave_sizes),
    )


@dataclasses.dataclass
class LaneSteps:
    """Decode-time steps for a lane count NL: step s is row s of the
    [S, NL] symbol grid, each wave packed into whole rows."""

    nl: int
    num_steps: int
    step_slot: np.ndarray  # [S, NL] int32 schedule index k or -1
    step_wave: np.ndarray  # [S] int32 wave id of each step


def grid_row_lane(sched: WavefrontSchedule, nl: int):
    """(row, lane) of every schedule symbol for lane count nl: row = the
    wave's base row + rank // nl, lane = rank % nl, where rank is the
    symbol's position within its wave. Also the total rows and the rows
    of each wave."""
    sizes = sched.wave_sizes.astype(np.int64)
    rows_per_wave = -(-sizes // nl)  # ceil; 0 rows for empty waves
    base = np.concatenate([[0], np.cumsum(rows_per_wave)])
    wstart = np.concatenate([[0], np.cumsum(sizes)])
    wave_of_sym = np.repeat(np.arange(sched.max_wave, dtype=np.int64), sizes)
    rank = np.arange(sched.num_symbols, dtype=np.int64) - wstart[wave_of_sym]
    return base[wave_of_sym] + rank // nl, rank % nl, int(base[-1]), rows_per_wave


def build_lane_steps(sched: WavefrontSchedule, nl: int) -> LaneSteps:
    row, lane, S, rows_per_wave = grid_row_lane(sched, nl)
    step_slot = np.full((S, nl), -1, dtype=np.int64)
    step_slot[row, lane] = np.arange(sched.num_symbols, dtype=np.int64)
    wave_of_step = np.repeat(np.arange(sched.max_wave, dtype=np.int64), rows_per_wave)
    return LaneSteps(nl=nl, num_steps=S, step_slot=step_slot.astype(np.int32),
                     step_wave=wave_of_step.astype(np.int32))


_sched_cache: Dict[Tuple[int, int, int], WavefrontSchedule] = {}
_lane_cache: Dict[Tuple[int, int, int, int], LaneSteps] = {}
_lock = threading.Lock()


def _grid_only(mode: str) -> None:
    if mode != "grid":
        raise ValueError(f"the reference decodes grid mode only, not {mode!r}")


def get_schedule(height: int, width: int, depth: int = BASE_FRAC_DEPTH,
                 mode: str = "grid") -> WavefrontSchedule:
    _grid_only(mode)
    key = (height, width, depth)
    with _lock:
        s = _sched_cache.get(key)
    if s is None:
        s = _build_schedule_grid(get_geometry(height, width, depth))
        with _lock:
            _sched_cache[key] = s
    return s


def get_lane_steps(height: int, width: int, nl: int, depth: int = BASE_FRAC_DEPTH,
                   mode: str = "grid") -> LaneSteps:
    _grid_only(mode)
    key = (height, width, depth, nl)
    with _lock:
        s = _lane_cache.get(key)
    if s is None:
        s = build_lane_steps(get_schedule(height, width, depth), nl)
        with _lock:
            _lane_cache[key] = s
    return s
