"""Wavefront decode schedules, the rANS lane layouts and the stream order.

The port's copy of frave_tpu/fractal/schedule.py, every mode:

  * mode="grid": per wave (DC phase A, DC phase B, root-HF, then HF levels
    1..depth-1), the raster order of the wave's dense lattice grid; the
    symbols of a wave fill rows of NL interleaved rANS lanes back to back
    (grid_row_lane), and a decode step is one such row;
  * mode="parallel": the same context model with the DC phases split by
    canonical tile parity and every level one wave in canonical order;
  * mode="parity": the reference's causal context model — 3 same-level
    taps {left, up_left, up_right} and 3 parent-resolution taps — whose
    waves are the longest-path (Kahn) layering of the in-level dependency
    graph: diagonal wavefronts, thousands of them at photo sizes.

Symbols are enumerated in schedule order k = 0..K-1; every symbol's
context taps live in strictly earlier waves, so a whole wave decodes in
parallel. In the parallel and parity modes lane(k) = k mod NL, each wave
is cut into steps of at most NL symbols, and the word row of symbol k is
k // NL (tightly packed rows). LaneSteps holds the decode steps, and
build_stream_perm the static order of the words in the stream: step by
step, channel-major, lane-minor.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from .geometry import FractalGeometry, get_geometry, BASE_FRAC_DEPTH

MODES = ("grid", "parallel", "parity")


def _layer_waves(num_nodes: int, deps: np.ndarray) -> np.ndarray:
    """Longest-path layering. deps: [num_nodes, d] int64 node indices or
    -1. Returns the wave of each node (0-based): 0 without dependencies,
    else 1 + the largest wave among them. Three columns (the parity
    schedule's causal taps) go through the native Kahn layering
    (native.layer_waves_native), as in the JAX package; any other width
    through layer_waves_plain. Raises on a cycle."""
    if deps.ndim == 2 and deps.shape[1] == 3:
        from ..native import layer_waves_native

        return layer_waves_native(deps).astype(np.int64)
    return layer_waves_plain(num_nodes, deps)


def layer_waves_plain(num_nodes: int, deps: np.ndarray) -> np.ndarray:
    """_layer_waves in numpy: level-synchronous Kahn (the nodes whose
    dependencies all sit in waves < L form wave L), giving the waves of
    the native layering and the JAX package's Kahn queue. Raises on a
    cycle."""
    wave = np.full(num_nodes, -1, dtype=np.int64)
    d = deps.shape[1] if deps.ndim == 2 else 0
    src = deps.reshape(-1).astype(np.int64)
    dst = np.repeat(np.arange(num_nodes, dtype=np.int64), d)
    keep = src >= 0
    src, dst = src[keep], dst[keep]
    indeg = np.bincount(dst, minlength=num_nodes)
    order = np.argsort(src, kind="stable")
    succ = dst[order]
    start = np.searchsorted(src[order], np.arange(num_nodes + 1, dtype=np.int64))
    frontier = np.nonzero(indeg == 0)[0]
    level = seen = 0
    while frontier.size:
        wave[frontier] = level
        seen += frontier.size
        cnt = start[frontier + 1] - start[frontier]
        tot = int(cnt.sum())
        if not tot:
            break
        first = np.repeat(start[frontier] - (np.cumsum(cnt) - cnt), cnt)
        nodes, dec = np.unique(succ[first + np.arange(tot)], return_counts=True)
        indeg[nodes] -= dec
        frontier = nodes[indeg[nodes] == 0]
        level += 1
    if seen != num_nodes:
        raise AssertionError("cycle in causal dependency graph")
    return wave


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
    """The schedule of `mode` (MODES).

    mode="parity": the reference's context model — 3 same-level causal
    taps {left, up_left, up_right} + 3 parent-resolution taps; the DC and
    root-HF phases follow the causal tile wavefront (MED contexts), each
    HF level the layering of its in-level dependency graph.

    mode="parallel": all six directional taps read at the parent haar
    slot, decoded before a level starts, so each level is ONE wave; the
    DC phase is two waves (alternate tiles in canonical order coded
    context-free, then the rest predicted from their A-neighbours), the
    root-HF phase one wave over the neighbour tiles' DC values."""
    if mode == "grid":
        return _build_schedule_grid(geo)
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    from ..entropy.tables import CONTEXT_AMOUNT

    n = geo.nodes_per_tile
    depth = geo.depth
    T = geo.num_tiles

    sched_coef: List[np.ndarray] = []
    sched_nbr: List[np.ndarray] = []
    sched_lf: List[np.ndarray] = []
    sched_group: List[np.ndarray] = []
    sched_fbkt: List[np.ndarray] = []
    wave_sizes: List[int] = []
    # one fine group id per contiguous segment, remembering which of the
    # 3 coarse (v7) groups it belongs to
    legacy_of_fine: List[int] = []

    def fine_group(size: int, legacy: int) -> np.ndarray:
        fid = len(legacy_of_fine)
        legacy_of_fine.append(legacy)
        return np.full(size, fid, dtype=np.int8)

    if mode == "parity":
        # DC + root-HF phases follow the causal tile wavefront
        tile_deps = geo.tile_nbr[:, 0:3].astype(np.int64)
        tile_waves = _layer_waves(T, tile_deps)
        tile_order = np.lexsort((np.arange(T), tile_waves))
        t_sorted = np.arange(T, dtype=np.int64)[tile_order]
        w_sorted = tile_waves[tile_order]
        _, tile_counts = np.unique(w_sorted, return_counts=True)
        for phase_haar in (0, 1):
            coef = (t_sorted * n + phase_haar).astype(np.int64)
            nbr = np.full((T, 6), -1, dtype=np.int64)
            valid = geo.tile_nbr[t_sorted, 0:3] >= 0
            nbr[:, 0:3] = np.where(
                valid, geo.tile_nbr[t_sorted, 0:3].astype(np.int64) * n + phase_haar, -1
            )
            sched_coef.append(coef)
            sched_nbr.append(nbr)
            sched_lf.append(np.ones(T, dtype=bool))
            sched_group.append(fine_group(T, 0))
            sched_fbkt.append(np.full(T, -1, dtype=np.int8))
            wave_sizes.extend(tile_counts.tolist())
    else:
        # two DC waves: phase A (alternate tiles, canonical order) coded
        # context-free in the widest bucket, phase B predicted from the
        # already-decoded A-neighbour DCs
        a_set = np.arange(T) % 2 == 0
        a_tiles = np.nonzero(a_set)[0].astype(np.int64)
        sched_coef.append(a_tiles * n)
        sched_nbr.append(np.full((a_tiles.size, 6), -1, dtype=np.int64))
        sched_lf.append(np.zeros(a_tiles.size, dtype=bool))
        sched_group.append(fine_group(a_tiles.size, 2))
        sched_fbkt.append(np.full(a_tiles.size, CONTEXT_AMOUNT - 1, dtype=np.int8))
        wave_sizes.append(int(a_tiles.size))

        b_tiles = np.nonzero(~a_set)[0].astype(np.int64)
        tn = geo.tile_nbr[b_tiles].astype(np.int64)  # [B, 6]
        nbr_b = np.where((tn >= 0) & a_set[np.clip(tn, 0, None)], tn * n, -1)
        sched_coef.append(b_tiles * n)
        sched_nbr.append(nbr_b)
        sched_lf.append(np.zeros(b_tiles.size, dtype=bool))
        sched_group.append(fine_group(b_tiles.size, 2))
        sched_fbkt.append(np.full(b_tiles.size, -1, dtype=np.int8))
        wave_sizes.append(int(b_tiles.size))

        # root-HF phase: one wave; 6 taps = neighbour tiles' DC values
        tn = geo.tile_nbr.astype(np.int64)
        sched_coef.append(np.arange(T, dtype=np.int64) * n + 1)
        sched_nbr.append(np.where(tn >= 0, tn * n, -1))
        sched_lf.append(np.zeros(T, dtype=bool))
        sched_group.append(fine_group(T, 2))
        sched_fbkt.append(np.full(T, -1, dtype=np.int8))
        wave_sizes.append(T)

    # HF levels 1..depth-1, coarse to fine
    flat_mask = geo.coef_mask.reshape(-1)
    for L in range(1, depth):
        slots = geo.level_slots[L].astype(np.int64)  # canonical order
        slots = slots[flat_mask[slots]]
        nL = slots.shape[0]
        if nL == 0:
            continue
        group = 0 if L == depth - 1 else (1 if L == depth - 2 else 2)
        if mode == "parallel":
            sched_coef.append(slots)
            sched_nbr.append(geo.nbr_par[slots].astype(np.int64))
            sched_lf.append(np.zeros(nL, dtype=bool))
            sched_group.append(fine_group(nL, group))
            sched_fbkt.append(np.full(nL, -1, dtype=np.int8))
            wave_sizes.append(nL)
            continue

        nbr = geo.nbr_idx[slots].astype(np.int64)  # [nL, 6]
        # causal deps: same-level neighbours that are themselves symbols
        # (mask-true); mask-false neighbours read 0 on both sides and
        # impose no order. slot -> node by a sorted search.
        order_s = np.argsort(slots, kind="stable")
        sorted_slots = slots[order_s]
        deps = np.full((nL, 3), -1, dtype=np.int64)
        for k in range(3):
            sk = nbr[:, k]
            present = (sk >= 0) & flat_mask[np.clip(sk, 0, None)]
            pos = np.searchsorted(sorted_slots, np.clip(sk, 0, None))
            pos_c = np.minimum(pos, nL - 1)
            found = present & (sorted_slots[pos_c] == sk)
            deps[:, k] = np.where(found, order_s[pos_c], -1)
        waves = _layer_waves(nL, deps)
        order = np.lexsort((np.arange(nL), waves))
        _, counts = np.unique(waves[order], return_counts=True)
        sched_coef.append(slots[order])
        sched_nbr.append(nbr[order])
        sched_lf.append(np.zeros(nL, dtype=bool))
        sched_group.append(fine_group(nL, group))
        sched_fbkt.append(np.full(nL, -1, dtype=np.int8))
        wave_sizes.extend(counts.tolist())

    coef = np.concatenate(sched_coef)
    ws = np.asarray(wave_sizes, dtype=np.int64)
    if ws.sum() != coef.shape[0]:
        raise AssertionError("wave sizes do not cover the schedule")
    return WavefrontSchedule(
        num_symbols=int(coef.shape[0]),
        sched_coef=coef.astype(np.int32),
        sched_nbr=np.concatenate(sched_nbr, axis=0).astype(np.int32),
        sched_lf=np.concatenate(sched_lf),
        sched_group=np.concatenate(sched_group),
        legacy_of_fine=np.asarray(legacy_of_fine, dtype=np.int8),
        num_fine=len(legacy_of_fine),
        sched_fbkt=np.concatenate(sched_fbkt).astype(np.int8),
        wave_sizes=ws.astype(np.int32),
        max_wave=int(ws.shape[0]),
    )


@dataclasses.dataclass
class LaneSteps:
    """Decode-time step tensors for a lane count NL.

    Waves are cut into steps of at most NL symbols; within a step every
    symbol has a lane of its own (lane = k mod NL, k the schedule index,
    contiguous within a step), stored lane-aligned so that the per-lane
    rANS states index directly."""

    nl: int
    num_steps: int
    step_slot: np.ndarray  # [S, NL] int32 schedule index k or -1
    step_coef: np.ndarray  # [S, NL] int32 flat coefficient slot or -1
    step_nbr: np.ndarray  # [S, NL, 6] int32
    step_lf: np.ndarray  # [S, NL] bool
    step_group: np.ndarray  # [S, NL] int8
    step_fbkt: np.ndarray  # [S, NL] int8 fixed bucket or -1
    step_wave: np.ndarray  # [S] int32 wave id of each step
    # grid mode: step s IS row s of the [R, NL] symbol/word grid; the other
    # modes pack waves tightly, so a step may straddle rows and the word
    # row of symbol k is k // NL
    rows_are_steps: bool = False


def _steps_from_slot(
    sched: WavefrontSchedule,
    nl: int,
    step_slot: np.ndarray,
    wave_of_step: np.ndarray,
    rows_are_steps: bool,
) -> LaneSteps:
    valid = step_slot >= 0
    safe = np.where(valid, step_slot, 0)
    return LaneSteps(
        nl=nl,
        num_steps=step_slot.shape[0],
        step_slot=step_slot.astype(np.int32),
        step_coef=np.where(valid, sched.sched_coef[safe], -1).astype(np.int32),
        step_nbr=np.where(valid[..., None], sched.sched_nbr[safe], -1).astype(np.int32),
        step_lf=np.where(valid, sched.sched_lf[safe], False).astype(bool),
        step_group=np.where(valid, sched.sched_group[safe], 0).astype(np.int8),
        step_fbkt=np.where(valid, sched.sched_fbkt[safe], -1).astype(np.int8),
        step_wave=wave_of_step.astype(np.int32),
        rows_are_steps=rows_are_steps,
    )


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


def _build_lane_steps_grid(sched: WavefrontSchedule, nl: int) -> LaneSteps:
    row, lane, S, rows_per_wave = grid_row_lane(sched, nl)
    step_slot = np.full((S, nl), -1, dtype=np.int64)
    step_slot[row, lane] = np.arange(sched.num_symbols, dtype=np.int64)
    wave_of_step = np.repeat(np.arange(sched.max_wave, dtype=np.int64), rows_per_wave)
    return _steps_from_slot(sched, nl, step_slot, wave_of_step, True)


def build_lane_steps(sched: WavefrontSchedule, nl: int) -> LaneSteps:
    """The decode steps of `sched` at nl lanes: grid mode's rows, or each
    wave cut into steps of at most nl consecutive symbols."""
    if sched.cell_pos is not None:
        return _build_lane_steps_grid(sched, nl)
    sizes = sched.wave_sizes.astype(np.int64)
    per_wave = -(-sizes // nl)  # steps of each wave (0 for empty waves)
    S = int(per_wave.sum())
    wave_of_step = np.repeat(np.arange(sizes.shape[0], dtype=np.int64), per_wave)
    wstart = np.concatenate([[0], np.cumsum(sizes)])
    sbase = np.concatenate([[0], np.cumsum(per_wave)])
    step_k0 = wstart[wave_of_step] + (np.arange(S) - sbase[wave_of_step]) * nl
    step_len = np.minimum(nl, wstart[wave_of_step + 1] - step_k0)
    step_slot = np.full((S, nl), -1, dtype=np.int64)
    s_idx = np.repeat(np.arange(S, dtype=np.int64), step_len)
    ks = step_k0[s_idx] + (np.arange(int(step_len.sum())) - np.repeat(np.cumsum(step_len) - step_len, step_len))
    step_slot[s_idx, ks % nl] = ks
    return _steps_from_slot(sched, nl, step_slot, wave_of_step, False)


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
_lane_cache: Dict[Tuple[int, int, int, int, str], LaneSteps] = {}
_perm_cache: Dict[Tuple[int, int, int, int, str, int], np.ndarray] = {}
_lock = threading.Lock()


def get_schedule(
    height: int, width: int, depth: int = BASE_FRAC_DEPTH, mode: str = "grid"
) -> WavefrontSchedule:
    """Cached schedule per (h, w, depth, mode)."""
    key = (height, width, depth, mode)
    with _lock:
        s = _sched_cache.get(key)
    if s is None:
        s = build_schedule(get_geometry(height, width, depth), mode)
        with _lock:
            _sched_cache[key] = s
    return s


def get_lane_steps(
    height: int, width: int, nl: int, depth: int = BASE_FRAC_DEPTH, mode: str = "grid"
) -> LaneSteps:
    """Cached build_lane_steps per (h, w, depth, nl, mode)."""
    key = (height, width, depth, nl, mode)
    with _lock:
        s = _lane_cache.get(key)
    if s is None:
        s = build_lane_steps(get_schedule(height, width, depth, mode), nl)
        with _lock:
            _lane_cache[key] = s
    return s


def build_stream_perm(steps: LaneSteps, channels: int) -> np.ndarray:
    """Static permutation from stream rank to emission-grid slot.

    The rANS word stream is stored in DECODE order: step by step, channel
    by channel, active lane by active lane (ascending), at most one word
    each. The encoder emits words on the [R, C, NL] symbol grid (row r:
    symbols [r*NL, (r+1)*NL), or grid mode's row = step); by rANS renorm
    symmetry the word emitted while encoding symbol k is the one pulled
    while decoding it, so the stream order is this static map and no
    per-lane word counts travel in the container.

    Returns perm [K * channels] int32: perm[j] is the flat index into the
    row-major [R, C, NL] grid whose word (if flagged) has rank j among
    the flagged ones."""
    nl = steps.nl
    valid = steps.step_slot >= 0  # [S, NL]
    s_idx, l_idx = np.nonzero(valid)  # (step, lane)-ordered
    k = steps.step_slot[valid].astype(np.int64)
    if steps.rows_are_steps:
        r, lane = s_idx.astype(np.int64), l_idx.astype(np.int64)
    else:
        r, lane = k // nl, k % nl
        if not np.array_equal(lane, l_idx):
            raise AssertionError("a symbol sits off its lane")
    C = channels
    K = k.shape[0]
    src = ((r[:, None] * C + np.arange(C)[None, :]) * nl + lane[:, None]).reshape(-1)
    order = np.lexsort((np.repeat(lane, C), np.tile(np.arange(C), K), np.repeat(s_idx, C)))
    return src[order].astype(np.int32)


def get_stream_perm(
    height: int, width: int, nl: int, depth: int = BASE_FRAC_DEPTH, mode: str = "grid",
    channels: int = 1,
) -> np.ndarray:
    """Cached build_stream_perm per (h, w, nl, depth, mode, channels)."""
    key = (height, width, nl, depth, mode, channels)
    with _lock:
        p = _perm_cache.get(key)
    if p is None:
        p = build_stream_perm(get_lane_steps(height, width, nl, depth, mode), channels)
        with _lock:
            _perm_cache[key] = p
    return p
