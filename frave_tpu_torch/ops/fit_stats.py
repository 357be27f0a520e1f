"""The encode's predictor fits: csrc/fit_stats.cu and its plain version.

An encode batch's statistics fit, for every (image, channel) row and
every predictor group, a value predictor by least squares over the
group's fit samples, rounds it to the f16 wire values, then fits a width
model to the |residuals| of those rounded values (fit_predictors). On the
card fit_stats runs it in four launches whatever the batch (the value
pass, its solve, the width pass, its solve; csrc/fit_stats.cu says how);
on CPU tensors it runs the plain version, fit_stats_plain, which is
fit_predictors on the gathered taps and targets. Each launch adds one to
fit_stats.launches.

A program's fit samples come as a FitTable (fit_table, built once a
sample set): the int32 [7, n] slot table the kernels read, the int64 taps
and targets the plain version gathers (the program's fit_samples, shared,
not copied), and the cut of each group into chunks (chunk_table), which
depends on the groups' sizes alone. chunk_sums gives one pass's per-chunk
sums ([rows, chunks, 27] int64: the 21 upper Gram entries, then b; the
width pass's b as float64 bits), the kernel's on the card and
chunk_sums_plain's on the CPU; group_sums adds them up to each group's
normal equations, which the tests hold against value_equations' and
width_equations' float64 sums.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import _build
from . import torch_ops as T

_I32 = torch.int32
_I64 = torch.int64
_F32 = torch.float32
_F64 = torch.float64
TAPS = 6
# a group of n samples is cut into min(MAX_CHUNKS, ceil(n / MIN_CHUNK))
# chunks, one block (of csrc/fit_stats.cu kThreads) a chunk and row; the
# solve adds a group's chunks in one warp, a lane a chunk
MIN_CHUNK = 1024
MAX_CHUNKS = 32
# a chunk's sums: the upper entries of the 6x6 Gram in row order, then b
UPPER = [(i, j) for i in range(TAPS) for j in range(i, TAPS)]
PARTIAL = len(UPPER) + TAPS


def _gram_solve(G: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Regularised Cholesky solve of batched 6x6 normal equations. Where
    the factorisation fails the result is NaN, as XLA's Cholesky gives."""
    tr = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)
    eps = tr * 1e-6 / 6.0 + 1e-12
    eye = torch.eye(G.shape[-1], dtype=G.dtype, device=G.device)
    L, info = torch.linalg.cholesky_ex(G + eps[..., None, None] * eye)
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    x = torch.linalg.solve_triangular(L.mT, y, upper=True)[..., 0]
    return torch.where((info != 0)[..., None], torch.full_like(x, float("nan")), x)


def _width_feats(Xs: torch.Tensor) -> torch.Tensor:
    """Width-model design features over tap values [..., 6]: bias + the 5
    gradient magnitudes."""
    return torch.stack(
        [
            torch.ones_like(Xs[..., 0]),
            torch.abs(Xs[..., 0] - Xs[..., 3]),
            torch.abs(Xs[..., 1] - Xs[..., 2]),
            torch.abs(Xs[..., 4] - Xs[..., 5]),
            torch.abs(Xs[..., 1] - Xs[..., 5]),
            torch.abs(Xs[..., 2] - Xs[..., 4]),
        ],
        dim=-1,
    )


def value_equations(Xs_l, ys_l):
    """The value fits' normal equations in float64: (G [rows, F, 6, 6],
    b [rows, F, 6]) over per-group taps [rows, k_g, 6] and targets
    [rows, k_g] (float64)."""
    G = torch.stack([torch.einsum("ckx,cky->cxy", X, X) for X in Xs_l], dim=1)
    b = torch.stack([torch.einsum("ckx,ck->cx", X, y) for X, y in zip(Xs_l, ys_l)], dim=1)
    return G, b


def width_equations(Xs_l, ys_l, vparams):
    """The width fits' normal equations in float64 over the residuals of
    the f16 wire vparams [rows, F, 6]: features _width_feats, target
    |y - pred|."""
    Gws, bws = [], []
    for g, (X, y) in enumerate(zip(Xs_l, ys_l)):
        pred = torch.einsum("ckx,cx->ck", X, vparams[:, g].to(_F64))
        rg = torch.abs(y - pred)
        Fs = _width_feats(X)
        Gws.append(torch.einsum("ckx,cky->cxy", Fs, Fs))
        bws.append(torch.einsum("ckx,ck->cx", Fs, rg))
    return torch.stack(Gws, dim=1), torch.stack(bws, dim=1)


def fit_predictors(Xs_l, ys_l, overrides, reduce=None):
    """Per-group predictor fits of every row: Xs_l / ys_l are per-group
    tap values [rows, k_g, 6] and targets [rows, k_g] (integer values), a
    row one (image, channel) of a batch. Value parameters by least squares,
    rounded to the f16 wire values; width parameters fitted to the
    |residuals| of those rounded values. `overrides` = (vp [rows, F, 6],
    wp, use_w) tensors pin the parameters instead (the width fit still runs
    when only the value parameters are pinned). `reduce`, where given, sums
    each pair of normal equations (G, b) over the shards of a sharded
    encode before its solve: each shard passes its own samples. Returns
    (vparams, wparams) [rows, F, 6] f32 — ONE tensor each, read by both
    the symbol math and the wire header.

    The sums and solves run in float64 and round to f32 at the end: the
    value Grams of integer taps are exact there (the width Grams all but
    exact), so a row's fit does not depend on the order in which a library
    sums, which on the card follows the batch's row count. An image's fit
    is therefore the same alone and in any batch."""
    vp_ovr, wp_ovr, use_w = overrides if overrides is not None else (None, None, False)
    Xs_l = [X.to(_F64) for X in Xs_l]
    ys_l = [y.to(_F64) for y in ys_l]
    if vp_ovr is None:
        G, bv = value_equations(Xs_l, ys_l)
        if reduce is not None:
            G, bv = reduce(G, bv)
        vparams = _gram_solve(G, bv).to(_F32)
    else:
        vparams = vp_ovr
    vparams = T.f16_wire_round(vparams)
    if use_w:
        wparams = wp_ovr
    else:
        Gw, bw = width_equations(Xs_l, ys_l, vparams)
        if reduce is not None:
            Gw, bw = reduce(Gw, bw)
        wparams = _gram_solve(Gw, bw).to(_F32)
    return vparams, T.f16_wire_round(wparams)


def chunk_table(sizes):
    """The chunks of groups of `sizes` samples (in group order, each group
    contiguous): (chunk_start [chunks + 1] int32, the first sample of each
    chunk and then n; chunk_group [chunks] int32; chunk_off [F + 1] int32,
    the first chunk of each group and then chunks). A group of k samples
    has min(MAX_CHUNKS, ceil(k / MIN_CHUNK)) chunks of ceil(k / chunks)
    samples, the last shorter; an empty group none."""
    starts, group, off, base = [], [], [0], 0
    for g, k in enumerate(int(s) for s in sizes):
        m = min(MAX_CHUNKS, -(-k // MIN_CHUNK))
        step = -(-k // m) if m else 0
        starts += [base + i * step for i in range(m)]
        group += [g] * m
        off.append(off[-1] + m)
        base += k
    return (np.array(starts + [base], np.int32), np.array(group, np.int32),
            np.array(off, np.int32))


@dataclasses.dataclass
class FitTable:
    """One sample set's fit samples on one device: samples [7, n] int32
    (the six tap slots, then the target slot; the kernels' table), taps
    [n, 6] and target [n] int64 (the plain version's), sizes (each group's
    sample count, in group order), the chunk tables of chunk_table, and
    max_slot, the largest slot the samples name."""

    samples: torch.Tensor
    taps: torch.Tensor
    target: torch.Tensor
    sizes: tuple
    chunk_start: torch.Tensor
    chunk_group: torch.Tensor
    chunk_off: torch.Tensor
    max_slot: int

    @property
    def groups(self) -> int:
        return len(self.sizes)

    @property
    def chunks(self) -> int:
        return self.chunk_group.shape[0]

    def to(self, device) -> "FitTable":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def fit_table(taps: torch.Tensor, target: torch.Tensor, sizes) -> FitTable:
    """The FitTable of taps [n, 6] and target slots [n] (int64, on their
    device; kept, not copied), groups of `sizes` samples in order."""
    sizes = tuple(int(s) for s in sizes)
    if taps.shape != (sum(sizes), TAPS) or target.shape != (sum(sizes),):
        raise ValueError(f"taps {tuple(taps.shape)} and target {tuple(target.shape)} do not "
                         f"hold {sum(sizes)} samples")
    if sum(sizes) >= 1 << 31:
        raise ValueError("a sample set holds fewer than 2^31 samples")
    samples = torch.cat([taps.T, target[None]]).to(_I32).contiguous()
    max_slot = int(samples.max()) if samples.numel() else 0
    dev = taps.device
    start, group, off = (torch.as_tensor(a, device=dev) for a in chunk_table(sizes))
    return FitTable(samples, taps, target, sizes, start, group, off, max_slot)


def _check(rows: torch.Tensor, table: FitTable) -> None:
    if rows.dtype != _I32 or rows.dim() != 2 or rows.stride(1) != 1:
        raise TypeError(f"rows must be int32 [rows, slots] with unit column stride, got "
                        f"{rows.dtype} {tuple(rows.shape)} {rows.stride()}")
    if table.max_slot >= rows.shape[1]:
        raise ValueError(f"the samples name slot {table.max_slot}, past rows of "
                         f"{rows.shape[1]}")
    if rows.device != table.samples.device:
        raise ValueError(f"rows on {rows.device}, the table on {table.samples.device}")


def _gather(rows: torch.Tensor, table: FitTable):
    """The per-group taps [rows, k_g, 6] and targets [rows, k_g] of rows."""
    return (torch.split(rows[:, table.taps], table.sizes, dim=1),
            torch.split(rows[:, table.target], table.sizes, dim=1))


def fit_stats_plain(rows: torch.Tensor, table: FitTable, overrides=None):
    """fit_stats as the plain version computes it: the samples' taps and
    targets gathered, then fit_predictors."""
    _check(rows, table)
    Xs_l, ys_l = _gather(rows, table)
    return fit_predictors(Xs_l, ys_l, overrides)


def _pass(rows, table, vparams, part) -> None:
    lib = _build.load_library()
    code = lib.frave_fit_pass(
        rows.data_ptr(), rows.stride(0), rows.shape[0], table.samples.data_ptr(),
        table.samples.shape[1], table.chunk_start.data_ptr(), table.chunk_group.data_ptr(),
        table.chunks, None if vparams is None else vparams.data_ptr(), table.groups,
        part.data_ptr(), _build.current_stream(rows.device))
    _build.check(code, "frave_fit_pass")
    fit_stats.launches += 1


def _solve(part, table, width: bool, rows: int) -> torch.Tensor:
    out = torch.empty((rows, table.groups, TAPS), dtype=_F32, device=part.device)
    lib = _build.load_library()
    code = lib.frave_fit_solve(part.data_ptr(), table.chunk_off.data_ptr(), rows, table.groups,
                               table.chunks, int(width), out.data_ptr(),
                               _build.current_stream(part.device))
    _build.check(code, "frave_fit_solve")
    fit_stats.launches += 1
    return out


def fit_stats(rows: torch.Tensor, table: FitTable, overrides=None):
    """rows [R, >= max_slot + 1] int32 (an encode batch's coefficient plane
    rows, one (image, channel) a row; any row stride), the FitTable of the
    program's sample set, overrides (vp [R, F, 6], wp, use_w) or None ->
    (vparams, wparams) [R, F, 6] f32, the f16 wire values, as
    fit_predictors gives them. On the card: the value pass and its solve
    unless vp is pinned, the width pass and its solve unless use_w; the
    plain version on the CPU."""
    _check(rows, table)
    if rows.device.type == "cpu":
        return fit_stats_plain(rows, table, overrides)
    if rows.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {rows.device}")
    R = rows.shape[0]
    if not 1 <= R <= 65535:
        raise ValueError(f"rows must number 1 to 65535, got {R}")
    vp_ovr, wp_ovr, use_w = overrides if overrides is not None else (None, None, False)
    part = torch.empty((R, table.chunks, PARTIAL), dtype=_I64, device=rows.device)
    if vp_ovr is None:
        _pass(rows, table, None, part)
        vparams = _solve(part, table, False, R)
    else:
        vparams = T.f16_wire_round(vp_ovr)
    if use_w:
        return vparams, T.f16_wire_round(wp_ovr)
    _pass(rows, table, vparams.contiguous(), part)
    return vparams, _solve(part, table, True, R)


fit_stats.launches = 0


def chunk_sums_plain(rows: torch.Tensor, table: FitTable, vparams=None) -> torch.Tensor:
    """One pass's per-chunk sums [R, chunks, 27] int64 in plain PyTorch:
    the value pass (vparams None: the Gram of the taps, then taps times
    target) or the width pass over the f16 wire vparams [R, F, 6] (the
    Gram of _width_feats, then the features times |y - pred| in float64,
    whose bits fill the last six). Each chunk's float64 sum runs over its
    samples in order (index_add_), row by row."""
    _check(rows, table)
    X = rows[:, table.taps].to(_I64)
    y = rows[:, table.target].to(_I64)
    group = torch.repeat_interleave(torch.arange(table.groups, device=rows.device),
                                    torch.as_tensor(table.sizes, device=rows.device))
    chunk = torch.bucketize(torch.arange(X.shape[1], device=rows.device),
                            table.chunk_start[1:].to(_I64), right=True)
    i, j = (torch.tensor(ix, device=rows.device) for ix in zip(*UPPER))
    if vparams is None:
        per = torch.cat([X[..., i] * X[..., j], X * y[..., None]], dim=-1)
    else:
        pred = (X.to(_F64) * vparams[:, group].to(_F64)).sum(-1)
        rg = torch.abs(y.to(_F64) - pred)
        Fs = _width_feats(X)
        b = (Fs.to(_F64) * rg[..., None]).view(_I64)
        per = torch.cat([Fs[..., i] * Fs[..., j], b], dim=-1)
    out = torch.zeros((X.shape[0], table.chunks, PARTIAL), dtype=_I64, device=rows.device)
    out[..., :len(UPPER)].index_add_(1, chunk, per[..., :len(UPPER)])
    if vparams is None:
        out[..., len(UPPER):].index_add_(1, chunk, per[..., len(UPPER):])
    else:
        bf = torch.zeros((X.shape[0], table.chunks, TAPS), dtype=_F64, device=rows.device)
        bf.index_add_(1, chunk, per[..., len(UPPER):].view(_F64))
        out[..., len(UPPER):] = bf.view(_I64)
    return out


def chunk_sums(rows: torch.Tensor, table: FitTable, vparams=None) -> torch.Tensor:
    """One pass's per-chunk sums [R, chunks, 27] int64 (chunk_sums_plain's
    layout): one frave_fit_pass launch on the card (its float64 sums in
    the kernel's order), chunk_sums_plain on the CPU."""
    _check(rows, table)
    if rows.device.type == "cpu":
        return chunk_sums_plain(rows, table, vparams)
    part = torch.empty((rows.shape[0], table.chunks, PARTIAL), dtype=_I64, device=rows.device)
    _pass(rows, table, None if vparams is None else vparams.contiguous(), part)
    return part


def group_sums(part: torch.Tensor, table: FitTable, width: bool = False):
    """Each group's normal equations from a pass's per-chunk sums: (G
    [R, F, 6, 6], b [R, F, 6]) float64; the Gram and the value pass's b
    added as integers (exact), the width pass's b in float64 in chunk
    order."""
    R, F = part.shape[0], table.groups
    sums = torch.zeros((R, F, PARTIAL), dtype=_I64, device=part.device)
    sums.index_add_(1, table.chunk_group.to(_I64), part)
    G = torch.zeros((R, F, TAPS, TAPS), dtype=_F64, device=part.device)
    for e, (i, j) in enumerate(UPPER):
        G[..., i, j] = G[..., j, i] = sums[..., e].to(_F64)
    if not width:
        return G, sums[..., len(UPPER):].to(_F64)
    bf = part[..., len(UPPER):].view(_F64)
    off = chunk_table(table.sizes)[2]
    b = torch.zeros((R, F, TAPS), dtype=_F64, device=part.device)
    for g in range(F):
        for c in range(off[g], off[g + 1]):
            b[:, g] += bf[:, c]
    return G, b
