"""Context-table pipeline on the device: the port of
frave_tpu/entropy/tables_jax.py.

finalize_contexts_device is an exact integer twin of the host
entropy/tables.finalize_context (the decoder regenerates the
tables from the wire fields, and rANS breaks on any 1-bit difference).
select_scales_device picks the Laplace-grid scale per context; the index
travels on the wire, so it is encode-only and need not match another
implementation's float ordering (see its docstring).
"""

from __future__ import annotations

import torch

from .tables import ENC_FREQ_BITS_CAP, MAX_FREQ_BITS_CAP, MIN_FREQ_BITS


def _bits_from_total(total: torch.Tensor) -> torch.Tensor:
    """clamp(bit_length(total) - 1, MIN_FREQ_BITS, ENC_FREQ_BITS_CAP)."""
    bits = torch.full_like(total, MIN_FREQ_BITS)
    for k in range(MIN_FREQ_BITS + 1, ENC_FREQ_BITS_CAP + 1):
        bits = bits + (total >= (1 << k)).to(bits.dtype)
    return bits


def select_scales_device(
    hist: torch.Tensor, grid_log2: torch.Tensor, grid_zero: torch.Tensor
) -> torch.Tensor:
    """Per-(..., context) Laplace-grid scale maximising
    sum_a hist*log2(row) - 16 * |{data symbols the row zeroes}| at the
    context's starting bits (tables.select_scale). Ties resolve to the
    lowest index.

    hist [..., CA, 1024] int; grid_log2 / grid_zero [G, 7, 1024] f32.
    Returns [..., CA] int64. The gains are summed in f64 — every term
    (an integer count times an f32 log2) is exact there — so the choice
    is the true argmax; the f32 twins (host numpy, jax) can flip only
    where two scales' gains agree to within f32 rounding."""
    h = hist.to(torch.float64)
    data = (hist > 0).to(torch.float64)
    G, NB, A = grid_log2.shape
    gl = h @ grid_log2.to(torch.float64).reshape(G * NB, A).T  # [..., CA, G*7]
    gz = data @ grid_zero.to(torch.float64).reshape(G * NB, A).T
    gains = (gl - 16.0 * gz).reshape(hist.shape[:-1] + (G, NB))
    b = _bits_from_total(hist.sum(dim=-1)) - MIN_FREQ_BITS  # [..., CA]
    idx = b[..., None, None].expand(b.shape + (G, 1))
    sel = torch.gather(gains, -1, idx)[..., 0]  # [..., CA, G]
    return torch.argmax(sel, dim=-1)


def finalize_contexts_device(
    hist: torch.Tensor,
    lap_rows: torch.Tensor,
    bits0: torch.Tensor = None,
    off_mask_in: torch.Tensor = None,
    scale_idx: torch.Tensor = None,
):
    """hist [..., CA, 1024] data histograms; lap_rows [G, 7, 1024] Laplace
    rows per (grid scale, bits), indexed by scale_idx [..., CA] (format
    v9), or by the context id when scale_idx is None (legacy rows).

    Encode side: bits0/off_mask_in omitted — the starting bits come from
    the histogram totals. Decode side: the wire bits and off-mask with an
    all-zero hist.

    Returns (bits [..., CA] int64, freqs [..., CA, 1024] int64,
    cdf [..., CA, 1024] int64, off_mask [..., CA, 1024] bool)."""
    h = hist.to(torch.int64)
    data_raw = h > 0
    data = data_raw if off_mask_in is None else (data_raw | off_mask_in)
    total = h.sum(dim=-1)
    if bits0 is None:
        bits = _bits_from_total(total)
    else:
        bits = torch.clamp(bits0.to(torch.int64), MIN_FREQ_BITS, MAX_FREQ_BITS_CAP)

    lap = lap_rows.to(torch.int64)
    if scale_idx is None:
        ca = hist.shape[-2]
        scale_idx = torch.arange(ca, device=hist.device).expand(hist.shape[:-1])
    rows = lap[scale_idx.to(torch.int64)]  # [..., CA, 7, 1024]

    # sequential bump: b = bits0; while not ok(b) and b < 14: b += 1, with
    # ok(b) = (1 << b) >= nnz of the filled row at b
    nnz = ((rows > 0) | data[..., None, :]).sum(dim=-1)  # [..., CA, 7]
    for k in range(MIN_FREQ_BITS, MAX_FREQ_BITS_CAP):
        ok = (1 << k) >= nnz[..., k - MIN_FREQ_BITS]
        bits = torch.where((bits == k) & ~ok, bits + 1, bits)

    sel = (bits - MIN_FREQ_BITS)[..., None, None].expand(
        bits.shape + (1, rows.shape[-1])
    )
    lap_sel = torch.gather(rows, -2, sel)[..., 0, :]  # [..., CA, 1024]
    one = torch.ones((), dtype=torch.int64, device=h.device)
    zero = torch.zeros((), dtype=torch.int64, device=h.device)
    filled = torch.where(lap_sel > 0, lap_sel, torch.where(data, one, zero))
    off_mask = data_raw & (lap_sel == 0)
    if off_mask_in is not None:
        off_mask = off_mask | off_mask_in

    # largest-remainder normalisation (tables._normalize_freqs twin)
    target = one << bits  # [..., CA]
    total2 = filled.sum(dim=-1)
    scaled = torch.div(
        filled * target[..., None], total2[..., None], rounding_mode="floor"
    )
    s = torch.where(filled > 0, torch.clamp(scaled, min=1), zero)
    diff = target - s.sum(dim=-1)

    # diff > 0: everything goes to the (first) largest entry
    jmax = torch.argmax(s, dim=-1, keepdim=True)
    s = s.scatter_add(-1, jmax, torch.clamp(diff, min=0)[..., None])
    s = drain_excess(s, torch.clamp(diff, max=0))
    cdf = torch.cumsum(s, dim=-1) - s
    return bits, s, cdf, off_mask


def drain_excess(s: torch.Tensor, diff: torch.Tensor) -> torch.Tensor:
    """The excess -diff [...] (diff <= 0) of the frequencies s [..., 1024]
    taken as tables._normalize_freqs' loop takes it: the (first) largest
    entry drained down to 1, then the next, until none is left. Draining
    never reorders the entries not yet drained, so the loop visits them in
    a stable descending sort, each giving up to s - 1: in that closed form
    it needs no read of the device from the host (the loop's test is one
    per step)."""
    order = torch.sort(s, dim=-1, descending=True, stable=True).indices
    cap = torch.clamp(torch.gather(s, -1, order) - 1, min=0)
    before = torch.cumsum(cap, dim=-1) - cap  # what the earlier entries give
    take = torch.minimum(torch.clamp(-diff[..., None] - before, min=0), cap)
    return s.scatter_add(-1, order, -take)
