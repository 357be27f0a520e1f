"""Each CUDA kernel of the port against its plain PyTorch version.

Seeded inputs at a given shape, the kernel wrapper and the plain version
run on the same device tensors, the largest absolute difference of their
outputs (the kernels are integer, so anything but 0 is a fault) and,
optionally, the median time of each over repeated launches, measured with
CUDA events. Used by chip_smoke.py and by the card-only test.
"""

from __future__ import annotations

import numpy as np
import torch

from frave_tpu.entropy.tables import ALPHABET_SIZE, CONTEXT_AMOUNT, _LAPLACE_GRID_ROWS

from .entropy.tables_torch import finalize_contexts_device
from .ops import lifting as L
from .ops import rans_torch as RT

# name -> (wrapper, plain version, CUDA source, the TPU kernel it replaces)
KERNELS = {
    "forward_lift_quantize": (
        L.forward_lift_quantize,
        L.forward_lift_quantize_plain,
        "frave_tpu_torch/csrc/lifting.cu",
        "frave_tpu/ops/pallas_lifting.py:120",
    ),
    "dequantize_inverse_lift": (
        L.dequantize_inverse_lift,
        L.dequantize_inverse_lift_plain,
        "frave_tpu_torch/csrc/lifting.cu",
        "frave_tpu/ops/pallas_lifting.py:148",
    ),
    "encode_scan": (
        RT.encode_scan,
        RT.encode_scan_plain,
        "frave_tpu_torch/csrc/rans_encode.cu",
        "frave_tpu/ops/rans_jax.py:52",
    ),
}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def lifting_problem(rng, rows: int, mask_rows: int, depth: int = 9):
    """(leaves [rows, N] int32 pre-masked, leaf mask, node mask
    [mask_rows, N] uint8, qdiv [N] int32 not all ones) on the CPU."""
    n = 1 << depth
    leaf_mask = rng.random((mask_rows, n)) > 0.1
    node_mask = rng.random((mask_rows, n)) > 0.05
    leaves = rng.integers(0, 256, size=(rows, n))
    leaves = np.where(np.tile(leaf_mask, (rows // mask_rows, 1)), leaves, 0)
    qdiv = np.ones(n, np.int32)
    qdiv[n // 2 :] = 3
    qdiv[n // 4 : n // 2] = 2
    return (
        _t(leaves.astype(np.int32)), _t(leaf_mask.astype(np.uint8)),
        _t(node_mask.astype(np.uint8)), _t(qdiv),
    )


def rans_problem(rng, R: int, C: int, NL: int):
    """A seeded encode_scan problem (sym, bkt, valid, freqs, cdfs, bits)
    on the CPU whose tables give every drawn symbol a nonzero frequency;
    the last row is partly filled, as the grid's last rows are."""
    sym = np.minimum(rng.geometric(0.08, size=(R, C, NL)) - 1, ALPHABET_SIZE - 1)
    bkt = rng.integers(0, CONTEXT_AMOUNT, size=(R, C, NL))
    valid = np.ones((R, C, NL), dtype=bool)
    valid[-1, :, NL - NL // 3 :] = False
    ids = (np.arange(C)[None, :, None] * CONTEXT_AMOUNT + bkt) * ALPHABET_SIZE + sym
    hist = np.bincount(ids[valid], minlength=C * CONTEXT_AMOUNT * ALPHABET_SIZE)
    hist = _t(hist.reshape(C, CONTEXT_AMOUNT, ALPHABET_SIZE))
    bits, freqs, cdfs, _ = finalize_contexts_device(hist, _t(_LAPLACE_GRID_ROWS))
    i32 = torch.int32
    return (
        _t(sym.astype(np.int32)), _t(bkt.astype(np.int32)), _t(valid.astype(np.uint8)),
        freqs.to(i32), cdfs.to(i32), bits.to(i32),
    )


def problem(name: str, rng, shape):
    """(positional args, extra args) for kernel `name` at `shape`:
    lifting (rows, mask_rows), encode_scan (R, C, NL)."""
    if name == "forward_lift_quantize":
        leaves, lm, _, qdiv = lifting_problem(rng, *shape)
        return (leaves, lm, qdiv), (9,)
    if name == "dequantize_inverse_lift":
        leaves, lm, nm, qdiv = lifting_problem(rng, *shape)
        qcoef = L.forward_lift_quantize_plain(leaves, lm, qdiv, 9)
        return (qcoef, nm, lm, qdiv), (9,)
    if name == "encode_scan":
        return rans_problem(rng, *shape), ()
    raise KeyError(name)


def _max_abs_err(a, b) -> int:
    if isinstance(a, tuple):
        return max(_max_abs_err(x, y) for x, y in zip(a, b))
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.dtype == torch.bool:
        a, b = a.to(torch.int64), b.to(torch.int64)
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median time of fn() on the current CUDA stream, CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def check(name: str, shape, device, seed: int = 0, timed: bool = False) -> dict:
    """Kernel `name` vs its plain version on the same `device` tensors at
    `shape`. Returns {"name", "shape", "max_abs_err", "ms", "plain_ms"}
    (times None unless timed)."""
    wrapper, plain, _, _ = KERNELS[name]
    args, extra = problem(name, np.random.default_rng(seed), shape)
    args = tuple(a.to(device) for a in args)
    got = wrapper(*args, *extra)
    ref = plain(*args, *extra)
    out = {"name": name, "shape": list(shape), "max_abs_err": _max_abs_err(got, ref),
           "ms": None, "plain_ms": None}
    if timed:
        out["ms"] = median_ms(lambda: wrapper(*args, *extra))
        out["plain_ms"] = median_ms(lambda: plain(*args, *extra))
    return out
