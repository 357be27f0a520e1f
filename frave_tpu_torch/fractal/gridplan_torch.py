"""Torch executor for fractal/gridplan.py plans.

gridplan.apply_plan runs a host-verified op list (pad, transpose, flip,
flat-stride, and the rare explicit "take") on numpy arrays. Two of its
spellings have no torch form — numpy's pad-width pairs and `flip(axis=)` —
so this executor restates the same ops for torch, on the two trailing
axes of a tensor with any leading (channel) dims.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .gridplan import GridPlan


def _pad_last(t: torch.Tensor, lo: int, hi: int, fill) -> torch.Tensor:
    if lo == 0 and hi == 0:
        return t
    return F.pad(t, (lo, hi), value=fill)


def apply_plan(plan: GridPlan, arr: torch.Tensor, fill=0) -> torch.Tensor:
    """OUT[..., i, j] = arr[..., f(i, j)] for the plan's affine map f, with
    `fill` where f reads out of bounds. arr: [..., H, W]."""
    lead = tuple(arr.shape[:-2])
    for op in plan.ops:
        tag = op[0]
        if tag == "pad":
            _, lo0, hi0, lo1, hi1 = op
            arr = F.pad(arr, (lo1, hi1, lo0, hi0), value=fill)
        elif tag == "transpose":
            arr = arr.transpose(-1, -2)
        elif tag == "flip":
            arr = arr.flip(-2 if op[1] == 0 else -1)
        elif tag == "stride":
            _, P, Q, O, I, J = op
            flat = arr.reshape(lead + (-1,))
            lpad = max(0, -O)
            rneed = O + lpad + (I - 1) * P + (J - 1) * Q + 1
            rpad = max(0, rneed - (flat.shape[-1] + lpad))
            flat = _pad_last(flat, lpad, rpad, fill)
            start = O + lpad
            span = (I - 1) * P + (J - 1) * Q + 1
            flat = flat[..., start : start + span]
            if span < I * P:
                flat = _pad_last(flat, 0, I * P - span, fill)
            arr = flat[..., : I * P].reshape(lead + (I, P))[
                ..., :, : (J - 1) * Q + 1 : Q
            ]
        elif tag == "take":
            _, idx0, idx1, mask = op
            dev = arr.device
            i0 = torch.as_tensor(idx0, dtype=torch.int64, device=dev)
            i1 = torch.as_tensor(idx1, dtype=torch.int64, device=dev)
            m = torch.as_tensor(mask, dtype=torch.bool, device=dev)
            got = arr[..., i0, i1]
            arr = torch.where(m, got, torch.full_like(got, fill))
        else:  # pragma: no cover
            raise AssertionError(f"unknown grid op {tag}")
    if tuple(arr.shape[-2:]) != tuple(plan.out_shape):
        raise AssertionError((tuple(arr.shape), plan.out_shape))
    return arr
