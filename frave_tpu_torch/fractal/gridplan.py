"""Gather-free realization of integer-affine 2D grid transforms.

The port's copy of frave_tpu/fractal/gridplan.py, the host planner. Given
a source grid S and an integer affine map f(z) = M @ z + c, a plan
produces OUT[z] = S[f(z)] (fill where out of bounds) using only layout
operations — pad, transpose, flip, and a flat-stride read:

    out[i, j] = flat[O + i*P + j*Q]  ==  flat (padded to cover the read
    span) reshaped [I, P], column-sliced [.. :: Q] — exact whenever
    rows don't overlap (P >= (J-1)*Q + 1 and Q >= 1).

One such op realizes any lower-triangular integer matrix with arbitrary
offset; a Bruhat-style factorization M = [[1,0],[x,1]] @ SWAP? @ L makes
every map of the lattice layout at most two strides and a transpose. The
planner verifies the op list against direct indexing on an iota array
(apply_plan, numpy); on any failure it falls back to an explicit ("take",
...) gather, counted on the plan (`gathers`). The device executes plans
with fractal/gridplan_torch.apply_plan.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

Op = Tuple


@dataclasses.dataclass
class GridPlan:
    ops: List[Op]
    out_shape: Tuple[int, int]
    gathers: int  # 0 = fully gather-free


def apply_plan(plan: GridPlan, arr: np.ndarray, fill=0) -> np.ndarray:
    """Execute a plan on a numpy array (the planner's verification)."""
    xp = np
    for op in plan.ops:
        tag = op[0]
        if tag == "pad":
            _, lo0, hi0, lo1, hi1 = op
            arr = xp.pad(
                arr, ((lo0, hi0), (lo1, hi1)), constant_values=fill
            )
        elif tag == "transpose":
            arr = arr.T
        elif tag == "flip":
            arr = xp.flip(arr, axis=op[1])
        elif tag == "stride":
            _, P, Q, O, I, J = op
            flat = arr.reshape(-1)
            lpad = max(0, -O)
            rneed = O + lpad + (I - 1) * P + (J - 1) * Q + 1
            rpad = max(0, rneed - (flat.shape[0] + lpad))
            if lpad or rpad:
                flat = xp.pad(flat, (lpad, rpad), constant_values=fill)
            start = O + lpad
            span = (I - 1) * P + (J - 1) * Q + 1
            flat = flat[start : start + span]
            if span < I * P:
                flat = xp.pad(
                    flat, (0, I * P - span), constant_values=fill
                )
            arr = flat[: I * P].reshape(I, P)[:, : (J - 1) * Q + 1 : Q]
        elif tag == "take":
            _, idx0, idx1, mask = op
            g = arr[xp.asarray(idx0), xp.asarray(idx1)]
            arr = xp.where(xp.asarray(mask), g, fill)
        else:  # pragma: no cover
            raise AssertionError(f"unknown grid op {tag}")
    assert arr.shape == plan.out_shape, (arr.shape, plan.out_shape)
    return arr


def _emit_stride(
    ops: List[Op],
    shape: Tuple[int, int],
    T: np.ndarray,  # [[a, 0], [b, c]] lower-triangular, a, c >= 1
    t: np.ndarray,  # offset [2]
    out_hw: Tuple[int, int],
) -> Optional[Tuple[int, int]]:
    """Append ops realizing cur2[i, j] = cur[T @ (i, j) + t] (fill when
    out of the real region). Pads cur's width first so intended reads
    never wrap rows. Returns the new shape, or None if infeasible."""
    a, b, ccol = int(T[0, 0]), int(T[1, 0]), int(T[1, 1])
    if int(T[0, 1]) != 0 or a < 1 or ccol < 1:
        return None
    I2, J2 = out_hw
    H0, W0 = shape
    # y1 = b*i + c*j + t1 over the out domain
    y1s = [
        b * i + ccol * j + int(t[1]) for i in (0, I2 - 1) for j in (0, J2 - 1)
    ]
    lo1, hi1 = min(y1s), max(y1s)
    padl = max(0, -lo1)
    padr = max(0, hi1 - (W0 - 1))
    # y0 = a*i + t0
    y0s = [int(t[0]), a * (I2 - 1) + int(t[0])]
    lo0, hi0 = min(y0s), max(y0s)
    padu = max(0, -lo0)
    padd = max(0, hi0 - (H0 - 1))
    if padl or padr or padu or padd:
        ops.append(("pad", padu, padd, padl, padr))
    H1, W1 = H0 + padu + padd, W0 + padl + padr
    P = a * W1 + b
    Q = ccol
    O = (int(t[0]) + padu) * W1 + int(t[1]) + padl
    if P < (J2 - 1) * Q + 1:
        return None
    ops.append(("stride", P, Q, O, I2, J2))
    return (I2, J2)


def plan_affine_take(
    src_shape: Tuple[int, int],
    M: np.ndarray,
    c: np.ndarray,
    out_shape: Tuple[int, int],
) -> GridPlan:
    """Plan OUT[z] = SRC[M @ z + c] with fill at out-of-bounds reads."""
    M = np.asarray(M, dtype=np.int64)
    c = np.asarray(c, dtype=np.int64)
    I, J = out_shape
    H0, W0 = src_shape

    ii, jj = np.meshgrid(
        np.arange(I, dtype=np.int64),
        np.arange(J, dtype=np.int64),
        indexing="ij",
    )
    y0 = M[0, 0] * ii + M[0, 1] * jj + c[0]
    y1 = M[1, 0] * ii + M[1, 1] * jj + c[1]
    inb = (y0 >= 0) & (y0 < H0) & (y1 >= 0) & (y1 < W0)
    iota = np.arange(H0 * W0, dtype=np.int64).reshape(H0, W0)
    want = np.where(
        inb, iota[np.clip(y0, 0, H0 - 1), np.clip(y1, 0, W0 - 1)], -1
    )

    for plan in _candidate_plans(src_shape, M, c, out_shape):
        if plan is None:
            continue
        got = apply_plan(plan, iota, fill=-1)
        if got.shape == (I, J) and np.array_equal(got, want):
            return plan
    idx0 = np.clip(y0, 0, H0 - 1)
    idx1 = np.clip(y1, 0, W0 - 1)
    return GridPlan(
        ops=[("take", idx0, idx1, inb)], out_shape=(I, J), gathers=1
    )


def _flip_to_positive(M, c, out_shape):
    """Yield (M', c', post_ops) sign variants: negative stride
    directions are folded by re-indexing the OUTPUT (i -> I-1-i), which
    is a host-side relabeling realized by emitting nothing — instead we
    relabel the map: out_flipped[i] = out[I-1-i]. The caller composes
    plans for the flipped map and appends a flip at the very end."""
    I, J = out_shape
    variants = []
    for f0 in (1, -1):
        for f1 in (1, -1):
            Mv = M.copy()
            cv = c.copy()
            post = []
            if f0 == -1:
                # out'[i, j] = out[I-1-i, j]
                cv = cv + Mv[:, 0] * (I - 1)
                Mv = Mv.copy()
                Mv[:, 0] = -Mv[:, 0]
                post.append(("flipout", 0))
            if f1 == -1:
                cv = cv + Mv[:, 1] * (J - 1)
                Mv = Mv.copy()
                Mv[:, 1] = -Mv[:, 1]
                post.append(("flipout", 1))
            variants.append((Mv, cv, post))
    return variants


def _candidate_plans(src_shape, M, c, out_shape):
    for Mv, cv, post in _flip_to_positive(M, c, out_shape):
        plan = _plan_bruhat(src_shape, Mv, cv, out_shape)
        if plan is not None:
            # the variant planned out'[i] = out[I-1-i]: undo by flipping
            # the produced array back
            for p in post:
                plan.ops.append(("flip", p[1]))
            yield plan
    yield None


def _plan_bruhat(src_shape, M, c, out_shape):
    """M with non-negative stride structure -> at most
    stride([[1,0],[x,1]]) then transpose then stride(lower-tri)."""
    I, J = out_shape
    ops: List[Op] = []
    if M[0, 1] == 0:
        shape = _emit_stride(ops, src_shape, M, c, out_shape)
        if shape is None:
            return None
        return GridPlan(ops=ops, out_shape=out_shape, gathers=0)
    # need a swap: SRC[M z + c] = SRC[L1 @ (S @ (L2 z + t2)) + t1] with
    # L1 = [[1,0],[x,1]]: choose x s.t. (S-conjugated) remainder is
    # lower-triangular: L1^{-1} M = [[m00, m01], [m10 - x m00,
    # m11 - x m01]]; pick x with m11 - x*m01 == 0, then
    # S @ (L1^{-1} M) = [[m10', 0], [m00, m01]] = L2 (lower-tri).
    m00, m01 = int(M[0, 0]), int(M[0, 1])
    m10, m11 = int(M[1, 0]), int(M[1, 1])
    if m01 == 0 or m11 % m01 != 0:
        return None
    x = m11 // m01
    L2 = np.asarray([[m10 - x * m00, 0], [m00, m01]], np.int64)
    # offsets: SRC read = L1 @ y + t1 where y = S L2 z + S t2 ... fold
    # all offset into the FIRST op (t1 = c is wrong — the first op is
    # the innermost read): out[z] = src[L1 S L2 z + c] with c placed on
    # the L1 stride (t1 = c) and none on L2:
    #   step1 (cur1[y] = src[L1 y + c]) over y-domain = S L2 zdom
    #   step2 cur2 = transpose(cur1)  -> cur2[y'] = cur1[S y']
    #   step3 out[z] = cur2[L2 z]
    zc = np.stack(
        [
            np.asarray([a, b], np.int64)
            for a in (0, I - 1)
            for b in (0, J - 1)
        ]
    )
    ydom = zc @ L2.T  # then S applied
    ydom = ydom[:, ::-1]
    ylo = ydom.min(axis=0)
    yhi = ydom.max(axis=0)
    if (ylo < -(1 << 30)).any():
        return None
    Iy, Jy = int(yhi[0] - ylo[0]) + 1, int(yhi[1] - ylo[1]) + 1
    L1 = np.asarray([[1, 0], [x, 1]], np.int64)
    t1 = L1 @ ylo + c
    shape = _emit_stride(ops, src_shape, L1, t1, (Iy, Jy))
    if shape is None:
        return None
    ops.append(("transpose",))
    shape = (shape[1], shape[0])
    # step3: out[z] = cur2[L2 z - (S ylo)]
    t3 = -np.asarray([ylo[1], ylo[0]], np.int64)
    if int(L2[0, 0]) < 1 or int(L2[1, 1]) < 1:
        return None
    shape = _emit_stride(ops, shape, L2, t3, out_shape)
    if shape is None:
        return None
    return GridPlan(ops=ops, out_shape=out_shape, gathers=0)
