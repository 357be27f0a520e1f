"""The step-tensor rANS decode: the port of the lax.scan body of
frave_tpu/codec/pipeline_jax.py decode_fused (with ops/rans_jax.py
decode_step_merged).

The parallel and parity modes, and grid-mode shapes too small for a dense
lattice, decode over static step tensors (fractal/schedule.py LaneSteps):
step s decodes one symbol on each of its active lanes, for every image and
channel of a batch. Each step can read what earlier steps wrote, so the
steps run in order:

  * decode_steps — kernel D (csrc/rans_step_decode.cu
    frave_rans_decode_steps): every step of the batch in one launch, one
    thread-block cluster an image; decode_steps_plan says the cluster
    size its launch rule picks;
  * decode_steps_plain — its plain version, a torch loop over the steps:
    the 6-tap gather from the plane, torch_ops.contexts, the fixed-bucket
    override, rans_torch.decode_row and the store of the active lanes'
    values. decode_steps runs it on CPU tensors.

Both take a same-shape batch on a leading axis (one image may come without
it); the step tensors and the bucket edges are shared by the batch.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from . import rans_torch as RT
from . import torch_ops as T

_I32 = torch.int32
_I64 = torch.int64
# the step tensors of a decode, by name: dtype and trailing shape after [S, NL]
STEP_FIELDS = {
    "coef": (torch.int32, ()),  # flat coefficient slot, -1: inactive lane
    "nbr": (torch.int32, (6,)),  # tap slots, -1: absent (reads 0)
    "lf": (torch.uint8, ()),  # 1: LF (MED) context, 0: HF
    "group": (torch.int8, ()),  # predictor row
    "fbkt": (torch.int8, ()),  # fixed bucket, -1: computed
}


def step_tensors(steps, device) -> dict:
    """The step tensors of a LaneSteps on `device`, as decode_steps reads
    them ({name: tensor} of STEP_FIELDS)."""
    host = {
        "coef": steps.step_coef, "nbr": steps.step_nbr, "lf": steps.step_lf,
        "group": steps.step_group, "fbkt": steps.step_fbkt,
    }
    return {
        k: torch.as_tensor(np.ascontiguousarray(host[k]), device=device).to(dt).contiguous()
        for k, (dt, _) in STEP_FIELDS.items()
    }


def decode_steps_plain(x, gptr, steps, vparams, wparams, stream, tabs, n_slots: int):
    """decode_steps as a torch loop over the steps (see there). Returns
    (plane [B, C, n_slots] int32, x', gptr')."""
    if gptr.dim() == 0:
        plane, x, gptr = decode_steps_plain(
            x[None], gptr[None], steps, vparams[None], wparams[None], stream[None],
            {k: v[None] for k, v in tabs.items()}, n_slots,
        )
        return plane[0], x[0], gptr[0]
    B, C, NL = x.shape
    dev = x.device
    rtabs = RT._row_tables(tabs)
    coef = steps["coef"].to(_I64)
    nbr = steps["nbr"].to(_I64)
    lf = steps["lf"].to(torch.bool)
    grp = steps["group"].to(_I64)
    fbkt = steps["fbkt"].to(_I64)
    # one slot past the plane takes the inactive lanes' stores
    plane = torch.zeros((B, C, n_slots + 1), dtype=_I32, device=dev)
    for s in range(coef.shape[0]):
        nb = nbr[s]  # [NL, 6]
        vals = plane[:, :, nb.clamp(min=0)]  # [B, C, NL, 6]
        vals = torch.where(nb >= 0, vals, torch.zeros((), dtype=_I32, device=dev))
        bk, pred = T.contexts(vals, lf[s], grp[s], vparams, wparams)
        bk = torch.where(fbkt[s] >= 0, fbkt[s].to(bk.dtype), bk)
        act = coef[s] >= 0
        sym, x, gptr = RT.decode_row(x, gptr, bk, act, stream, rtabs)
        vals_out = (T.unpack_signed(sym) + pred).to(_I32)
        dst = torch.where(act, coef[s], n_slots).expand(B, C, NL)
        plane.scatter_(2, dst, vals_out)
    return plane[..., :n_slots].contiguous(), x, gptr


def decode_steps_plan(channels: int, lanes: int, contexts: int, fine: int, cluster: int = 0):
    """Kernel D's launch plan on the current CUDA device for one image of
    channels x lanes (every image of a batch runs one such cluster): (the
    cluster size it runs, the lanes a thread). `cluster` 0 takes the launch
    rule (csrc/rans_step_decode.cu); a power of two up to 16 forces that
    size, for the kernel checks, and raises where it cannot be resident.
    Raises where C * NL exceeds 16 * 8192 lanes."""
    lib = _build.load_library()
    size, per = ctypes.c_int(0), ctypes.c_int(0)
    code = lib.frave_rans_decode_steps_plan(
        channels, lanes, contexts, fine, cluster, ctypes.byref(size), ctypes.byref(per)
    )
    _build.check(code, "frave_rans_decode_steps_plan")
    return size.value, per.value


def decode_steps(x, gptr, steps, vparams, wparams, stream, tabs, n_slots: int,
                 cluster: int = 0):
    """Every step of a decode of a same-shape batch (replaces the
    decode_fused scan of pipeline_jax): kernel D on the card, one launch
    of B thread-block clusters, one an image; decode_steps_plain on the
    CPU.

    x [B, C, NL] int64 lane states (u32 values); gptr [B] int64 stream
    positions; steps {name: [S, NL(, 6)]} of STEP_FIELDS (step_tensors;
    shared by the batch); vparams / wparams [B, C, F, 6] f32 predictor
    rows; stream [B, W] int32 u16 words, zero-padded by C * NL; tabs from
    rans_torch.decode_tables ([B, C, ...]); n_slots the plane's width. Per
    image, step and (channel, lane): the 6 taps from the image's plane
    (tap -1 reads 0), torch_ops.contexts on them with the lane's LF flag
    and predictor row, fbkt >= 0 replacing the bucket, then
    decode_scan_wave's symbol and renorm (words ranked channel-major,
    lane-minor within the image, the stream index clamped to [0, W - 1]);
    lanes with coef >= 0 advance their state and store
    unpack_signed(sym) + prediction at plane[b, c, coef]. One image may
    come without its batch axis. `cluster` forces kernel D's cluster size
    (decode_steps_plan; 0, the launch rule, everywhere but the checks).
    Returns (plane [B, C, n_slots] int32, zero where no step stored, x',
    gptr')."""
    if gptr.dim() == 0:
        plane, x, gptr = decode_steps(
            x[None], gptr[None], steps, vparams[None], wparams[None], stream[None],
            {k: v[None] for k, v in tabs.items()}, n_slots, cluster,
        )
        return plane[0], x[0], gptr[0]
    if x.dim() != 3:
        raise ValueError(f"x must be [B, C, NL], got {tuple(x.shape)}")
    B, C, NL = x.shape
    S = steps["coef"].shape[0]
    ca = tabs["bits"].shape[-1]
    F = vparams.shape[-2]
    check = RT._check_grid
    for k, (dt, tail) in STEP_FIELDS.items():
        check(k, steps[k], (S, NL) + tail, (dt,))
    check("x", x, (B, C, NL), (_I64,))
    check("gptr", gptr, (B,), (_I64,))
    check("vparams", vparams, (B, C, F, 6), (torch.float32,))
    check("wparams", wparams, (B, C, F, 6), (torch.float32,))
    if stream.dim() != 2 or stream.shape[0] != B or not 1 <= stream.shape[1] < 1 << 31:
        raise ValueError(
            f"stream must be [{B}, W] with 1 to 2^31 - 1 words, got {tuple(stream.shape)}"
        )
    check("stream", stream, tuple(stream.shape), (_I32,))
    check("cdf", tabs["cdf"], (B, C, ca, RT.ALPHABET_SIZE), (_I32,))
    check("bits", tabs["bits"], (B, C, ca), (_I32,))
    if not 1 <= n_slots < 1 << 31:
        raise ValueError(f"n_slots must be in [1, 2^31), got {n_slots}")
    if not 1 <= B <= 65535:
        raise ValueError(f"a batch holds 1 to 65535 images, got {B}")
    dev = x.device
    if dev.type == "cpu":
        return decode_steps_plain(x, gptr, steps, vparams, wparams, stream, tabs, n_slots)
    if dev.type != "cuda":
        raise RuntimeError(f"no kernel for device {dev}")
    ops = (gptr, vparams, wparams, stream, tabs["cdf"], tabs["bits"], *steps.values())
    if any(t.device != dev for t in ops):
        raise ValueError(f"all operands must lie on {dev}")
    lib = _build.load_library()
    size, _ = decode_steps_plan(C, NL, ca, F, cluster)
    edges = T._bucket_edges(dev)
    if edges.shape[0] != ca - 1:
        raise ValueError(f"{ca} contexts need {ca - 1} bucket edges, not {edges.shape[0]}")
    plane = torch.zeros((B, C, n_slots), dtype=_I32, device=dev)
    x_out = torch.empty_like(x)
    g_out = torch.empty_like(gptr)
    code = lib.frave_rans_decode_steps(
        x.data_ptr(), gptr.data_ptr(), steps["coef"].data_ptr(), steps["nbr"].data_ptr(),
        steps["lf"].data_ptr(), steps["group"].data_ptr(), steps["fbkt"].data_ptr(),
        vparams.data_ptr(), wparams.data_ptr(), edges.data_ptr(), stream.data_ptr(),
        tabs["cdf"].data_ptr(), tabs["bits"].data_ptr(), plane.data_ptr(), x_out.data_ptr(),
        g_out.data_ptr(), S, C, NL, ca, F, n_slots, stream.shape[1], B, size,
        _build.current_stream(dev),
    )
    _build.check(code, "frave_rans_decode_steps")
    decode_steps.launches += 1
    return plane, x_out, g_out


decode_steps.launches = 0
