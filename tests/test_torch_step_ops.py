"""Kernel D's operands and plain version (frave_tpu_torch/ops/step_decode.py)
on the CPU, on every program the step-tensor modes decode in
tests/test_torch_modes.py (parallel and parity at 64x64 gray and 96x80 RGB,
grid mode's 16x16 and 1x1, gray and RGB):

  * the step map and the schedule-order records rebuild the program's
    LaneSteps (schedule index, slot, LF flag, group and fixed bucket of
    every lane of every step; each tap's writer is the slot LaneSteps
    names);
  * the taps, remapped to schedule indices, read from a plane in schedule
    order the values the slot taps read from the coefficient plane;
  * the rank order of the words, wrapped bands included, is
    build_stream_perm's;
  * the host's step-order check refuses a tap at or past its step's first
    schedule index;
  * decode_steps_plain over the new operands is bit-equal to PR 7's plain
    version over the padded [S, NL] step tensors (kept here as
    _padded_plain), on the wire of the port's own containers and on
    garbage, one image and a batch of three. (tests/test_torch_modes.py
    holds it to the jax scan of decode_fused's body.)
"""

import numpy as np
import pytest
import torch

from frave_tpu_torch import kernel_check
from frave_tpu_torch.codec import pipeline_torch as PT
from frave_tpu_torch.codec.options import EncoderOptions
from frave_tpu_torch.fractal import schedule as ST
from frave_tpu_torch.images import RasterImage
from frave_tpu_torch.ops import rans_torch as RT
from frave_tpu_torch.ops import step_decode as SD
from frave_tpu_torch.ops import torch_ops as T
from frave_tpu_torch.testing import natural_image

# (h, w, c, mode): the programs kernel D decodes in test_torch_modes.py
PROGRAMS = [
    (64, 64, 1, "parallel"), (64, 64, 1, "parity"), (96, 80, 3, "parallel"),
    (96, 80, 3, "parity"), (16, 16, 1, "grid"), (16, 16, 3, "grid"), (1, 1, 1, "grid"),
    (1, 1, 3, "grid"),
]


def _program(h, w, c, mode):
    nl = ST.default_num_lanes(ST.get_schedule(h, w, mode=mode).num_symbols)
    prog = PT.get_program(h, w, nl, c, "cpu", mode)
    return prog, ST.get_lane_steps(h, w, nl, mode=mode)


def _padded_tensors(lane_steps) -> dict:
    """PR 7's step tensors: coef, nbr, lf, group and fbkt [S, NL(, 6)]."""
    return {"coef": torch.from_numpy(lane_steps.step_coef.astype(np.int64)),
            "nbr": torch.from_numpy(lane_steps.step_nbr.astype(np.int64)),
            "lf": torch.from_numpy(lane_steps.step_lf.astype(bool)),
            "group": torch.from_numpy(lane_steps.step_group.astype(np.int64)),
            "fbkt": torch.from_numpy(lane_steps.step_fbkt.astype(np.int64))}


def _padded_plain(x, gptr, steps, vparams, wparams, stream, tabs, n_slots: int):
    """PR 7's decode_steps_plain over the padded step tensors [S, NL]:
    every lane of every step, the taps as slots of the coefficient plane."""
    B, C, NL = x.shape
    dev = x.device
    rtabs = RT._row_tables(tabs)
    coef, nbr, lf, grp, fbkt = (steps[k] for k in ("coef", "nbr", "lf", "group", "fbkt"))
    # one slot past the plane takes the inactive lanes' stores
    plane = torch.zeros((B, C, n_slots + 1), dtype=torch.int32, device=dev)
    for s in range(coef.shape[0]):
        nb = nbr[s]  # [NL, 6]
        vals = plane[:, :, nb.clamp(min=0)]  # [B, C, NL, 6]
        vals = torch.where(nb >= 0, vals, torch.zeros((), dtype=torch.int32, device=dev))
        bk, pred = T.contexts(vals, lf[s], grp[s], vparams, wparams)
        bk = torch.where(fbkt[s] >= 0, fbkt[s].to(bk.dtype), bk)
        act = coef[s] >= 0
        sym, x, gptr = RT.decode_row(x, gptr, bk, act, stream, rtabs)
        vals_out = (T.unpack_signed(sym) + pred).to(torch.int32)
        dst = torch.where(act, coef[s], n_slots).expand(B, C, NL)
        plane.scatter_(2, dst, vals_out)
    return plane[..., :n_slots].contiguous(), x, gptr


@pytest.mark.parametrize("h,w,c,mode", PROGRAMS)
def test_step_map_and_records_match_lane_steps(h, w, c, mode):
    """lane_grid(step map, records) is the program's LaneSteps: the
    schedule index, slot, LF flag, group and fixed bucket of every lane of
    every step (inactive lanes as LaneSteps has them); a tap's writer is
    the slot LaneSteps names, and a tap -1 names no written slot."""
    prog, ls = _program(h, w, c, mode)
    ops = prog.steps
    k, grid = SD.lane_grid(ops)
    np.testing.assert_array_equal(k.numpy(), ls.step_slot)
    np.testing.assert_array_equal(grid[..., 0].numpy(), ls.step_coef)
    lf, grp, fbkt = SD.unpack_meta(grid[..., SD.REC_WORDS - 1])
    np.testing.assert_array_equal(lf.numpy(), ls.step_lf)
    np.testing.assert_array_equal(grp.numpy(), ls.step_group)
    np.testing.assert_array_equal(fbkt.numpy(), ls.step_fbkt)
    n = prog.n_slots
    written = np.zeros(n + 1, bool)
    written[ls.step_coef[ls.step_coef >= 0]] = True
    nbr = ls.step_nbr.astype(np.int64)
    named = np.where((nbr >= 0) & (nbr < n), nbr, n)
    named = np.where(written[named], named, -1)  # slots that some step writes
    taps = grid[..., 1:1 + SD.TAPS].numpy()
    coef = ops.rec[:, 0].numpy()
    np.testing.assert_array_equal(np.where(taps >= 0, coef[np.clip(taps, 0, None)], -1), named)
    assert ops.max_len == int((ls.step_slot >= 0).sum(1).max())
    assert ops.num_symbols == ops.rec.shape[0] == int((ls.step_slot >= 0).sum())


@pytest.mark.parametrize("h,w,c,mode", PROGRAMS)
def test_remapped_taps_read_same_values(h, w, c, mode):
    """On a seeded plane (zero where no step stores, as the decode's plane
    starts), each lane's six taps read through the records from the plane
    in schedule order equal its slot taps read from the coefficient plane
    (-1 and slots past the plane read 0)."""
    prog, ls = _program(h, w, c, mode)
    ops = prog.steps
    n = prog.n_slots
    rng = np.random.default_rng(h * w + c)
    coef = ops.rec[:, 0].numpy().astype(np.int64)
    plane = np.zeros((c, n + 1), np.int64)
    plane[:, coef] = rng.integers(-300, 300, size=(c, coef.shape[0]))
    splane = np.concatenate([plane[:, coef], np.zeros((c, 1), np.int64)], axis=1)
    k, grid = SD.lane_grid(ops)
    taps = grid[..., 1:1 + SD.TAPS].numpy()
    new = splane[:, np.where(taps >= 0, taps, coef.shape[0])]
    nbr = ls.step_nbr.astype(np.int64)
    old = plane[:, np.where((nbr >= 0) & (nbr < n), nbr, n)]
    act = (k.numpy() >= 0)[None, :, :, None]
    np.testing.assert_array_equal(np.where(act, new, 0), np.where(act, old, 0))


def _rank_order_perm(ops, channels: int, rows_are_steps: bool) -> np.ndarray:
    """The emission-grid slot of each word rank from the step map alone:
    per step, channel-major, the band's lanes ascending (a wrapped band's
    tail [0, wrapped) first)."""
    nl = ops.lanes
    out = []
    for s, (k0, lane0, length, wrapped) in enumerate(ops.step_map.tolist()):
        j = np.arange(length)
        o = np.where(j < wrapped, length - wrapped + j, j - wrapped)
        ks = k0 + o
        lanes = (lane0 + o) % nl
        assert np.all(np.diff(lanes) > 0)  # ascending lanes
        r = np.full(length, s) if rows_are_steps else ks // nl
        for ch in range(channels):
            out.append((r * channels + ch) * nl + lanes)
    return np.concatenate(out) if out else np.zeros(0, np.int64)


@pytest.mark.parametrize("h,w,c,mode", PROGRAMS)
def test_wrapped_band_rank_order_matches_stream_perm(h, w, c, mode):
    """The words' rank order the kernel derives from the step map (o = j +
    len - wrapped mod len for the j-th pair of a channel) is
    build_stream_perm's decode order, wrapped bands included."""
    prog, ls = _program(h, w, c, mode)
    perm = ST.build_stream_perm(ls, c)
    np.testing.assert_array_equal(_rank_order_perm(prog.steps, c, ls.rows_are_steps), perm)


def test_some_band_wraps():
    """The programs above include wrapped bands (the step-tensor modes cut
    waves at k mod NL), so the rank-order test covers them; grid mode's
    rows start at lane 0 and never wrap."""
    wraps = {}
    for h, w, c, mode in PROGRAMS:
        prog, _ = _program(h, w, c, mode)
        wraps[(h, w, mode)] = int((prog.steps.step_map[:, 3] > 0).sum())
    assert wraps[(64, 64, "parity")] > 0 and wraps[(96, 80, "parallel")] > 0, wraps
    assert all(v == 0 for (h, w, mode), v in wraps.items() if mode == "grid"), wraps


def test_step_order_check_refuses_forged_taps():
    """check_step_order passes every program's operands and refuses a
    record whose tap reads its own step's first schedule index, or a later
    one, though the slot taps (LaneSteps) are left as they were."""
    for mode in ("parallel", "parity"):
        sched = ST.get_schedule(64, 64, mode=mode)
        ls = ST.get_lane_steps(64, 64, 32, mode=mode)
        n = PT.get_geometry(64, 64).num_coef_slots
        step_map, rec = SD.step_operands_host(sched, ls, n)
        PT.check_step_order(ls, n, step_map, rec)
        s = int(np.nonzero(step_map[:, 2] > 1)[0][-1])
        k0, length = int(step_map[s, 0]), int(step_map[s, 2])
        for k_bad in (k0, k0 + length - 1, rec.shape[0] - 1):
            bad = rec.copy()
            bad[k0 + 1, 1] = k_bad
            with pytest.raises(AssertionError):
                PT.check_step_order(ls, n, step_map, bad)
        bad = rec.copy()
        bad[k0, 3] = k0 - 1  # the previous step's last symbol: allowed
        PT.check_step_order(ls, n, step_map, bad)


@pytest.mark.parametrize("kind", ["valid", "garbage"])
@pytest.mark.parametrize("images", [0, 3])
@pytest.mark.parametrize("h,w,c,mode", PROGRAMS)
def test_plain_matches_padded_plain(h, w, c, mode, images, kind):
    """decode_steps_plain (the step map and records, taps from the plane
    in schedule order) against PR 7's plain version over the padded
    [S, NL] step tensors: plane, final lane states and stream position
    bit-equal, on the port's containers of seeded images (one, or three in
    one batch) and on garbage states and words; decode_steps on CPU
    tensors is the plain version."""
    rng = np.random.default_rng(h + w + c + images)
    nl = ST.default_num_lanes(ST.get_schedule(h, w, mode=mode).num_symbols)
    imgs = [RasterImage.from_array(natural_image(h, w, c, 500 + i))
            for i in range(max(images, 1))]
    cis = PT.encode_pipeline_torch_batch(imgs, EncoderOptions(mode=mode, num_lanes=nl), "cpu")
    ops = kernel_check.step_operands(cis, torch.device("cpu"), kind, rng, images=len(cis))
    x, gptr, steps, vparams, wparams, stream, tabs, n_slots = ops
    padded = _padded_tensors(ST.get_lane_steps(h, w, nl, mode=mode))
    want = _padded_plain(x, gptr, padded, vparams, wparams, stream, tabs, n_slots)
    got = SD.decode_steps_plain(*ops)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    if kind == "valid":
        assert (got[1] == RT.RANS_L).all()
    if not images:  # one image without its batch axis, through the wrapper
        one = SD.decode_steps(x[0], gptr[0], steps, vparams[0], wparams[0], stream[0],
                              {k: v[0] for k, v in tabs.items()}, n_slots)
        for a, b in zip(one, want):
            np.testing.assert_array_equal(a.numpy(), b[0].numpy())
