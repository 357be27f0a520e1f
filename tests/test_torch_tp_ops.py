"""The tp-sharded decode's step kernels and kernel C's lane window, on the
CPU (their plain versions; the card runs the kernels, test at the end).

Kernel 3T's and DT's plain versions are the per-step halves of the one-card
plain decodes: chained over a decode with the lanes split over simulated
ranks (kernel_check.tp_row_chain / tp_step_chain: every rank's launch, then
the counts or (value, need) pairs joined as the collective would), they
give decode_scan_wave_plain's and decode_steps_plain's symbols, states,
stream position and plane bit for bit, on valid and garbage streams. No
JAX: the one-card plain decodes are held to frave_tpu by
test_torch_rans.py and test_torch_modes.py.
"""

import numpy as np
import pytest
import torch

from frave_tpu_torch import kernel_check as KC
from frave_tpu_torch.ops import rans_torch as RT
from frave_tpu_torch.ops import tp_decode as TD

CPU = torch.device("cpu")

ROW_CASES = [
    ((12, 3, 64), "valid", 2),
    ((12, 3, 64), "valid", 4),
    ((12, 3, 64), "garbage", 2),
    ((9, 1, 128), "valid", 1),
    ((9, 1, 128), "garbage", 4),
    ((5, 3, 32), "valid", 8),
]
STEP_CASES = [
    ((40, 40, 1, "parallel"), "valid", 2),
    ((40, 40, 1, "parallel"), "garbage", 4),
    ((24, 24, 1, "parity"), "valid", 4),
    ((24, 40, 3, "parity"), "garbage", 2),
    ((16, 16, 3, "grid"), "valid", 2),
    ((16, 16, 1, "grid"), "valid", 1),
]


@pytest.mark.parametrize("shape,kind,ranks", ROW_CASES)
def test_row_halves_chained_equal_the_wave_decode(shape, kind, ranks):
    """3T's plain version chained over a wave, the lanes split over
    `ranks`, equals decode_scan_wave_plain (symbols on every lane, final
    states, stream position); the wrapper on CPU tensors is the plain
    version (its launch count stays 0)."""
    TD.tp_decode_row.launches = 0
    r = KC.tp_check("tp_decode_row", shape, kind, CPU, ranks=ranks, seed=5)
    assert r["max_abs_err"] == 0, r
    assert r["launches"] == shape[0] + 1
    assert TD.tp_decode_row.launches == 0


@pytest.mark.parametrize("shape,kind,ranks", STEP_CASES)
def test_step_halves_chained_equal_the_step_decode(shape, kind, ranks):
    """DT's plain version chained over a step-tensor decode, the lanes
    split over `ranks`, equals decode_steps_plain (plane, final states,
    stream position), every rank's replicated planes alike."""
    TD.tp_decode_step.launches = 0
    r = KC.tp_check("tp_decode_step", shape, kind, CPU, ranks=ranks, seed=6)
    assert r["max_abs_err"] == 0, r
    assert TD.tp_decode_step.launches == 0


def test_row_chain_ranks_words_across_ranks():
    """The renorm offsets really cross ranks: on a valid wave, decoding
    with the counts of the other ranks zeroed (as if no rank exchanged)
    leaves the ranks at different stream positions, so the [n, C] count
    gather carries the decode."""
    args = KC.tp_problem("tp_decode_row", np.random.default_rng(2), (12, 3, 64), "valid", CPU)

    def lonely(x, need, gptr, counts, rank, *rest, **kw):
        solo = torch.zeros_like(counts)
        solo[rank] = counts[rank]
        return TD.tp_decode_row_plain(x, need, gptr, solo, rank, *rest, **kw)

    with pytest.raises(AssertionError, match="disagree on the stream position"):
        KC.tp_row_chain(lonely, args, 2)


def test_decode_row_is_its_two_halves():
    """rans_torch.decode_row is row_symbols then row_renorm with the
    channel-major, lane-minor word ranks."""
    x0, g0, bkt, act, stream, tabs = KC.decode_problem(np.random.default_rng(4), 6, 3, 64, "valid")
    rt = RT._row_tables({k: v[None] for k, v in tabs.items()})
    x, g = x0[None].clone(), g0[None].clone()
    for t in range(bkt.shape[0]):
        s1, x1, g1 = RT.decode_row(x, g, bkt[t][None], act[t], stream[None], rt)
        sym, xn, need = RT.row_symbols(x, bkt[t][None], act[t], rt)
        pos = g[:, None] + torch.cumsum(need.reshape(1, -1).to(torch.int64), 1) - 1
        x2 = torch.where(act[t], RT.row_renorm(xn, need, pos.reshape(x.shape), stream[None]), x)
        assert torch.equal(s1, sym) and torch.equal(x1, x2)
        x, g = x1, g1


@pytest.mark.parametrize("shape,ranks", [((7, 3, 64), 2), ((7, 3, 64), 4), ((5, 1, 96), 3)])
def test_encode_window_is_a_slice_of_the_lanes(shape, ranks):
    """Kernel C's lane window (encode_scan(..., lane0, lanes); its plain
    version on the CPU) gives exactly the window's lanes of the whole
    grid's states, words and flags."""
    args, extra = KC.problem("encode_scan", np.random.default_rng(9), shape)
    full = RT.encode_scan(*args, *extra)
    L = shape[2] // ranks
    for s in range(ranks):
        win = RT.encode_scan(*args, *extra, lane0=s * L, lanes=L)
        sl = slice(s * L, (s + 1) * L)
        for a, b in zip(win, full):
            assert torch.equal(a, b[..., sl])


def test_wrappers_refuse_bad_operands():
    x0, g0, bkt, act, stream, tabs = KC.decode_problem(np.random.default_rng(1), 3, 3, 32, "valid")
    x = x0[:, :16].clone()
    need = torch.zeros((3, 16), dtype=torch.bool)
    gptr = torch.zeros(1, dtype=torch.int64)
    counts = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        TD.tp_decode_row(x, need, gptr, counts, 2, bkt[0, :, :16].contiguous(),
                         act[0, :16].contiguous(), stream, tabs)
    with pytest.raises(TypeError):
        TD.tp_decode_row(x, need.to(torch.uint8), gptr, counts, 0, bkt[0, :, :16].contiguous(),
                         act[0, :16].contiguous(), stream, tabs)
    with pytest.raises(ValueError):
        RT.encode_scan(*KC.problem("encode_scan", np.random.default_rng(0), (3, 1, 32))[0], 32,
                       lane0=16, lanes=32)


@pytest.mark.parametrize("seed,C", [(3, 3), (8, 1)])
def test_table_image_is_the_shared_memory_layout(seed, C):
    """table_image holds, entry for entry, what load_tables
    (csrc/rans_common.cuh) writes into shared memory for each channel:
    the bits clamped to 14 as u32, then each context's staircase clamped
    to 2^14 as u16 at cdf_slot(e) = (e / 32) * 34 + e % 32 of a row
    32 * 34 + 2 slots long, each part 16-byte aligned; the padding 0."""
    rng = np.random.default_rng(seed)
    CA = 15
    cdf = torch.as_tensor(rng.integers(-5, (1 << 14) + 50, (C, CA, 1024)), dtype=torch.int32)
    bits = torch.as_tensor(rng.integers(-2, 17, (C, CA)), dtype=torch.int32)
    img = TD.table_image({"cdf": cdf, "bits": bits})
    head = (CA * 4 + 15) // 16 * 16
    size = head + (CA * 1090 * 2 + 15) // 16 * 16
    assert img.dtype == torch.uint8 and tuple(img.shape) == (C, size) == (C, TD.image_bytes(CA))
    for c in range(C):
        raw = img[c].numpy().tobytes()
        want_bits = np.zeros(head // 4, np.uint32)
        for k in range(CA):
            want_bits[k] = min(max(int(bits[c, k]), 0), 14)
        assert np.frombuffer(raw[:head], np.uint32).tolist() == want_bits.tolist()
        want = np.zeros((size - head) // 2, np.uint16)
        cc = cdf[c].tolist()
        for k in range(CA):
            for e in range(1024):
                want[k * 1090 + (e // 32) * 34 + e % 32] = min(max(cc[k][e], 0), 1 << 14)
        assert np.array_equal(np.frombuffer(raw[head:], np.uint16), want)


# the smoke's shapes: (kind, channels, a rank's lanes at 2 ranks) -> the plan
PLANS = [
    (("row", 3, 8192), TD.TPPlan("cluster", 8, 1)),  # 2048x2048 RGB's largest wave
    (("row", 3, 1024), TD.TPPlan("block", 1, 1)),  # 768x512 RGB
    (("row", 1, 256), TD.TPPlan("block", 1, 1)),  # 256x256 gray
    (("step", 3, 8192), TD.TPPlan("cluster", 16, 2, False)),  # e1 2048x2048 RGB parallel
    (("step", 3, 1024), TD.TPPlan("cluster", 8, 1)),  # e2 768x512 RGB parity
    (("step", 1, 256), TD.TPPlan("block", 1, 1)),  # e3 256x256 gray parity
    (("step", 3, 16384), TD.TPPlan("cluster", 16, 4, False)),  # e1 on one rank
    (("row", 1, 1025), TD.TPPlan("cluster", 2, 1)),
]


@pytest.mark.parametrize("shape,want", PLANS)
def test_launch_rule_at_the_smoke_shapes(shape, want):
    """The launch rule: one block up to 1024 pairs (3T: a channel's lanes),
    else the smallest power-of-two cluster with at most 1024 (3T) or 512
    (DT) a block (up to 16), the fewest pairs a thread (1, 2 or 4) that
    cover a block's; the tables by TMA in a cluster of at most 8 blocks,
    by the threads in one of 16 (e1's)."""
    assert TD.plan_rule(*shape) == want


def test_launch_rule_switches_and_refusals():
    """Forced sizes and switches; what no variant can run raises."""
    assert TD.plan_rule("step", 3, 1024, flags=TD.FORCE_BLOCK) == TD.TPPlan("block", 1, 4)
    assert TD.plan_rule("row", 3, 8192, cluster=8) == TD.TPPlan("cluster", 8, 1)
    assert TD.plan_rule("step", 3, 8192, flags=TD.TMA) == TD.TPPlan("cluster", 16, 2, True)
    assert TD.plan_rule("step", 3, 1024, flags=TD.NO_TMA) == TD.TPPlan("cluster", 8, 1, False)
    assert TD.plan_rule("step", 3, 1024, cluster=16) == TD.TPPlan("cluster", 16, 1, False)
    assert TD.plan_rule("row", 3, 8192, cluster=16) == TD.TPPlan("cluster", 16, 1, False)
    assert TD.plan_rule("step", 3, 8192, cluster=8) == TD.TPPlan("cluster", 8, 4, True)
    assert TD.plan_rule("row", 3, 1024, flags=TD.FORCE_BLOCK | TD.NO_TMA) == TD.TPPlan(
        "block", 1, 1, False)
    for args, kw in ((("step", 3, 8192), {"flags": TD.FORCE_BLOCK}),
                     (("step", 3, 8192), {"cluster": 2}),
                     (("row", 3, 8192), {"cluster": 3}),
                     (("step", 5, 64), {}),
                     (("row", 3, 64), {"flags": TD.TMA | TD.NO_TMA}),
                     (("row", 1, 16 * 4096 + 1), {})):
        with pytest.raises(ValueError):
            TD.plan_rule(*args, **kw)


def test_wrappers_refuse_designs_on_the_cpu():
    """cluster and flags choose a kernel's design; the CPU runs the plain
    version and has none."""
    x0, g0, bkt, act, stream, tabs = KC.decode_problem(np.random.default_rng(1), 3, 3, 32, "valid")
    need = torch.zeros((3, 32), dtype=torch.bool)
    counts = torch.zeros((1, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="design"):
        TD.tp_decode_row(x0.clone(), need, g0.reshape(1), counts, 0, bkt[0], act[0], stream,
                         tabs, flags=TD.NO_TMA)


# every design on the card: the rule, one block, each cluster size, the
# tables by threads and by TMA, one block with the tables by threads (a
# design the plan refuses at a shape is skipped there, at least one runs)
CARD_DESIGNS = tuple(KC.TP_DESIGNS)


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,kind,ranks", [
    ("tp_decode_row", (30, 3, 16384), "valid", 2),
    ("tp_decode_row", (30, 3, 16384), "garbage", 2),
    ("tp_decode_row", (12, 1, 512), "valid", 4),
    ("tp_decode_step", (64, 64, 3, "parallel"), "valid", 2),
    ("tp_decode_step", (256, 256, 1, "parity"), "garbage", 4),
    ("tp_decode_step", (512, 512, 3, "parallel"), "valid", 2),
    ("tp_decode_step", (512, 512, 3, "parallel"), "garbage", 1),
])
def test_tp_kernels_on_the_card(name, shape, kind, ranks):
    """Kernels 3T and DT chained over a decode on the card at every design,
    bit-equal to their plain versions chained the same way and to the
    one-card plain decode; the 512x512 RGB parallel program's steps take a
    cluster under the rule."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    r = KC.tp_check(name, shape, kind, torch.device("cuda", 0), ranks=ranks,
                    designs=CARD_DESIGNS)
    assert r["errs"] and r["max_abs_err"] == 0, r
    assert "rule" in r["errs"] and "tables by threads" in r["errs"], r["plans"]
    if shape == (512, 512, 3, "parallel"):
        assert r["plans"]["rule"].variant == "cluster", r["plans"]
