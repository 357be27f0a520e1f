"""The predictor fits' plain twin (ops/fit_stats.py) on the CPU: the two
passes' per-chunk integer sums against fit_predictors' float64 normal
equations, the chunk table, and the fixed-order width sums of an image
alone and in a batch. The kernels themselves run on the card
(tests/test_torch_cuda.py); on CPU tensors fit_stats is fit_predictors."""

import numpy as np
import pytest
import torch

from frave_tpu_torch import kernel_check
from frave_tpu_torch.ops import fit_stats as FS

CPU = torch.device("cpu")
# (h, w, c) of the programs: one RGB, one gray
SHAPES = [(96, 80, 3), (64, 64, 1)]


def _rows(shape, plane, images, seed=0):
    prog = kernel_check.program(*shape, CPU)
    rows = kernel_check.fit_plane(np.random.default_rng(seed), prog, plane, images)
    return prog, rows, prog.fit_table(prog.grid_enc is not None)


def _f64(ts):
    return tuple(t.to(torch.float64) for t in ts)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("plane", ["stripes", "noise", "valid"])
def test_plain_sums_equal_the_float64_normal_equations(shape, plane):
    """The value pass's sums, added up a group, equal value_equations'
    float64 Gram and b exactly, and the width pass's Gram equals
    width_equations' exactly (its float64 b, summed in another order, to
    1e-12), on 0/255 stripes (the largest Grams), noise and a natural
    image; the taps' magnitudes stay within 511."""
    _, rows, table = _rows(shape, plane, 2)
    assert int(rows.abs().max()) <= 511
    Xs, ys = (_f64(ts) for ts in FS._gather(rows, table))
    G, b = FS.group_sums(FS.chunk_sums_plain(rows, table), table)
    Gr, br = FS.value_equations(Xs, ys)
    assert torch.equal(G, Gr) and torch.equal(b, br)
    vp, _ = FS.fit_predictors(Xs, ys, None)
    G, b = FS.group_sums(FS.chunk_sums_plain(rows, table, vp), table, width=True)
    Gr, br = FS.width_equations(Xs, ys, vp)
    assert torch.equal(G, Gr)
    torch.testing.assert_close(b, br, rtol=1e-12, atol=0)


def test_stripes_reach_the_largest_taps():
    """0/255 stripes give taps of magnitude 255 and Gram entries past
    2^27, beyond float32's exact integers: the exactness the int64 sums
    keep."""
    _, rows, table = _rows((96, 80, 3), "stripes", 1)
    part = FS.chunk_sums_plain(rows, table)
    assert int(rows[:, table.taps].abs().max()) == 255
    assert int(FS.group_sums(part, table)[0].max()) > 1 << 27


def test_chunked_width_sums_alone_and_in_a_batch():
    """Each image's per-chunk sums of both passes, its chunk-ordered width
    b and its wire parameters are the same alone as in a batch of 3."""
    _, rows, table = _rows((96, 80, 3), "valid", 3, seed=4)
    vp, wp = FS.fit_stats(rows, table)
    vpart = FS.chunk_sums_plain(rows, table)
    wpart = FS.chunk_sums_plain(rows, table, vp)
    wb = FS.group_sums(wpart, table, width=True)[1]
    for i in range(3):
        one = slice(3 * i, 3 * i + 3)
        v1, w1 = FS.fit_stats(rows[one], table)
        assert torch.equal(v1.view(torch.int32), vp[one].view(torch.int32))
        assert torch.equal(w1.view(torch.int32), wp[one].view(torch.int32))
        assert torch.equal(FS.chunk_sums_plain(rows[one], table), vpart[one])
        p1 = FS.chunk_sums_plain(rows[one], table, v1)
        assert torch.equal(p1, wpart[one])
        assert torch.equal(FS.group_sums(p1, table, width=True)[1].view(torch.int64),
                           wb[one].view(torch.int64))


@pytest.mark.parametrize("sizes", [(0, 79, 1024, 1025, 123423), (81, 79, 160, 32896), (5,)])
def test_chunk_table_cuts_each_group_by_its_size_alone(sizes):
    """A group of k samples has min(32, ceil(k / 1024)) chunks, covering it
    in order without gaps, each at most ceil(k / chunks) long; the chunks
    of a group do not depend on the other groups."""
    start, group, off = FS.chunk_table(sizes)
    base = np.concatenate([[0], np.cumsum(sizes)])
    assert start[-1] == base[-1] and off[-1] == group.shape[0] == start.shape[0] - 1
    for g, k in enumerate(sizes):
        m = min(FS.MAX_CHUNKS, -(-k // FS.MIN_CHUNK))
        assert off[g + 1] - off[g] == m and (group[off[g]:off[g + 1]] == g).all()
        cuts = start[off[g]:off[g + 1] + 1] if m else np.array([base[g]])
        assert cuts[0] == base[g] and (m == 0 or start[off[g + 1]] == base[g + 1])
        lens = np.diff(cuts)
        assert (lens > 0).all() and (lens <= -(-k // max(m, 1))).all()
        own = FS.chunk_table((k,))
        np.testing.assert_array_equal(own[0][:-1] + base[g], start[off[g]:off[g + 1]])


@pytest.mark.parametrize("ovr", kernel_check.FIT_OVERRIDES)
def test_cpu_fit_stats_is_fit_predictors(ovr):
    """On CPU tensors fit_stats is its plain version, fit_predictors on the
    table's gathered taps, bit for bit, unpinned and pinned."""
    args, _ = kernel_check.problem("fit_stats", np.random.default_rng(2), (96, 80, 3),
                                   ("noise", ovr), CPU, images=2)
    rows, table, overrides = args
    got = FS.fit_stats(rows, table, overrides)
    want = FS.fit_predictors(*FS._gather(rows, table), overrides)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("shape", SHAPES)
def test_fit_table_holds_the_programs_fit_samples(shape):
    """A program's FitTable of each sample set holds its fit_samples' taps
    and targets, group by group in order, as int32 [7, n]."""
    prog = kernel_check.program(*shape, CPU)
    for strided, (taps, target, ks) in prog.fit_samples.items():
        table = prog.fit_table(strided)
        assert table.sizes == tuple(k.shape[0] for k in ks)
        assert table.samples.dtype == torch.int32 and table.samples.shape == (7, taps.shape[0])
        assert torch.equal(table.samples[:6].T.to(torch.int64), taps)
        assert torch.equal(table.samples[6].to(torch.int64), target)
        assert table.max_slot == int(table.samples.max()) <= prog.n_slots
