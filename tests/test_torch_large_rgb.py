"""The port at 1024x768 RGB, the smallest shape that takes the strided
branches of 2048x2048 RGB, and its per-pixel host copies, on the CPU.

  * at 1024x768 the transform proxy samples every second pixel, and two
    predictor groups pass the fit cap (at strides 4 and 2), as five do at
    2048x2048;
  * there the port's encode decodes to exactly the input through the port
    and through the benchmark's plain reference decoder, with the
    transform id that the exact proxy chooses;
  * at 64x64 RGB the copy spans sit inside their parents
    (frave.encode.stack in frave.encode.upload, frave.decode.widen in
    frave.decode.upload; frave.pin opens only where _upload pins, on the
    card), transfer_bytes grows by exactly the bytes of the arrays
    uploaded and fetched (the gradient counts of the transform choice
    among them), and a container is byte-equal with a profiler
    on and off.
"""

import numpy as np
import pytest
import torch

import frave_tpu_torch
from frave_tpu_torch.codec import channel_transform as CT
from frave_tpu_torch.codec import pipeline_torch as PT
from frave_tpu_torch.codec.container import deserialize
from frave_tpu_torch.fractal.schedule import default_num_lanes, get_schedule
from frave_tpu_torch.testing import natural_image

H, W = 768, 1024


@pytest.fixture(scope="module")
def large():
    px = natural_image(H, W, 3, seed=22)
    return px, frave_tpu_torch.encode(px, device="cpu")


def test_the_large_shape_takes_the_strided_branches():
    assert CT._proxy_stride(H, W) == 2
    sched = get_schedule(H, W)
    assert sched.num_symbols >= PT.GRID_ENC_MIN_K
    prog = PT.get_program(H, W, default_num_lanes(sched.num_symbols), 3, "cpu", "grid")
    capped = {hi - lo: PT.fit_stride(hi - lo) for lo, hi in prog.group_ranges
              if PT.fit_stride(hi - lo) > 1}
    assert capped == {393_728: 4, 197_312: 2}


def test_the_large_shape_round_trips_through_port_and_reference(large):
    from portbench.reference.decode import decode as reference_decode

    px, blob = large
    np.testing.assert_array_equal(frave_tpu_torch.decode(blob, device="cpu").data, px)
    np.testing.assert_array_equal(reference_decode(blob), px)
    lossless = (CT.T_NONE, CT.T_SUBGREEN, CT.T_YCOCG)
    assert deserialize(blob).transform == CT.select_transform(px, True) == CT._proxy_choice(
        px, lossless)


def _spans(prof):
    return [(e.name, e.time_range) for e in prof.events() if e.name.startswith("frave.")]


def _inside(spans, child, parent):
    (p,) = [r for n, r in spans if n == parent]
    (c,) = [r for n, r in spans if n == child]
    return p.start <= c.start and c.end <= p.end


def test_copy_spans_nest_in_their_parents():
    px = natural_image(64, 64, 3, seed=5)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        blob = frave_tpu_torch.encode(px, device="cpu")
        out = frave_tpu_torch.decode(blob, device="cpu")
    np.testing.assert_array_equal(out.data, px)
    spans = _spans(prof)
    assert _inside(spans, "frave.encode.stack", "frave.encode.upload")
    assert _inside(spans, "frave.decode.widen", "frave.decode.upload")
    assert "frave.pin" not in {n for n, _ in spans}  # the CPU uploads without staging


def test_transfer_bytes_count_the_arrays_moved():
    px = natural_image(64, 64, 3, seed=6)
    C = 3
    before = dict(PT.transfer_bytes)
    blob = frave_tpu_torch.encode(px, device="cpu")
    enc = {k: PT.transfer_bytes[k] - before[k] for k in before}
    ci = deserialize(blob)
    prog = PT.get_program(64, 64, ci.num_lanes, C, "cpu", "grid")
    # up: the pixels, the 512 int32 divisors and the transform id; down: the
    # candidate planes' gradient counts [8, 256] int32, the header row with
    # its residual sums [C] int64, then the stream's int32 words
    assert enc["h2d"] == px.nbytes + 512 * 4 + 4
    assert enc["d2h"] == (8 * 256 * 4 + 4 * prog.hdr_words + 8 * C
                          + 4 * ((len(ci.stream) + 1) // 2))

    before = dict(PT.transfer_bytes)
    out = frave_tpu_torch.decode(blob, device="cpu")
    dec = {k: PT.transfer_bytes[k] - before[k] for k in before}
    np.testing.assert_array_equal(out.data, px)
    states, streams, bits, offpk, scales, vp, wp, qdiv, tids = PT.assemble_wire_batch(
        [ci], ci.num_lanes)
    # the wire arrays in their own widths (the decode widens them on the
    # device): u32 states, int32 bits, u32 offsets, int32 scales, the u16 stream
    wire = 4 * (states.size + bits.size + offpk.size + scales.size) + 2 * streams.size
    assert dec["h2d"] == wire + vp.nbytes + wp.nbytes + qdiv.nbytes + tids.nbytes
    assert dec["d2h"] == px.nbytes


def test_containers_are_byte_equal_with_a_profiler_on_and_off():
    px = natural_image(64, 64, 3, seed=7)
    off = frave_tpu_torch.encode(px, device="cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        on = frave_tpu_torch.encode(px, device="cpu")
    assert on == off
