"""The rate, tail, spread and idle arithmetic on made-up numbers, spans
and traces."""

import statistics

import numpy as np
import pytest

from portbench.core import manifest as M
from portbench.core import readers as RD
from portbench.core.loop import Batch
from portbench.core import stats
from portbench.core.trace import Trace, merge


def test_rate_is_all_work_over_all_time():
    assert stats.rate(30.0, 1.5) == 20.0
    with pytest.raises(ValueError):
        stats.rate(1.0, 0.0)


def test_percentile_is_over_every_value():
    vals = list(range(1, 201))  # 1..200
    assert stats.percentile(vals, 95) == pytest.approx(np.percentile(vals, 95))
    assert stats.beyond(vals, 95) == 10
    # one slow request among fast ones moves the tail, not a median of chunks
    vals = [10.0] * 99 + [500.0]
    assert stats.percentile(vals, 99) > 10.0
    assert stats.percentile([7.0], 95) == 7.0


def test_spread_uses_statistics_quartiles():
    vals = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    q1, q2, q3 = statistics.quantiles(vals, n=4)
    assert stats.spread(vals) == pytest.approx((q3 - q1) / q2)


def test_bits_per_pixel_counts_a_colour_pixel_once():
    assert stats.bits_per_pixel(1000, 8000) == 1.0


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _trace():
    # a 100 us window; two encode spans (0-40, 50-90); kernels 10-20, 15-25, 60-70
    return Trace([
        _ev("user_annotation", "portbench.window", 0, 100),
        _ev("user_annotation", "portbench.encode", 0, 40),
        _ev("user_annotation", "portbench.encode", 50, 40),
        _ev("kernel", "void rans_decode_wave_kernel(WaveArgs)", 10, 10),
        _ev("kernel", "elementwise", 15, 10),
        _ev("gpu_memcpy", "Memcpy HtoD", 60, 10),
        _ev("cpu_op", "aten::copy_", 28, 20),
        _ev("cpu_op", "aten::empty", 30, 2),
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 5},
    ])


def test_merge_and_busy():
    assert merge([(5, 7), (1, 3), (2, 4)]) == [[1, 4], [5, 7]]
    tr = _trace()
    assert tr.busy == [[10, 25], [60, 70]]
    assert tr.busy_us(0, 100) == 25
    assert tr.busy_us(12, 62) == 15


def test_idle_share_within_spans():
    tr = _trace()
    spans = tr.spans["portbench.encode"]
    assert tr.idle_pct(spans) == pytest.approx(100.0 * (1 - 25 / 80))
    assert tr.idle_pct([tr.window()]) == pytest.approx(75.0)


def test_device_time_by_name_and_breakdown():
    tr = _trace()
    assert tr.device_us(["rans_decode_wave_kernel"]) == 10
    assert tr.device_us(["rans_decode_wave_kernel"], 15, 100) == 5
    ops = tr.top_device_ops()
    assert ops[0][1] == pytest.approx(10e-6) and len(ops) == 3
    gaps = dict(tr.idle_gaps(0, 100))
    # idle: 0-10 and 70-100 inside encode spans with no host event; 25-60
    # between the spans, its midpoint (42.5) inside aten::copy_
    assert sum(gaps.values()) == pytest.approx(75e-6)
    assert gaps["between units: aten::copy_"] == pytest.approx(35e-6)
    assert gaps["encode: host python"] == pytest.approx(40e-6)


def test_readers_on_made_up_units_and_trace(monkeypatch):
    units = [RD.Unit("encode", 10.0, {"encode/stats": 2.0, "encode/lift": 1.0}),
             RD.Unit("encode", 12.0, {"encode/stats": 4.0, "encode/lift": 1.0}),
             RD.Unit("decode", 5.0, {"decode/waves": 3.0})]
    tr = _trace()
    work = M.load_kernel_family("rans_decode")["work"]
    monkeypatch.setattr(work, "bytes_needed", lambda batches: 1000 * len(batches))
    batches = [Batch([0, 1], [b"a", b"b"]), Batch([2], [b"c"])]
    ctx = RD.Context({}, {}, "card", {"hbm_bytes_per_s": 1e12}, 1.5, units, tr, batches, [])
    assert RD.driver_ms(ctx, "encode") == pytest.approx(statistics.median([7.0, 7.0]))
    assert RD.driver_ms(ctx, "decode") == 2.0
    assert RD.stage_ms(ctx, "encode/stats") == 3.0
    assert RD.stage_ms(ctx, "decode/nothing") is None
    assert RD.idle_pct(ctx, "encode") == pytest.approx(100.0 * (1 - 25 / 80))
    assert RD.idle_pct(ctx, "call") is None
    # 2,000 bytes over 1e12 B/s, over the kernels' 10 us
    assert RD.roofline_pct(ctx, "rans_decode") == pytest.approx(100 * 2000 / 1e12 / 10e-6)


def test_roofline_reads_nothing_without_kernel_time_or_peak():
    tr = Trace([_ev("user_annotation", "portbench.window", 0, 100)])
    batches = [Batch([0], [b"a"])]
    ctx = RD.Context({}, {}, "card", {"hbm_bytes_per_s": 1e12}, 1.0, [], tr, batches, [])
    assert RD.roofline_pct(ctx, "rans_decode") is None  # never 0
    ctx = RD.Context({}, {}, "card", {}, 1.0, [], _trace(), batches, [])
    assert RD.roofline_pct(ctx, "rans_decode") is None  # a card without a peak
    ctx = RD.Context({}, {}, "card", {"hbm_bytes_per_s": 1e12}, 1.0, [], _trace(), [], [])
    assert RD.roofline_pct(ctx, "rans_decode") is None  # no decode traced
