"""The readers of the program's spans (core/program_spans.py and the six
metrics on it): a traced CPU run of a small cell reports each of them
that lists the cell, and on a made-up trace they count every microsecond
under nested or overlapping spans once and divide by the right number of
units or batches."""

import time

import pytest

from portbench.core import manifest as M
from portbench.core import program_spans as PS
from portbench.core.harness import run_cell
from portbench.core.readers import Context
from portbench.core.trace import Trace

SPAN_METRICS = ("transform_choice_ms.enc1", "transform_choice_ms.bulk", "encode_host_ms.enc1",
                "decode_host_ms.dec1", "dispatch_host_ms.bulk", "stream_wait_ms.bulk")


@pytest.mark.parametrize("name", ["tiles256_gray.bulk64", "tiles256_gray.single",
                                  "kodak_shape_rgb.single"])
def test_traced_cpu_run_reports_the_span_metrics(manifest, small, name):
    cell, cfg, tr = small(name)
    out = run_cell(manifest, cell, cfg, tr, 2**31 + 77, 0.3, True, "cpu", time.perf_counter())
    assert out["correct"] is True
    want = [m["name"] for m in M.per_layer(manifest, name) if m["name"] in SPAN_METRICS]
    assert want
    for metric in want:
        v = out["metrics"][metric]["value"]
        assert isinstance(v, float) and v > 0, metric


def _ev(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def _ctx(events, batches_per_call=2):
    return Context({"batches_per_call": batches_per_call}, {}, "cpu", {}, 0.0, [],
                   Trace(events), [], [])


def test_nested_and_overlapping_spans_count_once():
    events = [
        _ev("portbench.window", 0, 1000),
        _ev("portbench.call", 0, 400), _ev("portbench.call", 500, 400),
        # call 1: a dispatch with a nested one-off span, and two that overlap
        _ev("frave.encode.dispatch", 10, 100), _ev("frave.encode.transform", 20, 50),
        _ev("frave.decode.dispatch", 200, 60), _ev("frave.encode.dispatch", 240, 40),
        # call 2: one dispatch, and one reaching past the call's end
        _ev("frave.decode.dispatch", 510, 30), _ev("frave.encode.dispatch", 880, 50),
        # outside every call, and an operator that is no program span
        _ev("frave.encode.dispatch", 420, 50), _ev("aten::copy_", 20, 500, "cpu_op"),
    ]
    ctx = _ctx(events)
    names = ["frave.encode.dispatch", "frave.decode.dispatch", "frave.encode.transform"]
    # call 1: [10, 110] + [200, 280] = 180 us; call 2: 30 + 20 = 50 us
    assert PS.unit_ms(ctx, "call", names) == pytest.approx([0.180, 0.050])
    assert PS.batch_ms(ctx, names) == pytest.approx(0.230 / 4)
    assert PS.batch_ms(_ctx(events, 1), names) == pytest.approx(0.230 / 2)
    assert PS.batch_ms(ctx, ["frave.encode.transform"]) == pytest.approx(0.050 / 4)


def test_requests_take_the_median_and_absent_spans_read_none():
    events = [
        _ev("portbench.window", 0, 1000),
        _ev("portbench.encode", 0, 100), _ev("portbench.encode", 200, 100),
        _ev("portbench.encode", 400, 100), _ev("portbench.decode", 600, 100),
        _ev("frave.encode.upload", 10, 10), _ev("frave.container.serialize", 15, 10),
        _ev("frave.encode.upload", 210, 40), _ev("frave.encode.launch", 400, 30),
        _ev("frave.encode.unpack", 420, 20),
    ]
    ctx = _ctx(events)
    steps = ["frave.encode.upload", "frave.encode.launch", "frave.encode.unpack",
             "frave.container.serialize"]
    # the requests read 15, 40 and 40 us
    assert PS.request_ms(ctx, "encode", steps) == pytest.approx(0.040)
    assert PS.unit_ms(ctx, "decode", steps) == [0.0]
    # a program without the spans (or a run without the unit) reads nothing
    assert PS.request_ms(ctx, "encode", ["frave.decode.wrap"]) is None
    assert PS.batch_ms(ctx, steps) is None
    assert PS.request_ms(_ctx([_ev("portbench.window", 0, 10)]), "encode", steps) is None
    for metric in SPAN_METRICS:
        assert M.load_reader(metric)(_ctx([_ev("portbench.window", 0, 10)])) is None
