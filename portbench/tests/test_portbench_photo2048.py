"""The 2048x2048 RGB cell (photo2048_rgb.single) and the readers it brought:
its small cut runs sound, its faults and its control come out not
correct, a traced CPU run reports its span metrics; on made-up traces
the per-pixel copy readers count the union of their spans and read
nothing on a program without them, and the single decodes' roofline is
the family's bound time over its kernels' device time."""

import time

import pytest

from portbench.control import readings
from portbench.core import manifest as M
from portbench.core.harness import run_cell
from portbench.core.loop import Batch
from portbench.core.readers import Context
from portbench.core.trace import Trace

from test_portbench_faults import FAULTS

CELL = "photo2048_rgb.single"
SEED = 2**31 + 5151


def _run(manifest, small, trace=False):
    cell, cfg, tr = small(CELL)
    return run_cell(manifest, cell, cfg, tr, SEED, 0.3, trace, "cpu", time.perf_counter())


def test_the_cell_is_the_baseline_shape_uncut(manifest):
    cell = M.workload(manifest, CELL)
    cfg = M.load_config(cell["config"])
    assert (cfg["height"], cfg["width"], cfg["channels"]) == (2048, 2048, 3)
    assert cfg["reduced"] == [] and cell["chips"] == 1 and cell["traffic"] == "single"
    assert {m["name"] for m in M.end_to_end(manifest, CELL)} == {
        "setup_s", "encode_p95_ms", "decode_p95_ms", "bpp"}


def test_sound_run_is_correct(manifest, small):
    out = _run(manifest, small)
    assert out["correct"] and out["failed"] == 0
    assert all(c["value"] == 0 for c in out["checks"].values())


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(manifest, small, monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    out = _run(manifest, small)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_control_is_not_correct(manifest, small):
    cell, cfg, tr = small(CELL)
    (r,) = readings(manifest, cell, cfg, tr, [SEED], 0.3, "cpu")
    assert r["sound_correct"] and not r["control_correct"]
    assert r["control"]["decoded_px_wrong"] > 0 and r["sound"]["decoded_px_wrong"] == 0


def test_traced_cpu_run_reports_the_span_metrics(manifest, small):
    out = _run(manifest, small, trace=True)
    assert out["correct"] is True
    want = {m["name"] for m in M.per_layer(manifest, CELL) if m["source"] == "program_span"}
    assert {"host_copy_ms.enc1", "host_copy_ms.dec1", "encode_host_ms.enc1"} <= want
    for metric in want:
        v = out["metrics"][metric]["value"]
        assert isinstance(v, float) and v >= 0, metric
    for metric in ("host_copy_ms.enc1", "host_copy_ms.dec1", "encode_host_ms.enc1",
                   "decode_host_ms.dec1", "transform_choice_ms.enc1"):
        assert out["metrics"][metric]["value"] > 0, metric
    # the CPU has no bandwidth in peaks.json: no roofline
    assert "rans_decode_roofline.dec1" not in out["metrics"]


def _ev(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def _ctx(events, peaks=None, batches=()):
    return Context({"batch_size": 1}, {}, "card", peaks or {}, 0.0, [], Trace(events),
                   list(batches), [])


def test_copy_readers_take_the_union_of_their_spans():
    events = [
        _ev("portbench.window", 0, 2000),
        _ev("portbench.encode", 0, 400), _ev("portbench.decode", 500, 400),
        _ev("portbench.encode", 1000, 400), _ev("portbench.decode", 1500, 400),
        # encode 1: the stack inside the upload, two pins; encode 2: one pin
        _ev("frave.encode.upload", 10, 100), _ev("frave.encode.stack", 20, 30),
        _ev("frave.pin", 60, 10), _ev("frave.pin", 80, 20), _ev("frave.pin", 1010, 50),
        # decode 1: widen, a pin overlapping it, the wrap; decode 2: widen and wrap
        _ev("frave.decode.widen", 510, 40), _ev("frave.pin", 540, 20),
        _ev("frave.decode.wrap", 800, 5),
        _ev("frave.decode.widen", 1510, 10), _ev("frave.decode.wrap", 1800, 3),
    ]
    ctx = _ctx(events)
    # encodes: 30 + 10 + 20 = 60 us and 50 us; decodes: [510, 560] + 5 = 55 us and 13 us
    assert M.load_reader("host_copy_ms.enc1")(ctx) == pytest.approx(0.055)
    assert M.load_reader("host_copy_ms.dec1")(ctx) == pytest.approx(0.034)


def test_copy_readers_read_nothing_without_their_spans():
    events = [
        _ev("portbench.window", 0, 1000),
        _ev("portbench.encode", 0, 400), _ev("portbench.decode", 500, 400),
        _ev("frave.encode.upload", 10, 100), _ev("frave.decode.upload", 510, 40),
        _ev("frave.decode.wrap", 800, 5),  # a program that predates the copy spans has this one
    ]
    for metric in ("host_copy_ms.enc1", "host_copy_ms.dec1"):
        assert M.load_reader(metric)(_ctx(events)) is None, metric


def test_single_decode_roofline_is_bound_time_over_device_time():
    import frave_tpu_torch as F

    from portbench.core.pool import natural_image

    blob = F.encode(natural_image(64, 96, 3, [3, 0]), F.EncoderOptions(), device="cpu")
    batches = [Batch([0], [blob]), Batch([1], [blob])]
    events = [
        _ev("portbench.window", 0, 1000),
        _ev("void (anonymous namespace)::rans_decode_wave_kernel<1>", 100, 30, "kernel"),
        _ev("void (anonymous namespace)::rans_decode_wave_kernel<4>", 300, 20, "kernel"),
        _ev("wave_finish_kernel", 330, 40, "kernel"),
        _ev("rans_decode_wave_kernel past the window", 1200, 40, "kernel"),
    ]
    bw = 3.35e12
    read = M.load_reader("rans_decode_roofline.dec1")
    need = M.load_kernel_family("rans_decode")["work"].bytes_needed(batches)
    got = read(_ctx(events, {"hbm_bytes_per_s": bw}, batches))
    assert got == pytest.approx(100.0 * (need / bw) / 50e-6)
    assert read(_ctx(events, {}, batches)) is None
    assert read(_ctx(events, {"hbm_bytes_per_s": bw}, [])) is None
