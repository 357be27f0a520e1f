"""The port's metrics sink and profiling hooks against frave_tpu's, on the
CPU.

  * encode/mean_abs_residual_ch{c} equals frave_tpu's numpy backend's on
    the same image with the value parameters pinned (rel 1e-12);
  * encode/bpp and, under verbose, the per-context entropies equal the jax
    backend's (abs 1e-9), and under emit_coefficients the per-context
    histograms too, the parameters pinned;
  * an encode batch's finish still makes two fetches (the residual sums,
    and the histograms when asked for, ride the headers' fetch), after
    the one of an RGB batch's gradient counts;
  * a StageTimes records its stages in the sink;
  * the drivers' spans (profiling.annotate): with no profiler recording
    they never call record_function; under a default torch.profiler a
    single encode and decode show every span of the one-image path, one a
    call (frave.fetch four times); under profiling.trace the stream's
    worker spans sit on other threads than the caller's, whose
    frave.stream.wait spans and dispatch|finish spans a batch appear;
  * profiling.trace writes a Chrome trace on the CPU that names an
    annotated region;
  * a fresh `python -m frave_tpu_torch.cli --help` process imports
    neither jax nor frave_tpu.
"""

import json
import os
import subprocess
import sys
import threading
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

import frave_tpu
import frave_tpu_torch
from frave_tpu.codec import pipeline_jax as PJ
from frave_tpu.codec import pipeline_np as PN
from frave_tpu.metrics import get_metrics as jax_metrics
from frave_tpu_torch import EncoderOptions, RasterImage
from frave_tpu_torch import profiling
from frave_tpu_torch.codec import pipeline_torch as PT
from frave_tpu_torch.metrics import get_metrics
from frave_tpu_torch.testing import natural_image

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def sinks():
    """Both sinks empty and quiet before and after the test."""
    for m in (get_metrics(), jax_metrics()):
        m.reset()
        m.verbose = False
    yield get_metrics(), jax_metrics()
    for m in (get_metrics(), jax_metrics()):
        m.reset()
        m.verbose = False


def pinned(ci, c, backend, **kw):
    """The port's options and frave_tpu's (on `backend`) with ci's value
    and width parameters and lane count pinned."""
    vp = np.stack([ci.channel_data[i].value_prediction_parameters for i in range(c)])
    wp = np.stack([ci.channel_data[i].width_prediction_parameters for i in range(c)])
    common = dict(value_prediction_params=vp, width_prediction_params=wp,
                  num_lanes=ci.num_lanes, **kw)
    return EncoderOptions(**common), frave_tpu.EncoderOptions(backend=backend, **common)


@pytest.mark.parametrize("shape", [(64, 64, 1), (80, 96, 3)])
def test_mean_abs_residual_matches_the_numpy_backend(sinks, shape):
    port, ref = sinks
    px = natural_image(*shape, seed=50)
    ci = PN.encode_pipeline_np(
        frave_tpu.RasterImage.from_array(px), frave_tpu.EncoderOptions())
    opts_t, opts_j = pinned(ci, shape[2], "numpy")
    ref.reset()
    frave_tpu.encode(px, opts_j)
    frave_tpu_torch.encode(px, opts_t, device="cpu")
    for c in range(shape[2]):
        name = f"encode/mean_abs_residual_ch{c}"
        got, want = port.snapshot()[name], ref.snapshot()[name]
        assert len(got) == len(want) == 1
        np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("shape,mode", [((64, 64, 1), "grid"), ((80, 96, 3), "grid"),
                                        ((64, 64, 1), "parity")])
def test_bpp_and_context_statistics_match_the_jax_backend(sinks, capsys, shape, mode):
    port, ref = sinks
    px = natural_image(*shape, seed=51)
    ci = PJ.encode_pipeline_jax(
        frave_tpu.RasterImage.from_array(px), frave_tpu.EncoderOptions(mode=mode))
    opts_t, opts_j = pinned(ci, shape[2], "jax", mode=mode, verbose=True,
                            emit_coefficients=True)
    ref.reset()
    blob_j = frave_tpu.encode(px, opts_j)
    blob_t = frave_tpu_torch.encode(px, opts_t, device="cpu")
    assert blob_t == blob_j
    got, want = port.snapshot(), ref.snapshot()
    names = sorted(n for n in want if n == "encode/bpp" or n.startswith("encode/context_"))
    assert "encode/bpp" in names and len(names) > shape[2]
    assert sorted(n for n in got if n == "encode/bpp" or n.startswith("encode/context_")) == names
    for n in names:
        np.testing.assert_allclose(got[n], want[n], rtol=0, atol=1e-9, err_msg=n)
    hists = [n for n in (f"encode/context_hist_ch{c}_b{k}" for c in range(shape[2])
                         for k in range(15))]
    for n in hists:
        a, b = port.arrays(n), ref.arrays(n)
        assert len(a) == len(b) == 1, n
        np.testing.assert_array_equal(a[0], b[0])
    assert "[frave] encode/bpp = " in capsys.readouterr().out


@pytest.mark.parametrize("verbose", [False, True])
def test_an_encode_batch_keeps_its_two_fetches(sinks, monkeypatch, verbose):
    port, _ = sinks
    fetched = []
    real = PT._fetch

    def fetch(t, ready):
        fetched.append(1)
        return real(t, ready)

    monkeypatch.setattr(PT, "_fetch", fetch)
    imgs = [RasterImage.from_array(natural_image(32, 40, 3, seed=s)) for s in (6, 7)]
    PT.encode_pipeline_torch_batch(imgs, EncoderOptions(verbose=verbose), "cpu")
    assert len(fetched) == 1 + 2  # the transform choice's gradient counts, then the finish's
    snap = port.snapshot()
    assert [len(snap[f"encode/mean_abs_residual_ch{c}"]) for c in range(3)] == [2, 2, 2]
    assert any(n.startswith("encode/context_entropy") for n in snap) == verbose


def _trace_spans(tmp_path):
    """(name, tid) of every frave.* span in the one Chrome trace under
    tmp_path."""
    (path,) = tmp_path.iterdir()
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], e.get("tid")) for e in events
            if e.get("ph") == "X" and str(e.get("name", "")).startswith("frave.")]


def test_stream_drivers_record_their_stage_timers(sinks, tmp_path):
    """The stream drivers' dispatch and finish spans, one a batch."""
    imgs = [RasterImage.from_array(natural_image(32, 32, 1, seed=s)) for s in (1, 2, 3)]
    with profiling.trace(str(tmp_path), device="cpu"):
        cis = PT.encode_pipeline_torch_stream(imgs, EncoderOptions(), batch_size=2,
                                              device="cpu")
        outs = PT.decode_pipeline_torch_stream(cis, batch_size=2, device="cpu")
    for im, out in zip(imgs, outs):
        np.testing.assert_array_equal(out.data, im.data)
    got = Counter(name for name, _ in _trace_spans(tmp_path))
    for name in ("frave.encode.dispatch", "frave.encode.finish", "frave.decode.dispatch",
                 "frave.decode.finish"):
        assert got[name] == 2, name
    assert len(get_metrics().snapshot()["encode/bpp"]) == 3


def _no_record_function(*args, **kwargs):
    raise AssertionError("record_function called with no profiler recording")


@pytest.mark.parametrize("path", ["batch", "stream", "roundtrip", "public"])
def test_spans_cost_nothing_when_off(monkeypatch, path):
    monkeypatch.setattr(torch.profiler, "record_function", _no_record_function)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _no_record_function)
    pxs = [natural_image(32, 40, 3, seed=s) for s in (8, 9, 10)]
    imgs = [RasterImage.from_array(p) for p in pxs]
    opts = EncoderOptions()
    if path == "batch":
        cis = PT.encode_pipeline_torch_batch(imgs, opts, "cpu")
        outs = [o.data for o in PT.decode_pipeline_torch_batch(cis, "cpu")]
    elif path == "stream":
        cis = PT.encode_pipeline_torch_stream(imgs, opts, batch_size=2, device="cpu")
        outs = [o.data for o in PT.decode_pipeline_torch_stream(cis, batch_size=2, device="cpu")]
    elif path == "roundtrip":
        _, res = PT.roundtrip_pipeline_torch_stream(imgs, opts, batch_size=2, device="cpu")
        outs = [o.data for o in res]
    else:
        outs = [frave_tpu_torch.decode(frave_tpu_torch.encode(p, opts, device="cpu"),
                                       device="cpu").data for p in pxs]
    assert len(outs) == len(pxs)
    for px, out in zip(pxs, outs):
        np.testing.assert_array_equal(out, px)


SINGLE_PATH_SPANS = (
    "frave.encode.dispatch", "frave.encode.transform", "frave.encode.upload",
    "frave.encode.stack", "frave.encode.launch", "frave.encode.finish",
    "frave.encode.unpack", "frave.container.serialize", "frave.container.parse",
    "frave.decode.dispatch", "frave.decode.assemble", "frave.decode.upload",
    "frave.decode.widen", "frave.decode.launch", "frave.decode.finish", "frave.decode.wrap",
)


def test_single_path_spans_in_a_default_profiler():
    """A default torch.profiler session on the caller's thread sees every
    span of one RGB encode and decode, once a call; frave.fetch once in the
    encode's transform choice (the gradient counts), twice in its finish
    and once in the decode's."""
    px = natural_image(32, 40, 3, seed=11)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        blob = frave_tpu_torch.encode(px, device="cpu")
        out = frave_tpu_torch.decode(blob, device="cpu")
    np.testing.assert_array_equal(out.data, px)
    events = [e for e in prof.events() if e.name.startswith("frave.")]
    got = Counter(e.name for e in events)
    assert {n: got[n] for n in SINGLE_PATH_SPANS} == {n: 1 for n in SINGLE_PATH_SPANS}
    assert set(got) == set(SINGLE_PATH_SPANS) | {"frave.fetch"}
    fetches = [e.time_range for e in events if e.name == "frave.fetch"]
    for parent, n in (("encode.transform", 1), ("encode.finish", 2), ("decode.finish", 1)):
        (span,) = [e.time_range for e in events if e.name == f"frave.{parent}"]
        assert sum(span.start <= f.start and f.end <= span.end for f in fetches) == n, parent
    assert len(fetches) == 4


def test_a_flat_image_reencode_is_one_span():
    """The rate fix for flat content is one frave.encode.reencode span
    around the re-encoded batch's own spans."""
    flat = np.full((256, 256, 1), 77, dtype=np.uint8)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        blob = frave_tpu_torch.encode(flat, device="cpu")
    np.testing.assert_array_equal(frave_tpu_torch.decode(blob, device="cpu").data, flat)
    got = Counter(e.name for e in prof.events() if e.name.startswith("frave."))
    assert got["frave.encode.reencode"] == 1
    assert got["frave.encode.dispatch"] == got["frave.encode.finish"] == 2


def test_stream_worker_spans_under_trace(tmp_path):
    """profiling.trace records every thread: the stream's container work
    on its workers, the waits for them on the caller's thread."""
    imgs = [RasterImage.from_array(natural_image(32, 32, 1, seed=s)) for s in (12, 13, 14, 15)]
    with profiling.trace(str(tmp_path), device="cpu"):
        _, outs = PT.roundtrip_pipeline_torch_stream(imgs, EncoderOptions(), batch_size=2,
                                                     device="cpu")
    for im, out in zip(imgs, outs):
        np.testing.assert_array_equal(out.data, im.data)
    caller = threading.get_native_id()
    tids = {}
    for name, tid in _trace_spans(tmp_path):
        tids.setdefault(name, []).append(tid)
    for name in ("frave.encode.unpack", "frave.container.serialize", "frave.decode.wrap"):
        assert len(tids[name]) == 2 and caller not in tids[name], name
    assert tids["frave.stream.wait"] and set(tids["frave.stream.wait"]) == {caller}
    assert set(tids["frave.encode.dispatch"]) == {caller}


def test_stage_times_record_into_the_sink(sinks):
    port, _ = sinks
    st = PT.StageTimes("cpu")
    ci = PT.encode_pipeline_torch(RasterImage.from_array(natural_image(32, 32, 1, seed=4)),
                                  EncoderOptions(), "cpu", stages=st)
    PT.decode_pipeline_torch(ci, "cpu", stages=st)
    snap = port.snapshot()
    assert set(st.ms) >= {"encode/lift", "encode/stats", "encode/tables", "encode/rans",
                          "encode/compact", "encode/fetch", "decode/tables", "decode/pixels",
                          "decode/fetch"}
    for name, ms in st.ms.items():
        assert np.isclose(sum(snap[name]) * 1e3, ms), name


def test_trace_writes_a_chrome_trace(tmp_path):
    px = natural_image(32, 32, 1, seed=5)
    with profiling.trace(str(tmp_path), device="cpu"):
        with profiling.annotate("frave/encode"):
            blob = frave_tpu_torch.encode(px, device="cpu")
        frave_tpu_torch.decode(blob, device="cpu")
    (path,) = tmp_path.iterdir()
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "frave/encode" in names
    assert any(str(n).startswith("aten::") for n in names)


def test_cli_help_imports_neither_jax_nor_frave_tpu():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "frave_tpu_torch.cli", "--help"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert "encode" in res.stdout and "optimize" in res.stdout
    mods = [line.rsplit("|", 1)[-1].strip() for line in res.stderr.splitlines()
            if line.startswith("import time:") and "|" in line]
    assert "frave_tpu_torch.cli.main" in mods
    bad = [m for m in mods if m.split(".")[0] in ("jax", "frave_tpu")]
    assert not bad, bad
