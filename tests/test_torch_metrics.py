"""The port's metrics sink and profiling hooks against frave_tpu's, on the
CPU.

  * encode/mean_abs_residual_ch{c} equals frave_tpu's numpy backend's on
    the same image with the value parameters pinned (rel 1e-12);
  * encode/bpp and, under verbose, the per-context entropies equal the jax
    backend's (abs 1e-9), and under emit_coefficients the per-context
    histograms too, the parameters pinned;
  * an encode batch still makes two fetches (the residual sums, and the
    histograms when asked for, ride the headers' fetch);
  * the _stream drivers record encode|decode/dispatch|finish, and a
    StageTimes records its stages in the sink;
  * profiling.trace writes a Chrome trace on the CPU that names an
    annotated region;
  * a fresh `python -m frave_tpu_torch.cli --help` process imports
    neither jax nor frave_tpu.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

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
    assert len(fetched) == 2
    snap = port.snapshot()
    assert [len(snap[f"encode/mean_abs_residual_ch{c}"]) for c in range(3)] == [2, 2, 2]
    assert any(n.startswith("encode/context_entropy") for n in snap) == verbose


def test_stream_drivers_record_their_stage_timers(sinks):
    port, _ = sinks
    imgs = [RasterImage.from_array(natural_image(32, 32, 1, seed=s)) for s in (1, 2, 3)]
    cis = PT.encode_pipeline_torch_stream(imgs, EncoderOptions(), batch_size=2, device="cpu")
    outs = PT.decode_pipeline_torch_stream(cis, batch_size=2, device="cpu")
    for im, out in zip(imgs, outs):
        np.testing.assert_array_equal(out.data, im.data)
    snap = port.snapshot()
    for name in ("encode/dispatch", "encode/finish", "decode/dispatch", "decode/finish"):
        assert len(snap[name]) == 2 and all(t > 0 for t in snap[name]), name
    assert len(snap["encode/bpp"]) == 3


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
