"""The lossy configuration and its cell: the baseline's shape uncut; a
sound run on the CPU is correct, each fault of the timed path (those of
test_portbench_faults, a harder table, a dequantize without its bias)
is not, nor is the control; the lossy reference decodes every preset as
the port does; the lifting kernels' roofline on a made-up trace."""

import time

import numpy as np
import pytest

from portbench.control import readings
from portbench.core import manifest as M
from portbench.core.harness import run_cell
from portbench.core.loop import Batch
from portbench.core.pool import natural_image
from portbench.core.readers import Context
from portbench.core.trace import Trace
from portbench.reference import container, decode, decode_lossy, geometry
from portbench.reference.quantization import QUANT_TABLES, expected_round_trip
from test_portbench_faults import FAULTS

CELL = "gray512_lossy.bulk16"
PRESETS = ["HIGH", "MEDIUM", "LOW"]


def _run(manifest, small):
    cell, cfg, tr = small(CELL)
    return run_cell(manifest, cell, cfg, tr, 2**31 + 5151, 0.3, False, "cpu",
                    time.perf_counter())


def _low_table(monkeypatch):
    from frave_tpu_torch.codec import pipeline_torch as P

    monkeypatch.setattr(P, "quantization_matrix",
                        lambda quality: np.asarray(QUANT_TABLES["LOW"], dtype=np.int32))


def _dequantize_without_bias(monkeypatch):
    import torch

    from frave_tpu_torch.ops import torch_ops as T

    monkeypatch.setattr(T, "dequantize",
                        lambda coef, divisors: coef.to(torch.int32) * divisors.to(torch.int32))


LOSSY_FAULTS = {**FAULTS, "encoder_given_low_table": _low_table,
                "dequantize_without_bias": _dequantize_without_bias}


def test_cell_is_the_baseline_shape_uncut(manifest):
    cell = M.workload(manifest, CELL)
    cfg = M.load_config(cell["config"])
    entry = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    assert cell["chips"] == 1 and entry["reduced"] == [] and cfg["reduced"] == []
    assert (cfg["height"], cfg["width"], cfg["channels"], cfg["quality"]) == (512, 512, 1,
                                                                              "MEDIUM")
    assert cfg["guarantees"]["quantization_matrix"] == QUANT_TABLES["MEDIUM"]


def test_sound_run_is_correct(manifest, small):
    out = _run(manifest, small)
    assert out["correct"] and out["failed"] == 0
    assert set(out["checks"]) == {"missing_outputs", "matrix_wrong", "decoded_px_wrong",
                                  "container_px_wrong"}
    assert all(c["value"] == 0 for c in out["checks"].values())


@pytest.mark.parametrize("fault", sorted(LOSSY_FAULTS))
def test_fault_is_not_correct(manifest, small, monkeypatch, fault):
    LOSSY_FAULTS[fault](monkeypatch)
    out = _run(manifest, small)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_control_is_not_correct(manifest, small):
    cell, cfg, tr = small(CELL)
    (r,) = readings(manifest, cell, cfg, tr, [2**31 + 77], 0.3, "cpu")
    assert r["sound_correct"] and not r["control_correct"]
    assert r["control"]["decoded_px_wrong"] > 0 and r["sound"]["decoded_px_wrong"] == 0
    assert r["control"]["container_px_wrong"] == 0  # one limit fails, not each


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("shape", [(64, 64, 1), (96, 80, 3)])
def test_decode_lossy_decodes_as_the_port(shape, preset):
    import frave_tpu_torch as F

    h, w, c = shape
    img = natural_image(h, w, c, [9, h, c])
    blob = F.encode(img, F.EncoderOptions(quality=F.EncoderQuality[preset]), device="cpu")
    port = F.decode(blob, device="cpu").data.reshape(h, w, c)
    assert np.array_equal(decode_lossy.decode(blob), port)
    if c == 1:
        assert np.array_equal(expected_round_trip(img, preset), port)
        assert not np.array_equal(port, img)


def test_decode_lossy_of_a_lossless_container_is_decode():
    import frave_tpu_torch as F

    img = natural_image(64, 64, 1, [10])
    blob = F.encode(img, F.EncoderOptions(), device="cpu")
    assert np.array_equal(decode_lossy.decode(blob), decode.decode(blob))
    assert np.array_equal(expected_round_trip(img, "LOSSLESS"), img)


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_lifting_roofline_on_a_made_up_trace():
    import frave_tpu_torch as F

    imgs = [natural_image(64, 64, 1, [12, i]) for i in range(2)]
    opts = F.EncoderOptions(quality=F.EncoderQuality.MEDIUM)
    blobs = [F.encode(im, opts, device="cpu") for im in imgs]
    batches = [Batch([0, 1], blobs)]
    nodes = int(np.count_nonzero(geometry.get_geometry(64, 64).coef_mask))
    assert len(container.deserialize(blobs[0]).quantization_matrix) == 32
    # per image, each side: 64*64 pixels at a byte and the nodes at 2 bytes;
    # one MEDIUM table of 32 divisors at 2 bytes a side for the batch
    want = 2 * 2 * (64 * 64 + 2 * nodes) + 2 * 2 * 32
    assert M.load_kernel_family("lifting")["work"].bytes_needed(batches) == want
    tr = Trace([
        _ev("user_annotation", "portbench.window", 0, 100),
        _ev("kernel", "void fwd_lift_pixels_kernel<1>(unsigned char const*)", 10, 10),
        _ev("kernel", "inv_lift_pixels_kernel(int const*, long)", 30, 15),
        _ev("kernel", "void rans_decode_wave_kernel(WaveArgs)", 50, 20),
    ])
    ctx = Context({}, {}, "card", {"hbm_bytes_per_s": 1e12}, 1.0, [], tr, batches, imgs)
    got = M.load_reader("lifting_roofline.bulk")(ctx)
    assert got == pytest.approx(100 * want / 1e12 / 25e-6)
