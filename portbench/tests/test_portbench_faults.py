"""A run with the timed path broken underneath comes out not correct,
once for each fault a cell of this benchmark can have; a sound run and
the control on the same small cells. The harness's look for a card is
skipped: the port runs its plain versions on the CPU (device="cpu").
No cell spans cards, so the fault of an exchange left out has no place."""

import time

import numpy as np
import pytest

from portbench.control import readings
from portbench.core.harness import run_cell

CELLS = ["tiles256_gray.bulk64", "kodak_shape_rgb.single"]


def _run(manifest, small, name, trace=False):
    cell, cfg, tr = small(name)
    return run_cell(manifest, cell, cfg, tr, 2**31 + 4242, 0.3, trace, "cpu", time.perf_counter())


def _step_returns_state_unchanged(monkeypatch):
    from frave_tpu_torch.codec import grid_decode as GD

    def stuck(x, gptr, buckets, active, stream, tabs, cluster=0):
        return buckets.new_zeros(buckets.shape), x, gptr

    monkeypatch.setattr(GD, "decode_scan_wave", stuck)


def _half_the_batch_left_out(monkeypatch):
    from frave_tpu_torch.codec import pipeline_torch as P

    real = P._decode_finish

    def half(dec, stages=None):
        outs = real(dec, stages)
        return outs[: len(outs) // 2]

    monkeypatch.setattr(P, "_decode_finish", half)


def _container_altered(monkeypatch):
    from frave_tpu_torch.codec import encoder as E
    from frave_tpu_torch.codec import pipeline_torch as P

    real = P.serialize

    def altered(ci):
        blob = bytearray(real(ci))
        blob[-3] ^= 0x21  # a word of the stream's end
        return bytes(blob)

    monkeypatch.setattr(P, "serialize", altered)
    monkeypatch.setattr(E, "serialize", altered)


def _pixel_altered(monkeypatch):
    from frave_tpu_torch.codec import pipeline_torch as P

    real = P._decode_finish

    def altered(dec, stages=None):
        outs = real(dec, stages)
        for o in outs:
            o.data = np.array(o.data)
            o.data.flat[7] ^= 1
        return outs

    monkeypatch.setattr(P, "_decode_finish", altered)


FAULTS = {
    "step_returns_state_unchanged": _step_returns_state_unchanged,
    "half_the_batch_left_out": _half_the_batch_left_out,
    "container_altered": _container_altered,
    "pixel_altered": _pixel_altered,
}


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(manifest, small, name):
    out = _run(manifest, small, name)
    assert out["correct"] and out["failed"] == 0
    assert all(c["value"] == 0 for c in out["checks"].values())


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(manifest, small, monkeypatch, name, fault):
    FAULTS[fault](monkeypatch)
    out = _run(manifest, small, name)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(manifest, small, name):
    cell, cfg, tr = small(name)
    (r,) = readings(manifest, cell, cfg, tr, [2**31 + 99], 0.3, "cpu")
    assert r["sound_correct"] and not r["control_correct"]
    assert r["control"]["decoded_px_wrong"] > 0 and r["sound"]["decoded_px_wrong"] == 0
