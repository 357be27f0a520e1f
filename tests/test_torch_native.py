"""The port's native host library (frave_tpu_torch/native.py) on the CPU.

The library is built with g++ from csrc/ into frave_tpu_torch/_build/ once
per worker (under its file lock; the others load the same file). Held
against the plain numpy versions and against frave_tpu:

  * the native geometry equals the port's build_geometry_fast (field by
    field, dtypes too) and frave_tpu's, at tests/test_native_geometry.py's
    shapes;
  * the native layering gives the parity schedule the numpy layering
    gives it, every field, at 64x64 and 96x80;
  * backend="native" containers are byte-equal to frave_tpu's
    backend="native" ones and cross-decode with the port's torch backend;
  * refbase_roundtrip is lossless;
  * the build: a binary that does not carry the sources' hash is rebuilt,
    two processes that build at once both load the one library, and a
    source that does not compile raises with g++'s message (no fallback).
"""

import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import frave_tpu
import frave_tpu_torch
from frave_tpu.fractal import geometry_fast as GFJ
from frave_tpu_torch import native as N
from frave_tpu_torch.fractal import geometry as GT
from frave_tpu_torch.fractal import geometry_fast as GFT
from frave_tpu_torch.fractal import schedule as ST
from frave_tpu_torch.testing import natural_image
from test_torch_hostmods import assert_same

REPO = Path(__file__).resolve().parent.parent


def assert_same_typed(port, ref):
    """Every field equal, value, shape and dtype."""
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if isinstance(a, list):
            assert len(a) == len(b), f.name
            for x, y in zip(a, b):
                assert x.dtype == y.dtype, f.name
                np.testing.assert_array_equal(x, y, err_msg=f.name)
        elif isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, (f.name, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize(
    "h,w,depth",
    [(32, 32, 9), (48, 40, 9), (100, 60, 9), (1, 1, 9), (7, 300, 9), (64, 64, 7)],
)
def test_native_geometry_matches_numpy_and_frave_tpu(h, w, depth):
    nat = N.build_geometry_native(h, w, depth)
    assert_same_typed(nat, GFT.build_geometry_fast(h, w, depth))
    assert_same(nat, GFJ.build_geometry_fast(h, w, depth))


def test_get_geometry_builds_natively(monkeypatch):
    """get_geometry goes through the native builder (no switch picks the
    numpy one)."""
    calls = []
    real = N.build_geometry_native
    monkeypatch.setattr(GT, "_geometry_cache", {})
    monkeypatch.setattr(N, "build_geometry_native", lambda *a: calls.append(a) or real(*a))
    monkeypatch.setattr(GFT, "build_geometry_fast", None)
    GT.get_geometry(40, 24)
    assert calls == [(40, 24, GT.BASE_FRAC_DEPTH)]


@pytest.mark.parametrize("h,w", [(64, 64), (96, 80)])
def test_native_layering_matches_numpy_on_the_parity_schedule(monkeypatch, h, w):
    geo = GT.get_geometry(h, w)
    seen = []
    real = ST._layer_waves

    def native(n, deps):
        seen.append(deps.copy())
        return real(n, deps)

    monkeypatch.setattr(ST, "_layer_waves", native)
    nat = ST.build_schedule(geo, "parity")
    assert len(seen) > 1  # the tile wavefront, then each HF level
    for deps in seen:
        np.testing.assert_array_equal(N.layer_waves_native(deps),
                                      ST.layer_waves_plain(deps.shape[0], deps))
    monkeypatch.setattr(ST, "_layer_waves", ST.layer_waves_plain)
    assert_same(nat, ST.build_schedule(geo, "parity"))


NATIVE_CASES = [
    ((64, 64, 1), "grid", "auto", "LOSSLESS"),
    ((80, 96, 3), "grid", "auto", "LOSSLESS"),
    ((80, 96, 3), "grid", "trial", "HIGH"),
    ((80, 96, 3), "parallel", "auto", "LOSSLESS"),
]


@pytest.mark.parametrize("shape,mode,ct,quality", NATIVE_CASES)
def test_native_backend_matches_frave_tpu_and_cross_decodes(shape, mode, ct, quality):
    px = natural_image(*shape, seed=sum(shape))
    blob = frave_tpu_torch.encode(
        px, frave_tpu_torch.EncoderOptions(
            backend="native", mode=mode, color_transform=ct,
            quality=frave_tpu_torch.EncoderQuality[quality]),
        device="cpu",
    )
    ref = frave_tpu.encode(px, frave_tpu.EncoderOptions(
        backend="native", mode=mode, color_transform=ct,
        quality=frave_tpu.EncoderQuality[quality]))
    assert blob == ref
    out = frave_tpu_torch.decode(blob, device="cpu").data
    if quality == "LOSSLESS":
        np.testing.assert_array_equal(out, px)
    if mode == "grid":
        np.testing.assert_array_equal(
            frave_tpu_torch.decode(blob, backend="native").data, out)
        port = frave_tpu_torch.encode(px, frave_tpu_torch.EncoderOptions(
            mode=mode, quality=frave_tpu_torch.EncoderQuality[quality]), device="cpu")
        np.testing.assert_array_equal(
            frave_tpu_torch.decode(port, backend="native").data,
            frave_tpu_torch.decode(port, device="cpu").data)


def test_native_refuses_what_it_has_not():
    px = natural_image(32, 32, 1, seed=3)
    with pytest.raises(ValueError, match="no mode"):
        frave_tpu_torch.encode(px, frave_tpu_torch.EncoderOptions(
            backend="native", mode="parity"), device="cpu")
    with pytest.raises(ValueError, match="frif_probe"):
        frave_tpu_torch.decode(b"not a container", backend="native")
    with pytest.raises(ValueError, match="unknown backend"):
        frave_tpu_torch.decode(b"", backend="jax")


@pytest.mark.parametrize("cache", [False, True])
def test_refbase_roundtrip_is_lossless(cache):
    enc_s, dec_s, nbytes = N.refbase_roundtrip(natural_image(64, 48, 3, seed=9), cache)
    assert enc_s > 0 and dec_s > 0 and 0 < nbytes < 64 * 48 * 3


def test_stale_binary_is_rebuilt(tmp_path):
    """A library under the current name that reports another source hash
    is rebuilt and the rebuilt one loaded."""
    stale = tmp_path / "stale.c"
    stale.write_text('extern "C" const char* fg_source_sha(void) { return "stale"; }\n')
    out = N.library_path(tmp_path)
    subprocess.run([N.CXX, "-shared", "-fPIC", "-x", "c++", str(stale), "-o", str(out)],
                   check=True)
    before = out.stat().st_ino
    lib = N.load_library(tmp_path)
    assert lib.fg_source_sha().decode() == N.source_sha()
    assert out.stat().st_ino != before
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        ["stale.c", out.name, "libfrave_host.lock"])


def test_two_processes_building_at_once_both_load(tmp_path):
    code = ("import sys\nfrom frave_tpu_torch import native as N\n"
            "print(N.load_library(sys.argv[1]).fg_source_sha().decode())\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    assert [o.strip() for o, _ in outs] == [N.source_sha()] * 2
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [N.library_path(tmp_path).name, "libfrave_host.lock"])


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    for name in N.SHA_SOURCES:
        shutil.copy(N.CSRC / name, src / name)
    for name in N.UNITS:
        (src / name).write_text("this is not C++\n")
    monkeypatch.setattr(N, "CSRC", src)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed(.|\\n)*error"):
        N.load_library(tmp_path / "build")
