"""The port's command line (frave_tpu_torch/cli) on the CPU: main([...])
in process, on tmp_path, with --device cpu.

  * encode writes the bytes frave_tpu_torch.encode(..., device="cpu")
    returns, in grid, parallel and parity modes; decode gives back the
    input .npy; [h, w] gray .npy is accepted; an unreadable image, or a
    PIL format without PIL, exits 2 naming the file;
  * bench exits 0 and prints the per-file and corpus lines;
  * the optimize sweep prints its four rows;
  * the predictor search: find_predictor_vectors equals frave_tpu's, and
    search_predictors at 64x64 gray over 16 candidates gives frave_tpu's
    numpy search's best vector and scores (rel 1e-12). The container sizes
    are held to frave_tpu's jax backend at the best vector (within 1%: the
    width fits are not pinned); frave_tpu's numpy backend picks its
    context tables on the host and its sizes differ from both device
    backends' (by up to 7% on this image).
"""

import importlib
import sys

import numpy as np
import pytest

import frave_tpu
import frave_tpu_torch
from frave_tpu_torch import EncoderOptions, RasterImage
from frave_tpu_torch.testing import natural_image

# the modules (each package's cli/__init__ binds `main` to the function)
CJ = importlib.import_module("frave_tpu.cli.main")
CT = importlib.import_module("frave_tpu_torch.cli.main")

CASES = [("grid", (80, 96, 3)), ("parallel", (64, 64, 1)), ("parity", (64, 64, 1))]


def cli(*args) -> int:
    return CT.main([str(a) for a in args])


@pytest.mark.parametrize("mode,shape", CASES)
def test_encode_writes_the_api_bytes(tmp_path, capsys, mode, shape):
    px = natural_image(*shape, seed=31)
    np.save(tmp_path / "in.npy", px)
    assert cli("encode", tmp_path / "in.npy", "-o", tmp_path / "x.frv", "--mode", mode,
               "--device", "cpu") == 0
    blob = frave_tpu_torch.encode(px, EncoderOptions(mode=mode), device="cpu")
    assert (tmp_path / "x.frv").read_bytes() == blob
    assert f"frif size: {len(blob)} bytes" in capsys.readouterr().out


@pytest.mark.parametrize("mode,shape", CASES)
def test_decode_gives_back_the_input(tmp_path, capsys, mode, shape):
    px = natural_image(*shape, seed=32)
    (tmp_path / "x.frv").write_bytes(
        frave_tpu_torch.encode(px, EncoderOptions(mode=mode), device="cpu"))
    assert cli("-q", "decode", tmp_path / "x.frv", "-o", tmp_path / "out.npy",
               "--device", "cpu") == 0
    out = np.load(tmp_path / "out.npy")
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(out, px)
    assert capsys.readouterr().out == ""


def test_image_files(tmp_path, capsys, monkeypatch):
    """A [h, w] gray .npy encodes as [h, w, 1]; a wrong dtype, a missing
    file and a PNG without PIL each exit 2 naming the file."""
    px = natural_image(40, 24, 1, seed=33)
    np.save(tmp_path / "flat.npy", px[..., 0])
    assert cli("-q", "encode", tmp_path / "flat.npy", "-o", tmp_path / "x.frv",
               "--device", "cpu") == 0
    assert (tmp_path / "x.frv").read_bytes() == frave_tpu_torch.encode(px, device="cpu")
    np.save(tmp_path / "f32.npy", px.astype(np.float32))
    for name in ("f32.npy", "missing.npy"):
        assert cli("encode", tmp_path / name, "--device", "cpu") == 2
        assert name in capsys.readouterr().err
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert cli("decode", tmp_path / "x.frv", "-o", tmp_path / "x.png", "--device", "cpu") == 2
    assert "x.png: PIL is not installed" in capsys.readouterr().err


def test_bench_prints_the_corpus_lines(tmp_path, capsys):
    src = tmp_path / "corpus"
    src.mkdir()
    for i in range(2):
        np.save(src / f"g{i}.npy", natural_image(64, 64, 1, seed=40 + i))
    np.save(src / "rgb.npy", natural_image(80, 96, 3, seed=42))
    (src / "notes.txt").write_text("not an image")
    assert cli("bench", src, "-o", tmp_path / "out", "--device", "cpu") == 0
    out = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in out[:3]] == ["g0.npy", "g1.npy", "rgb.npy"]
    assert all("mse=0.0000" in line for line in out[:3])
    assert out[3] == "--- corpus averages ---"
    assert out[4] == f"files: 3  pixels: {2 * 64 * 64 + 80 * 96}"
    assert out[-1].startswith("throughput: encode ") and out[-1].endswith(" MP/s")
    for name in ("g0.npy", "g1.npy", "rgb.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / "out" / name), np.load(src / name))


def test_optimize_sweep_prints_four_rows(tmp_path, capsys):
    np.save(tmp_path / "g.npy", natural_image(64, 64, 1, seed=43))
    assert cli("optimize", tmp_path / "g.npy", "--device", "cpu") == 0
    rows = capsys.readouterr().out.splitlines()[2:]
    assert [r.split()[0] for r in rows] == ["LOSSLESS", "HIGH", "MEDIUM", "LOW"]
    assert rows[0].split()[-2:] == ["0.0000", "inf"]


def test_find_predictor_vectors_match_frave_tpu():
    for limit in (None, 16):
        port, ref = CT.find_predictor_vectors(limit), CJ.find_predictor_vectors(limit)
        assert len(port) == len(ref) == (16 if limit else len(ref))
        for a, b in zip(port, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_search_predictors_matches_frave_tpu(tmp_path, capsys):
    px = natural_image(64, 64, 1, seed=21)
    cands = CT.find_predictor_vectors(16)
    best, res = CT.search_predictors(RasterImage.from_array(px), cands, device="cpu")
    best_j, res_j = CJ.search_predictors(frave_tpu.RasterImage.from_array(px), "numpy", cands)
    np.testing.assert_array_equal(best, best_j)
    assert [tuple(v) for _, _, v in res] == [tuple(v) for _, _, v in res_j]
    np.testing.assert_allclose([s for s, _, _ in res], [s for s, _, _ in res_j], rtol=1e-12)
    params = np.broadcast_to(best, (3, 6)).astype(np.float32)
    ref_bytes = len(frave_tpu.encode(px, frave_tpu.EncoderOptions(
        backend="jax", value_prediction_params=params)))
    assert abs(res[0][1] - ref_bytes) <= 0.01 * ref_bytes
    # the CLI prints the same search
    np.save(tmp_path / "g.npy", px)
    assert cli("optimize", tmp_path / "g.npy", "--search-predictors", "--search-limit", 16,
               "--device", "cpu") == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].endswith("searched 16 predictor vectors (reference grid: optimize.rs:16-32)")
    assert out[2].split()[:2] == [f"{res[0][0]:.4f}", str(res[0][1])]
    assert out[-1] == f"best: {best.astype(int).tolist()}"
    assert cli("optimize", tmp_path / "g.npy", "--search-predictors", "--backend", "native") == 2
