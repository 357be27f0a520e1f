"""The port's multi-host layer (frave_tpu_torch.parallel.multihost) against
tests/test_multihost.py and test_multihost_real.py: corpus shards, checkpoint
and resume, the merged manifest, the dp x tp mesh route, and a real world of
processes on gloo; every container decodes on frave_tpu's numpy decoder to
the image it came from. Also the dry run (dryrun.run_dryrun) on a world of
four CPU ranks.
"""

import json
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from frave_tpu.codec.container import deserialize
from frave_tpu.codec.decoder import FRIDecoder

from frave_tpu_torch.parallel import multihost as MH
from frave_tpu_torch.parallel.dryrun import run_dryrun
from frave_tpu_torch.parallel.multihost import CorpusRunner, merged_manifest
from frave_tpu_torch.parallel.world import launch


@pytest.fixture()
def corpus(tmp_path):
    rng = np.random.default_rng(0)
    files = []
    for i in range(6):
        arr = rng.integers(0, 256, size=(24, 24), dtype=np.uint8)
        p = tmp_path / f"img_{i}.png"
        Image.fromarray(arr, mode="L").save(p)
        files.append(str(p))
    return files


def _ref(fp):
    if fp.endswith(".npy"):
        a = np.load(fp)
        return a if a.ndim == 3 else a[:, :, None]
    return np.asarray(Image.open(fp))[:, :, None]


def _check_outputs(files, outd):
    dec = FRIDecoder(backend="numpy")
    for fp in files:
        blob = (Path(outd) / (Path(fp).stem + ".frv")).read_bytes()
        np.testing.assert_array_equal(dec.decode(blob).data, _ref(fp))


def test_shard_partition(corpus, tmp_path):
    shards = [
        CorpusRunner(output_dir=str(tmp_path / "out"), num_processes=2, process_id=pid,
                     device="cpu").my_shard(corpus)
        for pid in range(2)
    ]
    assert sorted(shards[0] + shards[1]) == sorted(corpus)
    assert not set(shards[0]) & set(shards[1])


def test_two_host_run_and_gather(corpus, tmp_path):
    outd = str(tmp_path / "out")
    for pid in range(2):
        CorpusRunner(output_dir=outd, num_processes=2, process_id=pid, batch_size=2,
                     device="cpu").run(corpus)
    merged = merged_manifest(outd)
    assert merged["num_done"] == 6
    assert merged["num_failed"] == 0
    assert sorted(merged["hosts"]) == [0, 1]
    _check_outputs(corpus, outd)


def test_resume_skips_done(corpus, tmp_path):
    outd = str(tmp_path / "out")
    r = CorpusRunner(output_dir=outd, num_processes=1, process_id=0, batch_size=3, device="cpu")
    r.run(corpus)
    ts1 = {k: v["ts"] for k, v in json.loads(r.manifest_path.read_text())["entries"].items()}
    r2 = CorpusRunner(output_dir=outd, num_processes=1, process_id=0, batch_size=3, device="cpu")
    r2.run(corpus)
    ts2 = {k: v["ts"] for k, v in json.loads(r2.manifest_path.read_text())["entries"].items()}
    assert ts1 == ts2


def test_unreadable_file_marked_failed(corpus, tmp_path):
    bad = tmp_path / "broken.png"
    bad.write_bytes(b"not a png")
    badnpy = tmp_path / "broken.npy"
    np.save(badnpy, np.zeros((4, 4), np.float32))  # not uint8: refused
    outd = str(tmp_path / "out")
    r = CorpusRunner(output_dir=outd, num_processes=1, process_id=0, device="cpu")
    m = r.run(corpus + [str(bad), str(badnpy)])
    assert m["entries"][str(bad)]["status"] == "failed"
    assert m["entries"][str(badnpy)]["status"] == "failed"
    assert sum(1 for e in m["entries"].values() if e["status"] == "done") == 6


def test_failed_batch_is_retried_then_recorded(corpus, tmp_path, monkeypatch):
    """A batch whose encode raises is retried max_retries times, then its
    images are recorded as failed and the run goes on."""
    from frave_tpu_torch.codec import pipeline_torch as PT

    calls = []

    def broken(imgs, opts, device):
        calls.append(len(imgs))
        raise RuntimeError("device lost")

    monkeypatch.setattr(PT, "encode_pipeline_torch_batch", broken)
    r = CorpusRunner(output_dir=str(tmp_path / "out"), num_processes=1, process_id=0,
                     batch_size=6, max_retries=1, device="cpu")
    m = r.run(corpus)
    assert calls == [6, 6]
    assert all(e == {"status": "failed", "error": "device lost"} for e in m["entries"].values())


def test_npy_corpus_mixed_shapes(tmp_path):
    """.npy images of two shapes and colorspaces go in separate buckets."""
    rng = np.random.default_rng(4)
    files = []
    for i, shape in enumerate([(16, 24), (16, 24, 3), (16, 24), (20, 20, 3)]):
        p = tmp_path / f"n{i}.npy"
        np.save(p, rng.integers(0, 256, size=shape, dtype=np.uint8))
        files.append(str(p))
    outd = str(tmp_path / "out")
    m = CorpusRunner(output_dir=outd, num_processes=1, process_id=0, device="cpu").run(files)
    assert all(e["status"] == "done" for e in m["entries"].values())
    _check_outputs(files, outd)


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """Two simulated hosts, each through the dp x tp ShardedEncoder of a
    4-rank gloo world (2 x 2)."""
    d = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(0)
    files = []
    for i in range(6):
        p = d / "corpus" / f"img_{i}.png"
        p.parent.mkdir(exist_ok=True)
        Image.fromarray(rng.integers(0, 256, size=(24, 24), dtype=np.uint8), mode="L").save(p)
        files.append(str(p))
    res = launch(4, "frave_tpu_torch.parallel.multihost:run_corpus",
                 {"corpus_dir": str(d / "corpus"), "output_dir": str(d / "out"),
                  "batch_size": 2, "hosts": 2, "dp": 2, "tp": 2},
                 device="cpu", timeout=300)
    return res, files, str(d / "out")


def test_two_host_sharded_mesh_run(mesh_run):
    """Each simulated host drives the dp x tp ShardedEncoder (the halo
    rings and all) over its shard; the merged manifest covers the corpus;
    every container decodes bit-exactly."""
    res, files, outd = mesh_run
    assert all(r["cached"] == [True, True] for r in res)  # the mesh path ran
    merged = merged_manifest(outd)
    assert merged["num_done"] == 6
    assert merged["num_failed"] == 0
    _check_outputs(files, outd)


def test_two_host_sharded_grid_mode(mesh_run):
    """The mesh route's containers are grid-mode (the default options)."""
    _, files, outd = mesh_run
    for fp in files:
        blob = (Path(outd) / (Path(fp).stem + ".frv")).read_bytes()
        assert deserialize(blob).mode == "grid"


def test_two_process_gloo_world_with_resume(tmp_path):
    """A real 2-process gloo world: each rank a host (its rank and the
    world size from the live world), the merged manifest covers the .npy
    corpus, and a second run resumes with nothing re-encoded."""
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    rng = np.random.default_rng(5)
    files = []
    for i in range(6):
        p = corpus / f"img{i}.npy"
        np.save(p, rng.integers(0, 256, size=(32, 32), dtype=np.uint8))
        files.append(str(p))
    kw = {"corpus_dir": str(corpus), "output_dir": str(tmp_path / "out"), "batch_size": 4}
    first = launch(2, "frave_tpu_torch.parallel.multihost:run_corpus", kw, device="cpu")
    assert [r["rank"] for r in first] == [0, 1] and all(r["world"] == 2 for r in first)
    assert [r["done"] for r in first] == [[3], [3]]
    merged = merged_manifest(str(tmp_path / "out"))
    assert merged["num_done"] == 6 and sorted(merged["hosts"]) == [0, 1]
    _check_outputs(files, tmp_path / "out")
    again = launch(2, "frave_tpu_torch.parallel.multihost:run_corpus", kw, device="cpu")
    assert [r["ts"] for r in again] == [r["ts"] for r in first]


def test_init_distributed_reads_torchrun_env(monkeypatch):
    """Without a multi-process request it returns 0 and initializes
    nothing; from torchrun's variables it initializes the world over TCP
    with the backend the caller names."""
    import torch.distributed as dist

    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    seen = {}
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **k: seen.update(a=a, k=k))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "get_rank", lambda: 3)
    assert MH.init_distributed() == 0 and not seen
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "29555")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    assert MH.init_distributed(backend="gloo") == 3
    assert seen["a"] == ("gloo",)
    assert seen["k"] == {"init_method": "tcp://localhost:29555", "world_size": 4, "rank": 3}


def test_launch_reports_a_failed_rank(tmp_path):
    """A child's exception fails the launch with its traceback."""
    with pytest.raises(RuntimeError, match="FileNotFoundError"):
        launch(2, "frave_tpu_torch.parallel.multihost:run_corpus",
               {"corpus_dir": str(tmp_path / "missing"), "output_dir": str(tmp_path / "o")},
               device="cpu", timeout=120)
    with pytest.raises(ValueError):
        launch(1, "os:getcwd", device="cpu")


def test_launch_defaults_to_the_card(tmp_path):
    """A launch that names no device runs its ranks on the card: without
    CUDA it fails with the rank's traceback naming CUDA, never falling back
    to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: a default launch would run on it")
    with pytest.raises(RuntimeError, match="(?s)rank 0:.*CUDA is not available"):
        launch(1, "frave_tpu_torch.parallel.multihost:run_corpus",
               {"corpus_dir": str(tmp_path / "missing"), "output_dir": str(tmp_path / "o")},
               timeout=120)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_launch_names_the_device_once(tmp_path, device):
    """launch hands the target its device; a device in the target's
    keyword arguments too is refused before any rank starts, whether it
    agrees or not."""
    with pytest.raises(ValueError, match="launch gives the target its device"):
        launch(1, "frave_tpu_torch.parallel.multihost:run_corpus",
               {"corpus_dir": str(tmp_path), "output_dir": str(tmp_path / "o"),
                "device": device}, device="cpu", timeout=30)
    assert not (tmp_path / "o").exists()


def test_dryrun_four_ranks():
    """The dry run's legs (dp x tp encode with the halo, dp decode, tp
    decode, the host decode, the parallel mode) on a 2 x 2 CPU world."""
    res = run_dryrun(4, device="cpu")
    assert res["mesh"] == [2, 2]
    assert [leg["op"] for leg in res["legs"]] == [
        "encode", "dp_decode", "tp_decode", "encode", "dp_decode"]
    assert res["legs"][0]["halo"]
