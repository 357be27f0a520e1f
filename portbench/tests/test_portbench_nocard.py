"""Without a card the benchmark measures nothing: no CPU fallback, no
result; and the process check names jax and frave_tpu by whole
top-level names."""

import shutil
import subprocess
import sys

import pytest

from portbench.core import manifest as M
from portbench.run import forbidden_modules


def _run(cwd):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "tiles256_gray.single", "--seed",
         "7", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def _has_result(stdout: str) -> bool:
    return any(line.lstrip().startswith("{") for line in stdout.splitlines())


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = _run(M.ROOT)
    assert proc.returncode != 0 and not _has_result(proc.stdout)
    assert "CUDA" in proc.stderr


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(M.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(M.BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0 and not _has_result(proc.stdout)


@pytest.mark.parametrize("mods,found", [
    (["frave_tpu_torch", "frave_tpu_torch.codec", "torch", "numpy"], []),
    (["jax.numpy"], ["jax"]),
    (["jaxlib"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["frave_tpu.codec.pipeline_np"], ["frave_tpu"]),
    (["jaxtyping", "flaxen", "frave_tpu_tools"], []),
])
def test_forbidden_modules_compare_whole_names(mods, found):
    assert forbidden_modules(mods) == found
