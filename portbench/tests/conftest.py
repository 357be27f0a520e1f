"""The benchmark's own tests, on the CPU: `python -m pytest portbench/tests -q`
from the repository's root. Tests marked `cuda` skip without a card; on
the card: `python -m pytest portbench/tests -q -m cuda`."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.fixture(scope="session")
def manifest():
    from portbench.core import manifest as M

    return M.load_manifest()


def small_cell(manifest, name: str, pool: int = 4, batch: int = 2):
    """A cell of BENCHMARK.json with its configuration and traffic cut to a
    size a CPU test holds: `pool` images, batches of at most `batch`, and
    768x512 images at 192x128."""
    from portbench.core import manifest as M

    cell = M.workload(manifest, name)
    cfg = copy.deepcopy(M.load_config(cell["config"]))
    tr = copy.deepcopy(M.load_traffic(cell["traffic"]))
    cfg["pool_images"] = pool
    cfg["judge"]["reference_decodes"] = 2
    if cfg["height"] > 256:
        cfg["height"], cfg["width"] = 128, 192
    tr["batch_size"] = min(tr["batch_size"], batch)
    if "batches_per_call" in tr:
        tr["batches_per_call"] = 2
    return cell, cfg, tr


@pytest.fixture
def small(manifest):
    """small_cell bound to the manifest."""
    return lambda name, **kw: small_cell(manifest, name, **kw)
