"""The port stands alone: no module of frave_tpu_torch, and not
chip_smoke.py, imports frave_tpu or jax (an AST scan of every file), and
a fresh process that encodes and decodes through the port ends with
neither in sys.modules."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FILES = sorted(
    [p.relative_to(REPO).as_posix() for p in (REPO / "frave_tpu_torch").rglob("*.py")]
    + ["chip_smoke.py"]
)
FOREIGN = ("frave_tpu", "jax")


def _foreign(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FOREIGN)


def _imports(path: Path):
    """(line, absolute module name, package depth left) of every import in
    the file; relative imports resolved against the file's package (depth
    left < 1: the import climbs out of the top-level package)."""
    rel = path.relative_to(REPO)
    package = list(rel.parent.parts)
    for node in ast.walk(ast.parse(path.read_text(), str(rel))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name, 1
        elif isinstance(node, ast.ImportFrom):
            depth = len(package) - node.level + 1 if node.level else 1
            if node.level:
                base = package[: max(depth, 0)]
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module
            yield node.lineno, mod, depth
            for a in node.names:
                yield node.lineno, f"{mod}.{a.name}", depth


@pytest.mark.parametrize("rel", FILES)
def test_file_imports_neither_frave_tpu_nor_jax(rel):
    bad = [(line, mod) for line, mod, _ in _imports(REPO / rel) if _foreign(mod)]
    assert not bad, f"{rel} imports {bad}"


def test_relative_imports_stay_in_the_package():
    """A relative import that climbed out of frave_tpu_torch could reach a
    sibling package; every one resolves inside it."""
    out = [(rel, line, mod) for rel in FILES for line, mod, depth in _imports(REPO / rel)
           if depth < 1]
    assert not out, out


def test_encode_decode_load_neither_frave_tpu_nor_jax():
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import frave_tpu_torch\n"
        "rng = np.random.default_rng(0)\n"
        "px = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)\n"
        "blob = frave_tpu_torch.encode(px, device='cpu')\n"
        "out = frave_tpu_torch.decode(blob, device='cpu')\n"
        "assert np.array_equal(out.data, px)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'frave_tpu')\n"
        "             or m.startswith(('jax.', 'frave_tpu.')))\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]", res.stdout
