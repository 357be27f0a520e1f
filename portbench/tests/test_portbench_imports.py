"""Nothing under portbench/ imports jax, jaxlib, flax or frave_tpu (top-level
names compared whole); the reference imports nothing of the program; and
the harness's modules, imported with the program, bring none of them in."""

import ast
import subprocess
import sys

import pytest

from portbench.core import manifest as M

FORBIDDEN = {"jax", "jaxlib", "flax", "frave_tpu"}
FILES = sorted(p for p in M.BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def imported(path) -> set:
    """Top-level names of every absolute import in a file."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            pytest.fail(f"{path}: dynamic import")
    return names


def test_files_found():
    assert len(FILES) > 20 and any(p.name == "run.py" for p in FILES)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(M.BENCH)))
def test_no_jax_or_jax_package(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((M.BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_plain_numpy(path):
    assert imported(path) <= {"__future__", "dataclasses", "enum", "typing", "threading",
                              "collections", "functools", "math", "struct", "numpy"}


def test_harness_with_the_program_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "import portbench.run, portbench.control, portbench.core.harness\n"
        "import frave_tpu_torch, frave_tpu_torch.codec.pipeline_torch\n"
        "from portbench.core import manifest as M\n"
        "man = M.load_manifest()\n"
        "[M.load_reader(m['name']) for m in man['per_layer']]\n"
        "M.load_kernel_family('rans_decode')\n"
        "[M.load_loop(M.load_traffic(w['traffic'])['loop']) for w in man['workloads']]\n"
        "[M.load_judge(M.load_config(c['name'])['judge']['kind']) for c in man['configs']]\n"
        "print(portbench.run.forbidden_modules())\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=M.ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "[]"
