"""The benchmark of frave_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cell's cards. The
cell (BENCHMARK.json "workloads") names a configuration
(portbench/configs/<config>.json) and a traffic mix
(portbench/traffic/<mix>.json). With --trace 0 the last line of standard
output is the result with the cell's end-to-end metrics; with --trace 1,
with its per-layer metrics (portbench/metrics/<name>.py), the device's
busy and traced seconds and the breakdown. The numbers compared for
`correct` go last, to standard error and into the line.

Exits non-zero without a result where CUDA is missing or has fewer cards
than the cell asks for, where the program is not in the checkout, and
where the process holds jax, jaxlib, flax or frave_tpu once the window
has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "frave_tpu")
# the build and kernel caches a library may use, at fixed paths in the checkout
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton"}
# one process with few threads: no OpenMP or BLAS thread pools beside the
# caller's thread and the program's own (set before numpy and torch load)
ONE_THREAD = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def forbidden_modules(modules=None) -> list:
    """Top-level names in sys.modules that the benchmark must not hold,
    compared whole (frave_tpu_torch is not frave_tpu)."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def print_checks(checks: dict) -> None:
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)


def main(argv=None) -> int:
    args = parse_args(argv)
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / ".portbench_cache" / sub)
    os.environ["USE_FLAX"] = "0"
    for var in ONE_THREAD:
        os.environ[var] = "1"
    sys.path.insert(0, str(ROOT))
    from portbench.core import manifest as M

    man = M.load_manifest()
    cell = M.workload(man, args.workload)
    config = M.load_config(cell["config"])
    traffic = M.load_traffic(cell["traffic"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    from portbench.core.harness import run_cell

    out = run_cell(man, cell, config, traffic, args.seed, args.seconds, bool(args.trace),
                   "cuda", T_START)
    found = forbidden_modules()
    if found:
        print(f"portbench: the process holds {found}; no result", file=sys.stderr)
        return 3
    print_checks(out["checks"])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
