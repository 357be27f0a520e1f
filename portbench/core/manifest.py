"""BENCHMARK.json and the files it names, found by name.

A cell names a configuration (configs/<name>.json) and a traffic mix
(traffic/<name>.json); a mix names its loop (loops/<loop>.py), a
configuration its comparison (judges/<kind>.py); a per-layer metric has
its reader in metrics/<name>.py and a kernel family its names and work
arithmetic in kernels/<family>.json and .py. Adding any of them is
adding files.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_manifest(path: Path = ROOT / "BENCHMARK.json") -> dict:
    with open(path) as f:
        return json.load(f)


def _load_json(folder: str, name: str) -> dict:
    if not NAME.match(name):
        raise ValueError(f"bad name {name!r}")
    with open(BENCH / folder / f"{name}.json") as f:
        return json.load(f)


def load_config(name: str) -> dict:
    return _load_json("configs", name)


def load_traffic(name: str) -> dict:
    return _load_json("traffic", name)


def load_kernel_family(family: str) -> dict:
    """kernels/<family>.json (the kernel names whose device time counts)
    with the work arithmetic of kernels/<family>.py as "work"."""
    spec = _load_json("kernels", family)
    spec["work"] = _load_named("kernels", family)
    return spec


def load_loop(name: str):
    """The Loop class of loops/<name>.py."""
    return _load_named("loops", name).Loop


def load_judge(kind: str):
    """The module judges/<kind>.py, whose judge(...) compares a run's outputs."""
    return _load_named("judges", kind)


def _load_named(folder: str, name: str):
    if not NAME.match(name):
        raise ValueError(f"bad name {name!r}")
    safe = name.replace(".", "_").replace("-", "_")
    return _load_module(BENCH / folder / f"{name}.py", f"portbench_{folder}_{safe}")


def load_reader(metric: str):
    """The read(ctx) function of metrics/<metric>.py."""
    return _load_named("metrics", metric).read


def _load_module(path: Path, modname: str):
    """A module of the benchmark's folders, loaded once a process."""
    if modname in sys.modules:
        return sys.modules[modname]
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[modname]
        raise
    return mod


def workload(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def end_to_end(manifest: dict, cell: str) -> list:
    """The end-to-end metrics that cell reports."""
    return [m for m in manifest["end_to_end"] if _applies(m, cell)]


def per_layer(manifest: dict, cell: str) -> list:
    """The per-layer metrics that cell reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    moved = {m["name"] for m in end_to_end(manifest, cell)}
    return [m for m in manifest["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]
