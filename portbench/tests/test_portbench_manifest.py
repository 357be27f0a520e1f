"""BENCHMARK.json against the benchmark's contract: keys, names, units,
files found by name, and what every cell reports."""

import json
import re

import pytest

from portbench.core import manifest as M
from portbench.core.loop import BaseLoop

TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _line(text) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_and_size(manifest):
    assert set(manifest) == TOP
    assert (M.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= manifest["run_seconds"] <= 51 and isinstance(manifest["run_seconds"], int)


def test_command_and_paths(manifest):
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (M.ROOT / p).is_dir()
    cmd = manifest["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for word in cmd[1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in manifest["paths"]), word
            assert (M.ROOT / word).is_file()


def test_names_units_and_entries(manifest):
    names = []
    for c in manifest["configs"]:
        assert set(c) == CONFIG_KEYS
        assert M.NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(M.NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in manifest["workloads"]:
        assert set(w) == CELL_KEYS
        assert M.NAME.match(w["name"]) and M.NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] == 1  # no cell measures a path across cards
        names.append(w["name"])
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == E2E_KEYS
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == LAYER_KEYS
        assert m["source"] in SOURCES and _line(m["layer"])
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert M.NAME.match(m["name"]) and M.UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))
    assert 1 <= len(manifest["configs"]) <= 24 and 1 <= len(manifest["workloads"]) <= 24
    assert 1 <= len(manifest["end_to_end"]) <= 16 and 1 <= len(manifest["per_layer"]) <= 128


@pytest.mark.parametrize("bad", ["", "a b", "a,b", "a/b", ".x", "x" * 65, "µs"])
def test_name_rule_refuses(bad):
    assert not M.NAME.match(bad)


@pytest.mark.parametrize("unit,ok", [("tokens/s", True), ("%", True), ("bits/pixel", True),
                                     ("ms per batch", False), ("µs", False), ("", False)])
def test_unit_rule(unit, ok):
    assert bool(M.UNIT.match(unit)) is ok


def test_configs_are_files_under_paths_and_used(manifest):
    used = {w["config"] for w in manifest["workloads"]}
    files = set()
    for c in manifest["configs"]:
        assert c["file"].startswith(manifest["paths"][0] + "/") and c["file"] not in files
        files.add(c["file"])
        with open(M.ROOT / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and all(k in cfg for k in c["reduced"])
        assert cfg == M.load_config(c["name"])
        assert c["name"] in used


def test_cells_find_their_files_and_report_enough(manifest):
    pairs = set()
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e
    for w in manifest["workloads"]:
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        M.load_config(w["config"])
        assert issubclass(M.load_loop(M.load_traffic(w["traffic"])["loop"]), BaseLoop)
        assert callable(M.load_judge(M.load_config(w["config"])["judge"]["kind"]).judge)
        reported = {m["name"] for m in M.end_to_end(manifest, w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        layers = M.per_layer(manifest, w["name"])
        assert layers
        assert all(m["moves"] in reported for m in layers)


def test_metric_workloads_name_cells(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert set(m.get("workloads", [])) <= cells


def test_every_per_layer_metric_has_a_reader(manifest):
    for m in manifest["per_layer"]:
        assert callable(M.load_reader(m["name"]))


def test_kernel_family_files():
    spec = M.load_kernel_family("rans_decode")
    assert spec["kernels"] and callable(spec["work"].bytes_needed)


def test_one_layer_name_per_layer(manifest):
    layers = {m["layer"] for m in manifest["per_layer"]}
    assert layers == {"program build", "entry and drivers", "encode stages", "decode stages",
                      "kernels", "device"}
