"""The shape of a run's result: the keys the contract asks for, the
cell's metrics by the manifest's names and units, the numbers compared
last; and a run on the card (marked cuda)."""

import json
import subprocess
import sys
import time

import pytest

from portbench.core import manifest as M
from portbench.core.harness import run_cell


@pytest.mark.parametrize("name", ["tiles256_gray.bulk64", "tiles256_gray.single"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_shape(manifest, small, name, trace):
    cell, cfg, tr = small(name)
    out = run_cell(manifest, cell, cfg, tr, 12345, 0.3, trace, "cpu", time.perf_counter())
    keys = list(out)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert set(keys) <= {"correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "checks"}
    json.loads(json.dumps(out))
    assert out["correct"] is True and out["attempted"] > 0
    dev = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    want = M.per_layer(manifest, name) if trace else M.end_to_end(manifest, name)
    units = {m["name"]: m["unit"] for m in want}
    if trace:
        assert dev["window_s"] > 0 and "busy_s" in dev
        bd = out["breakdown"]
        assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10
        # on the CPU no kernel runs: the roofline reads nothing and is left out
        assert set(out["metrics"]) <= set(units)
        assert "rans_decode_roofline.bulk" not in out["metrics"]
    else:
        assert set(out["metrics"]) == set(units)
    for k, v in out["metrics"].items():
        assert v["unit"] == units[k] and isinstance(v["value"], float) or isinstance(v["value"], int)
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.cuda
def test_run_on_card(cuda_device):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "tiles256_gray.single", "--seed",
         str(2**31 + 5), "--seconds", "2", "--trace", "0"],
        cwd=M.ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
