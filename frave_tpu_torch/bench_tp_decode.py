#!/usr/bin/env python3
"""Kernels 3T and DT (the tp-sharded rANS decode steps) of one source tree,
timed on the card: one JSON line.

    python3 frave_tpu_torch/bench_tp_decode.py TREE
    python3 frave_tpu_torch/bench_tp_decode.py --ab PARENT CHANGE
    python3 frave_tpu_torch/bench_tp_decode.py --sweep TREE

TREE is a checkout holding frave_tpu_torch (this one, or an unpacked
`git archive` of another commit). Per case, on the tree's own operands
(kernel_check.tp_problem with seed 7, two ranks; the same seeded images
and waves in every tree): one launch of rank 0 at the middle row of the
wave or the widest step of the program (kernel_check._tp_one_launch),
checked bit-equal to the tree's plain version on fresh copies, then its
device time per call at the tree's launch rule (the tree's
kernel_check.device_ms: back-to-back calls behind a sleep kernel, CUDA
events). Where the tree has them (kernel_check.TP_DESIGNS), also its plan
and the empty launch of that plan (the floor). Cases: 3T on the largest
wave of 2048x2048 RGB, 768x512 RGB and 256x256 gray ([3, 8192], [3, 1024]
and [1, 256] lanes a rank); DT at e1 2048x2048 RGB parallel, e2 768x512
RGB parity and e3 256x256 gray parity. --ab runs PARENT, CHANGE, CHANGE,
PARENT, each in a fresh process, and prints their times side by side.
--sweep times every launch size the plan can run (one block, clusters of
2 to 16) with the tables copied by TMA and by the threads, each launch
checked the same way: one SWEEP line a case.
"""

import json
import subprocess
import sys


def _same(a, b) -> bool:
    import torch

    if isinstance(a, (tuple, list)):
        return all(_same(x, y) for x, y in zip(a, b))
    if a is None or b is None:
        return a is None and b is None
    return torch.equal(a.to(torch.int64), b.to(torch.int64))


def _cases(KC):
    cases = [("tp_decode_row", f"{h}x{w}x{c}", KC.grid_shapes(h, w, c)["wave"])
             for h, w, c in ((2048, 2048, 3), (512, 768, 3), (256, 256, 1))]
    return cases + [("tp_decode_step", label, sh) for label, sh in (
        ("e1", (2048, 2048, 3, "parallel")), ("e2", (512, 768, 3, "parity")),
        ("e3", (256, 256, 1, "parity")))]


def _checked(KC, name, label, ops, design=None):
    """A closure launching one step of rank 0 at `design` (cluster, flags;
    None: the tree's default), checked bit-equal to the plain version."""
    import torch

    extra = () if design is None else (design,)
    torch.manual_seed(0)  # the same random flags in both copies
    call, _ = KC._tp_one_launch(name, ops, 2, *extra)
    torch.manual_seed(0)
    _, plain = KC._tp_one_launch(name, ops, 2, *extra)
    if not _same(call(), plain()):
        raise AssertionError(f"{name} {label}: the kernel disagrees with its plain version")
    return call


def run(tree: str) -> int:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from frave_tpu_torch import kernel_check as KC

    dev = torch.device("cuda", 0)
    designs = getattr(KC, "TP_DESIGNS", None)
    out = {"tree": tree}
    for name, label, shape in _cases(KC):
        ops = KC.tp_problem(name, np.random.default_rng(7), shape, "valid", dev)
        r = {"shape": list(shape), "device_ms": KC.device_ms(_checked(KC, name, label, ops))}
        if designs is not None:
            r["plan"] = str(KC.tp_design_plan(name, ops, 2, designs["rule"]))
            r["floor_ms"] = KC.tp_floor_ms(name, ops, 2)
        out[f"{name} {label}"] = r
    print("AB", json.dumps(out), flush=True)
    return 0


def sweep(tree: str) -> int:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from frave_tpu_torch import kernel_check as KC
    from frave_tpu_torch.ops import tp_decode as TD

    dev = torch.device("cuda", 0)
    sizes = [("one block", 0, TD.FORCE_BLOCK)] + [(f"cluster {s}", s, 0) for s in KC.CLUSTERS[1:]]
    for name, label, shape in _cases(KC):
        ops = KC.tp_problem(name, np.random.default_rng(7), shape, "valid", dev)
        rule = KC.tp_design_plan(name, ops, 2, (0, 0))
        out = {"shape": list(shape), "rule": str(rule), "ms": {}}
        for size, cluster, force in sizes:
            for copy, flag in (("TMA", TD.TMA), ("threads", TD.NO_TMA)):
                design = (cluster, force | flag)
                plan = KC.tp_design_plan(name, ops, 2, design)
                if isinstance(plan, str):
                    continue
                call = _checked(KC, name, label, ops, design)
                out["ms"][f"{size} x{plan.per} {copy}"] = round(KC.device_ms(call), 5)
        print(f"SWEEP {name} {label} {json.dumps(out)}", flush=True)
    return 0


def ab(parent: str, change: str) -> int:
    runs = []
    for tree in (parent, change, change, parent):
        proc = subprocess.run([sys.executable, __file__, tree], capture_output=True, text=True)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout + proc.stderr)
            return proc.returncode
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")][-1]
        print(line, flush=True)
        runs.append(json.loads(line[3:]))
    for case in [k for k in runs[1] if k != "tree"]:
        p = [runs[i][case]["device_ms"] for i in (0, 3)]
        c = [runs[i][case]["device_ms"] for i in (1, 2)]
        extra = {k: [runs[i][case].get(k) for i in (1, 2)] for k in ("plan", "floor_ms")}
        print(f"AB {case} {runs[1][case]['shape']}: parent ms {p}, change ms {c}, change "
              f"{json.dumps(extra)}", flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1] == "--ab":
        sys.exit(ab(sys.argv[2], sys.argv[3]))
    if sys.argv[1] == "--sweep":
        sys.exit(sweep(sys.argv[2]))
    sys.exit(run(sys.argv[1]))
