#!/usr/bin/env python3
"""Kernel 3 (the whole-wave rANS decode) of one source tree, timed on the
card at the main path's wave shapes: one JSON line.

    python3 frave_tpu_torch/bench_kernel3.py TREE

TREE is a checkout holding frave_tpu_torch (this one, or an unpacked
`git archive` of another commit), so that two commits compare on one card
in one call: run it as parent, change, change, parent. Per shape, on a
valid wave checked bit-equal to the plain version first: the device time
per call (back-to-back calls behind a sleep kernel, CUDA events; the same
method as kernel_check.device_ms, kept here so a tree without it is
timed the same way), the CUDA-event median per call with the host's
share, and, where the tree's wrapper takes a cluster size, the device
time forced to one block.
"""

import json
import sys
import time

tree = sys.argv[1]
sys.path.insert(0, tree)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from frave_tpu_torch import kernel_check as KC  # noqa: E402
from frave_tpu_torch.ops import rans_torch as RT  # noqa: E402

SHAPES = [(40, 1, 512), (65, 1, 512), (65, 1, 2048), (97, 3, 2048), (129, 3, 16384)]


def device_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    cycles = int(2e9 * (2 * reps * (time.perf_counter() - t) + 1e-3))
    for _ in range(4):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        host = (time.perf_counter() - t) * 1e3
        ev[2].record()
        ev[2].synchronize()
        if host < ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / reps
        cycles *= 2
    raise RuntimeError("the host did not get ahead of the device")


def main() -> int:
    dev = torch.device("cuda", 0)
    out = {"tree": tree}
    for sh in SHAPES:
        args, _ = KC.problem("decode_scan_wave", np.random.default_rng(7), sh, "valid")
        args = tuple(KC._to(a, dev) for a in args)
        ref = RT.decode_scan_wave_plain(*args)
        got = RT.decode_scan_wave(*args)
        if not all(bool((a.to(torch.int64) == b.to(torch.int64)).all()) for a, b in zip(got, ref)):
            raise AssertionError(f"{sh}: kernel 3 disagrees with its plain version")
        row = {"device_ms": device_ms(lambda: RT.decode_scan_wave(*args)),
               "event_ms": KC.median_ms(lambda: RT.decode_scan_wave(*args))}
        if "cluster" in RT.decode_scan_wave.__code__.co_varnames:
            row["one_block_device_ms"] = device_ms(lambda: RT.decode_scan_wave(*args, cluster=1))
        out[str(sh)] = row
    print("AB", json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
