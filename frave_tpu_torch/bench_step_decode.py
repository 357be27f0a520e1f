#!/usr/bin/env python3
"""Kernel D (the step-tensor rANS decode) of one source tree, timed on the
card at the smoke's path-e cases: one JSON line.

    python3 frave_tpu_torch/bench_step_decode.py TREE

TREE is a checkout holding frave_tpu_torch (this one, or an unpacked
`git archive` of another commit), so that two commits compare on one card
in one call: run it as parent, change, change, parent. Per case, on the
tree's own operands of the port's containers of seeded images (the same
images in every tree: kernel_check.problem with seed 7), checked bit-equal
to the tree's plain version first: the device time per call of the launch
rule (back-to-back calls behind a sleep kernel, CUDA events; the method of
kernel_check.device_ms, kept here so a tree without it is timed the same
way) and the CUDA-event median per call with the host's share. Cases: e1
2048x2048 RGB parallel, e2 768x512 RGB parity, e3 4 256x256 gray parity
images in one batch.
"""

import json
import sys
import time

tree = sys.argv[1]
sys.path.insert(0, tree)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from frave_tpu_torch import kernel_check as KC  # noqa: E402
from frave_tpu_torch.ops import step_decode as SD  # noqa: E402

CASES = (("e1", (2048, 2048, 3, "parallel"), 0), ("e2", (512, 768, 3, "parity"), 0),
         ("e3", (256, 256, 1, "parity"), 4))


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
    for case, shape, images in CASES:
        args, extra = KC.problem("decode_steps", np.random.default_rng(7), shape, "valid", dev,
                                 images)
        args = tuple(KC._to(a, dev) for a in args)
        ref = SD.decode_steps_plain(*args, *extra)
        got = SD.decode_steps(*args, *extra)
        if not all(bool((a == b).all()) for a, b in zip(got, ref)):
            raise AssertionError(f"{case}: kernel D disagrees with its plain version")
        out[case] = {"device_ms": device_ms(lambda: SD.decode_steps(*args, *extra)),
                     "event_ms": KC.median_ms(lambda: SD.decode_steps(*args, *extra))}
    print("AB", json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
