#!/usr/bin/env python3
"""The grid decode's wave chain and the encode statistics of one source
tree, timed on the card: one JSON line.

    python3 frave_tpu_torch/bench_waves.py TREE

TREE is a checkout holding frave_tpu_torch (this one, or an unpacked
`git archive` of another commit), so that two commits compare on one card
in one call: run it as parent, change, change, parent. Cases, on the
smoke's seeded images (testing.natural_image), lossless at the default
lane count: 256x256 gray (K below 2^18: the step statistics' fits),
768x512 RGB and 2048x2048 RGB (above: the subsampled fits), one image a
call, and 64 256x256 gray images in one batch, in grid mode; e1
2048x2048 RGB parallel, e2 768x512 RGB parity and e3 4 256x256 gray
parity images in one batch (their statistics). Per case, the median over
RUNS warm calls of the StageTimes' ms (each mark synchronises the card,
so a stage is the host's and the device's time together): "encode/stats"
and, in grid mode, "decode/waves"; per grid decode, the device kernels it
runs (torch.profiler's CUDA events over one decode batch), the torch
operators it dispatches (a TorchDispatchMode count over another; views
included) and the launches of the port's own kernels (their wrappers'
counters).
"""

import json
import sys

tree = sys.argv[1]
sys.path.insert(0, tree)

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from frave_tpu_torch import EncoderOptions, RasterImage, kernel_check  # noqa: E402
from frave_tpu_torch.codec import pipeline_torch as PT  # noqa: E402
from frave_tpu_torch.testing import natural_image  # noqa: E402

RUNS = 5
# (label, h, w, c, seeds, mode)
CASES = (
    ("256x256 gray", 256, 256, 1, (1,), "grid"),
    ("768x512 RGB", 512, 768, 3, (2,), "grid"),
    ("2048x2048 RGB", 2048, 2048, 3, (4,), "grid"),
    ("64x 256x256 gray", 256, 256, 1, tuple(range(64)), "grid"),
    ("e1 2048x2048 RGB parallel", 2048, 2048, 3, (4,), "parallel"),
    ("e2 768x512 RGB parity", 512, 768, 3, (2,), "parity"),
    ("e3 4x 256x256 gray parity", 256, 256, 1, tuple(range(200, 204)), "parity"),
)


class _Ops(TorchDispatchMode):
    """Counts the torch operators dispatched under it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _median_stages(fn, dev) -> dict:
    """Median ms of each stage over RUNS calls of fn(stages) after a warm
    one."""
    fn(PT.StageTimes(dev))
    runs = []
    for _ in range(RUNS):
        st = PT.StageTimes(dev)
        fn(st)
        runs.append(st.ms)
    return {k: float(np.median([r[k] for r in runs])) for k in runs[0]}


def _kernels(fn, dev) -> int:
    """The CUDA events (kernels, copies, fills) torch.profiler records over
    one fn()."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(dev)
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


def main() -> int:
    dev = torch.device("cuda", 0)
    wrappers = {n: k[0] for n, k in kernel_check.KERNELS.items()}
    out = {"tree": tree}
    for label, h, w, c, seeds, mode in CASES:
        imgs = [RasterImage.from_array(natural_image(h, w, c, s)) for s in seeds]
        opts = EncoderOptions(mode=mode)
        enc = _median_stages(lambda st: PT.encode_pipeline_torch_batch(imgs, opts, dev, st), dev)
        row = {"encode/stats": enc["encode/stats"], "encode": sum(enc.values())}
        if mode == "grid":
            cis = PT.encode_pipeline_torch_batch(imgs, opts, dev)
            dec = _median_stages(lambda st: PT.decode_pipeline_torch_batch(cis, dev, st), dev)
            row["decode/waves"] = dec["decode/waves"]
            row["decode"] = sum(dec.values())
            row["device_events"] = _kernels(lambda: PT.decode_pipeline_torch_batch(cis, dev), dev)
            for fn in wrappers.values():
                fn.launches = 0
            with _Ops() as ops:
                PT.decode_pipeline_torch_batch(cis, dev)
            row["torch_ops"] = ops.n
            row["port_launches"] = {n: fn.launches for n, fn in wrappers.items() if fn.launches}
        out[label] = row
    print("AB", json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
